"""Headline benchmark: audio-seconds/s/chip on the flagship net.

Workload = the reference's largest validated config: 7x2048-hidden /
8000-senone net, 432-dim spliced features, 100 frames per audio-second
(/root/reference/README.md:49,64).  The reference's quantized SSE engine
processes 1 s of speech in 0.25-0.3 s per x86 core, i.e. ~3.65
audio-seconds/s/core (README.md:60-61, BASELINE.md) — that is vs_baseline=1.

Methodology: the engine is timed as a *chained repetition* inside one jit:
score REPS_HI vs REPS_LO times (each iteration's posteriors feed the next
iteration's features), and

    frames/s = (REPS_HI - REPS_LO) * batch / (t_hi - t_lo)

cancels the single compile/dispatch overhead.  XLA can see the whole graph,
so a full-row posterior sum is consumed each iteration to keep every output
column live — a full f32 read of the posteriors that makes the numbers
slightly conservative.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "audio-s/s/chip", "vs_baseline": N, ...}
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

FRAMES_PER_AUDIO_SECOND = 100.0
REFERENCE_AUDIO_S_PER_S = 3.65  # quantized SSE engine, per core (README.md:60-61)


def synced_time(fn, iters: int) -> float:
    """Min wall time of fn(), where fn must force device completion."""
    fn()  # warmup / compile
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def chained_frames_per_s(
    score_once,
    frames: jax.Array,
    *,
    reps_lo: int = 4,
    reps_hi: int = 24,
    iters: int = 7,
    masks: jax.Array | None = None,
) -> float:
    """Marginal throughput from two chained-repetition jits (see module doc).

    score_once(frames[, masks]) -> posteriors [b, out].  Raises when the
    longer chain is not slower (no marginal to measure).
    """
    b, in_dim = frames.shape
    out_dim = jax.eval_shape(
        (lambda x, m: score_once(x, m)) if masks is not None else score_once,
        *((frames, masks) if masks is not None else (frames,)),
    ).shape[1]
    if out_dim < in_dim:
        raise ValueError(
            f"posterior width {out_dim} < feature dim {in_dim}: the feedback "
            "chain slices posteriors back into features, so the net's output "
            "must be at least as wide as its input"
        )

    def make(reps: int):
        @jax.jit
        def f(x):
            p = None
            for _ in range(reps):
                p = score_once(x, masks) if masks is not None else score_once(x)
                # feed posteriors back as features and consume every
                # column via a full-row sum
                x = p[:, :in_dim] * 50.0 + jnp.sum(p, axis=1, keepdims=True)
            return p

        return lambda: np.asarray(f(frames)[0, 0])

    t_lo = synced_time(make(reps_lo), iters)
    t_hi = synced_time(make(reps_hi), iters)
    if t_hi <= t_lo:
        raise RuntimeError(
            f"no marginal: {reps_hi} reps took {t_hi:.6f}s, {reps_lo} took {t_lo:.6f}s"
        )
    return (reps_hi - reps_lo) * b / (t_hi - t_lo)


def run_config(name: str, backend: str, iters: int) -> dict:
    """BASELINE.json secondary configs (the headline is config 4 = main())."""
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer
    from fastdnn_tpu.models.feedforward import random_net
    from fastdnn_tpu.quant.quantize import quantize_net
    from fastdnn_tpu.utils.synthetic import features

    if name in ("8khz", "16khz"):
        # configs 1 and 2: utterance-sized batches at the reference's feature
        # shapes (389 x 432 on the mid-size net, 100 x 432 on the flagship)
        frames, widths, out_dim = (
            (features(389), [1024] * 5, 4000) if name == "8khz"
            else (features(100), [2048] * 7, 8000)
        )
        net = random_net(jax.random.PRNGKey(0), 432, widths, out_dim)
        scorer = Scorer(quantize_net(net), EngineConfig(backend=backend))
        call = lambda: np.asarray(scorer.score(frames)[0, 0])
        t = synced_time(call, iters)
        return {"config": name, "frames": int(frames.shape[0]),
                "wall_ms": round(t * 1e3, 3)}

    if name == "midsize-lazy":
        # config 3: 5x1024 / 4000-out net, lazy masks at 30-50% density
        b = 8192
        net = random_net(jax.random.PRNGKey(0), 432, [1024] * 5, 4000)
        scorer = Scorer(quantize_net(net), EngineConfig(backend=backend))
        out = {"config": name}

        @functools.partial(jax.jit, static_argnames=("density",))
        def gen_masks(key, density):
            return (jax.random.uniform(key, (b, 4000)) < density).astype(jnp.uint8)

        frames = jax.block_until_ready(
            jax.random.normal(jax.random.PRNGKey(0), (b, 432), jnp.float32)
        )
        for density in (0.3, 0.5):
            masks = jax.block_until_ready(gen_masks(jax.random.PRNGKey(1), density=density))
            score_once = lambda x, m: scorer._score_masked(scorer.net, x, m)
            fps = chained_frames_per_s(score_once, frames, masks=masks, iters=iters)
            out[f"lazy_frames_per_s_{int(density*100)}pct"] = round(fps)
        return out

    raise SystemExit(f"unknown config {name}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--iters", type=int, default=7)
    p.add_argument("--backend", default="auto", choices=["auto", "xla", "pallas"])
    p.add_argument("--mask-density", type=float, default=0.4)
    p.add_argument("--quick", action="store_true")
    p.add_argument(
        "--config",
        default=None,
        choices=["8khz", "16khz", "midsize-lazy"],
        help="run a BASELINE.json secondary config instead of the headline",
    )
    args = p.parse_args(argv)

    from fastdnn_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]

    if args.config:
        print(json.dumps(run_config(args.config, args.backend, args.iters)))
        return 0

    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer
    from fastdnn_tpu.models.feedforward import random_net
    from fastdnn_tpu.quant.quantize import quantize_net

    if args.quick:
        args.batch, args.iters = 2048, 3

    net = random_net(jax.random.PRNGKey(0), 432, [2048] * 7, 8000)
    qnet = quantize_net(net, cutoff=3.0)
    scorer = Scorer(qnet, EngineConfig(backend=args.backend))

    b = args.batch
    frames = jax.block_until_ready(
        jax.random.normal(jax.random.PRNGKey(0), (b, 432), jnp.float32)
    )

    fps = chained_frames_per_s(
        lambda x: scorer._score(scorer.net, x), frames, iters=args.iters
    )
    audio_s_per_s = fps / FRAMES_PER_AUDIO_SECOND

    # lazy (masked) scoring at the typical ASR density (README.md:32)
    masks = jax.block_until_ready(
        (jax.random.uniform(jax.random.PRNGKey(1), (b, 8000)) < args.mask_density).astype(
            jnp.uint8
        )
    )
    lazy_fps = chained_frames_per_s(
        lambda x, m: scorer._score_masked(scorer.net, x, m),
        frames,
        masks=masks,
        iters=args.iters,
    )

    result = {
        "metric": "audio_seconds_per_second_per_chip_7x2048x8000",
        "value": round(audio_s_per_s, 1),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(audio_s_per_s / REFERENCE_AUDIO_S_PER_S, 1),
        "frames_per_s": round(fps),
        "lazy_frames_per_s_40pct": round(lazy_fps),
        "backend": scorer._backend,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "batch": b,
        "method": "chained-repetition marginal (full-row consume-sum)",
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
