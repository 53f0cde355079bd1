"""Decoder-loop emulation: realistic lazy (masked) acoustic scoring.

Mimics how an ASR beam-search decoder consumes this engine, the workload
the reference's FuncTest.lazyEmulation models
(/root/reference/test/java/suskun/nn/FuncTest.java:92-154): the decoder
keeps 30-50% of senones active and churns ~3% of them per frame as beams
evolve.

Two consumption patterns are shown:

  1. BATCH (recommended): the decoder runs one frame behind and hands the
     engine the whole utterance's mask matrix at once — one device call.
  2. STREAMING (reference-API-shaped): LazyContext scores frame by frame,
     like QuantizedDnn.LazyContext over JNI — correct, but it pays one
     device round trip per frame, the very control-flow shape that limited
     the reference's lazy win to 5-10% (README.md:45).

Run (any backend; uses seeded stand-in features, utils.synthetic):

    python examples/lazy_decoder.py [--model model.bin] [--density 0.4]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def evolving_masks(rng, frames, senones, density, churn=0.03):
    """Initial random active set, then +/-churn per frame (FuncTest's
    generateMasks shape)."""
    masks = np.zeros((frames, senones), np.uint8)
    active = max(1, int(senones * density))
    masks[0, rng.choice(senones, active, replace=False)] = 1
    flip = max(1, int(senones * churn))
    for t in range(1, frames):
        masks[t] = masks[t - 1]
        off = np.flatnonzero(masks[t] == 0)
        on = np.flatnonzero(masks[t] == 1)
        masks[t, rng.choice(off, min(flip, off.size), replace=False)] = 1
        if on.size > flip:
            masks[t, rng.choice(on, flip, replace=False)] = 0
    return masks


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None, help="binary model (default: random 5x1024/4000)")
    p.add_argument("--density", type=float, default=0.4)
    p.add_argument("--backend", default="auto")
    args = p.parse_args()

    import fastdnn_tpu as fd
    from fastdnn_tpu.config import EngineConfig

    frames = fd.synthetic_features(389)
    if args.model:
        net = fd.from_raw(fd.read_model(args.model))
    else:
        import jax

        net = fd.align(fd.random_net(jax.random.PRNGKey(0), 429, [1024] * 5, 4000), 4, 16)
    qnet = fd.quantize_net(net, cutoff=3.0)
    scorer = fd.Scorer(qnet, EngineConfig(backend=args.backend))
    rng = np.random.default_rng(1)
    masks = evolving_masks(rng, len(frames), scorer.output_dim, args.density)

    # -- pattern 1: whole-utterance masked scoring (one device call) --------
    scorer.score_masked(frames, masks)  # warmup/compile
    t0 = time.perf_counter()
    post = scorer.score_masked(frames, masks)
    dt = time.perf_counter() - t0
    print(f"batch lazy: {len(frames)} frames in {dt*1e3:.1f} ms "
          f"({len(frames)/dt/100:.1f} audio-s/s incl. host I/O)")
    print(f"  posteriors {post.shape}, rowsum [{post.sum(1).min():.5f}, {post.sum(1).max():.5f}]")

    # -- pattern 2: frame-by-frame LazyContext (reference API shape) --------
    ctx = scorer.new_lazy_context(len(frames))
    t0 = time.perf_counter()
    ctx.calculate_until_output(frames)
    per_frame = [ctx.calculate_for_output_nodes(masks[t]) for t in range(len(frames))]
    dt = time.perf_counter() - t0
    print(f"streaming lazy: {len(frames)} frames in {dt*1e3:.1f} ms "
          f"(one device call per frame, like the reference's JNI loop)")

    drift = max(
        float(np.abs(a - b).max()) for a, b in zip(per_frame, post)
    )
    print(f"  max |batch - streaming| = {drift:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
