"""Time the fused int8 hidden-layer kernel against XLA's plain version.

Runs on one GPU, in one process.  For each frame count it checks every
kernel tiling bitwise against the jitted `ops.matmul.hidden_layer_step`,
then times a chain of layer applications (one jitted `fori_loop`, so no
per-call dispatch is counted) in alternating rounds, and prints device
kernel names and durations from a short profiler trace.  With --e2e it
also times the flagship Scorer (7x2048/8000) with each backend, in
alternating rounds: the device program alone and Scorer.score from host
features to host posteriors.

    python tools/time_hidden_layer.py [--batches 128 8192] [--width 2048] [--e2e]

Writes the optimized HLO of the XLA step to chiprun_out/hidden_xla_hlo.txt.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from fastdnn_tpu.ops import hidden_kernel as hk
from fastdnn_tpu.ops.matmul import hidden_layer_step
from fastdnn_tpu.utils.timer import device_kernel_events

#: (block_frames, block_nodes, block_k, num_warps, num_stages); the
#: engine's own tiling (hidden_kernel.tiling) is always timed too
VARIANTS = [
    (128, 128, 128, 4, 3),
    (128, 128, 128, 8, 3),
    (128, 128, 128, 8, 4),
    (128, 128, 256, 8, 3),
    (128, 256, 128, 8, 4),
    (256, 128, 64, 8, 4),
    (64, 128, 128, 4, 3),
    (64, 64, 128, 4, 3),
    (64, 64, 128, 4, 4),
    (64, 64, 256, 4, 3),
    (32, 64, 128, 4, 3),
    (32, 128, 128, 4, 3),
    (32, 64, 256, 4, 2),
]


def _layer_args(width: int, seed: int = 0):
    r = np.random.default_rng(seed)
    w = r.integers(-40, 41, (width, width)).astype(np.int8)
    colsum = 128 * w.astype(np.int32).sum(0)
    # a multiplier near the flagship's keeps activations spread over the LUT
    inv = np.float32(1.0 / (60.0 * 255.0))
    bias = r.normal(0, 1, width).astype(np.float32)
    return jnp.asarray(w), jnp.asarray(colsum), jnp.asarray(inv), jnp.asarray(bias)


def _chain(step, reps):
    def run(x, *args):
        return jax.lax.fori_loop(0, reps, lambda i, a: step(a, *args), x)

    return jax.jit(run)


def _time(fn, args, rounds):
    out = fn(*args)
    out.block_until_ready()
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return ts


def _device_events(fn, args):
    """{kernel name: (count, mean us)} of one call, from a profiler trace."""
    ev = device_kernel_events(lambda: fn(*args))
    return {k: (len(v), sum(v) / len(v) / 1e3) for k, v in ev.items()}


def _flagship():
    from fastdnn_tpu.models.feedforward import random_net
    from fastdnn_tpu.quant.quantize import quantize_net

    return quantize_net(random_net(jax.random.PRNGKey(0), 432, [2048] * 7, 8000))


def time_input_precision(batches, rounds, precisions):
    """Flagship Scorer (default backend) at each input-layer precision:
    device program time, and int8 hidden activations that differ from the
    "highest" engine's on seeded features."""
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer
    from fastdnn_tpu.utils.synthetic import features

    qnet = _flagship()
    scorers = {p: Scorer(qnet, EngineConfig(input_precision=p)) for p in precisions}
    ref = Scorer(qnet, EngineConfig(input_precision="highest"))
    padded, n = ref._prepare(features(389))
    want = np.asarray(ref._hidden(ref.net, padded))[:n]
    rows = []
    for p, sc in scorers.items():
        got = np.asarray(sc._hidden(sc.net, padded))[:n]
        print(f"precision {p}: {int((got != want).sum())}/{want.size} int8 hidden "
              f"activations differ from 'highest'")
    for b in batches:
        x = jnp.asarray(np.random.default_rng(b).standard_normal((b, 432)).astype(np.float32))
        dev = {p: [] for p in scorers}
        for _ in range(rounds):
            for p, sc in scorers.items():
                dev[p].extend(_time(lambda sc=sc: sc._score(sc.net, x), (), 20))
        for p in scorers:
            ms = statistics.median(dev[p]) * 1e3
            print(f"precision {p} B={b}: device program {ms:.3f} ms/call")
            rows.append({"batch": b, "variant": f"precision-{p}", "device_ms": ms})
    return rows


def time_scorer(batches, rounds):
    """Flagship Scorer, xla vs pallas backend, alternating rounds."""
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer

    qnet = _flagship()
    scorers = {b: Scorer(qnet, EngineConfig(backend=b)) for b in ("xla", "pallas")}
    rows = []
    for b in batches:
        frames = np.random.default_rng(b).standard_normal((b, 432)).astype(np.float32)
        x = jnp.asarray(frames)
        want = scorers["xla"].score(frames)
        dev = {k: [] for k in scorers}
        host = {k: [] for k in scorers}
        for k, sc in scorers.items():
            d = float(np.abs(sc.score(frames) - want).max())
            print(f"e2e B={b} {k}: max|d| vs xla {d:.3e}")
        reps = 20
        for _ in range(rounds):
            for k, sc in scorers.items():
                fn = lambda sc=sc: sc._score(sc.net, x)
                dev[k].extend(_time(fn, (), reps))
                for _ in range(reps if b <= 1024 else 2):
                    t0 = time.perf_counter()
                    sc.score(frames)
                    host[k].append(time.perf_counter() - t0)
        for k in scorers:
            ms_dev = statistics.median(dev[k]) * 1e3
            ms_host = statistics.median(host[k]) * 1e3
            print(f"e2e B={b} {k}: device program {ms_dev:.3f} ms/call, "
                  f"Scorer.score {ms_host:.3f} ms/call "
                  f"({b / (ms_dev / 1e3) / 100:.0f} audio-s/s device, "
                  f"{b / (ms_host / 1e3) / 100:.0f} audio-s/s host API)")
            rows.append({"batch": b, "variant": f"scorer-{k}",
                         "device_ms": ms_dev, "host_ms": ms_host})
        for k, sc in scorers.items():
            ev = _device_events(lambda sc=sc: sc._score(sc.net, x), ())
            top = sorted(ev.items(), key=lambda kv: -kv[1][0] * kv[1][1])[:8]
            print(f"e2e B={b} {k} trace (name: [count, mean us]): {json.dumps(dict(top))}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, nargs="+", default=[128, 8192])
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--e2e", action="store_true",
                    help="also time the flagship Scorer with each backend")
    ap.add_argument("--input-precisions", nargs="*", default=[],
                    help="time the flagship Scorer at these input precisions "
                    "and skip the layer sweep")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {dev.device_kind} | nvidia-smi: {smi} | jax {jax.__version__}")

    w, colsum, inv, bias = _layer_args(args.width)
    w_t = jnp.asarray(np.asarray(w).T.copy())
    xla_step = jax.jit(hidden_layer_step)
    os.makedirs("chiprun_out", exist_ok=True)
    x0 = jnp.zeros((max(args.batches), args.width), jnp.int8)
    with open("chiprun_out/hidden_xla_hlo.txt", "w") as f:
        f.write(xla_step.lower(x0, w, colsum, inv, bias).compile().as_text())

    results = []
    if args.input_precisions:
        results.extend(time_input_precision(args.batches, args.rounds, args.input_precisions))
        args.batches = []
    for b in args.batches:
        r = np.random.default_rng(b)
        x = jnp.asarray(r.integers(-128, 128, (b, args.width)).astype(np.int8))
        ref = np.asarray(xla_step(x, w, colsum, inv, bias))
        reps = max(20, min(2000, (1 << 22) // b))
        cands = {"xla": (_chain(hidden_layer_step, reps), (x, w, colsum, inv, bias))}
        for bm, bn, bk, nw, ns in dict.fromkeys([hk.tiling(b), *VARIANTS]):
            name = f"triton bm{bm} bn{bn} bk{bk} w{nw} s{ns}"
            if not hk.tiles(b, args.width, args.width, bm, bn, bk):
                continue

            def step(a, w_t, c, s, bb, bm=bm, bn=bn, bk=bk, nw=nw, ns=ns):
                return hk.fused_hidden_layer(
                    a, w_t, c, s, bb, block_frames=bm, block_nodes=bn,
                    block_k=bk, num_warps=nw, num_stages=ns,
                )

            try:
                got = np.asarray(jax.jit(step)(x, w_t, colsum, inv, bias))
            except Exception as e:  # report and keep timing the others
                print(f"B={b} {name}: FAILED {type(e).__name__}: {str(e)[:300]}")
                continue
            mism = int((got != ref).sum())
            print(f"B={b} {name}: mismatches vs XLA {mism}/{ref.size}")
            cands[name] = (_chain(step, reps), (x, w_t, colsum, inv, bias))
        per = {k: [] for k in cands}
        for _ in range(args.rounds):
            for k, (fn, a) in cands.items():
                per[k].extend(_time(fn, a, 1))
        for k, ts in per.items():
            us = statistics.median(ts) / reps * 1e6
            fn, a = cands[k]
            ev = _device_events(fn, a)
            # the layer's own kernels: leave out the loop's counter update
            # and carry copies, and the weight transpose XLA hoists out of it
            layer = {n: v for n, v in ev.items()
                     if not n.startswith(("MemcpyD2D", "loop_add", "wrapped_transpose", "Memset"))}
            dev_us = sum(c * m for c, m in layer.values()) / reps
            print(f"B={b} {k}: {us:.2f} us/layer wall (median of {len(ts)}, {reps} "
                  f"layers/call); device {dev_us:.2f} us/layer in "
                  f"{json.dumps({n: round(m, 3) for n, (c, m) in layer.items()})}")
            results.append({"batch": b, "variant": k, "us_per_layer": us,
                            "device_us_per_layer": dev_us})
    if args.e2e:
        results.extend(time_scorer(args.batches, args.rounds))
    with open("chiprun_out/hidden_timing.json", "w") as f:
        json.dump({"device": dev.device_kind, "nvidia_smi": smi, "results": results}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
