"""Smoke test of the scoring engine on one NVIDIA GPU, at flagship width.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the mesh path only

The flagship net is random_net(PRNGKey(0), 432, [2048]*7, 8000) written in
the reference binary format, with 389 x 432 seeded features (the shape of
the reference's 8khz.aligned.bin).  Phases, one line each:

  1. device   GPU present; device kind, count, JAX version, nvidia-smi
  2. sigmoid  all 1281 LUT entries bit-exact on the card (XLA path and the
              fused kernel's epilogue)
  3. kernel   fused hidden layer == jitted XLA hidden_layer_step bitwise at
              2048 x 2048, B in {128, 8192}
  4. engine   Scorer.score / score_masked (both lazy semantics) against the
              XLA engine at "highest" matmul precision; int8 activation flips
              between the default input precision and "highest"; the device
              kernel XLA runs for the int8 GEMM
  5. cli      python -m fastdnn_tpu.cli.score agrees with phase 4
  6. server   python -m fastdnn_tpu.cli.serve answers full and masked
              requests that agree with the Scorer

The last line is one JSON object, printed only when every phase passed:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

One process per card: this parent never uses JAX.  Model preparation runs
in a CPU-only child, the card phases in one child, then the CLI child and
the server child, one after the other.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

INPUT_DIM, HIDDEN, N_HIDDEN, SENONES = 432, 2048, 7, 8000
N_FRAMES = 389
MASK_DENSITY = 0.4
#: posteriors against the "highest"-precision XLA engine: softmax
#: reduction order is the only difference left
ATOL = 1e-5
#: the four-card mesh against the single-card engine
MESH_ATOL = 1e-6
#: substrings by which cuBLAS and cutlass name int8 tensor-core kernels
INT8_TENSOR_CORE_TAGS = ("i8i32", "gemm_s8", "imma")
#: server requests: (first frame, last frame, masked)
REQUESTS = ((0, 100, False), (100, N_FRAMES, False), (0, 150, True))


class PhaseError(RuntimeError):
    pass


def _say(phase: str, ok: bool, msg: str) -> None:
    print(f"{'PASS' if ok else 'FAIL'} {phase}: {msg}", flush=True)
    if not ok:
        raise PhaseError(f"{phase}: {msg}")


def nvidia_smi() -> str:
    """name, power.limit of each card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseError(f"device: nvidia-smi unavailable ({e})") from e
    if out.returncode != 0 or not out.stdout.strip():
        raise PhaseError(f"device: nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


# --------------------------------------------------------------------------
# Phase functions (run in a JAX child; sizes are parameters so that the
# CPU tests can run them small, with the kernel in interpreter mode)
# --------------------------------------------------------------------------


def write_inputs(workdir: str, *, input_dim=INPUT_DIM, hidden=HIDDEN,
                 n_hidden=N_HIDDEN, senones=SENONES, n_frames=N_FRAMES) -> dict:
    """Seeded model + features in the reference binary formats."""
    import jax

    from fastdnn_tpu.formats.binary import write_features, write_model
    from fastdnn_tpu.models.feedforward import random_net, to_raw
    from fastdnn_tpu.utils.synthetic import features

    net = random_net(jax.random.PRNGKey(0), input_dim, [hidden] * n_hidden, senones)
    paths = {"model": os.path.join(workdir, "model.bin"),
             "features": os.path.join(workdir, "features.bin")}
    write_model(to_raw(net), paths["model"])
    write_features(features(n_frames, input_dim), paths["features"])
    return paths


def check_sigmoid(interpret: bool = False) -> dict:
    """Mismatches against the reference LUT at all 1281 table inputs, for
    the XLA closed form and for the fused kernel's epilogue (driven through
    zero weights, so each output column is sigmoid(its bias))."""
    import jax
    import jax.numpy as jnp

    from fastdnn_tpu.ops import hidden_kernel
    from fastdnn_tpu.ops.sigmoid import (
        ZERO_POINT,
        quantized_sigmoid_shifted_i8,
        reference_lut_lookup,
    )

    ks = np.arange(-640, 641)
    lin = ks.astype(np.float32) / np.float32(100.0)
    want = (reference_lut_lookup(lin).astype(np.int16) - ZERO_POINT).astype(np.int8)
    got_xla = np.asarray(jax.jit(quantized_sigmoid_shifted_i8)(jnp.asarray(lin)))
    n = -(-lin.size // hidden_kernel.LANES) * hidden_kernel.LANES
    bias = np.zeros(n, np.float32)
    bias[: lin.size] = lin
    out = hidden_kernel.fused_hidden_layer(
        jnp.zeros((hidden_kernel.BLOCK_FRAMES, hidden_kernel.BLOCK_K), jnp.int8),
        jnp.zeros((n, hidden_kernel.BLOCK_K), jnp.int8),
        jnp.zeros(n, jnp.int32), jnp.float32(1.0), jnp.asarray(bias),
        interpret=interpret,
    )
    got_kernel = np.asarray(out)[:, : lin.size]
    return {
        "entries": int(ks.size),
        "xla_bad": ks[got_xla != want].tolist(),
        "kernel_bad": ks[(got_kernel != want[None]).any(0)].tolist(),
    }


def check_kernel(width: int, batches, interpret: bool = False) -> list:
    """The fused hidden layer against the jitted XLA step, bitwise, on
    random int8 activations at `width` x `width`; with the kernel step's
    compiled memory analysis."""
    import jax
    import jax.numpy as jnp

    from fastdnn_tpu.ops import hidden_kernel
    from fastdnn_tpu.ops.matmul import hidden_layer_step

    r = np.random.default_rng(0)
    w = r.integers(-40, 41, (width, width)).astype(np.int8)
    colsum = jnp.asarray(128 * w.astype(np.int32).sum(0))
    inv = jnp.float32(1.0 / (60.0 * 255.0))
    bias = jnp.asarray(r.normal(0, 1, width).astype(np.float32))
    w_t = jnp.asarray(w.T.copy())
    w = jnp.asarray(w)
    kern = jax.jit(lambda a, wt, c, s, b: hidden_kernel.hidden_layer(
        a, wt, c, s, b, interpret=interpret))
    xla = jax.jit(hidden_layer_step)
    rows = []
    for b in batches:
        x = jnp.asarray(r.integers(-128, 128, (b, width)).astype(np.int8))
        got = np.asarray(kern(x, w_t, colsum, inv, bias))
        want = np.asarray(xla(x, w, colsum, inv, bias))
        mem = kern.lower(x, w_t, colsum, inv, bias).compile().memory_analysis()
        rows.append({
            "batch": b,
            "mismatches": int((got != want).sum()),
            "size": int(want.size),
            "distinct": int(np.unique(want).size),
            "tiling": hidden_kernel.tiling(b),
            "memory": str(mem).replace("\n", " "),
        })
    return rows


def engine_scorers(qnet, interpret: bool = False) -> dict:
    """The engine as users get it (default config), and the plain XLA
    engine at the default and at "highest" input precision."""
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer

    backend = "pallas" if interpret else "auto"
    out = {}
    for sem in ("reference", "active_only"):
        out[f"engine_{sem}"] = Scorer(
            qnet, EngineConfig(backend=backend, interpret=interpret, lazy_semantics=sem))
        out[f"highest_{sem}"] = Scorer(
            qnet, EngineConfig(backend="xla", input_precision="highest", lazy_semantics=sem))
    out["xla_default"] = Scorer(qnet, EngineConfig(backend="xla"))
    out["xla_tf32"] = Scorer(qnet, EngineConfig(backend="xla", input_precision="high"))
    return out


def check_engine(qnet, frames, masks, interpret: bool = False) -> dict:
    """Phase 4: posteriors of the engine against the "highest" XLA engine,
    full and masked under both semantics, plus hidden-activation flips."""
    import jax

    sc = engine_scorers(qnet, interpret)
    res = {"backend": sc["engine_reference"]._backend, "cases": {}}
    with jax.default_matmul_precision("highest"):
        ref = {
            "full": sc["highest_reference"].score(frames),
            "masked_reference": sc["highest_reference"].score_masked(frames, masks),
            "masked_active_only": sc["highest_active_only"].score_masked(frames, masks),
        }
        padded, n = sc["highest_reference"]._prepare(frames)
        acts_highest = np.asarray(sc["highest_reference"]._hidden(
            sc["highest_reference"].net, padded))[:n]
    got = {
        "full": sc["engine_reference"].score(frames),
        "masked_reference": sc["engine_reference"].score_masked(frames, masks),
        "masked_active_only": sc["engine_active_only"].score_masked(frames, masks),
    }
    for k in ref:
        d = np.abs(got[k] - ref[k])
        res["cases"][k] = {
            "max_abs": float(d.max()),
            "argmax_agree": float((got[k].argmax(1) == ref[k].argmax(1)).mean()),
            "max_rowsum_err": float(np.abs(got[k].sum(1) - 1.0).max()),
            "finite": bool(np.isfinite(got[k]).all()),
        }
    xd = sc["xla_default"]
    acts_default = np.asarray(xd._hidden(xd.net, padded))[:n]
    eng = sc["engine_reference"]
    acts_engine = np.asarray(eng._hidden(eng.net, padded))[:n, : acts_highest.shape[1]]
    res["flips_default_vs_highest"] = int((acts_default != acts_highest).sum())
    xt = sc["xla_tf32"]
    acts_tf32 = np.asarray(xt._hidden(xt.net, padded))[:n]
    res["flips_high_vs_highest"] = int((acts_tf32 != acts_highest).sum())
    res["flips_engine_vs_highest"] = int((acts_engine != acts_highest).sum())
    res["acts"] = int(acts_highest.size)
    res["input_precision"] = eng.config.input_precision
    res["posteriors"] = got
    res["scorer"] = eng
    return res


def gemm_kernels(scorer, batch: int) -> dict:
    """Device kernels of one scoring call (name -> count), from a profiler
    trace, and the int8 dots of the compiled program with their fusion
    kinds, from its optimized HLO."""
    import re

    import jax.numpy as jnp

    from fastdnn_tpu.utils.timer import device_kernel_events

    x = jnp.zeros((batch, scorer.input_dim), jnp.float32)
    names = {k: len(v) for k, v in
             device_kernel_events(lambda: scorer._score(scorer.net, x)).items()}
    hlo = scorer._score.lower(scorer.net, x).compile().as_text()
    # int8 x int8 dots are the program's only dots with an s32 result
    s32_dots = re.findall(r"= s32\[[0-9,]+\]\{[^}]*\} dot\(", hlo)
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    kinds = sorted(set(re.findall(r'"kind":"(__triton[a-z_]*)"', hlo)))
    return {"kernels": names, "s8_dots": len(s32_dots), "custom_calls": targets,
            "fusion_kinds": kinds}


# --------------------------------------------------------------------------
# Children
# --------------------------------------------------------------------------


def _device_or_die(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise PhaseError(f"device: JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < count:
        raise PhaseError(f"device: {len(devs)} GPU(s), {count} needed")
    return devs


def _load(paths):
    from fastdnn_tpu import load_model, quantize_net
    from fastdnn_tpu.formats.binary import read_features

    qnet = quantize_net(load_model(paths["model"]), cutoff=3.0)
    frames = read_features(paths["features"])
    masks = (np.random.default_rng(1).random((frames.shape[0], qnet.output_dim))
             < MASK_DENSITY).astype(np.uint8)
    return qnet, frames, masks


def card_phases(workdir: str, smi: str) -> None:
    """Phases 1-4 on one card, in this process; writes what the CLI and
    server phases compare with into `workdir`."""
    import jax

    from fastdnn_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    devs = _device_or_die(1)
    dev = devs[0]
    _say("device", True, f"{dev.device_kind} | count {len(devs)} | jax {jax.__version__} "
         f"| nvidia-smi: {smi}")
    with open(os.path.join(workdir, "device.json"), "w") as f:
        json.dump({"platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}, f)

    sig = check_sigmoid()
    _say("sigmoid", not sig["xla_bad"] and not sig["kernel_bad"],
         f"xla {sig['entries'] - len(sig['xla_bad'])}/{sig['entries']} exact, "
         f"kernel epilogue {sig['entries'] - len(sig['kernel_bad'])}/{sig['entries']} "
         f"exact (bad k: xla {sig['xla_bad'][:8]}, kernel {sig['kernel_bad'][:8]})")

    for row in check_kernel(HIDDEN, (128, 8192)):
        _say("kernel", row["mismatches"] == 0,
             f"B={row['batch']} {HIDDEN}x{HIDDEN} tiling {row['tiling']}: "
             f"{row['mismatches']}/{row['size']} mismatches vs XLA "
             f"({row['distinct']} distinct values) | memory_analysis: {row['memory']}")

    paths = {"model": os.path.join(workdir, "model.bin"),
             "features": os.path.join(workdir, "features.bin")}
    qnet, frames, masks = _load(paths)
    res = check_engine(qnet, frames, masks)
    for name, c in res["cases"].items():
        ok = c["max_abs"] <= ATOL and c["max_rowsum_err"] <= 1e-5 and c["finite"]
        _say("engine", ok,
             f"{name} ({res['backend']}, input_precision={res['input_precision']}): "
             f"max|d| {c['max_abs']:.3e} vs 'highest' XLA, argmax agree "
             f"{c['argmax_agree']:.4f}, max|rowsum-1| {c['max_rowsum_err']:.2e}")
    _say("engine", res["flips_engine_vs_highest"] == res["flips_default_vs_highest"],
         f"int8 hidden activation flips vs 'highest': XLA at the default "
         f"input_precision ({res['input_precision']}) "
         f"{res['flips_default_vs_highest']}/{res['acts']}, engine "
         f"{res['flips_engine_vs_highest']}/{res['acts']}, XLA at 'high' "
         f"{res['flips_high_vs_highest']}/{res['acts']}")
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer

    for b in (N_FRAMES, 8192):
        g = gemm_kernels(Scorer(qnet, EngineConfig(backend="xla")), b)
        gemm = {k: v for k, v in g["kernels"].items()
                if any(t in k.lower() for t in ("gemm", "xmma", "imma", "dot", "matmul"))}
        # cuBLAS/cutlass name their int8 tensor-core kernels by operand type
        int8_tc = sorted(k for k in gemm if any(t in k for t in INT8_TENSOR_CORE_TAGS))
        _say("engine", True,
             f"XLA int8 GEMM at B={b}: int8 tensor-core GEMM "
             f"{'yes: ' + str(int8_tc) if int8_tc else 'not identified by name'}; "
             f"s32-result dots in HLO {g['s8_dots']}, custom calls "
             f"{g['custom_calls']}, fusion kinds {g['fusion_kinds']}, GEMM-like "
             f"device kernels {gemm}")

    save_expected(workdir, res["scorer"], frames, masks)


def save_expected(workdir: str, scorer, frames, masks) -> None:
    """What the CLI and server phases must reproduce: the engine's
    posteriors on the whole feature file and on each server request."""
    np.save(os.path.join(workdir, "full.npy"), scorer.score(frames))
    for i, (lo, hi, masked) in enumerate(REQUESTS):
        want = (scorer.score_masked(frames[lo:hi], masks[lo:hi]) if masked
                else scorer.score(frames[lo:hi]))
        np.save(os.path.join(workdir, f"request{i}.npy"), want)
    np.save(os.path.join(workdir, "masks.npy"), masks)


def four_phases(workdir: str, smi: str) -> None:
    """The mesh path on four cards in one process, against the
    single-card Scorer on card 0."""
    import jax

    from fastdnn_tpu.config import EngineConfig, enable_compilation_cache
    from fastdnn_tpu.engine.scorer import Scorer
    from fastdnn_tpu.parallel.mesh import make_mesh

    enable_compilation_cache()
    devs = _device_or_die(4)[:4]
    _say("device", True, f"{devs[0].device_kind} | count {len(devs)} | jax "
         f"{jax.__version__} | nvidia-smi: {smi}")
    with open(os.path.join(workdir, "device.json"), "w") as f:
        json.dump({"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)}, f)
    qnet, frames, masks = _load({"model": os.path.join(workdir, "model.bin"),
                                 "features": os.path.join(workdir, "features.bin")})
    single = Scorer(qnet)
    want = single.score(frames)
    want_m = single.score_masked(frames, masks)
    for data, model in ((1, 4), (2, 2)):
        sc = Scorer(qnet, EngineConfig(), mesh=make_mesh(data=data, model=model, devices=devs))
        got, got_m = sc.score(frames), sc.score_masked(frames, masks)
        d, dm = float(np.abs(got - want).max()), float(np.abs(got_m - want_m).max())
        shard_devs = {s.device for s in sc.net.weights[-1].addressable_shards}
        _say("mesh", d <= MESH_ATOL and dm <= MESH_ATOL and len(shard_devs) == 4,
             f"data={data} x model={model} ({sc._backend}): max|d| score {d:.3e}, "
             f"score_masked {dm:.3e} vs single card; output-layer shards on "
             f"{len(shard_devs)} distinct devices")


# --------------------------------------------------------------------------
# Parent
# --------------------------------------------------------------------------


def _child(args, *, env_extra=None, timeout=900) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, *args], cwd=REPO, env=env, timeout=timeout)
    if r.returncode != 0:
        raise PhaseError(f"{' '.join(args[:3])} exited {r.returncode}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_phase(workdir: str) -> None:
    out = os.path.join(workdir, "cli_out.txt")
    _child(["-m", "fastdnn_tpu.cli.score", os.path.join(workdir, "model.bin"),
            os.path.join(workdir, "features.bin"), out, "TXT"], timeout=600)
    got = np.loadtxt(out, dtype=np.float32, ndmin=2)
    want = np.load(os.path.join(workdir, "full.npy"))
    ok = got.shape == want.shape and float(np.abs(got - want).max()) <= ATOL
    _say("cli", ok, f"fastdnn_tpu.cli.score TXT {got.shape}: max|d| vs engine "
         f"{float(np.abs(got - want).max()) if got.shape == want.shape else 'shape'}")


def server_phase(workdir: str) -> None:
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    log = open(os.path.join(workdir, "server.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fastdnn_tpu.cli.serve", os.path.join(workdir, "model.bin"),
         "--port", str(port), "--max-wait-ms", "1"],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.time() + 600
        while True:
            if proc.poll() is not None:
                raise PhaseError(f"server: exited {proc.returncode} before serving")
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                if time.time() > deadline:
                    raise PhaseError("server: not serving within 600 s")
                time.sleep(0.5)
        from fastdnn_tpu.cli.serve import ScoreClient  # socket client only

        from fastdnn_tpu.formats.binary import read_features

        frames = read_features(os.path.join(workdir, "features.bin"))
        masks = np.load(os.path.join(workdir, "masks.npy"))
        client = ScoreClient("127.0.0.1", port)
        try:
            for i, (lo, hi, masked) in enumerate(REQUESTS):
                got = client.score(frames[lo:hi], masks[lo:hi] if masked else None)
                want = np.load(os.path.join(workdir, f"request{i}.npy"))
                d = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
                ok = (got.shape == want.shape and np.isfinite(got).all() and d <= ATOL
                      and float(np.abs(got.sum(1) - 1).max()) <= 1e-5)
                _say("server", ok, f"request {i} ({'masked' if masked else 'full'}, "
                     f"{hi - lo} frames) -> {got.shape}, max|d| vs Scorer {d:.3e}")
        finally:
            client.close()
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        log.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the mesh path on four cards and its comparison")
    p.add_argument("--phase", choices=["inputs", "card", "four"], help=argparse.SUPPRESS)
    p.add_argument("--workdir", help=argparse.SUPPRESS)
    p.add_argument("--smi", default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.phase:  # a child
        try:
            if args.phase == "inputs":
                write_inputs(args.workdir)
            elif args.phase == "card":
                card_phases(args.workdir, args.smi)
            else:
                four_phases(args.workdir, args.smi)
        except PhaseError as e:
            print(f"FAIL {e}", file=sys.stderr)
            return 1
        return 0

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        smi = nvidia_smi()
        print(f"nvidia-smi: {smi}", flush=True)
        me = os.path.abspath(__file__)
        _child([me, "--phase", "inputs", "--workdir", workdir],
               env_extra={"JAX_PLATFORMS": "cpu"}, timeout=600)
        if args.four:
            _child([me, "--phase", "four", "--workdir", workdir, "--smi", smi])
        else:
            _child([me, "--phase", "card", "--workdir", workdir, "--smi", smi])
            cli_phase(workdir)
            server_phase(workdir)
        with open(os.path.join(workdir, "device.json")) as f:
            device = json.load(f)
    except (PhaseError, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
