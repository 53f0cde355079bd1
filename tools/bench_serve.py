"""Serving-under-load benchmark: N concurrent TCP clients vs the server.

The reference published its concurrency story as MultiThreadedStressTest
timings (/root/reference/test/java/suskun/nn/MultiThreadedStressTest.java:
37-44: per-task wall times under an 8-thread pool, each thread a private
context + JNI call).  This tool measures the replacement — the
shared-batch streaming server (cli/serve.py + engine/stream.py) — the way
a capacity planner needs it:

  * N client threads, each streaming utterances back-to-back over its own
    persistent TCP connection (closed-loop load: a client sends its next
    utterance the moment the previous response lands);
  * utterance lengths drawn uniformly from [min_len, max_len] frames
    (real ASR decode spans ~1-10 s of audio = 100-1000 frames);
  * a --masked fraction of clients sends the lazy path (random masks at
    the beam decoder's measured density, BENCHMARKS.md);
  * reported per run: aggregate audio-s/s, per-utterance latency
    p50/p90/p99, and the server's own mean batch fill (frames per device
    dispatch, from the stats op) — the number that says whether
    cross-utterance packing amortizes device calls.

Usage (spawns its own server unless --port points at a running one):

    python tools/bench_serve.py                       # default ladder
    python tools/bench_serve.py --clients 16 --max-wait-ms 3
    python tools/bench_serve.py --ladder               # sweep table

Output: one JSON line per configuration (plus a markdown table with
--ladder for BENCHMARKS.md).

One process per device: the server child is the only process that touches
an accelerator.  This parent imports only the socket client and prepares
the model in a CPU-only child.
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
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fastdnn_tpu.cli.serve import ScoreClient  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for_server(port: int, proc, timeout_s: float) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if proc.poll() is not None:
            out = proc.stdout.read() if proc.stdout else ""
            raise RuntimeError(f"server exited early:\n{out[-3000:]}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.3)
    raise TimeoutError(f"server not up on :{port} within {timeout_s}s")


def spawn_server(model: str, port: int, *, backend: str, max_wait_ms: float,
                 max_batch_frames: int, timeout_s: float) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-m", "fastdnn_tpu.cli.serve", model,
         "--port", str(port), "--backend", backend,
         "--max-wait-ms", str(max_wait_ms),
         "--max-batch-frames", str(max_batch_frames), "--warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ,
             "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")},
    )
    _wait_for_server(port, proc, timeout_s)
    return proc


class ClientLoad(threading.Thread):
    """One closed-loop client: stream utterances, record latencies."""

    def __init__(self, port: int, input_dim: int, output_dim: int, *,
                 seed: int, duration_s: float, min_len: int, max_len: int,
                 masked: bool, mask_density: float, start_evt: threading.Event):
        super().__init__(daemon=True)
        self.port = port
        self.rng = np.random.default_rng(seed)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.duration_s = duration_s
        self.min_len, self.max_len = min_len, max_len
        self.masked, self.density = masked, mask_density
        self.start_evt = start_evt
        self.latencies: list[float] = []
        self.frames = 0
        self.error: Exception | None = None

    def run(self) -> None:
        try:
            cli = ScoreClient("127.0.0.1", self.port)
            # pre-generate a pool of utterances: payload generation must not
            # serialize with the measurement loop
            pool = []
            for _ in range(8):
                n = int(self.rng.integers(self.min_len, self.max_len + 1))
                f = self.rng.standard_normal((n, self.input_dim)).astype(np.float32)
                m = None
                if self.masked:
                    m = (self.rng.random((n, self.output_dim)) < self.density
                         ).astype(np.uint8)
                pool.append((f, m))
            self.start_evt.wait()
            deadline = time.perf_counter() + self.duration_s
            i = 0
            while time.perf_counter() < deadline:
                f, m = pool[i % len(pool)]
                t0 = time.perf_counter()
                out = cli.score(f, m)
                dt = time.perf_counter() - t0
                assert out.shape[0] == f.shape[0]
                self.latencies.append(dt)
                self.frames += f.shape[0]
                i += 1
            cli.close()
        except Exception as e:  # surfaced by the harness
            self.error = e


def run_load(port: int, *, clients: int, duration_s: float, min_len: int,
             max_len: int, masked_frac: float, mask_density: float) -> dict:
    probe = ScoreClient("127.0.0.1", port)
    st = probe.stats()
    input_dim, output_dim = st["input_dim"], st["output_dim"]
    start = threading.Event()
    n_masked = int(round(clients * masked_frac))
    loads = [
        ClientLoad(port, input_dim, output_dim, seed=100 + i,
                   duration_s=duration_s, min_len=min_len, max_len=max_len,
                   masked=i < n_masked, mask_density=mask_density,
                   start_evt=start)
        for i in range(clients)
    ]
    for ld in loads:
        ld.start()
    time.sleep(0.3)  # let every client finish generating its pool
    stats0 = probe.stats()
    t0 = time.perf_counter()
    start.set()
    for ld in loads:
        ld.join(duration_s + 120)
    wall = time.perf_counter() - t0
    stats1 = probe.stats()
    probe.close()
    for ld in loads:
        if ld.error is not None:
            raise ld.error
    lats = np.concatenate([np.asarray(ld.latencies) for ld in loads])
    frames = sum(ld.frames for ld in loads)
    sframes = stats1["frames"] - stats0["frames"]
    sbatches = stats1["batches"] - stats0["batches"]
    return {
        "clients": clients,
        "masked_clients": n_masked,
        "utterances": int(lats.size),
        "frames": int(frames),
        "audio_s_per_s": round(frames / 100.0 / wall, 1),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 1),
        "p90_ms": round(float(np.percentile(lats, 90)) * 1e3, 1),
        "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 1),
        "mean_batch_fill": round(sframes / sbatches, 1) if sbatches else 0.0,
        "wall_s": round(wall, 1),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default=None,
                   help="model path (default: build a flagship-shaped net)")
    p.add_argument("--port", type=int, default=0,
                   help="attach to a running server instead of spawning")
    p.add_argument("--backend", default="auto")
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--duration-s", type=float, default=10.0)
    p.add_argument("--min-len", type=int, default=100)
    p.add_argument("--max-len", type=int, default=1000)
    p.add_argument("--masked-frac", type=float, default=0.25)
    p.add_argument("--mask-density", type=float, default=0.08)
    p.add_argument("--max-wait-ms", type=float, default=3.0)
    p.add_argument("--max-batch-frames", type=int, default=8192)
    p.add_argument("--ladder", action="store_true",
                   help="sweep clients x max_wait_ms, print a markdown table")
    args = p.parse_args(argv)

    model = args.model
    tmp = None
    if model is None and not args.port:
        # mid-size 5x1024/4000 net in the reference binary format, prepped on CPU
        tmp = tempfile.mkdtemp(prefix="bench_serve_")
        model = os.path.join(tmp, "model.bin")
        code = (
            "import jax\n"
            "from fastdnn_tpu.models.feedforward import random_net, to_raw, align\n"
            "from fastdnn_tpu.formats.binary import write_model\n"
            "net = align(random_net(jax.random.PRNGKey(7), 429, [1024]*5, 4000), 4, 16)\n"
            f"write_model(to_raw(net), {model!r})\n"
        )
        subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})

    configs = [(args.clients, args.max_wait_ms)]
    if args.ladder:
        configs = [(c, w) for w in (1.0, 3.0, 10.0) for c in (1, 4, 16, 64)]

    rows = []
    by_wait: dict[float, subprocess.Popen] = {}
    try:
        for clients, wait_ms in configs:
            if args.port:
                port = args.port
            else:
                # one server per max_wait_ms value (server-side knob)
                if wait_ms not in by_wait:
                    for prev in by_wait.values():
                        prev.terminate()
                        try:
                            prev.wait(20)
                        except subprocess.TimeoutExpired:
                            # a wedged server must not end the sweep — and
                            # it MUST die before the next spawn (one
                            # process per device)
                            prev.kill()
                            prev.wait(20)
                    by_wait.clear()
                    port = _free_port()
                    by_wait[wait_ms] = spawn_server(
                        model, port, backend=args.backend,
                        max_wait_ms=wait_ms,
                        max_batch_frames=args.max_batch_frames,
                        timeout_s=600,
                    )
                    by_wait[wait_ms]._port = port  # type: ignore[attr-defined]
                port = by_wait[wait_ms]._port  # type: ignore[attr-defined]
            r = run_load(port, clients=clients, duration_s=args.duration_s,
                         min_len=args.min_len, max_len=args.max_len,
                         masked_frac=args.masked_frac,
                         mask_density=args.mask_density)
            r["max_wait_ms"] = wait_ms
            rows.append(r)
            print(json.dumps(r), flush=True)
    finally:
        for proc in by_wait.values():
            proc.terminate()
            try:
                proc.wait(20)
            except subprocess.TimeoutExpired:
                proc.kill()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    if args.ladder and rows:
        print("\n| wait ms | clients | audio-s/s | p50 ms | p90 ms | p99 ms | fill |")
        print("|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['max_wait_ms']} | {r['clients']} | {r['audio_s_per_s']} "
                  f"| {r['p50_ms']} | {r['p90_ms']} | {r['p99_ms']} "
                  f"| {r['mean_batch_fill']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
