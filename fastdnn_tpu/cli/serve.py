"""Scoring server: TCP front-end over the streaming engine.

    python -m fastdnn_tpu.cli.serve MODEL --port 8477 [--backend auto]
        [--cutoff 3.0] [--max-batch-frames 8192] [--max-wait-ms 3]

Concurrent clients submit utterances; the StreamingScorer packs them into
shared device batches (the replacement for the reference's
thread-per-caller JNI model — see engine/stream.py).

Wire protocol (all integers little-endian u32 unless noted):

    request:  magic b"FDN1" | op u8 | n | dim | f32 frames[n*dim]
              op 1 = score
              op 2 = score_masked: followed by u8 masks[n * out_dim]
              op 3 = stats (no body)
    response: status u8 (0 ok, 1 error) |
              ok:    n | out | f32 posteriors[n*out]
              error: len | utf-8 message
              stats: len | utf-8 json

One request per connection round; connections persist for many rounds.
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import struct
import sys
import threading

import numpy as np

from ..config import EngineConfig

MAGIC = b"FDN1"
OP_SCORE, OP_SCORE_MASKED, OP_STATS = 1, 2, 3


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _send_ok(sock: socket.socket, arr: np.ndarray) -> None:
    n, out = arr.shape
    sock.sendall(struct.pack("<BII", 0, n, out))
    sock.sendall(np.ascontiguousarray(arr, dtype=np.float32).tobytes())


def _send_err(sock: socket.socket, msg: str) -> None:
    raw = msg.encode()
    sock.sendall(struct.pack("<BI", 1, len(raw)) + raw)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "ScoreServer" = self.server  # type: ignore[assignment]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                head = _recv_exact(sock, 5)
            except ConnectionError:
                return
            if head[:4] != MAGIC:
                _send_err(sock, "bad magic")
                return
            op = head[4]
            if op not in (OP_SCORE, OP_SCORE_MASKED, OP_STATS):
                # reject BEFORE reading a body the op doesn't define —
                # otherwise the handler blocks waiting for phantom payload
                _send_err(sock, f"unknown op {op}")
                continue
            try:
                if op == OP_STATS:
                    tp = server.stream.throughput
                    payload = json.dumps(
                        {
                            "frames": tp.frames,
                            "batches": tp.batches,
                            "mean_batch_fill": round(tp.mean_batch_fill(), 1),
                            "frames_per_s": round(tp.frames_per_s(), 1),
                            "audio_seconds_per_s": round(tp.audio_seconds_per_s(), 2),
                            # model dims so clients can size feature vectors
                            # and mask payloads without out-of-band knowledge
                            "input_dim": server.stream.input_dim,
                            "output_dim": server.stream.output_dim,
                        }
                    ).encode()
                    sock.sendall(struct.pack("<BI", 0, len(payload)) + payload)
                    continue
                n, dim = struct.unpack("<II", _recv_exact(sock, 8))
                if n == 0 or dim == 0 or n * dim > 1 << 28 or dim > server.stream.input_dim:
                    # the declared payload length is untrustworthy (and a
                    # wrong dim desynchronizes a masked request's byte
                    # stream), so error out and drop the connection rather
                    # than misparse what follows
                    _send_err(
                        sock,
                        f"bad frame count/dim {n}x{dim} "
                        f"(model input dim {server.stream.input_dim})",
                    )
                    return
                frames = np.frombuffer(
                    _recv_exact(sock, 4 * n * dim), dtype="<f4"
                ).reshape(n, dim)
                masks = None
                if op == OP_SCORE_MASKED:
                    out_dim = server.stream.output_dim
                    masks = np.frombuffer(
                        _recv_exact(sock, n * out_dim), dtype=np.uint8
                    ).reshape(n, out_dim)
                fut = server.stream.submit(frames, masks)
                _send_ok(sock, fut.result())
            except (ConnectionError, BrokenPipeError):
                return
            except Exception as e:  # surface engine errors to the client
                try:
                    _send_err(sock, f"{type(e).__name__}: {e}")
                except OSError:
                    return


class ScoreServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, stream):
        self.stream = stream
        super().__init__(addr, _Handler)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fastdnn-serve", description=__doc__.split("\n")[0])
    p.add_argument(
        "model",
        help="reference-format binary model, or a .npz int8 checkpoint "
        "(quantize once, serve forever)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    p.add_argument("--cutoff", type=float, default=3.0)
    p.add_argument("--hidden-bits", type=int, default=None, choices=[8, 4],
                   help="4 = int4 hidden trunk (output layer stays int8)")
    p.add_argument("--backend", default="auto", choices=["auto", "xla", "pallas"])
    p.add_argument("--max-batch-frames", type=int, default=8192)
    p.add_argument("--max-wait-ms", type=float, default=3.0)
    p.add_argument(
        "--lazy-mode",
        default="auto",
        choices=["auto", "dense", "gathered"],
        help="masked-scoring strategy (config.EngineConfig.lazy_mode)",
    )
    p.add_argument(
        "--mesh-model",
        type=int,
        default=0,
        help="tensor-parallel size for the senone axis (0 = no mesh: plain "
        "single-device scorer); with a mesh, frames are data-parallel over "
        "the remaining devices",
    )
    p.add_argument(
        "--mesh-data",
        type=int,
        default=None,
        help="data-parallel size (default: all devices not used by --mesh-model)",
    )
    p.add_argument(
        "--coordinator",
        default=None,
        help="multi-host: jax.distributed coordinator address host:port "
        "(--num-processes/--process-id explicit, or cluster-auto-detected); "
        "the process with jax.process_index() 0 serves TCP, the rest run "
        "the scoring worker loop",
    )
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--fast-posteriors",
        action="store_true",
        help="bf16 posteriors on device (EngineConfig.fast_posteriors): "
        "halves the device-to-host posterior transfer; responses still "
        "carry f32 (converted host-side).  bf16 rounding sits away from "
        "the softmax mass — see docs/serving.md",
    )
    p.add_argument(
        "--input-precision",
        default=EngineConfig.input_precision,
        choices=["highest", "high", "default"],
        help="matmul precision of the float input layer "
        "(EngineConfig.input_precision); below 'highest' a GPU may run it "
        "in TF32, which can flip a few sigmoid counts",
    )
    p.add_argument(
        "--warmup",
        action="store_true",
        help="pre-compile the common frame buckets before accepting clients "
        "(first jit of a shape costs seconds; do it at startup, not on the "
        "first request)",
    )
    return p


def build_scorer(args):
    """Model load + quantize + (optionally meshed / multi-host) scorer.

    Returns the scorer; in a multi-process launch, non-coordinator
    processes get a MultiHostScorer whose worker_loop the caller must run.
    """
    from ..quant.serialize import load_quantized

    if getattr(args, "coordinator", None):
        from ..parallel.mesh import init_multihost

        init_multihost(
            args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    qnet, topology = load_quantized(
        args.model, cutoff=args.cutoff,
        hidden_bits=getattr(args, "hidden_bits", None),
    )
    cfg = EngineConfig(
        backend=args.backend,
        lazy_mode=getattr(args, "lazy_mode", "auto"),
        fast_posteriors=getattr(args, "fast_posteriors", False),
        input_precision=getattr(args, "input_precision", EngineConfig.input_precision),
    )
    mesh_model = getattr(args, "mesh_model", 0)
    mesh_data = getattr(args, "mesh_data", None)
    # either mesh flag activates a mesh (matching fastdnn-score's behavior)
    if not mesh_model and not mesh_data and not getattr(args, "coordinator", None):
        from ..engine.scorer import Scorer

        return Scorer(qnet, cfg), topology
    from ..parallel.mesh import make_mesh
    from ..parallel.service import MultiHostScorer

    mesh = make_mesh(data=mesh_data, model=mesh_model or 1)
    return MultiHostScorer(qnet, cfg, mesh), topology


def make_server(args, prebuilt=None) -> ScoreServer:
    from ..engine.stream import StreamingScorer

    scorer, topology = prebuilt if prebuilt is not None else build_scorer(args)
    stream = StreamingScorer(
        scorer,
        max_batch_frames=args.max_batch_frames,
        max_wait_ms=args.max_wait_ms,
    )
    print(f"Network = {topology}", flush=True)
    if getattr(args, "warmup", False):
        bucket = scorer.config.frame_bucket
        for n in (bucket, 4 * bucket, args.max_batch_frames):
            n = min(n, args.max_batch_frames)
            scorer.score(np.zeros((n, scorer.input_dim), np.float32))
            print(f"warmed {n}-frame bucket", flush=True)
    return ScoreServer((args.host, args.port), stream)


def main(argv=None) -> int:
    from ..config import enable_compilation_cache

    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    prebuilt = None
    if args.coordinator:
        # build first (runs init_multihost), then decide the role from
        # jax.process_index() — the value MultiHostScorer itself keys on —
        # so auto-assigned process ids (no --process-id) also work
        import jax

        scorer, topology = build_scorer(args)
        if jax.process_index() != 0:
            # worker process of a multi-host launch: no TCP, just mirror
            # the coordinator's device calls until it broadcasts stop
            print(f"worker {jax.process_index()}: Network = {topology}", flush=True)
            scorer.worker_loop()
            return 0
        prebuilt = (scorer, topology)
    server = make_server(args, prebuilt=prebuilt)
    host, port = server.server_address[:2]
    print(f"serving on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.stream.close()
        if hasattr(server.stream._scorer, "close"):
            server.stream._scorer.close()  # release multi-host workers
    return 0


# -- minimal client (also used by tests) -------------------------------------


class ScoreClient:
    """Blocking client for the serve protocol."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def score(self, frames: np.ndarray, masks: np.ndarray | None = None) -> np.ndarray:
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        n, dim = frames.shape
        op = OP_SCORE_MASKED if masks is not None else OP_SCORE
        with self._lock:
            self._sock.sendall(MAGIC + struct.pack("<BII", op, n, dim))
            self._sock.sendall(frames.tobytes())
            if masks is not None:
                self._sock.sendall(
                    np.ascontiguousarray(masks, dtype=np.uint8).tobytes()
                )
            return self._read_response()

    def stats(self) -> dict:
        with self._lock:
            self._sock.sendall(MAGIC + struct.pack("<B", OP_STATS))
            status, ln = struct.unpack("<BI", _recv_exact(self._sock, 5))
            payload = _recv_exact(self._sock, ln)
        if status != 0:
            raise RuntimeError(payload.decode())
        return json.loads(payload)

    def _read_response(self) -> np.ndarray:
        status = _recv_exact(self._sock, 1)[0]
        if status != 0:
            (ln,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            raise RuntimeError(_recv_exact(self._sock, ln).decode())
        n, out = struct.unpack("<II", _recv_exact(self._sock, 8))
        data = _recv_exact(self._sock, 4 * n * out)
        return np.frombuffer(data, dtype="<f4").reshape(n, out).copy()

    def close(self) -> None:
        self._sock.close()




def _cli(argv=None) -> int:
    """Entry point with one-line error reporting (no tracebacks for
    expected failures like bad paths, dims, or parameters)."""
    try:
        return main(argv)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_cli())
