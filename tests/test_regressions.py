"""Regression tests for bugs found in self-review (round 1)."""

import threading

import numpy as np
import pytest

from fastdnn_tpu.config import EngineConfig
from fastdnn_tpu.engine.scorer import Scorer
from fastdnn_tpu.quant.quantize import quantize_net


def test_lazy_context_dense_path_single_row_pallas(small_net, rng):
    """LazyContext on the pallas backend used to crash in dense mode: the
    per-frame path scored a [1, K] batch that failed a kernel's batch
    multiple check.  The single-row output path must match the batched
    masked path."""
    qnet = quantize_net(small_net)
    sc = Scorer(qnet, EngineConfig(backend="pallas", interpret=True, lazy_mode="dense"))
    frames = rng.standard_normal((3, sc.input_dim)).astype(np.float32)
    ctx = sc.new_lazy_context(3)
    ctx.calculate_until_output(frames)
    mask = (rng.random(sc.output_dim) < 0.7).astype(np.uint8)
    out = ctx.calculate_for_output_nodes(mask)
    assert out.shape == (sc.output_dim,)
    np.testing.assert_allclose(out.sum(), 1.0, rtol=1e-4)
    # must match the batched masked path exactly
    ref = sc.score_masked(frames[:1], mask[None, :])[0]
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_lazy_context_reusable_across_utterances(small_net, rng):
    """calculate_until_output resets the frame cursor, so one context can
    stream a second utterance (previously raised IndexError)."""
    qnet = quantize_net(small_net)
    sc = Scorer(qnet, EngineConfig(backend="xla"))
    ctx = sc.new_lazy_context(2)
    mask = np.ones(sc.output_dim, np.uint8)
    for _ in range(2):
        frames = rng.standard_normal((2, sc.input_dim)).astype(np.float32)
        ctx.calculate_until_output(frames)
        ctx.calculate_for_output_nodes(mask)
        ctx.calculate_for_output_nodes(mask)
    assert ctx.current_vector_index == 2


def test_stream_mixed_flood_no_deadlock(small_net, rng):
    """Alternating masked/unmasked submissions from several threads used to
    risk a permanent deadlock (worker pushed incompatible items back onto
    the bounded queue it alone consumes).  Small queue forces the squeeze."""
    from fastdnn_tpu.engine.stream import StreamingScorer

    sc = Scorer(quantize_net(small_net), EngineConfig(backend="xla"))
    ss = StreamingScorer(sc, max_batch_frames=64, max_wait_ms=1.0, max_queue=4)
    futs = []
    errors = []

    def worker(seed):
        try:
            r = np.random.default_rng(seed)
            for i in range(10):
                f = r.standard_normal((5, sc.input_dim)).astype(np.float32)
                m = None
                if i % 2:
                    m = (r.random((5, sc.output_dim)) < 0.5).astype(np.uint8)
                futs.append(ss.submit(f, m))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for f in list(futs):
        out = f.result(timeout=60)
        assert out.shape[1] == sc.output_dim
    ss.close()


def test_stream_close_resolves_racing_submits(small_net, rng):
    """Items enqueued concurrently with close() either resolve or the
    submit raises — no Future may hang forever."""
    from fastdnn_tpu.engine.stream import StreamingScorer

    sc = Scorer(quantize_net(small_net), EngineConfig(backend="xla"))
    for _ in range(5):
        ss = StreamingScorer(sc, max_wait_ms=1.0)
        results = []

        def submitter():
            try:
                f = ss.submit(np.zeros((2, sc.input_dim), np.float32))
                results.append(f)
            except RuntimeError:
                pass  # closed first: acceptable, nothing enqueued

        t = threading.Thread(target=submitter)
        t.start()
        ss.close()
        t.join()
        for f in results:
            assert f.result(timeout=30).shape == (2, sc.output_dim)


def test_truncated_network_text_raises_value_error():
    from fastdnn_tpu.formats.kaldi_text import parse_network_text

    truncated = "<AffineTransform> 4 3\n1 2 3\n4 5 6\n"  # needs 4 rows + bias
    with pytest.raises(ValueError, match="truncated"):
        parse_network_text(truncated)


def test_quantize_all_zero_layer_is_exact(rng):
    """An all-zero layer must quantize to zeros with finite scales (was
    inf multiplier -> NaN weights)."""
    import jax

    from fastdnn_tpu.models.feedforward import random_net

    net = random_net(jax.random.PRNGKey(0), 16, [32, 32], 20)
    zero_w = tuple(
        w if i != 1 else w * 0.0 for i, w in enumerate(net.weights)
    )
    net = type(net)(weights=zero_w, biases=net.biases, shift=net.shift, scale=net.scale)
    qnet = quantize_net(net)
    assert np.isfinite(float(qnet.multipliers[0]))
    assert np.asarray(qnet.weights[0]).max() == 0
    out = Scorer(qnet, EngineConfig(backend="xla")).score(
        rng.standard_normal((4, 16)).astype(np.float32)
    )
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


def test_serve_rejects_zero_dim(small_net, tmp_path):
    import socket
    import struct

    from fastdnn_tpu.cli.serve import MAGIC, make_server
    from fastdnn_tpu.formats.binary import write_model
    from fastdnn_tpu.models.feedforward import to_raw

    model_path = tmp_path / "m.bin"
    write_model(to_raw(small_net), model_path)

    class A:
        model = str(model_path)
        host, port = "127.0.0.1", 0
        cutoff, backend = 3.0, "xla"
        max_batch_frames, max_wait_ms = 64, 1.0

    srv = make_server(A)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        s = socket.create_connection(srv.server_address[:2])
        s.sendall(MAGIC + struct.pack("<BII", 1, 50, 0))
        assert s.recv(1)[0] == 1  # error status
        (ln,) = struct.unpack("<I", s.recv(4))
        assert b"bad frame count/dim" in s.recv(ln)
        s.close()
    finally:
        srv.shutdown()
        srv.stream.close()


def test_huge_cutoff_keeps_multiplier_finite(rng):
    """cutoff >> absmax used to round the multiplier to 0 -> inf inv_scale
    -> NaN posteriors; the multiplier now floors at 1."""
    import jax

    from fastdnn_tpu.models.feedforward import random_net

    net = random_net(jax.random.PRNGKey(0), 16, [32], 20)
    big = tuple(w * 300.0 for w in net.weights)  # absmax >> 254
    net = type(net)(weights=big, biases=net.biases, shift=net.shift, scale=net.scale)
    qnet = quantize_net(net, cutoff=1000.0)
    assert all(float(m) >= 1.0 for m in qnet.multipliers)
    out = Scorer(qnet, EngineConfig(backend="xla")).score(
        rng.standard_normal((4, 16)).astype(np.float32)
    )
    assert np.isfinite(out).all()


def test_serve_unknown_op_no_hang(small_net, tmp_path):
    """An unknown op used to make the handler block reading a phantom body;
    it must answer immediately and keep the connection usable."""
    import socket
    import struct

    from fastdnn_tpu.cli.serve import MAGIC, ScoreClient, make_server
    from fastdnn_tpu.formats.binary import write_model
    from fastdnn_tpu.models.feedforward import to_raw

    model_path = tmp_path / "m.bin"
    write_model(to_raw(small_net), model_path)

    class A:
        model = str(model_path)
        host, port = "127.0.0.1", 0
        cutoff, backend = 3.0, "xla"
        max_batch_frames, max_wait_ms = 64, 1.0

    srv = make_server(A)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        s = socket.create_connection(srv.server_address[:2], timeout=10)
        s.sendall(MAGIC + struct.pack("<B", 9))  # no body follows
        s.settimeout(10)
        assert s.recv(1)[0] == 1
        (ln,) = struct.unpack("<I", s.recv(4))
        assert b"unknown op" in s.recv(ln)
        s.close()
        # connection pool still healthy for real clients
        c = ScoreClient(*srv.server_address[:2])
        out = c.score(np.zeros((2, small_net.input_dim), np.float32))
        assert out.shape[0] == 2
        c.close()
    finally:
        srv.shutdown()
        srv.stream.close()
