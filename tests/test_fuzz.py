"""Topology/shape fuzzing: random nets through the full pipeline.

The reference supports exactly one topology family — input layer + N
equal-width sigmoid hidden layers + softmax output (README.md:69-70) — but
arbitrary dims within it.  These tests sweep random dims (including odd,
non-multiple-of-16 widths) through parse → align → quantize → score on both
backends, asserting the invariants that hold regardless of shape:
backend equality, probability simplex, float-oracle closeness, and
save/load round-trips.
"""

import io

import numpy as np
import pytest

from fastdnn_tpu.config import EngineConfig
from fastdnn_tpu.engine.scorer import Scorer
from fastdnn_tpu.formats.binary import read_model, write_model
from fastdnn_tpu.models.feedforward import align, forward, from_raw, random_net, to_raw
from fastdnn_tpu.quant.quantize import quantize_net


def random_topology(rng):
    import jax

    depth = int(rng.integers(1, 5))
    width = int(rng.integers(17, 200))  # deliberately not x16
    in_dim = int(rng.integers(13, 150))
    out_dim = int(rng.integers(11, 300))
    seed = int(rng.integers(0, 2**31))
    return random_net(jax.random.PRNGKey(seed), in_dim, [width] * depth, out_dim)


@pytest.mark.parametrize("trial", range(6))
def test_random_topologies_end_to_end(rng, trial):
    net = random_topology(rng)
    net = align(net, 4, 16)  # reference SSE alignment is still valid surgery
    n_frames = int(rng.integers(1, 60))
    frames = rng.standard_normal((n_frames, net.input_dim)).astype(np.float32) * 2.0

    # binary round trip first — the durable artifact must survive any shape
    buf = io.BytesIO()
    write_model(to_raw(net), buf)
    net2 = from_raw(read_model(io.BytesIO(buf.getvalue())))

    qnet = quantize_net(net2, cutoff=3.0)
    sx = Scorer(qnet, EngineConfig(backend="xla"))
    sp = Scorer(qnet, EngineConfig(backend="pallas", interpret=True))

    px = sx.score(frames)
    pp = sp.score(frames)
    assert px.shape == (n_frames, net.output_dim)
    # the fused hidden kernel is bitwise-equal on int8 activations and
    # both backends share the XLA output layer and softmax
    np.testing.assert_allclose(px, pp, atol=3e-5)
    np.testing.assert_allclose(px.sum(-1), 1.0, rtol=1e-4)

    # the float oracle bounds quantization error the same way FuncTest does
    oracle = np.asarray(forward(net2, frames))
    assert np.abs(px - oracle).sum(axis=0).max() < 0.1 * max(1, n_frames / 100)

    # masked path on a random mask
    masks = (rng.random((n_frames, net.output_dim)) < rng.uniform(0.2, 0.8)).astype(np.uint8)
    lx = sx.score_masked(frames, masks)
    lp = sp.score_masked(frames, masks)
    np.testing.assert_allclose(lx, lp, atol=3e-5)
    np.testing.assert_allclose(lx.sum(-1), 1.0, rtol=1e-4)


def test_single_hidden_layer_minimum(rng):
    """Smallest legal topology: input layer + output layer only."""
    import jax

    net = random_net(jax.random.PRNGKey(0), 24, [32], 40)
    qnet = quantize_net(net)
    out = Scorer(qnet, EngineConfig(backend="xla")).score(
        rng.standard_normal((5, 24)).astype(np.float32)
    )
    assert out.shape == (5, 40)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


def test_extreme_input_values(rng):
    """Saturating inputs must produce valid probabilities (the quantized
    sigmoid clamps to 0/255 outside +/-6.4, dnn.h:35-42)."""
    import jax

    net = random_net(jax.random.PRNGKey(1), 32, [64, 64], 50)
    qnet = quantize_net(net)
    s = Scorer(qnet, EngineConfig(backend="xla"))
    for scale in (0.0, 1e3, -1e3):
        frames = np.full((4, 32), scale, np.float32)
        out = s.score(frames)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("hidden_widths", [[64], [96, 96]])
def test_shallow_topologies_supported(rng, hidden_widths):
    """Nets with fewer than two int8 hidden layers are LEGAL topologies the
    reference's own parser accepts but its engine cannot run
    (CalculationContext reads layers()[1], /root/reference/src/cpp/
    dnn.cc:199: segfault at depth 1, silent heap overflow at depth 2 —
    ASan-verified; PARITY.md "Reference bugs surfaced").  This engine must
    handle them correctly at both backends."""
    import jax

    net = align(random_net(jax.random.PRNGKey(5), 429, hidden_widths, 120), 4, 16)
    frames = rng.standard_normal((33, net.input_dim)).astype(np.float32)
    oracle = np.asarray(forward(net, frames))
    qnet = quantize_net(net, cutoff=3.0)
    for cfg in (EngineConfig(backend="xla"),
                EngineConfig(backend="pallas", interpret=True)):
        out = Scorer(qnet, cfg).score(frames)
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)
        # the reference's own accuracy discipline (summed |dp| per senone)
        assert np.abs(out - oracle).sum(axis=0).max() < 0.1
