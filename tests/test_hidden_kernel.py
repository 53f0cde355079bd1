"""The fused int8 hidden-layer kernel (ops.hidden_kernel) on the CPU, in
interpreter mode, against the plain XLA step; its wrapper's shapes and
padding; and the engine's choice of kernel.  The compiled kernel itself
runs only on a GPU (the `gpu` tests, and chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastdnn_tpu.config import EngineConfig
from fastdnn_tpu.engine.scorer import Scorer
from fastdnn_tpu.models.feedforward import random_net
from fastdnn_tpu.ops import hidden_kernel as hk
from fastdnn_tpu.ops.matmul import hidden_layer_step
from fastdnn_tpu.quant.quantize import quantize_net


def _layer(b, k, n, seed=0):
    r = np.random.default_rng(seed)
    x = r.integers(-128, 128, (b, k)).astype(np.int8)
    w = r.integers(-40, 41, (k, n)).astype(np.int8)
    colsum = 128 * w.astype(np.int32).sum(0)
    inv = np.float32(1.0 / (60.0 * 255.0))
    bias = r.normal(0, 1, n).astype(np.float32)
    return x, w, colsum, inv, bias


def _xla(x, w, colsum, inv, bias):
    # the jitted XLA step is the oracle (eager evaluation may round the
    # linear activation differently)
    return np.asarray(jax.jit(hidden_layer_step)(x, w, colsum, inv, bias))


@pytest.mark.parametrize(
    "tiling",
    [(128, 128, 128, 4, 3), (64, 64, 128, 4, 3), (32, 128, 64, 4, 2), (64, 256, 128, 8, 3)],
    ids=lambda t: "bm{}_bn{}_bk{}".format(*t[:3]),
)
def test_bitwise_equal_to_xla_step(tiling):
    bm, bn, bk, nw, ns = tiling
    x, w, colsum, inv, bias = _layer(256, 256, 256)
    got = hk.fused_hidden_layer(
        x, w.T.copy(), colsum, inv, bias, block_frames=bm, block_nodes=bn,
        block_k=bk, num_warps=nw, num_stages=ns, interpret=True,
    )
    want = _xla(x, w, colsum, inv, bias)
    assert got.dtype == jnp.int8 and got.shape == (256, 256)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert np.unique(want).size > 100  # the epilogue is really exercised


@pytest.mark.parametrize("b", [1, 37, 130, 1024])
def test_wrapper_pads_ragged_frame_counts(b):
    x, w, colsum, inv, bias = _layer(b, 128, 256, seed=b)
    got = hk.hidden_layer(x, w.T.copy(), colsum, inv, bias, interpret=True)
    assert got.shape == (b, 256)
    np.testing.assert_array_equal(np.asarray(got), _xla(x, w, colsum, inv, bias))


def test_tiling_keyed_on_frame_count():
    assert hk.tiling(8192) == hk.tiling(1024)
    assert hk.tiling(128) == hk.tiling(1)
    assert hk.tiling(512) not in (hk.tiling(128), hk.tiling(8192))
    big, small = hk.tiling(8192), hk.tiling(128)
    # small batches take smaller tiles, so more blocks fill the card
    assert small[0] * small[1] < big[0] * big[1]
    for t in (big, small):
        assert all(v & (v - 1) == 0 for v in t[:3])  # powers of two


def test_shape_checks():
    x, w, colsum, inv, bias = _layer(128, 128, 128)
    wt = w.T.copy()
    with pytest.raises(ValueError, match="K mismatch"):
        hk.fused_hidden_layer(x, wt[:, :64], colsum, inv, bias, interpret=True)
    with pytest.raises(ValueError, match="colsum/bias"):
        hk.fused_hidden_layer(x, wt, colsum[:64], inv, bias, interpret=True)
    with pytest.raises(ValueError, match="int8"):
        hk.fused_hidden_layer(x.astype(np.int32), wt, colsum, inv, bias, interpret=True)
    with pytest.raises(ValueError, match="tile"):
        hk.fused_hidden_layer(x[:100], wt, colsum, inv, bias, interpret=True)
    assert hk.tiles(256, 128, 384)
    assert not hk.tiles(256, 100, 384)


def test_prepare_net_pads_and_transposes_trunk():
    net = quantize_net(random_net(jax.random.PRNGKey(2), 40, [200, 200], 300))
    prep = hk.prepare_net(net)
    assert prep.hidden_kmajor and not net.hidden_kmajor
    # hidden widths padded to LANES and stored [N, K]; output layer [K, N]
    assert [w.shape for w in prep.weights] == [(256, 256), (256, 300)]
    assert prep.input_w.shape == (40, 256)
    np.testing.assert_array_equal(
        np.asarray(prep.weights[0])[:200, :200], np.asarray(net.weights[0]).T
    )
    assert prep.output_dim == 300
    assert hk.prepare_net(prep) is prep  # idempotent


def test_prepare_net_leaves_int4_trunk_to_xla():
    net = quantize_net(random_net(jax.random.PRNGKey(2), 40, [128, 128], 64), hidden_bits=4)
    assert hk.prepare_net(net) is net


def test_kernel_net_scores_like_plain_net(small_net, rng):
    """Padding + K-major storage are inert: hidden activations bitwise,
    posteriors to f32 roundoff."""
    qnet = quantize_net(small_net)
    frames = rng.standard_normal((50, 432)).astype(np.float32)
    plain = Scorer(qnet, EngineConfig(backend="xla"))
    kern = Scorer(qnet, EngineConfig(backend="pallas", interpret=True))
    assert kern.net.hidden_kmajor and not plain.net.hidden_kmajor
    pf, _ = plain._prepare(frames)
    np.testing.assert_array_equal(
        np.asarray(kern._hidden(kern.net, pf))[:, :256],
        np.asarray(plain._hidden(plain.net, pf)),
    )
    np.testing.assert_allclose(kern.score(frames), plain.score(frames), atol=1e-6)


@pytest.mark.parametrize(
    "backend,interpret,platform,want",
    [
        ("auto", False, "gpu", "pallas"),
        ("auto", False, "cpu", "xla"),
        ("auto", True, "cpu", "xla"),
        ("xla", False, "gpu", "xla"),
        ("pallas", False, "gpu", "pallas"),
        ("pallas", True, "cpu", "pallas"),
        ("pallas", False, "cpu", ValueError),
    ],
)
def test_backend_choice(backend, interpret, platform, want):
    cfg = EngineConfig(backend=backend, interpret=interpret)
    if want is ValueError:
        with pytest.raises(ValueError, match="GPU"):
            cfg.resolve_backend(platform)
    else:
        assert cfg.resolve_backend(platform) == want


def test_scorer_refuses_compiled_kernel_off_gpu(small_net):
    with pytest.raises(ValueError, match="GPU"):
        Scorer(quantize_net(small_net), EngineConfig(backend="pallas"))


def test_kmajor_flag_is_static_metadata():
    net = hk.prepare_net(quantize_net(random_net(jax.random.PRNGKey(1), 8, [128, 128], 16)))
    leaves, treedef = jax.tree_util.tree_flatten(net)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.hidden_kmajor
    assert dataclasses.replace(net, hidden_kmajor=False).hidden_kmajor is False


@pytest.mark.gpu
@pytest.mark.parametrize("b", [128, 8192])
def test_compiled_kernel_matches_xla_on_gpu(gpu_device, b):
    """The compiled Triton kernel, bitwise against the XLA step, at the
    flagship width."""
    x, w, colsum, inv, bias = _layer(b, 2048, 2048)
    got = jax.jit(hk.hidden_layer)(x, w.T.copy(), colsum, inv, bias)
    np.testing.assert_array_equal(np.asarray(got), _xla(x, w, colsum, inv, bias))
