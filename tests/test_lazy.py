"""Gathered lazy-output tests: the capacity-bounded gathered matmul must be
numerically identical to the dense masked path, across modes and semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastdnn_tpu.config import EngineConfig
from fastdnn_tpu.engine.lazy import union_active_indices
from fastdnn_tpu.engine.scorer import Scorer
from fastdnn_tpu.models.feedforward import random_net
from fastdnn_tpu.quant.quantize import quantize_net


@pytest.fixture(scope="module")
def qnet():
    return quantize_net(random_net(jax.random.PRNGKey(3), 432, [256, 256], 640))


def masks_at_density(rng, n, dim, density):
    return (rng.random((n, dim)) < density).astype(np.uint8)


class TestUnionIndices:
    def test_union_and_padding(self):
        masks = np.zeros((3, 10), np.uint8)
        masks[0, 2] = masks[1, 5] = masks[2, 2] = 1
        idx, count = union_active_indices(masks, capacity=4)
        assert count == 2
        np.testing.assert_array_equal(idx, [2, 5, 0, 0])

    def test_capacity_overflow(self):
        masks = np.ones((1, 10), np.uint8)
        with pytest.raises(ValueError):
            union_active_indices(masks, capacity=4)


class TestGatheredVsDense:
    @pytest.mark.parametrize("semantics", ["reference", "active_only"])
    def test_matches_dense(self, qnet, features_16khz, rng, semantics):
        frames = features_16khz[:16]
        masks = masks_at_density(rng, 16, qnet.output_dim, 0.3)
        # capacity must cover the union across frames: independent random
        # masks saturate fast (real decoder masks evolve slowly instead)
        dense = Scorer(
            qnet, EngineConfig(backend="xla", lazy_mode="dense", lazy_semantics=semantics)
        ).score_masked(frames, masks)
        gathered = Scorer(
            qnet,
            EngineConfig(
                backend="xla", lazy_mode="gathered", lazy_semantics=semantics, lazy_capacity=1.0
            ),
        ).score_masked(frames, masks)
        np.testing.assert_allclose(gathered, dense, atol=2e-6)

    def test_auto_mode_resolves_to_dense(self, qnet, rng):
        """"auto" never dispatches gathered — the gathered matmul runs only
        on explicit lazy_mode="gathered" (config.lazy_mode)."""
        sc = Scorer(qnet, EngineConfig(backend="xla", lazy_mode="auto"))
        masks_small = masks_at_density(rng, 1, qnet.output_dim, 0.3)
        assert not sc._use_gathered(1, masks_small)
        assert not sc._use_gathered(4096, masks_small)
        explicit = Scorer(
            qnet, EngineConfig(backend="xla", lazy_mode="gathered", lazy_capacity=1.0)
        )
        assert explicit._use_gathered(1, masks_small)

    def test_gathered_mode_overflow_raises(self, qnet, features_16khz):
        sc = Scorer(qnet, EngineConfig(backend="xla", lazy_mode="gathered"))
        masks = np.ones((4, qnet.output_dim), np.uint8)
        with pytest.raises(ValueError):
            sc.score_masked(features_16khz[:4], masks)

    def test_lazy_context_uses_gathered(self, qnet, features_16khz, rng):
        """Frame-by-frame context agrees with the dense batched path."""
        sc = Scorer(
            qnet, EngineConfig(backend="xla", lazy_mode="gathered", lazy_capacity=1.0)
        )
        dense_sc = Scorer(qnet, EngineConfig(backend="xla", lazy_mode="dense"))
        n = 5
        masks = masks_at_density(rng, n, qnet.output_dim, 0.35)
        expected = dense_sc.score_masked(features_16khz[:n], masks)
        ctx = sc.new_lazy_context(n)
        ctx.calculate_until_output(features_16khz[:n])
        for i in range(n):
            out = ctx.calculate_for_output_nodes(masks[i])
            np.testing.assert_allclose(out, expected[i], atol=2e-6)

    def test_inactive_posteriors_reference_semantics(self, qnet, features_16khz, rng):
        """Gathered path keeps the reference's exp(0) mass on inactive nodes."""
        sc = Scorer(
            qnet, EngineConfig(backend="xla", lazy_mode="gathered", lazy_capacity=1.0)
        )
        masks = masks_at_density(rng, 4, qnet.output_dim, 0.3)
        out = sc.score_masked(features_16khz[:4], masks)
        assert np.all(out[masks == 0] > 0)
        # all inactive posteriors within a frame share the same exp(0) value
        for i in range(4):
            vals = out[i][masks[i] == 0]
            np.testing.assert_allclose(vals, vals[0], rtol=1e-5)


def test_fully_masked_frame_active_only_yields_zeros(qnet, features_16khz):
    """A frame whose mask has no active senones gets all-zero posteriors
    under active_only semantics — identically with and without the fused
    hidden kernel."""
    import numpy as np

    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer

    frames = features_16khz[:4]
    masks = np.ones((4, qnet.output_dim), np.uint8)
    masks[2] = 0  # one dead frame
    for cfg in (
        EngineConfig(backend="xla", lazy_semantics="active_only", lazy_mode="dense"),
        EngineConfig(
            backend="pallas", interpret=True, lazy_semantics="active_only", lazy_mode="dense"
        ),
    ):
        out = Scorer(qnet, cfg).score_masked(frames, masks)
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(out[2], 0.0)
        np.testing.assert_allclose(out[[0, 1, 3]].sum(-1), 1.0, rtol=1e-4)


class TestKernelBackendLazy:
    """Masked scoring with the fused hidden kernel (interpret mode) must
    match the XLA engine: the kernel changes only how the hidden layers
    run, never the masked output layer."""

    @pytest.mark.parametrize("semantics", ["reference", "active_only"])
    def test_matches_xla_engine(self, qnet, rng, semantics):
        frames = rng.standard_normal((64, 432)).astype(np.float32)
        masks = (rng.random((64, qnet.output_dim)) < 0.4).astype(np.uint8)
        masks[5] = 0
        xla = Scorer(
            qnet, EngineConfig(backend="xla", lazy_semantics=semantics)
        ).score_masked(frames, masks)
        kern = Scorer(
            qnet,
            EngineConfig(backend="pallas", interpret=True, lazy_semantics=semantics),
        ).score_masked(frames, masks)
        np.testing.assert_allclose(kern, xla, atol=1e-6)
