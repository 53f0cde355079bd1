"""End-to-end engine tests: quantized forward vs float oracle (the
reference's diff() discipline, /root/reference/test/java/suskun/nn/
FuncTest.java:59-74), lazy/masked semantics, and API behavior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastdnn_tpu.config import EngineConfig
from fastdnn_tpu.engine.scorer import Scorer
from fastdnn_tpu.models import feedforward as ff
from fastdnn_tpu.quant.quantize import quantize_net


def generate_masks(rng, count, dim, active, churn):
    """Evolving decoder masks: random initial set at the target density,
    then +/-churn nodes per frame (mirrors FuncTest.generateMasks,
    /root/reference/test/java/suskun/nn/FuncTest.java:121-154)."""
    masks = np.zeros((count, dim), dtype=np.uint8)
    idx = rng.choice(dim, size=active, replace=False)
    masks[0, idx] = 1
    for i in range(1, count):
        masks[i] = masks[i - 1]
        off = np.flatnonzero(masks[i] == 0)
        on = np.flatnonzero(masks[i] == 1)
        masks[i, rng.choice(off, size=min(churn, off.size), replace=False)] = 1
        masks[i, rng.choice(on, size=min(churn, on.size), replace=False)] = 0
    return masks


@pytest.fixture(scope="module")
def scorer(small_net):
    return Scorer(quantize_net(small_net, cutoff=3.0))


@pytest.fixture(scope="module")
def frames_16khz(features_16khz):
    return features_16khz  # 100 x 432


class TestGoldenParity:
    def test_quantized_vs_float_reference_tolerance(self, small_net, scorer, frames_16khz):
        """The reference accepts summed |Δ| <= 0.1 per output across 100
        frames vs its float model (FuncTest.java:70-72)."""
        float_post = np.asarray(ff.forward(small_net, jnp.asarray(frames_16khz)))
        q_post = scorer.score(frames_16khz)
        assert q_post.shape == float_post.shape
        summed_abs = np.abs(q_post - float_post).sum(axis=0)  # per output node
        assert summed_abs.max() < 0.1, f"max summed |d| = {summed_abs.max()}"
        np.testing.assert_allclose(q_post.sum(-1), 1.0, rtol=1e-4)

    def test_quantized_vs_float_8khz(self, small_net, scorer, features_8khz):
        float_post = np.asarray(ff.forward(small_net, jnp.asarray(features_8khz)))
        q_post = scorer.score(features_8khz)
        summed_abs = np.abs(q_post - float_post).sum(axis=0)
        # 389 frames -> scale the per-100-frame budget like the reference's
        assert summed_abs.max() < 0.1 * (389 / 100)

    def test_unfused_vs_fused_transform_same_result(self, small_net, frames_16khz):
        """Fusing shift/scale into the first layer must not change scores."""
        q_fused = Scorer(quantize_net(small_net, fuse_input_transform=True))
        pre = ff.fuse_transform(small_net)
        q_manual = Scorer(quantize_net(pre, fuse_input_transform=False))
        a = q_fused.score(frames_16khz[:16])
        b = q_manual.score(frames_16khz[:16])
        np.testing.assert_allclose(a, b, atol=2e-5)


class TestIntegerOracle:
    def test_engine_matches_numpy_quant_pipeline(self, small_net, scorer, frames_16khz):
        """Independent numpy reimplementation of the quantized pipeline
        (uint8 LUT sigmoid, exact integer dots, per-layer dequant) must match
        the engine almost exactly — the only legitimate divergence is +/-1
        sigmoid count from f32 summation order in the float input layer."""
        from fastdnn_tpu.ops.sigmoid import reference_lut_lookup

        qnet = scorer.net
        n = 32
        x = frames_16khz[:n].astype(np.float64)
        lin = x @ np.asarray(qnet.input_w).astype(np.float64) + np.asarray(qnet.input_b)
        a_u8 = reference_lut_lookup(lin.astype(np.float32)).astype(np.int64)
        for i in range(len(qnet.weights)):
            w = np.asarray(qnet.weights[i]).astype(np.int64)
            acc = a_u8 @ w
            lin = acc.astype(np.float64) * float(qnet.inv_scales[i]) + np.asarray(
                qnet.biases[i]
            )
            if i < len(qnet.weights) - 1:
                a_u8 = reference_lut_lookup(lin.astype(np.float32)).astype(np.int64)
        e = np.exp(lin - lin.max(-1, keepdims=True))
        oracle = (e / e.sum(-1, keepdims=True)).astype(np.float32)
        ours = scorer.score(frames_16khz[:n])
        np.testing.assert_allclose(ours, oracle, atol=2e-3)


class TestScoreAPI:
    def test_empty_input(self, scorer):
        out = scorer.score(np.zeros((0, 432), np.float32))
        assert out.shape == (0, scorer.output_dim)

    def test_narrow_input_padded(self, scorer, frames_16khz):
        """429-dim raw features are zero-padded to the 432 network input,
        like the reference x4 alignment path."""
        out_429 = scorer.score(frames_16khz[:8, :429])
        out_432 = scorer.score(frames_16khz[:8])
        np.testing.assert_array_equal(out_429, out_432)

    def test_too_wide_input_rejected(self, scorer):
        with pytest.raises(ValueError):
            scorer.score(np.zeros((4, 500), np.float32))

    def test_bucketing_consistency(self, scorer, frames_16khz):
        """Scores must not depend on the padded bucket size."""
        full = scorer.score(frames_16khz)
        prefix = scorer.score(frames_16khz[:37])
        np.testing.assert_array_equal(full[:37], prefix)

    def test_single_frame(self, scorer, frames_16khz):
        one = scorer.score(frames_16khz[:1])
        full = scorer.score(frames_16khz)
        np.testing.assert_allclose(one[0], full[0], atol=1e-6)


class TestLazyMasked:
    def test_all_ones_mask_matches_reference_semantics(self, scorer, frames_16khz):
        """With a full mask, masked scoring equals plain scoring."""
        n = 16
        masks = np.ones((n, scorer.output_dim), np.uint8)
        full = scorer.score(frames_16khz[:n])
        masked = scorer.score_masked(frames_16khz[:n], masks)
        np.testing.assert_allclose(masked, full, atol=1e-6)

    def test_reference_zero_logit_semantics(self, scorer, frames_16khz, rng):
        """Inactive senones keep logit 0 and contribute exp(0)=1 to the
        denominator (/root/reference/src/cpp/dnn.cc:369-389)."""
        n, out = 8, scorer.output_dim
        masks = generate_masks(rng, n, out, active=out // 2, churn=out // 32)
        res = scorer.score_masked(frames_16khz[:n], masks)
        # manual recomputation from full logits
        cfg = scorer.config
        from fastdnn_tpu.engine.scorer import hidden_forward, output_logits

        acts = hidden_forward(scorer.net, jnp.asarray(scorer._prepare(frames_16khz[:n])[0]))
        logits = np.asarray(output_logits(scorer.net, acts))[:n]
        z = np.where(masks != 0, logits, 0.0)
        e = np.exp(z - z.max(-1, keepdims=True))
        expected = e / e.sum(-1, keepdims=True)
        np.testing.assert_allclose(res, expected, rtol=1e-4, atol=1e-6)
        # inactive nodes share the uniform exp(0) mass, not zero
        inactive = res[masks == 0]
        assert np.all(inactive > 0)

    def test_active_only_semantics(self, small_net, frames_16khz, rng):
        cfg = EngineConfig(lazy_semantics="active_only")
        sc = Scorer(quantize_net(small_net), cfg)
        n, out = 8, sc.output_dim
        masks = generate_masks(rng, n, out, active=out // 3, churn=out // 32)
        res = sc.score_masked(frames_16khz[:n], masks)
        assert np.all(res[masks == 0] == 0.0)
        np.testing.assert_allclose(res.sum(-1), 1.0, rtol=1e-4)

    def test_lazy_context_frame_by_frame(self, scorer, frames_16khz, rng):
        """LazyContext mirrors the reference API and must agree with the
        batched masked path."""
        n, out = 6, scorer.output_dim
        masks = generate_masks(rng, n, out, active=out // 2, churn=out // 32)
        batched = scorer.score_masked(frames_16khz[:n], masks)
        ctx = scorer.new_lazy_context(n)
        ctx.calculate_until_output(frames_16khz[:n])
        for i in range(n):
            res = ctx.calculate_for_output_nodes(masks[i])
            np.testing.assert_allclose(res, batched[i], atol=1e-5)
        with pytest.raises(IndexError):
            ctx.calculate_for_output_nodes(masks[0])

    def test_lazy_context_requires_hidden_pass(self, scorer):
        ctx = scorer.new_lazy_context(4)
        with pytest.raises(RuntimeError):
            ctx.calculate_for_output_nodes(np.ones(scorer.output_dim, np.uint8))

    def test_mask_shape_validated(self, scorer, frames_16khz):
        with pytest.raises(ValueError):
            scorer.score_masked(frames_16khz[:4], np.ones((3, scorer.output_dim)))
