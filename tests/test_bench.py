"""Smoke tests for the bench harness itself (bench.py at the repo root).

Its numbers come from a GPU run; these tests only pin the harness
mechanics on CPU: the chained-repetition marginal produces a finite
positive rate, and both feedback forms score full posteriors.
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


@pytest.fixture(scope="module")
def scorer():
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer
    from fastdnn_tpu.models.feedforward import random_net
    from fastdnn_tpu.quant.quantize import quantize_net

    # the posterior-feedback chain slices the first input_dim columns of
    # the posteriors, so (like every bench config) output_dim >= input_dim
    net = random_net(jax.random.PRNGKey(3), 96, [128, 128], 500)
    return Scorer(quantize_net(net), EngineConfig(backend="xla"))


def test_chained_marginal_finite(scorer):
    frames = jax.numpy.asarray(
        np.random.default_rng(0).standard_normal((64, scorer.input_dim)).astype(np.float32)
    )
    fps = bench.chained_frames_per_s(
        lambda x: scorer._score(scorer.net, x),
        frames,
        reps_lo=1,
        reps_hi=3,
        iters=2,
    )
    assert np.isfinite(fps) and fps > 0


def test_feedback_modes_score_full_posteriors(scorer):
    """Both feedback modes drive full-width, normalized posteriors through
    the whole chain (opaque_output changes what is consumed, not scored)."""
    frames = jax.numpy.asarray(
        np.random.default_rng(1).standard_normal((32, scorer.input_dim)).astype(np.float32)
    )

    def chain(opaque):
        x = frames
        for _ in range(3):
            p = scorer._score(scorer.net, x)
            x = p[:, : scorer.input_dim] * 50.0
            if not opaque:
                x = x + jax.numpy.sum(p, axis=1, keepdims=True)
        return np.asarray(p)

    for opaque in (True, False):
        p = chain(opaque)
        assert p.shape == (32, scorer.output_dim)
        assert np.isfinite(p).all()
        np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-4)
