"""Cross-implementation parity against the REAL reference engine.

The golden files were produced by compiling the reference C++ engine
unmodified and running its CLI on a model written by OUR binary writer:

    g++ -O2 -msse4 -std=c++11 -o ref-dnn \
        /root/reference/src/cpp/dnn.cc /root/reference/src/cpp/float_dnn.cc
    ref-dnn tests/golden/parity_model.bin \
        /root/reference/data/8khz.aligned.bin ref_out.txt TXT

(reference CLI: cutoff 3, batch 8, dnn.cc:20-84).  That run proves two
things at once: the reference binary parses our model files byte-for-byte,
and our quantized posteriors match its actual SSE int8 output — not just
our own float oracle.

Model: 429 -> 3x64 sigmoid -> 100 softmax, align(4,16) -> 432 input
(random_net(PRNGKey(11)), tools/make_reference_golden.py regenerates).

Expected divergences are all sub-quantization-noise here: our exact int32
accumulation vs _mm_maddubs_epi16 16-bit pairwise saturation (dnn.cc:340;
no saturation occurs at these magnitudes), our stable vs the reference's
unstable softmax (dnn.cc:534-544), and f32 summation order.  Observed:
max |dp| ~1.4e-4, summed |dp| per senone ~0.011; the reference's own
FuncTest gate is summed |dp| < 0.1 (FuncTest.java:70-72) — we assert 5x
tighter.
"""

import os

import numpy as np
import pytest

from fastdnn_tpu.config import EngineConfig
from fastdnn_tpu.engine.scorer import Scorer
from fastdnn_tpu.formats.binary import read_features, read_model
from fastdnn_tpu.models.feedforward import from_raw
from fastdnn_tpu.quant.quantize import quantize_net

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
#: directory of the reference's bundled data (its 8khz.aligned.bin)
REFERENCE_DATA_ENV = "FASTDNN_REFERENCE_DATA"


@pytest.fixture(scope="module")
def reference_frames():
    """The reference's own 8khz.aligned.bin.  The golden posteriors are the
    reference engine's output on exactly these frames, so seeded stand-ins
    cannot replace them: without the file these tests skip."""
    path = os.path.join(os.environ.get(REFERENCE_DATA_ENV, ""), "8khz.aligned.bin")
    if not os.path.isfile(path):
        pytest.skip(
            f"golden oracle needs the reference's 8khz.aligned.bin; set "
            f"{REFERENCE_DATA_ENV} to the reference's data directory"
        )
    return read_features(path)


@pytest.fixture(scope="module")
def golden(reference_frames):
    model = read_model(os.path.join(GOLDEN, "parity_model.bin"))
    ref = read_features(os.path.join(GOLDEN, "parity_ref_posteriors.bin"))
    return model, reference_frames, ref


@pytest.mark.parametrize("backend_kw", [
    dict(backend="xla"),
    dict(backend="pallas", interpret=True),
])
def test_posteriors_match_reference_engine(golden, backend_kw):
    raw, frames, ref = golden
    qnet = quantize_net(from_raw(raw), cutoff=3.0)  # CLI hardcodes 3 (dnn.cc:60)
    ours = Scorer(qnet, EngineConfig(**backend_kw)).score(frames)
    assert ours.shape == ref.shape
    d = np.abs(ours - ref)
    assert d.max() < 5e-4, f"max |dp| {d.max():.2e} vs reference engine"
    # the reference's own acceptance gate (0.1), 5x tightened
    assert d.sum(axis=0).max() < 0.02
    np.testing.assert_array_equal(ours.argmax(1), ref.argmax(1))


@pytest.mark.parametrize("backend_kw", [
    dict(backend="xla"),
    dict(backend="pallas", interpret=True),
])
def test_lazy_posteriors_match_reference_engine(golden, backend_kw):
    """Lazy-path parity against the reference's ACTUAL masked scorer
    (CalculationContext::LazyOutputActivations, dnn.cc:355-392), driven by
    tools/ref_lazy_harness.cc — the reference CLI never exposed it.  Masks
    are FuncTest-style evolving beam masks at 40% density; the default
    softmax-over-zeros semantics must reproduce the reference's inactive
    1/Z rows exactly (tools/make_reference_golden.py regenerates)."""
    raw, frames, _ = golden
    masks = (read_features(os.path.join(GOLDEN, "lazy_masks.bin")) != 0).astype(np.uint8)
    ref = read_features(os.path.join(GOLDEN, "lazy_ref_posteriors.bin"))
    frames = frames[: masks.shape[0]]
    qnet = quantize_net(from_raw(raw), cutoff=3.0)
    ours = Scorer(qnet, EngineConfig(**backend_kw)).score_masked(frames, masks)
    assert ours.shape == ref.shape
    d = np.abs(ours - ref)
    assert d.max() < 5e-4, f"lazy max |dp| {d.max():.2e} vs reference engine"
    assert d.sum(axis=0).max() < 0.02  # 5x inside the reference's own gate
    np.testing.assert_array_equal(ours.argmax(1), ref.argmax(1))


def test_reference_tolerance_gate_semantics(golden):
    """The gate above implies the reference's own diff() check passes
    (FuncTest.java:59-74: flag any senone whose summed |dp| across frames
    exceeds 0.1)."""
    raw, frames, ref = golden
    qnet = quantize_net(from_raw(raw))
    ours = Scorer(qnet, EngineConfig(backend="xla")).score(frames)
    flagged = (np.abs(ours - ref).sum(axis=0) > 0.1).sum()
    assert flagged == 0


class TestFlagshipScale:
    """Cross-engine agreement at the flagship 7x2048/8000 shape, built by
    the reference's own big-net recipe (FuncTest.java:21-28: small net ->
    extend(2048, 8000) -> saveBinary).  The 165 MB extended model is not
    checked in: it re-derives deterministically (pure numpy circular
    cloning, no PRNG) from the checked-in seed, and the golden posteriors
    came from the compiled reference engine scoring that exact model.

    This is the scale where quantizer dynamics differ from the toy net:
    per-layer multipliers over 2048-wide layers, softmax over 8000 senones
    (7900 of them the recipe's zero-weight synthetic columns, which dilute
    every posterior — the reference's own FuncTest workload has the same
    property and gates only summed |dp|, not argmax).
    """

    @pytest.fixture(scope="class")
    def flagship(self, reference_frames):
        from fastdnn_tpu.models.feedforward import extend

        seed = from_raw(read_model(os.path.join(GOLDEN, "flagship_seed_model.bin")))
        big = extend(seed, 2048, 8000)
        assert [w.shape for w in big.weights[1:]] == [(2048, 2048)] * 6 + [(2048, 8000)]
        ref = read_features(os.path.join(GOLDEN, "flagship_ref_posteriors.bin"))
        frames = reference_frames[: ref.shape[0]]
        return big, frames, ref

    def test_posteriors_match_reference_engine(self, flagship):
        big, frames, ref = flagship
        qnet = quantize_net(big, cutoff=3.0)
        ours = Scorer(qnet, EngineConfig(backend="xla")).score(frames)
        assert ours.shape == ref.shape == (32, 8000)
        d = np.abs(ours - ref)
        assert d.max() < 5e-4, f"max |dp| {d.max():.2e} vs reference at flagship scale"
        # 10x tighter than the reference's own 0.1 acceptance gate
        assert d.sum(axis=0).max() < 0.01
        # argmax must agree wherever the winner is resolvable above the
        # cross-engine noise floor (the synthetic zero columns flatten
        # posteriors, so unconditional argmax equality would gate on
        # tie-breaking noise)
        margin = np.sort(ref, axis=1)
        resolvable = (margin[:, -1] - margin[:, -2]) > 5e-6
        assert resolvable.any()
        np.testing.assert_array_equal(
            ours[resolvable].argmax(1), ref[resolvable].argmax(1)
        )


class TestQuantizerDivergence:
    """The one DOCUMENTED divergence from the reference, measured instead of
    asserted by reasoning: the reference fails to clamp positive weight
    outliers before rounding (its max-side clamp tests minWeight > maxWeight,
    /root/reference/src/cpp/dnn.cc:496-498), so w > cutoff quantizes to
    round(w * multiplier) > 127 and overflows signed char (e.g. 5.0 * 42 ->
    210 -> -46).  Our quantizer clamps both sides (quant/quantize.py).  The
    golden model plants 24 positive outliers in (3.5, 6.0); the golden
    posteriors are the compiled reference engine's actual output on it.
    """

    @pytest.fixture(scope="class")
    def divergence(self, reference_frames):
        raw = read_model(os.path.join(GOLDEN, "divergence_model.bin"))
        ref = read_features(os.path.join(GOLDEN, "divergence_ref_posteriors.bin"))
        return raw, reference_frames, ref

    def test_divergence_is_real_and_bounded(self, divergence):
        raw, frames, ref = divergence
        qnet = quantize_net(from_raw(raw), cutoff=3.0)
        ours = Scorer(qnet, EngineConfig(backend="xla")).score(frames)
        per_senone = np.abs(ours - ref).sum(axis=0)
        # the divergence EXISTS (the golden genuinely exercises the path:
        # the reference's own 0.1 gate would flag it)...
        assert per_senone.max() > 0.5
        # ...but stays bounded: posterior-level damage from 24 overflowed
        # weights out of ~37k (argmax unaffected on this workload)
        assert per_senone.max() < 5.0
        np.testing.assert_array_equal(ours.argmax(1), ref.argmax(1))

    def test_our_clamp_is_closer_to_float_oracle(self, divergence):
        """The fix must be an improvement, not just a difference: against
        the float forward pass (the reference's own accuracy oracle,
        FuncTest.java:59-74), our clamped quantization shows ~10x less
        total error than the reference's overflowing quantization."""
        from fastdnn_tpu.models.feedforward import forward

        raw, frames, ref = divergence
        net = from_raw(raw)
        oracle = np.asarray(forward(net, frames))
        ours = Scorer(quantize_net(net, cutoff=3.0), EngineConfig(backend="xla")).score(
            frames
        )
        err_ours = np.abs(ours - oracle).sum()
        err_ref = np.abs(ref - oracle).sum()
        assert err_ours * 5 < err_ref, (
            f"clamped quantization (total |err| {err_ours:.2f}) should beat "
            f"the reference's overflow (total |err| {err_ref:.2f}) by >= 5x"
        )


@pytest.mark.slow
def test_cross_engine_property_sweep(tmp_path):
    """Property-based parity: random topologies through BOTH engines
    (tools/compare_engines.py) — every trial must sit 5x inside the
    reference's own acceptance gate with full resolvable-argmax agreement."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "compare_engines.py"),
         "--trials", "4", "--seed", "7"],
        env=env, capture_output=True, text=True, timeout=500, cwd=repo,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "4/4 trials inside the tight gate" in r.stdout
