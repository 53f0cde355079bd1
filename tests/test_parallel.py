"""Multi-device sharding tests on the forced 8-device CPU mesh.

Validates that data-parallel frames + tensor-parallel output layer produce
posteriors identical to the single-device engine, for both the GSPMD path
and the explicit shard_map/psum path (SURVEY.md §2 new-components table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastdnn_tpu.config import EngineConfig
from fastdnn_tpu.engine.scorer import Scorer
from fastdnn_tpu.models.feedforward import random_net
from fastdnn_tpu.parallel import mesh as pmesh
from fastdnn_tpu.parallel.sharded import make_gspmd_scorer, score_shard_map
from fastdnn_tpu.quant.quantize import pad_qnet, quantize_net


@pytest.fixture(scope="module")
def qnet():
    net = random_net(jax.random.PRNGKey(7), 432, [256, 256], 512)
    return quantize_net(net)


@pytest.fixture(scope="module")
def frames(features_16khz):
    return jnp.asarray(features_16khz[:64])  # 64 divides the 8-dev data axis


def single_device_reference(qnet, frames, masks=None):
    sc = Scorer(qnet, EngineConfig(backend="xla"))
    if masks is None:
        return sc.score(np.asarray(frames))
    return sc.score_masked(np.asarray(frames), np.asarray(masks))


class TestMesh:
    def test_make_mesh_shapes(self):
        assert len(jax.devices()) == 8
        m = pmesh.make_mesh()
        assert m.shape == {"data": 8, "model": 1}
        m2 = pmesh.make_mesh(model=2)
        assert m2.shape == {"data": 4, "model": 2}
        with pytest.raises(ValueError):
            pmesh.make_mesh(model=3)
        with pytest.raises(ValueError):
            pmesh.make_mesh(data=3, model=2)

    def test_shard_qnet_layout(self, qnet):
        m = pmesh.make_mesh(data=4, model=2)
        sharded = pmesh.shard_qnet(qnet, m)
        # output layer node dim split over 2 model shards
        out_w = sharded.weights[-1]
        assert out_w.sharding.spec == jax.sharding.PartitionSpec(None, "model")
        # hidden layers replicated
        assert sharded.weights[0].sharding.is_fully_replicated


class TestGSPMD:
    @pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
    def test_score_matches_single_device(self, qnet, frames, data, model):
        m = pmesh.make_mesh(data=data, model=model)
        score, _ = make_gspmd_scorer(m)
        out = np.asarray(score(qnet, frames))
        ref = single_device_reference(qnet, frames)
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_score_masked_matches(self, qnet, frames, rng):
        m = pmesh.make_mesh(data=4, model=2)
        _, score_masked = make_gspmd_scorer(m)
        masks = (rng.random((64, qnet.output_dim)) < 0.4).astype(np.uint8)
        out = np.asarray(score_masked(qnet, frames, jnp.asarray(masks)))
        ref = single_device_reference(qnet, frames, masks)
        np.testing.assert_allclose(out, ref, atol=2e-5)


class TestShardMap:
    @pytest.mark.parametrize("data,model", [(4, 2), (2, 4)])
    def test_explicit_collectives_match(self, qnet, frames, data, model):
        m = pmesh.make_mesh(data=data, model=model)
        out = np.asarray(score_shard_map(qnet, frames, m))
        ref = Scorer(qnet, EngineConfig(backend="xla")).score(np.asarray(frames))
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_masked_reference_semantics(self, qnet, frames, rng):
        m = pmesh.make_mesh(data=2, model=4)
        masks = (rng.random((64, qnet.output_dim)) < 0.4).astype(np.uint8)
        out = np.asarray(
            score_shard_map(qnet, frames, m, masks=jnp.asarray(masks))
        )
        ref = single_device_reference(qnet, frames, masks)
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_masked_active_only_semantics(self, qnet, frames, rng):
        m = pmesh.make_mesh(data=2, model=4)
        masks = (rng.random((64, qnet.output_dim)) < 0.4).astype(np.uint8)
        out = np.asarray(
            score_shard_map(
                qnet, frames, m, masks=jnp.asarray(masks), semantics="active_only"
            )
        )
        sc = Scorer(qnet, EngineConfig(backend="xla", lazy_semantics="active_only"))
        ref = sc.score_masked(np.asarray(frames), masks)
        np.testing.assert_allclose(out, ref, atol=2e-5)
        assert np.all(out[masks == 0] == 0.0)


class TestMeshScorer:
    """The unified engine API: Scorer(net, config, mesh=...) must equal the
    single-device Scorer on every public method, with Scorer-grade prep
    (frame bucketing, dim padding, mask handling) — VERDICT r1 #6."""

    def _frames(self, rng, n=100, dim=432):
        return rng.standard_normal((n, dim)).astype(np.float32)

    @pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
    def test_score_matches_single_device_xla(self, qnet, rng, data, model):
        frames = self._frames(rng)  # 100 frames: exercises bucketing too
        ref = Scorer(qnet, EngineConfig(backend="xla")).score(frames)
        sc = Scorer(qnet, EngineConfig(backend="xla"), mesh=pmesh.make_mesh(data=data, model=model))
        out = sc.score(frames)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=2e-5)

    @pytest.mark.parametrize("data,model", [(4, 2), (8, 1)])
    def test_pallas_stack_matches_single_device_pallas(self, qnet, rng, data, model):
        """mesh x pallas == single-device pallas: the mesh programs run the
        same fused hidden kernel per shard."""
        frames = self._frames(rng)
        cfg = EngineConfig(backend="pallas", interpret=True)
        ref = Scorer(qnet, cfg).score(frames)
        sc = Scorer(qnet, cfg, mesh=pmesh.make_mesh(data=data, model=model))
        out = sc.score(frames)
        # int8 activations are bit-identical; only the collective softmax
        # reduction order can differ
        np.testing.assert_allclose(out, ref, atol=2e-5)

    @pytest.mark.parametrize("backend_kw", [
        dict(backend="xla"),
        dict(backend="pallas", interpret=True),
    ])
    def test_score_masked_matches(self, qnet, rng, backend_kw):
        frames = self._frames(rng)
        masks = (rng.random((100, qnet.output_dim)) < 0.4).astype(np.uint8)
        ref = Scorer(qnet, EngineConfig(backend="xla")).score_masked(frames, masks)
        sc = Scorer(
            qnet, EngineConfig(**backend_kw), mesh=pmesh.make_mesh(data=2, model=4)
        )
        out = sc.score_masked(frames, masks)
        np.testing.assert_allclose(out, ref, atol=3e-5)

    def test_active_only_semantics_and_fully_masked_row(self, qnet, rng):
        frames = self._frames(rng, n=32)
        masks = (rng.random((32, qnet.output_dim)) < 0.4).astype(np.uint8)
        masks[5] = 0  # fully-masked frame -> all-zero row, not NaN
        cfg = EngineConfig(backend="xla", lazy_semantics="active_only")
        ref = Scorer(qnet, cfg).score_masked(frames, masks)
        sc = Scorer(qnet, cfg, mesh=pmesh.make_mesh(data=2, model=4))
        out = sc.score_masked(frames, masks)
        assert not np.isnan(out).any()
        np.testing.assert_array_equal(out[5], 0.0)
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_unpadded_feature_dim_and_odd_frame_count(self, rng):
        """Scorer-grade prep under a mesh: 429-dim features (pad to 432) and
        a frame count not divisible by anything."""
        from fastdnn_tpu.models.feedforward import random_net

        net = random_net(jax.random.PRNGKey(3), 429, [128, 128], 300)
        qnet = quantize_net(net)
        frames = rng.standard_normal((37, 429)).astype(np.float32)
        ref = Scorer(qnet, EngineConfig(backend="xla")).score(frames)
        sc = Scorer(qnet, EngineConfig(backend="xla"), mesh=pmesh.make_mesh(data=4, model=2))
        out = sc.score(frames)
        assert out.shape == (37, 300)
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_lazy_context(self, qnet, rng):
        frames = self._frames(rng, n=3)
        masks = (rng.random((3, qnet.output_dim)) < 0.4).astype(np.uint8)
        ref = Scorer(qnet, EngineConfig(backend="xla")).score_masked(frames, masks)
        sc = Scorer(qnet, EngineConfig(backend="xla"), mesh=pmesh.make_mesh(data=2, model=4))
        ctx = sc.new_lazy_context(3)
        ctx.calculate_until_output(frames)
        for i in range(3):
            row = ctx.calculate_for_output_nodes(masks[i])
            np.testing.assert_allclose(row, ref[i], atol=2e-5)

    def test_score_utterances(self, qnet, rng):
        utts = {f"u{i}": self._frames(rng, n=5 + 3 * i) for i in range(3)}
        ref = Scorer(qnet, EngineConfig(backend="xla")).score_utterances(utts)
        sc = Scorer(qnet, EngineConfig(backend="xla"), mesh=pmesh.make_mesh(data=4, model=2))
        out = sc.score_utterances(utts)
        for k in utts:
            np.testing.assert_allclose(out[k], ref[k], atol=2e-5)

    def test_gathered_mode_rejected(self, qnet):
        with pytest.raises(ValueError, match="gathered"):
            Scorer(
                qnet,
                EngineConfig(backend="xla", lazy_mode="gathered"),
                mesh=pmesh.make_mesh(data=2, model=4),
            )

    @pytest.mark.parametrize("data,model", [(2, 4), (4, 2), (8, 1)])
    def test_kernel_mesh_with_padded_senones(self, rng, data, model):
        """The fused hidden kernel (interpret mode) per shard with the
        cross-shard collective softmax must equal the single-device XLA
        engine, masked and unmasked, both semantics, including a
        fully-masked active_only row and a senone count (300) whose padding
        lands on the last model shard."""
        from fastdnn_tpu.models.feedforward import random_net

        net = random_net(jax.random.PRNGKey(9), 432, [128, 128], 300)
        q = quantize_net(net)
        frames = rng.standard_normal((64, 432)).astype(np.float32)
        masks = (rng.random((64, 300)) < 0.4).astype(np.uint8)
        masks[7] = 0
        mesh = pmesh.make_mesh(data=data, model=model)
        for semantics in ("reference", "active_only"):
            single = Scorer(q, EngineConfig(backend="xla", lazy_semantics=semantics))
            kern = Scorer(
                q,
                EngineConfig(backend="pallas", interpret=True, lazy_semantics=semantics),
                mesh=mesh,
            )
            assert kern.net.hidden_kmajor
            np.testing.assert_allclose(kern.score(frames), single.score(frames), atol=2e-5)
            km = kern.score_masked(frames, masks)
            np.testing.assert_allclose(km, single.score_masked(frames, masks), atol=2e-5)
            if semantics == "active_only":
                assert not np.isnan(km).any()
                np.testing.assert_array_equal(km[7], 0.0)

    @pytest.mark.parametrize("backend_kw", [
        dict(backend="xla"),
        dict(backend="pallas", interpret=True),
    ])
    def test_no_weight_allgather_in_compiled_program(self, qnet, backend_kw):
        """The production sharded path must never gather the model-sharded
        output weight to satisfy a kernel (the VERDICT r1 concern about
        opaque pallas_call under GSPMD): under shard_map the body only sees
        local shards, so the compiled HLO contains the softmax's small
        all-reduces but NO all-gather."""
        sc = Scorer(
            qnet, EngineConfig(**backend_kw), mesh=pmesh.make_mesh(data=2, model=4)
        )
        frames = jnp.zeros((256, qnet.input_dim), jnp.float32)
        hlo = sc._score.lower(sc.net, frames).compile().as_text()
        assert "all-gather" not in hlo, "sharded weight was gathered"
        assert "all-reduce" in hlo  # the pmax/psum softmax collectives

    def test_streaming_scorer_over_mesh(self, qnet, rng):
        """StreamingScorer composed with a mesh Scorer: batched submissions
        (masked and unmasked) resolve to single-device results — the
        multi-chip serving engine (VERDICT r1 next-step #4)."""
        from fastdnn_tpu.engine.stream import StreamingScorer

        single = Scorer(qnet, EngineConfig(backend="xla"))
        sc = Scorer(qnet, EngineConfig(backend="xla"), mesh=pmesh.make_mesh(data=4, model=2))
        with StreamingScorer(sc, max_batch_frames=512, max_wait_ms=2.0) as ss:
            utts = [self._frames(rng, n=rng.integers(1, 40)) for _ in range(6)]
            masks = (rng.random((utts[2].shape[0], qnet.output_dim)) < 0.4).astype(np.uint8)
            futs = [
                ss.submit(u, masks if i == 2 else None) for i, u in enumerate(utts)
            ]
            for i, (u, f) in enumerate(zip(utts, futs)):
                got = f.result(timeout=120)
                want = (
                    single.score_masked(u, masks) if i == 2 else single.score(u)
                )
                assert got.shape == (u.shape[0], qnet.output_dim)
                np.testing.assert_allclose(got, want, atol=2e-5)


def test_shard_map_active_only_fully_masked_row_is_zero(qnet, frames):
    """A frame whose mask is all-zero must yield an all-zero posterior row
    (not NaN) under active_only semantics — the shard_map path used to
    divide by a zero psum (ADVICE r1)."""
    masks = np.ones((64, qnet.output_dim), np.uint8)
    masks[3] = 0
    masks[17] = 0
    m = pmesh.make_mesh(data=2, model=4)
    out = np.asarray(
        score_shard_map(qnet, frames, m, masks=jnp.asarray(masks), semantics="active_only")
    )
    assert not np.isnan(out).any()
    np.testing.assert_array_equal(out[3], 0.0)
    np.testing.assert_array_equal(out[17], 0.0)


def test_shard_map_derives_out_dim_from_padded_net(small_net):
    """pad_qnet stamps the true senone count on the net, so the
    sharded path must exclude padding columns from the softmax WITHOUT the
    caller passing out_dim (ADVICE r1: silent divergence by default)."""
    from fastdnn_tpu.parallel.mesh import make_mesh
    from fastdnn_tpu.quant.quantize import pad_qnet, quantize_net

    qnet = quantize_net(small_net)  # 400 outputs
    padded = pad_qnet(qnet, out_lanes=256)  # -> 512
    assert padded.output_dim == 400 and padded.padded_output_dim == 512
    mesh = make_mesh(model=2)
    frames = np.random.default_rng(0).standard_normal((16, qnet.input_dim)).astype(np.float32)
    fp = jnp.pad(jnp.asarray(frames), ((0, 0), (0, padded.input_dim - qnet.input_dim)))
    out = np.asarray(score_shard_map(padded, fp, mesh))  # no out_dim passed
    expected = Scorer(qnet, EngineConfig(backend="xla")).score(frames)
    np.testing.assert_array_equal(out[:, 400:], 0.0)
    np.testing.assert_allclose(out[:, :400], expected, atol=1e-5)


def test_shard_map_excludes_mxu_padding_from_softmax(small_net):
    """With a pad_qnet-padded net (senone count not divisible by
    the model axis), score_shard_map must keep the zero-logit padding
    columns out of the softmax denominator and zero them in the output."""
    import jax
    import numpy as np

    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer
    from fastdnn_tpu.parallel.mesh import make_mesh
    from fastdnn_tpu.parallel.sharded import score_shard_map
    from fastdnn_tpu.quant.quantize import pad_qnet, quantize_net

    qnet = quantize_net(small_net)  # 400 outputs
    padded = pad_qnet(qnet, out_lanes=256)  # -> 512, 112 pad columns
    mesh = make_mesh(model=2)
    frames = np.random.default_rng(0).standard_normal((16, qnet.input_dim)).astype(np.float32)
    fp = jax.numpy.pad(
        jax.numpy.asarray(frames), ((0, 0), (0, padded.input_dim - qnet.input_dim))
    )
    out = np.asarray(score_shard_map(padded, fp, mesh, out_dim=qnet.output_dim))
    expected = Scorer(qnet, EngineConfig(backend="xla")).score(frames)
    np.testing.assert_array_equal(out[:, qnet.output_dim :], 0.0)
    np.testing.assert_allclose(out[:, : qnet.output_dim], expected, atol=1e-5)


def test_multihost_scorer_inert_single_process(qnet, rng):
    """With jax.process_count() == 1, MultiHostScorer must behave exactly
    like Scorer(mesh=...) (no broadcasts, no worker protocol), and refuse
    work after close() only when genuinely multi-process."""
    from fastdnn_tpu.parallel.service import MultiHostScorer

    mesh = pmesh.make_mesh(data=4, model=2)
    frames = rng.standard_normal((40, qnet.input_dim)).astype(np.float32)
    mh = MultiHostScorer(qnet, EngineConfig(backend="xla"), mesh)
    assert mh.is_coordinator
    plain = Scorer(qnet, EngineConfig(backend="xla"), mesh=mesh)
    np.testing.assert_array_equal(mh.score(frames), plain.score(frames))
    mh.worker_loop()  # no-op single-process
    mh.close()
    mh.score(frames)  # single-process close is inert too
    with pytest.raises(ValueError, match="requires a mesh"):
        MultiHostScorer(qnet, EngineConfig(backend="xla"), None)


def test_fast_posteriors_on_model_sharded_mesh(qnet):
    """fast_posteriors composes with tensor parallelism: the cross-shard
    softmax (stats, pmax/psum, normalize) stays exact in f32 and only the
    final posterior write narrows to bf16 — so mesh fast posteriors must
    match the f32 mesh result within bf16 rounding, on both backends."""
    rng = np.random.default_rng(21)
    frames = rng.standard_normal((64, qnet.input_dim)).astype(np.float32)
    for backend in ("pallas", "xla"):
        mesh = pmesh.make_mesh(data=2, model=4)
        want = Scorer(
            qnet, EngineConfig(backend=backend, interpret=True), mesh=mesh
        ).score(frames)
        sc = Scorer(
            qnet,
            EngineConfig(backend=backend, interpret=True, fast_posteriors=True),
            mesh=mesh,
        )
        padded, n = sc._prepare(frames)
        dev = sc.score_device(jnp.asarray(padded))
        assert dev.dtype == jnp.bfloat16  # the device-resident bandwidth win
        got = np.asarray(dev, np.float32)[:n, : sc.output_dim]
        np.testing.assert_allclose(got, want, atol=4e-3, err_msg=backend)
        # the host API stays f32-typed (converted), values unchanged
        np.testing.assert_allclose(sc.score(frames), want, atol=4e-3)
    # data-only mesh unchanged (single-device program per shard)
    Scorer(
        qnet,
        EngineConfig(backend="pallas", interpret=True, fast_posteriors=True),
        mesh=pmesh.make_mesh(data=8, model=1),
    )
