"""Quantization math tests: sigmoid LUT bit-exactness, multiplier math,
weight clamping, and the zero-point colsum identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastdnn_tpu.config import ACTIVATION_SCALE, WEIGHT_SCALE
from fastdnn_tpu.models.feedforward import random_net
from fastdnn_tpu.ops import sigmoid as qs
from fastdnn_tpu.ops.matmul import int8_matmul
from fastdnn_tpu.quant.quantize import quantize_layer, quantize_net


class TestQuantizedSigmoid:
    def test_lut_constants(self):
        """Spot-check the rebuilt LUT against hand-derived reference values
        (recipe: /root/reference/src/cpp/dnn.cc:100-115)."""
        lut = qs.build_reference_lut()
        assert lut.shape == (1280,)
        assert lut[640] == 128  # sigmoid(0)*255 = 127.5 -> round half away -> 128
        assert lut[0] == round(1 / (1 + np.exp(6.4)) * 255)  # x = -6.4
        assert lut[-1] == round(1 / (1 + np.exp(-6.39)) * 255)  # x = +6.39
        # monotone non-decreasing
        assert np.all(np.diff(lut.astype(np.int32)) >= 0)

    def test_closed_form_matches_lut_on_grid(self):
        """The closed form must reproduce the LUT exactly at every entry."""
        half = 640
        xs = (np.arange(-half, half) / 100.0).astype(np.float32)
        ours = np.asarray(qs.quantized_sigmoid_u8(jnp.asarray(xs)))
        lut = qs.build_reference_lut()
        np.testing.assert_array_equal(ours, lut)

    def test_closed_form_matches_lut_lookup_random(self, rng):
        """On random inputs, match the table-lookup oracle to <=1 count
        (half-way rounding of k may differ at f32 representation edges)."""
        xs = rng.uniform(-10, 10, 20000).astype(np.float32)
        ours = np.asarray(qs.quantized_sigmoid_u8(jnp.asarray(xs))).astype(np.int32)
        oracle = qs.reference_lut_lookup(xs).astype(np.int32)
        diff = np.abs(ours - oracle)
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.001

    def test_saturation(self):
        xs = jnp.asarray([-100.0, -6.4, -6.395, 6.395, 6.4, 100.0])
        out = np.asarray(qs.quantized_sigmoid_u8(xs))
        assert out[0] == 0 and out[1] == 0 and out[2] == 0
        assert out[3] == 255 and out[4] == 255 and out[5] == 255

    def test_shifted_i8(self):
        xs = jnp.asarray([-100.0, 0.0, 100.0])
        out = np.asarray(qs.quantized_sigmoid_shifted_i8(xs))
        assert out.dtype == np.int8
        np.testing.assert_array_equal(out, [-128, 0, 127])

    def test_shifted_equals_u8_minus_zero_point_everywhere(self, rng):
        """The shifted-int8 helper uses independent trimmed algebra (no
        clip, trunc rounding, direct floor form — ops/sigmoid.py); it must
        equal u8 - 128 on entries, half-cases, the saturated tail the
        dropped clip now handles implicitly, and sign edges."""
        xs = np.concatenate([
            (np.arange(-640, 640) / 100.0),               # every table entry
            (np.arange(-1290, 1290) / 200.0),             # all half-boundaries
            np.array([-0.0, 0.0, -1e30, 1e30, -6.4, 6.4, -6.405, 6.405,
                      -50.0, 50.0, -512.0, 512.0]),
            rng.uniform(-30, 30, 20000),
        ]).astype(np.float32)
        shifted = np.asarray(qs.quantized_sigmoid_shifted_i8(jnp.asarray(xs))).astype(np.int32)
        u8 = np.asarray(qs.quantized_sigmoid_u8(jnp.asarray(xs))).astype(np.int32)
        np.testing.assert_array_equal(shifted, u8 - qs.ZERO_POINT)


class TestQuantizeLayer:
    def test_multiplier_math(self):
        """multiplier = round(127 / absmax(clamped)) (dnn.cc:467-479)."""
        w = jnp.asarray([[0.5, -2.0], [1.0, 0.25]])
        w_q, mult = quantize_layer(w, cutoff=3.0)
        assert float(mult) == round(127 / 2.0)  # = 64
        np.testing.assert_array_equal(
            np.asarray(w_q), [[32, -128], [64, 16]]
        )  # round(0.5*64)=32, round(-2*64)=-128

    def test_cutoff_clamps_both_sides(self):
        """We clamp positive outliers too (the reference's positive-side
        clamp is dead code, dnn.cc:496-498 / SURVEY.md §2 #7)."""
        w = jnp.asarray([[5.0, -5.0, 3.0, -3.0]])
        w_q, mult = quantize_layer(w, cutoff=3.0)
        assert float(mult) == round(127 / 3.0)  # = 42
        np.testing.assert_array_equal(np.asarray(w_q), [[126, -126, 126, -126]])

    def test_int8_range(self, rng):
        w = jnp.asarray(rng.standard_normal((64, 64)).astype(np.float32) * 2)
        w_q, _ = quantize_layer(w, cutoff=3.0)
        assert w_q.dtype == jnp.int8
        aw = np.asarray(w_q).astype(np.int32)
        assert aw.min() >= -128 and aw.max() <= 127


class TestQuantizeNet:
    def test_structure(self, small_net):
        qnet = quantize_net(small_net, cutoff=3.0)
        assert qnet.input_dim == small_net.input_dim
        assert qnet.output_dim == small_net.output_dim
        assert qnet.layer_count == small_net.layer_count
        assert len(qnet.weights) == small_net.layer_count - 1
        for w in qnet.weights:
            assert w.dtype == jnp.int8
        for b in qnet.biases:
            assert b.dtype == jnp.float32

    def test_rejects_bad_cutoff(self, small_net):
        import pytest

        with pytest.raises(ValueError):
            quantize_net(small_net, cutoff=0.0)

    def test_colsum_identity(self, rng):
        """(a_u8 . w) == ((a_u8 - 128) . w) + colsum128 with exact int32."""
        a_u8 = rng.integers(0, 256, (16, 64), dtype=np.uint8)
        w = rng.integers(-128, 128, (64, 32)).astype(np.int8)
        colsum = 128 * w.astype(np.int32).sum(axis=0)
        shifted = (a_u8.astype(np.int32) - 128).astype(np.int8)
        acc = np.asarray(int8_matmul(jnp.asarray(shifted), jnp.asarray(w)))
        true = a_u8.astype(np.int64) @ w.astype(np.int64)
        np.testing.assert_array_equal(acc + colsum, true)

    def test_is_pytree(self, small_net):
        qnet = quantize_net(small_net)
        leaves = jax.tree_util.tree_leaves(qnet)
        assert all(hasattr(l, "dtype") for l in leaves)
        # jit-able as an argument
        f = jax.jit(lambda q: q.inv_scales[0] * 2)
        f(qnet)


class TestSerialization:
    def test_qnet_roundtrip(self, small_net, tmp_path):
        import numpy as np

        from fastdnn_tpu.engine.scorer import Scorer
        from fastdnn_tpu.quant.serialize import load_qnet, save_qnet

        qnet = quantize_net(small_net)
        path = tmp_path / "model.qnet.npz"
        save_qnet(qnet, path)
        back = load_qnet(path)
        for a, b in zip(
            jax.tree_util.tree_leaves(qnet), jax.tree_util.tree_leaves(back)
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert a.dtype == b.dtype
        # loaded net scores identically
        frames = np.zeros((4, 432), np.float32)
        np.testing.assert_array_equal(
            Scorer(back).score(frames), Scorer(qnet).score(frames)
        )

    def test_roundtrip_preserves_true_output_dim(self, small_net, tmp_path):
        from fastdnn_tpu.quant.quantize import pad_qnet
        from fastdnn_tpu.quant.serialize import load_qnet, save_qnet

        padded = pad_qnet(quantize_net(small_net), out_lanes=256)
        path = tmp_path / "padded.qnet.npz"
        save_qnet(padded, path)
        back = load_qnet(path)
        assert back.true_output_dim == padded.true_output_dim == 400
        assert back.output_dim == 400
        assert back.padded_output_dim == 512

    def test_version_check(self, small_net, tmp_path):
        import numpy as np
        import pytest

        from fastdnn_tpu.quant.serialize import load_qnet, save_qnet

        path = tmp_path / "m.npz"
        save_qnet(quantize_net(small_net), path)
        data = dict(np.load(path))
        data["format_version"] = np.int32(99)
        with open(path, "wb") as f:
            np.savez(f, **data)
        with pytest.raises(ValueError):
            load_qnet(path)


class TestInt4Trunk:
    """int4 hidden-trunk quantization (an extension; no reference analog —
    XLA packs s4 weights two per byte, halving weight bytes).  The output layer
    must stay int8 and accuracy must clear the reference's own float-oracle
    gate (FuncTest.java:70-72: summed |d| per node <= 0.1 over 100 frames)."""

    def test_dtypes_and_ranges(self, small_net):
        q = quantize_net(small_net, hidden_bits=4)
        for w in q.weights[:-1]:
            assert w.dtype == jnp.int4
            vals = np.asarray(w).astype(np.int32)
            # scale 7; the clip floor is -8 (one code point below the
            # symmetric scale, mirroring int8's -128): a rounded-up
            # multiplier can push w*mult just past the scale, and keeping
            # the extra negative code point halves that clipping error
            assert vals.min() >= -8 and vals.max() <= 7
        assert q.weights[-1].dtype == jnp.int8
        # colsum identity still holds layer-wise on int4 weights
        w0 = np.asarray(q.weights[0]).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(q.colsum128[0]), 128 * w0.sum(axis=0)
        )

    def test_float_oracle_reference_gate(self, small_net, features_16khz):
        from fastdnn_tpu import models
        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.engine.scorer import Scorer
        from fastdnn_tpu.models import feedforward as ff

        fl = np.asarray(ff.forward(small_net, jnp.asarray(features_16khz)))
        q4 = quantize_net(small_net, hidden_bits=4)
        p4 = Scorer(q4, EngineConfig(backend="xla")).score(features_16khz)
        summed = np.abs(p4 - fl).sum(axis=0)
        assert summed.max() < 0.1, f"int4 trunk fails the oracle gate: {summed.max()}"

    def test_backends_agree(self, small_net, features_16khz):
        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.engine.scorer import Scorer

        q4 = quantize_net(small_net, hidden_bits=4)
        px = Scorer(q4, EngineConfig(backend="xla")).score(features_16khz[:32])
        pp = Scorer(q4, EngineConfig(backend="pallas", interpret=True)).score(
            features_16khz[:32]
        )
        np.testing.assert_allclose(pp, px, atol=3e-5)

    def test_checkpoint_round_trip(self, small_net, tmp_path):
        from fastdnn_tpu.quant.serialize import load_quantized, save_qnet

        q4 = quantize_net(small_net, hidden_bits=4)
        path = tmp_path / "m4.npz"
        save_qnet(q4, path)
        q4b, desc = load_quantized(str(path))
        assert "int4-trunk" in desc
        for a, b in zip(q4.weights, q4b.weights):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(
                np.asarray(a).astype(np.int8), np.asarray(b).astype(np.int8)
            )

    def test_packed_trunk_is_pure_storage(self, small_net):
        """EngineConfig.int4_packed (the no-native-s4 alternative,
        quant.quantize.pack_int4_trunk): nibble-packed storage + in-program
        unpack is bitwise-identical to the jnp.int4 trunk — hidden
        activations equal exactly (integer math), posteriors equal across
        xla/pallas-interpret at the suite's bound."""
        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.engine.scorer import Scorer

        q4 = quantize_net(small_net, hidden_bits=4)
        rng = np.random.default_rng(9)
        frames = rng.standard_normal((64, q4.input_dim)).astype(np.float32)

        plain = Scorer(q4, EngineConfig(backend="xla"))
        packed = Scorer(q4, EngineConfig(backend="xla", int4_packed=True))
        assert packed.net.packed_int4 and not plain.net.packed_int4
        # weights really are half the rows (two nibbles per byte)
        for wp, w in zip(packed.net.weights[:-1], plain.net.weights[:-1]):
            assert wp.dtype == jnp.int8 and wp.shape[0] * 2 == w.shape[0]
        np.testing.assert_array_equal(plain.score(frames), packed.score(frames))

        pallas_packed = Scorer(
            q4, EngineConfig(backend="pallas", interpret=True, int4_packed=True)
        )
        np.testing.assert_allclose(
            pallas_packed.score(frames), packed.score(frames), atol=3e-5
        )
        pf, _ = packed._prepare(frames)
        gf, _ = pallas_packed._prepare(frames)
        np.testing.assert_array_equal(
            np.asarray(packed._hidden(packed.net, pf)),
            np.asarray(pallas_packed._hidden(pallas_packed.net, gf)),
        )

    @pytest.mark.parametrize(
        "hidden", [[96], [64, 128, 64], [256] * 4], ids=["1L", "unequal", "4L"]
    )
    def test_packed_trunk_shapes(self, hidden):
        """Packing is shape-independent: single hidden layer, unequal
        widths (no stack path), and a deeper trunk all stay bitwise equal
        to the unpacked int4 engine."""
        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.engine.scorer import Scorer

        net = random_net(jax.random.PRNGKey(13), 32, hidden, 80)
        q4 = quantize_net(net, hidden_bits=4)
        rng = np.random.default_rng(13)
        frames = rng.standard_normal((32, 32)).astype(np.float32)
        want = Scorer(q4, EngineConfig(backend="xla")).score(frames)
        got = Scorer(
            q4, EngineConfig(backend="xla", int4_packed=True)
        ).score(frames)
        np.testing.assert_array_equal(got, want)

    def test_packed_trunk_mesh_and_guards(self, small_net):
        """Packed nets ride the mesh engine unchanged (hidden weights are
        replicated); packing after padding is enforced and packed nets
        refuse to serialize (runtime storage only)."""
        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.engine.scorer import Scorer
        from fastdnn_tpu.parallel import mesh as pmesh
        from fastdnn_tpu.quant.quantize import (
            pack_int4_trunk,
            pad_qnet,
        )
        from fastdnn_tpu.quant.serialize import save_qnet

        q4 = quantize_net(small_net, hidden_bits=4)
        rng = np.random.default_rng(10)
        frames = rng.standard_normal((48, q4.input_dim)).astype(np.float32)
        ref = Scorer(q4, EngineConfig(backend="xla")).score(frames)
        got = Scorer(
            q4,
            EngineConfig(backend="xla", int4_packed=True),
            mesh=pmesh.make_mesh(data=2, model=4),
        ).score(frames)
        np.testing.assert_allclose(got, ref, atol=3e-5)

        packed = pack_int4_trunk(pad_qnet(q4, lanes=128))
        with pytest.raises(ValueError, match="pad before packing"):
            pad_qnet(packed)
        with pytest.raises(ValueError, match="unpacked"):
            save_qnet(packed, "/tmp/never-written.npz")
        # int8 nets pass through the transform untouched
        q8 = quantize_net(small_net)
        assert pack_int4_trunk(q8) is q8

    def test_checkpoint_explicit_bits_must_match(self, small_net, tmp_path):
        """An EXPLICIT hidden_bits request on a pre-quantized checkpoint is
        a hard requirement in BOTH directions (8-on-int4 as much as
        4-on-int8): quantization happened at save time, so silently scoring
        the other trunk width would misreport every downstream comparison.
        hidden_bits=None (the CLI default) accepts whatever is stored."""
        from fastdnn_tpu.quant.serialize import load_quantized, save_qnet

        p8, p4 = tmp_path / "m8.npz", tmp_path / "m4.npz"
        save_qnet(quantize_net(small_net), p8)
        save_qnet(quantize_net(small_net, hidden_bits=4), p4)
        with pytest.raises(ValueError, match="stored bits"):
            load_quantized(str(p4), hidden_bits=8)
        with pytest.raises(ValueError, match="stored bits"):
            load_quantized(str(p8), hidden_bits=4)
        # explicit-and-matching and default both load fine
        assert "int4" in load_quantized(str(p4), hidden_bits=4)[1]
        assert "int8" in load_quantized(str(p8))[1]

    def test_padding_preserves_dtype(self, small_net):
        from fastdnn_tpu.quant.quantize import pad_qnet

        q4 = pad_qnet(quantize_net(small_net, hidden_bits=4), lanes=128)
        for w in q4.weights[:-1]:
            assert w.dtype == jnp.int4

    def test_composes_with_mesh(self, small_net):
        """int4 weights shard over a ("data","model") mesh like int8 ones:
        the mesh Scorer must equal the single-device XLA engine bit-for-bit
        in posterior space (same tolerance the int8 mesh tests use)."""
        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.engine.scorer import Scorer
        from fastdnn_tpu.parallel import mesh as pmesh

        q4 = quantize_net(small_net, hidden_bits=4)
        rng = np.random.default_rng(12)
        frames = rng.standard_normal((48, q4.input_dim)).astype(np.float32)
        ref = Scorer(q4, EngineConfig(backend="xla")).score(frames)
        for data, model in ((4, 2), (2, 4)):
            got = Scorer(
                q4,
                EngineConfig(backend="xla"),
                mesh=pmesh.make_mesh(data=data, model=model),
            ).score(frames)
            np.testing.assert_allclose(got, ref, atol=3e-5, err_msg=f"mesh d{data}xm{model}")
