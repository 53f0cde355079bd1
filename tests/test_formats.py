"""Format parity tests against the bundled reference data files.

The bundled files are the reference's own fixtures (SURVEY.md §2 #23):
  data/16khz          Kaldi text features, 193 frames x 429 dims
  data/16khz.bin      binary features, header 100 x 432 (+1 benign extra frame)
  data/8khz           Kaldi text features
  data/8khz.aligned.bin  binary features 389 x 432, size-exact
"""

import io
import os

import numpy as np
import pytest

from fastdnn_tpu.formats import binary, kaldi_text



class TestBinaryFeatures:
    def test_16khz_bin_header(self, features_16khz):
        assert features_16khz.shape == (100, 432)
        assert features_16khz.dtype == np.float32

    def test_8khz_bin(self, sample_data, features_8khz):
        assert features_8khz.shape == (389, 432)
        # file is size-exact: 8 byte header + 389*432*4
        assert os.path.getsize(sample_data["8khz.aligned.bin"]) == 8 + 389 * 432 * 4

    def test_16khz_bin_matches_text_source(self, sample_data, features_16khz):
        """16khz.bin was serialized from the 16khz text features aligned to
        x4 (FuncTest.generateAlignedInput); first 100 frames must agree."""
        text = kaldi_text.first_utterance(sample_data["16khz"])
        assert text.shape == (193, 429)
        aligned = np.pad(text, ((0, 0), (0, 3)))
        np.testing.assert_array_equal(features_16khz, aligned[:100])

    def test_feature_roundtrip(self, rng):
        data = rng.standard_normal((17, 40)).astype(np.float32)
        buf = io.BytesIO()
        binary.write_features(data, buf)
        buf.seek(0)
        out = binary.read_features(buf)
        np.testing.assert_array_equal(out, data)

    def test_feature_roundtrip_max_frames(self, rng):
        data = rng.standard_normal((10, 4)).astype(np.float32)
        buf = io.BytesIO()
        binary.write_features(data, buf, max_frames=6)
        buf.seek(0)
        out = binary.read_features(buf)
        np.testing.assert_array_equal(out, data[:6])

    def test_big_endian_layout(self):
        """First 8 bytes of a written feature file are big-endian counts."""
        buf = io.BytesIO()
        binary.write_features(np.zeros((3, 5), np.float32), buf)
        raw = buf.getvalue()
        assert raw[:4] == (3).to_bytes(4, "big")
        assert raw[4:8] == (5).to_bytes(4, "big")


class TestKaldiText:
    def test_16khz_text(self, sample_data):
        feats = kaldi_text.load_features_text(sample_data["16khz"])
        assert len(feats) == 1
        frames = next(iter(feats.values()))
        assert frames.shape == (193, 429)
        # 429 = 39-dim x 11-frame splice: first frame's leading block repeats
        np.testing.assert_array_equal(frames[0, :39], frames[0, 39:78])

    def test_8khz_text(self, sample_data):
        feats = kaldi_text.load_features_text(sample_data["8khz"])
        frames = next(iter(feats.values()))
        assert frames.shape[0] == 389

    def test_network_text_parse(self):
        text = """<Nnet>
<AffineTransform> 2 3
[ 1.0 2.0 3.0
  4.0 5.0 6.0 ]
[ 0.5 -0.5 ]
<Sigmoid> 2 2
<AffineTransform> 2 2
[ 1 0
  0 1 ]
[ 0 0 ]
<Softmax> 2 2
</Nnet>
"""
        layers = kaldi_text.parse_network_text(text)
        assert len(layers) == 2
        np.testing.assert_array_equal(layers[0].weights, [[1, 2, 3], [4, 5, 6]])
        np.testing.assert_array_equal(layers[0].bias, [0.5, -0.5])
        np.testing.assert_array_equal(layers[1].weights, np.eye(2))

    def test_transform_parse_with_splice(self):
        text = "<Splice> [ 0 1 2 ] <AddShift> [ 1.5 2.5 ] <Rescale> [ 3.0 4.0 ]"
        shift, scale = kaldi_text.parse_transform_text(text)
        np.testing.assert_array_equal(shift, [1.5, 2.5])
        np.testing.assert_array_equal(scale, [3.0, 4.0])

    def test_transform_parse_two_blocks(self):
        shift, scale = kaldi_text.parse_transform_text("[ 1 2 ] [ 3 4 ]")
        np.testing.assert_array_equal(shift, [1, 2])
        np.testing.assert_array_equal(scale, [3, 4])

    def test_transform_wrong_block_count(self):
        with pytest.raises(ValueError):
            kaldi_text.parse_transform_text("[ 1 2 ]")


class TestBinaryModel:
    def test_model_roundtrip(self, rng):
        layers = [
            binary.RawLayer(
                rng.standard_normal((8, 6)).astype(np.float32),
                rng.standard_normal(8).astype(np.float32),
            ),
            binary.RawLayer(
                rng.standard_normal((4, 8)).astype(np.float32),
                rng.standard_normal(4).astype(np.float32),
            ),
        ]
        net = binary.RawNetwork(
            layers,
            rng.standard_normal(6).astype(np.float32),
            rng.standard_normal(6).astype(np.float32),
        )
        buf = io.BytesIO()
        binary.write_model(net, buf)
        buf.seek(0)
        out = binary.read_model(buf)
        assert len(out.layers) == 2
        for a, b in zip(net.layers, out.layers):
            np.testing.assert_array_equal(a.weights, b.weights)
            np.testing.assert_array_equal(a.bias, b.bias)
        np.testing.assert_array_equal(net.shift, out.shift)
        np.testing.assert_array_equal(net.scale, out.scale)
        assert out.topology() == "6-0x8-4"

    def test_text_to_binary_consistency(self, tmp_path):
        """Text-parsed net survives a binary write/read byte-exactly."""
        net_text = """<AffineTransform> 3 2
[ 0.25 -0.125
  1.0 2.0
  -3.5 0.5 ]
[ 0.1 0.2 0.3 ]
<AffineTransform> 2 3
[ 1 2 3
  4 5 6 ]
[ -1 1 ]
"""
        tf_text = "[ 0.5 0.25 ] [ 2.0 4.0 ]"
        netf, tff = tmp_path / "net.txt", tmp_path / "tf.txt"
        netf.write_text(net_text)
        tff.write_text(tf_text)
        raw = kaldi_text.load_network_text(netf, tff)
        binf = tmp_path / "model.bin"
        binary.write_model(raw, binf)
        out = binary.read_model(binf)
        np.testing.assert_array_equal(out.layers[0].weights, raw.layers[0].weights)
        np.testing.assert_array_equal(out.shift, raw.shift)


def test_feature_endianness_flag(tmp_path):
    """Both endiannesses round-trip, mirroring BatchData.loadRawBinary /
    serializeDataMatrix's bigEndian flag (BatchData.java:80-91,101-139)."""
    import io as _io

    import numpy as np

    from fastdnn_tpu.formats.binary import read_features, write_features

    d = np.arange(24, dtype=np.float32).reshape(6, 4) * 0.5
    for le in (False, True):
        p = tmp_path / f"f_{le}.bin"
        write_features(d, p, little_endian=le)
        np.testing.assert_array_equal(read_features(p, little_endian=le), d)
    # big-endian header bytes: frames=6 as 00 00 00 06
    assert (tmp_path / "f_False.bin").read_bytes()[:4] == b"\x00\x00\x00\x06"
    assert (tmp_path / "f_True.bin").read_bytes()[:4] == b"\x06\x00\x00\x00"


def test_model_little_endian_roundtrip(tmp_path):
    """The reference BinaryLoader carries an endianness flag
    (/root/reference/src/cpp/float_dnn.cc:166,19); model IO here supports
    both byte orders (the reference only ever writes models big-endian)."""
    import jax

    from fastdnn_tpu.formats.binary import read_model, write_model
    from fastdnn_tpu.models.feedforward import random_net, to_raw

    raw = to_raw(random_net(jax.random.PRNGKey(9), 12, [16], 20))
    be, le = tmp_path / "m_be.bin", tmp_path / "m_le.bin"
    write_model(raw, be)
    write_model(raw, le, little_endian=True)
    # different bytes, same parse
    assert be.read_bytes() != le.read_bytes()
    assert be.stat().st_size == le.stat().st_size
    back = read_model(le, little_endian=True)
    ref = read_model(be)
    for a, b in zip(back.layers, ref.layers):
        np.testing.assert_array_equal(a.weights, b.weights)
        np.testing.assert_array_equal(a.bias, b.bias)
    np.testing.assert_array_equal(back.shift, ref.shift)
    np.testing.assert_array_equal(back.scale, ref.scale)
