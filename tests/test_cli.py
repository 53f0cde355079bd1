"""CLI tests: convert the bundled Kaldi text features/models end to end and
score them, mirroring the reference's manual pipeline (SURVEY.md §3.4/§3.5)."""

import os

import numpy as np
import pytest

from fastdnn_tpu.cli import convert, score
from fastdnn_tpu.formats.binary import (
    RawLayer,
    RawNetwork,
    read_features,
    read_model,
    write_model,
)



@pytest.fixture()
def model_file(tmp_path, rng):
    """A small random model in the reference binary format (432 in)."""
    dims = [432, 64, 64, 50]
    layers = [
        RawLayer(
            (rng.standard_normal((dims[i + 1], dims[i])) * dims[i] ** -0.5).astype(np.float32),
            rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.1,
        )
        for i in range(len(dims) - 1)
    ]
    raw = RawNetwork(
        layers,
        rng.standard_normal(432).astype(np.float32),
        rng.uniform(0.5, 1.5, 432).astype(np.float32),
    )
    path = tmp_path / "model.bin"
    write_model(raw, path)
    return str(path)


class TestConvertCLI:
    def test_features_conversion_matches_bundled(self, sample_data, tmp_path):
        """Reproduce data/16khz.bin from data/16khz exactly (modulo the
        reference writer's benign off-by-one)."""
        out = tmp_path / "16khz.bin"
        rc = convert.main(
            ["features", sample_data["16khz"], str(out), "--align-dim", "4", "--max-frames", "100"]
        )
        assert rc == 0
        ours = read_features(out)
        bundled = read_features(sample_data["16khz.bin"])
        np.testing.assert_array_equal(ours, bundled)

    def test_model_align_extend(self, tmp_path, model_file):
        out = tmp_path / "big.bin"
        rc = convert.main(
            ["model", model_file, "--from-binary", str(out), "--extend", "128", "96", "--align", "4", "16"]
        )
        assert rc == 0
        raw = read_model(out)
        assert raw.layers[0].output_dim == 128
        assert raw.layers[-1].output_dim == 96
        assert raw.layers[0].input_dim == 432

    def test_model_text_conversion(self, tmp_path):
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
        netf = tmp_path / "net.txt"
        netf.write_text(net_text)
        tff = tmp_path / "tf.txt"
        tff.write_text("[ 0.5 0.25 ] [ 2.0 4.0 ]")
        out = tmp_path / "m.bin"
        rc = convert.main(["model", str(netf), str(tff), str(out)])
        assert rc == 0
        raw = read_model(out)
        assert raw.input_dim == 2 and raw.output_dim == 2


class TestScoreCLI:
    def test_score_bundled_features(self, sample_data, tmp_path, model_file, capsys):
        out = tmp_path / "post.bin"
        rc = score.main(
            [model_file, sample_data["16khz.bin"], str(out), "BIN", "--backend", "xla"]
        )
        assert rc == 0
        posteriors = read_features(out)
        assert posteriors.shape == (100, 50)
        np.testing.assert_allclose(posteriors.sum(-1), 1.0, rtol=1e-4)
        captured = capsys.readouterr().out
        assert "432-1x64-50" in captured
        assert "calculation time" in captured

    def test_score_mesh_flags_match_single_device(self, sample_data, tmp_path, model_file, capsys):
        """--mesh-model/--mesh-data route through Scorer(mesh=...) and must
        reproduce the single-device posteriors."""
        ref = tmp_path / "single.bin"
        out = tmp_path / "meshed.bin"
        feats = sample_data["16khz.bin"]
        assert score.main([model_file, feats, str(ref), "BIN", "--backend", "xla"]) == 0
        rc = score.main(
            [model_file, feats, str(out), "BIN", "--backend", "xla",
             "--mesh-model", "2"]
        )
        assert rc == 0
        assert "Mesh        = data=4 x model=2" in capsys.readouterr().out
        np.testing.assert_allclose(read_features(out), read_features(ref), atol=2e-5)

    def test_score_lazy_masks(self, sample_data, tmp_path, model_file):
        out = tmp_path / "post.txt"
        rc = score.main(
            [
                model_file,
                sample_data["16khz.bin"],
                str(out),
                "TXT",
                "--backend",
                "xla",
                "--mask-density",
                "0.4",
            ]
        )
        assert rc == 0
        posteriors = np.loadtxt(out, dtype=np.float32)
        assert posteriors.shape == (100, 50)
        # reference lazy semantics: all posteriors positive (exp(0) mass)
        assert posteriors.min() > 0

    def test_score_lazy_mode_flag(self, sample_data, tmp_path, model_file):
        """--lazy-mode reaches EngineConfig: 'dense' scores identically to
        the default, and an unknown strategy is refused by the parser."""
        out_a, out_b = tmp_path / "a.txt", tmp_path / "b.txt"
        base = [model_file, sample_data["16khz.bin"]]
        tail = ["TXT", "--backend", "xla", "--mask-density", "0.4"]
        assert score.main(base + [str(out_a)] + tail) == 0
        assert score.main(base + [str(out_b)] + tail + ["--lazy-mode", "dense"]) == 0
        np.testing.assert_array_equal(np.loadtxt(out_a), np.loadtxt(out_b))
        with pytest.raises(SystemExit):
            score.main(base + [str(out_a)] + tail + ["--lazy-mode", "block_sparse"])

    def test_score_hidden_bits4(self, sample_data, tmp_path, model_file):
        """--hidden-bits 4 quantizes the hidden trunk to int4 end to end;
        posteriors stay valid and near the int8 run (the float-oracle
        accuracy gate itself is test_quant's TestInt4Trunk)."""
        out8, out4 = tmp_path / "p8.txt", tmp_path / "p4.txt"
        base = [model_file, sample_data["16khz.bin"]]
        tail = ["TXT", "--backend", "xla"]
        assert score.main(base + [str(out8)] + tail) == 0
        assert score.main(base + [str(out4)] + tail + ["--hidden-bits", "4"]) == 0
        p8, p4 = np.loadtxt(out8), np.loadtxt(out4)
        assert p4.shape == p8.shape == (100, 50)
        np.testing.assert_allclose(p4.sum(1), 1.0, atol=1e-5)
        assert np.abs(p4 - p8).max() < 0.05

    def test_mask_generator_density_and_churn(self, rng):
        masks = score.generate_masks(rng, 50, 1000, 0.4)
        density = masks.mean(axis=1)
        assert abs(density[0] - 0.4) < 0.01
        assert np.all(np.abs(density - 0.4) < 0.1)
        flips = np.abs(np.diff(masks.astype(np.int8), axis=0)).sum(axis=1)
        assert flips.max() <= 2 * int(1000 * 0.03)


def test_score_text_input_multi_utterance(small_net, tmp_path):
    """--text-input scores every utterance in a Kaldi text feature file and
    writes id-keyed text output (round-trips through our parser)."""
    import numpy as np

    from fastdnn_tpu.cli.score import main
    from fastdnn_tpu.formats.binary import write_model
    from fastdnn_tpu.formats.kaldi_text import load_features_text, write_features_text_kaldi
    from fastdnn_tpu.models.feedforward import to_raw

    model = tmp_path / "m.bin"
    write_model(to_raw(small_net), model)
    feats = tmp_path / "feats.txt"
    rng = np.random.default_rng(0)
    write_features_text_kaldi(
        {
            "utt-x": rng.standard_normal((7, small_net.input_dim)).astype(np.float32),
            "utt-y": rng.standard_normal((3, small_net.input_dim)).astype(np.float32),
        },
        feats,
    )
    out = tmp_path / "post.txt"
    assert main([str(model), str(feats), str(out), "--text-input", "--backend", "xla"]) == 0
    scored = load_features_text(out)
    assert list(scored) == ["utt-x", "utt-y"]
    assert scored["utt-x"].shape == (7, small_net.output_dim)
    assert scored["utt-y"].shape == (3, small_net.output_dim)
    np.testing.assert_allclose(scored["utt-x"].sum(1), 1.0, rtol=1e-3)


def test_quantize_checkpoint_cli_roundtrip(sample_data, model_file, tmp_path, capsys):
    """fastdnn-convert quantize -> .npz checkpoint; score/serve consume it
    directly (no quantization pass) with identical posteriors."""
    from fastdnn_tpu.cli import convert

    ckpt = tmp_path / "model.qnet.npz"
    assert convert.main(["quantize", model_file, str(ckpt)]) == 0
    assert "int8 checkpoint" in capsys.readouterr().out

    feats = sample_data["16khz.bin"]
    out_bin = tmp_path / "p_bin.bin"
    out_ckpt = tmp_path / "p_ckpt.bin"
    assert score.main([model_file, feats, str(out_bin), "BIN", "--backend", "xla"]) == 0
    assert score.main([str(ckpt), feats, str(out_ckpt), "BIN", "--backend", "xla"]) == 0
    np.testing.assert_array_equal(read_features(out_ckpt), read_features(out_bin))
    assert "int8 checkpoint" in capsys.readouterr().out  # topology banner


def test_serve_mesh_data_alone_builds_mesh(model_file):
    """--mesh-data without --mesh-model must activate a data-parallel mesh
    (matching fastdnn-score), not silently fall back to one device."""
    from fastdnn_tpu.cli.serve import build_scorer
    from fastdnn_tpu.parallel.service import MultiHostScorer

    class A:
        model = model_file
        cutoff, backend = 3.0, "xla"
        mesh_model, mesh_data = 0, 8
        coordinator = None

    scorer, topology = build_scorer(A)
    try:
        assert isinstance(scorer, MultiHostScorer)
        assert scorer.mesh.shape["data"] == 8
        assert "432" in topology
    finally:
        scorer.close()


def test_serve_exposes_serving_knobs(model_file):
    """--fast-posteriors / --input-precision reach the EngineConfig (the
    deployment path for the measured serving profile, docs/serving.md)."""
    from fastdnn_tpu.cli.serve import build_scorer

    class A:
        model = model_file
        cutoff, backend = 3.0, "xla"
        mesh_model, mesh_data = 0, None
        coordinator = None
        fast_posteriors = True
        input_precision = "default"

    scorer, _ = build_scorer(A)
    assert scorer.config.fast_posteriors is True
    assert scorer.config.input_precision == "default"


def test_checkpoint_cutoff_warns(model_file, tmp_path):
    """--cutoff cannot apply to a pre-quantized .npz checkpoint; the load
    must say so instead of silently no-opping."""
    import warnings

    from fastdnn_tpu.quant.serialize import load_quantized, save_qnet
    from fastdnn_tpu.formats.binary import read_model
    from fastdnn_tpu.models.feedforward import from_raw
    from fastdnn_tpu.quant.quantize import quantize_net

    ckpt = tmp_path / "m.qnet.npz"
    save_qnet(quantize_net(from_raw(read_model(model_file))), ckpt)
    with pytest.warns(UserWarning, match="no effect"):
        load_quantized(str(ckpt), cutoff=5.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        load_quantized(str(ckpt), cutoff=3.0)  # default: no warning
