"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions work at a tiny size with the kernel in interpreter mode."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SMALL = dict(input_dim=432, hidden=128, n_hidden=3, senones=300)


def _env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return env


def test_exits_nonzero_without_gpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_env(), cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_card_child_refuses_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--phase", "card",
         "--workdir", str(tmp_path)],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not (tmp_path / "device.json").exists()


def test_alone_in_a_directory_fails(tmp_path):
    """Copied without the package, the script must fail, not pass."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env["PYTHONPATH"] = ""
    r = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py"), "--phase", "inputs",
         "--workdir", str(tmp_path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_sigmoid_phase():
    res = chip_smoke.check_sigmoid(interpret=True)
    assert res["entries"] == 1281
    assert res["xla_bad"] == [] and res["kernel_bad"] == []


def test_kernel_phase_small():
    rows = chip_smoke.check_kernel(256, (128, 200), interpret=True)
    for row in rows:
        assert row["mismatches"] == 0, row
        assert row["distinct"] > 100
        assert row["memory"]


@pytest.fixture(scope="module")
def small_workdir(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    chip_smoke.write_inputs(work, **SMALL)
    return work


def test_engine_phase_small(small_workdir):
    qnet, frames, masks = chip_smoke._load(
        {"model": os.path.join(small_workdir, "model.bin"),
         "features": os.path.join(small_workdir, "features.bin")}
    )
    assert frames.shape == (chip_smoke.N_FRAMES, 432)
    assert masks.shape == (chip_smoke.N_FRAMES, 300)
    res = chip_smoke.check_engine(qnet, frames, masks, interpret=True)
    assert res["backend"] == "pallas"
    assert set(res["cases"]) == {"full", "masked_reference", "masked_active_only"}
    for c in res["cases"].values():
        assert c["max_abs"] <= chip_smoke.ATOL
        assert c["max_rowsum_err"] <= 1e-5 and c["finite"]
        assert c["argmax_agree"] == 1.0
    # the CPU computes f32 dots exactly at every precision setting
    assert res["flips_default_vs_highest"] == 0
    assert res["flips_engine_vs_highest"] == 0
    assert res["flips_high_vs_highest"] == 0
    assert res["input_precision"] == "highest"


def test_cli_and_server_phases_small(small_workdir):
    """Phases 5 and 6 against expectations saved the way the card phase
    saves them (here from the CPU engine)."""
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer

    qnet, frames, masks = chip_smoke._load(
        {"model": os.path.join(small_workdir, "model.bin"),
         "features": os.path.join(small_workdir, "features.bin")}
    )
    chip_smoke.save_expected(small_workdir, Scorer(qnet, EngineConfig()), frames, masks)
    chip_smoke.cli_phase(small_workdir)
    chip_smoke.server_phase(small_workdir)


def test_gemm_kernels_reads_compiled_program(small_workdir):
    """On the CPU the trace has no GPU plane; the HLO part still finds the
    int8 dots."""
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer

    qnet, _, _ = chip_smoke._load(
        {"model": os.path.join(small_workdir, "model.bin"),
         "features": os.path.join(small_workdir, "features.bin")}
    )
    g = chip_smoke.gemm_kernels(Scorer(qnet, EngineConfig(backend="xla")), 128)
    assert g["kernels"] == {}
    assert g["s8_dots"] >= 1


def test_phase_error_is_reported(capsys):
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke._say("kernel", False, "B=128: 3 mismatches")
    assert capsys.readouterr().out.startswith("FAIL kernel:")
    assert jax.devices()[0].platform == "cpu"
    assert np.isfinite(chip_smoke.ATOL)
