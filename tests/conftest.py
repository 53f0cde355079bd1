"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators via
--xla_force_host_platform_device_count.  Must be set before jax
initializes, hence module scope here.  Tests that need a GPU carry the
`gpu` marker and skip (from the `gpu_device` fixture) everywhere else.
"""

import os

# the driver and CI run on the CPU; `JAX_PLATFORMS=cuda pytest -m gpu` runs
# the card-only tests on a GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# keep tests hermetic: the CLIs enable the persistent compilation cache
# (config.enable_compilation_cache); this is its off switch
os.environ["FASTDNN_COMPILE_CACHE"] = "0"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1)


@pytest.fixture(scope="session")
def sample_data(tmp_path_factory):
    """Seeded stand-ins for the reference's feature files, by file name
    (16khz, 16khz.bin, 8khz, 8khz.aligned.bin; utils.synthetic)."""
    from fastdnn_tpu.utils.synthetic import write_sample_data

    return write_sample_data(tmp_path_factory.mktemp("sample_data"))


@pytest.fixture(scope="session")
def features_16khz(sample_data):
    """Binary features, 100 frames x 432 dims."""
    from fastdnn_tpu.formats.binary import read_features

    return read_features(sample_data["16khz.bin"])


@pytest.fixture(scope="session")
def features_8khz(sample_data):
    """Aligned binary features, 389 frames x 432 dims."""
    from fastdnn_tpu.formats.binary import read_features

    return read_features(sample_data["8khz.aligned.bin"])


@pytest.fixture()
def gpu_device():
    """The first GPU, or a skip where JAX has none (tests marked `gpu`)."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; run on the card with: python -m pytest -m gpu")
    return devs[0]


@pytest.fixture(scope="session")
def small_net():
    """Small random net matching the bundled feature dims (432 input)."""
    import jax

    from fastdnn_tpu.models.feedforward import random_net

    return random_net(
        jax.random.PRNGKey(0), input_dim=432, hidden_widths=[256, 256, 256], output_dim=400
    )
