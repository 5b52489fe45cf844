"""Test configuration: force CPU jax with an 8-device virtual mesh.

Multi-device sharding is validated on a virtual CPU mesh; the GPU path
runs through ``chip_smoke.py`` on the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# A backend registered at interpreter start can pin jax_platforms; a
# config update re-initializes onto the virtual 8-device CPU mesh.
jax.config.update("jax_platforms", "cpu")

from lime_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import pytest  # noqa: E402

from .synth import SynthDataset, make_dataset  # noqa: E402


@pytest.fixture(scope="session")
def dataset(tmp_path_factory) -> SynthDataset:
    """Session-wide synthetic paired-end dataset with built indexes."""
    root = tmp_path_factory.mktemp("synth")
    return make_dataset(str(root), num_pairs=400, read_len=100,
                        genome_lens=(9000, 7000, 5000), seed=7)


@pytest.fixture(scope="session")
def oracle():
    """Compiled reference binaries (skips oracle tests if unavailable)."""
    from .oracle import OracleBinaries

    try:
        return OracleBinaries.build()
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference oracle unavailable: {e}")
