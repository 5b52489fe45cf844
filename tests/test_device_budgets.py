"""Device-derived memory budgets and the compile-cache location."""

import numpy as np
import pytest

from lime_tpu.config import LimeConfig
from lime_tpu.ops import fused_pipeline as fp
from lime_tpu.utils import compile_cache


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def fake_device(monkeypatch):
    monkeypatch.delenv("LIME_HBM_BUDGET", raising=False)
    monkeypatch.delenv("LIME_STREAM_BUDGET", raising=False)

    def use(platform, stats):
        monkeypatch.setattr(fp.jax, "devices",
                            lambda: [_FakeDevice(platform, stats)])
    return use


def test_budgets_follow_gpu_memory_limit(fake_device):
    limit = 60 << 30
    fake_device("gpu", {"bytes_limit": limit, "bytes_in_use": 0})
    assert fp._device_memory() == limit
    assert fp._hbm_budget() == limit * 3 // 8
    assert fp._stream_budget() == limit * 7 // 16


def test_budgets_cpu_default(fake_device):
    fake_device("cpu", None)
    assert fp._hbm_budget() == 6 << 30
    assert fp._stream_budget() == 7 << 30


def test_budgets_gpu_without_stats_raise(fake_device):
    fake_device("gpu", None)
    with pytest.raises(RuntimeError, match="no memory limit"):
        fp._hbm_budget()
    with pytest.raises(RuntimeError, match="no memory limit"):
        fp._stream_budget()


def test_budget_env_overrides(fake_device, monkeypatch):
    fake_device("gpu", None)  # overrides never consult the device
    monkeypatch.setenv("LIME_HBM_BUDGET", "12345")
    monkeypatch.setenv("LIME_STREAM_BUDGET", "678")
    assert fp._hbm_budget() == 12345
    assert fp._stream_budget() == 678


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    got = compile_cache.configure_compile_cache()
    assert got == compile_cache.DEFAULT_DIR
    assert got.endswith("/build/jax_cache")
    assert ("jax_compilation_cache_dir", got) in calls


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert not [k for k, _ in calls if k == "jax_compilation_cache_dir"]


def test_forced_pair_stream_refuses_fallback(monkeypatch, tmp_path):
    """pair_stream=True never falls back to another engine silently."""
    from lime_tpu.formats.lineage import Lineage

    monkeypatch.setattr(fp.native, "available", lambda: False)
    lineage = Lineage(names=["G0"], taxids=np.ones((6, 1), np.uint32))
    with pytest.raises(RuntimeError, match="pair_stream=True"):
        fp.run_fused([str(tmp_path / "c")] * 4, 10, 1, lineage, 100,
                     LimeConfig(fused=True, pair_stream=True, host_frac=0.0))
