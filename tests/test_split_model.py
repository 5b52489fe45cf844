"""Hybrid host/device split model (ops/fused_pipeline).

Round-4 hardcoded the host scorer rate and kept the max bandwidth sample
across the process (a high-biased estimator).  These tests pin the
calibrated model: recency-weighted estimates and the decision table of
``_split_fraction`` / ``_host_split_for`` against recorded (bw, rate)
samples.
"""

import numpy as np
import pytest

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.ops import fused_pipeline as fp


@pytest.fixture(autouse=True)
def _clean_samples():
    fp._bw_samples.clear()
    fp._host_rate_samples.clear()
    yield
    fp._bw_samples.clear()
    fp._host_rate_samples.clear()


def test_split_fraction_decision_table():
    rate = 11e6  # ~measured single-core SIMD scorer rate on this host
    # PCIe-class link (16 GB/s): essentially everything rides the device
    assert fp._split_fraction(16.0, rate) < 0.01
    # slow host link (20 MB/s): essentially everything host-scores
    assert fp._split_fraction(0.020, rate) > 0.6
    # the crossover bandwidth equalizes the pipelines at f = 0.5
    bw_eq = fp._STREAM_BYTES_PER_ROW * rate / 1e9
    assert abs(fp._split_fraction(bw_eq, rate) - 0.5) < 1e-6
    # monotone in bandwidth
    fs = [fp._split_fraction(bw, rate) for bw in (0.001, 0.01, 0.1, 1, 10)]
    assert all(a > b for a, b in zip(fs, fs[1:]))


def test_recency_weighted_estimates():
    assert fp._link_bw_estimate() is None
    for s in (0.001, 0.002, 0.040):
        fp._record_link_bw(s)
    est = fp._link_bw_estimate()
    # newer samples dominate: estimate sits well above the stale ones
    assert 0.02 < est < 0.04
    # a collapse is tracked quickly
    fp._record_link_bw(0.0005)
    fp._record_link_bw(0.0005)
    assert fp._link_bw_estimate() < 0.012


def test_host_rate_estimate_prior_and_measured():
    import os

    cores = min(os.cpu_count() or 1, 16)
    assert fp._host_rate_estimate() == fp._HOST_POS_PER_SEC_CORE * cores
    fp._record_host_rate(11e6)
    assert fp._host_rate_estimate() == pytest.approx(11e6 * cores)


@pytest.mark.skipif(not native.available(), reason="needs native scorer")
def test_host_split_for_uses_measurements():
    cfg = LimeConfig(executor="tpu", fused=True)
    # no bandwidth measurement yet: direct-attached starts pure-device
    assert fp._host_split_for(cfg, 10000, 100, False) == 0
    # degraded measured link: most-to-all host
    fp._record_link_bw(0.005)
    fp._record_host_rate(11e6)
    assert fp._host_split_for(cfg, 10000, 100, False) > 200
    # healthy link: pure device
    for _ in range(4):
        fp._record_link_bw(12.0)
    assert fp._host_split_for(cfg, 10000, 100, False) == 0
    # explicit fraction still wins over measurements
    cfg2 = LimeConfig(executor="tpu", fused=True, host_frac=1.0)
    assert fp._host_split_for(cfg2, 10000, 100, False) == 256
