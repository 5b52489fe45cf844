"""Pair-hits forms: the log-step scan and the band-pass core.

Both compute, per read-side row of a pair stream, how many genome-side
rows of the same copy share its (symbol, occurrence) key.  Genome-side
rows may carry garbage (every caller's scatter drops them), so parity is
asserted on read-side rows, against each other and against the
vectorized numpy oracle ``pair_hits_host``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lime_tpu.ops import pair_score as ps
from lime_tpu.ops.pair_score import (
    BUCKET_CAPS,
    _hits_dispatch,
    _pair_hits_core,
    _pair_hits_scan,
    codes_to_packed,
    pair_hits_host,
    planner_shaped_stream,
)


def _decode(codes):
    sym = jnp.asarray((codes & 3).astype(np.int8))
    m = jnp.asarray(((codes >> 2) & 1).astype(bool))
    dr = jnp.asarray(((codes >> 3) & 1).astype(bool))
    gs = jnp.asarray(((codes >> 4) & 1).astype(bool))
    return m, dr, gs, sym


def _read_side(codes):
    return ((codes >> 4) & 1) == 0


@pytest.mark.parametrize("cap", [16, 64])
def test_scan_matches_core(cap):
    """Two 16K-row tiles of planner-shaped stream: copies straddle the
    boundary where the former kernels cut tiles."""
    rng = np.random.default_rng(100 + cap)
    codes = planner_shaped_stream(rng, 2 * 16384, cap)
    m, dr, gs, sym = _decode(codes)
    ref = np.asarray(_pair_hits_core(m, dr, gs, sym, jnp.int32(cap)))
    got = np.asarray(jax.jit(_pair_hits_scan, static_argnums=1)(
        jnp.asarray(codes.astype(np.uint32)), cap))
    rs = _read_side(codes)
    assert np.array_equal(ref[rs], got[rs])


@pytest.mark.parametrize("cap", [16, 64])
def test_scan_matches_host_oracle_large(cap):
    rng = np.random.default_rng(200 + cap)
    codes = planner_shaped_stream(rng, 8 * 16384, cap)
    want = pair_hits_host(codes_to_packed(codes))
    got = np.asarray(_pair_hits_scan(jnp.asarray(codes.astype(np.uint32)),
                                     cap))
    rs = _read_side(codes)
    assert np.array_equal(want[rs], got[rs])


def test_dispatch_cap255_matches_host_oracle():
    """Cap 255 takes the band-pass core, which also counts general copies
    (genome rows interleaved with read rows) at two windows."""
    rng = np.random.default_rng(11)
    n = 2 * 16384
    codes = np.zeros(n, np.uint8)
    i = 0
    while i < n:
        copy_len = int(rng.integers(1, 14))
        for j in range(min(copy_len, n - i)):
            sym = rng.integers(0, 4)
            m = 0 if j == 0 else 1
            dr = 0 if (j == 0 or rng.random() < 0.5) else 1
            gs = 0 if j == 0 else int(rng.random() < 0.4)
            codes[i + j] = sym | (m << 2) | (dr << 3) | (gs << 4)
        i += copy_len
    m, dr, gs, sym = _decode(codes)
    want = pair_hits_host(codes_to_packed(codes))
    rs = _read_side(codes)
    for window in (13, 255):
        got = np.asarray(_hits_dispatch(
            jnp.asarray(codes.astype(np.uint32)), m, dr, gs, sym,
            jnp.int32(window), cap=255))
        assert np.array_equal(want[rs], got[rs]), window


@pytest.mark.parametrize("cap", BUCKET_CAPS)
def test_dispatch_picks_form_by_cap(cap, monkeypatch):
    called = []
    monkeypatch.setattr(ps, "_pair_hits_scan",
                        lambda bits, c: called.append(("scan", c)) or bits)
    monkeypatch.setattr(ps, "_pair_hits_core",
                        lambda *a: called.append(("core", None)) or a[0])
    bits = jnp.zeros(8, jnp.uint32)
    flag = jnp.zeros(8, bool)
    ps._hits_dispatch(bits, flag, flag, flag, jnp.zeros(8, jnp.int8),
                      jnp.int32(cap), cap=cap)
    want = ("scan", cap) if cap <= ps.SCAN_MAX_CAP else ("core", None)
    assert called == [want]
