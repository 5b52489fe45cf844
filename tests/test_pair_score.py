"""Pair-stream scoring path (G-independent device kernel) vs exact host.

The planner (lime_plan_pairs) + device kernel (ops/pair_score) must
reproduce the reference's scoring semantics exactly: routing covers the
full input domain (sparse clusters to the pair stream, genome-dense to
the dense matmul path, degenerate/long to host rescue) and the accumulated u8 matrix wraps
mod 256 like the reference's SimArray (src/ClusterBWT_DA.cpp:183).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.constants import SYMBOL_RANK_LUT
from lime_tpu.ops.fused_pass import _DEGENERATE_BYTE
from lime_tpu.ops.pair_score import (
    pair_hits,
    pair_hits_host,
    pair_score_into,
)
from lime_tpu.ops.scoring import score_clusters

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")

HOST = LimeConfig(executor="host")


def _random_index(rng, n, num_reads, num_genomes, alpha, deg_frac=0.0,
                  symbols=b"ACGT"):
    """Random (lcp, da, ebwt) with plausible alpha-runs."""
    lcp = rng.integers(0, 2 * 16, n).astype(np.uint32)
    # lengthen some runs so clusters of width > 2 exist
    run_at = rng.choice(n - 40, n // 40, replace=False)
    for s in run_at:
        w = rng.integers(2, 30)
        lcp[s:s + w] = rng.integers(16, 30)
    da = np.where(rng.random(n) < 0.6,
                  rng.integers(0, num_reads, n),
                  rng.integers(num_reads, num_reads + num_genomes, n)
                  ).astype(np.uint32)
    syms = np.frombuffer(symbols, np.uint8)
    ebwt = syms[rng.integers(0, len(syms), n)].copy()
    if deg_frac:
        k = int(n * deg_frac)
        ebwt[rng.choice(n, k, replace=False)] = ord("N")
    return lcp, da, ebwt


def _exact_matrix(lcp, da, ebwt, num_reads, num_genomes, config):
    """Oracle: full cluster list through the exact host scorer."""
    starts, lens, _, _ = _clusters_of(lcp, da, num_reads, config.alpha)
    return score_clusters(starts, lens, da,
                          ebwt if config.use_ebwt else None,
                          num_reads, num_genomes, config)


def _clusters_of(lcp, da, num_reads, alpha):
    m = lcp >= alpha
    m[0] = False
    d = np.diff(m.view(np.int8))
    rs = np.flatnonzero(d == 1) + 1
    re_ = np.flatnonzero(d == -1) + 1
    if m[-1]:
        re_ = np.append(re_, len(lcp))
    ps = rs - 1
    lens = re_ - ps
    cr = np.concatenate([[0], np.cumsum(da < num_reads, dtype=np.int64)])
    nri = cr[ps + lens] - cr[ps]
    mixed = (nri > 0) & (nri < lens)
    return (ps[mixed].astype(np.int64), lens[mixed].astype(np.int64),
            nri[mixed], lens[mixed] - nri[mixed])


def _ours_matrix(lcp, da, ebwt, num_reads, num_genomes, config,
                 dense_min=16):
    """plan_pairs routing: pair kernel + exact scoring of dense/bad."""
    g_pad = max(128, -(-num_genomes // 128) * 128)
    buckets, den_s, den_l, bad_s, bad_l = native.plan_pairs(
        lcp, da, ebwt if config.use_ebwt else None, num_reads,
        config.alpha, g_pad, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE.astype(np.uint8), dense_min=dense_min)
    sim = jnp.zeros((num_reads + 1, g_pad), jnp.int8)
    sim = pair_score_into(sim, buckets, num_reads, g_pad)
    got = np.asarray(sim)[:num_reads, :num_genomes].view(np.uint8).copy()
    for s, l in ((den_s, den_l), (bad_s, bad_l)):
        if len(s):
            got += score_clusters(s, l, da,
                                  ebwt if config.use_ebwt else None,
                                  num_reads, num_genomes, config)
    return got, buckets, den_s, bad_s


@pytest.mark.parametrize("use_ebwt", [True, False])
def test_pair_path_matches_exact(use_ebwt):
    rng = np.random.default_rng(11)
    num_reads, num_genomes = 200, 50
    lcp, da, ebwt = _random_index(rng, 30000, num_reads, num_genomes, 16)
    config = HOST.replace(use_ebwt=use_ebwt)
    want = _exact_matrix(lcp, da, ebwt, num_reads, num_genomes, config)
    got, buckets, _, _ = _ours_matrix(lcp, da, ebwt, num_reads,
                                      num_genomes, config)
    assert len(buckets) >= 1
    np.testing.assert_array_equal(got, want)


def test_pair_path_with_degenerates_and_dense():
    """Degenerate clusters route to rescue; dense to the matmul list."""
    rng = np.random.default_rng(23)
    num_reads, num_genomes = 150, 40
    lcp, da, ebwt = _random_index(rng, 40000, num_reads, num_genomes, 16,
                                  deg_frac=0.01)
    config = HOST
    want = _exact_matrix(lcp, da, ebwt, num_reads, num_genomes, config)
    got, buckets, den_s, bad_s = _ours_matrix(
        lcp, da, ebwt, num_reads, num_genomes, config, dense_min=4)
    assert len(bad_s) > 0  # degenerates were routed out
    np.testing.assert_array_equal(got, want)


def test_pair_path_terminator_symbols():
    """'$' rows map to rank 0 (the reference's operator[] default quirk)
    and '\\0' to rank 15 — both equality-matched, never cross-matched."""
    rng = np.random.default_rng(31)
    num_reads, num_genomes = 100, 20
    lcp, da, ebwt = _random_index(rng, 20000, num_reads, num_genomes, 16,
                                  symbols=b"ACGT$\x00")
    config = HOST
    want = _exact_matrix(lcp, da, ebwt, num_reads, num_genomes, config)
    got, _, _, _ = _ours_matrix(lcp, da, ebwt, num_reads, num_genomes,
                                config)
    np.testing.assert_array_equal(got, want)


def test_pair_hits_device_matches_host_oracle():
    """The banded device kernel == the sequential numpy oracle."""
    rng = np.random.default_rng(7)
    num_reads, num_genomes = 120, 30
    lcp, da, ebwt = _random_index(rng, 15000, num_reads, num_genomes, 16)
    g_pad = 128
    buckets, *_ = native.plan_pairs(
        lcp, da, ebwt, num_reads, 16, g_pad, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE.astype(np.uint8))
    checked = 0
    for packed, _, window in buckets:
        got = np.asarray(pair_hits(jnp.asarray(packed),
                                   jnp.int32(window)))
        want = pair_hits_host(packed)
        np.testing.assert_array_equal(got, want)
        checked += 1
    assert checked >= 1


def test_pair_path_u8_wrap():
    """Accumulation wraps mod 256 exactly like the reference's uchar."""
    # one read, one genome, many identical clusters: force sim > 255
    reps = 300
    lcp = np.zeros(4 * reps, np.uint32)
    da = np.zeros(4 * reps, np.uint32)
    ebwt = np.full(4 * reps, ord("A"), np.uint8)
    for i in range(reps):
        lcp[4 * i + 1] = 20  # run of one transition -> cluster of len 2
        da[4 * i] = 0        # read
        da[4 * i + 1] = 1    # genome
    num_reads, num_genomes = 1, 1
    config = HOST
    want = _exact_matrix(lcp, da, ebwt, num_reads, num_genomes, config)
    got, _, _, _ = _ours_matrix(lcp, da, ebwt, num_reads, num_genomes,
                                config)
    assert want[0, 0] == reps % 256
    np.testing.assert_array_equal(got, want)


def _ours_matrix_packed(lcp, da, ebwt, num_reads, num_genomes, config,
                        dense_min=16):
    """plan_pairs_packed routing: packed device kernel + exact dense/bad."""
    from lime_tpu.ops.pair_score import pair_score_packed_into

    g_pad = max(128, -(-num_genomes // 128) * 128)
    (arrays, chunks, windows, row_bits, den_s, den_l, bad_s,
     bad_l) = native.plan_pairs_packed(
        lcp, da, ebwt if config.use_ebwt else None, num_reads,
        config.alpha, SYMBOL_RANK_LUT, _DEGENERATE_BYTE.astype(np.uint8),
        dense_min=dense_min, chunk_pos=1 << 16)
    sim = jnp.zeros((num_reads + 1, g_pad), jnp.int8)
    sim = pair_score_packed_into(sim, arrays, chunks, windows, row_bits,
                                 num_reads, g_pad)
    got = np.asarray(sim)[:num_reads, :num_genomes].view(np.uint8).copy()
    for s, l in ((den_s, den_l), (bad_s, bad_l)):
        if len(s):
            got += score_clusters(s, l, da,
                                  ebwt if config.use_ebwt else None,
                                  num_reads, num_genomes, config)
    return got, chunks


@pytest.mark.parametrize("use_ebwt", [True, False])
def test_packed_pair_path_matches_exact(use_ebwt):
    rng = np.random.default_rng(13)
    num_reads, num_genomes = 200, 50
    lcp, da, ebwt = _random_index(rng, 30000, num_reads, num_genomes, 16)
    config = HOST.replace(use_ebwt=use_ebwt)
    want = _exact_matrix(lcp, da, ebwt, num_reads, num_genomes, config)
    got, chunks = _ours_matrix_packed(lcp, da, ebwt, num_reads,
                                      num_genomes, config)
    assert len(chunks) >= 2  # the small chunk_pos forces multiple chunks
    np.testing.assert_array_equal(got, want)


def test_packed_pair_path_degenerates_terminators():
    rng = np.random.default_rng(29)
    num_reads, num_genomes = 150, 40
    lcp, da, ebwt = _random_index(rng, 40000, num_reads, num_genomes, 16,
                                  deg_frac=0.01, symbols=b"ACGT$\x00")
    config = HOST
    want = _exact_matrix(lcp, da, ebwt, num_reads, num_genomes, config)
    got, _ = _ours_matrix_packed(lcp, da, ebwt, num_reads, num_genomes,
                                 config, dense_min=4)
    np.testing.assert_array_equal(got, want)


def test_packed_pair_path_u8_wrap():
    reps = 300
    lcp = np.zeros(4 * reps, np.uint32)
    da = np.zeros(4 * reps, np.uint32)
    ebwt = np.full(4 * reps, ord("A"), np.uint8)
    for i in range(reps):
        lcp[4 * i + 1] = 20
        da[4 * i] = 0
        da[4 * i + 1] = 1
    config = HOST
    want = _exact_matrix(lcp, da, ebwt, 1, 1, config)
    got, _ = _ours_matrix_packed(lcp, da, ebwt, 1, 1, config)
    assert want[0, 0] == reps % 256
    np.testing.assert_array_equal(got, want)
