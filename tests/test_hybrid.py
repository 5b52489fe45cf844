"""Hybrid host/device split: any host_frac must be byte-identical.

The hybrid engine hash-routes a share of clusters to the host SIMD
scorer (uplinked as delta-COO nonzeros) and leaves the rest on the
device pair stream.  Scatter adds commute and both engines implement
the reference's exact counter semantics (src/ClusterBWT_DA.cpp:81-252),
so every split — including all-host — must reproduce the host oracle
byte for byte.
"""

import numpy as np
import pytest

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.pipeline import run_paired

HOST = LimeConfig(executor="host")
FUSED = LimeConfig(executor="tpu", fused=True)


@pytest.mark.skipif(not native.available(), reason="native planner needed")
def test_hybrid_fractions_match_host(dataset, tmp_path):
    a = str(tmp_path / "staged.csv")
    run_paired(dataset.collections, a, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path,
               dataset.read_len, HOST)
    for frac in (0.0, 0.5, 1.0):
        b = str(tmp_path / f"hybrid_{frac}.csv")
        run_paired(dataset.collections, b, dataset.num_reads,
                   dataset.num_genomes, dataset.lineage_path,
                   dataset.read_len, FUSED.replace(host_frac=frac))
        assert open(a).read() == open(b).read(), f"host_frac {frac}"


@pytest.mark.skipif(not native.available(), reason="native planner needed")
def test_hybrid_wide_counters(dataset, tmp_path):
    """u32 counters (dataTypeNumSim=1) ride the 7-byte COO variant."""
    a = str(tmp_path / "staged.csv")
    run_paired(dataset.collections, a, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path,
               dataset.read_len, HOST.replace(wide_sim=True))
    b = str(tmp_path / "hybrid.csv")
    run_paired(dataset.collections, b, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path,
               dataset.read_len,
               FUSED.replace(wide_sim=True, host_frac=1.0))
    assert open(a).read() == open(b).read()


@pytest.mark.skipif(not native.available(), reason="native planner needed")
def test_coo_chain_roundtrip():
    """coo_compact -> merge_coo_segments -> host cumsum reconstruction."""
    from lime_tpu.ops.pair_score import merge_coo_segments

    rng = np.random.default_rng(7)
    mat = np.zeros((5000, 130), np.uint8)
    rows = np.concatenate([rng.integers(0, 600, 800),
                           rng.integers(4200, 5000, 400)])
    cols = rng.integers(0, 130, len(rows))
    mat[rows, cols] = rng.integers(1, 256, len(rows)).astype(np.uint8)
    for threads in (1, 2, 4):
        chain = merge_coo_segments(
            native.coo_compact(mat, 5000, 130, threads=threads))
        base, drow, col, val = chain
        rr = base + np.cumsum(drow.astype(np.int64))
        rec = np.zeros_like(mat)
        np.add.at(rec, (rr, col.astype(np.int64)), val)
        assert np.array_equal(rec, mat), threads


@pytest.mark.skipif(not native.available(), reason="native planner needed")
def test_planner_host_num_partition():
    """host_num routing moves clusters between lists without loss: the
    union of stream rows + dense + host positions is invariant."""
    from lime_tpu.constants import SYMBOL_RANK_LUT
    from lime_tpu.ops.fused_pass import _DEGENERATE_BYTE

    rng = np.random.default_rng(3)
    n = 200_000
    lcp = rng.integers(0, 32, n).astype(np.uint32)
    da = rng.integers(0, 120, n).astype(np.uint32)
    eb = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    deg = _DEGENERATE_BYTE.astype(np.uint8)

    def plan(hn):
        (_, chunks, _, _, ds, dl, bs, bl) = native.plan_pairs_packed(
            lcp, da, eb, 100, 16, SYMBOL_RANK_LUT, deg, host_num=hn)
        return int(dl.sum()), int(bl.sum()), sum(c[2] for c in chunks)

    d0, b0, s0 = plan(0)
    d1, b1, s1 = plan(128)
    d2, b2, s2 = plan(256)
    assert s2 == 0 and d2 == 0
    assert b2 > b1 > b0

    # host_num=256 captures exactly the membership-filtered clusters
    m = lcp >= 16
    m[0] = False
    edges = np.flatnonzero(np.diff(m.astype(np.int8)))
    starts = edges[0::2]  # run starts at edge+1; cluster covers edge
    ends = edges[1::2] + 1
    if m[-1]:
        ends = np.append(ends, n)
    total = 0
    for s, e in zip(starts, ends):
        nr = int((da[s:e] < 100).sum())
        if 0 < nr < e - s:
            total += e - s
    assert b2 == total


@pytest.mark.skipif(not native.available(), reason="native planner needed")
def test_hybrid_blocked_mode(dataset, tmp_path, monkeypatch):
    """Hybrid host scoring composes with the row-blocked beyond-HBM
    mode: per block, the host plane's row slice ships as delta-COO into
    the stack plane.  Forced multi-block via LIME_HBM_BUDGET=1."""
    a = str(tmp_path / "staged.csv")
    run_paired(dataset.collections, a, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path,
               dataset.read_len, HOST)
    monkeypatch.setenv("LIME_HBM_BUDGET", "1")
    for frac in (1.0, 0.5):
        b = str(tmp_path / f"blocked_{frac}.csv")
        run_paired(dataset.collections, b, dataset.num_reads,
                   dataset.num_genomes, dataset.lineage_path,
                   dataset.read_len, FUSED.replace(host_frac=frac))
        assert open(a).read() == open(b).read(), f"host_frac {frac}"


@pytest.mark.parametrize("offload,use_ebwt", [("0", True), ("1", True),
                                              ("1", False)])
def test_all_host_dense_offload_byte_identical(tmp_path, monkeypatch,
                                               offload, use_ebwt):
    """Pair-heavy clusters offloaded to the dense matmul path in all-host
    mode (round 5: 0.18% of clusters carry ~84% of pair work at paper
    scale) must not change a byte vs pure all-host or the host
    pipeline.  Deep-coverage duplicate reads force pair-heavy clusters
    at test scale."""
    import numpy as np

    from tests.synth import make_dataset

    from lime_tpu.config import LimeConfig
    from lime_tpu.pipeline import run_paired

    ds = make_dataset(str(tmp_path), num_pairs=300, read_len=80,
                      genome_lens=(5000, 4000), seed=77)
    host_out = tmp_path / "host.csv"
    run_paired(ds.collections, str(host_out), ds.num_reads,
               ds.num_genomes, ds.lineage_path, ds.read_len,
               LimeConfig(executor="host", use_ebwt=use_ebwt))
    monkeypatch.setenv("LIME_DENSE_OFFLOAD", offload)
    # threshold low enough that many clusters actually route at test
    # scale (production default is 256 pairs)
    monkeypatch.setenv("LIME_DENSE_OFFLOAD_MIN", "4")
    out = tmp_path / f"off{offload}.csv"
    run_paired(ds.collections, str(out), ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len,
               LimeConfig(executor="tpu", fused=True, host_frac=1.0,
                          use_ebwt=use_ebwt))
    assert out.read_text() == host_out.read_text()
