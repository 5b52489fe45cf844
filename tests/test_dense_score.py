"""Tensor-core histogram-matmul dense-scoring path vs the exact host scorer."""

import numpy as np
import pytest

import jax.numpy as jnp

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.ops.dense_score import K, MAX_ENT, PR, dense_score_into
from lime_tpu.ops.scoring import score_clusters
from lime_tpu.pipeline import run_paired

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")

HOST = LimeConfig(executor="host")
FUSED = LimeConfig(executor="tpu", fused=True)


def _random_stream(rng, n, num_reads, num_genomes, read_heavy=0.5):
    da = np.where(rng.random(n) < read_heavy,
                  rng.integers(0, num_reads, n),
                  rng.integers(num_reads, num_reads + num_genomes, n)
                  ).astype(np.uint32)
    ebwt = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    return da, ebwt


def _clusters(rng, n, count, max_len):
    starts = np.sort(rng.choice(n - max_len, count, replace=False))
    lens = rng.integers(2, max_len, count)
    # non-overlapping: clip each to its successor
    lens = np.minimum(lens, np.diff(np.append(starts, n)))
    keep = lens >= 2
    return starts[keep].astype(np.int64), lens[keep].astype(np.int64)


@pytest.mark.parametrize("use_ebwt", [True, False])
def test_dense_matches_exact_host(use_ebwt):
    """Scores via plan_dense + batched matmul == the exact host scorer."""
    rng = np.random.default_rng(5)
    num_reads, num_genomes = 300, 40
    n = 20000
    da, ebwt = _random_stream(rng, n, num_reads, num_genomes)
    starts, lens = _clusters(rng, n, 120, 400)
    eb = ebwt if use_ebwt else None

    g_pad = 128
    r_pad = num_reads + 9
    sim = jnp.zeros((r_pad, g_pad), jnp.int32)
    sim, left_s, left_l = dense_score_into(
        sim, starts, lens, da, eb, num_reads, num_genomes, g_pad)
    got = np.asarray(sim)[:num_reads, :num_genomes].astype(np.int64)
    if len(left_s):  # clusters the identity cannot express: exact host
        got += score_clusters(left_s, left_l, da, eb, num_reads,
                              num_genomes,
                              HOST.replace(wide_sim=True,
                                           use_ebwt=use_ebwt)
                              ).astype(np.int64)

    want = score_clusters(starts, lens, da, eb, num_reads, num_genomes,
                          HOST.replace(wide_sim=True, use_ebwt=use_ebwt)
                          ).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_dense_invalid_clusters_returned():
    """A read-side count > K must be routed back for exact host scoring."""
    num_reads, num_genomes = 4, 3
    # one cluster: read 0 occurs K+2 times with symbol A -> invalid
    da = np.array([0] * (K + 2) + [num_reads, num_reads + 1],
                  np.uint32)
    ebwt = np.frombuffer(b"A" * (K + 2) + b"CA", np.uint8).copy()
    starts = np.array([0], np.int64)
    lens = np.array([len(da)], np.int64)
    sim = jnp.zeros((num_reads + 1, 128), jnp.int32)
    sim, left_s, left_l = dense_score_into(
        sim, starts, lens, da, ebwt, num_reads, num_genomes, 128)
    assert list(left_s) == [0] and list(left_l) == [len(da)]
    assert int(np.asarray(sim).sum()) == 0


def test_dense_multi_entry_cluster():
    """A cluster with more than PR distinct reads splits across entries."""
    rng = np.random.default_rng(11)
    num_reads, num_genomes = 64, 16
    reads = np.arange(num_reads, dtype=np.uint32)  # 64 distinct = 8 entries
    genomes = rng.integers(num_reads, num_reads + num_genomes,
                           40).astype(np.uint32)
    da = np.concatenate([reads, genomes])
    rng.shuffle(da)
    ebwt = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, len(da))
                                            ].copy()
    starts = np.array([0], np.int64)
    lens = np.array([len(da)], np.int64)
    sim = jnp.zeros((num_reads + 1, 128), jnp.int32)
    sim, left_s, left_l = dense_score_into(
        sim, starts, lens, da, ebwt, num_reads, num_genomes, 128)
    assert len(left_s) == 0
    got = np.asarray(sim)[:num_reads, :num_genomes].astype(np.int64)
    want = score_clusters(starts, lens, da, ebwt, num_reads, num_genomes,
                          HOST.replace(wide_sim=True)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_fused_mxu_dense_routing_matches_host(dataset, tmp_path):
    """End-to-end: forcing every eligible cluster through the dense
    path leaves the CSV byte-identical to the host pipeline."""
    a = str(tmp_path / "staged.csv")
    run_paired(dataset.collections, a, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path, dataset.read_len,
               HOST)
    b = str(tmp_path / "fused_dense.csv")
    run_paired(dataset.collections, b, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path, dataset.read_len,
               FUSED.replace(mxu_dense_min=1, dense_threshold=1 << 62))
    assert open(a).read() == open(b).read()
