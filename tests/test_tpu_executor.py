"""Device-executor parity: jax path vs host path vs oracle artifacts.

Runs on CPU jax here; the kernels are platform-agnostic jax, and
``chip_smoke.py`` runs the same code on the GPU.
"""

import numpy as np
import pytest

from lime_tpu.config import LimeConfig
from lime_tpu.formats.arrays import clusters_path_for, open_da, open_ebwt, open_lcp, read_clusters
from lime_tpu.ops.classify_ops import classify_reads
from lime_tpu.ops.classify_tpu import classify_reads_tpu
from lime_tpu.ops.cluster_scan import find_clusters
from lime_tpu.ops.fused_pass import find_clusters_tpu, score_clusters_tpu
from lime_tpu.ops.scoring import score_clusters
from lime_tpu.pipeline import cluster_lcp, run_paired

HOST = LimeConfig(executor="host")
DEVICE = LimeConfig(executor="tpu")


def test_find_clusters_tpu_matches_host(dataset):
    fasta = dataset.collections[0]
    lcp, da = open_lcp(fasta), open_da(fasta)
    hp, hl = find_clusters(np.asarray(lcp), np.asarray(da),
                           dataset.num_reads, 16)
    # small blocks force many block-boundary carries
    tp, tl = find_clusters_tpu(lcp, da, dataset.num_reads, 16, block=4096)
    np.testing.assert_array_equal(hp, tp)
    np.testing.assert_array_equal(hl, tl)


@pytest.mark.parametrize("use_ebwt", [True, False])
def test_score_clusters_tpu_matches_host(dataset, use_ebwt):
    fasta = dataset.collections[0]
    cluster_lcp(fasta, dataset.num_reads, dataset.num_genomes, HOST)
    p, l = read_clusters(clusters_path_for(fasta, 16))
    da, ebwt = np.asarray(open_da(fasta)), np.asarray(open_ebwt(fasta))
    cfg_h = HOST.replace(use_ebwt=use_ebwt)
    cfg_t = DEVICE.replace(use_ebwt=use_ebwt)
    sim_h = score_clusters(p, l, da, ebwt, dataset.num_reads,
                           dataset.num_genomes, cfg_h)
    sim_t = score_clusters_tpu(p, l, da, ebwt, dataset.num_reads,
                               dataset.num_genomes, cfg_t)
    np.testing.assert_array_equal(sim_h, sim_t)


def test_classify_tpu_matches_host(dataset):
    rng = np.random.default_rng(3)
    B, F, T = 257, 4, 5
    dense = np.where(rng.random((B, F, T)) < 0.5, 0,
                     rng.random((B, F, T))).astype(np.float32)
    maxs = dense.max(axis=2)
    tax = np.array([10, 10, 11, 12, 12], dtype=np.uint32)
    rank_matrix = np.vstack([tax + 100 * r for r in range(6)]).astype(np.uint32)
    rank_matrix[2] = 7  # unanimous at level 2 → H
    for higher in (False, True):
        a = classify_reads(dense, maxs, tax, rank_matrix, 1,
                           np.float32(0.02), higher)
        b = classify_reads_tpu(dense, maxs, tax, rank_matrix, 1,
                               np.float32(0.02), higher)
        np.testing.assert_array_equal(a.types, b.types)
        np.testing.assert_array_equal(a.taxid, b.taxid)
        np.testing.assert_array_equal(a.sim, b.sim)


def test_tpu_end_to_end_matches_host(dataset, tmp_path):
    out_h = str(tmp_path / "host.csv")
    out_t = str(tmp_path / "tpu.csv")
    s_h = run_paired(dataset.collections, out_h, dataset.num_reads,
                     dataset.num_genomes, dataset.lineage_path,
                     dataset.read_len, HOST)
    s_t = run_paired(dataset.collections, out_t, dataset.num_reads,
                     dataset.num_genomes, dataset.lineage_path,
                     dataset.read_len, DEVICE)
    assert open(out_h).read() == open(out_t).read()
    assert s_h == s_t
