"""Sharded SPMD pipeline on an 8-device virtual mesh vs host + oracle.

The sharded path must accept the reference's full input domain: streams with
IUPAC-degenerate symbols (reference src/ClusterBWT_DA.cpp:146-177) and
clusters longer than 255 up to sizeMaxBuf=65,536 (src/Tools.h:35) — both are
routed through the host-rescue COO corrections inside the SPMD step.
"""

import os

import numpy as np
import pytest

import jax

from lime_tpu.config import LimeConfig
from lime_tpu.constants import SYMBOL_RANK_LUT
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp, write_index_arrays
from lime_tpu.parallel import banded_fused_step, make_mesh, run_sharded
from lime_tpu.pipeline import run_paired

from .synth import make_dataset

HOST = LimeConfig(executor="host")

MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 1)]


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_matches_host_on_standard_dataset(dataset, shape, tmp_path):
    """Byte-identical CSV vs the host pipeline on data WITH degenerates."""
    ds = dataset
    n_dev = shape[0] * shape[1]
    if n_dev > len(jax.devices()):
        pytest.skip("not enough devices")
    host_csv = str(tmp_path / "host.csv")
    run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, HOST)

    mesh = make_mesh(n_dev, shape=shape)
    shard_csv = str(tmp_path / "shard.csv")
    run_sharded(ds.collections, shard_csv, ds.num_reads, ds.num_genomes,
                ds.lineage_path, ds.read_len, LimeConfig(), mesh=mesh)

    with open(host_csv) as f1, open(shard_csv) as f2:
        assert f1.read() == f2.read()


def test_sharded_density_routing_matches_host(dataset, tmp_path):
    """Density-routed sharded run (host matrix merged on-mesh) == host."""
    ds = dataset
    host_csv = str(tmp_path / "host.csv")
    run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, HOST)
    mesh = make_mesh(min(8, len(jax.devices())))
    for thresh in (10**9, 3):
        shard_csv = str(tmp_path / f"shard_{thresh}.csv")
        run_sharded(ds.collections, shard_csv, ds.num_reads, ds.num_genomes,
                    ds.lineage_path, ds.read_len,
                    LimeConfig(dense_threshold=thresh), mesh=mesh)
        with open(host_csv) as f1, open(shard_csv) as f2:
            assert f1.read() == f2.read(), f"threshold {thresh}"


def test_sharded_higher_matches_host(dataset, tmp_path):
    ds = dataset
    cfg_h = LimeConfig(executor="host", assign_higher=True, tax_rank=1)
    host_csv = str(tmp_path / "host.csv")
    run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, cfg_h)
    mesh = make_mesh(min(8, len(jax.devices())))
    shard_csv = str(tmp_path / "shard.csv")
    run_sharded(ds.collections, shard_csv, ds.num_reads, ds.num_genomes,
                ds.lineage_path, ds.read_len,
                LimeConfig(assign_higher=True, tax_rank=1), mesh=mesh)
    with open(host_csv) as f1, open(shard_csv) as f2:
        assert f1.read() == f2.read()


def _craft_long_cluster_collection(path: str, rng, num_reads: int,
                                   num_genomes: int, n: int) -> None:
    """Index arrays containing a >255-position cluster + degenerates.

    Arbitrary (lcp, da, ebwt) arrays are a valid pipeline input — the three
    binaries never look at the FASTA — so the fixture plants exactly the
    cluster shapes the banded kernel cannot express and the rescue path
    must cover (len > 255: src/Tools.h:35 allows up to 65,536; IUPAC
    degenerate: src/ClusterBWT_DA.cpp:146-177).
    """
    num_docs = num_reads + num_genomes
    lcp = rng.integers(0, 16, size=n).astype(np.uint32)  # all < alpha
    da = rng.integers(0, num_docs, size=n).astype(np.uint32)
    sym_pool = np.frombuffer(b"ACGTACGTACGTN", dtype=np.uint8)
    ebwt = rng.choice(sym_pool, size=n)

    def plant(start, length, with_degenerate=False):
        lcp[start + 1:start + length] = 16 + rng.integers(
            0, 8, size=length - 1).astype(np.uint32)
        lcp[start + length] = 3  # close the run
        # guarantee the membership filter sees both sides
        da[start] = rng.integers(0, num_reads)
        da[start + 1] = num_reads + rng.integers(0, num_genomes)
        if with_degenerate:
            ebwt[start + length // 2] = ord("N")
            ebwt[start + length // 3] = ord("R")
        else:
            acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
            ebwt[start:start + length] = rng.choice(acgt, size=length)

    plant(100, 301)                        # long, pure ACGT
    plant(600, 400, with_degenerate=True)  # long + degenerate
    plant(1200, 12)                        # normal short cluster
    plant(1300, 9, with_degenerate=True)   # short + degenerate
    lcp[0] = 0
    write_index_arrays(path, ebwt, lcp, da)


def test_sharded_long_cluster_matches_oracle(oracle, tmp_path):
    """End-to-end CSV parity vs the reference binaries on a fixture whose
    clusters exceed the banded kernel's 255 bound."""
    num_reads, num_genomes, n = 10, 3, 2000
    rng = np.random.default_rng(42)
    cols = []
    for tag in ("F", "RC"):
        path = str(tmp_path / f"crafted_{tag}.fasta")
        with open(path, "w") as f:
            f.write(">placeholder\nACGT\n")
        _craft_long_cluster_collection(path, rng, num_reads, num_genomes, n)
        cols.append(path)

    lineage = str(tmp_path / "lineage.csv")
    with open(lineage, "w") as f:
        f.write("Acc;Sp;Ge;Fa;Or;Cl;Ph\n")
        for j in range(num_genomes):
            f.write(f"G{j};{100 + j};{200 + j};300;400;500;600\n")

    for c in cols:
        oracle.cluster_lcp(c, num_reads, num_genomes, 16)
        oracle.cluster_bwt(c, 100, 0.25)
    ref_csv = str(tmp_path / "ref.csv")
    oracle.classify([c + ".res" for c in cols], num_reads, num_genomes,
                    ref_csv, lineage, 1)

    mesh = make_mesh(min(8, len(jax.devices())))
    ours_csv = str(tmp_path / "ours.csv")
    run_sharded(cols, ours_csv, num_reads, num_genomes, lineage, 100,
                LimeConfig(), mesh=mesh)
    with open(ref_csv) as f1, open(ours_csv) as f2:
        assert f1.read() == f2.read()


@pytest.fixture(scope="module")
def clean_dataset(tmp_path_factory):
    """Degenerate-free dataset for the raw banded step (no rescue routing)."""
    root = tmp_path_factory.mktemp("synth_clean")
    return make_dataset(str(root), num_pairs=128, read_len=64,
                        genome_lens=(4000, 3000), seed=11,
                        degenerate_rate=0.0)


def test_banded_single_device_matches_host_scoring(clean_dataset):
    from lime_tpu.ops.cluster_scan import find_clusters
    from lime_tpu.ops.scoring import score_clusters

    ds = clean_dataset
    fasta = ds.collections[0]
    lcp = np.asarray(open_lcp(fasta)).astype(np.int32)
    da = np.asarray(open_da(fasta)).astype(np.int32)
    ebwt = np.asarray(open_ebwt(fasta))
    sym = SYMBOL_RANK_LUT[ebwt].astype(np.int32)
    p, l = find_clusters(np.asarray(open_lcp(fasta)), da, ds.num_reads, 16)
    expected = score_clusters(p, l, da, ebwt, ds.num_reads, ds.num_genomes,
                              HOST)
    out = jax.jit(banded_fused_step, static_argnums=(3, 4, 5, 6))(
        lcp, da, sym, ds.num_reads, ds.num_genomes, 16, 64)
    np.testing.assert_array_equal(np.asarray(out) % 256, expected)


def test_sharded_mxu_dense_matches_host(dataset, tmp_path):
    """Dense histogram-matmul chunks inside the SPMD step == host pipeline.

    mxu_dense_min=1 routes every eligible pure-ACGT cluster through the
    in-program dense scan (degenerate clusters still ride the COO rescue).
    """
    ds = dataset
    host_csv = str(tmp_path / "host.csv")
    run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, HOST)
    for shape in ((4, 2), (1, 1)):
        n_dev = shape[0] * shape[1]
        if n_dev > len(jax.devices()):
            continue
        mesh = make_mesh(n_dev, shape=shape)
        shard_csv = str(tmp_path / f"shard_mxu_{n_dev}.csv")
        run_sharded(ds.collections, shard_csv, ds.num_reads,
                    ds.num_genomes, ds.lineage_path, ds.read_len,
                    LimeConfig(mxu_dense_min=1, dense_threshold=1 << 62),
                    mesh=mesh)
        with open(host_csv) as f1, open(shard_csv) as f2:
            assert f1.read() == f2.read(), f"mesh {shape}"


def test_pair_engine_sharded_matches_host(dataset, tmp_path):
    """The chunk-parallel pair-stream SPMD engine == the host pipeline."""
    from lime_tpu.parallel.sharded import run_sharded_pairs

    ds = dataset
    host_csv = str(tmp_path / "host_pair.csv")
    run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, LimeConfig(executor="host"))
    for shape in ((8, 1), (2, 4), (1, 1)):
        mesh = make_mesh(shape[0] * shape[1], shape=shape)
        out_csv = str(tmp_path / f"pair_{shape[0]}x{shape[1]}.csv")
        run_sharded_pairs(ds.collections, out_csv, ds.num_reads,
                          ds.num_genomes, ds.lineage_path, ds.read_len,
                          mesh=mesh)
        with open(host_csv) as f:
            want = f.read()
        with open(out_csv) as f:
            got = f.read()
        assert got == want, f"mesh {shape} diverged"
