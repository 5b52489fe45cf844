"""Oracle parity at the reference's widest DB width: 3,423 genomes.

The SRR1804065 real-sample database has 3,423 accessions
(reference Datasets/README.md:67) — the widest genome set the reference
publishes.  This exercises the paths that only exist past 1,024 genome
lanes: g_pad 3456 psi tiles on the dense matmul path, the u16 per-copy
genome column of the packed pair stream, and the 12-bit coo24 column of
the hybrid uplink.  Output must be byte-identical to the host executor,
and the host executor to the compiled reference binaries where they can
be built.

Genomes are short (the width is what matters, not the length); a slow
marker keeps it out of the default quick loop only if runtime becomes a
problem — currently ~1.5 min on 2 CPU cores.
"""

import os

import numpy as np
import pytest

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.pipeline import run_paired

from .synth import make_dataset

SRR_GENOMES = 3423


@pytest.fixture(scope="module")
def srr_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("srr_width"))
    rng = np.random.default_rng(99)
    # short genomes: width (3,423 documents) is the stressor; conserved
    # 60-mers shared across blocks of 64 genomes create genome-dense
    # clusters that route to the dense matmul path at this width
    lens = [int(v) for v in rng.integers(180, 260, SRR_GENOMES)]
    ds = make_dataset(root, num_pairs=1500, read_len=60,
                      genome_lens=lens, seed=99, mutation_rate=0.01,
                      negative_fraction=0.1, degenerate_rate=0.001,
                      insert_len=150)
    return ds


def test_srr_width_oracle_parity(srr_dataset, oracle, tmp_path):
    """The host executor matches the compiled reference at width."""
    ds = srr_dataset
    assert ds.num_genomes == SRR_GENOMES
    ref_csv = str(tmp_path / "ref.csv")
    for c in ds.collections:
        oracle.cluster_lcp(c, ds.num_reads, ds.num_genomes, 16, threads=1)
        oracle.cluster_bwt(c, ds.read_len, 0.25, threads=1)
    oracle.classify([c + ".res" for c in ds.collections], ds.num_reads,
                    ds.num_genomes, ref_csv, ds.lineage_path, 1,
                    threads=1)
    host_csv = str(tmp_path / "host.csv")
    run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, LimeConfig(executor="host"))
    assert open(host_csv).read() == open(ref_csv).read()


def test_srr_width_fused_matches_host(srr_dataset, tmp_path):
    """Fused auto-routing (pair stream + dense matmul + rescue) at
    g_pad 3456, and the hybrid split's 12-bit coo24 columns above 1024
    genomes, both byte-identical to the host executor."""
    ds = srr_dataset
    host_csv = str(tmp_path / "host.csv")
    run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, LimeConfig(executor="host"))
    want = open(host_csv).read()

    out = str(tmp_path / "fused.csv")
    run_paired(ds.collections, out, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len,
               LimeConfig(executor="tpu", fused=True, host_frac=0.0))
    assert open(out).read() == want, "fused pair+dense diverged at width"

    out2 = str(tmp_path / "hybrid.csv")
    run_paired(ds.collections, out2, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len,
               LimeConfig(executor="tpu", fused=True, host_frac=0.5))
    assert open(out2).read() == want, "hybrid diverged at width"


def test_srr_width_spmd(srr_dataset, tmp_path):
    """dp-sliced SPMD engine at 3,423 genomes on an 8-device mesh."""
    if not native.available():
        pytest.skip("native planner needed")
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from lime_tpu.parallel import make_mesh
    from lime_tpu.parallel.sharded import run_sharded_pairs

    ds = srr_dataset
    host_csv = str(tmp_path / "host.csv")
    run_paired(ds.collections, host_csv, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, LimeConfig(executor="host"))
    out = str(tmp_path / "spmd.csv")
    mesh = make_mesh(8, shape=(2, 4))
    run_sharded_pairs(ds.collections, out, ds.num_reads, ds.num_genomes,
                      ds.lineage_path, ds.read_len, mesh=mesh)
    assert open(out).read() == open(host_csv).read()
