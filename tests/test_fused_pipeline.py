"""Fused one-dispatch pipeline vs the staged pipeline (identical CSV)."""

from lime_tpu.config import LimeConfig
from lime_tpu.pipeline import run_paired, run_single

HOST = LimeConfig(executor="host")
FUSED = LimeConfig(executor="tpu", fused=True)


def test_fused_matches_staged(dataset, tmp_path):
    a = str(tmp_path / "staged.csv")
    b = str(tmp_path / "fused.csv")
    s1 = run_paired(dataset.collections, a, dataset.num_reads,
                    dataset.num_genomes, dataset.lineage_path,
                    dataset.read_len, HOST)
    s2 = run_paired(dataset.collections, b, dataset.num_reads,
                    dataset.num_genomes, dataset.lineage_path,
                    dataset.read_len, FUSED)
    assert open(a).read() == open(b).read()
    assert s1 == s2


def test_fused_density_routing_matches_host(dataset, tmp_path):
    """Any density-routing split must leave the output byte-identical.

    dense_threshold=10**9 forces every cluster through the native host
    scorer; an intermediate value splits clusters between the device banded
    kernel and the host scorer mid-collection.
    """
    a = str(tmp_path / "staged.csv")
    run_paired(dataset.collections, a, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path, dataset.read_len,
               HOST)
    for thresh in (10**9, 3):
        b = str(tmp_path / f"fused_{thresh}.csv")
        run_paired(dataset.collections, b, dataset.num_reads,
                   dataset.num_genomes, dataset.lineage_path,
                   dataset.read_len, FUSED.replace(dense_threshold=thresh))
        assert open(a).read() == open(b).read(), f"threshold {thresh}"


def test_fused_single_end_higher(dataset, tmp_path):
    a = str(tmp_path / "staged.csv")
    b = str(tmp_path / "fused.csv")
    cfg_h = HOST.replace(assign_higher=True, tax_rank=1)
    cfg_f = FUSED.replace(assign_higher=True, tax_rank=1)
    run_single(dataset.single_collections, a, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path,
               dataset.read_len, cfg_h)
    run_single(dataset.single_collections, b, dataset.num_reads,
               dataset.num_genomes, dataset.lineage_path,
               dataset.read_len, cfg_f)
    assert open(a).read() == open(b).read()
