"""Pin the deliberate divergences from reference bugs, against the oracle.

These tests run the actual reference binary on inputs that trigger its
latent bugs and assert (a) exactly how its output differs from ours and
(b) that our behavior is the defensible one.  See docs/DESIGN.md §"Pinned
divergences".
"""

import os

import numpy as np
import pytest

from lime_tpu.config import LimeConfig
from lime_tpu.formats.lineage import read_lineage
from lime_tpu.pipeline import classify, cluster_bwt, cluster_lcp


@pytest.fixture(scope="module")
def scored_collections(dataset):
    """Host-scored .res files for the session dataset (single-end pair)."""
    cfg = LimeConfig(executor="host")
    res = []
    for c in dataset.collections[:2]:
        cluster_lcp(c, dataset.num_reads, dataset.num_genomes, cfg)
        res.append(cluster_bwt(c, dataset.read_len, cfg))
    return res


def test_empty_taxid_row_divergence(dataset, scored_collections, oracle,
                                    tmp_path):
    """Reference FixRank SKIPS a row whose taxid is empty at the chosen
    rank (src/Classify.cpp:58-60 `if(lin[ind]!="") push_back`); with a
    correct-length lineage that leaves v_corRef short and the binary exits
    with "Number of taxIDs ... lower than genome number" — the genome can
    never be classified at that rank no matter how its reads score.  (With
    surplus rows the same skip silently shifts every later genome's taxon;
    we refuse surplus rows instead.)  Our loader keeps genome ids aligned
    and maps the empty field to taxid 0: reads of the affected genome
    report C with TaxID 0, every other read matches the intact-lineage
    ground truth.
    """
    src = read_lineage(dataset.lineage_path)
    broken = str(tmp_path / "broken.csv")
    with open(dataset.lineage_path) as f:
        lines = f.read().splitlines()
    fields = lines[1].split(";")
    fields[1] = ""  # empty Species taxid for genome 0
    lines[1] = ";".join(fields)
    with open(broken, "w") as f:
        f.write("\n".join(lines) + "\n")

    # the reference refuses the file outright
    with pytest.raises(RuntimeError, match="lower than genome number"):
        oracle.classify(scored_collections, dataset.num_reads,
                        dataset.num_genomes, str(tmp_path / "ref.csv"),
                        broken, tax_rank=1)

    ours_csv = str(tmp_path / "ours.csv")
    classify(scored_collections, dataset.num_reads, dataset.num_genomes,
             ours_csv, broken, LimeConfig(executor="host"))
    good_csv = str(tmp_path / "good.csv")
    classify(scored_collections, dataset.num_reads, dataset.num_genomes,
             good_csv, dataset.lineage_path, LimeConfig(executor="host"))

    species0 = int(src.taxids[0, 0])
    n_zero = n_same = 0
    with open(ours_csv) as f1, open(good_csv) as f2:
        for oline, gline in zip(f1.read().splitlines()[1:],
                                f2.read().splitlines()[1:]):
            g = gline.split(",")
            o = oline.split(",")
            if g[0] == "C" and g[2] != "NA" and int(g[2]) == species0:
                if o[0] == "C":
                    assert o[2] == "0"  # the emptied field, not a shift
                    n_zero += 1
            elif oline == gline:
                n_same += 1
            else:
                # ambiguity involving genome 0 may resolve differently;
                # but no read may ever get another genome's taxon shifted in
                assert o[2] in ("NA", "0", g[2])
    assert n_zero > 10 and n_same > 100


def test_intact_lineage_identical_to_oracle(dataset, scored_collections,
                                            oracle, tmp_path):
    """Control: on a well-formed lineage the outputs are byte-identical."""
    ref_csv = str(tmp_path / "ref.csv")
    oracle.classify(scored_collections, dataset.num_reads,
                    dataset.num_genomes, ref_csv, dataset.lineage_path,
                    tax_rank=1)
    ours_csv = str(tmp_path / "ours.csv")
    classify(scored_collections, dataset.num_reads, dataset.num_genomes,
             ours_csv, dataset.lineage_path, LimeConfig(executor="host"))
    with open(ref_csv) as f1, open(ours_csv) as f2:
        assert f1.read() == f2.read()


def test_sim_dump_matches_reference_small_build(tmp_path, monkeypatch,
                                                capsys, oracle):
    """LIME_DUMP_SIM=1 reproduces the reference's SMALL=1 full-SimArray
    stdout dump byte for byte (src/ClusterBWT_DA.cpp:672-681) — the
    runtime equivalent of that compile-time debug build."""
    import pytest

    from lime_tpu import native
    from lime_tpu.config import LimeConfig
    from lime_tpu.pipeline import cluster_bwt, cluster_lcp
    from tests.synth import make_dataset

    if not native.available():
        pytest.skip("native library unavailable")
    ds = make_dataset(str(tmp_path), num_pairs=40, read_len=60,
                      genome_lens=(2000, 1500), seed=13)
    col = ds.collections[0]
    oracle.cluster_lcp(col, ds.num_reads, ds.num_genomes, 16)
    out = oracle._run(
        "ClusterBWT_DA_BIN1_EBWT1_SMALL1",
        [col, ds.read_len, 0.25, 1],
        cwd=str(tmp_path))
    lo = out.index("***FINAL***")
    hi = out.index("***********", lo) + len("***********\n")
    want = out[lo:hi]

    cluster_lcp(col, ds.num_reads, ds.num_genomes, LimeConfig())
    monkeypatch.setenv("LIME_DUMP_SIM", "1")
    cluster_bwt(col, ds.read_len, LimeConfig(executor="host"))
    got = capsys.readouterr().out
    lo = got.index("***FINAL***")
    hi = got.index("***********", lo) + len("***********\n")
    assert got[lo:hi] == want
