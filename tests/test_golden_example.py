"""Golden run on the reference's REAL example reads (the README Quick test).

Uses `/root/reference/example/reads_1.fasta` + `reads_2.fasta` (10,000 real
read pairs, reference README.md:125-131) and the shipped
`example/LineageFile.csv` (3 genomes; CRLF line endings + trailing blank
line).  `example/refs.fasta` is a stripped large blob
(reference .MISSING_LARGE_BLOBS), so the three genomes are synthesized by
embedding half of each accession's own reads — reads of the fourth
accession (CP000360, absent from the lineage, i.e. the negative-control
genome) classify U/A.  End-to-end CSV must be bit-identical across the
oracle binaries, the host path, and the fused device path at the README's
parameters (alpha=16, beta=0.25, TaxRank=1).
"""

import os

import numpy as np
import pytest

from lime_tpu.config import LimeConfig
from lime_tpu.formats.fasta import read_fasta, reverse_complement
from lime_tpu.index.builder import build_index_files
from lime_tpu.pipeline import run_paired

EXAMPLE_DIR = os.path.join(
    os.environ.get("LIME_REFERENCE_SRC", "/root/reference/src"), "..",
    "example")


@pytest.fixture(scope="module")
def example_dataset(tmp_path_factory):
    r1_path = os.path.join(EXAMPLE_DIR, "reads_1.fasta")
    r2_path = os.path.join(EXAMPLE_DIR, "reads_2.fasta")
    if not os.path.exists(r1_path):
        pytest.skip("reference example reads unavailable")
    root = tmp_path_factory.mktemp("golden_example")

    names1, reads1 = read_fasta(r1_path)
    names2, reads2 = read_fasta(r2_path)
    assert len(reads1) == len(reads2) == 10000

    # synthesize the 3 lineage genomes from half of their own reads
    lineage_src = os.path.join(EXAMPLE_DIR, "LineageFile.csv")
    with open(lineage_src, "rb") as f:
        lineage_accs = [line.split(b";")[0].decode()
                        for line in f.read().splitlines()[1:] if line.strip()]
    rng = np.random.default_rng(2024)
    parts = {acc: [] for acc in lineage_accs}
    for i, name in enumerate(names1):
        acc = name.split("-")[0]
        if acc in parts and i % 2 == 0:
            spacer = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                size=20).tobytes()
            parts[acc].append(reads1[i] + spacer
                              + reverse_complement(reads2[i]))
    genomes = [b"".join(parts[acc]) for acc in lineage_accs]
    assert all(len(g) > 100_000 for g in genomes)

    lineage_path = str(root / "LineageFile.csv")
    with open(lineage_src, "rb") as fsrc, open(lineage_path, "wb") as fdst:
        fdst.write(fsrc.read())  # keep CRLF + trailing blank line verbatim

    collections = []
    for tag, reads in (("1F", reads1),
                       ("1RC", [reverse_complement(r) for r in reads1]),
                       ("2F", reads2),
                       ("2RC", [reverse_complement(r) for r in reads2])):
        path = str(root / f"col_{tag}.fasta")
        with open(path, "w") as f:
            f.write(">stub\nACGT\n")
        build_index_files(path, list(reads) + genomes)
        collections.append(path)
    return {"collections": collections, "lineage": lineage_path,
            "num_reads": len(reads1), "num_genomes": len(genomes),
            "read_len": len(reads1[0]), "root": str(root)}


def test_golden_example_oracle_parity(example_dataset, oracle):
    ds = example_dataset
    for c in ds["collections"]:
        oracle.cluster_lcp(c, ds["num_reads"], ds["num_genomes"], 16)
    for c in ds["collections"]:
        oracle.cluster_bwt(c, ds["read_len"], 0.25)
    ref_csv = os.path.join(ds["root"], "ref.csv")
    oracle.classify([c + ".res" for c in ds["collections"]],
                    ds["num_reads"], ds["num_genomes"], ref_csv,
                    ds["lineage"], 1)
    with open(ref_csv) as f:
        ref = f.read()
    # the synthesized genomes must make the test meaningful: most reads of
    # the three DB accessions classify C, the negative control does not
    c_count = sum(1 for line in ref.splitlines()[1:]
                  if line.startswith("C"))
    assert c_count > 3000  # ~4.1k of 10k classify on the synthesized refs

    for name, cfg in (("host", LimeConfig(executor="host")),
                      ("fused", LimeConfig(executor="tpu", fused=True))):
        out = os.path.join(ds["root"], f"ours_{name}.csv")
        run_paired(ds["collections"], out, ds["num_reads"],
                   ds["num_genomes"], ds["lineage"], ds["read_len"], cfg)
        with open(out) as f:
            assert f.read() == ref, name
