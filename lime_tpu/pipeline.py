"""Pipeline stage drivers.

Maps one-to-one onto the reference's binaries and shell driver:

- :func:`cluster_lcp`      ~ ClusterLCP      (reference src/ClusterLCP.cpp)
- :func:`cluster_bwt`      ~ ClusterBWT_DA   (src/ClusterBWT_DA.cpp)
- :func:`classify`         ~ Classify        (src/Classify.cpp)
- :func:`run_paired` / :func:`run_single` ~ LiME_paired.sh

Every stage writes the same on-disk artifacts as the reference, so stages
are checkpoints (the reference's file-per-stage resume model,
LiME_paired.sh:5-7) and the two implementations interoperate mid-pipeline.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np

from .config import DEFAULT_CONFIG, LimeConfig
from .constants import MAX_CLUSTER_LEN, NUM_RANKS
from .formats.arrays import (
    AuxMetadata,
    aux_path_for,
    clusters_path_for,
    open_da,
    open_ebwt,
    open_lcp,
    read_aux,
    read_clusters,
    write_aux,
    write_clusters,
)
from .formats.lineage import read_lineage
from .formats.res import (
    dense_from_bin,
    read_results_bin,
    read_results_txt,
    write_results_bin,
    write_results_txt,
)
from .ops.classify_ops import _TYPE_CHARS, TYPE_A, TYPE_C, TYPE_H, TYPE_U, classify_reads
from .ops.cluster_scan import cluster_metadata, find_clusters
from .ops.scoring import normalize_scores, score_clusters
from .utils.timing import PhaseTimer


# ---------------------------------------------------------------------------
# Step 1 — alpha-cluster detection
# ---------------------------------------------------------------------------

def cluster_lcp(fasta_path: str, num_reads: int, num_genomes: int,
                config: LimeConfig = DEFAULT_CONFIG) -> AuxMetadata:
    """Detect alpha-clusters; write ``.alpha.clrs`` + ``.out``."""
    timer = PhaseTimer(f"cluster_lcp[{os.path.basename(fasta_path)}]")
    with timer.phase("load"):
        lcp = open_lcp(fasta_path)
        da = open_da(fasta_path)
    with timer.phase("scan", nbytes=8 * len(lcp)):
        # The standalone boundary scan is pure streaming at memory bandwidth
        # with a one-bit carry; the host implementation is optimal for it.
        # The device executor's value is in the fused scoring pass, where the
        # same mask is consumed on device (ops/fused_pass.py).  The native
        # scan honors config.threads via the straddle protocol (the
        # reference's ClusterLCP `threads` argument, src/ClusterLCP.cpp:139).
        from . import native
        if native.available():
            p_start, lens = native.plan_clusters(
                np.asarray(lcp), np.asarray(da), num_reads, config.alpha,
                threads=config.threads)
        else:
            p_start, lens = find_clusters(np.asarray(lcp), np.asarray(da),
                                          num_reads, config.alpha)
    with timer.phase("write"):
        write_clusters(clusters_path_for(fasta_path, config.alpha), p_start, lens)
        meta = cluster_metadata(p_start, lens, num_reads, num_genomes, config.alpha)
        write_aux(aux_path_for(fasta_path), meta)
    timer.report()
    return meta


# ---------------------------------------------------------------------------
# Step 2 — cluster scoring
# ---------------------------------------------------------------------------

def cluster_bwt(fasta_path: str, read_len: int,
                config: LimeConfig = DEFAULT_CONFIG) -> str:
    """Score clusters; write ``.res.bin``/``.res.pos`` (or ``.res.txt``).

    Returns the ``.res`` prefix path.
    """
    timer = PhaseTimer(f"cluster_bwt[{os.path.basename(fasta_path)}]")
    meta = read_aux(aux_path_for(fasta_path))
    if not config.wide_sim and read_len > 255:
        raise ValueError("read_len > 255 requires wide_sim=True "
                         "(the reference's dataTypeNumSim=1, Tools.h:51)")
    if meta.max_len > MAX_CLUSTER_LEN:
        raise ValueError(f"max cluster size {meta.max_len} exceeds "
                         f"{MAX_CLUSTER_LEN} (reference sizeMaxBuf guard)")

    with timer.phase("load"):
        p_start, lens = read_clusters(clusters_path_for(fasta_path, meta.alpha))
        da = open_da(fasta_path)
        ebwt = open_ebwt(fasta_path) if config.use_ebwt else None
    with timer.phase("score"):
        if config.executor == "tpu":
            from .ops.fused_pass import score_clusters_tpu
            sim = score_clusters_tpu(p_start, lens, da, ebwt, meta.num_reads,
                                     meta.num_genomes, config,
                                     alpha=meta.alpha,
                                     lcp=open_lcp(fasta_path))
        else:
            from . import native
            if native.available():
                # the SIMD scorer honors config.threads (the reference's
                # ClusterBWT_DA OpenMP argument, src/ClusterBWT_DA.cpp:630);
                # outputs are thread-count independent (per-thread partials
                # merged with commutative u8 wrap adds)
                from .constants import IUPAC_WATERFALL_PAIRS, SYMBOL_RANK_LUT
                from .ops.fused_pass import _DEGENERATE_BYTE
                sim = native.score_clusters_native(
                    np.asarray(p_start, np.int64), np.asarray(lens, np.int64),
                    np.asarray(da),
                    None if ebwt is None else np.asarray(ebwt),
                    meta.num_reads, meta.num_genomes, SYMBOL_RANK_LUT,
                    _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
                    wide=config.wide_sim, threads=config.threads)
            else:
                sim = score_clusters(p_start, lens, np.asarray(da),
                                     None if ebwt is None else np.asarray(ebwt),
                                     meta.num_reads, meta.num_genomes, config)
    if os.environ.get("LIME_DUMP_SIM") == "1":
        # runtime equivalent of the reference's SMALL=1 build: the full
        # SimArray as tab-separated ints on stdout
        # (src/ClusterBWT_DA.cpp:672-681) — inspection aid for tiny runs
        import sys as _sys

        w = _sys.stdout.write
        w("***FINAL***\n")
        for row in np.asarray(sim):
            w("\t".join(str(int(v)) for v in row))
            w("\t\n")
        w("***********\n")
    with timer.phase("write"):
        norm_rows = normalize_scores(sim, read_len, meta.alpha)
        res_prefix = fasta_path + ".res"
        if config.binary_results:
            write_results_bin(res_prefix, norm_rows, config.beta)
        else:
            write_results_txt(res_prefix, norm_rows, config.beta)
    timer.report()
    return res_prefix


# ---------------------------------------------------------------------------
# Step 3 — classification
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClassifySummary:
    num_reads: int
    classified: int
    higher: int
    ambiguous: int
    unclassified: int


def _format_sim(x: float) -> str:
    """C++ ostream default float formatting (%g with 6 significant digits)."""
    return f"{float(x):g}"


def classify(res_prefixes: Sequence[str], num_reads: int, num_genomes: int,
             output_path: str, lineage_path: str,
             config: LimeConfig = DEFAULT_CONFIG,
             block_reads: int = 1 << 16) -> ClassifySummary:
    """Merge 2 or 4 ``.res`` files into the final assignment CSV."""
    if len(res_prefixes) not in (2, 4):
        raise ValueError("classify takes 2 (single-end) or 4 (paired-end) "
                         ".res files (reference src/Classify.cpp:334-338)")
    timer = PhaseTimer("classify")
    lineage = read_lineage(lineage_path)
    if lineage.num_genomes != num_genomes:
        raise ValueError(
            f"lineage has {lineage.num_genomes} genomes, expected {num_genomes}: "
            "poor taxonomy information to classify")
    tax = lineage.at_rank(config.tax_rank)
    rank_matrix = lineage.taxids if config.assign_higher else None

    with timer.phase("load"):
        if config.binary_results:
            files = [read_results_bin(p, num_reads,
                                      mmap=num_reads > (1 << 22))
                     for p in res_prefixes]
        else:
            txt = [read_results_txt(p) for p in res_prefixes]

    counts = {"U": 0, "C": 0, "A": 0, "H": 0}
    error = np.float32(config.error_tolerance)

    def _block(lo: int):
        hi = min(lo + block_reads, num_reads)
        dense = np.zeros((hi - lo, len(res_prefixes), num_genomes),
                         dtype=np.float32)
        maxs = np.zeros((hi - lo, len(res_prefixes)), dtype=np.float32)
        for fi in range(len(res_prefixes)):
            if config.binary_results:
                pos, recs = files[fi]
                dense[:, fi], maxs[:, fi] = dense_from_bin(
                    pos, recs, num_reads, num_genomes, lo, hi)
            else:
                for r in range(lo, hi):
                    for k, (sim_v, id_v) in enumerate(txt[fi][r]):
                        if k == 0:
                            maxs[r - lo, fi] = sim_v
                        else:
                            dense[r - lo, fi, id_v] = sim_v
        if config.executor == "tpu":
            from .ops.classify_tpu import classify_reads_tpu
            return classify_reads_tpu(dense, maxs, tax, rank_matrix,
                                      config.tax_rank, error,
                                      config.assign_higher)
        return classify_reads(dense, maxs, tax, rank_matrix,
                              config.tax_rank, error, config.assign_higher)

    blocks = list(range(0, num_reads, block_reads))
    with timer.phase("cascade"), open(output_path, "w") as out:
        out.write("C/U/A/H,IdSeqRead,TaxID,maxSim\n")
        if (config.threads > 1 and len(blocks) > 1
                and config.executor != "tpu"):
            # Read-parallel classification (the reference's `#pragma omp
            # parallel for` over reads, src/Classify.cpp:474-477): blocks
            # run on a thread pool (large-array numpy kernels release the
            # GIL) and results serialize in read order like the
            # reference's vOutput drain (Classify.cpp:722-734).
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=config.threads) as ex:
                for lo, res in zip(blocks, ex.map(_block, blocks)):
                    for t, c in res.counts().items():
                        counts[t] += c
                    _write_csv_block(out, lo, res)
        else:
            for lo in blocks:
                res = _block(lo)
                for t, c in res.counts().items():
                    counts[t] += c
                _write_csv_block(out, lo, res)
    timer.report()
    return ClassifySummary(num_reads=num_reads, classified=counts["C"],
                           higher=counts["H"], ambiguous=counts["A"],
                           unclassified=counts["U"])


def _run_fused(collections, output_path, num_reads, num_genomes,
               lineage_path, read_len, config) -> ClassifySummary:
    """Serving path: one device dispatch for the whole run (no artifacts)."""
    from .formats.lineage import read_lineage as _rl
    from .ops.fused_pipeline import run_fused

    lineage = _rl(lineage_path)
    if lineage.num_genomes != num_genomes:
        raise ValueError(
            f"lineage has {lineage.num_genomes} genomes, expected "
            f"{num_genomes}: poor taxonomy information to classify")
    res = run_fused(collections, num_reads, num_genomes, lineage, read_len,
                    config)
    with open(output_path, "w") as out:
        out.write("C/U/A/H,IdSeqRead,TaxID,maxSim\n")
        _write_csv_block(out, 0, res)
    c = res.counts()
    return ClassifySummary(num_reads=num_reads, classified=c["C"],
                           higher=c["H"], ambiguous=c["A"],
                           unclassified=c["U"])


def _write_csv_block(out, base: int, res) -> None:
    """Emit CSV rows matching the reference's output (src/Classify.cpp:722-731)."""
    from . import native

    if native.available():
        out.flush()
        out.buffer.write(native.format_csv(
            np.asarray(res.types), np.asarray(res.taxid),
            np.asarray(res.sim), base))
        return
    lines: List[str] = []
    for i, t in enumerate(res.types):
        rid = base + i
        if t == TYPE_U:
            lines.append(f"U,{rid},NA,0\n")
        elif t == TYPE_A:
            lines.append(f"A,{rid},NA,0\n")
        else:
            ch = _TYPE_CHARS[t]
            lines.append(
                f"{ch},{rid},{res.taxid[i]},{_format_sim(res.sim[i])}\n")
    out.write("".join(lines))


# ---------------------------------------------------------------------------
# End-to-end drivers (reference LiME_paired.sh)
# ---------------------------------------------------------------------------

def run_paired(collections: Sequence[str], output_path: str, num_reads: int,
               num_genomes: int, lineage_path: str, read_len: int,
               config: LimeConfig = DEFAULT_CONFIG,
               keep_results: bool = True) -> ClassifySummary:
    """Paired-end run over 4 collections in 1F, 1RC, 2F, 2RC order
    (reference LiME_paired.sh:44-79)."""
    if len(collections) != 4:
        raise ValueError("paired-end run needs 4 collections: 1F, 1RC, 2F, 2RC")
    return _run(collections, output_path, num_reads, num_genomes,
                lineage_path, read_len, config, keep_results)


def run_single(collections: Sequence[str], output_path: str, num_reads: int,
               num_genomes: int, lineage_path: str, read_len: int,
               config: LimeConfig = DEFAULT_CONFIG,
               keep_results: bool = True) -> ClassifySummary:
    """Single-end run over 2 collections (F, RC)."""
    if len(collections) != 2:
        raise ValueError("single-end run needs 2 collections: F, RC")
    return _run(collections, output_path, num_reads, num_genomes,
                lineage_path, read_len, config, keep_results)


def _run(collections, output_path, num_reads, num_genomes, lineage_path,
         read_len, config, keep_results) -> ClassifySummary:
    if config.fused and config.executor == "tpu":
        return _run_fused(collections, output_path, num_reads, num_genomes,
                          lineage_path, read_len, config)
    for c in collections:
        cluster_lcp(c, num_reads, num_genomes, config)
    res_prefixes = [cluster_bwt(c, read_len, config) for c in collections]
    summary = classify(res_prefixes, num_reads, num_genomes, output_path,
                       lineage_path, config)
    if not keep_results:
        for p in res_prefixes:
            for ext in (".bin", ".pos", ".txt"):
                try:
                    os.remove(p + ext)
                except FileNotFoundError:
                    pass
    return summary
