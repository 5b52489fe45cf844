"""Vectorized large-scale synthetic workload generator.

Builds paper-scale fixtures (10^6 read pairs x ~10^3 genomes — the shape of
the reference's setB2 workload, reference README.md:137 / Datasets/README.md)
fast enough for benchmarking: all sequence synthesis is vectorized numpy and
the four collection indexes are built with the native SA-IS builder straight
from concatenated arrays (no FASTA round trip — the pipeline binaries never
read the FASTA, only ``<fasta>.ebwt/.lcp/.da``).

Biology knobs:

- ``conserved_frac``: a fraction of each genome is a mutated copy of its
  *group's* template (groups of ``group_size`` genomes), modeling conserved
  genus-level regions.  These create genome-dense alpha-clusters — the
  regime the dense matmul path is routed (density routing).
- reads are sampled from both strands with per-base mutations; a
  ``negative_fraction`` of shuffled reads must classify U (the reference
  benchmark's negative controls, Datasets/README.md:16).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from lime_tpu import native
from lime_tpu.formats.arrays import write_index_arrays

_COMP = np.zeros(4, np.uint8)
_COMP[[0, 1, 2, 3]] = [3, 2, 1, 0]  # A<->T, C<->G in 2-bit code
_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class BigDataset:
    root: str
    collections: List[str]
    lineage_path: str
    num_reads: int
    num_genomes: int
    read_len: int
    positions_per_collection: int


def _mutate(rng, arr2bit, rate):
    mask = rng.random(arr2bit.shape) < rate
    arr2bit[mask] = rng.integers(0, 4, size=int(mask.sum()), dtype=np.uint8)
    return arr2bit


def _synth_sequences(rng, num_pairs, num_genomes, genome_len, read_len,
                     insert_len, mutation_rate, negative_fraction,
                     conserved_frac, group_size, chunk):
    """All sequence synthesis (shared rng-draw order with compute_truth).

    Returns (genomes_flat_2bit, reads1, reads2, truth) where truth[i] is
    the origin genome of positive read pair i and -1 for the shuffled
    negative controls.
    """
    # --- genomes (2-bit codes) with group-conserved blocks -----------------
    genomes = rng.integers(0, 4, size=(num_genomes, genome_len),
                           dtype=np.uint8)
    block = int(genome_len * conserved_frac)
    if block >= 32:
        for g0 in range(0, num_genomes, group_size):
            g1 = min(num_genomes, g0 + group_size)
            template = rng.integers(0, 4, size=block, dtype=np.uint8)
            offs = rng.integers(0, genome_len - block, size=g1 - g0)
            for gi, off in zip(range(g0, g1), offs):
                copy = _mutate(rng, template.copy(), mutation_rate)
                genomes[gi, off:off + block] = copy

    # --- reads --------------------------------------------------------------
    n_pos = num_pairs - int(num_pairs * negative_fraction)
    reads1 = np.empty((num_pairs, read_len), np.uint8)
    reads2 = np.empty((num_pairs, read_len), np.uint8)
    truth = np.full(num_pairs, -1, np.int64)
    flat = genomes.reshape(-1)
    for lo in range(0, n_pos, chunk):
        hi = min(n_pos, lo + chunk)
        m = hi - lo
        origin = rng.integers(0, num_genomes, size=m)
        start = rng.integers(0, genome_len - insert_len, size=m)
        idx = (origin * genome_len + start)[:, None] + np.arange(insert_len)
        frag = flat[idx]
        flip = rng.random(m) < 0.5
        frag[flip] = _COMP[frag[flip, ::-1]]
        r1 = _mutate(rng, frag[:, :read_len].copy(), mutation_rate)
        r2 = _mutate(rng, frag[:, -read_len:].copy(), mutation_rate)
        reads1[lo:hi] = r1
        reads2[lo:hi] = _COMP[r2[:, ::-1]]  # mate 2 reported on F strand
        truth[lo:hi] = origin
    reads1[n_pos:] = rng.integers(0, 4, size=(num_pairs - n_pos, read_len),
                                  dtype=np.uint8)
    reads2[n_pos:] = rng.integers(0, 4, size=(num_pairs - n_pos, read_len),
                                  dtype=np.uint8)
    return flat, reads1, reads2, truth


def compute_truth(root: str, num_pairs: int, num_genomes: int,
                  genome_len: int, read_len: int = 100,
                  insert_len: int = 250, seed: int = 17,
                  mutation_rate: float = 0.01,
                  negative_fraction: float = 0.05,
                  conserved_frac: float = 0.1, group_size: int = 64,
                  chunk: int = 1 << 16) -> np.ndarray:
    """Ground-truth origins for a dataset, loading or replaying.

    Datasets generated before truth.npy existed are recovered by
    replaying the exact rng draw sequence of the generator (cheap — the
    expensive part of generation is index construction, which this
    skips); the result is cached next to the dataset.
    """
    path = os.path.join(root, "truth.npy")
    if os.path.exists(path):
        return np.load(path)
    rng = np.random.default_rng(seed)
    _, _, _, truth = _synth_sequences(
        rng, num_pairs, num_genomes, genome_len, read_len, insert_len,
        mutation_rate, negative_fraction, conserved_frac, group_size,
        chunk)
    np.save(path, truth)
    return truth


def make_big_dataset(root: str, num_pairs: int, num_genomes: int,
                     genome_len: int, read_len: int = 100,
                     insert_len: int = 250, seed: int = 17,
                     mutation_rate: float = 0.01,
                     negative_fraction: float = 0.05,
                     conserved_frac: float = 0.1,
                     group_size: int = 64,
                     chunk: int = 1 << 16) -> BigDataset:
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)

    flat, reads1, reads2, truth = _synth_sequences(
        rng, num_pairs, num_genomes, genome_len, read_len, insert_len,
        mutation_rate, negative_fraction, conserved_frac, group_size,
        chunk)
    np.save(os.path.join(root, "truth.npy"), truth)

    # --- lineage ------------------------------------------------------------
    lineage_path = os.path.join(root, "LineageFile.csv")
    with open(lineage_path, "w") as f:
        f.write("Acc;Sp;Ge;Fa;Or;Cl;Ph\n")
        for g in range(num_genomes):
            f.write(f"G{g:04d};{1000 + g};{20000 + g // 4};"
                    f"{30000 + g // 16};{40000 + g // 64};"
                    f"{50000 + g // 256};60000\n")

    # --- per-collection merged indexes (reads of one strand + genomes) -----
    glens = np.full(num_genomes, genome_len, np.int64)
    gflat_ascii = _BASE[flat]
    lens = np.concatenate([np.full(num_pairs, read_len, np.int64), glens])
    def build(tag, reads):
        path = os.path.join(root, f"col_{tag}.fasta")
        with open(path, "w") as f:
            f.write(f">stub {tag}\nACGT\n")  # binaries read only the arrays
        concat = np.concatenate([_BASE[reads.reshape(-1)], gflat_ascii])
        ebwt, lcp, da = native.build_index_native_concat(concat, lens)
        write_index_arrays(path, ebwt, lcp, da)
        return path, len(ebwt)

    # the native builder releases the GIL: the four indexes build at once
    from concurrent.futures import ThreadPoolExecutor

    strands = (("1F", reads1), ("1RC", _COMP[reads1[:, ::-1]]),
               ("2F", reads2), ("2RC", _COMP[reads2[:, ::-1]]))
    with ThreadPoolExecutor(max_workers=4) as pool:
        built = list(pool.map(lambda s: build(*s), strands))

    return BigDataset(root=root, collections=[p for p, _ in built],
                      lineage_path=lineage_path, num_reads=num_pairs,
                      num_genomes=num_genomes, read_len=read_len,
                      positions_per_collection=built[-1][1])
