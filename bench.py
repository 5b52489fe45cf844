"""Benchmark: fused-pipeline classification throughput vs the host executor.

Two workloads, both synthetic (the reference publishes no numbers of its
own — BASELINE.md):

- ``example``: 50k read pairs x 6 genomes — the round-1 configuration.
- ``paper``: 1M read pairs x 930 genomes (the genome count of the
  reference's simulated benchmark DB, reference Datasets/README.md:35;
  read count within 20x of setB2, README.md:137) with genus-conserved
  genome blocks.  Scoring runs on device through the packed pair-stream
  path (sparse clusters) + the dense histogram-matmul path (dense
  clusters); the classify cascade is one device program.

The baseline is the in-repo host executor (``LimeConfig(executor="host")``,
one thread).  Any output mismatch vs the host executor is fatal.

Ours runs >= 3 times; the JSON carries min/median/max, per-phase
breakdowns of the best run and the measured host<->device link
bandwidth.  ``unstable: true`` is set (and logged loudly) when
max/min > 2.

Prints exactly one JSON line; the headline metric is the paper-scale
throughput (median).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
DATA_DIR = os.path.join(ROOT, "build", "bench_data")
PAPER_DIR = os.path.join(ROOT, "build", "paper_data")

SEED = 123


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _example_dataset():
    """50k pairs x 6 genomes (round-1 configuration)."""
    from tests.synth import SynthDataset, make_dataset

    num_pairs, read_len = 50000, 100
    genome_lens = (250_000, 220_000, 200_000, 180_000, 160_000, 140_000)
    stamp = os.path.join(
        DATA_DIR, f"v2_{num_pairs}_{read_len}_{len(genome_lens)}_{SEED}.ok")
    if not os.path.exists(stamp):
        _log(f"bench[example]: building dataset ({num_pairs} pairs)...")
        os.makedirs(DATA_DIR, exist_ok=True)
        t0 = time.time()
        make_dataset(DATA_DIR, num_pairs=num_pairs, read_len=read_len,
                     genome_lens=genome_lens, seed=SEED)
        with open(stamp, "w") as f:
            f.write("ok")
        _log(f"bench[example]: dataset built in {time.time() - t0:.1f}s")
    collections = [os.path.join(DATA_DIR, f"col_{t}.fasta")
                   for t in ("1F", "1RC", "2F", "2RC")]
    return SynthDataset(
        root=DATA_DIR, collections=collections,
        lineage_path=os.path.join(DATA_DIR, "LineageFile.csv"),
        num_reads=num_pairs, num_genomes=len(genome_lens),
        read_len=read_len, genomes=[], reads1=[], reads2=[])


def _paper_dataset():
    """1M pairs x 930 genomes with genus-conserved blocks."""
    from tests.synth_big import BigDataset, make_big_dataset

    num_pairs, num_genomes, genome_len = 1_000_000, 930, 8000
    stamp = os.path.join(PAPER_DIR,
                         f"v1_{num_pairs}_{num_genomes}_{genome_len}.ok")
    if not os.path.exists(stamp):
        _log(f"bench[paper]: building dataset ({num_pairs} pairs x "
             f"{num_genomes} genomes; several minutes, cached)...")
        t0 = time.time()
        make_big_dataset(PAPER_DIR, num_pairs=num_pairs,
                         num_genomes=num_genomes, genome_len=genome_len,
                         seed=17)
        with open(stamp, "w") as f:
            f.write("ok")
        _log(f"bench[paper]: dataset built in {time.time() - t0:.0f}s")
    return BigDataset(
        root=PAPER_DIR,
        collections=[os.path.join(PAPER_DIR, f"col_{t}.fasta")
                     for t in ("1F", "1RC", "2F", "2RC")],
        lineage_path=os.path.join(PAPER_DIR, "LineageFile.csv"),
        num_reads=num_pairs, num_genomes=num_genomes, read_len=100,
        positions_per_collection=0)


def _measure_link_bandwidth():
    """Sustained h2d/d2h GB/s of the host<->device link (64MB random).

    h2d is measured as a dependent roundtrip: fetching a value computed
    FROM the uploaded data observes actual delivery (the 16-byte result
    fetch is negligible against 64MB).
    """
    import jax

    a = np.random.default_rng(0).integers(0, 255, 64 << 20, dtype=np.uint8)
    # run the exact pattern once untimed first: the gather program's
    # one-time compile must not sit inside the timed window
    # (shape-specific, so same-shape warm-up)
    np.asarray(jax.device_put(a)[:: 4 << 20][:16])
    t0 = time.time()
    d = jax.device_put(a)
    np.asarray(d[:: 4 << 20][:16])
    h2d = a.nbytes / 1e9 / (time.time() - t0)
    t0 = time.time()
    np.asarray(d)
    d2h = a.nbytes / 1e9 / (time.time() - t0)
    return round(h2d, 3), round(d2h, 3)


def _run_ours(ds, config, tag):
    from lime_tpu.pipeline import run_paired
    from lime_tpu.utils.memory import MemoryProfiler
    from lime_tpu.utils.timing import LAST_RUN

    out = os.path.join(ds.root, f"bench_ours_{tag}.csv")
    t0 = time.time()
    with MemoryProfiler(interval=0.5) as prof:
        run_paired(ds.collections, out, ds.num_reads, ds.num_genomes,
                   ds.lineage_path, ds.read_len, config)
    dt = time.time() - t0
    prof.write_csv(os.path.join(ROOT, "build", f"memprofile_{tag}.csv"))
    _log(f"bench[{tag}]: {dt:.2f}s | {prof.report()}")
    return dt, dict(LAST_RUN)


def _run_host(ds, tag) -> float:
    from lime_tpu.config import LimeConfig
    from lime_tpu.pipeline import run_paired

    t0 = time.time()
    run_paired(ds.collections, os.path.join(ds.root, f"bench_host_{tag}.csv"),
               ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len,
               LimeConfig(executor="host"))
    return time.time() - t0


def _check_outputs(ds, tag) -> None:
    with open(os.path.join(ds.root, f"bench_ours_{tag}.csv")) as f:
        ours = f.read()
    with open(os.path.join(ds.root, f"bench_host_{tag}.csv")) as f:
        ref = f.read()
    if ours != ref:
        _log(f"bench[{tag}]: FATAL — output mismatch vs the host executor!")
        sys.exit(1)
    _log(f"bench[{tag}]: outputs bit-identical to the host executor")


def _bench_config(ds, config, tag, host_runs, ours_runs):
    host_t = _run_host(ds, tag)
    for _ in range(host_runs - 1):
        host_t = min(host_t, _run_host(ds, tag))
    times = []
    phases_best = {}
    _run_ours(ds, config, tag)  # warm-up: compiles (cached across runs)
    for _ in range(ours_runs):
        dt, phases = _run_ours(ds, config, tag)
        times.append(dt)
        if dt == min(times):
            phases_best = phases
    _check_outputs(ds, tag)
    best = min(times)
    med = statistics.median(times)
    unstable = max(times) / best > 2.0
    if unstable:
        _log(f"bench[{tag}]: UNSTABLE — wall clock varies "
             f"{max(times) / best:.1f}x across {len(times)} runs "
             f"({[round(t, 1) for t in times]}) (recorded in JSON, see "
             "'runs_s')")
    index_gb = sum(os.path.getsize(c + ext) for c in ds.collections
                   for ext in (".lcp", ".da", ".ebwt")) / 1e9
    res = {
        "reads_per_s": round(ds.num_reads / med, 1),
        "reads_per_s_best": round(ds.num_reads / best, 1),
        "host_reads_per_s": round(ds.num_reads / host_t, 1),
        "speedup": round(host_t / med, 2),
        "speedup_best": round(host_t / best, 2),
        "ours_s_median": round(med, 2),
        "ours_s_min": round(best, 2),
        "ours_s_max": round(max(times), 2),
        "runs_s": [round(t, 2) for t in times],
        "unstable": unstable,
        "host_s": round(host_t, 2),
        "index_stream_GBps": round(index_gb / med, 2),
        "phases_best_run": phases_best.get("phases", {}),
        "num_reads": ds.num_reads,
        "num_genomes": ds.num_genomes,
    }
    _log(f"bench[{tag}]: host {host_t:.2f}s | ours median {med:.2f}s "
         f"min {best:.2f}s | {res['speedup']}x (best {res['speedup_best']}x)"
         f" | {res['reads_per_s']:.0f} reads/s")
    return res


def main() -> None:
    import jax

    from lime_tpu.config import LimeConfig
    from lime_tpu.utils.compile_cache import configure_compile_cache
    from lime_tpu.utils.memory import memory_report

    configure_compile_cache()
    ds_small = _example_dataset()
    ds_paper = _paper_dataset()
    backend = jax.default_backend()
    device_kind = jax.devices()[0].device_kind
    _log(f"bench: backend={backend} device_kind={device_kind}")
    h2d, d2h = _measure_link_bandwidth()
    _log(f"bench: link bandwidth h2d={h2d} GB/s d2h={d2h} GB/s")

    config = LimeConfig(executor="tpu", fused=True, threads=2)
    example = _bench_config(ds_small, config, "example", host_runs=2,
                            ours_runs=3)
    paper = _bench_config(ds_paper, config, "paper", host_runs=1,
                          ours_runs=3)

    # accuracy vs planted ground truth (the reference evaluates accuracy
    # only in its papers; here it's part of the bench)
    from lime_tpu.utils.evaluate import evaluate
    from tests.synth_big import compute_truth

    truth_arr = compute_truth(PAPER_DIR, ds_paper.num_reads,
                              ds_paper.num_genomes, 8000)
    truth = {i: (None if g < 0 else 1000 + int(g))
             for i, g in enumerate(truth_arr)}
    acc = evaluate(os.path.join(PAPER_DIR, "bench_ours_paper.csv"), truth)
    _log(f"bench[paper]: accuracy {acc.summary()}")
    paper["accuracy"] = {
        "sensitivity": round(acc.sensitivity, 4),
        "precision": round(acc.precision, 4),
        "f1": round(acc.f1, 4),
    }
    mem = memory_report().replace("\n", "; ")
    _log(f"bench: memory {mem}")

    print(json.dumps({
        "metric": "paper_scale_classification_throughput",
        "value": paper["reads_per_s"],
        "unit": "reads/s",
        "vs_baseline": paper["speedup"],
        "backend": backend,
        "device_kind": device_kind,
        "device_count": len(jax.devices()),
        "link_h2d_GBps": h2d,
        "link_d2h_GBps": d2h,
        "example": example,
        "paper": paper,
        "memory": mem,
    }))


if __name__ == "__main__":
    main()
