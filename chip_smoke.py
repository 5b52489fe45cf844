"""Smoke run of the fused classifier on one NVIDIA GPU.

    python chip_smoke.py [--seed N] [--trace DIR]
    python chip_smoke.py --four          # needs four GPUs in one host

Refuses to run on anything but a GPU.  Data is synthesized from ``--seed``
by the repository's generators (``tests/synth.py``, ``tests/synth_big.py``)
under ``build/chip_smoke/`` and reused when present.  Everything runs in
this one process: the host reference dispatches nothing to the card, and a
second JAX process would find the card's memory taken.

Phases (one card):

1. environment: card, JAX devices, device memory, compile cache, native
   library;
2. the main path at the reference database's width — 1,000,000 read pairs
   x 930 genomes x 100 bp through ``run_paired(..., LimeConfig(fused=True,
   pair_stream=True, host_frac=0.0))``, cold then warm, byte-compared with
   ``executor="host"``;
3. the same data through the CLI with ``--hbm-budget`` small enough to
   force several row blocks, byte-compared with the host CSV;
4. the staged CLI entry point (``lime-tpu run-paired`` without
   ``--fused``) on 50,000 pairs x 6 genomes, byte-compared with the host
   CSV;
5. every pair-hits form at bucket caps 16/64/255 on 32M-position
   planner-shaped streams: exact against ``pair_hits_host`` on read-side
   rows, then timed with a dependent device-to-host fetch.

``--four`` runs only the dp-sliced SPMD pair engine on four cards, as
(2, 2) and (1, 4) meshes, byte-compared with the host CSV of the phase-2
data.  ``--trace DIR`` also writes a profiler trace of a third phase-2 run
to DIR and prints each program's share of device time.

Any failed comparison raises.  The last line of standard output is one
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_ROOT = os.path.join(ROOT, "build", "chip_smoke")

PAPER = dict(num_pairs=1_000_000, num_genomes=930, genome_len=8000)
EXAMPLE = dict(num_pairs=50_000,
               genome_lens=(250_000, 220_000, 200_000, 180_000, 160_000,
                            140_000))
KERNEL_POSITIONS = 32 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def _cached(stamp_dir: str, build):
    """Run ``build(stamp_dir)`` unless a previous run finished it."""
    stamp = os.path.join(stamp_dir, "complete")
    if not os.path.exists(stamp):
        os.makedirs(stamp_dir, exist_ok=True)
        t0 = time.perf_counter()
        build(stamp_dir)
        log(f"  dataset built in {time.perf_counter() - t0:.1f} s: "
            f"{stamp_dir}")
        with open(stamp, "w") as f:
            f.write("ok\n")


def paper_dataset(seed: int, num_pairs: int, num_genomes: int,
                  genome_len: int, root: str = DATA_ROOT):
    from tests.synth_big import BigDataset, make_big_dataset

    d = os.path.join(root, f"paper_{num_pairs}x{num_genomes}x"
                           f"{genome_len}_s{seed}")
    _cached(d, lambda p: make_big_dataset(
        p, num_pairs=num_pairs, num_genomes=num_genomes,
        genome_len=genome_len, seed=seed))
    return BigDataset(
        root=d, collections=[os.path.join(d, f"col_{t}.fasta")
                             for t in ("1F", "1RC", "2F", "2RC")],
        lineage_path=os.path.join(d, "LineageFile.csv"),
        num_reads=num_pairs, num_genomes=num_genomes, read_len=100,
        positions_per_collection=0)


def example_dataset(seed: int, num_pairs: int, genome_lens,
                    root: str = DATA_ROOT):
    from tests.synth import SynthDataset, make_dataset

    d = os.path.join(root, f"example_{num_pairs}x{len(genome_lens)}"
                           f"_s{seed}")
    _cached(d, lambda p: make_dataset(p, num_pairs=num_pairs, read_len=100,
                                      genome_lens=genome_lens, seed=seed))
    return SynthDataset(
        root=d, collections=[os.path.join(d, f"col_{t}.fasta")
                             for t in ("1F", "1RC", "2F", "2RC")],
        lineage_path=os.path.join(d, "LineageFile.csv"),
        num_reads=num_pairs, num_genomes=len(genome_lens), read_len=100,
        genomes=[], reads1=[], reads2=[])


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _same_csv(got: str, want: str, what: str) -> None:
    a, b = _read(got), _read(want)
    if a != b:
        la, lb = a.splitlines(), b.splitlines()
        diff = sum(x != y for x, y in zip(la, lb)) + abs(len(la) - len(lb))
        raise AssertionError(f"{what}: CSV differs from the host executor "
                             f"on {diff} of {len(lb)} lines")
    log(f"  {what}: byte-identical to executor=host "
        f"({len(b.splitlines()) - 1} reads)")


def host_reference(ds, tag: str) -> str:
    """CSV of the staged host executor (dispatches nothing to a device)."""
    from lime_tpu.config import LimeConfig
    from lime_tpu.pipeline import run_paired

    out = os.path.join(ds.root, f"host_{tag}.csv")
    t0 = time.perf_counter()
    run_paired(ds.collections, out, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len,
               LimeConfig(executor="host", threads=os.cpu_count() or 1))
    log(f"  host reference ({tag}): {time.perf_counter() - t0:.2f} s")
    return out


def _device_memory_stats() -> dict:
    import jax

    return jax.devices()[0].memory_stats() or {}


def phase_environment() -> str:
    import jax

    from lime_tpu import native
    from lime_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    name = card()
    dev = jax.devices()[0]
    stats = _device_memory_stats()
    log(f"phase 1 environment: card {name}")
    log(f"  jax {jax.__version__} devices {jax.devices()}")
    log(f"  device_kind {dev.device_kind!r} bytes_limit "
        f"{stats.get('bytes_limit')}")
    log(f"  compile cache {cache}")
    log(f"  native library available: {native.available()}")
    if not native.available():
        raise RuntimeError(f"native library did not build: "
                           f"{native.load_error()}")
    return name


def _fused_config():
    from lime_tpu.config import LimeConfig

    return LimeConfig(fused=True, pair_stream=True, host_frac=0.0)


def phase_main_path(ds, host_csv: str, name: str,
                    trace_dir: str | None = None) -> dict:
    """Phase 2: cold and warm fused runs, each byte-compared."""
    from lime_tpu.pipeline import run_paired
    from lime_tpu.utils.timing import LAST_RUN

    log(f"phase 2 main path: {ds.num_reads} pairs x {ds.num_genomes} "
        f"genomes x {ds.read_len} bp")
    times = {}
    for run in ("cold", "warm"):
        out = os.path.join(ds.root, f"fused_{run}.csv")
        t0 = time.perf_counter()
        run_paired(ds.collections, out, ds.num_reads, ds.num_genomes,
                   ds.lineage_path, ds.read_len, _fused_config())
        times[run] = time.perf_counter() - t0
        log(f"  {run} wall {times[run]:.3f} s on {name}")
        log(f"  {run} phases {json.dumps(LAST_RUN.get('phases', {}))}")
        _same_csv(out, host_csv, f"fused {run}")
    stats = _device_memory_stats()
    log(f"  peak bytes_in_use {stats.get('peak_bytes_in_use')} "
        f"(bytes_in_use {stats.get('bytes_in_use')}) on {name}")
    if trace_dir:
        os.environ["LIME_PROFILE_DIR"] = trace_dir
        try:
            out = os.path.join(ds.root, "fused_traced.csv")
            run_paired(ds.collections, out, ds.num_reads, ds.num_genomes,
                       ds.lineage_path, ds.read_len, _fused_config())
        finally:
            del os.environ["LIME_PROFILE_DIR"]
        _same_csv(out, host_csv, "fused traced")
        log(f"  trace shares {json.dumps(trace_shares(trace_dir))}")
    return times


def row_block_budget(num_reads: int, num_genomes: int, n_blocks: int):
    """``--hbm-budget`` bytes that split the stack into ``n_blocks`` row
    blocks (the row-blocked runner's own sizing rule)."""
    from lime_tpu.ops import fused_pipeline as fp

    block = fp._classify_block_for(num_reads)
    # four collections x g_pad int8 counters x 2 (stack + slack)
    bytes_per_row = 4 * fp._g_pad_for(num_genomes) * 2
    rows = -(-(num_reads + 1) // n_blocks)
    rows = -(-rows // block) * block
    return rows * bytes_per_row, -(-(num_reads + 1) // rows)


def _cli(argv) -> None:
    """One ``lime-tpu`` CLI call in this process; the budget it sets in
    the environment does not outlive the call."""
    from lime_tpu import cli

    try:
        rc = cli.main(argv)
    finally:
        os.environ.pop("LIME_HBM_BUDGET", None)
    if rc != 0:
        raise RuntimeError(f"lime-tpu {' '.join(argv)} returned {rc}")


def phase_row_blocked(ds, host_csv: str, n_blocks: int = 4) -> None:
    from lime_tpu.utils.timing import LAST_RUN

    budget, blocks = row_block_budget(ds.num_reads, ds.num_genomes,
                                      n_blocks)
    log(f"phase 3 row-blocked runner: --hbm-budget {budget} "
        f"({blocks} row blocks)")
    if blocks < 2:
        raise AssertionError("budget does not force several row blocks")
    out = os.path.join(ds.root, "fused_blocked.csv")
    t0 = time.perf_counter()
    _cli(["run-paired", *ds.collections, out, str(ds.num_reads),
          str(ds.num_genomes), ds.lineage_path, str(ds.read_len),
          "--fused", "--host-frac", "0", "--hbm-budget", str(budget)])
    if "block_classify" not in LAST_RUN.get("phases", {}):
        raise AssertionError("the row-blocked runner did not run")
    log(f"  wall {time.perf_counter() - t0:.3f} s, phases "
        f"{json.dumps(LAST_RUN['phases'])}")
    _same_csv(out, host_csv, "row-blocked")


def phase_staged(ds) -> None:
    log(f"phase 4 staged entry point: {ds.num_reads} pairs x "
        f"{ds.num_genomes} genomes (run-paired, executor=tpu)")
    host_csv = host_reference(ds, "example")
    out = os.path.join(ds.root, "staged.csv")
    t0 = time.perf_counter()
    _cli(["run-paired", *ds.collections, out, str(ds.num_reads),
          str(ds.num_genomes), ds.lineage_path, str(ds.read_len)])
    log(f"  wall {time.perf_counter() - t0:.3f} s")
    _same_csv(out, host_csv, "staged")


def _pair_hits_fn(form: str, cap: int):
    """Jitted decode + pair-hits over u32 row codes, as production runs
    it inside a chunk program."""
    import jax
    import jax.numpy as jnp

    from lime_tpu.ops.pair_score import _pair_hits_core, _pair_hits_scan

    def f(bits, window):
        if form == "scan":
            return _pair_hits_scan(bits, cap)
        sym = (bits & 3).astype(jnp.int8)
        m = ((bits >> 2) & 1).astype(bool)
        dr = ((bits >> 3) & 1).astype(bool)
        gs = ((bits >> 4) & 1).astype(bool)
        return _pair_hits_core(m, dr, gs, sym, window)

    return jax.jit(f)


def phase_kernels(name: str, n: int = KERNEL_POSITIONS,
                  caps=(16, 64, 255), reps: int = 20,
                  unit: int = 1 << 20) -> list:
    """Phase 5: each pair-hits form per bucket cap, exact then timed."""
    import jax
    import jax.numpy as jnp

    from lime_tpu.ops.pair_score import (SCAN_MAX_CAP, codes_to_packed,
                                         pair_hits_host,
                                         planner_shaped_stream)

    log(f"phase 5 pair-hits forms: {n} positions per stream on {name}")
    rows = []
    for cap in caps:
        rng = np.random.default_rng(cap)
        codes = np.tile(planner_shaped_stream(rng, unit, cap), n // unit)
        want = pair_hits_host(codes_to_packed(codes))
        read_side = ((codes >> 4) & 1) == 0
        bits = jax.device_put(codes.astype(np.uint32))
        window = jnp.int32(cap)
        forms = ["scan", "core"] if cap <= SCAN_MAX_CAP else ["core"]
        for form in forms:
            fn = _pair_hits_fn(form, cap)
            out = fn(bits, window)
            got = np.asarray(out)
            if not np.array_equal(got[read_side], want[read_side]):
                bad = int((got[read_side] != want[read_side]).sum())
                raise AssertionError(f"pair hits {form} cap {cap}: {bad} "
                                     "read-side rows differ")
            np.asarray(out[-8:])  # compile the fetch outside the timing
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(bits, window)
            np.asarray(out[-8:])
            ms = (time.perf_counter() - t0) / reps * 1e3
            rows.append({"cap": cap, "form": form, "ms": ms,
                         "Gpos_per_s": n / ms / 1e6})
            log(f"  cap {cap:3d} {form:4s}: exact, {ms:.3f} ms per call "
                f"({n / ms / 1e6:.2f} Gpos/s) on {name}")
    return rows


def trace_shares(trace_dir: str) -> dict:
    """Device time per XLA program and the pair-hits share, from the
    newest profiler trace under ``trace_dir``.

    Kernels are the events on the GPU plane's compute streams; each
    names its program (``hlo_module``) and its op path (``name``, which
    carries the ``pair_hits`` named scope of ``ops/pair_score``).
    """
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    modules = {}
    pair_hits_ns = 0
    spans = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Compute" not in line.name:
                continue
            for ev in line.events:
                stats = {k: str(v) for k, v in ev.stats}
                dur = ev.duration_ns
                mod = stats.get("hlo_module", "?")
                modules[mod] = modules.get(mod, 0) + dur
                if "pair_hits" in stats.get("name", ""):
                    pair_hits_ns += dur
                spans.append((ev.start_ns, ev.start_ns + dur))
    busy = 0
    end = None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in spans) - min(s for s, _ in spans)
              if spans else 0)
    kernel_ns = sum(modules.values())
    return {
        "device_busy_s": busy / 1e9,
        "device_window_s": window / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "pair_hits_s": pair_hits_ns / 1e9,
        "pair_hits_share_of_kernel_time": (pair_hits_ns / kernel_ns
                                           if kernel_ns else 0.0),
        "module_s": {k: v / 1e9 for k, v in sorted(
            modules.items(), key=lambda kv: -kv[1])[:8]},
    }


def phase_four(ds, host_csv: str, name: str) -> None:
    """dp-sliced SPMD pair engine on four devices, two mesh shapes."""
    import jax

    from lime_tpu.parallel import make_mesh
    from lime_tpu.parallel.sharded import run_sharded_pairs

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, JAX sees "
                           f"{len(jax.devices())}")
    for shape in ((2, 2), (1, 4)):
        out = os.path.join(ds.root, f"sharded_{shape[0]}x{shape[1]}.csv")
        t0 = time.perf_counter()
        run_sharded_pairs(ds.collections, out, ds.num_reads,
                          ds.num_genomes, ds.lineage_path, ds.read_len,
                          mesh=make_mesh(4, shape=shape))
        log(f"  mesh {shape}: wall {time.perf_counter() - t0:.3f} s on "
            f"4 x {name}")
        _same_csv(out, host_csv, f"run_sharded_pairs mesh {shape}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--four", action="store_true",
                    help="only the four-card dp-sliced SPMD phase")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="also trace a phase-2 run into DIR")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {jax.devices()}",
              file=sys.stderr)
        return 2

    name = phase_environment()
    paper = paper_dataset(args.seed, **PAPER)
    host_csv = host_reference(paper, "paper")
    if args.four:
        log("phase 6 four-card SPMD pair engine")
        phase_four(paper, host_csv, name)
    else:
        phase_main_path(paper, host_csv, name, args.trace)
        phase_row_blocked(paper, host_csv)
        phase_staged(example_dataset(args.seed, **EXAMPLE))
        phase_kernels(name)
    dev = jax.devices()[0]
    log(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
