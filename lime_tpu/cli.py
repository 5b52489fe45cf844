"""Command-line interface.

One ``lime-tpu`` entry with subcommands covering every reference executable
and driver script:

- ``cluster-lcp``   ~ ClusterLCP        (args per README.md:87-92)
- ``cluster-bwt``   ~ ClusterBWT_DA     (README.md:94-99)
- ``classify``      ~ Classify          (README.md:101-105)
- ``run-paired``    ~ LiME_paired.sh    (README.md:120-124)
- ``run-single``    ~ the 2-file variant
- ``preprocess``    ~ Preprocessing.sh + Install_tools_preprocessing.sh
  (builds the four collection indexes directly from FASTA — no external
  BCR/egsa/eGap needed)
- ``gesa-convert``  ~ EGSAtoBCR
- ``create-docs``   ~ create_docs
- ``filter-fasta``  ~ Datasets/filter_by_headers.pl

The reference's compile-time flags become CLI options (--no-ebwt, --text,
--higher, --wide-sim, --executor).
"""

from __future__ import annotations

import argparse
import logging
import sys

from .config import LimeConfig


def _config_from(args) -> LimeConfig:
    return LimeConfig(
        alpha=getattr(args, "alpha", 16),
        beta=getattr(args, "beta", 0.25),
        tax_rank=getattr(args, "tax_rank", 1),
        use_ebwt=not getattr(args, "no_ebwt", False),
        assign_higher=getattr(args, "higher", False),
        binary_results=not getattr(args, "text", False),
        wide_sim=getattr(args, "wide_sim", False),
        executor=getattr(args, "executor", "tpu"),
        threads=getattr(args, "threads", 1),
        fused=getattr(args, "fused", False),
        dense_threshold=getattr(args, "dense_threshold", None),
        mxu_dense_min=getattr(args, "mxu_dense_min", None),
        host_frac=getattr(args, "host_frac", None),
    )


def _add_common(p: argparse.ArgumentParser, scoring: bool = False,
                classify: bool = False) -> None:
    p.add_argument("--executor", choices=["tpu", "host"], default="tpu")
    if scoring:
        p.add_argument("--no-ebwt", action="store_true",
                       help="document-only scoring (reference EBWT=0)")
        p.add_argument("--text", action="store_true",
                       help="write .res.txt instead of .res.bin/.pos "
                            "(reference BIN=0)")
        p.add_argument("--wide-sim", action="store_true",
                       help="u32 similarity counters for reads > 255bp "
                            "(reference dataTypeNumSim=1)")
    if classify:
        p.add_argument("--higher", action="store_true",
                       help="ascend lineage on ambiguity (reference HIGHER=1)")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s %(message)s")
    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    ap = argparse.ArgumentParser(prog="lime-tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("cluster-lcp", help="step 1: detect alpha-clusters")
    p.add_argument("fasta")
    p.add_argument("num_reads", type=int)
    p.add_argument("num_genomes", type=int)
    p.add_argument("alpha", type=int, nargs="?", default=16)
    p.add_argument("threads", type=int, nargs="?", default=1)
    _add_common(p)

    p = sub.add_parser("cluster-bwt", help="step 2: score clusters")
    p.add_argument("fasta")
    p.add_argument("read_len", type=int)
    p.add_argument("beta", type=float, nargs="?", default=0.25)
    p.add_argument("threads", type=int, nargs="?", default=1)
    _add_common(p, scoring=True)

    p = sub.add_parser("classify", help="step 3: assign reads to taxa")
    p.add_argument("num_files", type=int, choices=[2, 4])
    p.add_argument("res_and_rest", nargs="+",
                   help="res1..resN numReads numGenomes out lineage "
                        "taxRank threads")
    _add_common(p, classify=True)
    p.add_argument("--text", action="store_true")

    for name in ("run-paired", "run-single", "run-sharded"):
        p = sub.add_parser(
            name, help=("end-to-end SPMD pipeline over a device mesh"
                        if name == "run-sharded"
                        else f"end-to-end {name[4:]} pipeline"))
        n = 2 if name == "run-single" else 4
        p.add_argument("collections", nargs=n,
                       help="1F 1RC 2F 2RC" if n == 4 else "F RC")
        p.add_argument("output")
        p.add_argument("num_reads", type=int)
        p.add_argument("num_genomes", type=int)
        p.add_argument("lineage")
        p.add_argument("read_len", type=int)
        p.add_argument("threads", type=int, nargs="?", default=1)
        p.add_argument("--alpha", type=int, default=16)
        p.add_argument("--beta", type=float, default=0.25)
        p.add_argument("--tax-rank", type=int, default=1)
        p.add_argument("--keep-results", action="store_true")
        p.add_argument("--fused", action="store_true",
                       help="one-dispatch serving path (no .clrs/.res "
                            "artifacts)")
        p.add_argument("--dense-threshold", type=int, default=None,
                       help="genome-position density for banded routing "
                            "(default: auto)")
        p.add_argument("--mxu-dense-min", type=int, default=None,
                       help="genome-position threshold for the dense "
                            "histogram-matmul path (default: auto)")
        p.add_argument("--host-frac", type=float, default=None,
                       help="hybrid split: fraction of clusters scored "
                            "by the host SIMD engine (default: auto "
                            "from measured link bandwidth)")
        p.add_argument("--hbm-budget", type=int, default=None,
                       help="device-memory budget in bytes for the similarity "
                            "stack; smaller budgets force the "
                            "row-blocked beyond-HBM mode")
        if name == "run-sharded":
            p.add_argument("--devices", type=int, default=None,
                           help="mesh size (default: all visible devices)")
            p.add_argument("--engine", choices=["pair", "banded"],
                           default="pair",
                           help="SPMD engine: dp-sliced pair streams "
                                "(default) or the banded one-hot kernel")
            p.add_argument("--mesh", default=None, metavar="SPxDP",
                           help="explicit mesh shape, e.g. 2x4")
        _add_common(p, scoring=True, classify=True)

    p = sub.add_parser("preprocess",
                       help="build the collection indexes from FASTA")
    p.add_argument("reads1")
    p.add_argument("genomes")
    p.add_argument("--reads2", default=None,
                   help="mate file (paired-end; omit for single-end)")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--trlcp", type=int, default=None,
                   help="truncate stored LCP values (safe if >= alpha)")

    p = sub.add_parser("gesa-convert", help="split .gesa into .ebwt/.lcp/.da")
    p.add_argument("fasta")
    p.add_argument("num_seqs", type=int)

    p = sub.add_parser("create-docs", help="write <fasta>.docs")
    p.add_argument("fasta")
    p.add_argument("num_seqs", type=int)

    p = sub.add_parser("filter-fasta",
                       help="order-preserving filter by a list of titles")
    p.add_argument("titles")
    p.add_argument("src")
    p.add_argument("dst")

    args = ap.parse_args(argv)
    return _dispatch(args)


def _dispatch(args) -> int:
    if getattr(args, "hbm_budget", None) is not None:
        # smaller budgets force the row-blocked beyond-HBM mode
        import os

        os.environ["LIME_HBM_BUDGET"] = str(args.hbm_budget)

    if args.cmd == "cluster-lcp":
        from .pipeline import cluster_lcp
        cfg = _config_from(args).replace(alpha=args.alpha)
        meta = cluster_lcp(args.fasta, args.num_reads, args.num_genomes, cfg)
        print(f"Clustering process with alpha={cfg.alpha} completed.\n"
              f"Total number of clusters: {meta.n_clusters}.\n"
              f"Maximum cluster size: {meta.max_len}.")
        return 0

    if args.cmd == "cluster-bwt":
        from .pipeline import cluster_bwt
        cfg = _config_from(args).replace(beta=args.beta)
        cluster_bwt(args.fasta, args.read_len, cfg)
        print(f"Cluster analysis completed with beta={cfg.beta}.")
        return 0

    if args.cmd == "classify":
        from .pipeline import classify
        rest = args.res_and_rest
        n = args.num_files
        if len(rest) not in (n + 5, n + 6):  # threads arg is optional
            raise SystemExit("usage: classify N res1..resN numReads "
                             "numGenomes out lineage taxRank [threads]")
        res = rest[:n]
        num_reads, num_genomes = int(rest[n]), int(rest[n + 1])
        out, lineage, tax_rank = rest[n + 2], rest[n + 3], int(rest[n + 4])
        cfg = _config_from(args).replace(tax_rank=tax_rank)
        s = classify(res, num_reads, num_genomes, out, lineage, cfg)
        print(f"Classification process at level {tax_rank} completed.\n"
              f"Number of successfully classified reads: "
              f"{s.classified}/{s.num_reads};\n"
              f"\tClassified at higher taxonomic ranks: {s.higher}.\n"
              f"\tAmbiguously classified reads: {s.ambiguous}.\n"
              f"\tNot classified reads: {s.unclassified}.")
        return 0

    if args.cmd in ("run-paired", "run-single"):
        from .pipeline import run_paired, run_single
        cfg = _config_from(args).replace(
            alpha=args.alpha, beta=args.beta, tax_rank=args.tax_rank)
        fn = run_paired if args.cmd == "run-paired" else run_single
        s = fn(args.collections, args.output, args.num_reads,
               args.num_genomes, args.lineage, args.read_len, cfg,
               keep_results=args.keep_results)
        print(f"C={s.classified} H={s.higher} A={s.ambiguous} "
              f"U={s.unclassified} / {s.num_reads}")
        return 0

    if args.cmd == "run-sharded":
        from . import native
        from .parallel import make_mesh, run_sharded
        from .parallel.multihost import init_distributed
        from .parallel.sharded import run_sharded_pairs

        init_distributed()
        cfg = _config_from(args).replace(
            alpha=args.alpha, beta=args.beta, tax_rank=args.tax_rank)
        shape = None
        if args.mesh:
            sp_s, dp_s = args.mesh.lower().split("x")
            shape = (int(sp_s), int(dp_s))
            mesh = make_mesh(shape[0] * shape[1], shape=shape)
        else:
            mesh = make_mesh(args.devices)
        engine = args.engine
        if engine == "pair" and not native.available():
            print("warning: native runtime unavailable — falling back "
                  "to the banded SPMD engine", file=sys.stderr)
            engine = "banded"
        runner = run_sharded_pairs if engine == "pair" else run_sharded
        res = runner(args.collections, args.output, args.num_reads,
                     args.num_genomes, args.lineage, args.read_len,
                     cfg, mesh=mesh)
        c = res.counts()
        print(f"mesh {dict(mesh.shape)}: C={c['C']} H={c['H']} "
              f"A={c['A']} U={c['U']} / {args.num_reads}")
        return 0

    if args.cmd == "preprocess":
        from .preprocessing import preprocess
        paths = preprocess(args.reads1, args.reads2, args.genomes,
                           args.out_dir, max_lcp=args.trlcp)
        for pth in paths:
            print(pth)
        return 0

    if args.cmd == "gesa-convert":
        from .formats.gesa import convert_gesa
        n = convert_gesa(args.fasta, args.num_seqs)
        print(f"The total number of elements is {n}")
        return 0

    if args.cmd == "create-docs":
        from .formats.arrays import write_docs
        write_docs(args.fasta, args.num_seqs)
        print(f"file docs: {args.fasta}.docs.")
        return 0

    if args.cmd == "filter-fasta":
        from .utils.filter_fasta import filter_fasta_by_titles
        n = filter_fasta_by_titles(args.titles, args.src, args.dst)
        print(f"kept {n} sequences")
        return 0

    raise SystemExit(f"unknown command {args.cmd}")


if __name__ == "__main__":
    sys.exit(main())
