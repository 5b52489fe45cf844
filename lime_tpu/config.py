"""Runtime configuration for lime-tpu.

The reference selects its behavior with compile-time ``-D`` defines
(reference Makefile:9-14: M64/OMP/DEBUG/BIN/EBWT/HIGHER) plus typedef knobs in
src/Tools.h:43-75.  lime-tpu replaces all of that with one runtime dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .constants import DT_SIM_U8, DT_SIM_U32


@dataclasses.dataclass(frozen=True)
class LimeConfig:
    """Configuration shared by all pipeline stages.

    Parameters mirror the reference's knobs:

    - ``alpha``: minimum common-context length for a cluster
      (reference LiME_paired.sh:10, default 16).
    - ``beta``: minimum normalized similarity to report a read
      (reference LiME_paired.sh:11, default 0.25).
    - ``tax_rank``: 0=Genome .. 6=Phylum (reference LiME_paired.sh:12 /
      src/Classify.cpp:357-359, default 1=Species).
    - ``use_ebwt``: EBWT=1 symbol-aware scoring vs EBWT=0 document-count
      scoring (reference Makefile:13, src/ClusterBWT_DA.cpp:80-252).
    - ``assign_higher``: HIGHER=1 lineage ascent on ambiguity
      (reference Makefile:14, src/Classify.cpp:262-302).
    - ``binary_results``: BIN=1 .res.bin/.res.pos vs BIN=0 .res.txt
      (reference Makefile:12, src/ClusterBWT_DA.cpp:360-450).
    - ``wide_sim``: dataTypeNumSim=1 — u32 similarity counters for reads
      longer than 255bp (reference src/Tools.h:51-75).  With the default u8
      counters the similarity matrix accumulates mod 256, faithfully
      reproducing the reference's unsaturated uchar addition
      (src/ClusterBWT_DA.cpp:183).
    - ``executor``: 'tpu' runs the jax device path, 'host' the numpy
      reference path (used for validation and as the portable fallback).
    """

    alpha: int = 16
    beta: float = 0.25
    tax_rank: int = 1
    use_ebwt: bool = True
    assign_higher: bool = False
    binary_results: bool = True
    wide_sim: bool = False
    executor: str = "tpu"
    fused: bool = False  # one-dispatch serving path: no .clrs/.res artifacts
    threads: int = 1  # host-side worker threads for IO-bound stages
    block_positions: int = 1 << 22  # streaming block size for the device pass
    error_tolerance: float = 0.02  # classify tie tolerance (Tools.h:37)
    # Density routing: clusters with at least this many genome positions run
    # on the device banded kernel; sparser ones go to the native SIMD scorer
    # (the one-hot kernel pays window * G_pad lanes per position regardless
    # of hits, so it only wins when many genome lanes actually hit).
    # None = auto: 0 (everything banded) while G_pad <= 128, else G_pad // 16.
    dense_threshold: Optional[int] = None
    # Dense histogram-matmul routing (large-G regime): pure-ACGT clusters with
    # at least this many genome positions score on the tensor cores as batched
    # indicator-feature matmuls (ops/dense_score.py) instead of the host
    # scorer.  None = auto: disabled while the banded kernel covers the
    # genome width (G_pad <= 256), else 16.  0 disables.
    mxu_dense_min: Optional[int] = None
    # Pair-stream scoring (ops/pair_score.py): the G-independent device
    # path — sparse clusters score on device at any genome count, dense
    # ones on the tensor cores.  None = auto: on whenever the native planner is
    # available and the flat scatter range fits int32; False forces the
    # legacy banded/density routing.
    pair_stream: Optional[bool] = None
    # Hybrid host/device split: the fraction of clusters scored by the
    # host SIMD scorer (uplinked as delta-COO nonzeros) instead of the
    # device stream.  None = auto: pick from the measured host<->device
    # link bandwidth (0 on a healthy PCIe-class link; most-to-all host
    # on a degraded link, where shipping pre-aggregated nonzeros beats
    # shipping positions).  Any split is byte-identical: scatter-adds
    # commute and both engines implement the reference's exact counter
    # semantics.  Overridable with env LIME_HOST_FRAC.
    host_frac: Optional[float] = None

    def __post_init__(self) -> None:
        if self.executor not in ("tpu", "host"):
            raise ValueError(f"executor must be 'tpu' or 'host', got {self.executor!r}")
        if not 0 <= self.tax_rank <= 6:
            raise ValueError("tax_rank must be in 0..6 "
                             "(0=Genome, 1=Species, ..., 6=Phylum)")
        if self.alpha <= 0:
            raise ValueError("alpha must be positive")
        if self.host_frac is not None and not 0.0 <= self.host_frac <= 1.0:
            raise ValueError("host_frac must be in [0, 1]")

    @property
    def sim_dtype(self) -> np.dtype:
        return DT_SIM_U32 if self.wide_sim else DT_SIM_U8

    @property
    def sim_modulus(self) -> Optional[int]:
        """Accumulation modulus reproducing the reference counter width."""
        return None if self.wide_sim else 256

    def replace(self, **kw) -> "LimeConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = LimeConfig()
