"""Per-phase wall-clock timing.

Replacement for the reference's per-thread omp_get_wtime prints
(src/ClusterLCP.cpp:273-278) and /usr/bin/time -v wrappers
(LiME_paired.sh:44-79).  Also exposes jax device-memory stats in place of
the reference's malloc_count heap interposition (external/malloc_count/).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict

logger = logging.getLogger("lime_tpu")

#: Phase breakdown of the most recent completed PhaseTimer.report(), for
#: benchmark tooling: {"phases": {label: seconds}, "gbps": {label: GB/s},
#: "total": seconds}.  The reference offers only per-thread wtime prints;
#: a bench that cannot see phases cannot be audited (round-2 lesson).
LAST_RUN: dict = {}


class PhaseTimer:
    def __init__(self, name: str):
        self.name = name
        self.phases: Dict[str, float] = {}
        self.bytes: Dict[str, int] = {}
        self._start = time.perf_counter()
        # the job-shop engine times phases from concurrent worker
        # threads; unlocked read-modify-write would drop one worker's
        # seconds from the report the bench scoreboard reads
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, label: str, nbytes: int = 0):
        """Time a phase; ``nbytes`` of data streamed adds a GB/s figure to
        the report (the roofline view the reference lacks — its per-thread
        wtime prints give seconds only, src/ClusterLCP.cpp:273-278)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.phases[label] = self.phases.get(label, 0.0) + (
                    time.perf_counter() - t0)
                if nbytes:
                    self.bytes[label] = self.bytes.get(label, 0) + nbytes

    def add_bytes(self, label: str, nbytes: int) -> None:
        with self._lock:
            self.bytes[label] = self.bytes.get(label, 0) + nbytes

    def total(self) -> float:
        return time.perf_counter() - self._start

    def gbps(self, label: str) -> float:
        t = self.phases.get(label, 0.0)
        return (self.bytes.get(label, 0) / 1e9 / t) if t else 0.0

    def report(self) -> None:
        def fmt(k, v):
            if k in self.bytes:
                return f"{k}={v:.3f}s({self.gbps(k):.2f}GB/s)"
            return f"{k}={v:.3f}s"

        parts = " ".join(fmt(k, v) for k, v in self.phases.items())
        logger.info("%s: %s total=%.3fs", self.name, parts, self.total())
        LAST_RUN.clear()
        LAST_RUN.update({
            "name": self.name,
            "phases": {k: round(v, 3) for k, v in self.phases.items()},
            "gbps": {k: round(self.gbps(k), 3) for k in self.bytes},
            "total": round(self.total(), 3),
        })


def device_memory_stats() -> Dict[str, int]:
    """Per-device memory stats (bytes). Empty on platforms without support."""
    import jax

    stats = {}
    for d in jax.devices():
        try:
            s = d.memory_stats()
        except Exception:  # pragma: no cover - platform dependent
            s = None
        if s:
            stats[str(d)] = {
                "bytes_in_use": s.get("bytes_in_use", 0),
                "peak_bytes_in_use": s.get("peak_bytes_in_use", 0),
            }
    return stats
