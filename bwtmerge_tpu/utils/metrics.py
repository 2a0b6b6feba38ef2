"""Timing, memory, and throughput observability.

Parity with the reference's readTimer/memoryUsage/printSize/printTime
(utils.h:204-216, utils.cpp:38-96) plus structured per-phase metrics so merge
throughput is reported in the same units (MB/s, Mbases/s) as the paper.
"""

from __future__ import annotations

import resource
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator

MEGABYTE = 1024 * 1024
GIGABYTE = 1024 * MEGABYTE


def read_timer() -> float:
    """Seconds from an arbitrary time point (monotonic)."""
    return time.monotonic()


def memory_usage() -> int:
    """Peak RSS of this process in bytes (reference utils.cpp:86-96)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def card_info() -> str:
    """The GPU's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), one line per card; "not available"
    where nvidia-smi is missing or fails.  A card set below its maximum
    power runs slower under load, so every timing is reported beside this."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.strip() or "not available"


def in_megabytes(num_bytes: int) -> float:
    return num_bytes / float(MEGABYTE)


def in_gigabytes(num_bytes: int) -> float:
    return num_bytes / float(GIGABYTE)


def in_bpc(num_bytes: int, data_size: int) -> float:
    """Bits per character."""
    return 8.0 * num_bytes / data_size if data_size else 0.0


def print_size(header: str, num_bytes: int, data_size: int, out=sys.stdout) -> None:
    out.write(f"{header + ':':<18}{in_megabytes(num_bytes):.6g} MB "
              f"({in_bpc(num_bytes, data_size):.6g} bpc)\n")


def print_time(header: str, found: int, matches: int, num_bytes: int, seconds: float,
               out=sys.stdout) -> None:
    mbs = in_megabytes(num_bytes) / seconds if seconds > 0 else 0.0
    out.write(f"{header + ':':<18}Found {found} patterns with {matches} occ in "
              f"{seconds:.6g} seconds ({mbs:.6g} MB/s)\n")


@dataclass
class PhaseTimer:
    """Structured per-phase wall-clock metrics for the merge pipeline.

    Replaces the reference's VERBOSE_STATUS_INFO stderr tracing (SURVEY.md §5)
    with a queryable record: timer.phases -> {name: seconds}.
    """

    phases: Dict[str, float] = field(default_factory=dict)
    verbose: bool = False

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = read_timer()
        try:
            yield
        finally:
            elapsed = read_timer() - start
            self.phases[name] = self.phases.get(name, 0.0) + elapsed
            if self.verbose:
                sys.stderr.write(f"bwt_merge: {name} finished in {elapsed:.3f} seconds\n")

    def total(self) -> float:
        return sum(self.phases.values())

    @contextmanager
    def device_trace(self, trace_dir: str | None) -> Iterator[None]:
        """jax.profiler trace around a region (no-op when trace_dir is None).

        The SURVEY §5 mapping of VERBOSE_STATUS_INFO: wall-clock phases stay
        in `phases`; the device-side timeline (compiled program runs, HBM
        transfers, per-op costs) lands as a TensorBoard/Perfetto trace under
        trace_dir.
        """
        if not trace_dir:
            yield
            return
        import jax

        with jax.profiler.trace(trace_dir):
            yield

    def report(self, num_bytes: int, out=sys.stderr) -> None:
        for name, seconds in self.phases.items():
            mbs = in_megabytes(num_bytes) / seconds if seconds > 0 else 0.0
            out.write(f"  {name:<24}{seconds:10.3f} s  ({mbs:10.2f} MB/s)\n")
