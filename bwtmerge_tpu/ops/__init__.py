"""Compute ops: rank/LF, wavefront search, interleave.

Each op has a numpy backend (reference semantics, CPU) and a JAX backend
(the device path). The numpy backend doubles as the oracle for the device
code; ops/rank_sharded.py extends the device path to block-sharded
(larger than one device's memory) indexes.
"""

from .rank_np import RankIndex  # noqa: F401

__all__ = ["RankIndex"]
