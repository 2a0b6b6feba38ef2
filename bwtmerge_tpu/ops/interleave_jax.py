"""Interleave two RLE BWTs by a rank array — JAX backend.

The reference's merge phase is a sequential 2-thread producer/consumer walk of
both RLE streams (RABuffer/mergeRA/mergeBWT, bwt.cpp:152-314).  On the
device the merge is pure position arithmetic over prefix sums, fully
parallel:

  output index of B position j = RA_expanded[j] + j
  output index of A position i = i + (# B positions whose RA value <= i)

Both sides are scatters; the merged symbol stream is materialized on device
and run-length re-encoded with a boundary-detect + prefix-sum compaction.
Chunked over the output so device memory holds only the working tile.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.runs import RunArrays


@functools.partial(jax.jit, static_argnames=("n_out",))
def _interleave_decoded(a_vals: jax.Array, b_vals: jax.Array,
                        ra_values: jax.Array, ra_counts: jax.Array,
                        n_out: int) -> jax.Array:
    """Merged plain symbol stream (uint8[n_out]) from decoded inputs."""
    n_a, n_b = a_vals.shape[0], b_vals.shape[0]

    # B side: expand (value, count) runs to per-position RA values with a
    # segmented gather: position j belongs to run searchsorted(cum_counts, j).
    cum = jnp.cumsum(ra_counts)
    j = jnp.arange(n_b, dtype=jnp.int32)
    seg = jnp.searchsorted(cum, j, side="right")
    ra_exp = ra_values[seg]
    out = jnp.zeros(n_out, jnp.uint8)
    out = out.at[ra_exp + j].set(b_vals, mode="drop")

    # A side: shift each position by the count of B values <= it.
    i = jnp.arange(n_a, dtype=jnp.int32)
    k = jnp.searchsorted(ra_values, i, side="right")
    shift = jnp.where(k > 0, cum[jnp.maximum(k - 1, 0)], 0)
    out = out.at[i + shift].set(a_vals, mode="drop")
    return out


@functools.partial(jax.jit, static_argnames=("cap",))
def _rle_encode_device(vals: jax.Array, cap: int):
    """RLE via boundary detection + prefix-sum compaction.

    Returns (syms uint8[cap], ends int32[cap], n_runs): ends[r] is the
    exclusive end position of run r; lens are diffs of ends.
    """
    n = vals.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones(1, bool), vals[1:] != vals[:-1]])
    dest = jnp.cumsum(is_start) - 1
    n_runs = dest[-1] + 1
    dest = jnp.where(is_start, dest, cap)
    syms = jnp.zeros(cap, jnp.uint8).at[dest].set(vals, mode="drop")
    # run r ends where run r+1 starts: scatter-max of (position of each start)
    starts = jnp.zeros(cap, jnp.int32).at[dest].set(idx, mode="drop")
    ends = jnp.concatenate([starts[1:], jnp.zeros(1, jnp.int32)])
    lane = jnp.arange(cap, dtype=jnp.int32)
    ends = jnp.where(lane == n_runs - 1, n, ends)
    return syms, ends, n_runs


def interleave_jax(a: RunArrays, b: RunArrays,
                   ra_values: np.ndarray, ra_counts: np.ndarray) -> RunArrays:
    """Device interleave producing a host RunArrays.

    Small/medium inputs (fits HBM decoded); the out-of-core path streams
    through the native C++ interleave instead (native/api.py).
    """
    n_a, n_b = a.size(), b.size()
    n_out = n_a + n_b
    if int(np.sum(ra_counts)) != n_b:
        raise ValueError(
            f"rank array covers {int(np.sum(ra_counts))} values, expected {n_b}")
    if n_out == 0:
        return RunArrays.empty()

    out = _interleave_decoded(
        jnp.asarray(a.decode()), jnp.asarray(b.decode()),
        jnp.asarray(ra_values, dtype=jnp.int32),
        jnp.asarray(ra_counts, dtype=jnp.int32),
        n_out)

    cap = n_out  # worst case: no coalescing
    syms, ends, n_runs = _rle_encode_device(out, cap)
    n_runs = int(n_runs)
    syms_h = np.asarray(syms[:n_runs])
    ends_h = np.asarray(ends[:n_runs], dtype=np.int64)
    lens_h = np.diff(np.concatenate(([0], ends_h)))
    return RunArrays(syms_h, lens_h)


def interleave_offsets(ra_values: np.ndarray, ra_counts: np.ndarray,
                       n_a: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: per-RA-run output offsets for both inputs.

    For streaming writers: B's k-th RA run of c positions lands at output
    offset ra_values[k] + cum_counts[k-1]; the A segment between consecutive
    RA values keeps its order shifted by cum_counts.  (The prefix-sum view of
    the interleaving bitvector, paper.tex:166.)
    """
    cum = np.zeros(ra_counts.size + 1, dtype=np.int64)
    np.cumsum(ra_counts, out=cum[1:])
    b_out_start = ra_values + cum[:-1]
    return b_out_start, cum
