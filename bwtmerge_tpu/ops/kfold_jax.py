"""K-way fold by pairwise rank-array decomposition — the round-5 fold
engine.

The reference merges k BWTs as a left fold of pairwise merges, re-building
the accumulated index after every fold (bwt_merge.cpp:163-173; FMI::FMI
fmi.cpp:336-369 + BWT::build bwt.cpp:477-512).  On a device that design
makes the merged index cross the host link every fold, so fold cost grows
with the BASE size and the insert rate falls as the base grows.

This module replaces it with a decomposition that never materializes an
intermediate index ANYWHERE:

  rank of piece k's suffix s in the accumulated base (pieces 0..k-1)
      = |{suffixes of piece_0 <= s}| + ... + |{suffixes of piece_{k-1} <= s}|
      = sum of PAIRWISE rank arrays against the ORIGINAL pieces.

Each pairwise rank array is computed by the per-read backward walk
(ops/walk_jax.py) of piece k's reads through piece l's resident cplane
index.  The sum aligns for free: emission lane (t, r) IS the length-t+1
suffix of read r in EVERY walk (same creads layout), so the per-suffix sum
is a lane-wise add of the raw emission buffers, followed by ONE sort of
the summed buffer.  (A previous revision sorted each walk and summed the
sorted arrays — also correct, by monotonicity of each rank array in the
suffix rank, but k-1 sorts more expensive and incompatible with lane
blocking.)  Endmarker suffixes (j < R) each
count l.sequences() suffixes of piece l (piece order breaks ties: earlier
pieces' endmarkers sort first, exactly the reference's root-run convention,
fmi.cpp:286-287), contributing the constant root value sum.

Device cost per fold step k: one walk per earlier piece — O(|piece_k|)
work against SMALL resident indexes — plus one sort and one elementwise
add; the only host-link traffic is piece_k's one-time nibble upload
(0.5 B/base) and the packed summed rank array out (~0.5 B/run).  Nothing
proportional to the accumulated base ever crosses the link, so the insert
rate is flat in base size by construction.

The host-side interleave chain consumes the summed streams pairwise
(merged_{k} = interleave(merged_{k-1} stream, piece_k, RA_k)) as PIPELINED
chunk generators (native/windowed.py), so all k-1 passes overlap each
other and the device walks; peak host memory stays O(window).

The reference cannot use this decomposition at all: its search phase needs
the built FMI of the accumulated base because it has no access to the
inserted pieces' read text (construction is outsourced to ropebwt,
paper.tex:274).  The walk engine's read-text sidecar is what unlocks it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .rank_jax import DeviceFMIndex
from .search_jax import EXC_CAP, _bucket, _pack_planes
from .walk_jax import _SENT, _walk_emit, build_cplanes


class PieceIndex:
    """Device residency for one fold piece: per-character cplanes + C.

    Built once per piece from its DeviceFMIndex; the fused record table is
    NOT retained (the walk only gathers cplane rows), so a resident piece
    costs 1.25 B/position of HBM.
    """

    def __init__(self, cpl: jax.Array, C: jax.Array, sequences: int,
                 size: int):
        self.cpl = cpl
        self.C = C
        self.sequences = int(sequences)
        self.size = int(size)

    @classmethod
    def from_device_index(cls, idx: DeviceFMIndex) -> "PieceIndex":
        return cls(build_cplanes(idx.rec), idx.C, int(idx.C[1]), idx.size)


@jax.jit
def _walk_raw(cpl: jax.Array, C: jax.Array, creads: jax.Array,
              a0: jax.Array):
    """One pairwise walk, emissions left in LANE order (lane (t, r) = the
    length-t+1 suffix of read r; dead lanes _SENT).

    a0 is the walk start value: l.sequences() for an earlier piece l (the
    '<=' tie convention — l's endmarkers precede the walked piece's).
    Returns (emits int32[max_len*R], n_live)."""
    return _walk_emit(cpl, C, creads, a0)


# Pad marker for SUMMED lanes: 0xFFFFFFFF — unsigned max, so pads sort
# LAST under the unsigned sort below.  (The single-walk pad _SENT =
# int32-max would land in the MIDDLE of the unsigned order once summed
# values wrap past 2^31.)  A true value of 0xFFFFFFFF is excluded by the
# MAX_FOLD_TOTAL guard.
UPAD = jnp.int32(-1)
MAX_FOLD_TOTAL = (1 << 32) - 2


@jax.jit
def _first_lanes(emits: jax.Array) -> jax.Array:
    """First walk's emissions with pads remapped _SENT -> UPAD."""
    return jnp.where(emits == _SENT, UPAD, emits)


@jax.jit
def _sum_lanes(total: jax.Array, emits: jax.Array) -> jax.Array:
    """Per-suffix sum of pairwise walks: lane (t, r) IS the suffix, so the
    emission buffers are aligned by construction and the per-suffix sum is
    a plain lane-wise add (wraparound uint32 on the int32 lanes) — no
    per-target sort needed.  Pads (UPAD in the running total, _SENT in the
    new walk, same lanes) stay UPAD."""
    return jnp.where(total == UPAD, UPAD, total + emits)


@jax.jit
def _sort_vals(vals: jax.Array) -> jax.Array:
    """UNSIGNED ascending sort: summed values beyond 2^31 wrap the int32
    lanes negative, and a signed sort would order them FIRST (the round-5
    3.47 Gbp fold corrupted every step past a 2.1 Gbp accumulated total
    until this bitcast)."""
    u = jax.lax.bitcast_convert_type(vals, jnp.uint32)
    return jax.lax.bitcast_convert_type(jax.lax.sort(u), jnp.int32)


@functools.partial(jax.jit, static_argnames=())
def _pack_presorted(vals: jax.Array, n_live: jax.Array,
                    root_value: jax.Array, root_count: jax.Array):
    """Plane-pack an ALREADY SORTED emission array plus its root run.

    The root run (endmarker suffixes: value = sum of earlier pieces'
    sequence counts, count = R) sorts before every emission (emissions are
    >= C_l[1] per walked piece l), so it prepends without a sort — this is
    _pack_walk (walk_jax.py) minus the device sort the caller already did.
    Output contract matches search_and_pack: (dc8, meta_exc, exc4, esc).
    """
    e0 = vals.shape[0]
    e = _bucket(e0 + 2, minimum=1 << 10)
    ext = jnp.concatenate([
        root_value[None].astype(jnp.int32), vals,
        jnp.full(e - e0 - 1, _SENT, jnp.int32)])
    lane = jax.lax.broadcasted_iota(jnp.int32, (e, 1), 0)[:, 0]
    # liveness is POSITIONAL (sorted live lanes come first): summed values
    # beyond 2^31 wrap the int32 lanes, so comparing against the _SENT
    # sentinel would misclassify a wrapped sum that lands on int32-max
    counts = jnp.where(lane == 0, root_count,
                       (lane <= n_live).astype(jnp.int32))
    n_u = n_live + 1
    dc, exc, exc4, esc, n_exc, n_exc4, n_esc2 = _pack_planes(ext, counts, n_u)
    meta = jnp.zeros((1, EXC_CAP), jnp.int32)
    meta = meta.at[0, 0].set(n_u).at[0, 1].set(n_exc)
    meta = meta.at[0, 3].set(n_exc4).at[0, 4].set(n_esc2)
    return dc, jnp.concatenate([exc, meta], axis=0), exc4, esc


# One walk program (scan + sum + sort + pack) peaks at ~16 B/lane of device
# temporaries; this bounds the lanes PER PROGRAM.  Bigger pieces split
# their READ LANES into blocks (lane (t, r) stays a whole suffix, so the
# per-target lane-wise sum is block-local and the per-block sorted streams
# k-way merge on the host exactly like sequence blocks).
MAX_WALK_LANES = 96 * 1024 * 1024


def _summed_block(targets, creads_block, root_count: int):
    """One lane-block's summed + sorted + packed rank array."""
    total = None
    n_live = None
    root_value = 0
    for t in targets:
        vals, n_live = _walk_raw(t.cpl, t.C, creads_block,
                                 jnp.int32(t.sequences))
        total = _first_lanes(vals) if total is None \
            else _sum_lanes(total, vals)
        root_value += t.sequences
    total = _sort_vals(total)
    # totals beyond 2^31 ride the int32 lanes as wraparound uint32 (the
    # host decoders re-read negative exception deltas as uint32); wrap the
    # root value the same way so jnp.int32 never rejects it
    rv32 = ((root_value + 2**31) % 2**32) - 2**31
    return _pack_presorted(total, n_live, jnp.int32(rv32),
                           jnp.int32(root_count))


def summed_packed_part_thunks(targets, creads, n_reads: int | None = None):
    """The fold-step search as LAZY per-lane-block thunks: calling a thunk
    walks one block of `creads` (piece k's reads, one lane per read)
    through every earlier piece's resident index and returns that block's
    SUMMED packed rank array (dc8, meta_exc, exc4, esc).

    Each block's lanes are whole reads, so blocks partition the suffix
    multiset and the per-block sorted streams k-way merge (or spill-merge)
    on the host.  Laziness lets the caller bound how many blocks' packed
    planes are live in HBM at once.

    targets: list[PieceIndex] — pieces 0..k-1 in fold order.
    creads: host array (lane-padded here) or a device array already
    lane-bucketed (decode_creads_dev output) with n_reads its live lanes.
    """
    max_len, r = creads.shape
    if isinstance(creads, np.ndarray):
        n_reads = r if n_reads is None else n_reads
        per0 = _bucket(max(r, 1), minimum=128)
        if per0 > r:
            creads = np.pad(creads, ((0, 0), (0, per0 - r)))
        creads_dev = jnp.asarray(creads)
    else:
        if n_reads is None:
            raise ValueError("device creads needs an explicit n_reads")
        per0 = r
        creads_dev = creads
    if sum(t.size for t in targets) + n_reads >= MAX_FOLD_TOTAL:
        raise ValueError(
            "fold total exceeds the uint32 device lanes (4.29 Gbp); "
            "shard the fold")
    n_blocks = 1
    while max_len * -(-per0 // n_blocks) > MAX_WALK_LANES:
        n_blocks *= 2
    blk_w = _bucket(-(-per0 // n_blocks), minimum=8)

    def thunk(b):
        def run():
            w = min(blk_w, per0 - b)
            block = jax.lax.slice(creads_dev, (0, b), (max_len, b + w))
            if w < blk_w:
                block = jnp.pad(block, ((0, 0), (0, blk_w - w)))
            live = max(0, min(n_reads - b, w))
            return _summed_block(targets, block, live)
        return run

    return [thunk(b) for b in range(0, per0, blk_w)]


def summed_packed_parts(targets, creads, n_reads: int | None = None):
    """Eager list of per-lane-block packed parts (tests/small pieces)."""
    return [t() for t in summed_packed_part_thunks(targets, creads,
                                                   n_reads=n_reads)]


def summed_packed_ra(targets, creads, n_reads: int | None = None):
    """Single-part convenience wrapper over summed_packed_parts (pieces
    within one walk program's lane budget)."""
    parts = summed_packed_parts(targets, creads, n_reads=n_reads)
    if len(parts) != 1:
        raise ValueError("piece needs lane blocking; use summed_packed_parts")
    return parts[0]
