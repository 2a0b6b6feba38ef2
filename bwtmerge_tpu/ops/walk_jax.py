"""Rank-array construction by per-read backward walk — the search fast
path when B's read text is on hand.

The rank array is an order-independent MULTISET of a-positions (it is
re-sorted before interleaving), and the reverse-trie search's emissions
(buildRA, reference fmi.cpp:261-334) equal

  * the root run (value = a.sequences(), count = B.sequences()), plus
  * for each read r of B and each suffix length t in 1..len(r): the value
    a_t of the backward walk a_0 = a.sequences(),
    a_{t+1} = C_A[c_t] + rank_A(a_t, c_t), with c_t the t-th character of
    read r counted FROM THE END

(each walk state after consuming t characters is the rank in A of the
length-t suffix — one emission per B position, exactly the trie's multiset;
verified against the trie oracle in tests/test_walk.py).

So when B's per-read text is available — our build pipeline emits it as a
sidecar for free, and any BWT can be decoded into it once on device
(decode_creads) — the whole search phase collapses to a batched walk
through A ONLY:

  * no B-side probes at all and no range phase;
  * state stays in FIXED read-lane order, so each step's characters are a
    contiguous row slice of `creads` (layout [max_len, R], characters from
    the read END, 0 past the end) — no sorts, no realignment;
  * rank_A at a KNOWN character is one 8-byte-row gather from the
    per-character occ/bitmask planes (build_cplanes), a narrower row than
    the 64-byte fused record;
  * emissions land as contiguous [max_len, R] rows; the pack is one
    2-operand device sort + the shared plane packer.

The trade: the walk processes every B position individually, giving up the
trie's shared-prefix batching (paper.tex:182-184) — the wavefront drivers
in search_jax.py remain the path for highly repetitive collections and for
the sharded-index mesh.  Reference counterparts: buildRA fmi.cpp:261-334
(replaced), BWT::rank bwt.cpp:318-341 (the per-step primitive).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .rank_jax import BLK, LANES, SIGMA, DeviceFMIndex
from .search_jax import EXC_CAP, _bucket, _pack_planes

_SENT = 2**31 - 1
NC = SIGMA - 1        # walked characters 1..SIGMA-1 (endmarker never walked)

# Per-character rank planes: row (block*NC + c-1) = [occ_c, bitmask_c] where
# occ_c counts character c in positions [0, 32*block) and bit k of bitmask_c
# is set iff the block's position k holds c.  rank(a, c) for KNOWN c is then
# ONE 8-byte row gather + popcount — the narrow-row analog of the 64-byte
# fused record (rank_jax.py).
_SHIFTS = np.zeros(BLK, dtype=np.uint32)
# unpack order: lane l = 8*b + w holds position 4*w + b (rank_jax._POS_OF_LANE)
_SHIFTS[:] = 1
_SHIFTS = (_SHIFTS << (4 * (np.arange(BLK) % 8) + np.arange(BLK) // 8)).astype(np.uint32)


@jax.jit
def _cplanes_of(rec: jax.Array) -> jax.Array:
    """Per-character (occ, bitmask) plane rows of one record-table slab."""
    nblk = rec.shape[0]
    words = rec[:, LANES:].astype(jnp.uint32)                  # [NBLK, 8]
    syms = jnp.concatenate(
        [((words >> s) & 0xFF).astype(jnp.int32) for s in (0, 8, 16, 24)],
        axis=1)                                                # [NBLK, 32]
    shifts = jnp.asarray(_SHIFTS)[None, :]                     # [1, 32] u32
    rows = []
    for c in range(1, SIGMA):
        mask = jnp.sum(jnp.where(syms == c, shifts, jnp.uint32(0)),
                       axis=1, dtype=jnp.uint32)               # [NBLK]
        rows.append(jnp.stack(
            [rec[:, c],
             jax.lax.bitcast_convert_type(mask, jnp.int32)], axis=1))
    return jnp.stack(rows, axis=1).reshape(nblk * NC, 2)


@functools.partial(jax.jit, static_argnames=("size",))
def _cplanes_slab(rec: jax.Array, start: jax.Array, size: int) -> jax.Array:
    return _cplanes_of(jax.lax.dynamic_slice(
        rec, (start, jnp.int32(0)), (size, rec.shape[1])))


DECODE_SLAB_LANES = 4 * 1024 * 1024   # lanes per decode program

CPLANE_SLAB = 1 << 22   # blocks per cplane program: one bucket shape
                        # reused by every table size, so large tables add
                        # no new compiles


def build_cplanes(rec: jax.Array) -> jax.Array:
    """Per-character (occ, bitmask) planes from the fused record table.

    rec: int32[NBLK, 16] (rank_jax layout).  Returns int32[NBLK*NC, 2].
    Derived entirely on device — k-way folds rebuild it from the merged
    record table with no host round trip.  Large tables run slab-by-slab
    through ONE bucket-shaped program (the last slab is clamped and its
    overlap trimmed) so k-way folds at any base size reuse the compile."""
    nblk = rec.shape[0]
    if nblk <= CPLANE_SLAB:
        return _cplanes_of(rec)
    parts = []
    pos = 0
    while pos < nblk:
        start = min(pos, nblk - CPLANE_SLAB)
        sl = _cplanes_slab(rec, jnp.int32(start), CPLANE_SLAB)
        if start < pos:     # final slab: drop rows already covered
            sl = sl[(pos - start) * NC:]
        parts.append(sl)
        pos = start + CPLANE_SLAB
    return jnp.concatenate(parts)


def _rank_known_char(cpl: jax.Array, C: jax.Array, a: jax.Array,
                     cc: jax.Array) -> jax.Array:
    """LF(a, cc) for known characters cc in [1, SIGMA): one 8 B gather."""
    row = cpl[(a >> 5) * NC + (cc - 1)]                        # [R, 2]
    off = (a & (BLK - 1)).astype(jnp.uint32)
    mask = jax.lax.bitcast_convert_type(row[:, 1], jnp.uint32)
    low = (jnp.uint32(1) << off) - jnp.uint32(1)               # off in [0,31]
    cnt = jax.lax.population_count(mask & low).astype(jnp.int32)
    return C[cc] + row[:, 0] + cnt


@jax.jit
def _walk_emit(cpl: jax.Array, C: jax.Array, creads: jax.Array,
               a_sequences: jax.Array):
    """The walk loop: creads int8[max_len, R] (chars from the read end,
    0-padded) -> (emits int32[max_len, R] with _SENT in dead lanes,
    n_live total emissions).

    Two hard-won platform rules are baked into this function's shape
    (round-4 drills at the 26M-lane bench scale; host transfers of the
    buffers involved were always correct, so only device-side consumers
    ever saw the corruption):

      * lax.scan over the character rows, NOT a while_loop carrying the
        emission buffer — XLA aliases a carried buffer updated in place
        with dynamic_update_slice, and downstream ops of the loop output
        read stale lanes;
      * the stacked [max_len, R] output is FLATTENED INSIDE this program —
        a tall 2-D int32 buffer gets a row-padded tiled layout, and a
        SECOND program bulk-reading it across the jit boundary read
        garbage on the runtime it was found on, while the
        in-program reshape relayouts it into a clean 1-D buffer.

    Regression test: tests/test_walk.py::test_walk_pack_bench_scale_block
    (gated behind BWTMERGE_SLOW_TESTS=1 for runtime).  scan stacking also
    drops the early exit — callers pass creads trimmed to the longest
    read, so for read collections there are no wasted rows.

    Returns (emits int32[max_len*R] flat, n_live)."""
    r = creads.shape[1]
    a0 = jnp.full((r,), 0, jnp.int32) + a_sequences

    def body(a, c_row):
        c = c_row.astype(jnp.int32)
        alive = c > 0
        cc = jnp.maximum(c, 1)
        child = _rank_known_char(cpl, C, a, cc)
        a2 = jnp.where(alive, child, a)
        row = jnp.where(alive, child, _SENT)
        return a2, (row, jnp.sum(alive.astype(jnp.int32)))

    _, (emits, alive_n) = jax.lax.scan(body, a0, creads)
    return emits.reshape(-1), jnp.sum(alive_n)


@jax.jit
def _pack_walk(emits: jax.Array, n_live: jax.Array, a_sequences: jax.Array,
               root_count: jax.Array):
    """Root run + sort + plane packing over a finished FLAT emission
    buffer (see _walk_emit for why it must arrive 1-D)."""
    e0 = emits.shape[0]
    e = _bucket(e0 + 1, minimum=1 << 10)
    # root run + sentinel fill appended by CONCATENATE, root count patched
    # with a pure elementwise where — no dynamic_update_slice into a large
    # buffer (see walk_and_pack_device's two-program note)
    tail_lane = jax.lax.broadcasted_iota(jnp.int32, (e - e0, 1), 0)[:, 0]
    tail = jnp.where(tail_lane == 0, a_sequences, _SENT)
    values = jnp.concatenate([emits, tail])
    lane = jax.lax.broadcasted_iota(jnp.int32, (e, 1), 0)[:, 0]
    counts = jnp.where(lane == e0, root_count,
                       (values != _SENT).astype(jnp.int32))
    v, c = jax.lax.sort((values, counts), num_keys=1, is_stable=False)
    n_u = n_live + 1
    dc, exc, exc4, esc, n_exc, n_exc4, n_esc2 = _pack_planes(v, c, n_u)
    meta = jnp.zeros((1, EXC_CAP), jnp.int32)
    meta = meta.at[0, 0].set(n_u).at[0, 1].set(n_exc)
    meta = meta.at[0, 3].set(n_exc4).at[0, 4].set(n_esc2)
    return dc, jnp.concatenate([exc, meta], axis=0), exc4, esc


def walk_and_pack_device(cpl: jax.Array, C: jax.Array, creads: jax.Array,
                         a_sequences: jax.Array, root_count: jax.Array):
    """Walk + root run + sort + plane packing, as TWO device programs.

    Same output contract as search_and_pack (search_jax.py): (dc uint8[4, E],
    meta_exc int32[4, EXC_CAP], exc4, esc) — so PackedDeviceRA /
    stream_packed_ra / the blocked consumers work unchanged.  The walk's
    emission count is bounded by its buffer by construction, so overflow is
    structurally impossible (meta overflow flag always 0).

    DELIBERATELY two programs, not one fused jit: with the walk scan and
    the 33M-lane pack in one program, this platform's XLA buffer assignment
    aliased the scan's stacked output against pack temporaries and produced
    NONDETERMINISTIC packed planes (~20M corrupted bytes between identical
    calls; reproduced at the bench shape, .bench_cache/dbg_walk8/9 drills,
    round 4).  Splitting at the emits boundary makes the emission buffer an
    immutable program INPUT, which XLA may not alias; both halves measured
    deterministic and oracle-exact at the same shape.  The extra program
    costs one dispatch (~1 ms), nothing else — the buffer stays on device.
    """
    emits, n_live = _walk_emit(cpl, C, creads, a_sequences)
    return _pack_walk(emits, n_live, a_sequences, root_count)


def blocked_walk_and_pack(a_idx: DeviceFMIndex, creads: np.ndarray,
                          n_blocks: int,
                          a_sequences: int | None = None,
                          chunk_runs: int | None = None):
    """The walk search over read blocks, packed per block and consumed as
    one ascending chunk stream (BlockedPackedRA) — the walk analog of
    blocked_search_and_pack: block k+1's walk compute overlaps block k's
    rank-array D2H transfers.

    creads: int8[max_len, R] walk layout (host).  Blocks partition the READ
    LANES; each block's emissions are sorted on device, so the k-way chunk
    merge sums duplicates across blocks exactly as for sequence blocks.
    """
    from .search_jax import BlockedPackedRA, make_block_part

    if a_sequences is None:
        a_sequences = int(a_idx.C[1])
    max_len, r_total = creads.shape
    n_blocks = max(1, min(n_blocks, r_total))
    per = -(-r_total // n_blocks)
    per = _bucket(per, minimum=128)              # one program shape per fold
    cpl = build_cplanes(a_idx.rec)
    if chunk_runs is None:
        chunk_runs = BlockedPackedRA.CHUNK
    parts = []
    for b in range(0, r_total, per):
        blk = creads[:, b:b + per]
        n_lanes = blk.shape[1]
        if n_lanes < per:                        # pad lanes are dead (c=0)
            blk = np.pad(blk, ((0, 0), (0, per - n_lanes)))
        # root-run share: each block's lanes are whole reads (pads excluded)
        root = n_lanes
        dc8, meta, exc4, esc = walk_and_pack_device(
            cpl, a_idx.C, jnp.asarray(blk), jnp.int32(a_sequences),
            jnp.int32(root))
        # emission bound: every lane emits at most max_len + the root run
        bound = min(dc8.shape[1], per * max_len + 1)
        parts.append(make_block_part(dc8, meta, exc4, esc, chunk_runs,
                                     bound))
    return BlockedPackedRA(parts)


# -- decoding B into creads (when no text sidecar exists) ----------------------


@jax.jit
def _decode_step(b_idx: DeviceFMIndex, p: jax.Array, alive: jax.Array):
    lf, c = b_idx.LF_step(p)
    c = jnp.where(alive, c, 0)
    alive2 = alive & (c > 0)
    return jnp.where(alive2, lf, p), c, alive2


@jax.jit
def decode_creads_device(b_idx: DeviceFMIndex, creads0: jax.Array,
                         lane0: jax.Array = 0):
    """Decode B's reads ON DEVICE into the walk layout.

    creads0: int8[max_len_cap, R] zeros (R >= B.sequences(), lane-bucketed).
    Lane r chases LF from BWT row r (rows [0, sequences) are the endmarker
    rows, so the first step yields each read's LAST character — exactly
    creads order).  Returns (creads, n_alive_at_cap): a nonzero second value
    means some read is longer than the cap (caller falls back to the trie).
    One 64 B row gather per lane per step; runs once per input ever — the
    result is cached as a sidecar (formats/sidecar.py).
    """
    max_len, r = creads0.shape
    p0 = jnp.int32(lane0) + jnp.arange(r, dtype=jnp.int32)
    alive0 = p0 < b_idx.C[1]                   # C[1] = #sequences

    def cond(st):
        t, p, alive, creads = st
        return (t < max_len) & jnp.any(alive)

    def body(st):
        t, p, alive, creads = st
        p, c, alive = _decode_step(b_idx, p, alive)
        creads = jax.lax.dynamic_update_slice(
            creads, c.astype(jnp.int8)[None], (t, 0))
        return t + 1, p, alive, creads

    st = (jnp.int32(0), p0, alive0, creads0)
    _, _, alive, creads = jax.lax.while_loop(cond, body, st)
    return creads, jnp.sum(alive.astype(jnp.int32))


def decode_creads_dev(b_idx: DeviceFMIndex, sequences: int, size: int,
                      max_len_cap: int = 1 << 14):
    """Device-resident decode_creads: same walk, but the creads array never
    crosses to the host (the k-way fold engine walks it in place,
    ops/kfold_jax.py — a D2H copy of it and an upload back would cost more
    than the decode itself).  Rows are trimmed to the EXACT longest read
    (one compile per distinct max read length — uniform read sets reuse
    one shape; r4 verdict weak #5's dead-row waste removed).

    Returns (creads int8[used_rows, R_bucket] on device, n_reads) or None
    when some read exceeds max_len_cap."""
    if sequences <= 0:
        return jnp.zeros((1, 128), jnp.int8), 0
    r = _bucket(sequences, minimum=128)
    avg = max(1, size // sequences)
    # start near the average length: the 4x headroom of the host-side
    # decode sized a [256, 12.6M] int8 buffer (3.2 GB) for 50 bp reads and
    # OOMed HBM at 510 Mbp pieces; uneven collections grow via the retry
    cap = min(_bucket(avg + avg // 4 + 16, minimum=64),
              _bucket(max_len_cap))
    # decode in LANE SLABS: one [cap, r] program at 12.6M lanes peaks at
    # ~3 GB of per-step gather temps (rec rows + unpacked symbols), which
    # collided with outstanding walk parts at the 510 Mbp-piece tier
    W = min(r, DECODE_SLAB_LANES)
    while True:
        slabs = []
        n_over = 0
        for s0 in range(0, r, W):
            creads0 = jnp.zeros((cap, W), jnp.int8)
            sl, ov = decode_creads_device(b_idx, creads0, jnp.int32(s0))
            n_over += int(ov)      # per-slab sync bounds live temps
            slabs.append(sl)
        if n_over == 0:
            creads = slabs[0] if len(slabs) == 1                 else jnp.concatenate(slabs, axis=1)
            del slabs
            used = int(np.asarray(_rows_used(creads)))
            used = max(used, 1)
            return jax.lax.slice(creads, (0, 0), (used, r)), sequences
        if cap >= max_len_cap:
            return None
        cap = min(_bucket(cap * 2), _bucket(max_len_cap))


@jax.jit
def _rows_used(creads: jax.Array) -> jax.Array:
    """1 + index of the last row holding any live character (0 if none)."""
    any_row = jnp.any(creads > 0, axis=1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (creads.shape[0], 1), 0)[:, 0]
    return jnp.max(jnp.where(any_row, idx + 1, 0))


def decode_creads(b_idx: DeviceFMIndex, sequences: int, size: int,
                  max_len_cap: int = 1 << 14):
    """Host wrapper: bucketed shapes, overflow-aware.  Returns creads
    np.int8[max_len, R] (end-aligned walk layout) or None when some read
    exceeds max_len_cap."""
    if sequences <= 0:
        return np.zeros((0, 0), np.int8)
    r = _bucket(sequences, minimum=128)
    avg = max(1, size // sequences)
    cap = min(_bucket(4 * avg + 64, minimum=64), _bucket(max_len_cap))
    while True:
        creads0 = jnp.zeros((cap, r), jnp.int8)
        creads, n_over = decode_creads_device(b_idx, creads0)
        if int(n_over) == 0:
            out = np.asarray(creads)[:, :sequences]  # drop bucket-pad lanes
            used = int(np.max(np.nonzero(out.any(axis=1))[0], initial=-1)) + 1
            return out[:used] if used else out[:1]
        if cap >= max_len_cap:
            return None
        cap = min(_bucket(cap * 2), _bucket(max_len_cap))
