"""Rank-array construction by wavefront search — JAX backend.

Vector re-design of the reference's reverse-trie DFS (buildRA,
fmi.cpp:261-334).  The reference walks one trie node at a time per thread with
three node-size-dependent LF strategies; here the WHOLE frontier advances one
trie depth per step with three batched rank-table gathers:

    step:  [F] nodes (a_pos, b_sp, b_ep)
           -> ranks_all(B, sp), ranks_all(B, ep+1), ranks_all(A, a_pos)
           -> [F, sigma-1] children, keep = non-empty
           -> prefix-sum scatter compaction -> new frontier

Shared-prefix batching (the reference's key trick, paper.tex:182-184) is
inherent: a node carries a whole lexicographic range of B-suffixes, so highly
repetitive read collections advance in few nodes.

Three drivers share the machinery:

  * `wavefront_search_device2` — the production path: the WHOLE search as one
    compiled two-phase lax.while_loop (general range phase, then a lean
    singleton-only phase), emissions accumulated on device; used by the
    sharded mesh path and bench.
  * `wavefront_search_device` — the single-phase variant (kept as the simpler
    reference implementation of the same contract).
  * `wavefront_search` — host-driven fallback for inputs whose frontier or
    emission volume exceeds the static device buffers: one compiled step per
    depth, frontier padded to power-of-two buckets, RA runs streamed to the
    host spill ladder each depth.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .rank_jax import SIGMA, DeviceFMIndex


# -- single depth step --------------------------------------------------------


@jax.jit
def _expand_step(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                 a_pos: jax.Array, b_sp: jax.Array, b_ep: jax.Array,
                 valid: jax.Array):
    """Expand every frontier node by all characters 1..SIGMA-1 and compact.

    Returns (child_a, child_sp, child_ep, count): arrays of capacity
    F*(SIGMA-1) with the live children compacted to the front, and the live
    count.  Batched analog of the per-node child loops fmi.cpp:296-321.
    """
    f = a_pos.shape[0]
    rb_sp = b_idx.ranks_all(b_sp)        # [F, LANES]
    rb_ep = b_idx.ranks_all(b_ep + 1)    # [F, LANES]
    ra = a_idx.ranks_all(a_pos)          # [F, LANES]

    cs = jnp.arange(1, SIGMA, dtype=jnp.int32)            # endmarker never extends
    child_sp = b_idx.C[cs][None, :] + rb_sp[:, 1:SIGMA]   # [F, SIGMA-1]
    child_ep = b_idx.C[cs][None, :] + rb_ep[:, 1:SIGMA] - 1
    child_a = a_idx.C[cs][None, :] + ra[:, 1:SIGMA]
    keep = (child_ep >= child_sp) & valid[:, None]

    # Compaction by stable multi-operand sort on the dead/alive key: packs
    # live children to the front in one fused op instead of three
    # prefix-sum scatters.
    keep_f = keep.reshape(-1)
    count = jnp.sum(keep_f.astype(jnp.int32))
    key = jnp.where(keep_f, jnp.int32(0), jnp.int32(1))
    _, out_a, out_sp, out_ep = jax.lax.sort(
        (key, child_a.reshape(-1), child_sp.reshape(-1),
         jnp.where(keep_f, child_ep.reshape(-1), -1)),
        num_keys=1, is_stable=True)
    return out_a, out_sp, out_ep, count


# -- production driver: host loop, device steps -------------------------------


def _bucket(n: int, minimum: int = 128, growth: int = 2) -> int:
    """Next power-of-`growth` capacity >= n (bounds the number of distinct
    XLA programs; raise `minimum`/`growth` where compiles are slow)."""
    b = minimum
    while b < n:
        b *= growth
    return b


def wavefront_search(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                     b_seq_range: Tuple[int, int],
                     a_sequences: int,
                     emit, min_bucket: int = 128, growth: int = 2) -> None:
    """Search B's sequence block [sp0, ep0] through A, streaming RA runs.

    `emit(values: np.int64[K], counts: np.int64[K])` is called once per trie
    depth with that depth's (a_pos, count) runs — the host-side consumer
    (accumulator / spill ladder) decides what to do with them, mirroring the
    run-buffer handoff of fmi.cpp:290.
    """
    sp0, ep0 = b_seq_range
    if ep0 < sp0:
        return

    # Root: the whole block of B endmarkers, rank a.sequences() in A
    # (fmi.cpp:286-287).
    a_pos = np.array([a_sequences], dtype=np.int32)
    b_sp = np.array([sp0], dtype=np.int32)
    b_ep = np.array([ep0], dtype=np.int32)
    count = 1

    while count:
        emit(a_pos[:count].astype(np.int64),
             (b_ep[:count].astype(np.int64) - b_sp[:count] + 1))

        cap = _bucket(count, min_bucket, growth)
        if cap != a_pos.shape[0]:
            pad = cap - count
            a_pos = np.pad(a_pos[:count], (0, pad))
            b_sp = np.pad(b_sp[:count], (0, pad))
            b_ep = np.pad(b_ep[:count], (0, pad), constant_values=-1)
        valid = np.zeros(cap, dtype=bool)
        valid[:count] = True

        out_a, out_sp, out_ep, cnt = _expand_step(
            a_idx, b_idx, jnp.asarray(a_pos), jnp.asarray(b_sp),
            jnp.asarray(b_ep), jnp.asarray(valid))
        count = int(cnt)
        a_pos = np.asarray(out_a)
        b_sp = np.asarray(out_sp)
        b_ep = np.asarray(out_ep)


# -- singleton-specialized fully-jitted driver --------------------------------
#
# Deep in the search almost every frontier node is a SINGLETON (|b_range|=1):
# a singleton has exactly ONE child (the char BWT_B[p], via one LF step) and
# needs TWO rank-row gathers instead of three — and no 5-way child fan-out.
# This is the device analog of the reference's node-size strategy switch
# (fmi.cpp:296-321).  A range node's children can be singletons but never the
# reverse, so the search runs in two phases: the general range loop until the
# whole frontier is singleton, then a lean singles-only loop (2 gathers + a
# 3-operand compaction sort over F lanes instead of 3 gathers + a 4-operand
# sort over 5F lanes).


@functools.partial(jax.jit, static_argnames=("frontier_cap", "emit_cap"))
def wavefront_search_device2(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                             b_sp0: jax.Array, b_ep0: jax.Array,
                             a_sequences: int,
                             frontier_cap: int = 4096,
                             emit_cap: int = 65536):
    """Two-phase singleton-specialized search; same contract as
    wavefront_search_device (drop-in; read collections are singleton-heavy,
    so the lean phase does most of the depth steps)."""
    cap = frontier_cap
    zero = (b_sp0 * 0).astype(jnp.int32)

    count0 = jnp.where(b_ep0 >= b_sp0, jnp.int32(1), jnp.int32(0))
    values0 = jnp.zeros(emit_cap, jnp.int32) + zero
    counts0 = jnp.zeros(emit_cap, jnp.int32) + zero

    def emit(values, counts, n_emit, ovf, a_pos, cnts, c):
        w = min(c, emit_cap)
        safe = n_emit + c <= emit_cap
        start = jnp.where(safe, n_emit, 0)
        values = jax.lax.dynamic_update_slice(values, a_pos[:w], (start,))
        counts = jax.lax.dynamic_update_slice(counts, cnts[:w], (start,))
        return values, counts, ovf | ~safe

    def range_loop(c, st, staged):
        """General range loop at capacity `c`.  Exits when all-singleton,
        overflow — or (staged mode) when the next expansion might not fit,
        so a wider-capacity loop can take over without losing work."""
        lane_c = jax.lax.broadcasted_iota(jnp.int32, (c, 1), 0)[:, 0]

        def cond(st):
            a_pos, b_sp, b_ep, count, values, counts, n_emit, ovf = st
            valid = lane_c < count
            has_range = jnp.sum((valid & (b_ep > b_sp)).astype(jnp.int32)) > 0
            go = (count > 0) & has_range & ~ovf
            if staged:
                go = go & (count * (SIGMA - 1) <= c)  # children surely fit
            return go

        def body(st):
            a_pos, b_sp, b_ep, count, values, counts, n_emit, ovf = st
            valid = lane_c < count
            values, counts, ovf = emit(values, counts, n_emit, ovf, a_pos,
                                       jnp.where(valid, b_ep - b_sp + 1, 0), c)
            n_emit = n_emit + count
            out_a, out_sp, out_ep, child_count = _expand_step(
                a_idx, b_idx, a_pos, b_sp, b_ep, valid)
            ovf = ovf | (child_count > c)
            child_count = jnp.minimum(child_count, c)
            return (out_a[:c], out_sp[:c], out_ep[:c], child_count,
                    values, counts, n_emit, ovf)

        return jax.lax.while_loop(cond, body, st)

    # ---- phase 0: small-capacity range loop — early depths have tiny
    # frontiers (<= (SIGMA-1)^depth) and must not pay full-frontier gathers
    cap0 = max(256, cap // 16)
    if cap0 < cap:
        st = ((jnp.zeros(cap0, jnp.int32) + zero).at[0].set(a_sequences + zero),
              jnp.zeros(cap0, jnp.int32).at[0].set(b_sp0),
              jnp.full(cap0, -1, jnp.int32).at[0].set(b_ep0),
              count0, values0, counts0, zero, zero != 0)
        a_p, b_s, b_e, count0, values0, counts0, n_emit0, ovf0 = \
            range_loop(cap0, st, staged=True)
        pad = cap - cap0
        a_pos0 = jnp.concatenate([a_p, jnp.zeros(pad, jnp.int32)])
        sp0 = jnp.concatenate([b_s, jnp.zeros(pad, jnp.int32)])
        ep0 = jnp.concatenate([b_e, jnp.full(pad, -1, jnp.int32)])
    else:
        a_pos0 = (jnp.zeros(cap, jnp.int32) + zero).at[0].set(a_sequences + zero)
        sp0 = jnp.zeros(cap, jnp.int32).at[0].set(b_sp0)
        ep0 = jnp.full(cap, -1, jnp.int32).at[0].set(b_ep0)
        n_emit0, ovf0 = zero, zero != 0

    # ---- phase 1: general range loop at full capacity, exits all-singleton
    st = (a_pos0, sp0, ep0, count0, values0, counts0, n_emit0, ovf0)
    a_pos, b_sp, b_ep, count, values, counts, n_emit, ovf = \
        range_loop(cap, st, staged=False)

    # ---- phase 2: singles only (every live node has b_ep == b_sp).
    # A singleton has exactly one child, so `count` is NON-INCREASING: the
    # phase runs as a capacity LADDER (cap -> cap/2 -> cap/4) — each stage's
    # loop exits once the frontier fits the next stage, which then runs the
    # same body on a sliced frontier.  Probes and compaction sorts are
    # O(lanes) per step, and fixed-length read collections keep ~|B-block|
    # singletons alive for most of the depth, so fitting the lane count to
    # the live count (callers size frontier_cap with fan-out headroom the
    # singles phase never needs) cuts the dominant loop's width 2x.

    def singles_stage(cap_s: int, next_cap: int, st):
        """Run the singles loop at `cap_s` lanes until the frontier fits
        `next_cap` (0 = run to completion) or overflow."""
        lane_s = jax.lax.broadcasted_iota(jnp.int32, (cap_s, 1), 0)[:, 0]

        def cond2(st):
            sa, spos, count, values, counts, n_emit, ovf = st
            return (count > next_cap) & ~ovf

        def body2(st):
            sa, spos, count, values, counts, n_emit, ovf = st
            live = lane_s < count
            values, counts, ovf = emit(values, counts, n_emit, ovf, sa,
                                       jnp.where(live, 1, 0), cap_s)
            n_emit = n_emit + count

            lf_b, c_b = b_idx.LF_step(spos)      # 1 row gather: child b-pos
            rows = a_idx.ranks_all(sa)           # 1 row gather: child a-pos
            child_a = (a_idx.C[c_b]
                       + jnp.take_along_axis(rows, c_b[:, None], axis=1)[:, 0])
            alive = live & (c_b != 0)

            key = jnp.where(alive, jnp.int32(0), jnp.int32(1))
            _, sa2, spos2 = jax.lax.sort((key, child_a, lf_b), num_keys=1,
                                         is_stable=False)
            return (sa2, spos2, jnp.sum(alive.astype(jnp.int32)),
                    values, counts, n_emit, ovf)

        return jax.lax.while_loop(cond2, body2, st)

    caps2 = [cap]
    while caps2[-1] // 2 >= 256 and len(caps2) < 3:
        caps2.append(caps2[-1] // 2)
    st2 = (a_pos, b_sp, count, values, counts, n_emit, ovf)
    for i, cap_s in enumerate(caps2):
        next_cap = caps2[i + 1] if i + 1 < len(caps2) else 0
        if i:  # live lanes are compacted at the front by every producer
            st2 = (st2[0][:cap_s], st2[1][:cap_s]) + st2[2:]
        st2 = singles_stage(cap_s, next_cap, st2)
    _, _, _, values, counts, n_emit, ovf = st2
    return values, counts, n_emit, ovf


# -- fully-jitted driver (multi-device / dryrun path) -------------------------


@functools.partial(jax.jit, static_argnames=("frontier_cap", "emit_cap"))
def wavefront_search_device(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                            b_sp0: jax.Array, b_ep0: jax.Array,
                            a_sequences: int,
                            frontier_cap: int = 4096,
                            emit_cap: int = 65536):
    """Whole search as one compiled program with static capacities.

    Returns (values int32[emit_cap], counts int32[emit_cap], n_emitted,
    overflowed).  Frontier wider than frontier_cap or emissions beyond
    emit_cap set the overflow flag (callers fall back to the host driver).
    Used inside shard_map where a host loop per device is impossible.
    """
    cap = frontier_cap

    # Seed every carry component from the (possibly device-varying) inputs so
    # the loop is valid under shard_map: a constant-initialized carry would be
    # "unvarying" while the body makes it varying (shard_map vma rules).
    zero = (b_sp0 * 0).astype(jnp.int32)
    a_pos0 = (jnp.zeros(cap, jnp.int32) + zero).at[0].set(a_sequences + zero)
    sp0 = jnp.zeros(cap, jnp.int32).at[0].set(b_sp0)
    ep0 = jnp.full(cap, -1, jnp.int32).at[0].set(b_ep0)
    count0 = jnp.where(b_ep0 >= b_sp0, jnp.int32(1), jnp.int32(0))

    values0 = jnp.zeros(emit_cap, jnp.int32) + zero
    counts0 = jnp.zeros(emit_cap, jnp.int32) + zero

    def cond(state):
        _, _, _, count, _, _, _, overflow = state
        return (count > 0) & ~overflow

    def body(state):
        a_pos, b_sp, b_ep, count, values, counts, n_emit, overflow = state
        lane = jax.lax.broadcasted_iota(jnp.int32, (cap, 1), 0)[:, 0]
        valid = lane < count

        # Emit the frontier as one contiguous window at offset n_emit: a
        # dynamic_update_slice (fast copy), not a scatter.  The tail beyond
        # `count` writes garbage that the NEXT emission overwrites; the final
        # tail past n_emit is never read.  Overflow guard: DUS clamps the
        # start when it would run past the buffer, corrupting earlier data —
        # detect and flag instead (callers discard on overflow).
        safe = n_emit + cap <= emit_cap
        start = jnp.where(safe, n_emit, 0)
        window = min(cap, emit_cap)  # degenerate emit_cap < cap overflows below
        values = jax.lax.dynamic_update_slice(values, a_pos[:window], (start,))
        counts = jax.lax.dynamic_update_slice(
            counts, (b_ep - b_sp + 1)[:window], (start,))
        new_emit = n_emit + count
        overflow = overflow | ~safe

        out_a, out_sp, out_ep, child_count = _expand_step(
            a_idx, b_idx, a_pos, b_sp, b_ep, valid)
        overflow = overflow | (child_count > cap)
        child_count = jnp.minimum(child_count, cap)
        return (out_a[:cap], out_sp[:cap], out_ep[:cap], child_count,
                values, counts, new_emit, overflow)

    state = (a_pos0, sp0, ep0, count0, values0, counts0,
             zero, zero != 0)
    a_pos, b_sp, b_ep, count, values, counts, n_emit, overflow = \
        jax.lax.while_loop(cond, body, state)
    return values, counts, n_emit, overflow


EXC_CAP = 8192       # byte-plane exception slots (gap/count > 254)
EXC4_CAP = 1 << 23   # >254-outlier slots shared by the nibble/q4 planes
# (96 MB device; only the bucketed used prefix ever crosses the link.
# Raised 64k -> 1M -> 8M in round 5: a sorted-unique stream of n values
# over a range R has at most R/254/e ~ 6.2M gaps > 254 at the uint32
# fold ceiling R = 4.29G (x * e^(-254x/R) maximizes at x = R/254), so 8M
# covers EVERY lane-blocked part of any in-range fold; the 1.6 Gbp fold
# had already measured ~87k and sparse 96M-lane parts of the 3.77 Gbp
# tier overflowed 1M.)
META_ROWS = 4        # byte-plane exc(3 rows) + scalar metadata(1 row)

# 4-bit pair-code table: codes 0-14 name the most frequent (delta, count)
# runs of RAW (uncompacted) rank-array streams — measured on 50 bp read
# merges at a 2:1 base ratio: delta 0 (a duplicate value; the pack ships
# compact=False) is ~32% of runs, the rest is a geometric delta tail with
# count almost always 1.  Code 15 escapes to a 1-byte nibble entry in a
# lane-ordered side stream.  98% of runs hit this table on the measured
# workload, so the plane costs ~0.52 B/run vs the nibble plane's 1 B/run.
# A mismatched workload only raises the escape rate; the consumer picks the
# cheapest plane per block from the measured counts.
Q4_PAIRS = ((0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (5, 1), (6, 1), (7, 1),
            (8, 1), (9, 1), (10, 1), (11, 1), (12, 1), (0, 2), (13, 1))
Q4_ESCAPE = 15
# numpy decode tables (escape slot holds 0; overwritten from the side stream)
Q4_TABLE_D = np.array([p[0] for p in Q4_PAIRS] + [0], dtype=np.int64)
Q4_TABLE_C = np.array([p[1] for p in Q4_PAIRS] + [0], dtype=np.int64)


@jax.jit
def compact_ra_device(values: jax.Array, counts: jax.Array, n: jax.Array):
    """Sort + duplicate-sum compaction of raw RA emissions ON DEVICE.

    The device analog of compact_rank_array (search_np.py:82-96) — the
    reference's RLArray sort+merge (support.h:416-453) — but with zero
    scatters: one value sort, a segment-head compaction sort, and gathers
    into the inclusive count cumsum recover per-unique-value sums.

    Returns (v int32[E], c int32[E], n_unique): strictly increasing unique
    a-positions in the first n_unique lanes (dead lanes int32-max / 0).
    """
    e = values.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (e, 1), 0)[:, 0]
    live = lane < n
    key = jnp.where(live, values, jnp.int32(2**31 - 1))
    v, c = jax.lax.sort((key, jnp.where(live, counts, 0)), num_keys=1,
                        is_stable=False)

    # segment heads of the sorted live prefix
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), v[:-1]])
    head = live & (v != prev)          # after sort, live lanes are [0, n)
    n_u = jnp.sum(head.astype(jnp.int32))

    # pack head lanes to the front: head lanes ascending = ascending value
    # order, and the lane keys are UNIQUE, so a cheap non-stable 2-operand
    # sort replaces a stable 3-operand one
    hkey = jnp.where(head, lane, jnp.int32(2**31 - 1))
    start, uv = jax.lax.sort((hkey, v), num_keys=1, is_stable=False)

    # segment sums by cumsum differences: segment k spans lanes
    # [start[k], end_k) where end_k = start[k+1] (or n for the last segment)
    cs = jnp.cumsum(c)                                  # inclusive, int32
    nxt = jnp.concatenate([start[1:], start[-1:]])
    end = jnp.where(lane == n_u - 1, n, nxt)
    cs_end = cs[jnp.clip(end - 1, 0, e - 1)]
    cs_before = jnp.where(start > 0, cs[jnp.clip(start - 1, 0, e - 1)], 0)
    uc = jnp.where(lane < n_u, cs_end - cs_before, 0)
    uv = jnp.where(lane < n_u, uv, jnp.int32(2**31 - 1))
    return uv, uc, n_u


@functools.partial(jax.jit, static_argnames=("compact",))
def pack_ra_device(values: jax.Array, counts: jax.Array, n: jax.Array,
                   compact: bool = True):
    """Sort (+ optionally compact) + delta/byte-pack the RA runs ON DEVICE.

    The RA stream is reduced before it crosses to the host.  Two packings
    are produced in one
    pass over the sorted runs:

    * byte planes (rows 0-1 of dc): u8 delta + u8 count, exceptions
      (delta/count > 254) in the `exc` table — 2 B/run, low exception rate
      on any workload;
    * nibble plane (row 2 of dc): delta (<= 14) in the low nibble, count
      (<= 15) in the high nibble — 1 B/run; escape lanes (any lane missing
      the Q4_PAIRS table, which includes every lane that does not fit a
      nibble) carry the marker byte 15 and spill their true (delta, count)
      to the 2-byte `esc` side stream shared with the pair-code plane.

    The consumer picks at runtime: pair-code plane when the halved plane
    pays for the extra reads, nibble plane otherwise, byte planes as the
    fallback.

    compact=True additionally sums duplicate a-positions on device
    (compact_ra_device) — two extra full-width sorts.  compact=False ships
    the raw sorted runs (duplicates encode as delta-0 entries) and lets the
    host's chunk consumers do the summing: the extra transfer hides
    behind the pipelined merge, so the streaming path wants
    compact=False.

    * pair-code plane (row 3 of dc, first E/2 bytes): 4-bit codes over the
      static Q4_PAIRS table — 0.5 B/run; misses (code 15) read their
      (delta u8, count u8) pair from the lane-ordered `esc` side stream.

    * esc side stream (u8[2, E]): one saturating (delta, count) byte pair
      per escape lane, lane-ordered; the pair (255, 255) marks a run that
      fits neither byte (delta or count > 254) and is overridden by its
      `exc4` row.  Replaced the old 1-byte nibble escape + full-width exc4
      table: the i32 exception table cost 12 B per merely-nibble-wide run
      (measured 12 MB/sequence-block of D2H on 50 bp read merges); now a
      wide run costs 2 B and exc4 holds only >254 outliers (typically 0).

    Returns (dc u8[4, E], exc i32[3, EXC_CAP], exc4 i32[3, EXC4_CAP],
    esc u8[2, E], n_packed, n_exc, n_exc4, n_esc2) — unpack with unpack_ra
    / unpack_ra4 / the native decoders on the host; n_exc > EXC_CAP means
    even the byte planes overflowed and the caller must fall back to the
    unpacked transfer.
    """
    if compact:
        v, c, n_u = compact_ra_device(values, counts, n)
    else:
        v, c = sort_ra_device(values, counts, n)
        n_u = n
    dc, exc, exc4, esc2, n_exc, n_exc4, n_esc2 = _pack_planes(v, c, n_u)
    return dc, exc, exc4, esc2, n_u, n_exc, n_exc4, n_esc2


def _pack_planes(v: jax.Array, c: jax.Array, n_u: jax.Array):
    """Delta/byte/nibble/pair-code packing of SORTED runs (the tail of
    pack_ra_device, shared with the walk path's presorted emissions).

    v must be ascending in the first n_u lanes with int32-max beyond;
    returns (dc, exc, exc4, esc2, n_exc, n_exc4, n_esc2)."""
    e = v.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (e, 1), 0)[:, 0]
    live = lane < n_u
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), v[:-1]])
    delta = jnp.where(live, v - prev, 0)  # delta[0] = values[0]
    cnt = jnp.where(live, c, 0)

    # delta < 0 = a uint32 value wrapped into int32 (sorted-unique rank
    # arrays never have negative deltas): totals beyond 2^31 (the k-way
    # fold's summed rank arrays, ops/kfold_jax.py) ride the int32 lanes as
    # wraparound uint32 — such deltas are "wide" by definition and their
    # int32-negative exception entries are re-read as uint32 on the host
    wide = live & ((delta > 254) | (delta < 0) | (cnt > 254))
    d8 = jnp.where(wide, 255, jnp.minimum(delta, 254)).astype(jnp.uint8)
    c8 = jnp.where(wide, 255, jnp.minimum(cnt, 254)).astype(jnp.uint8)

    n_exc = jnp.sum(wide.astype(jnp.int32))
    # the <= EXC_CAP wide lanes via binary search on the running count of
    # wide lanes (EXC_CAP queries over the cumsum, in place of a top_k) —
    # comes out SORTED by lane, so the host skips its argsort
    k = min(EXC_CAP, e)
    cs = jnp.cumsum(wide.astype(jnp.int32))
    slots = jnp.arange(1, k + 1, dtype=jnp.int32)
    lane_w = jnp.searchsorted(cs, slots).astype(jnp.int32) if e else slots * 0
    valid = jnp.arange(k, dtype=jnp.int32) < n_exc
    safe = jnp.where(valid, lane_w, 0)
    exc_idx = jnp.where(valid, lane_w, -1)  # -1 in unused slots (never read)
    exc_delta = jnp.where(valid, delta[safe], 0)
    exc_count = jnp.where(valid, cnt[safe], 0)

    # escape set: every live lane missing the 4-bit pair-code table.  The
    # same set (and the same 2-byte side stream) serves both the pair-code
    # plane (code 15) and the nibble plane (marker byte 15) — table misses
    # that would still fit a nibble pay 2 stream bytes instead of 1 inline
    # byte (~2% of runs on measured read merges), and in exchange the i32
    # exception table shrinks to >254 outliers only.
    code = jnp.full_like(delta, Q4_ESCAPE)
    for kq, (dd, cc) in enumerate(Q4_PAIRS):
        code = jnp.where((delta == dd) & (cnt == cc), kq, code)
    code = jnp.where(live, code, 0).astype(jnp.uint8)
    esc_lane = live & (code == Q4_ESCAPE)
    n_esc2 = jnp.sum(esc_lane.astype(jnp.int32))

    # nibble plane: delta | count << 4 for table hits (hits have delta <= 13
    # and count <= 2, so they always fit and the low nibble is never 15);
    # the unambiguous marker byte 15 for escape lanes
    nib = jnp.where(live,
                    jnp.where(esc_lane, 15, delta | (cnt << 4)),
                    0).astype(jnp.uint8)

    # 2-byte escape stream: saturating (delta, count) byte pairs for the
    # escape lanes in lane order; (255, 255) marks a >254 outlier resolved
    # by its exc4 row.  One non-stable 3-operand sort compacts the lanes.
    fits8 = (delta <= 254) & (delta >= 0) & (cnt <= 254)
    d8e = jnp.where(fits8, delta, 255).astype(jnp.uint8)
    c8e = jnp.where(fits8, cnt, 255).astype(jnp.uint8)
    ekey = jnp.where(esc_lane, lane, jnp.int32(2**31 - 1))
    _, esc_d, esc_c = jax.lax.sort((ekey, d8e, c8e), num_keys=1,
                                   is_stable=False)
    esc2 = jnp.stack([esc_d, esc_c])  # [2, E]

    e2 = e + (e & 1)  # pair the codes; odd emit caps pad one dead lane
    code2 = jnp.pad(code, (0, e2 - e))
    if e2 % 512 == 0:
        # wide-row pairing: a [e/2, 2] reshape gets its minor dim tile-
        # padded 2 -> 128 (64x, 32 GB materialized at the k-way fold's
        # 128M emit cap — AOT refused the allocation); strided slices of
        # 512-wide rows keep every temp at clean [e/512, 256] tiles and
        # preserve pair order (row r holds codes 512r..512r+511)
        c2 = code2.reshape(-1, 512)
        q4 = (c2[:, 0::2] | (c2[:, 1::2] << 4)).astype(jnp.uint8).reshape(-1)
    else:
        cpair = code2.reshape(e2 // 2, 2)
        q4 = (cpair[:, 0] | (cpair[:, 1] << 4)).astype(jnp.uint8)
    q4row = jnp.pad(q4, (0, e - q4.shape[0]))  # dc rows are E wide
    # exc4 now holds ONLY the >254 outliers (statistically ~0 on genomic
    # rank arrays; structural outliers like giant endmarker gaps are few)
    wide8 = live & ~fits8
    n_exc4 = jnp.sum(wide8.astype(jnp.int32))
    k4 = min(EXC4_CAP, max(e, 1))
    # outlier lanes by binary search on the running count of wide lanes
    # (k4 queries over the cumsum): with the 2-byte escape stream carrying
    # everything <= 254, outliers are so rare that the query count dropped
    # from 1M to 64k and the searchsorted (~0.06 s at 67M lanes) beats the
    # full-width 3-operand sort (~0.27 s) it replaces.  Comes out SORTED
    # by lane, as the decoders require.
    cs4 = jnp.cumsum(wide8.astype(jnp.int32))
    slots4 = jnp.arange(1, k4 + 1, dtype=jnp.int32)
    lane4 = (jnp.searchsorted(cs4, slots4).astype(jnp.int32)
             if e else slots4 * 0)
    valid4 = jnp.arange(k4, dtype=jnp.int32) < n_exc4
    safe4 = jnp.where(valid4, lane4, 0)
    exc4_idx = jnp.where(valid4, lane4, -1)
    exc4_delta = jnp.where(valid4, delta[safe4], 0)
    exc4_count = jnp.where(valid4, cnt[safe4], 0)

    # single-buffer outputs: each device->host transfer pays a fixed
    # latency, so the planes and each exception table ship as ONE
    # array each (the consumer slices the plane it chose)
    dc = jnp.stack([d8, c8, nib, q4row])                       # [4, E] u8

    def fit(x, cap):  # degenerate emit caps smaller than cap pad with zeros
        return x[:cap] if x.shape[0] >= cap else jnp.pad(x, (0, cap - x.shape[0]))

    exc = jnp.stack([fit(exc_idx, EXC_CAP), fit(exc_delta, EXC_CAP),
                     fit(exc_count, EXC_CAP)])
    # the outlier table is emit-cap-adaptive: n_exc4 <= n <= e always fits
    # a width-e table, so small packs need not pad to the 8M worst-case
    # (a fixed EXC4_CAP pad cost ~100 MB and minutes of virtual-mesh CPU
    # compile per tiny program)
    exc4 = jnp.stack([fit(exc4_idx, k4), fit(exc4_delta, k4),
                      fit(exc4_count, k4)])
    return dc, exc, exc4, esc2, n_exc, n_exc4, n_esc2


@functools.partial(jax.jit, static_argnames=("frontier_cap", "emit_cap"))
def search_and_pack(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                    b_sp0: jax.Array, b_ep0: jax.Array, a_sequences: int,
                    frontier_cap: int, emit_cap: int):
    """Whole search + compaction + transfer packing with scalar metadata
    folded into the exception buffer: the host needs exactly TWO device reads
    (meta+exc, then the chosen plane sliced to n) instead of five round trips.

    Returns (dc uint8[4, emit_cap], meta_exc int32[4, EXC_CAP],
    exc4 int32[3, EXC4_CAP], esc uint8[2, emit_cap]): rows 0-2 of meta_exc
    are the byte-plane exception table, row 3 is (n_packed, n_exceptions,
    overflowed, n_exc4, n_esc2).  exc4 (the >254-outlier table) and esc
    (the planes' shared 2-byte escape stream) STAY ON DEVICE and are
    fetched sliced to bucketed lengths.  The host picks the cheapest valid
    plane per block: pair-code (dc row 3, 0.5 B/run + 2 B/escape), nibble
    (dc row 2, 1 B/run + 2 B/escape), byte planes (dc rows 0-1, 2 B/run).
    The packed runs are SORTED by a-position but may repeat values
    (compact=False — duplicate summing costs two extra full-width device
    sorts and is done by the host chunk consumers instead).
    """
    v, c, n, ovf = wavefront_search_device2(
        a_idx, b_idx, b_sp0, b_ep0, a_sequences,
        frontier_cap=frontier_cap, emit_cap=emit_cap)
    dc, exc, exc4, esc, n_u, n_exc, n_exc4, n_esc2 = pack_ra_device(
        v, c, n, compact=False)
    meta = jnp.zeros((1, EXC_CAP), jnp.int32)
    meta = meta.at[0, 0].set(n_u).at[0, 1].set(n_exc)
    meta = meta.at[0, 2].set(ovf.astype(jnp.int32)).at[0, 3].set(n_exc4)
    meta = meta.at[0, 4].set(n_esc2)
    return dc, jnp.concatenate([exc, meta], axis=0), exc4, esc


def _meta_fields(meta_exc):
    """(n, n_exc, overflowed, n_exc4, n_esc2) from a host meta buffer
    (4 rows: byte-plane exception table + scalar metadata row).

    `overflowed` here is the BYTE-PLANE-ONLY verdict (emission overflow or
    a truncated byte exception table); callers holding the exc4/esc side
    streams should use `packed_overflowed` instead — the nibble/pair-code
    planes stay decodable from exc4 alone long after n_exc passes EXC_CAP
    (large sparse rank spaces: a 714 Mbp base put ~5x EXC_CAP wide gaps in
    a 50M-run block, which is business as usual, not an overflow)."""
    n = int(meta_exc[3, 0])
    n_exc = int(meta_exc[3, 1])
    overflowed = bool(meta_exc[3, 2]) or n_exc > EXC_CAP
    n_exc4 = int(meta_exc[3, 3]) if meta_exc.shape[1] > 3 else 0
    n_esc2 = int(meta_exc[3, 4]) if meta_exc.shape[1] > 4 else 0
    return n, n_exc, overflowed, n_exc4, n_esc2


def packed_overflowed(meta_exc, have_side: bool) -> bool:
    """True when a packed RA is NOT decodable: the device search flagged a
    real emission overflow, or no transfer plane's exception table covers
    it (byte needs n_exc <= EXC_CAP; nib/q4 need the exc4/esc side streams
    and n_exc4 <= EXC4_CAP)."""
    n, n_exc, _, n_exc4, _ = _meta_fields(meta_exc)
    if bool(meta_exc[3, 2]):
        return True
    byte_ok = n_exc <= EXC_CAP
    side_ok = have_side and n_exc4 <= EXC4_CAP
    return not (byte_ok or side_ok)


@functools.partial(jax.jit, static_argnames=("length",))
def _cut_exc4(x, length):
    return jax.lax.slice(x, (0, 0), (3, length))


def _exc4_bucket(n_exc4: int, cap: int) -> int:
    """Power-of-two prefix length covering the first n_exc4 exception rows
    (bounded by the table width) — shared by fetch/dispatch/prefetch so a
    pre-dispatched prefix is found by exact length."""
    k = 1 << 10
    while k < n_exc4 and k < cap:
        k *= 2
    return min(k, cap)


def dispatch_exc4(exc4_dev, n_exc4: int, presliced=None):
    """Dispatch (or find pre-dispatched) the bucketed exc4 prefix and START
    its D2H copy; returns the device array to np.asarray later.  Splitting
    dispatch from wait lets callers overlap this transfer with the plane
    windows' (each synchronous fetch otherwise pays a full round trip)."""
    if n_exc4 == 0:
        return None
    cap = exc4_dev.shape[1]
    s = _pick_presliced(presliced, n_exc4, cap)
    if s is None:
        k = _exc4_bucket(n_exc4, cap)
        s = exc4_dev if k >= cap else _cut_exc4(exc4_dev, k)
    s.copy_to_host_async()
    return s


@functools.partial(jax.jit, static_argnames=("length",))
def _cut_esc(x, length):
    return jax.lax.slice(x, (0, 0), (2, length))


def _esc_bucket(n_esc2: int, cap: int) -> int:
    """Power-of-two prefix length covering the first n_esc2 escape pairs
    (bounded by the buffer) — shared by dispatch_esc and the blocked
    prefetcher so a pre-dispatched prefix is found by exact length."""
    k = 1 << 10
    while k < n_esc2 and k < cap:
        k *= 2
    return min(k, cap)


def _pick_presliced(presliced, need: int, cap: int):
    """Smallest pre-dispatched prefix covering `need` entries, if any —
    lets a sparse bucket ladder (or a single eagerly-copied prefix) serve
    every smaller request without dispatching a new device program (which
    would queue behind whatever search is currently running)."""
    if not presliced:
        return None
    ks = sorted(k for k in presliced if k >= need or k >= cap)
    return presliced[ks[0]] if ks else None


def dispatch_esc(esc_dev, n_esc2: int, presliced=None):
    """Dispatch (or find pre-dispatched) the bucketed escape-stream prefix
    and START its D2H copy; returns the device array to np.asarray later."""
    if n_esc2 == 0:
        return None
    cap = esc_dev.shape[1]
    s = _pick_presliced(presliced, n_esc2, cap)
    if s is None:
        k = _esc_bucket(n_esc2, cap)
        s = esc_dev if k >= cap else _cut_esc(esc_dev, k)
    s.copy_to_host_async()
    return s


# Minimum transfer-byte saving before the pair-code plane is preferred over
# the nibble plane: both planes read the same 2-byte escape stream, so q4's
# saving is exactly n/2 plane bytes — only worth the extra round trips
# on the half-width windows once it clears this.  (Plane choice is per block
# at runtime; tests force a plane explicitly.)
Q4_MIN_SAVE = 4 << 20


def _choose_plane(dc8, n: int, n_exc4: int, n_esc2: int,
                  exc4, esc, plane: str | None = None,
                  byte_ok: bool = True) -> str:
    """Pick the cheapest valid transfer plane for a packed RA block:
    'q4' (0.5 B/run + 2 B/escape), 'nib' (1 B/run + 2 B/escape),
    'byte' (2 B/run).  byte_ok=False bars the byte plane (its exception
    table is truncated past EXC_CAP wide runs)."""
    if plane is not None:
        return plane
    nib_ok = (exc4 is not None and esc is not None and n_exc4 <= EXC4_CAP
              and dc8.shape[0] > 2)
    q4_ok = nib_ok and dc8.shape[0] > 3 and dc8.shape[1] % 2 == 0
    if q4_ok and (n // 2 > Q4_MIN_SAVE or not byte_ok):
        return "q4"
    if nib_ok:
        return "nib"
    if not byte_ok:
        # no nibble plane AND the byte plane's exception table is truncated:
        # decoding would silently return wrong runs, so refuse here (every
        # consumer — unpack_search included — must see this, not just
        # stream_packed_ra's own guard)
        raise ValueError(
            "byte plane cannot cover its exception table and no nibble "
            "plane exists for this packed RA")
    return "byte"


def unpack_search(dc8, meta_exc, exc4=None, esc=None, plane=None) -> tuple:
    """Host side of search_and_pack -> (values, counts, overflowed).

    Two device reads (three when the nibble plane is chosen and exc4 is
    non-empty, four for the pair-code plane): the metadata/exception buffer
    first (this also blocks on the search compute), then the chosen plane
    sliced ON DEVICE to a bucketed length >= n — shipping the full emit-cap
    padding can double the transfer.  The bucket sizes ({2^k, 3*2^(k-2)},
    <=33% waste) keep the slice program cache small."""
    meta_exc = jax.device_get(meta_exc)
    n, n_exc, _ovf_byte, n_exc4, n_esc2 = _meta_fields(meta_exc)
    if packed_overflowed(meta_exc, exc4 is not None and esc is not None):
        return np.zeros(0, np.int64), np.zeros(0, np.int64), True
    plane = _choose_plane(dc8, n, n_exc4, n_esc2, exc4, esc, plane,
                          byte_ok=n_exc <= EXC_CAP)
    cap = dc8.shape[1]
    k = 1 << 10
    while k < n:
        k *= 2
    if k // 4 * 3 >= n:
        k = k // 4 * 3
    k = min(k, cap)
    if plane == "q4":
        exc4_dev = dispatch_exc4(exc4, n_exc4)  # async: overlaps plane fetch
        esc_dev = dispatch_esc(esc, n_esc2)
        kb = min(max(1, (k + 1) // 2), cap)
        q4b = jax.device_get(dc8[3, :kb] if kb < cap else dc8[3])
        v, c = unpack_ra_q4(
            q4b,
            np.asarray(esc_dev) if esc_dev is not None else np.zeros((2, 0), np.uint8),
            np.asarray(exc4_dev) if exc4_dev is not None else np.zeros((3, 0), np.int32),
            n, n_exc4)
    elif plane == "nib":
        exc4_dev = dispatch_exc4(exc4, n_exc4)
        esc_dev = dispatch_esc(esc, n_esc2)
        nib = jax.device_get(dc8[2, :k] if k < cap else dc8[2])
        v, c = unpack_ra4(
            nib,
            np.asarray(esc_dev) if esc_dev is not None else np.zeros((2, 0), np.uint8),
            np.asarray(exc4_dev) if exc4_dev is not None else np.zeros((3, 0), np.int32),
            n, n_exc4)
    else:
        dc8 = jax.device_get(dc8[:2, :k] if k < cap else dc8[:2])
        v, c = unpack_ra(dc8[:, :n], meta_exc, n, n_exc)
    # the packed runs are sorted but not deduplicated (pack compact=False);
    # one linear host pass restores the sorted-unique contract
    from .search_np import compact_sorted_rank_array

    v, c = compact_sorted_rank_array(v, c)
    return v, c, False


@functools.partial(jax.jit, static_argnames=("length",))
def _cut_chunk(x, start, length):
    """Module-level jitted window slice: a closure-local jit would retrace
    (and recompile) on every stream_packed_ra call."""
    return jax.lax.dynamic_slice(x, (jnp.int32(0), start), (2, length))


@functools.partial(jax.jit, static_argnames=("length",))
def _cut_chunk_nib(x, start, length):
    """Window slice of the nibble plane (row 2) only — 1 B/run over the
    host link instead of the byte planes' 2 B/run."""
    return jax.lax.dynamic_slice(x, (jnp.int32(2), start), (1, length))


@functools.partial(jax.jit, static_argnames=("length",))
def _cut_chunk_q4(x, byte_start, length):
    """Window slice of the pair-code plane (row 3) in BYTES — 0.5 B/run;
    the row is emit-cap wide while only ceil(n/2) bytes carry data, so a
    chunk/2-byte window never clamps."""
    return jax.lax.dynamic_slice(x, (jnp.int32(3), byte_start), (1, length))


@functools.partial(jax.jit,
                   static_argnames=("chunk", "esc_rungs", "exc4_rungs"))
def _grid_program(dc8, esc, exc4, chunk: int,
                  esc_rungs: tuple, exc4_rungs: tuple):
    """EVERY slice the blocked consumer may copy, as ONE device program:
    the q4 window grid plus the side-stream ladder rungs: one dispatch
    per block instead of ~25 separate slice programs queued between the
    blocks' searches."""
    cap = dc8.shape[1]
    q4 = [jax.lax.dynamic_slice(dc8, (jnp.int32(3), jnp.int32(s // 2)),
                                (1, chunk // 2))
          for s in range(0, cap, chunk)]
    esc_l = [jax.lax.slice(esc, (0, 0), (2, k)) for k in esc_rungs]
    exc4_l = [jax.lax.slice(exc4, (0, 0), (3, k)) for k in exc4_rungs]
    return q4, esc_l, exc4_l


def stream_packed_ra(dc8, meta_exc, exc4=None,
                     chunk_runs: int = 4 * 1024 * 1024,
                     presliced=None, esc=None, plane=None):
    """Generator of ascending sorted-unique (values, counts) chunks straight
    from a packed device RA (search_and_pack output) — the transfer/merge
    pipeline: chunk k+1's device->host copy is issued asynchronously while
    the consumer (interleave + writer) processes chunk k, hiding the
    transfer behind the host merge.

    The device analog of the reference's producer/consumer RABuffer channel
    (bwt.cpp:152-190): the single-slot swap becomes an in-flight async copy.
    Raises ValueError on overflow (callers should have checked meta first).
    """
    meta_exc = jax.device_get(meta_exc)
    n, n_exc, _ovf_byte, n_exc4, n_esc2 = _meta_fields(meta_exc)
    have_side = exc4 is not None and esc is not None
    if packed_overflowed(meta_exc, have_side):
        raise ValueError(
            "packed RA overflowed its device buffers "
            f"(n={n}, n_exc={n_exc}, ovf_flag={int(meta_exc[3, 2])}, "
            f"n_exc4={n_exc4}, n_esc2={n_esc2}, caps: exc={EXC_CAP}, "
            f"exc4={EXC4_CAP})")
    if n == 0:
        return
    if presliced is not None and not isinstance(presliced, dict):
        presliced = {"nib": presliced}  # legacy (slices, chunk) tuple
    plane = _choose_plane(dc8, n, n_exc4, n_esc2, exc4, esc, plane,
                          byte_ok=n_exc <= EXC_CAP)
    if plane == "byte" and n_exc > EXC_CAP:
        raise ValueError("byte plane cannot cover its exception table "
                         f"({n_exc} wide runs > {EXC_CAP} slots)")

    cap = dc8.shape[1]
    grid = (presliced or {}).get(plane)
    if grid is not None:
        # pre-dispatched static plane grid (BlockedPackedRA): the slice
        # programs already ran right after this block's search, so their
        # D2H DMA can overlap the NEXT block's search compute
        chunk = grid[1]
        starts = list(range(0, n, chunk))
        dev_starts = starts
        slices = list(grid[0][:len(starts)])
    else:
        chunk = min(chunk_runs, cap)
        if plane == "q4":
            # two runs per byte: even windows keep every lane's nibble
            # parity equal to its window-relative parity
            chunk = max(2, chunk - (chunk & 1))
        # dynamic_slice clamps the start when start+chunk > cap: issue the
        # last window at cap-chunk and compensate with a host-side offset
        # (cap and chunk are both even on the q4 plane, so the clamped
        # starts stay nibble-aligned)
        starts = list(range(0, n, chunk))
        dev_starts = [min(s, cap - chunk) for s in starts]
        if plane == "q4":
            slices = [_cut_chunk_q4(dc8, jnp.int32(s // 2), chunk // 2)
                      for s in dev_starts]
        elif plane == "nib":
            slices = [_cut_chunk_nib(dc8, jnp.int32(s), chunk)
                      for s in dev_starts]
        else:
            slices = [_cut_chunk(dc8, jnp.int32(s), chunk)
                      for s in dev_starts]
    # dispatch the side-stream prefixes FIRST (async copies), then every
    # chunk's D2H copy: they stream back-to-back (a synchronous side
    # fetch before the windows would serialize a full round trip ahead
    # of the first chunk); host-side peak is the same 0.5-2 B/run the
    # consumer retires in order
    exc4_dev = (dispatch_exc4(exc4, n_exc4, (presliced or {}).get("exc4"))
                if plane != "byte" else None)
    esc_dev = (dispatch_esc(esc, n_esc2, (presliced or {}).get("esc"))
               if plane != "byte" else None)
    for s in slices:
        s.copy_to_host_async()

    if plane == "byte":
        exc_idx = meta_exc[0, :n_exc].astype(np.int64)
        exc_delta = _u32_delta(meta_exc[1, :n_exc])
        exc_count = meta_exc[2, :n_exc]
        order = np.argsort(exc_idx, kind="stable")
        exc_idx, exc_delta, exc_count = (exc_idx[order], exc_delta[order],
                                         exc_count[order])
    else:
        # exc4 indices come out of the device pack already sorted by lane
        exc4_h = (np.asarray(exc4_dev) if exc4_dev is not None
                  else np.zeros((3, 0), np.int32))
        exc_idx = exc4_h[0, :n_exc4].astype(np.int64)
        exc_delta = _u32_delta(exc4_h[1, :n_exc4])
        exc_count = exc4_h[2, :n_exc4]
    esc_h = None
    if plane != "byte":
        esc_h = (np.asarray(esc_dev) if esc_dev is not None
                 else np.zeros((2, 0), np.uint8))

    native_decode = None
    if plane != "byte":
        try:
            if plane == "q4":
                from ..native import ra_decode_q4_chunk as native_decode
            else:
                from ..native import ra_decode_nib_chunk as native_decode
        except Exception:  # pragma: no cover - native build unavailable
            native_decode = None

    # state: {carry, pend_v, pend_c, have_pend, esc_off} — the trailing run
    # is withheld until the last window so cross-chunk duplicates merge
    dec_state = np.zeros(5, np.int64)
    carry = 0
    esc_off = 0  # numpy-path equivalent of dec_state[4]
    pend_v = pend_c = None  # numpy-path equivalent of dec_state[1:]
    for k, s in enumerate(starts):
        h = np.asarray(slices[k])
        slices[k] = None  # release the device slice + its host copy
        off = s - dev_starts[k]
        m = min(chunk, n - s)
        lo = np.searchsorted(exc_idx, s)
        hi = np.searchsorted(exc_idx, s + m)
        finish = k + 1 == len(starts)
        if native_decode is not None:
            # fused native sweep: plane split + exception patch + cumsum +
            # duplicate-sum in one GIL-released pass (native/src/radecode.cpp)
            if plane == "q4":
                uv, uc = native_decode(
                    h[0, off // 2:(off + m + 1) // 2], m, esc_h,
                    exc_idx[lo:hi] - s, exc_delta[lo:hi], exc_count[lo:hi],
                    dec_state, finish, Q4_TABLE_D, Q4_TABLE_C)
            else:
                uv, uc = native_decode(h[0, off:off + m], esc_h,
                                       exc_idx[lo:hi] - s,
                                       exc_delta[lo:hi], exc_count[lo:hi],
                                       dec_state, finish=finish)
            if uv.size:
                yield uv, uc
            continue
        if plane == "q4":
            hb = h[0, off // 2:(off + m + 1) // 2]
            codes = np.empty(hb.size * 2, np.uint8)
            codes[0::2] = hb & np.uint8(15)
            codes[1::2] = hb >> 4
            codes = codes[:m]
            delta = Q4_TABLE_D[codes]
            counts = Q4_TABLE_C[codes]
            em = codes == Q4_ESCAPE
            ke = int(em.sum())
            eb = esc_h[:, esc_off:esc_off + ke]
            if eb.shape[1] != ke:
                raise ValueError("pair-code escape stream exhausted "
                                 "(corrupt packed RA)")
            esc_off += ke
            delta[em] = eb[0].astype(np.int64)
            counts[em] = eb[1].astype(np.int64)
        elif plane == "nib":
            nib = h[0, off:off + m]
            delta = (nib & np.uint8(15)).astype(np.int64)
            counts = (nib >> 4).astype(np.int64)
            em = (nib & np.uint8(15)) == 15
            ke = int(em.sum())
            eb = esc_h[:, esc_off:esc_off + ke]
            if eb.shape[1] != ke:
                raise ValueError("nibble escape stream exhausted "
                                 "(corrupt packed RA)")
            esc_off += ke
            delta[em] = eb[0].astype(np.int64)
            counts[em] = eb[1].astype(np.int64)
        else:
            delta = h[0, off:off + m].astype(np.int64)
            counts = h[1, off:off + m].astype(np.int64)
        if hi > lo:
            loc = exc_idx[lo:hi] - s
            delta[loc] = exc_delta[lo:hi]
            counts[loc] = exc_count[lo:hi]
        values = np.cumsum(delta) + carry
        carry = int(values[-1])
        # the packed runs repeat values (device pack skips the compaction
        # sorts); sum duplicates in one linear pass per chunk
        head = np.empty(m, np.bool_)
        head[0] = True
        np.not_equal(values[1:], values[:-1], out=head[1:])
        starts_u = np.flatnonzero(head)
        uv = values[starts_u]
        uc = np.add.reduceat(counts, starts_u)
        if pend_v is not None:
            if uv[0] == pend_v:
                uc[0] += pend_c
            else:
                uv = np.concatenate([[pend_v], uv])
                uc = np.concatenate([[pend_c], uc])
        if k + 1 < len(starts):
            pend_v, pend_c = int(uv[-1]), int(uc[-1])
            uv, uc = uv[:-1], uc[:-1]
            if uv.size == 0:
                continue
        yield uv, uc


class PackedDeviceRA:
    """A finished search result left ON DEVICE in packed byte-plane form.

    Duck-types the RankArraySpill consumption surface (stream / finish /
    n_spill_files) so merge_fmi / merge_fmi_to_file can consume the rank
    array without ever materializing it on the host: `stream()` yields
    ascending chunks whose device->host copies are issued one chunk ahead
    of the consumer (stream_packed_ra), so the transfer hides behind the
    interleave.  The device analog of the reference's
    producer/consumer RABuffer hand-off (bwt.cpp:152-190).
    """

    prefer_stream = True      # consumers should use stream(), not finish()
    n_spill_files = 0
    total_spilled_bytes = 0

    def __init__(self, dc8, meta_exc, exc4=None, esc=None):
        self.dc8 = dc8
        self.exc4 = exc4
        self.esc = esc
        self.meta = jax.device_get(meta_exc)  # blocks on the search compute

    @property
    def overflowed(self) -> bool:
        return packed_overflowed(
            self.meta, self.exc4 is not None and self.esc is not None)

    @property
    def n_runs(self) -> int:
        return int(self.meta[3, 0])

    @property
    def plane(self) -> str:
        """Transfer plane the consumers will pick ('q4'/'nib'/'byte')."""
        n, n_exc, ovf, n_exc4, n_esc2 = _meta_fields(self.meta)
        return _choose_plane(self.dc8, n, n_exc4, n_esc2, self.exc4, self.esc,
                             byte_ok=n_exc <= EXC_CAP)

    def stream(self, chunk_runs: int | None = None):
        if chunk_runs is None:
            # aim for ~8 in-flight windows so the D2H copy of chunk k+1
            # hides behind the interleave of chunk k, but keep the sizes
            # bucketed ({1,2,4} M runs) — each distinct window length
            # compiles its own slice program
            target = max(1, self.n_runs // 8)
            chunk_runs = 1024 * 1024
            while chunk_runs * 2 <= target and chunk_runs < 4 * 1024 * 1024:
                chunk_runs *= 2
        return stream_packed_ra(self.dc8, self.meta, self.exc4, chunk_runs,
                                esc=self.esc)

    def finish(self):
        parts = list(self.stream())
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))


class BlockedPackedRA:
    """Packed per-sequence-block search results left ON DEVICE, consumed as
    one ascending sorted-unique chunk stream.

    The device executes programs in dispatch order, so blocked_search_and_pack
    dispatches each block's search IMMEDIATELY followed by a static grid of
    nibble-plane slice programs over its packed buffer: block k's slices are
    computed before block k+1's search starts.  A prefetch thread then reads
    each block's metadata as it lands and issues the D2H copies for the live
    windows — pure DMA against already-computed arrays, overlapping block
    k+1's search COMPUTE with block k's chunk TRANSFERS.  This overlaps the
    search and transfer phases the way the reference overlaps its search and
    merge threads (fmi.cpp:351-357, bwt.cpp:286-298), but across sequence
    blocks on one device.  Blocks partition B's sequences, so each stream is
    ascending sorted; merge_ra_chunk_streams sums the duplicate a-positions
    across block boundaries.

    NOTE: `overflowed` blocks on EVERY block's search — prefer consuming
    stream() and catching ValueError before the first chunk (the k-way merge
    reads every block's meta before yielding anything, so overflow always
    surfaces before any output is produced).
    """

    prefer_stream = True
    n_spill_files = 0
    total_spilled_bytes = 0
    CHUNK = 2 * 1024 * 1024

    def __init__(self, parts):
        # [(dc8, meta_exc dev, exc4 dev, esc dev, {plane: (slices, chunk),
        #   "esc": {bucket: prefix}})] — unread; shorter tuples (no escape
        # stream / no pre-dispatched slice grid) are padded with None
        self.parts = [(*p, *([None] * (5 - len(p)))) for p in parts]
        self._metas = [None] * len(self.parts)
        self._prefetcher = None

    def _meta(self, i):
        if self._metas[i] is None:
            self._metas[i] = jax.device_get(self.parts[i][1])
        return self._metas[i]

    @property
    def overflowed(self) -> bool:
        return any(
            packed_overflowed(self._meta(i),
                              self.parts[i][2] is not None
                              and self.parts[i][3] is not None)
            for i in range(len(self.parts)))

    @property
    def n_runs(self) -> int:
        return sum(int(self._meta(i)[3, 0]) for i in range(len(self.parts)))

    def _prefetch(self):
        """Issue each block's live-window D2H copies the moment its meta
        lands; jax.Array caches the host copy, so the consumer's later
        np.asarray reuses the transfer instead of re-fetching."""
        for i, part in enumerate(self.parts):
            dc8, _m, exc4, esc, sliced = part
            try:
                m = self._meta(i)
            except Exception:
                return
            n, n_exc, _ovf_byte, n_exc4, n_esc2 = _meta_fields(m)
            if sliced is None or packed_overflowed(
                    m, exc4 is not None and esc is not None):
                continue
            plane = _choose_plane(dc8, n, n_exc4, n_esc2, exc4, esc,
                                  byte_ok=n_exc <= EXC_CAP)
            # side streams first: the consumer needs them before it can
            # decode ANY window, and the ladders were dispatched right
            # after this block's search (blocked_search_and_pack), so these
            # copies are pure DMA — a lazily dispatched slice program here
            # would queue BEHIND the next block's search and gate the whole
            # merge on it
            if plane != "byte" and n_exc4:
                dispatch_exc4(exc4, n_exc4, sliced.get("exc4"))
            if plane != "byte" and n_esc2:
                dispatch_esc(esc, n_esc2, sliced.get("esc"))
            grid = sliced.get(plane)
            if grid is None:
                continue
            slices, chunk = grid
            for s in slices[:(n + chunk - 1) // chunk]:
                s.copy_to_host_async()

    def start_prefetch(self):
        if self._prefetcher is None:
            import threading

            self._prefetcher = threading.Thread(target=self._prefetch,
                                                daemon=True)
            self._prefetcher.start()

    def stream(self, chunk_runs: int = CHUNK):
        from ..models.spill import merge_ra_chunk_streams
        from ..utils.pipeline import prefetch_chunks

        self.start_prefetch()
        # each block's decode (device window waits + native plane decode)
        # runs on its OWN thread: the k-way merge thread then only merges —
        # serializing k decodes behind the merge doubled the blocked merge
        # window vs the single-block path
        return merge_ra_chunk_streams(
            [prefetch_chunks(
                stream_packed_ra(dc8,
                                 self._metas[i] if self._metas[i] is not None
                                 else meta, exc4, chunk_runs,
                                 presliced=sliced, esc=esc),
                depth=2)
             for i, (dc8, meta, exc4, esc, sliced) in enumerate(self.parts)],
            chunk_runs=chunk_runs)

    def finish(self):
        parts = list(self.stream())
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))


def blocked_search_and_pack(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                            a_sequences: int, b_sequences: int,
                            n_blocks: int, frontier_cap: int, emit_cap: int,
                            chunk_runs: int = BlockedPackedRA.CHUNK,
                            block_emit_bound: int | None = None
                            ) -> BlockedPackedRA:
    """Dispatch one search_and_pack program per sequence block plus its
    pair-code slice grid and side-stream ladders, and EAGERLY request every
    D2H copy the consumer will need — all before the NEXT block's search is
    dispatched.

    A D2H copy requested on a still-PENDING buffer may run only after the
    dispatch queue ahead of it drains, so a copy requested after block
    k+1's search is dispatched can wait for that search.  Requesting the
    copies here puts them in stream order right behind block k's own
    programs: the DMA then overlaps block k+1's search compute.

    block_emit_bound (e.g. block bases + block sequences, an upper bound on
    a block's emission count) trims the eagerly-copied plane windows; the
    escape-stream eager prefix assumes <= ~12.5% escape rate.  Both are
    heuristics: if the real n/n_esc2 lands beyond them, the prefetch thread
    tops up from the pre-dispatched ladders (pure DMA of retired buffers).
    Callers size frontier_cap/emit_cap for the LARGEST block."""
    from ..utils.ranges import get_bounds

    parts = []
    for sp, ep in get_bounds((0, b_sequences - 1), max(1, n_blocks)):
        dc8, meta, exc4, esc = search_and_pack(
            a_idx, b_idx, jnp.int32(sp), jnp.int32(ep), a_sequences,
            frontier_cap=frontier_cap, emit_cap=emit_cap)
        parts.append(make_block_part(dc8, meta, exc4, esc, chunk_runs,
                                     block_emit_bound))
    return BlockedPackedRA(parts)


def make_block_part(dc8, meta, exc4, esc, chunk_runs: int,
                    block_emit_bound: int | None):
    """Dispatch a packed block's slice grid + side-stream ladders and EAGERLY
    request every D2H copy the consumer will need — in stream order right
    behind the block's own programs, so the DMAs overlap the NEXT block's
    compute (see blocked_search_and_pack).  Returns the BlockedPackedRA
    part tuple."""
    cap = dc8.shape[1]
    chunk = min(chunk_runs, cap)
    chunk = max(2, chunk - (chunk & 1))  # q4 nibble alignment
    bound = min(cap, block_emit_bound) if block_emit_bound else cap
    # sparse side-stream ladders: every rung is computed NOW (one grid
    # program per block) so no consumer-side fetch ever creates a
    # program that would queue behind a later search; the full-width
    # rung is the buffer itself (copying it needs no program at all)
    esc_cap = esc.shape[1]
    esc_eager = _esc_bucket(max(bound // 8, 1 << 14), esc_cap)
    esc_rungs, k = [], esc_eager
    while k < esc_cap:
        esc_rungs.append(k)
        k *= 4
    exc4_rungs, k = [], 1 << 10
    while k < exc4.shape[1]:
        exc4_rungs.append(k)
        k *= 8
    q4_slices, esc_slices, exc4_slices = _grid_program(
        dc8, esc, exc4, chunk, tuple(esc_rungs), tuple(exc4_rungs))
    esc_ladder = dict(zip(esc_rungs, esc_slices))
    esc_ladder[esc_cap] = esc
    exc4_ladder = dict(zip(exc4_rungs, exc4_slices))
    exc4_ladder[exc4.shape[1]] = exc4
    grid = {
        "q4": (q4_slices, chunk),
        "esc": esc_ladder,
        "exc4": exc4_ladder,
    }
    # eager copy requests, in stream order behind this block's programs
    meta.copy_to_host_async()
    live_w = (min(bound + 2, cap) + chunk - 1) // chunk
    for s in q4_slices[:live_w]:
        s.copy_to_host_async()
    esc_ladder[min(esc_ladder)].copy_to_host_async()
    exc4_ladder[min(exc4_ladder)].copy_to_host_async()
    return (dc8, meta, exc4, esc, grid)


def _u32_delta(d: np.ndarray) -> np.ndarray:
    """Exception deltas as int64, re-reading int32-negative entries as
    uint32: rank-array deltas are nonnegative by construction, so a
    negative entry is a value chain beyond 2^31 (the k-way fold's summed
    arrays) wrapped by the int32 device lanes."""
    return np.asarray(d).astype(np.int64) & 0xFFFFFFFF


def unpack_ra(dc8: np.ndarray, exc: np.ndarray, n: int, n_exc: int):
    """Host-side inverse of pack_ra_device's byte planes -> sorted
    (values, counts).

    dc8: uint8[>=2, n] (delta plane, count plane); exc: int32[3, EXC_CAP]
    (index, delta, count) rows for wide entries.
    """
    delta = dc8[0, :n].astype(np.int64)
    counts = dc8[1, :n].astype(np.int64)
    if n_exc:
        idx = exc[0, :n_exc]
        delta[idx] = _u32_delta(exc[1, :n_exc])
        counts[idx] = exc[2, :n_exc]
    return np.cumsum(delta), counts


def unpack_ra4(nib: np.ndarray, esc: np.ndarray, exc4: np.ndarray,
               n: int, n_exc4: int):
    """Host-side inverse of pack_ra_device's nibble plane -> sorted
    (values, counts).

    nib: uint8[>=n] (delta in the low nibble, count in the high; escape
    lanes carry the marker byte 15); esc: uint8[2, >= #escapes] lane-ordered
    (delta, count) byte pairs; exc4: int32[3, >= n_exc4] lane-indexed
    overrides for >254 outliers (their escape pair is (255, 255)).
    """
    nib = nib[:n]
    delta = (nib & np.uint8(15)).astype(np.int64)
    counts = (nib >> 4).astype(np.int64)
    em = (nib & np.uint8(15)) == 15
    ke = int(em.sum())
    eb = esc[:, :ke]
    if eb.shape[1] != ke:
        raise ValueError("nibble escape stream exhausted (corrupt "
                         "packed RA)")
    delta[em] = eb[0].astype(np.int64)
    counts[em] = eb[1].astype(np.int64)
    if n_exc4:
        idx = exc4[0, :n_exc4]
        delta[idx] = _u32_delta(exc4[1, :n_exc4])
        counts[idx] = exc4[2, :n_exc4]
    return np.cumsum(delta), counts


def unpack_ra_q4(q4b: np.ndarray, esc: np.ndarray, exc4: np.ndarray,
                 n: int, n_exc4: int):
    """Host-side inverse of pack_ra_device's pair-code plane -> sorted
    (values, counts).

    q4b: uint8[>= ceil(n/2)] plane bytes (two 4-bit codes per byte, low
    nibble first); esc: uint8[2, >= #escapes] lane-ordered (delta, count)
    byte pairs, one per code-15 lane; exc4: int32[3, >= n_exc4]
    lane-indexed overrides for >254 outliers (their escape pair is
    (255, 255)).
    """
    nb = (n + 1) // 2
    b = q4b[:nb]
    codes = np.empty(nb * 2, np.uint8)
    codes[0::2] = b & np.uint8(15)
    codes[1::2] = b >> 4
    codes = codes[:n]
    delta = Q4_TABLE_D[codes]
    counts = Q4_TABLE_C[codes]
    em = codes == Q4_ESCAPE
    ke = int(em.sum())
    eb = esc[:, :ke]
    if eb.shape[1] != ke:
        raise ValueError("pair-code escape stream exhausted (corrupt "
                         "packed RA)")
    delta[em] = eb[0].astype(np.int64)
    counts[em] = eb[1].astype(np.int64)
    if n_exc4:
        idx = exc4[0, :n_exc4]
        delta[idx] = _u32_delta(exc4[1, :n_exc4])
        counts[idx] = exc4[2, :n_exc4]
    return np.cumsum(delta), counts


@jax.jit
def sort_ra_device(values: jax.Array, counts: jax.Array, n: jax.Array):
    """Sort emitted RA runs by a-position ON DEVICE (live prefix n; dead lanes
    sort to the back as int32-max).  The host then only needs a linear
    segment-sum (compact_sorted_rank_array) — the 3.4M-run argsort that
    dominated host post-processing moves to a ~15 ms device sort."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (values.shape[0], 1), 0)[:, 0]
    live = lane < n
    key = jnp.where(live, values, jnp.int32(2**31 - 1))
    v, c = jax.lax.sort((key, jnp.where(live, counts, 0)), num_keys=1,
                        is_stable=False)
    return v, c


# -- host-side RA accumulation ------------------------------------------------


class RankArrayAccumulator:
    """Collects (a_pos, count) run chunks and compacts them into the sorted
    unique rank array — the vector analog of the reference's run-buffer /
    thread-buffer / merge-buffer ladder (fmi.cpp:139-257).

    Compaction triggers when the pending pool exceeds `compact_every` runs,
    bounding host memory the way the ladder bounds the reference's.
    """

    def __init__(self, compact_every: int = 16 * 1024 * 1024):
        self.compact_every = compact_every
        self._chunks: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending = 0
        self._base: tuple[np.ndarray, np.ndarray] | None = None

    def emit(self, values: np.ndarray, counts: np.ndarray) -> None:
        if values.size == 0:
            return
        self._chunks.append((values, counts))
        self._pending += values.size
        if self._pending >= self.compact_every:
            self._compact()

    def _compact(self) -> None:
        from .search_np import compact_rank_array, merge_rank_arrays

        if not self._chunks:
            return
        values = np.concatenate([c[0] for c in self._chunks])
        counts = np.concatenate([c[1] for c in self._chunks])
        part = compact_rank_array(values, counts)
        self._base = part if self._base is None else merge_rank_arrays(self._base, part)
        self._chunks = []
        self._pending = 0

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        self._compact()
        if self._base is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return self._base


# -- merge-facing entry point -------------------------------------------------


def build_rank_array_jax(a, b, config) -> Tuple[np.ndarray, np.ndarray]:
    """Device-backed replacement for search_np.build_rank_array, called from
    models/merge.py when config.backend == 'jax'.  `a`, `b` are host FMIs.
    """
    from ..utils.ranges import get_bounds

    a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
    b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())

    acc = RankArrayAccumulator()
    blocks = get_bounds((0, b.sequences() - 1), max(1, config.sequence_blocks))
    for blk in blocks:
        wavefront_search(a_idx, b_idx, blk, a.sequences(), acc.emit)
    return acc.finish()
