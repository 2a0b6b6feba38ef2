"""Device-resident FM-index: batched rank/LF over a BWT in JAX.

Vector replacement for the reference's per-query block decode
(BWT::rank, bwt.cpp:318-341).  A rank query is ONE gather of ONE fused
record, found by pure arithmetic (no binary search, no dependent loads):

  rec: int32[NBLK, 16]   one 64-byte record per 32-position block:
       rec[b, 0:8]  = occ counts of each char in positions [0, 32*b)
       rec[b, 8:16] = the block's 32 symbols, 4 packed per int32 (LSB first)

  rank(i, c) = rec[i>>5, c] + popcount(syms[0 : i&31] == c)

One gather (block id = shift, no search) + elementwise unpack/mask/sum.
This is the vector analog of the reference's 64-byte-block + samples design
(bwt.h:49-50,174-176) with the samples fused INTO the block so a query
costs a single row of device memory.

The dense layout spends 2 B/position (vs RLE); terabase inputs are handled
by sharding (parallel/mesh.py), not per-device compression.  Positions are
int32: a per-device shard never exceeds 2^31 positions.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..models.runs import RunArrays

SIGMA = 6
LANES = 8        # occ lanes (sigma padded)
BLK = 32         # positions per block
REC = 16         # int32 words per record: 8 occ + 8 packed-symbol words


def _bucket_positions(npos: int) -> int:
    """Bucket a padded position count to {2^k, 3*2^(k-2)} so at most two
    XLA build programs exist per octave (waste <= 33%)."""
    padded = 1 << 16
    while padded < npos:
        padded *= 2
    if padded // 4 * 3 >= npos:
        padded = padded // 4 * 3
    return padded


NIB_FILL = SIGMA | (SIGMA << 4)  # pad byte: no occ lane counts SIGMA


def pack_nibbles_chunked(chunks, size_hint: int = 0):
    """Stream (syms, lens) run chunks into the block-planar nibble layout
    (DeviceFMIndex.build's upload format) without ever materializing run
    arrays or decoded text: peak host memory is the 0.5 B/pos nibble buffer
    plus one decoded chunk window.

    Returns (nibbles uint8[padded/2] bucket-padded SIGMA-filled,
    counts int64[SIGMA], size, n_runs) — feed to DeviceFMIndex.from_nibbles.
    """
    cap = _bucket_positions(max(int(size_hint), 1 << 16))
    nib = np.full(cap // 2, NIB_FILL, dtype=np.uint8)
    carry = np.zeros(0, np.uint8)
    pos = 0
    counts = np.zeros(SIGMA, np.int64)
    n_runs = 0
    last_sym = -1
    for syms, lens in chunks:
        syms = np.asarray(syms, np.uint8)
        lens = np.asarray(lens, np.int64)
        if syms.size == 0:
            continue
        np.add.at(counts, syms, lens)
        n_runs += syms.size - (1 if syms[0] == last_sym else 0)
        last_sym = int(syms[-1])
        # decode in bounded sub-windows (a chunk's decoded size is not
        # bounded by its encoded size for long runs)
        cum = np.concatenate(([0], np.cumsum(lens)))
        total_w = int(cum[-1])
        w = 0
        while w < total_w:
            end = min(w + (1 << 22), total_w)
            i0 = int(np.searchsorted(cum, w, side="right")) - 1
            i1 = int(np.searchsorted(cum, end, side="left"))
            wl = lens[i0:i1].copy()
            wl[0] -= w - cum[i0]
            wl[-1] -= cum[i1] - end
            win = np.repeat(syms[i0:i1], wl)
            if carry.size:
                win = np.concatenate([carry, win])
            usable = win.size // BLK * BLK
            if pos + usable + BLK > cap:
                new_cap = _bucket_positions(max(2 * cap, pos + usable + BLK))
                grown = np.full(new_cap // 2, NIB_FILL, np.uint8)
                grown[: cap // 2] = nib
                nib = grown
                cap = new_cap
            if usable:
                blk = win[:usable].reshape(-1, BLK)
                packed = (blk[:, :16] | (blk[:, 16:] << 4)).astype(np.uint8)
                nib[pos // 2: pos // 2 + usable // 2] = packed.reshape(-1)
                pos += usable
            carry = win[usable:]
            w = end
    size = pos + carry.size
    if carry.size:
        tail = np.full(BLK, SIGMA, np.uint8)
        tail[: carry.size] = carry
        nib[pos // 2: pos // 2 + BLK // 2] = (
            tail[:16] | (tail[16:] << 4)).astype(np.uint8)
    padded = _bucket_positions((size // BLK + 1) * BLK)
    if padded > cap:
        grown = np.full(padded // 2, NIB_FILL, np.uint8)
        grown[: cap // 2] = nib
        nib = grown
    return nib[: padded // 2], counts, size, n_runs


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class DeviceFMIndex:
    """Block-fused FM-index resident in device memory."""

    rec: jax.Array   # int32[NBLK, REC]
    C: jax.Array     # int32[LANES+1] cumulative char counts (C[sigma]=size)
    size: int        # static: total positions
    n_runs: int      # static: run count of the source RLE (informational)

    # -- pytree plumbing ------------------------------------------------------

    def tree_flatten(self):
        return ((self.rec, self.C), (self.size, self.n_runs))

    @classmethod
    def tree_unflatten(cls, aux, children):
        rec, C = children
        size, n_runs = aux
        return cls(rec=rec, C=C, size=size, n_runs=n_runs)

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_nibbles(cls, nibbles: np.ndarray, counts: np.ndarray,
                     size: int, n_runs: int = 0) -> "DeviceFMIndex":
        """Build from an ALREADY block-planar-packed nibble buffer
        (pack_nibbles_chunked output): the 0.5 B/pos upload path that never
        materializes run arrays on the host — the k-way fold's piece loader
        (models/kfold.py) reads files straight into this."""
        if size >= 2**31 - 1:
            # strictly below int32-max: the walk engine reserves 2^31-1 as
            # its dead-lane sentinel, so a rank equal to it must not exist
            raise ValueError(
                f"BWT shard of {size} positions exceeds int32 device layout; "
                "shard it first (parallel/mesh.py)")
        nblk = size // BLK + 1
        counts = np.asarray(counts)
        c_arr = np.zeros(LANES + 1, dtype=np.int32)
        c_arr[: counts.size + 1] = np.concatenate(
            ([0], np.cumsum(counts))).astype(np.int32)
        c_arr[counts.size + 1:] = c_arr[counts.size]
        rec = build_rec_slabbed(jnp.asarray(nibbles), nblk)
        return cls(rec=rec, C=jnp.asarray(c_arr), size=size, n_runs=n_runs)

    @classmethod
    def build(cls, runs: RunArrays, C: np.ndarray | None = None) -> "DeviceFMIndex":
        """Build the block-fused device layout ON DEVICE from a 4-bit-packed
        upload.

        The host only packs the decoded text two positions per byte (0.5
        B/position); the record table (2 B/position) is derived on device —
        4x fewer bytes over the host link and no large host-side temporary
        tables.  Packed sizes are bucketed so XLA compiles O(log) program
        variants, not one per input.
        """
        size = runs.size()
        if size >= 2**31 - 1:
            # strictly below int32-max: the walk engine reserves 2^31-1 as
            # its dead-lane sentinel, so a rank equal to it must not exist
            raise ValueError(
                f"BWT shard of {size} positions exceeds int32 device layout; "
                "shard it first (parallel/mesh.py)")
        nblk = size // BLK + 1  # extra block so i == size resolves
        padded = _bucket_positions(nblk * BLK)

        # block-planar nibble packing: byte k of block b holds positions
        # (b*32 + k) in the low nibble and (b*32 + 16 + k) in the high nibble.
        # Chosen so the device unpack is a [nblk,16]+[nblk,16] concat — no
        # tiny trailing dims for XLA to tile-pad (a [N,2] interleave temp
        # padded 64x and OOMed at 25M positions).  Packed CHUNKED from the
        # runs (1 B/pos decoded windows of <= 4 MB) so the only O(n) host
        # temporary is the 0.5 B/pos nibble buffer itself.
        nibbles = np.full(padded // 2, SIGMA | (SIGMA << 4), dtype=np.uint8)
        try:
            # one native pass straight from the runs (~2x memcpy speed);
            # this is the fold-to-fold index-rebuild hot path
            from ..native import nib4_pack

            wrote = nib4_pack(runs.syms, runs.lens, nibbles)
            assert wrote == size, (wrote, size)
        except ImportError:  # pragma: no cover - numpy fallback
            pos = 0
            for c_syms, c_lens in runs.iter_chunks(1 << 22):  # multiple of BLK
                win = np.repeat(c_syms, c_lens)
                if win.size % BLK:
                    win = np.concatenate(
                        [win, np.full((-win.size) % BLK, SIGMA, np.uint8)])
                blk = win.reshape(-1, BLK)
                nib = (blk[:, :16]
                       | (blk[:, 16:] << 4)).astype(np.uint8).reshape(-1)
                nibbles[pos // 2: pos // 2 + nib.size] = nib
                pos += blk.size

        counts = runs.counts(SIGMA) if C is None else np.asarray(C)
        c_arr = np.zeros(LANES + 1, dtype=np.int32)
        c_arr[: counts.size + 1] = np.concatenate(([0], np.cumsum(counts)))
        c_arr[counts.size + 1:] = c_arr[counts.size]

        rec = build_rec_slabbed(jnp.asarray(nibbles), nblk)
        return cls(rec=rec, C=jnp.asarray(c_arr),
                   size=size, n_runs=runs.n_runs)

    # -- device-side record construction --------------------------------------

    # (free function below; kept out of the class so jit caches by shape only)

    # -- the block probe (shared by every query) ------------------------------

    def _probe(self, i: jax.Array):
        """One gather per query: (occ_base [Q,LANES], syms [Q,BLK] permuted,
        before [Q,BLK] mask of positions < i within the block, off [Q])."""
        i = i.astype(jnp.int32)
        row = self.rec[i >> 5]                                # [Q, REC] gather
        return _decode_row(row, i)

    # -- core queries (all batched) -------------------------------------------

    @jax.jit
    def ranks_all(self, i: jax.Array) -> jax.Array:
        """rank(i, c) for every c: int32[Q, LANES].  i in [0, size]."""
        occ_base, syms, before, _ = self._probe(i)
        return occ_base + _count_lanes(syms, before)

    @jax.jit
    def rank(self, i: jax.Array, c: jax.Array) -> jax.Array:
        """rank(i, c) per (i, c) pair: int32[Q]."""
        occ_base, syms, before, _ = self._probe(i)
        c = c.astype(jnp.int32)
        hits = (syms == c[:, None]) & before
        base = jnp.take_along_axis(occ_base, c[:, None], axis=1)[:, 0]
        return base + jnp.sum(hits.astype(jnp.int32), axis=1)

    @jax.jit
    def inverse_select(self, i: jax.Array):
        """(rank(i, BWT[i]), BWT[i]) per position (bwt.cpp:445-464)."""
        occ_base, syms, before, off = self._probe(i)
        sym = jnp.take_along_axis(syms, _lane_of(off), axis=1)[:, 0]
        hits = (syms == sym[:, None]) & before
        base = jnp.take_along_axis(occ_base, sym[:, None], axis=1)[:, 0]
        return base + jnp.sum(hits.astype(jnp.int32), axis=1), sym

    @jax.jit
    def access(self, i: jax.Array) -> jax.Array:
        _, syms, _, off = self._probe(i)
        return jnp.take_along_axis(syms, _lane_of(off), axis=1)[:, 0]

    # -- LF layer (fmi.h:146-193) ---------------------------------------------

    @jax.jit
    def LF_all(self, i: jax.Array) -> jax.Array:
        """LF(i, c) = C[c] + rank(i, c) for every c at once: int32[Q, LANES]."""
        return self.C[:LANES][None, :] + self.ranks_all(i)

    @jax.jit
    def LF(self, i: jax.Array, c: jax.Array) -> jax.Array:
        return self.C[c] + self.rank(i, c)

    @jax.jit
    def LF_step(self, i: jax.Array):
        """(LF(i), BWT[i]) batched (utils.h:335-341)."""
        rnk, sym = self.inverse_select(i)
        return self.C[sym] + rnk, sym

    def char_range(self, c: jax.Array):
        """Closed SA range of character c: (C[c], C[c+1]-1)."""
        return self.C[c], self.C[c + 1] - 1



# Permuted in-block symbol layout: unpacking the 8 words by shift amount
# (concat of four [Q, 8] slices — no tiny trailing dims for XLA to tile-pad)
# places position p = 4w + b at lane l = 8b + w.  _POS_OF_LANE maps lanes
# back to positions for the prefix mask; _lane_of maps an offset to its lane.
_POS_OF_LANE = (4 * (np.arange(BLK, dtype=np.int32) % 8)
                + np.arange(BLK, dtype=np.int32) // 8).reshape(1, BLK)


def _pos_of_lane():
    return jnp.asarray(_POS_OF_LANE)


def _lane_of(off: jax.Array) -> jax.Array:
    """Lane index of position offset `off` (per query), shaped [Q, 1]."""
    return (8 * (off % 4) + off // 4)[:, None]


def _decode_row(row: jax.Array, i: jax.Array):
    """Shared record decode: (occ_base, permuted syms, before-mask, off)."""
    occ_base = row[:, :LANES]
    words = row[:, LANES:].astype(jnp.uint32)                 # [Q, 8]
    syms = jnp.concatenate(
        [((words >> s) & 0xFF).astype(jnp.int32) for s in (0, 8, 16, 24)],
        axis=1)                                               # [Q, BLK] permuted
    off = i.astype(jnp.int32) & (BLK - 1)
    before = _pos_of_lane() < off[:, None]
    return occ_base, syms, before, off


def _count_lanes(syms: jax.Array, before: jax.Array) -> jax.Array:
    """Per-char counts of masked symbols: int32[Q, LANES]; all temps 2-D."""
    cols = []
    for c in range(LANES):
        cols.append(jnp.sum(((syms == c) & before).astype(jnp.int32),
                            axis=1, keepdims=True))
    return jnp.concatenate(cols, axis=1)


REC_SLAB_BLK = 1 << 21   # blocks per rec-build program: the one-shot build
                         # allocates ~12 B/pos of [nblk, 32] temporaries
                         # (~20 GB at 1.63 Gbp)


@functools.partial(jax.jit, static_argnames=("size",))
def _build_rec_slab(nibbles: jax.Array, start_byte: jax.Array, size: int,
                    base_occ: jax.Array):
    """One slab of the record table: records for blocks starting at byte
    offset start_byte, occ lanes rebased by the running per-char totals.
    Returns (rec int32[size/16, REC], slab per-char totals int32[LANES])."""
    slab = jax.lax.dynamic_slice(nibbles, (start_byte,), (size,))
    rec = _build_rec_device(slab)
    counts = _slab_counts(slab)
    rec = rec.at[:, :LANES].add(base_occ[None, :])
    return rec, counts


@jax.jit
def _slab_counts(nibbles: jax.Array) -> jax.Array:
    nib2 = nibbles.reshape(-1, 16)
    by_block = jnp.concatenate([(nib2 & 0xF).astype(jnp.int32),
                                (nib2 >> 4).astype(jnp.int32)], axis=1)
    return jnp.stack([jnp.sum((by_block == c).astype(jnp.int32))
                      for c in range(LANES)])


def build_rec_slabbed(nibbles: jax.Array, nblk: int) -> jax.Array:
    """Record table from a (padded) nibble buffer, slab-by-slab for big
    inputs: one bucket-shaped program reused across slabs, running occ
    totals carried on device."""
    slab_bytes = REC_SLAB_BLK * BLK // 2
    # engage slabbing only from 3*slab_bytes up: every bucketed size
    # {2^k, 3*2^(k-2)} at or above 3*2^m is a whole multiple of 2^m, so
    # no clamped final slab exists (a clamp would need occ rebasing at
    # mid-slab); below that the one-shot build's temporaries stay small
    if nibbles.shape[0] < 3 * slab_bytes:
        return _build_rec_device(nibbles)[:nblk]
    assert nibbles.shape[0] % slab_bytes == 0, nibbles.shape
    parts = []
    base = jnp.zeros(LANES, jnp.int32)
    for pos in range(0, nibbles.shape[0], slab_bytes):
        rec, counts = _build_rec_slab(nibbles, jnp.int32(pos), slab_bytes,
                                      base)
        parts.append(rec)
        base = base + counts
    return jnp.concatenate(parts)[:nblk]


@jax.jit
def _build_rec_device(nibbles: jax.Array) -> jax.Array:
    """4-bit-packed text -> block-fused record table, entirely on device.

    nibbles: uint8[P/2], block-planar (see DeviceFMIndex.build).  Returns
    int32[P/BLK, REC].  Pad positions hold SIGMA, which no occ lane counts.
    All intermediates keep trailing dims >= 16 — XLA tile-pads small minor
    dimensions up to 128 lanes, which blew a [P,2] temp to 64x its size.
    """
    nib2 = nibbles.reshape(-1, 16)                           # [nblk, 16]
    by_block = jnp.concatenate([(nib2 & 0xF).astype(jnp.int32),
                                (nib2 >> 4).astype(jnp.int32)], axis=1)

    nblk = by_block.shape[0]
    cols = []
    for c in range(LANES):
        cols.append(jnp.sum((by_block == c).astype(jnp.int32), axis=1,
                            keepdims=True))
    per_block = jnp.concatenate(cols, axis=1)                # [nblk, LANES]
    occ = jnp.cumsum(per_block, axis=0) - per_block          # exclusive

    # word w of a block packs positions (4w, 4w+1, 4w+2, 4w+3) LSB-first;
    # strided slices keep every temp at [nblk, 8]
    packed = (by_block[:, 0::4] | (by_block[:, 1::4] << 8)
              | (by_block[:, 2::4] << 16) | (by_block[:, 3::4] << 24))
    return jnp.concatenate([occ, packed], axis=1)


# -- backward search ----------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("max_len",))
def backward_search(index: DeviceFMIndex, patterns: jax.Array,
                    lengths: jax.Array, max_len: int):
    """Batched backward search: closed SA ranges for a batch of patterns.

    patterns: int32[Q, max_len] comp values, right-aligned padding ignored via
    `lengths`.  Returns (sp, ep) int32[Q] each; empty matches have ep < sp.
    The device analog of FMI::find (fmi.h:195-209), vectorized over queries
    instead of characters.
    """
    q = patterns.shape[0]
    last = patterns[jnp.arange(q), lengths - 1]
    sp = index.C[last]
    ep = index.C[last + 1] - 1

    def body(t, carry):
        sp, ep = carry
        # character at distance t+1 from the end, per query
        idx = lengths - 2 - t
        active = (idx >= 0) & (ep >= sp)
        c = patterns[jnp.arange(q), jnp.clip(idx, 0, max_len - 1)]
        new_sp = index.C[c] + index.rank(sp, c)
        new_ep = index.C[c] + index.rank(ep + 1, c) - 1
        sp = jnp.where(active, new_sp, sp)
        ep = jnp.where(active, new_ep, ep)
        return sp, ep

    sp, ep = jax.lax.fori_loop(0, max_len - 1, body, (sp, ep))
    return sp, ep


def batch_count(index: DeviceFMIndex, patterns_np, char2comp: np.ndarray,
                chunk: int = 1 << 16) -> np.ndarray:
    """Occurrence counts for a list of str/bytes patterns (host convenience).

    Processes in fixed-size chunks (padded to `chunk`) so multi-million
    pattern sets — the paper verifies 2M 32-mers per run (paper.tex:211-212)
    — stream through one compiled program with bounded device memory.
    """
    if not patterns_np:
        return np.zeros(0, dtype=np.int64)
    comps = []
    for p in patterns_np:
        if isinstance(p, str):
            p = p.encode()
        if isinstance(p, (bytes, bytearray)):
            arr = char2comp[np.frombuffer(bytes(p), dtype=np.uint8)]
        else:
            arr = np.asarray(p)
        comps.append(arr.astype(np.int32))
    max_len = max(c.size for c in comps)
    q = len(comps)
    out = np.empty(q, dtype=np.int64)
    q_pad = min(chunk, 1 << max(6, (q - 1).bit_length()))  # one program shape
    for start in range(0, q, q_pad):
        batch = comps[start:start + q_pad]
        pat = np.zeros((q_pad, max_len), dtype=np.int32)
        lens = np.ones(q_pad, dtype=np.int32)  # pad queries: 1-char dummies
        for j, c in enumerate(batch):
            pat[j, : c.size] = c
            lens[j] = max(c.size, 1)
        sp, ep = backward_search(index, jnp.asarray(pat), jnp.asarray(lens),
                        max_len)
        n = len(batch)
        out[start:start + n] = np.maximum(
            0, np.asarray(ep[:n], dtype=np.int64)
            - np.asarray(sp[:n], dtype=np.int64) + 1)
    return out
