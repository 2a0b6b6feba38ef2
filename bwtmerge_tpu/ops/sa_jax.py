"""Device-side multi-string BWT construction: prefix-doubling suffix array
and RLO read ordering as `lax.sort` programs.

Device replacement for the host oracle's numpy prefix doubling
(models/oracle.py suffix_array): the same O(n log^2 n) algorithm, but every
round is ONE fused multi-operand device sort.  The reference has no
equivalent: it consumes BWTs prebuilt by external tools (ropebwt /
ropebwt2, paper.tex:274).

Collection conventions follow models/oracle.py build_bwt: sequence k is
terminated by a distinct endmarker $_k with $_i < $_j iff i < j, encoded by
remapping endmarker k -> value k and character c -> m + c.  Device padding
appends DISTINCT descending values below every real value (see
_end_padding), implementing the end-of-string comparison convention while
adding no doubling rounds; the real suffix array is `order[pad:]`.

Doubling terminates for reads at ~log2(max read length) rounds — the unique
endmarkers make distant positions distinct early — so building the BWT of a
50 bp read collection costs ~8 device sorts of 2 int32 operands.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.runs import RunArrays


def _bucket(n: int, minimum: int = 1 << 12) -> int:
    """{2^k, 3*2^(k-2)} size bucket >= n (two XLA programs per octave)."""
    b = minimum
    while b < n:
        b *= 2
    if b // 4 * 3 >= n:
        b = b // 4 * 3
    return b


def _end_padding(lo: int, count: int) -> np.ndarray:
    """Pad values for the suffix sort: strictly DESCENDING values below the
    real alphabet's minimum `lo`.  Every pad value compares below every real
    character, so (a) a suffix that runs off the real end sorts before any
    longer suffix sharing its prefix — the end-of-string convention the
    oracle's -1 fill implements; (b) pad-start suffixes occupy the first
    `count` suffix-array rows (sliced off); (c) pad values are distinct, so
    pad suffixes are rank-distinct from round 0 and add no doubling rounds.
    """
    if lo - count < -(2**31) + 1:
        raise ValueError("text values too small for int32 end padding")
    return np.arange(lo - 1, lo - 1 - count, -1, dtype=np.int32)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _sa_ranks(text_pad: jax.Array, n_pad: int):
    """Prefix-doubling ranks over the padded text.

    Returns (order int32[n_pad], rank int32[n_pad]): `order` is the suffix
    array of the padded text, `rank` its inverse.  All comparisons happen in
    int32; callers guarantee distinct pad values above the real alphabet.
    """
    idx = jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0)[:, 0]

    def invert(order, rank_sorted):
        # rank-by-position = inverse permutation of `order`, computed by ONE
        # 2-operand sort instead of a scatter
        _, rank = jax.lax.sort((order, rank_sorted), num_keys=1,
                               is_stable=False)
        return rank

    # round 0: rank by first character (one 2-operand sort + segment scan)
    t_sorted, order = jax.lax.sort((text_pad, idx), num_keys=1,
                                   is_stable=True)
    changed = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         (t_sorted[1:] != t_sorted[:-1]).astype(jnp.int32)])
    rank = invert(order, jnp.cumsum(changed))

    def cond(st):
        order, rank, k = st
        return rank[order[-1]] != n_pad - 1

    def body(st):
        order, rank, k = st
        # second key: rank of the suffix k positions later (-1 past the end)
        second = jnp.where(idx + k < n_pad, jnp.roll(rank, -k), -1)
        r_s, s_s, order = jax.lax.sort((rank, second, idx), num_keys=2,
                                       is_stable=False)
        changed = jnp.concatenate(
            [jnp.zeros(1, jnp.int32),
             ((r_s[1:] != r_s[:-1]) | (s_s[1:] != s_s[:-1])).astype(jnp.int32)])
        rank = invert(order, jnp.cumsum(changed))
        return order, rank, k * 2

    order, rank, _ = jax.lax.while_loop(
        cond, body, (order, rank, jnp.int32(1)))
    return order, rank


def suffix_array_device(text: np.ndarray) -> np.ndarray:
    """Suffix array of an int array by device prefix doubling.

    Matches models/oracle.suffix_array exactly (tests pin it).  The text is
    padded to a size bucket with distinct ascending values above max(text),
    so one XLA program serves each bucket.
    """
    text = np.asarray(text)
    n = text.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n >= 2**31 - 1:
        raise ValueError(f"text of {n} positions exceeds the int32 device "
                         "suffix sort; shard the collection first")
    n_pad = _bucket(n)
    text_pad = np.concatenate([text.astype(np.int32),
                               _end_padding(int(text.min()), n_pad - n)])
    order, _ = _sa_ranks(jnp.asarray(text_pad), n_pad)
    return np.asarray(order[n_pad - n:]).astype(np.int64)


@functools.partial(jax.jit, static_argnames=("n_pad", "m", "n"))
def _bwt_from_nibbles(nib: jax.Array, n_pad: int, m: int, n: int):
    """BWT (uint8[ceil(n/2)], 2 symbols/byte) from 4-bit-packed chars.

    Both host<->device directions are packed 4 bits per symbol (8x less
    than the naive int32 text upload).  The oracle's remapped text
    (endmarker k -> k, char c -> m + c) is derived ON DEVICE from the char
    plane: endmarker positions carry char 0 and their ordinal is a running
    count of endmarkers seen.  Suffix-array padding (descending below 0,
    _end_padding semantics) is generated from iota.

    Instead of a per-row gather text[sa-1], the previous-character array
    is carried as a sort
    PAYLOAD: sorting (rank, prev_char) by rank permutes prev_char into
    suffix-array order in one fused device sort.
    """
    chars = jnp.concatenate([(nib & 0xF).astype(jnp.int32),
                             (nib >> 4).astype(jnp.int32)], axis=0)
    half = nib.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (2 * half, 1), 0)[:, 0]
    # undo the two-plane packing: byte i holds positions 2i (low) and
    # 2i+1 (high) -> plane row r of half h maps to position 2h + r
    pos = 2 * (idx % half) + idx // half
    _, chars = jax.lax.sort((pos, chars), num_keys=1, is_stable=False)

    is_end = (chars == 0) & (idx < n)
    seq_ord = jnp.cumsum(is_end.astype(jnp.int32)) - is_end.astype(jnp.int32)
    remapped = jnp.where(is_end, seq_ord, chars + m)[:n]
    pad_i = jax.lax.broadcasted_iota(jnp.int32, (n_pad - n, 1), 0)[:, 0]
    text_pad = jnp.concatenate([remapped, -pad_i - 1])  # descending below 0

    _, rank = _sa_ranks(text_pad, n_pad)
    # prev char within the sequence: positions whose predecessor is an
    # endmarker (value < m) or position 0 wrap to their own endmarker (0)
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), text_pad[:-1]])
    bwt_of_pos = jnp.where(prev < m, 0, prev - m)
    _, bwt = jax.lax.sort((rank, bwt_of_pos), num_keys=1, is_stable=False)
    # pad suffixes occupy the first n_pad - n rows; keep the real n and
    # nibble-pack the result for the D2H trip
    real = jax.lax.slice(bwt, (n_pad - n,), (n_pad,))
    out_half = (n + 1) // 2
    lo = jax.lax.slice(jnp.pad(real, (0, n & 1)), (0,), (2 * out_half,), (2,))
    hi = jax.lax.slice(jnp.pad(real, (0, n & 1)), (1,), (2 * out_half,), (2,))
    return (lo | (hi << 4)).astype(jnp.uint8)


def pack_collection(sequences):
    """(flat, lengths) packed form of a sequence collection — every host
    pass over it is then vectorized (2M-read Python loops cost minutes)."""
    if isinstance(sequences, tuple) and len(sequences) == 2:
        flat, lengths = sequences
        return (np.ascontiguousarray(flat, dtype=np.int32),
                np.asarray(lengths, dtype=np.int64))
    seqs = [np.asarray(s) for s in sequences]
    lengths = np.fromiter((s.size for s in seqs), dtype=np.int64,
                          count=len(seqs))
    flat = (np.concatenate(seqs).astype(np.int32) if seqs
            else np.zeros(0, np.int32))
    return flat, lengths


def _reorder_packed(flat: np.ndarray, lengths: np.ndarray,
                    order: np.ndarray):
    """Packed collection with its sequences permuted by `order` (one
    vectorized gather — no per-read Python)."""
    if lengths.size and (lengths == lengths[0]).all():
        # fixed-length fast path: one row gather, no index temps (the
        # general path's three full-length index arrays cost ~10 s of page
        # faults at 100 Mbp on the target VM)
        ln = int(lengths[0])
        return flat.reshape(-1, ln)[order].reshape(-1), lengths.copy()
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    new_lengths = lengths[order]
    total = int(lengths.sum())
    # source index of each output position: run k copies from
    # starts[order[k]] for new_lengths[k] positions
    out_starts = np.concatenate([[0], np.cumsum(new_lengths)[:-1]])
    pos = np.arange(total, dtype=np.int64)
    row = np.repeat(np.arange(order.size, dtype=np.int64), new_lengths)
    src = starts[order][row] + (pos - out_starts[row])
    return flat[src], new_lengths


def build_bwt_device(sequences, chunk: int = 1 << 22) -> RunArrays:
    """Device analog of oracle.build_bwt: BWT of a sequence collection.

    Concatenates '<seq>$_k' with the oracle's remapping (endmarker k -> k,
    char c -> m + c), runs the device suffix sort, and extracts the BWT with
    one payload sort.  Output is identical to oracle.build_bwt (pinned by
    tests/test_sa_jax.py).  `sequences` may be a list of arrays or a packed
    (flat, lengths) tuple.
    """
    flat, lengths = pack_collection(sequences)
    m = lengths.size
    if flat.size and flat.min() <= 0:
        raise ValueError(
            "sequences must contain comp values >= 1 (no endmarkers)")
    n = int(lengths.sum()) + m
    if n >= 2**31 - 1:
        raise ValueError(f"collection of {n} positions exceeds the int32 "
                         "device suffix sort; shard the collection first")
    if n == 0:
        return RunArrays.empty()

    # vectorized assembly of the char plane (0 marks endmarker positions;
    # the unique endmarker ORDINALS are derived on device), nibble-packed
    # for the upload (0.5 B/position over the host link)
    chars = np.zeros(n + (n & 1), dtype=np.uint8)
    ends = np.cumsum(lengths + 1) - 1
    mask = np.ones(n, dtype=bool)
    mask[ends] = False
    chars[:n][mask] = flat.astype(np.uint8)
    # two-plane packing: byte i = position 2i (low nibble) | 2i+1 (high)
    nib = chars[0::2] | (chars[1::2] << 4)

    n_pad = _bucket(n)
    packed = np.asarray(_bwt_from_nibbles(jnp.asarray(nib), n_pad, m, n))
    bwt = np.empty(2 * packed.size, dtype=np.uint8)
    bwt[0::2] = packed & 0xF
    bwt[1::2] = packed >> 4
    return RunArrays.from_values(bwt[:n])


# -- RLO read ordering ---------------------------------------------------------

_RLO_BITS = 3          # comp values 0..5 fit in 3 bits
_RLO_PER_KEY = 30 // _RLO_BITS   # chars per int32 sort key (sign bit spare;
                                 # the device is int32 — x64 stays disabled)


@functools.partial(jax.jit, static_argnames=("n_keys",))
def _rlo_sort(keys: jax.Array, n_keys: int):
    idx = jnp.arange(keys.shape[1], dtype=jnp.int32)
    ops = tuple(keys[j] for j in range(n_keys)) + (idx,)
    out = jax.lax.sort(ops, num_keys=n_keys, is_stable=True)
    return out[-1]


def rlo_pack_keys(flat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Fixed-width reverse-lexicographic sort keys for a packed read
    collection: int32[n_keys, m], 10 chars per key (3 bits/char), reversed
    reads zero-padded past the end — pad sorts below every character, so a
    read that is a suffix of a longer read sorts first.  Lexicographic order
    of the key columns == RLO order of the reads (models/build.rlo_order)."""
    m = lengths.size
    max_len = int(lengths.max()) if m else 0
    # vectorized reversed-read matrix: rev[i, j] = read i's char at
    # position len_i - 1 - j (0 past the end)
    if (lengths == max_len).all():
        rev = flat.reshape(m, max_len)[:, ::-1].astype(np.int32)
    else:
        rev = np.zeros((m, max_len), dtype=np.int32)
        total = int(lengths.sum())
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        pos = np.arange(total, dtype=np.int64)
        row = np.repeat(np.arange(m, dtype=np.int64), lengths)
        off = pos - starts[row]                   # position within the read
        rev[row, lengths[row] - 1 - off] = flat
    n_keys = (max_len + _RLO_PER_KEY - 1) // _RLO_PER_KEY
    keys = np.zeros((n_keys, m), dtype=np.int32)
    for j in range(n_keys):
        block = rev[:, j * _RLO_PER_KEY: (j + 1) * _RLO_PER_KEY]
        acc = np.zeros(m, dtype=np.int32)
        for col in range(block.shape[1]):
            acc = (acc << _RLO_BITS) | block[:, col]
        # left-align the final (possibly short) block so shorter pads
        # compare below longer content, matching per-column lexsort
        acc <<= _RLO_BITS * (_RLO_PER_KEY - block.shape[1])
        keys[j] = acc
    return keys


def rlo_order_device(sequences) -> np.ndarray:
    """Device analog of models/build.rlo_order: permutation sorting reads
    into reverse-lexicographic order.

    Packs the reversed reads into fixed-width keys (rlo_pack_keys), then ONE
    stable multi-key device sort orders the collection.  Identical to the
    numpy lexsort path (pinned by tests).  `sequences` may be a list of
    arrays or a packed (flat, lengths) tuple."""
    flat, lengths = pack_collection(sequences)
    m = lengths.size
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    if int(lengths.max()) == 0:
        return np.arange(m, dtype=np.int64)
    keys = rlo_pack_keys(flat, lengths)
    return np.asarray(_rlo_sort(jnp.asarray(keys), keys.shape[0])
                      ).astype(np.int64)
