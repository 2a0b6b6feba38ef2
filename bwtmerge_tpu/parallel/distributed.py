"""Multi-host execution: jax.distributed bring-up + rank-range rank-array
exchange + sharded merge output.

The reference is explicitly single-node (paper.tex:197; no MPI/NCCL anywhere
— SURVEY.md §5 "distributed communication backend").  This framework
scales out with the same decomposition it uses across devices:

  hosts   -> jax processes (jax.distributed.initialize)
  search  -> B's sequence blocks, partitioned per process, then per local
             device (parallel/mesh.py); the FM-indexes are replicated per
             host (an index beyond one device is block-sharded:
             ops/rank_sharded.py)
  combine -> A-POSITION-RANGE exchange: sample-based splitters partition
             [0, |A|] into one contiguous range per process; each process
             routes its sorted RA pieces to the owning process with ONE
             all_to_all over a one-device-per-process mesh, then k-way
             merges the P received pieces locally.  Per-process peak is
             O(|RA|/P + skew), never the full rank array — the distributed
             analog of the RankArray k-way disk merge (support.h:576-638)
             with processes in place of temp files.
  merge   -> each process interleaves ITS OWN A-range against the shared
             inputs (stateful native kernel initialized at the range
             cursors) and writes a run-chunk shard; shards concatenate in
             rank order through one streaming format writer, coalescing
             the seam runs.

Single-process calls degrade to the local mesh path, so this module is safe
to use unconditionally; true multi-host runs need the driver to start one
process per host with the same coordinator address.

One process owns each card: a JAX process reserves most of a GPU's memory
when it first uses it, so a second process on the same card fails for want
of memory.  On one host, one process drives all of its cards through the
local mesh; across hosts, each process drives its own host's cards.
jax.distributed.initialize needs its coordinator_address
("host:port"), num_processes and process_id given explicitly where no
cluster manager provides them.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..ops.rank_jax import DeviceFMIndex
from .mesh import make_mesh, sequence_shards


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed (no-op when already initialized or when
    running single-process with no coordinator)."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def process_info() -> Tuple[int, int]:
    import jax

    return jax.process_index(), jax.process_count()


def _one_device_per_process():
    """One representative device per process, process-rank ordered — the
    exchange mesh for host-resident payloads (they are per-process, so a
    finer mesh would only replicate them across local devices)."""
    import jax

    by_proc = {}
    for d in jax.devices():
        if d.process_index not in by_proc:
            by_proc[d.process_index] = d
    return [by_proc[p] for p in sorted(by_proc)]


def _local_rank_array(a_idx, b_idx, a_sequences, b_sequences,
                      frontier_cap, emit_cap):
    """This process's sorted-unique RA runs for its own B-sequence block
    (searched by the per-device shard_map path over the local mesh)."""
    pid, nproc = process_info()
    my_block = sequence_shards(b_sequences, nproc)[pid]
    sp, ep = int(my_block[0]), int(my_block[1])
    if ep < sp:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), False
    from .mesh import sharded_rank_array

    return sharded_rank_array(
        a_idx, b_idx, a_sequences, ep - sp + 1, mesh=make_mesh(local_only=True),
        frontier_cap=frontier_cap, emit_cap=emit_cap, b_seq_offset=sp)


def _split_words(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 -> (low, high) int32 words (jax x64 is off, so cross-process
    payloads travel as int32 pairs)."""
    return ((x & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
            (x >> 32).astype(np.int32))


def _join_words(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo.view(np.uint32).astype(np.int64)
            | (hi.astype(np.int64) << 32))


def _allgather_i64(x: np.ndarray) -> np.ndarray:
    """Allgather an int64 vector across processes as int32 word pairs (jax
    x64 is off; a direct int64 allgather would silently truncate).  Returns
    [nproc, x.size]."""
    from jax.experimental import multihost_utils

    x = np.ascontiguousarray(x, dtype=np.int64)
    pack = np.empty((2, x.size), np.int32)
    pack[0], pack[1] = _split_words(x)
    allp = np.asarray(multihost_utils.process_allgather(pack))
    allp = allp.reshape(-1, 2, x.size)
    return _join_words(allp[:, 0].reshape(-1),
                       allp[:, 1].reshape(-1)).reshape(-1, x.size)


def exchange_by_rank_range(values: np.ndarray, counts: np.ndarray,
                           oversample: int = 64, stats: Optional[dict] = None):
    """Route sorted-unique (values, counts) RA runs to their owning process
    by A-position range; return this process's merged range.

    Every process contributes `oversample` regular samples of its values;
    the sorted global sample's quantiles become the P-1 range splitters
    (process p owns [splitter[p-1], splitter[p]), ends open), so skewed
    rank distributions still balance to O(|RA|/P) per process.  One
    all_to_all over a one-device-per-process mesh moves each piece to its
    owner; the P received pieces k-way merge through the native pairwise
    tournament.

    Returns (my_values, my_counts, b_offset) where b_offset = total counts
    owned by lower ranges (the B-rank of this range's first insertion).
    `stats`, when given, receives exchange telemetry (exchange_width,
    recv_runs, sent_runs) for peak-memory assertions.
    """
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..models.spill import _merge_sorted_parts

    pid, nproc = process_info()
    if nproc == 1:
        if stats is not None:
            stats.update(exchange_width=0, recv_runs=values.size,
                         sent_runs=values.size)
        return values, counts, 0

    # --- splitters from count-mass-weighted samples (small, replicated) --
    # Interleave work per range is POSITIONS (sum of counts + A-span), not
    # runs: a collection where a few runs carry huge counts would balance
    # run counts yet skew the per-range interleave.  So sample values at
    # local count-mass quantiles, carry the mass each sample represents,
    # and cut at global mass quantiles.  Payloads cross processes as int32
    # word pairs (jax x64 is off).
    r = oversample
    if values.size:
        cm = np.cumsum(counts, dtype=np.int64)
        targets = (np.arange(r, dtype=np.int64) * cm[-1]) // r
        idx = np.minimum(np.searchsorted(cm, targets, side="right"),
                         values.size - 1)
        samp = values[idx]
        wts = np.full(r, max(int(cm[-1]) // r, 1), np.int64)
    else:
        samp = np.full(r, np.int64(2**62))  # empty: never attracts a range
        wts = np.zeros(r, np.int64)
    allp = _allgather_i64(np.concatenate([samp, wts]))
    all_samp = allp[:, :r].reshape(-1)
    all_wts = allp[:, r:].reshape(-1)
    order = np.argsort(all_samp, kind="stable")
    all_samp = all_samp[order]
    cw = np.cumsum(all_wts[order], dtype=np.int64)
    total_w = max(int(cw[-1]), 1)
    qmass = (np.arange(1, nproc, dtype=np.int64) * total_w) // nproc
    splitters = all_samp[np.minimum(
        np.searchsorted(cw, qmass, side="right"), all_samp.size - 1)]

    # --- bucket the local runs by owner ----------------------------------
    cuts = np.concatenate(([0], np.searchsorted(values, splitters),
                           [values.size]))
    piece_runs = np.diff(cuts).astype(np.int64)             # [P]
    piece_count_sums = np.asarray(
        [counts[cuts[q]:cuts[q + 1]].sum() for q in range(nproc)],
        dtype=np.int64)

    sizes = _allgather_i64(piece_runs)                                 # [P,P]
    count_sums = _allgather_i64(piece_count_sums)                      # [P,P]
    w = max(int(sizes.max()), 1)
    if stats is not None:
        stats.update(exchange_width=w,
                     recv_runs=int(sizes[:, pid].sum()),
                     sent_runs=int(values.size))

    # --- one all_to_all over the process mesh ----------------------------
    # payload rows per piece: value lo/hi words, count lo/hi words
    send = np.zeros((nproc, 4, w), np.int32)
    for q in range(nproc):
        v = values[cuts[q]:cuts[q + 1]]
        c = counts[cuts[q]:cuts[q + 1]]
        send[q, 0, :v.size], send[q, 1, :v.size] = _split_words(v)
        send[q, 2, :v.size], send[q, 3, :v.size] = _split_words(c)

    mesh = Mesh(np.array(_one_device_per_process()), ("proc",))
    sharding = NamedSharding(mesh, P("proc"))
    g = jax.make_array_from_process_local_data(
        sharding, send.reshape(1, nproc, 4, w))

    def body(x):  # x: [1, P, 4, w] local -> [P, 1, 4, w] received
        return jax.lax.all_to_all(x, "proc", split_axis=1, concat_axis=0)

    out = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("proc"), out_specs=P("proc")))(g)
    recv = np.asarray(
        [s.data for s in out.addressable_shards][0]).reshape(nproc, 4, w)

    # --- merge the P received pieces -------------------------------------
    parts = []
    for p in range(nproc):
        n = int(sizes[p, pid])
        if n:
            parts.append((_join_words(recv[p, 0, :n], recv[p, 1, :n]),
                          _join_words(recv[p, 2, :n], recv[p, 3, :n])))
    if parts:
        my_values, my_counts = _merge_sorted_parts(parts)
        my_values = np.ascontiguousarray(my_values)
        my_counts = np.ascontiguousarray(my_counts)
    else:
        my_values = np.zeros(0, np.int64)
        my_counts = np.zeros(0, np.int64)
    b_offset = int(count_sums[:, :pid].sum())
    return my_values, my_counts, b_offset


def multihost_rank_array_ranged(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                                a_sequences: int, b_sequences: int,
                                frontier_cap: int = 1 << 16,
                                emit_cap: int = 1 << 22,
                                stats: Optional[dict] = None):
    """Search + rank-range exchange: returns THIS process's range of the
    global rank array.

    Returns (values, counts, b_offset, lo, hi, drain, overflow):
      values/counts — sorted-unique RA runs owned by this process
      b_offset      — total counts in lower ranges (B-rank of the range
                      start)
      lo, hi        — this process's half-open A-position range; the
                      ranges TILE [0, inf): lo_0 = 0, lo_{p+1} = hi_p, so
                      per-range interleaves concatenate to the full output
      drain         — True on exactly one process (the last NON-EMPTY
                      range): its shard appends A's tail after its runs
      overflow      — any process's device search overflowed (all re-run
                      through the host driver in that case)
    """
    from jax.experimental import multihost_utils

    pid, nproc = process_info()
    values, counts, overflow = _local_rank_array(
        a_idx, b_idx, a_sequences, b_sequences, frontier_cap, emit_cap)
    if nproc == 1:
        if stats is not None:
            stats.update(exchange_width=0, recv_runs=values.size,
                         sent_runs=values.size)
        return values, counts, 0, 0, np.int64(2**62), True, bool(overflow)

    # splitters are recomputed inside the exchange; the tiling range
    # boundaries come from the merged ranges' FIRST values (a tiny
    # allgather): boundary between p and p+1 = p+1's first value, so p's
    # shard advances A exactly to where p+1's begins.  Empty ranges
    # collapse to lo == hi (their A span is covered by the predecessor);
    # the A tail is drained by the LAST NON-EMPTY range (trailing empty
    # ranges own nothing).
    my_v, my_c, b_offset = exchange_by_rank_range(values, counts, stats=stats)
    first = np.int64(my_v[0]) if my_v.size else np.int64(-1)
    firsts = np.asarray(multihost_utils.process_allgather(first))

    def next_first(p):
        for q in range(p + 1, nproc):
            if firsts[q] >= 0:
                return np.int64(firsts[q])
        return np.int64(2**62)

    nonempty = [q for q in range(nproc) if firsts[q] >= 0]
    drain_pid = nonempty[-1] if nonempty else 0
    lo = np.int64(0) if pid == 0 else next_first(pid - 1)
    hi = next_first(pid)
    ovf = np.asarray(multihost_utils.process_allgather(np.bool_(overflow)))
    return (my_v, my_c, b_offset, int(lo), hi, pid == drain_pid,
            bool(ovf.any()))


def multihost_rank_array(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                         a_sequences: int, b_sequences: int,
                         frontier_cap: int = 1 << 16,
                         emit_cap: int = 1 << 22):
    """Full rank array on every process (compat surface for callers that
    need it — e.g. replicated-interleave drivers and tests).

    Built ON TOP of the rank-range exchange: the merge work is distributed
    (each process dedups only its own range), and the final allgather moves
    each merged run exactly once.  Production merges should prefer
    multihost_rank_array_ranged + multihost_merge_to_file, which never
    materialize more than O(|RA|/P) per process.
    """
    pid, nproc = process_info()
    if nproc == 1:
        v, c, ovf = _local_rank_array(a_idx, b_idx, a_sequences, b_sequences,
                                      frontier_cap, emit_cap)
        return v, c, bool(ovf)

    my_v, my_c, _off, _lo, _hi, _drain, ovf = multihost_rank_array_ranged(
        a_idx, b_idx, a_sequences, b_sequences, frontier_cap, emit_cap)

    all_n = _allgather_i64(np.asarray([my_v.size], np.int64)).reshape(-1)
    width = max(int(all_n.max()), 1)
    padded = np.zeros((2, width), dtype=np.int64)
    padded[0, :my_v.size] = my_v
    padded[1, :my_v.size] = my_c
    gathered = _allgather_i64(padded.reshape(-1)).reshape(nproc, 2, width)
    parts_v = [gathered[p, 0, :int(all_n[p])] for p in range(nproc)]
    parts_c = [gathered[p, 1, :int(all_n[p])] for p in range(nproc)]
    # ranges are disjoint and ascending by construction: concatenate
    return (np.concatenate(parts_v), np.concatenate(parts_c), ovf)


# -- sharded merge output ------------------------------------------------------


def _range_cursor(lens: np.ndarray, pos: int,
                  cum: Optional[np.ndarray] = None) -> Tuple[int, int]:
    """(run index, remaining-in-run) cursor at absolute position `pos` of an
    RLE stream (prefix-sum binary search, the host analog of
    interleave.cpp cursor_at).  Pass a precomputed `cum` (np.cumsum(lens))
    when calling per-fragment — recomputing it is O(runs) per call."""
    if pos <= 0:
        return 0, int(lens[0]) if lens.size else 0
    if cum is None:
        cum = np.cumsum(lens)
    run = int(np.searchsorted(cum, pos, side="right"))
    if run >= lens.size:
        return int(lens.size), 0
    return run, int(cum[run] - pos)


def interleave_range_chunks(a_runs, b_runs, ra_chunks, lo: int, hi: int,
                            b_offset: int, last: bool,
                            chunk_runs: int = 1 << 20,
                            a_cum: Optional[np.ndarray] = None,
                            b_cum: Optional[np.ndarray] = None):
    """Generator of merged (syms, lens) run chunks for ONE A-position range
    [lo, hi) of the interleave, given that range's ascending RA chunks and
    the B-rank offset of its first insertion.

    The stateful native kernel is initialized at the range cursors (A at
    position lo, B at rank b_offset); after the RA runs, A is advanced to
    `hi` with a synthetic zero-count entry (`last` drains A's tail
    instead).  The trailing run is NOT withheld — the shard concatenator
    coalesces seams.  Shards produced for consecutive ranges concatenate
    into exactly the full interleave's run stream (up to seam splits).
    """
    from ..native.api import _as_i64, _as_u8, _configure_stream_interleave, _lib

    lib = _lib()
    _configure_stream_interleave(lib)
    a_syms, a_lens = _as_u8(a_runs.syms), _as_i64(a_runs.lens)
    b_syms, b_lens = _as_u8(b_runs.syms), _as_i64(b_runs.lens)

    state = np.zeros(7, np.int64)
    state[0], state[1] = _range_cursor(a_lens, lo, a_cum)
    state[2], state[3] = _range_cursor(b_lens, b_offset, b_cum)
    state[4] = lo

    def run(rv, rc, finish):
        rv, rc = _as_i64(rv), _as_i64(rc)
        # emitted-run bound: A fragments (touched runs + one split per RA
        # run) + B fragments likewise — position spans bound the touched
        # runs but must not drive the allocation (a sparse range's span can
        # be orders of magnitude larger than its run count)
        span = (int(rv[-1]) - int(state[4])) if rv.size else 0
        cap = (min(max(span, 0), a_lens.size + 1)
               + min(int(rc.sum()), b_lens.size + 1) + 2 * rv.size + 16)
        if finish:
            cap += a_lens.size + 2
        out_s = np.empty(cap, np.uint8)
        out_l = np.empty(cap, np.int64)
        n = lib.interleave_chunk(a_syms, a_lens, a_syms.size,
                                 b_syms, b_lens, b_syms.size,
                                 rv, rc, rv.size, 1 if finish else 0,
                                 cap, state, out_s, out_l)
        if n == -1:
            raise ValueError("rank-array range inconsistent with inputs")
        if n < 0:
            raise RuntimeError(f"native interleave_chunk failed (code {n})")
        return out_s[:n], out_l[:n]

    for rv, rc in ra_chunks:
        if len(rv) == 0:
            continue
        s, l = run(rv, rc, finish=False)
        if s.size:
            yield s, l
    if last:
        s, l = run(np.zeros(0, np.int64), np.zeros(0, np.int64), finish=True)
        if s.size:
            yield s, l
    else:
        # advance A to the range end with a zero-count entry, then flush
        # the withheld trailing run (the next shard starts at a_pos = hi).
        # Collapsed (empty, lo == hi) ranges have nothing to advance.
        if hi > int(state[4]):
            s, l = run(np.asarray([hi], np.int64),
                       np.asarray([0], np.int64), finish=False)
            if s.size:
                yield s, l
        if state[6] > 0:
            yield (np.asarray([state[5]], np.uint8),
                   np.asarray([state[6]], np.int64))
            state[6] = 0


def coalesce_run_chunks(chunks):
    """Re-establish maximal runs across a chunk stream whose boundaries may
    split runs (shard seams): withholds each chunk's trailing run and
    merges it with the next chunk's head when the symbols match."""
    pend = None  # (sym, len)
    for syms, lens in chunks:
        if syms.size == 0:
            continue
        syms = np.asarray(syms, np.uint8)
        lens = np.asarray(lens, np.int64)
        if pend is not None:
            if syms[0] == pend[0]:
                lens = lens.copy()
                lens[0] += pend[1]
            else:
                yield (np.asarray([pend[0]], np.uint8),
                       np.asarray([pend[1]], np.int64))
        pend = (int(syms[-1]), int(lens[-1]))
        if syms.size > 1:
            yield syms[:-1], lens[:-1]
    if pend is not None:
        yield (np.asarray([pend[0]], np.uint8),
               np.asarray([pend[1]], np.int64))


def _fragment_seam_plan(n_runs, head_sym, head_len, tail_sym):
    """Cross-fragment run coalescing, decided from per-fragment boundary
    metadata alone (deterministic on every process).  Each coalesced run is
    owned by the fragment contributing its FIRST piece: fragment p drops its
    head run when it continues the pending run, and the owner's tail run
    grows by the absorbed lengths (chains through single-run fragments).
    Returns (drop_head[P] bool, extra_tail[P] int64)."""
    nproc = len(n_runs)
    drop_head = np.zeros(nproc, bool)
    extra_tail = np.zeros(nproc, np.int64)
    pend_owner = -1
    pend_sym = -1
    for p in range(nproc):
        if n_runs[p] == 0:
            continue
        if pend_owner >= 0 and head_sym[p] == pend_sym:
            drop_head[p] = True
            extra_tail[pend_owner] += head_len[p]
            if n_runs[p] == 1:
                continue          # fully absorbed; the pending run lives on
        pend_owner, pend_sym = p, int(tail_sym[p])
    return drop_head, extra_tail


def multihost_merge_to_file(a, b, path: str, fmt: str = "native",
                            shard_dir: Optional[str] = None,
                            frontier_cap: int = 1 << 16,
                            emit_cap: int = 1 << 22,
                            stats: Optional[dict] = None) -> None:
    """Fully distributed merge: every process searches its B-block,
    receives its A-range of the rank array (rank-range exchange),
    interleaves that range, and ENCODES its fragment of the output file's
    byte stream itself — resuming the format's position-dependent 64-byte
    block rule at its global byte offset (native rle codec support.h:256-282;
    codec.cpp rle_encode_at semantics).  Process 0 only writes headers,
    concatenates the encoded fragment files, and (native) stitches the
    per-block sample tables; it never decodes or re-encodes run data, so no
    process performs an O(total output) encode pass.

    Cross-fragment coordination is three O(P)-sized collectives: boundary
    runs (seam coalescing), per-fragment char counts (prefix state), and
    64-phase size tables (fragment_phase_table) from which every process
    composes the global byte offsets locally.

    Per-process peak: inputs + O(|RA|/P) rank array + O(output/P) fragment.
    `shard_dir` must be shared across processes (defaults to the output's
    directory — multi-host deployments point it at the shared filesystem
    the output itself lives on).
    """
    import shutil

    from jax.experimental import multihost_utils

    from ..formats.streaming import (NativeFragmentWriter, SGAFragmentWriter,
                                     write_bwt_stream, write_native_tail)
    from ..formats.headers import NativeHeader, SGAHeader
    from ..models.runs import SIGMA, RunArrays
    from ..native import fragment_phase_table

    if fmt not in ("native", "sga"):
        raise ValueError(f"no distributed fragment writer for format: {fmt}")

    pid, nproc = process_info()
    shard_dir = shard_dir or (os.path.dirname(os.path.abspath(path)) or ".")

    my_v, my_c, b_offset, lo, hi, drain, ovf = multihost_rank_array_ranged(
        a.device_index, b.device_index, a.sequences(), b.sequences(),
        frontier_cap=frontier_cap, emit_cap=emit_cap, stats=stats)
    if ovf:
        raise RuntimeError("device search overflowed its static buffers; "
                           "re-run with larger caps")

    def ra_chunks():
        step = 1 << 20
        for s in range(0, my_v.size, step):
            yield my_v[s:s + step], my_c[s:s + step]

    range_chunks = interleave_range_chunks(
        a.runs, b.runs, ra_chunks(), lo, int(min(hi, np.int64(2**62))),
        b_offset, last=drain)

    if nproc == 1:
        write_bwt_stream(path, fmt, coalesce_run_chunks(range_chunks),
                         a.alpha)
        return

    # --- this process's fragment, as maximal runs -------------------------
    parts = list(range_chunks)
    syms = (np.concatenate([p[0] for p in parts]) if parts
            else np.zeros(0, np.uint8))
    lens = (np.concatenate([p[1] for p in parts]) if parts
            else np.zeros(0, np.int64))
    del parts
    frag = RunArrays(syms, lens.astype(np.int64)).coalesced()
    syms, lens = frag.syms, frag.lens
    if stats is not None:
        stats["shard_runs"] = int(syms.size)

    # --- seam plan from boundary metadata (one tiny allgather) ------------
    meta = np.zeros(4, np.int64)
    if syms.size:
        meta[:] = (syms.size, syms[0], lens[0], syms[-1])
    bounds = _allgather_i64(meta)                       # [P, 4]
    drop_head, extra_tail = _fragment_seam_plan(
        bounds[:, 0], bounds[:, 1], bounds[:, 2], bounds[:, 3])
    if drop_head[pid]:
        syms, lens = syms[1:], lens[1:]
    if extra_tail[pid]:
        lens = lens.copy()
        lens[-1] += extra_tail[pid]

    # --- global prefix state (char counts) + 64-phase size tables ---------
    counts = np.zeros(SIGMA, np.int64)
    for c in range(SIGMA):
        counts[c] = int(np.sum(lens[syms == c], dtype=np.int64))
    tab = fragment_phase_table(syms, lens)              # [2, 64]
    g = _allgather_i64(np.concatenate([counts, tab.reshape(-1)]))
    all_counts = g[:, :SIGMA]                           # [P, SIGMA]
    tabs = g[:, SIGMA:].reshape(nproc, 2, 64)
    # compose the offset chain: fragment p's size depends only on its start
    # phase (offset mod 64), so every process resolves all offsets locally
    off = 0
    start_off = frag_bytes = frag_codes = 0
    total_codes = 0
    for p in range(nproc):
        nb = int(tabs[p, 0, off % 64])
        nc = int(tabs[p, 1, off % 64])
        if p == pid:
            start_off, frag_bytes, frag_codes = off, nb, nc
        total_codes += nc
        off += nb
    total_bytes = off
    total_counts = all_counts.sum(axis=0)
    prefix_counts = (all_counts[:pid].sum(axis=0) if pid
                     else np.zeros(SIGMA, np.int64))

    # --- encode THIS fragment only ----------------------------------------
    frag_path = os.path.join(shard_dir, f".bwtmerge_frag_{pid}.bytes")
    samp_path = os.path.join(shard_dir, f".bwtmerge_frag_{pid}_samples.npz")
    step = 1 << 20
    with open(frag_path, "wb") as f:
        if fmt == "sga":
            w = SGAFragmentWriter(f, start_off)
            for s in range(0, syms.size, step):
                w.write_chunk(syms[s:s + step], lens[s:s + step])
            assert w.n_codes == frag_codes, (w.n_codes, frag_codes)
        else:
            w = NativeFragmentWriter(f, start_off, prefix_counts)
            for s in range(0, syms.size, step):
                w.write_chunk(syms[s:s + step], lens[s:s + step])
            assert w.n_bytes_written - start_off == frag_bytes, \
                (w.n_bytes_written, start_off, frag_bytes)
            ids, end, cc = w.finish()
            np.savez(samp_path, ids=ids, end=end, cc=cc)
    if stats is not None:
        stats["frag_bytes"] = int(frag_bytes)
        stats["frag_offset"] = int(start_off)

    multihost_utils.sync_global_devices("bwtmerge fragments written")

    # --- process 0: headers + byte concatenation + sample stitch ----------
    if pid == 0:
        alpha = type(a.alpha)(
            char2comp=a.alpha.char2comp.copy(),
            comp2char=a.alpha.comp2char.copy(),
            C=(a.alpha.C.astype(np.int64)
               + b.alpha.C.astype(np.int64)).astype(np.uint64),
        )
        with open(path, "wb") as out:
            if fmt == "sga":
                out.write(SGAHeader(sequences=int(total_counts[0]),
                                    bases=int(total_counts.sum()),
                                    bytes_=total_codes).to_bytes())
            else:
                out.write(b"\x00" * (NativeHeader.SIZE + 8))
            for p in range(nproc):
                fp = os.path.join(shard_dir, f".bwtmerge_frag_{p}.bytes")
                with open(fp, "rb") as src:
                    shutil.copyfileobj(src, out, 16 * 1024 * 1024)
                os.remove(fp)
            if fmt == "native":
                ids_l, end_l, cc_l = [], [], []
                for p in range(nproc):
                    sp = os.path.join(shard_dir,
                                      f".bwtmerge_frag_{p}_samples.npz")
                    with np.load(sp) as z:
                        ids_l.append(z["ids"])
                        end_l.append(z["end"])
                        cc_l.append(z["cc"])
                    os.remove(sp)
                ids = np.concatenate(ids_l)
                end = np.concatenate(end_l)
                cc = np.vstack(cc_l)
                # seam blocks are reported by both neighbours; the LATER row
                # carries the complete cumulative stats (global prefix state)
                keep = np.ones(ids.size, bool)
                keep[:-1] = ids[:-1] != ids[1:]
                write_native_tail(out, total_bytes, end[keep], cc[keep],
                                  total_counts, alpha)
    multihost_utils.sync_global_devices("bwtmerge output written")
