"""Multi-chip sharding on the 8-device virtual CPU mesh: sharded rank-array
search and sharded pattern verification vs single-device oracles."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bwtmerge_tpu.models import oracle
from bwtmerge_tpu.models.fmi import FMI
from bwtmerge_tpu.ops import search_np
from bwtmerge_tpu.ops.rank_jax import DeviceFMIndex
from bwtmerge_tpu.parallel import (
    make_mesh,
    sequence_shards,
    sharded_backward_search,
    sharded_rank_array,
)


def _fmi(seqs):
    return FMI.from_runs(oracle.build_bwt(seqs))


class TestSequenceShards:
    def test_partition_covers_all(self):
        bounds = sequence_shards(13, 4)
        assert bounds.shape == (4, 2)
        covered = []
        for sp, ep in bounds:
            covered.extend(range(sp, ep + 1))
        assert covered == list(range(13))

    def test_more_shards_than_sequences(self):
        bounds = sequence_shards(3, 8)
        lens = [max(0, ep - sp + 1) for sp, ep in bounds]
        assert sum(lens) == 3
        assert all(l in (0, 1) for l in lens)


class TestShardedRankArray:
    def test_matches_single_device(self, rng):
        a_seqs = oracle.random_collection(rng, 8, 10, 60)
        b_seqs = oracle.random_collection(rng, 12, 10, 60)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())

        mesh = make_mesh(8)
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        v, c, overflow = sharded_rank_array(
            a_idx, b_idx, a.sequences(), b.sequences(), mesh=mesh,
            frontier_cap=2048, emit_cap=32768)
        assert not overflow
        assert np.array_equal(v, want[0])
        assert np.array_equal(c, want[1])

    def test_sharded_packed_ra_stream_matches(self, rng):
        """ShardedPackedRA: per-device packed buffers stream through the
        k-way chunk merge and equal the materialized sharded rank array."""
        from bwtmerge_tpu.parallel.mesh import sharded_packed_ra

        a_seqs = oracle.random_collection(rng, 8, 10, 60)
        b_seqs = oracle.random_collection(rng, 12, 10, 60)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        mesh = make_mesh(8)
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        want_v, want_c, overflow = sharded_rank_array(
            a_idx, b_idx, a.sequences(), b.sequences(), mesh=mesh,
            frontier_cap=2048, emit_cap=32768)
        assert not overflow

        packed = sharded_packed_ra(
            a_idx, b_idx, a.sequences(), b.sequences(), mesh=mesh,
            frontier_cap=2048, emit_cap=32768)
        assert packed is not None
        assert packed.n_runs >= want_v.size  # pre-merge runs may overlap
        # tiny chunks force boundary handling in the k-way merge
        parts = list(packed.stream(chunk_runs=173))
        prev_last = -1
        for pv, _ in parts:
            assert np.all(np.diff(pv) > 0)
            assert pv[0] > prev_last  # chunks never overlap
            prev_last = int(pv[-1])
        got_v = np.concatenate([p[0] for p in parts])
        got_c = np.concatenate([p[1] for p in parts])
        assert np.array_equal(got_v, want_v)
        assert np.array_equal(got_c, want_c)

    def test_merge_ra_chunk_streams_host(self, rng):
        """Pure-host k-way chunk merge: overlapping ascending streams sum
        their duplicate values."""
        from bwtmerge_tpu.models.spill import merge_ra_chunk_streams
        from bwtmerge_tpu.ops.search_np import compact_rank_array

        streams, all_v, all_c = [], [], []
        for _ in range(3):
            n = int(rng.integers(50, 400))
            v = np.sort(rng.choice(5000, size=n, replace=False)).astype(np.int64)
            c = rng.integers(1, 9, size=n).astype(np.int64)
            all_v.append(v)
            all_c.append(c)
            # split into ragged chunks
            cuts = np.sort(rng.choice(np.arange(1, n), size=min(5, n - 1),
                                      replace=False))
            streams.append([(v[s:e], c[s:e]) for s, e in
                            zip(np.r_[0, cuts], np.r_[cuts, n])])
        want = compact_rank_array(np.concatenate(all_v), np.concatenate(all_c))
        parts = list(merge_ra_chunk_streams(streams, chunk_runs=64))
        got_v = np.concatenate([p[0] for p in parts])
        got_c = np.concatenate([p[1] for p in parts])
        assert np.array_equal(got_v, want[0])
        assert np.array_equal(got_c, want[1])

    def test_overflow_flag(self, rng):
        a_seqs = oracle.random_collection(rng, 8, 10, 60)
        b_seqs = oracle.random_collection(rng, 12, 10, 60)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        _, _, overflow = sharded_rank_array(
            a_idx, b_idx, a.sequences(), b.sequences(), mesh=make_mesh(2),
            frontier_cap=128, emit_cap=64)
        assert overflow


class TestShardedVerification:
    def test_counts_match_host(self, rng):
        seqs = oracle.random_collection(rng, 10, 10, 60)
        fmi = _fmi(seqs)
        idx = DeviceFMIndex.build(fmi.runs, fmi.alpha.counts())

        pats = [np.asarray(s[:5]) for s in seqs[:7]]
        max_len = 5
        pat = np.zeros((len(pats), max_len), dtype=np.int32)
        lens = np.zeros(len(pats), dtype=np.int32)
        for i, p in enumerate(pats):
            pat[i, : p.size] = p
            lens[i] = p.size

        counts = sharded_backward_search(
            idx, jnp.asarray(pat), jnp.asarray(lens), max_len, mesh=make_mesh(8))
        want = np.array([fmi.count(p) for p in pats])
        assert np.array_equal(np.asarray(counts), want)


class TestShardedMerge:
    def test_merge_fmi_devices8(self, rng):
        from bwtmerge_tpu.models.merge import MergeConfig, merge_fmi

        a_seqs = oracle.random_collection(rng, 8, 10, 60)
        b_seqs = oracle.random_collection(rng, 12, 10, 60)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        cfg = MergeConfig(backend="jax", devices=8)
        merged = merge_fmi(a, b, cfg)
        assert merged.runs == oracle.merge_collections([a_seqs, b_seqs])


class TestMultihostSingleProcess:
    def test_degrades_to_local(self, rng):
        """multihost_rank_array with one process == local rank array."""
        from bwtmerge_tpu.parallel.distributed import (
            multihost_rank_array, process_info)

        assert process_info() == (0, 1)
        a_seqs = oracle.random_collection(rng, 8, 10, 60)
        b_seqs = oracle.random_collection(rng, 10, 10, 60)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        v, c, ovf = multihost_rank_array(
            a_idx, b_idx, a.sequences(), b.sequences(),
            frontier_cap=2048, emit_cap=32768)
        assert not ovf
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())
        assert np.array_equal(v, want[0])
        assert np.array_equal(c, want[1])


class TestBlockShardedIndex:
    def test_ranks_match_replicated(self, rng):
        import jax.numpy as jnp
        from bwtmerge_tpu.ops.rank_sharded import ShardedFMIndex

        seqs = oracle.random_collection(rng, 10, 20, 80)
        fmi = _fmi(seqs)
        mesh = make_mesh(8)
        sharded = ShardedFMIndex.build(fmi.runs, fmi.alpha.counts(), mesh=mesh)
        local = DeviceFMIndex.build(fmi.runs, fmi.alpha.counts())

        q = rng.integers(0, fmi.size() + 1, size=256).astype(np.int32)
        want = np.asarray(local.ranks_all(jnp.asarray(q)))
        got = np.asarray(sharded.ranks_all(jnp.asarray(q), mesh))
        assert np.array_equal(got, want)

    def test_build_streams_slabs_within_device_budget(self, rng, monkeypatch):
        """The block-sharded build must never materialize the whole record
        table on one device (VERDICT: the HBM-exceeding claim needs a build
        that streams slabs).  Per-device budget: one slab + padding."""
        import jax.numpy as jnp
        from bwtmerge_tpu.ops.rank_jax import REC, DeviceFMIndex as DFI
        from bwtmerge_tpu.ops.rank_sharded import ShardedFMIndex

        seqs = oracle.random_collection(rng, 40, 100, 300)
        fmi = _fmi(seqs)
        # reference answers BEFORE patching the full build away
        local = DFI.build(fmi.runs, fmi.alpha.counts())
        q = rng.integers(0, fmi.size() + 1, size=128).astype(np.int32)
        want = np.asarray(local.ranks_all(jnp.asarray(q)))

        def boom(*a, **k):
            raise AssertionError(
                "ShardedFMIndex.build materialized a full single-device index")

        monkeypatch.setattr(DFI, "build", classmethod(boom))
        mesh = make_mesh(8)
        sharded = ShardedFMIndex.build(fmi.runs, fmi.alpha.counts(), mesh=mesh)

        total_bytes = sharded.rec.shape[0] * REC * 4
        budget = sharded.slab * REC * 4  # one slab per device
        for s in sharded.rec.addressable_shards:
            assert s.data.nbytes <= budget
        assert total_bytes >= 8 * (budget - 32 * REC * 4)  # really sharded

        got = np.asarray(sharded.ranks_all(jnp.asarray(q), mesh))
        assert np.array_equal(got, want)

    def test_backward_search_blocked(self, rng):
        from bwtmerge_tpu.ops.rank_sharded import (
            ShardedFMIndex, sharded_backward_search_blocked)

        seqs = oracle.random_collection(rng, 8, 10, 60)
        fmi = _fmi(seqs)
        mesh = make_mesh(8)
        sharded = ShardedFMIndex.build(fmi.runs, fmi.alpha.counts(), mesh=mesh)

        pats = [np.asarray(s[:6]) for s in seqs[:5]]
        max_len = 6
        pat = np.zeros((len(pats), max_len), dtype=np.int64)
        lens = np.zeros(len(pats), dtype=np.int64)
        for i, p in enumerate(pats):
            pat[i, : p.size] = p
            lens[i] = p.size
        counts = sharded_backward_search_blocked(sharded, mesh, pat, lens)
        want = np.array([fmi.count(p) for p in pats])
        assert np.array_equal(counts, want)

    def test_wavefront_sharded_index(self, rng):
        from bwtmerge_tpu.ops.rank_sharded import (
            ShardedFMIndex, wavefront_search_sharded)

        a_seqs = oracle.random_collection(rng, 8, 10, 60)
        b_seqs = oracle.random_collection(rng, 10, 10, 60)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())

        mesh = make_mesh(8)
        a_sh = ShardedFMIndex.build(a.runs, a.alpha.counts(), mesh=mesh)
        b_sh = ShardedFMIndex.build(b.runs, b.alpha.counts(), mesh=mesh)
        v, c, ovf = wavefront_search_sharded(
            a_sh, b_sh, mesh, 0, b.sequences() - 1, a.sequences(),
            frontier_cap=2048, emit_cap=32768)
        assert not ovf
        got = search_np.compact_rank_array(v, c)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])

    def test_merge_to_file_sharded_placement(self, rng, tmp_path):
        """End-to-end product path on the 8-device mesh with block-sharded
        indexes (VERDICT r2 #4): merge_fmi_to_file with
        index_placement='sharded' routes the search through
        ShardedFMIndex + wavefront_search_sharded, streams the rank array
        through the spill ladder into the native interleave and a format
        writer, and every device holds only its slab of each record table
        (per-device budget asserted)."""
        from bwtmerge_tpu.formats import read_bwt
        from bwtmerge_tpu.models.merge import (MergeConfig, merge_fmi,
                                               merge_fmi_to_file)
        from bwtmerge_tpu.ops.rank_jax import REC
        from bwtmerge_tpu.ops.rank_sharded import ShardedFMIndex

        a_seqs = oracle.random_collection(rng, 30, 12, 90)
        b_seqs = oracle.random_collection(rng, 26, 14, 90)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        want = oracle.merge_collections([a_seqs, b_seqs])

        # per-device record-table budget: slab rows only, never the table
        mesh = make_mesh(8)
        for fmi in (a, b):
            idx = ShardedFMIndex.build(fmi.runs, fmi.alpha.counts(),
                                       mesh=mesh)
            total = idx.rec.shape[0] * REC * 4
            for s in idx.rec.addressable_shards:
                assert s.data.nbytes <= total // 8 + REC * 4

        out = str(tmp_path / "sharded.sga")
        cfg = MergeConfig(backend="jax", devices=8,
                          index_placement="sharded", sequence_blocks=2)
        merge_fmi_to_file(a, b, out, "sga", cfg)
        got, _, _ = read_bwt(out, "sga")
        assert got == want

        # merge_fmi takes the same path (full in-memory result)
        cfg2 = MergeConfig(backend="jax", devices=8,
                           index_placement="sharded", sequence_blocks=3)
        merged = merge_fmi(a, b, cfg2)
        assert merged.runs == want

        # the auto heuristic with a tiny budget also picks the sharded path
        cfg3 = MergeConfig(backend="jax", devices=8, index_placement="auto",
                           hbm_budget_bytes=64)
        merged = merge_fmi(a, b, cfg3)
        assert merged.runs == want


class TestDynamicScheduling:
    def test_weighted_shards_balance_bases(self):
        from bwtmerge_tpu.parallel import sequence_shards_weighted

        # pathological skew: 32 reads of 200 bases then 800 of 10
        lens = np.array([200] * 32 + [10] * 800, np.int64)
        bounds = sequence_shards_weighted(lens, 8)
        # contiguous cover
        covered = []
        for sp, ep in bounds:
            covered.extend(range(sp, ep + 1))
        assert covered == list(range(lens.size))
        per = np.array([lens[sp:ep + 1].sum() for sp, ep in bounds])
        mean = lens.sum() / 8
        assert per.max() <= 1.25 * mean, per  # one read granularity
        # equal-count shards for comparison: shard 0 carries ~4x the mean
        naive = sequence_shards(lens.size, 8)
        naive_per = np.array([lens[sp:ep + 1].sum() for sp, ep in naive])
        assert naive_per.max() > 3 * mean

    def test_dynamic_queue_balances_skewed_reads(self, rng):
        """Pathologically skewed read lengths across 8 virtual devices:
        base-weighted blocks pulled from the dynamic queue keep per-device
        emitted-run imbalance <= 15% (VERDICT r2 #6; the reference gets
        this from its atomic block counter, utils.cpp:204-209)."""
        from bwtmerge_tpu.parallel import dynamic_block_search

        # B: 16 long reads (120 bases) then 960 short (20 bases) — sized so
        # one read is well under the 15% balance target per shard
        b_seqs = ([rng.integers(1, 5, size=120).astype(np.int64)
                   for _ in range(16)]
                  + [rng.integers(1, 5, size=20).astype(np.int64)
                     for _ in range(960)])
        a_seqs = oracle.random_collection(rng, 40, 30)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())

        from bwtmerge_tpu.ops.search_jax import RankArrayAccumulator

        lens = np.array([s.size for s in b_seqs], np.int64)
        acc = RankArrayAccumulator()
        stats = {}
        dynamic_block_search(
            a.device_index, b.device_index, a.sequences(), b.sequences(),
            acc.emit, n_blocks=8, mesh=make_mesh(8),
            b_size=b.size(), weights=lens + 1, stats=stats)
        got = acc.finish()
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])

        # base-weighted blocks: per-shard emitted runs within 15% of the
        # mean (equal-count shards would give shard 0 ~4x the mean)
        per = np.array(stats["per_block_runs"], np.float64)
        mean = per.sum() / per.size
        imbalance = (per.max() - mean) / mean
        assert imbalance <= 0.15, (per, imbalance)

        # the dynamic queue covers the unknown-weight case: every device
        # participated and every block ran exactly once
        assert stats["n_blocks"] == 8
        acc2 = RankArrayAccumulator()
        stats2 = {}
        dynamic_block_search(
            a.device_index, b.device_index, a.sequences(), b.sequences(),
            acc2.emit, n_blocks=64, mesh=make_mesh(8),
            b_size=b.size(), stats=stats2)
        got2 = acc2.finish()
        assert np.array_equal(got2[0], want[0])
        assert np.array_equal(got2[1], want[1])
        assert len(stats2["per_block_runs"]) == stats2["n_blocks"] == 64


class TestRangeInterleave:
    def test_range_shards_concatenate_to_full_interleave(self, rng):
        """interleave_range_chunks over consecutive A-position ranges +
        coalesce_run_chunks must reproduce the full interleave exactly —
        the single-process core of the multihost sharded merge output."""
        from bwtmerge_tpu.native import interleave_native
        from bwtmerge_tpu.parallel.distributed import (coalesce_run_chunks,
                                                       interleave_range_chunks)

        a_seqs = oracle.random_collection(rng, 12, 10, 70)
        b_seqs = oracle.random_collection(rng, 9, 10, 70)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        v, c = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())
        want = interleave_native(a.runs, b.runs, v, c)

        for n_ranges in (1, 2, 5):
            # range boundaries at value quantiles, lo_0 = 0, tiling
            cuts = [0] + [int(v[(k * v.size) // n_ranges])
                          for k in range(1, n_ranges)] + [2**62]
            parts = []
            cum = np.concatenate(([0], np.cumsum(c)))
            for k in range(n_ranges):
                lo, hi = cuts[k], cuts[k + 1]
                sel = (v >= lo) & (v < hi)
                b_off = int(cum[np.searchsorted(v, lo, side="left")])
                parts.append(list(interleave_range_chunks(
                    a.runs, b.runs, iter([(v[sel], c[sel])]),
                    lo, min(hi, 2**62), b_off,
                    last=(k == n_ranges - 1), chunk_runs=37)))
            merged = list(coalesce_run_chunks(
                ch for p in parts for ch in p))
            got_s = np.concatenate([m[0] for m in merged])
            got_l = np.concatenate([m[1] for m in merged])
            assert np.array_equal(got_s, want.syms), n_ranges
            assert np.array_equal(got_l, want.lens), n_ranges

    def test_empty_middle_range_collapses(self, rng):
        """A range with no RA values (lo == hi) contributes nothing and the
        neighbors still tile the output."""
        from bwtmerge_tpu.native import interleave_native
        from bwtmerge_tpu.parallel.distributed import (coalesce_run_chunks,
                                                       interleave_range_chunks)

        a_seqs = oracle.random_collection(rng, 5, 8, 40)
        b_seqs = oracle.random_collection(rng, 4, 8, 40)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        v, c = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())
        want = interleave_native(a.runs, b.runs, v, c)
        mid = int(v[v.size // 2])
        cum = np.concatenate(([0], np.cumsum(c)))
        b_mid = int(cum[np.searchsorted(v, mid, side="left")])
        sel0 = v < mid
        parts = (list(interleave_range_chunks(
                    a.runs, b.runs, iter([(v[sel0], c[sel0])]),
                    0, mid, 0, last=False))
                 + list(interleave_range_chunks(   # empty collapsed range
                    a.runs, b.runs, iter([]), mid, mid, b_mid, last=False))
                 + list(interleave_range_chunks(
                    a.runs, b.runs, iter([(v[~sel0], c[~sel0])]),
                    mid, 2**62, b_mid, last=True)))
        merged = list(coalesce_run_chunks(iter(parts)))
        got_s = np.concatenate([m[0] for m in merged])
        got_l = np.concatenate([m[1] for m in merged])
        assert np.array_equal(got_s, want.syms)
        assert np.array_equal(got_l, want.lens)
