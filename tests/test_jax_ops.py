"""Device (JAX) kernels vs their numpy oracles: rank/LF, backward search,
wavefront rank-array construction, device interleave, end-to-end jax merge."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bwtmerge_tpu.models import oracle
from bwtmerge_tpu.models.fmi import FMI
from bwtmerge_tpu.models.merge import MergeConfig, merge_fmi
from bwtmerge_tpu.ops import search_np
from bwtmerge_tpu.ops.interleave_jax import interleave_jax
from bwtmerge_tpu.ops.rank_jax import DeviceFMIndex, backward_search, batch_count
from bwtmerge_tpu.ops.search_jax import (
    RankArrayAccumulator,
    build_rank_array_jax,
    wavefront_search,
    wavefront_search_device,
)


def _fmi(seqs):
    return FMI.from_runs(oracle.build_bwt(seqs))


@pytest.fixture
def pair(rng):
    a_seqs = oracle.random_collection(rng, 6, 5, 40)
    b_seqs = oracle.random_collection(rng, 5, 5, 40)
    return a_seqs, b_seqs, _fmi(a_seqs), _fmi(b_seqs)


class TestDeviceRank:
    def test_ranks_all_matches_numpy(self, pair):
        _, _, a, _ = pair
        idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        n = a.size()
        positions = np.arange(n + 1, dtype=np.int64)
        want = a.rank_index.ranks_all(positions)
        got = np.asarray(idx.ranks_all(jnp.asarray(positions, jnp.int32)))
        assert np.array_equal(got[:, :6], want)

    @pytest.mark.parametrize("n_seqs,length", [(4, 31), (8, 47), (3, 9)])
    def test_ranks_all_at_size_and_sentinel_tails(self, rng, n_seqs, length):
        """Queries at i == size (the extra record block) and batches whose
        tail is padded with the sentinel position size, across sizes that
        end on and off a 32-position block boundary."""
        seqs = [rng.integers(1, 5, size=length) for _ in range(n_seqs)]
        a = _fmi(seqs)
        n = a.size()
        idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        q = np.concatenate([np.arange(n + 1), np.full(64, n)])
        want = a.rank_index.ranks_all(q)
        got = np.asarray(idx.ranks_all(jnp.asarray(q, jnp.int32)))
        assert np.array_equal(got[:, :6], want)
        assert np.array_equal(got[-1, :6], a.alpha.counts())

    def test_rank_single_char(self, pair, rng):
        _, _, a, _ = pair
        idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        q = rng.integers(0, a.size() + 1, size=64)
        c = rng.integers(0, 6, size=64)
        want = a.rank_index.rank(q, c)
        got = np.asarray(idx.rank(jnp.asarray(q, jnp.int32), jnp.asarray(c, jnp.int32)))
        assert np.array_equal(got, want)

    def test_inverse_select_and_access(self, pair, rng):
        _, _, a, _ = pair
        idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        q = rng.integers(0, a.size(), size=64)
        want_rank, want_sym = a.rank_index.inverse_select(q)
        got_rank, got_sym = idx.inverse_select(jnp.asarray(q, jnp.int32))
        assert np.array_equal(np.asarray(got_sym), want_sym)
        assert np.array_equal(np.asarray(got_rank), want_rank)
        assert np.array_equal(np.asarray(idx.access(jnp.asarray(q, jnp.int32))),
                              a.rank_index.access(q))

    def test_LF_matches_host(self, pair, rng):
        _, _, a, _ = pair
        idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        q = rng.integers(0, a.size() + 1, size=32)
        got = np.asarray(idx.LF_all(jnp.asarray(q, jnp.int32)))[:, :6]
        want = a.LF_all(q)
        assert np.array_equal(got, want)


class TestBackwardSearch:
    def test_counts_match_host_find(self, pair, rng):
        a_seqs, _, a, _ = pair
        idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        patterns = []
        for s in a_seqs[:4]:
            if s.size >= 3:
                patterns.append(np.asarray(s[:3], dtype=np.int64))
        patterns.append(np.array([1, 2, 3], dtype=np.int64))  # maybe absent
        want = np.array([a.count(p) for p in patterns], dtype=np.int64)
        got = batch_count(idx, patterns, a.alpha.char2comp)
        assert np.array_equal(got, want)


class TestWavefront:
    def test_rank_array_matches_numpy(self, pair):
        _, _, a, b = pair
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())

        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        acc = RankArrayAccumulator()
        wavefront_search(a_idx, b_idx, (0, b.sequences() - 1), a.sequences(), acc.emit)
        got = acc.finish()
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])

    def test_device_driver_matches(self, pair):
        _, _, a, b = pair
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())

        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        values, counts, n, overflow = wavefront_search_device(
            a_idx, b_idx, jnp.int32(0), jnp.int32(b.sequences() - 1),
            a.sequences(), frontier_cap=4096, emit_cap=65536)
        assert not bool(overflow)
        got = search_np.compact_rank_array(
            np.asarray(values[:int(n)], dtype=np.int64),
            np.asarray(counts[:int(n)], dtype=np.int64))
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])

    def test_blocked_search_accumulates(self, pair):
        _, _, a, b = pair
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())

        class Cfg:
            sequence_blocks = 3
        got = build_rank_array_jax(a, b, Cfg)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


class TestDeviceInterleave:
    def test_matches_oracle_merge(self, pair):
        a_seqs, b_seqs, a, b = pair
        values, counts = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())
        merged = interleave_jax(a.runs, b.runs, values, counts)
        want = oracle.merge_collections([a_seqs, b_seqs])
        assert merged == want


class TestJaxMergeEndToEnd:
    def test_merge_backend_jax(self, pair):
        a_seqs, b_seqs, a, b = pair
        cfg = MergeConfig(backend="jax", sequence_blocks=2)
        merged = merge_fmi(a, b, cfg)
        want = oracle.merge_collections([a_seqs, b_seqs])
        assert merged.runs == want
        # pattern-count invariant (the reference's -v acceptance gate)
        for s in (a_seqs[0], b_seqs[0]):
            p = s[: min(4, s.size)]
            assert merged.count(p) == a.count(p) + b.count(p)


class TestPackedTransfer:
    def test_pack_unpack_round_trip(self, pair):
        import numpy as np
        from bwtmerge_tpu.ops.search_jax import (
            EXC_CAP, pack_ra_device, unpack_ra, unpack_ra4,
            wavefront_search_device)
        from bwtmerge_tpu.ops.search_np import compact_sorted_rank_array

        _, _, a, b = pair
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        v, c, n, ovf = wavefront_search_device(
            a_idx, b_idx, jnp.int32(0), jnp.int32(b.sequences() - 1),
            a.sequences(), frontier_cap=4096, emit_cap=65536)
        assert not bool(ovf)
        dc8, exc, exc4, esc, n_u, n_exc, n_exc4, n_esc2 = pack_ra_device(
            v, c, n)
        n_u, n_exc, n_exc4 = int(n_u), int(n_exc), int(n_exc4)
        assert n_exc <= EXC_CAP
        got_v, got_c = unpack_ra(np.asarray(dc8[:2, :n_u]), np.asarray(exc),
                                 n_u, n_exc)
        # the nibble plane must decode to the same runs
        nib_v, nib_c = unpack_ra4(np.asarray(dc8[2, :n_u]), np.asarray(esc),
                                  np.asarray(exc4), n_u, n_exc4)
        assert np.array_equal(nib_v, got_v)
        assert np.array_equal(nib_c, got_c)
        # ... and so must the pair-code plane + its escape stream
        from bwtmerge_tpu.ops.search_jax import unpack_ra_q4
        q4_v, q4_c = unpack_ra_q4(np.asarray(dc8[3]), np.asarray(esc),
                                  np.asarray(exc4), n_u, n_exc4)
        assert np.array_equal(q4_v, got_v)
        assert np.array_equal(q4_c, got_c)
        # pack_ra_device compacts on device: already sorted unique
        got = compact_sorted_rank_array(got_v, got_c)
        assert np.array_equal(got[0], got_v)
        assert np.array_equal(got[1], got_c)

        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])

    def test_wide_gaps_go_through_exceptions(self, rng):
        import numpy as np
        from bwtmerge_tpu.ops.search_jax import (pack_ra_device, unpack_ra,
                                                 unpack_ra4)

        # sparse large values -> every delta is wide (in BOTH packings)
        values = np.sort(rng.choice(10_000_000, size=300, replace=False))
        counts = rng.integers(1, 1000, size=300)
        E = 512
        v = jnp.zeros(E, jnp.int32).at[:300].set(jnp.asarray(values, jnp.int32))
        c = jnp.zeros(E, jnp.int32).at[:300].set(jnp.asarray(counts, jnp.int32))
        dc8, exc, exc4, esc, n_u, n_exc, n_exc4, n_esc2 = pack_ra_device(
            v, c, jnp.int32(300))
        assert int(n_u) == 300  # all values unique
        got_v, got_c = unpack_ra(np.asarray(dc8[:2, :300]), np.asarray(exc),
                                 300, int(n_exc))
        assert np.array_equal(got_v, values)
        assert np.array_equal(got_c, counts)
        # wide deltas: most escape pairs carry the value; only >254
        # outliers land in the exc4 table (values up to 10M, 300 lanes ->
        # most deltas exceed 254)
        assert int(n_exc4) > 0
        assert int(n_esc2) == 300  # every lane escapes (misses the table)
        nib_v, nib_c = unpack_ra4(np.asarray(dc8[2, :300]), np.asarray(esc),
                                  np.asarray(exc4), 300, int(n_exc4))
        assert np.array_equal(nib_v, values)
        assert np.array_equal(nib_c, counts)
        # pair-code plane: every lane escapes (wide pairs never hit the
        # table); (255, 255) pairs are overridden by exc4 rows
        from bwtmerge_tpu.ops.search_jax import unpack_ra_q4
        q4_v, q4_c = unpack_ra_q4(np.asarray(dc8[3]), np.asarray(esc),
                                  np.asarray(exc4), 300, int(n_exc4))
        assert np.array_equal(q4_v, values)
        assert np.array_equal(q4_c, counts)

    def test_device_compaction_sums_duplicates(self, rng):
        import numpy as np
        from bwtmerge_tpu.ops.search_jax import compact_ra_device
        from bwtmerge_tpu.ops.search_np import compact_rank_array

        # unsorted emissions with many duplicate a-positions (the raw shape
        # wavefront_search_device2 hands to pack_ra_device)
        n = 700
        e = 1024
        values = rng.integers(0, 150, size=n)  # ~5 duplicates per value
        counts = rng.integers(1, 300, size=n)
        v = jnp.zeros(e, jnp.int32).at[:n].set(jnp.asarray(values, jnp.int32))
        c = jnp.zeros(e, jnp.int32).at[:n].set(jnp.asarray(counts, jnp.int32))
        uv, uc, n_u = compact_ra_device(v, c, jnp.int32(n))
        n_u = int(n_u)
        want_v, want_c = compact_rank_array(values.astype(np.int64),
                                            counts.astype(np.int64))
        assert n_u == want_v.size
        assert np.array_equal(np.asarray(uv[:n_u]), want_v)
        assert np.array_equal(np.asarray(uc[:n_u]), want_c)


class TestSingletonSpecializedDriver:
    def test_matches_numpy(self, pair):
        from bwtmerge_tpu.ops.search_jax import wavefront_search_device2

        _, _, a, b = pair
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        v, c, n, ovf = wavefront_search_device2(
            a_idx, b_idx, jnp.int32(0), jnp.int32(b.sequences() - 1),
            a.sequences(), frontier_cap=2048, emit_cap=65536)
        assert not bool(ovf)
        got = search_np.compact_rank_array(
            np.asarray(v[:int(n)], dtype=np.int64),
            np.asarray(c[:int(n)], dtype=np.int64))
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])

    def test_overflow_flags(self, pair):
        from bwtmerge_tpu.ops.search_jax import wavefront_search_device2

        _, _, a, b = pair
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        _, _, _, ovf = wavefront_search_device2(
            a_idx, b_idx, jnp.int32(0), jnp.int32(b.sequences() - 1),
            a.sequences(), frontier_cap=128, emit_cap=64)
        assert bool(ovf)

    def test_single_sequence_block(self, pair):
        from bwtmerge_tpu.ops.search_jax import wavefront_search_device2

        _, _, a, b = pair
        # block of exactly one sequence: root is itself a singleton-sized range
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences(), b_seq_range=(2, 2))
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        v, c, n, ovf = wavefront_search_device2(
            a_idx, b_idx, jnp.int32(2), jnp.int32(2),
            a.sequences(), frontier_cap=1024, emit_cap=16384)
        assert not bool(ovf)
        got = search_np.compact_rank_array(
            np.asarray(v[:int(n)], dtype=np.int64),
            np.asarray(c[:int(n)], dtype=np.int64))
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


class TestBlockedPackedRA:
    def test_blocked_stream_matches_oracle(self, pair):
        from bwtmerge_tpu.ops.search_jax import blocked_search_and_pack

        _, _, a, b = pair
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        packed = blocked_search_and_pack(
            a_idx, b_idx, a.sequences(), b.sequences(), n_blocks=3,
            frontier_cap=4096, emit_cap=65536)
        assert not packed.overflowed
        chunks = list(packed.stream(chunk_runs=53))
        got_v = np.concatenate([x[0] for x in chunks])
        got_c = np.concatenate([x[1] for x in chunks])
        assert np.all(np.diff(got_v) > 0)  # globally ascending unique
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())
        assert np.array_equal(got_v, want[0])
        assert np.array_equal(got_c, want[1])
        assert packed.n_runs >= want[0].size  # raw runs, pre-dedup

    def test_blocked_overflow_surfaces_before_output(self):
        import jax.numpy as jnp

        from bwtmerge_tpu.ops.search_jax import EXC_CAP, BlockedPackedRA

        ok_meta = jnp.zeros((4, EXC_CAP), jnp.int32)
        bad_meta = jnp.zeros((4, EXC_CAP), jnp.int32).at[3, 2].set(1)
        dc = jnp.zeros((3, 64), jnp.uint8)
        e4 = jnp.zeros((3, 8), jnp.int32)
        packed = BlockedPackedRA([(dc, ok_meta, e4), (dc, bad_meta, e4)])
        assert packed.overflowed
        import pytest as _pytest
        with _pytest.raises(ValueError):
            next(iter(packed.stream()), None)


class TestChunkedBatchCount:
    def test_large_batch_equals_verify(self, pair):
        """2^14+ patterns (the batch size where a large-batch search path
        used to take over) count exactly like the host FMI.verify."""
        a_seqs, _, a, _ = pair
        rng2 = np.random.default_rng(5)
        pats = []
        for k in range((1 << 14) + 37):
            if k % 2:
                s = a_seqs[k % len(a_seqs)]
                lo = int(rng2.integers(0, max(1, len(s) - 3)))
                pats.append(np.asarray(s[lo:lo + int(rng2.integers(1, 9))]))
            else:
                pats.append(rng2.integers(1, 6, size=int(rng2.integers(1, 9))))
        got = batch_count(a.device_index, pats, a.alpha.char2comp)
        assert np.array_equal(got, a.verify(pats))
        assert got.sum() > 0

    def test_many_patterns_chunked(self, pair):
        _, _, a, _ = pair
        idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        rng2 = np.random.default_rng(3)
        pats = [rng2.integers(1, 6, size=int(rng2.integers(1, 5)))
                for _ in range(300)]
        want = np.array([a.count(p) for p in pats], dtype=np.int64)
        got = batch_count(idx, pats, a.alpha.char2comp, chunk=64)
        assert np.array_equal(got, want)


class TestSearchAndPack:
    def test_two_read_path_matches(self, pair):
        from bwtmerge_tpu.ops.search_jax import search_and_pack, unpack_search
        from bwtmerge_tpu.ops.search_np import compact_sorted_rank_array

        _, _, a, b = pair
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        dc8, meta_exc, exc4, esc = search_and_pack(
            a_idx, b_idx, jnp.int32(0), jnp.int32(b.sequences() - 1),
            a.sequences(), frontier_cap=4096, emit_cap=65536)
        v, c, ovf = unpack_search(dc8, meta_exc, exc4, esc)
        assert not ovf
        got = compact_sorted_rank_array(v, c)
        want = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences())
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        # every transfer plane decodes to the same rank array
        for plane in ("q4", "nib", "byte"):
            pv, pc, povf = unpack_search(dc8, meta_exc, exc4, esc,
                                         plane=plane)
            assert not povf
            assert np.array_equal(pv, v)
            assert np.array_equal(pc, c)

    def test_stream_matches_unpack(self, pair):
        from bwtmerge_tpu.ops.search_jax import (search_and_pack,
                                                 stream_packed_ra,
                                                 unpack_search)

        _, _, a, b = pair
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        dc8, meta_exc, exc4, esc = search_and_pack(
            a_idx, b_idx, jnp.int32(0), jnp.int32(b.sequences() - 1),
            a.sequences(), frontier_cap=4096, emit_cap=65536)
        v, c, ovf = unpack_search(dc8, meta_exc, exc4, esc)
        assert not ovf
        # odd chunk size forces several chunks incl. a clamped final window
        # (and, on the q4 plane, the even-alignment fixup)
        for plane in (None, "q4", "nib", "byte"):
            chunks = list(stream_packed_ra(dc8, meta_exc, exc4,
                                           chunk_runs=37, esc=esc,
                                           plane=plane))
            assert len(chunks) > 1
            for cv, _ in chunks:  # each chunk strictly ascending a-positions
                assert np.all(np.diff(cv) > 0)
            got_v = np.concatenate([x[0] for x in chunks])
            got_c = np.concatenate([x[1] for x in chunks])
            assert np.array_equal(got_v, v)
            assert np.array_equal(got_c, c)

    def test_stream_exceptions_across_chunk_boundaries(self, rng):
        from bwtmerge_tpu.ops.search_jax import (pack_ra_device,
                                                 stream_packed_ra)

        # sparse large values -> every delta routes through the exception
        # table; tiny chunks make most exceptions land mid-stream
        values = np.sort(rng.choice(50_000_000, size=300, replace=False))
        counts = rng.integers(1, 100_000, size=300)
        E = 512
        v = jnp.zeros(E, jnp.int32).at[:300].set(jnp.asarray(values, jnp.int32))
        c = jnp.zeros(E, jnp.int32).at[:300].set(jnp.asarray(counts, jnp.int32))
        dc8, exc, exc4, esc, n_u, n_exc, n_exc4, n_esc2 = pack_ra_device(
            v, c, jnp.int32(300))
        # no exc4 handed over: forces the byte-plane decode path
        meta = jnp.zeros((1, exc.shape[1]), jnp.int32)
        meta = meta.at[0, 0].set(n_u).at[0, 1].set(n_exc)
        meta_exc = jnp.concatenate([exc, meta], axis=0)
        chunks = list(stream_packed_ra(dc8, meta_exc, chunk_runs=7))
        got_v = np.concatenate([x[0] for x in chunks])
        got_c = np.concatenate([x[1] for x in chunks])
        assert np.array_equal(got_v, values)
        assert np.array_equal(got_c, counts)

    def test_stream_nibble_exceptions_across_chunk_boundaries(self, rng):
        from bwtmerge_tpu.ops.search_jax import (EXC_CAP, pack_ra_device,
                                                 stream_packed_ra)

        # mixed widths: ~half the runs fit the nibble inline, half escape
        # to the 2-byte side stream (none reach the >254 exc4 table)
        deltas = rng.integers(1, 30, size=300)  # > 14 -> escape
        values = np.cumsum(deltas)
        counts = rng.integers(1, 40, size=300)  # > 15 -> escape
        E = 512
        v = jnp.zeros(E, jnp.int32).at[:300].set(jnp.asarray(values, jnp.int32))
        c = jnp.zeros(E, jnp.int32).at[:300].set(jnp.asarray(counts, jnp.int32))
        dc8, exc, exc4, esc, n_u, n_exc, n_exc4, n_esc2 = pack_ra_device(
            v, c, jnp.int32(300))
        assert 0 < int(n_esc2) <= 300
        assert int(n_exc4) == 0  # nothing exceeds 254
        meta = jnp.zeros((1, EXC_CAP), jnp.int32)
        meta = meta.at[0, 0].set(n_u).at[0, 1].set(n_exc)
        meta = meta.at[0, 3].set(n_exc4).at[0, 4].set(n_esc2)
        meta_exc = jnp.concatenate([exc, meta], axis=0)
        chunks = list(stream_packed_ra(dc8, meta_exc, exc4, chunk_runs=7,
                                       esc=esc, plane="nib"))
        got_v = np.concatenate([x[0] for x in chunks])
        got_c = np.concatenate([x[1] for x in chunks])
        assert np.array_equal(got_v, values)
        assert np.array_equal(got_c, counts)
        # the pair-code plane (escape-heavy here: most pairs miss the
        # table) round-trips the same stream through the escape side
        # stream + the shared exc4 table, across chunk boundaries
        chunks = list(stream_packed_ra(dc8, meta_exc, exc4, chunk_runs=8,
                                       esc=esc, plane="q4"))
        got_v = np.concatenate([x[0] for x in chunks])
        got_c = np.concatenate([x[1] for x in chunks])
        assert np.array_equal(got_v, values)
        assert np.array_equal(got_c, counts)

    def test_q4_pure_numpy_matches_native(self, rng):
        """The numpy q4 window decode and the native kernel agree (incl.
        escape-cursor state across windows)."""
        import bwtmerge_tpu.ops.search_jax as sj

        deltas = rng.integers(1, 20, size=400)
        values = np.cumsum(deltas)
        counts = rng.integers(1, 5, size=400)
        E = 512
        v = jnp.zeros(E, jnp.int32).at[:400].set(jnp.asarray(values, jnp.int32))
        c = jnp.zeros(E, jnp.int32).at[:400].set(jnp.asarray(counts, jnp.int32))
        dc8, exc, exc4, esc, n_u, n_exc, n_exc4, n_esc2 = sj.pack_ra_device(
            v, c, jnp.int32(400))
        meta = jnp.zeros((1, sj.EXC_CAP), jnp.int32)
        meta = meta.at[0, 0].set(n_u).at[0, 1].set(n_exc)
        meta = meta.at[0, 3].set(n_exc4).at[0, 4].set(n_esc2)
        meta_exc = jnp.concatenate([exc, meta], axis=0)

        def run():
            chunks = list(sj.stream_packed_ra(dc8, meta_exc, exc4,
                                              chunk_runs=64, esc=esc,
                                              plane="q4"))
            return (np.concatenate([x[0] for x in chunks]),
                    np.concatenate([x[1] for x in chunks]))

        got_native = run()
        import unittest.mock as mock
        with mock.patch.dict("sys.modules"):
            # hide the native module so the numpy fallback runs
            import sys
            sys.modules["bwtmerge_tpu.native"] = None
            got_np = run()
        assert np.array_equal(got_native[0], got_np[0])
        assert np.array_equal(got_native[1], got_np[1])
        assert np.array_equal(got_native[0], values)
        assert np.array_equal(got_native[1], counts)

    def test_overflow_reported(self, pair):
        from bwtmerge_tpu.ops.search_jax import search_and_pack, unpack_search

        _, _, a, b = pair
        a_idx = DeviceFMIndex.build(a.runs, a.alpha.counts())
        b_idx = DeviceFMIndex.build(b.runs, b.alpha.counts())
        dc8, meta_exc, exc4, esc = search_and_pack(
            a_idx, b_idx, jnp.int32(0), jnp.int32(b.sequences() - 1),
            a.sequences(), frontier_cap=256, emit_cap=64)
        _, _, ovf = unpack_search(dc8, meta_exc, exc4, esc)
        assert ovf


class TestWideGapPack:
    def test_exc_cap_overflow_uses_side_streams(self):
        """An RA whose wide-gap count exceeds the byte-plane exception table
        (EXC_CAP) must still pack/decode via the exc4/esc side streams —
        sparse rank spaces at multi-100-Mbp bases produce this routinely
        (the old all-or-nothing check silently forced a trie fallback)."""
        import jax.numpy as jnp

        from bwtmerge_tpu.ops.search_jax import (EXC_CAP, PackedDeviceRA,
                                                 pack_ra_device,
                                                 stream_packed_ra)

        n = EXC_CAP + 1000          # every delta = 300 -> all runs "wide"
        values = (np.arange(n, dtype=np.int64) * 300 + 7).astype(np.int32)
        counts = np.ones(n, np.int32)
        cap = 1 << 14
        v = jnp.full((cap,), 2**31 - 1, jnp.int32).at[:n].set(
            jnp.asarray(values))
        c = jnp.zeros((cap,), jnp.int32).at[:n].set(jnp.asarray(counts))
        dc, exc, exc4, esc, n_u, n_exc, n_exc4, n_esc2 = pack_ra_device(
            v, c, jnp.int32(n), compact=False)
        assert int(n_exc) > EXC_CAP
        meta = np.zeros((1, EXC_CAP), np.int32)
        meta[0, 0] = int(n_u)
        meta[0, 1] = int(n_exc)
        meta[0, 3] = int(n_exc4)
        meta[0, 4] = int(n_esc2)
        meta_exc = np.concatenate([np.asarray(exc), meta])

        packed = PackedDeviceRA(dc, jnp.asarray(meta_exc), exc4, esc)
        assert not packed.overflowed
        gv, gc = packed.finish()
        np.testing.assert_array_equal(gv, values.astype(np.int64))
        np.testing.assert_array_equal(gc, counts.astype(np.int64))

        # explicit byte plane must refuse (its table is truncated)
        with pytest.raises(ValueError):
            list(stream_packed_ra(dc, meta_exc, exc4, esc=esc, plane="byte"))

        # without the side streams the pack is genuinely undecodable
        bare = PackedDeviceRA(dc, jnp.asarray(meta_exc))
        assert bare.overflowed
