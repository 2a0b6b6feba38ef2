"""End-to-end merge correctness: engine output vs direct oracle construction."""

import numpy as np
import pytest

from bwtmerge_tpu.models import oracle
from bwtmerge_tpu.models.fmi import FMI
from bwtmerge_tpu.models.merge import MergeConfig, merge_fmi
from bwtmerge_tpu.ops import search_np


def _fmi(seqs):
    return FMI.from_runs(oracle.build_bwt(seqs))


class TestRankArray:
    def test_matches_oracle(self, rng):
        a_seqs = oracle.random_collection(rng, 6, 5, 40)
        b_seqs = oracle.random_collection(rng, 5, 5, 40)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        values, counts = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences(),
        )
        assert int(counts.sum()) == b.size()
        expect = oracle.rank_array_oracle(a_seqs, b_seqs)
        got = np.repeat(values, counts)
        # RA values sorted ascending must equal the per-position oracle sorted.
        assert np.array_equal(got, np.sort(expect))

    def test_sequence_blocks_equivalent(self, rng):
        """Searching in blocks then merging gives the same RA (the basis of
        sequence-block data parallelism, fmi.cpp:351-357)."""
        a_seqs = oracle.random_collection(rng, 4, 5, 30)
        b_seqs = oracle.random_collection(rng, 7, 5, 30)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        args = (a.rank_index, a.alpha.C.astype(np.int64),
                b.rank_index, b.alpha.C.astype(np.int64),
                a.sequences(), b.sequences())
        full = search_np.build_rank_array(*args)
        from bwtmerge_tpu.utils.ranges import get_bounds

        merged = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        for blk in get_bounds((0, b.sequences() - 1), 3):
            part = search_np.build_rank_array(*args, b_seq_range=blk)
            merged = search_np.merge_rank_arrays(merged, part)
        assert np.array_equal(full[0], merged[0])
        assert np.array_equal(full[1], merged[1])


class TestMerge:
    @pytest.mark.parametrize("blocks", [1, 4])
    def test_pairwise_matches_oracle(self, rng, blocks):
        a_seqs = oracle.random_collection(rng, 6, 5, 50)
        b_seqs = oracle.random_collection(rng, 4, 5, 50)
        merged = merge_fmi(_fmi(a_seqs), _fmi(b_seqs),
                           MergeConfig(sequence_blocks=blocks))
        expect = oracle.merge_collections([a_seqs, b_seqs])
        assert merged.runs == expect
        assert merged.size() == sum(len(s) for s in a_seqs + b_seqs) + 10
        assert merged.sequences() == 10

    def test_left_fold_multiway(self, rng):
        """k-way merge as a left fold of pairwise merges (bwt_merge.cpp:167-173)."""
        colls = [oracle.random_collection(rng, 3, 5, 30) for _ in range(4)]
        index = _fmi(colls[0])
        for coll in colls[1:]:
            index = merge_fmi(index, _fmi(coll))
        expect = oracle.merge_collections(colls)
        assert index.runs == expect

    def test_pattern_count_invariant(self, rng):
        """The reference's -v acceptance gate: count_merged(p) == sum of
        count_input_i(p) for every pattern (bwt_merge.cpp:179-194)."""
        a_seqs = oracle.random_collection(rng, 5, 10, 60)
        b_seqs = oracle.random_collection(rng, 5, 10, 60)
        a, b = _fmi(a_seqs), _fmi(b_seqs)
        merged = merge_fmi(a, b)
        patterns = [rng.integers(1, 6, int(rng.integers(2, 8))) for _ in range(25)]
        pre = a.verify(patterns) + b.verify(patterns)
        post = merged.verify(patterns)
        assert np.array_equal(pre, post)

    def test_hash_matches_oracle(self, rng):
        a_seqs = oracle.random_collection(rng, 3, 5, 25)
        b_seqs = oracle.random_collection(rng, 3, 5, 25)
        merged = merge_fmi(_fmi(a_seqs), _fmi(b_seqs))
        expect = FMI.from_runs(oracle.merge_collections([a_seqs, b_seqs]))
        assert merged.hash() == expect.hash()

    def test_alphabet_mismatch_rejected(self, rng):
        from bwtmerge_tpu.utils.alphabet import AlphabeticOrder, create_alphabet, Alphabet

        a = _fmi(oracle.random_collection(rng, 2, 5, 10))
        b = _fmi(oracle.random_collection(rng, 2, 5, 10))
        sorted_alpha = create_alphabet(AlphabeticOrder.SORTED)
        b.alpha = Alphabet.from_counts(b.runs.counts(),
                                       sorted_alpha.char2comp, sorted_alpha.comp2char)
        with pytest.raises(ValueError):
            merge_fmi(a, b)

    def test_skewed_sizes(self, rng):
        """Merge a large base with a small increment and vice versa."""
        big = oracle.random_collection(rng, 20, 30, 80)
        small = oracle.random_collection(rng, 1, 5, 10)
        m1 = merge_fmi(_fmi(big), _fmi(small))
        assert m1.runs == oracle.merge_collections([big, small])
        m2 = merge_fmi(_fmi(small), _fmi(big))
        assert m2.runs == oracle.merge_collections([small, big])

    def test_repetitive_collections(self, rng):
        """Highly repetitive reads (the reference's target workload)."""
        base = rng.integers(1, 5, 50)
        a_seqs = [base.copy() for _ in range(5)]
        b_seqs = [base.copy() for _ in range(4)] + [base[5:45].copy()]
        merged = merge_fmi(_fmi(a_seqs), _fmi(b_seqs))
        assert merged.runs == oracle.merge_collections([a_seqs, b_seqs])


class TestInterleaveBackendChoice:
    def test_device_interleave_option(self, rng):
        from bwtmerge_tpu.models import oracle
        a_seqs = oracle.random_collection(rng, 5, 10, 50)
        b_seqs = oracle.random_collection(rng, 4, 10, 50)
        a = FMI.from_runs(oracle.build_bwt(a_seqs))
        b = FMI.from_runs(oracle.build_bwt(b_seqs))
        want = oracle.merge_collections([a_seqs, b_seqs])
        for il in ("native", "device"):
            cfg = MergeConfig(backend="jax", interleave=il)
            assert merge_fmi(a, b, cfg).runs == want


class TestDeviceBlocks:
    def test_blocked_device_merge_matches_oracle(self, rng):
        """device_blocks > 1 dispatches per-block search programs whose RA
        streams k-way-merge into the interleave; result must be identical."""
        from bwtmerge_tpu.models import oracle

        a_seqs = oracle.random_collection(rng, 12, 10, 60)
        b_seqs = oracle.random_collection(rng, 9, 10, 60)
        a = FMI.from_runs(oracle.build_bwt(a_seqs))
        b = FMI.from_runs(oracle.build_bwt(b_seqs))
        want = oracle.merge_collections([a_seqs, b_seqs])
        merged = merge_fmi(a, b, MergeConfig(backend="jax", device_blocks=3))
        assert merged.runs == want

    def test_blocked_overflow_falls_back(self, rng, monkeypatch):
        """A block overflowing its static buffers must surface before any
        output and fall back to a correct path."""
        import jax.numpy as jnp

        from bwtmerge_tpu.models import oracle
        from bwtmerge_tpu.ops import search_jax as sj

        a_seqs = oracle.random_collection(rng, 6, 10, 40)
        b_seqs = oracle.random_collection(rng, 5, 10, 40)
        a = FMI.from_runs(oracle.build_bwt(a_seqs))
        b = FMI.from_runs(oracle.build_bwt(b_seqs))

        real_blocked = sj.blocked_search_and_pack

        def overflowing_blocked(*args, **kwargs):
            packed = real_blocked(*args, **kwargs)
            bad = jnp.zeros((4, sj.EXC_CAP), jnp.int32).at[3, 2].set(1)
            packed.parts[-1] = (packed.parts[-1][0], bad,
                                *packed.parts[-1][2:])
            return packed
        monkeypatch.setattr(sj, "blocked_search_and_pack", overflowing_blocked)

        merged = merge_fmi(a, b, MergeConfig(backend="jax", device_blocks=2))
        assert merged.runs == oracle.merge_collections([a_seqs, b_seqs])


class TestDeviceOverflowFallback:
    def test_fallback_to_host_driver(self, rng, monkeypatch):
        """When the single-program device search overflows its static
        buffers, the merge must fall back to the streaming host driver and
        still match."""
        import jax.numpy as jnp

        from bwtmerge_tpu.models import oracle
        from bwtmerge_tpu.ops import search_jax as sj

        a_seqs = oracle.random_collection(rng, 5, 10, 50)
        b_seqs = oracle.random_collection(rng, 4, 10, 50)
        a = FMI.from_runs(oracle.build_bwt(a_seqs))
        b = FMI.from_runs(oracle.build_bwt(b_seqs))

        calls = {"n": 0}

        def fake_pack(*args, **kwargs):
            calls["n"] += 1
            meta = jnp.zeros((4, sj.EXC_CAP), jnp.int32).at[3, 2].set(1)
            return (jnp.zeros((2, 64), jnp.uint8), meta,
                    jnp.zeros((3, 8), jnp.int32), jnp.zeros(64, jnp.uint8))
        monkeypatch.setattr(sj, "search_and_pack", fake_pack)

        merged = merge_fmi(a, b, MergeConfig(backend="jax"))
        assert calls["n"] == 1  # the device path was attempted and overflowed
        assert merged.runs == oracle.merge_collections([a_seqs, b_seqs])


class TestEmptyCollectionMerge:
    def test_merge_with_empty_b(self, rng):
        from bwtmerge_tpu.models import oracle
        from bwtmerge_tpu.models.runs import RunArrays

        a_seqs = oracle.random_collection(rng, 5, 10, 50)
        a = FMI.from_runs(oracle.build_bwt(a_seqs))
        empty = FMI.from_runs(RunArrays.empty())
        for backend in ("numpy", "jax"):
            merged = merge_fmi(a, empty, MergeConfig(backend=backend))
            assert merged.runs == a.runs


class TestParallelInterleave:
    def test_parallel_interleave_byte_identity(self, rng, tmp_path):
        """The range-parallel interleave (models/parallel_merge.py) must
        produce byte-identical sga AND native files to the serial native
        interleave chain, across many tiny chunk boundaries."""
        from bwtmerge_tpu.formats.streaming import write_bwt_stream
        from bwtmerge_tpu.models.parallel_merge import (
            interleave_stream_chunks_parallel)
        from bwtmerge_tpu.native import interleave_stream_chunks
        from bwtmerge_tpu.parallel.distributed import coalesce_run_chunks
        from bwtmerge_tpu.utils.alphabet import Alphabet

        a_seqs = oracle.random_collection(rng, 40, 10, 90)
        b_seqs = oracle.random_collection(rng, 35, 10, 90)
        fa = FMI.from_runs(oracle.build_bwt(a_seqs))
        fb = FMI.from_runs(oracle.build_bwt(b_seqs))
        rv, rc = search_np.build_rank_array(
            fa.rank_index, fa.alpha.C.astype(np.int64),
            fb.rank_index, fb.alpha.C.astype(np.int64),
            fa.sequences(), fb.sequences())
        alpha = Alphabet.from_counts(
            fa.alpha.counts().astype(np.int64)
            + fb.alpha.counts().astype(np.int64))

        def chunks(step):
            for s in range(0, rv.size, step):
                yield rv[s:s + step], rc[s:s + step]

        for fmt in ("sga", "native"):
            want = str(tmp_path / f"serial.{fmt}")
            write_bwt_stream(want, fmt,
                             interleave_stream_chunks(fa.runs, fb.runs,
                                                      chunks(1 << 20)),
                             alpha)
            for step in (7, 64, 1 << 20):
                got = str(tmp_path / f"par_{step}.{fmt}")
                write_bwt_stream(
                    got, fmt,
                    coalesce_run_chunks(interleave_stream_chunks_parallel(
                        fa.runs, fb.runs, chunks(step), workers=3)),
                    alpha)
                assert open(got, "rb").read() == open(want, "rb").read(), \
                    (fmt, step)

    def test_parallel_interleave_empty_ra(self, rng, tmp_path):
        """Empty B: the drain fragment must still emit all of A."""
        from bwtmerge_tpu.models.parallel_merge import (
            interleave_stream_chunks_parallel)
        from bwtmerge_tpu.parallel.distributed import coalesce_run_chunks

        a_seqs = oracle.random_collection(rng, 8, 5, 40)
        fa = FMI.from_runs(oracle.build_bwt(a_seqs))
        fb_runs = type(fa.runs)(np.zeros(0, np.uint8), np.zeros(0, np.int64))
        parts = list(coalesce_run_chunks(interleave_stream_chunks_parallel(
            fa.runs, fb_runs, iter([]), workers=2)))
        syms = np.concatenate([p[0] for p in parts])
        lens = np.concatenate([p[1] for p in parts])
        got = type(fa.runs)(syms, lens)
        assert got == fa.runs


class TestDeviceDecisions:
    def test_walk_failure_fails_the_merge(self, rng, monkeypatch):
        """A failing walk search raises; it does not fall back to the trie."""
        from bwtmerge_tpu.ops import walk_jax

        a_seqs = oracle.random_collection(rng, 6, 5, 40)
        b_seqs = oracle.random_collection(rng, 5, 5, 40)
        a, b = _fmi(a_seqs), _fmi(b_seqs)

        def broken(*args, **kwargs):
            raise RuntimeError("walk compile refused")

        monkeypatch.setattr(walk_jax, "blocked_walk_and_pack", broken)
        with pytest.raises(RuntimeError, match="walk compile refused"):
            merge_fmi(a, b, MergeConfig(backend="jax", search="walk",
                                        devices=1))

    @pytest.mark.parametrize("limit,want", [
        (0, "replicated"),             # no limit reported (the CPU)
        (1 << 40, "replicated"),       # tables fit one device
        (64, "sharded"),               # tables exceed one device
    ])
    def test_placement_follows_device_limit(self, rng, monkeypatch,
                                            limit, want):
        from bwtmerge_tpu.models import merge as merge_mod

        a = _fmi(oracle.random_collection(rng, 6, 5, 40))
        b = _fmi(oracle.random_collection(rng, 5, 5, 40))
        monkeypatch.setattr(merge_mod, "device_memory_limit", lambda: limit)
        assert merge_mod._resolve_placement(MergeConfig(), a, b, 4) == want
        # an explicit budget overrides the device's limit
        assert merge_mod._resolve_placement(
            MergeConfig(hbm_budget_bytes=1 << 40), a, b, 4) == "replicated"

    def test_cpu_reports_no_memory_limit(self):
        from bwtmerge_tpu.models.merge import device_memory_limit

        assert device_memory_limit() == 0
