"""K-way pairwise-decomposition fold (models/kfold.py, ops/kfold_jax.py)
vs the sequential left-fold oracle.

The decomposition's correctness hinges on two delicate facts the tests pin:
per-suffix alignment of the summed sorted walks (monotonicity argument) and
the endmarker tie convention (earlier pieces' endmarkers first — the
reference root-run convention, fmi.cpp:286-287).  Duplicate reads ACROSS
pieces exercise the tie-breaking hardest.
"""

import numpy as np
import pytest

from bwtmerge_tpu.models.build import build_from_reads
from bwtmerge_tpu.models.fmi import FMI
from bwtmerge_tpu.models.kfold import merge_files_many, merge_fmi_many
from bwtmerge_tpu.models.merge import MergeConfig, merge_fmi


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _random_reads(rng, n, max_len=30):
    return [rng.integers(1, 6, size=int(rng.integers(1, max_len))
                         ).astype(np.uint8) for _ in range(n)]


def _fmi(reads):
    runs, _ = build_from_reads(reads, backend="numpy")
    return FMI.from_runs(runs)


def _leftfold(reads_list, tmp_path):
    fmis = [_fmi(r) for r in reads_list]
    acc = fmis[0]
    for f in fmis[1:]:
        acc = merge_fmi(acc, f, MergeConfig(backend="numpy",
                                            temp_dir=str(tmp_path)))
    return acc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_many_equals_leftfold(tmp_path, seed):
    rng = np.random.default_rng(seed)
    reads_list = [_random_reads(rng, int(rng.integers(2, 10)))
                  for _ in range(4)]
    # duplicate reads across pieces: the hardest tie case
    reads_list[2][0] = reads_list[0][0].copy()
    reads_list[3][-1] = reads_list[1][0].copy()

    want = _leftfold(reads_list, tmp_path)
    got = merge_fmi_many([_fmi(r) for r in reads_list],
                         MergeConfig(backend="jax", temp_dir=str(tmp_path)))
    np.testing.assert_array_equal(got.runs.syms, want.runs.syms)
    np.testing.assert_array_equal(got.runs.lens, want.runs.lens)
    np.testing.assert_array_equal(got.alpha.C, want.alpha.C)
    assert got.hash() == want.hash()


def test_merge_many_identical_pieces(tmp_path):
    # every piece identical: maximal duplicate-suffix pressure
    rng = np.random.default_rng(7)
    reads = _random_reads(rng, 5, 12)
    reads_list = [list(reads) for _ in range(3)]
    want = _leftfold(reads_list, tmp_path)
    got = merge_fmi_many([_fmi(r) for r in reads_list],
                         MergeConfig(backend="jax", temp_dir=str(tmp_path)))
    assert got.runs == want.runs


def test_merge_many_single_char_reads(tmp_path):
    reads_list = [
        [np.array([2], np.uint8), np.array([3, 1], np.uint8)],
        [np.array([5], np.uint8)],
        [np.array([1], np.uint8), np.array([1], np.uint8)],
    ]
    want = _leftfold(reads_list, tmp_path)
    got = merge_fmi_many([_fmi(r) for r in reads_list],
                         MergeConfig(backend="jax", temp_dir=str(tmp_path)))
    assert got.runs == want.runs


def test_merge_files_many_streaming(tmp_path, rng):
    from bwtmerge_tpu.formats import read_bwt, write_bwt

    reads_list = [_random_reads(rng, 8) for _ in range(3)]
    paths = []
    for i, reads in enumerate(reads_list):
        f = _fmi(reads)
        p = str(tmp_path / f"p{i}.sga")
        write_bwt(p, "sga", f.runs, f.alpha)
        paths.append(p)
    out = str(tmp_path / "merged.native")
    stats = {}
    merge_files_many(paths, out, "sga", "native",
                     MergeConfig(backend="jax", temp_dir=str(tmp_path)),
                     window_positions=256, stats=stats)
    got, _, got_alpha = read_bwt(out, "native")
    want = _leftfold(reads_list, tmp_path)
    assert got == want.runs
    np.testing.assert_array_equal(got_alpha.C, want.alpha.C)
    assert stats.get("fold_steps") == 2


def test_merge_files_many_trie_fallback(tmp_path, rng, monkeypatch):
    from bwtmerge_tpu.formats import read_bwt, write_bwt

    monkeypatch.setenv("BWTMERGE_SEARCH", "trie")
    reads_list = [_random_reads(rng, 5) for _ in range(3)]
    paths = []
    for i, reads in enumerate(reads_list):
        f = _fmi(reads)
        p = str(tmp_path / f"p{i}.sga")
        write_bwt(p, "sga", f.runs, f.alpha)
        paths.append(p)
    out = str(tmp_path / "merged.sga")
    merge_files_many(paths, out, "sga", "sga",
                     MergeConfig(backend="jax", temp_dir=str(tmp_path)))
    got, _, _ = read_bwt(out, "sga")
    want = _leftfold(reads_list, tmp_path)
    assert got == want.runs


def test_merge_many_mismatched_alphabet(tmp_path, rng):
    from bwtmerge_tpu.utils.alphabet import AlphabeticOrder, create_alphabet

    a = _fmi(_random_reads(rng, 3))
    b = _fmi(_random_reads(rng, 3))
    sorted_alpha = create_alphabet(AlphabeticOrder.SORTED)
    sorted_alpha.C = b.alpha.C.copy()
    b.alpha = sorted_alpha
    with pytest.raises(ValueError, match="alphabet"):
        merge_fmi_many([a, b, a], MergeConfig(backend="jax",
                                              temp_dir=str(tmp_path)))


def test_cli_kway_fold(tmp_path, rng):
    from bwtmerge_tpu.cli.bwt_merge import main as merge_main
    from bwtmerge_tpu.formats import read_bwt, write_bwt

    reads_list = [_random_reads(rng, 6) for _ in range(3)]
    paths = []
    for i, reads in enumerate(reads_list):
        f = _fmi(reads)
        p = str(tmp_path / f"p{i}.sga")
        write_bwt(p, "sga", f.runs, f.alpha)
        paths.append(p)
    # patterns: first read of each piece as characters
    pat_file = str(tmp_path / "pats.txt")
    with open(pat_file, "w") as fh:
        for reads in reads_list:
            fh.write("".join("$ACGTN"[c] for c in reads[0]) + "\n")
    out = str(tmp_path / "out.sga")
    rc = merge_main(paths + [out, "-i", "sga", "-o", "sga", "--quiet",
                             "--backend", "jax", "--fold", "kway",
                             "-v", pat_file, "-d", str(tmp_path)])
    assert rc == 0
    got, _, _ = read_bwt(out, "sga")
    want = _leftfold(reads_list, tmp_path)
    assert got == want.runs


def test_pack_presorted_values_beyond_int32(tmp_path):
    # summed rank arrays cross 2^31 at >2.1 Gbp totals: values ride the
    # int32 device lanes as wraparound uint32 and the host decoders
    # re-read negative exception deltas as uint32
    import jax.numpy as jnp

    from bwtmerge_tpu.ops.kfold_jax import (_first_lanes, _pack_presorted,
                                            _sort_vals)
    from bwtmerge_tpu.ops.search_jax import stream_packed_ra
    from bwtmerge_tpu.ops.walk_jax import _SENT

    # (2^31 - 1 itself cannot occur: it is the walk's dead-lane sentinel,
    # and per-piece sizes are guarded strictly below it)
    true = np.array([100, 2**31 - 3, 2**31 - 2, 2**31 + 5, 2**31 + 5,
                     2**31 + 300, 3_500_000_000, 3_500_000_000,
                     4_100_000_000], np.int64)
    root_value, root_count = 7, 4
    # UNSORTED lane order with _SENT pads interleaved, exactly as the
    # walk emits — the sort must order wrapped (int32-negative) values
    # AFTER the small positive ones (unsigned order; the signed sort
    # corrupted every fold step past a 2.1 Gbp accumulated total)
    rng2 = np.random.default_rng(3)
    wrapped = (true % (1 << 32)).astype(np.uint32).view(np.int32)
    vals = np.full(1 << 10, _SENT, np.int32)
    lanes = rng2.choice(vals.size, size=wrapped.size, replace=False)
    vals[lanes] = wrapped
    sorted_vals = _sort_vals(_first_lanes(jnp.asarray(vals)))
    dc8, meta, exc4, esc = _pack_presorted(
        sorted_vals, jnp.int32(true.size),
        jnp.int32(root_value), jnp.int32(root_count))
    got = list(stream_packed_ra(dc8, meta, exc4, chunk_runs=4, esc=esc))
    gv = np.concatenate([v for v, _ in got])
    gc = np.concatenate([c for _, c in got])
    # expected: root + compacted true values
    ev, idx = np.unique(np.concatenate([[root_value], true]),
                        return_inverse=True)
    ec = np.bincount(idx, weights=np.concatenate(
        [[root_count], np.ones(true.size)])).astype(np.int64)
    np.testing.assert_array_equal(gv, ev)
    np.testing.assert_array_equal(gc, ec)


def test_pack_nibbles_chunked_matches_build(rng):
    from bwtmerge_tpu.ops.rank_jax import (DeviceFMIndex,
                                           pack_nibbles_chunked)

    reads = _random_reads(rng, 30, 40)
    f = _fmi(reads)
    idx1 = DeviceFMIndex.build(f.runs, f.alpha.counts())
    nib, counts, size, n_runs = pack_nibbles_chunked(f.runs.iter_chunks(97))
    np.testing.assert_array_equal(counts, f.runs.counts(6))
    assert (size, n_runs) == (f.size(), f.runs.n_runs)
    idx2 = DeviceFMIndex.from_nibbles(nib, counts, size, n_runs)
    np.testing.assert_array_equal(np.asarray(idx1.rec), np.asarray(idx2.rec))
    np.testing.assert_array_equal(np.asarray(idx1.C), np.asarray(idx2.C))


def test_sparse_backward_search_matches_fmi(rng):
    from bwtmerge_tpu.ops.rank_np import SparseRankIndex

    reads = _random_reads(rng, 30, 40)
    f = _fmi(reads)
    sparse = SparseRankIndex.build(f.runs, f.alpha.sigma, stride=16)
    pats, lens = [], []
    for r in reads[:10]:
        pats.append(r[:6])
    maxlen = max(p.size for p in pats)
    P = np.zeros((len(pats), maxlen), np.int64)
    L = np.zeros(len(pats), np.int64)
    for j, p in enumerate(pats):
        P[j, :p.size] = p
        L[j] = p.size
    sp, ep = sparse.batch_backward_search(f.alpha.C.astype(np.int64), P, L)
    want = f.verify([p for p in pats])
    np.testing.assert_array_equal(np.maximum(0, ep - sp + 1), want)


def test_lane_blocked_summed_parts(tmp_path, monkeypatch):
    # force lane blocking on a small piece: the blocked streams must merge
    # to the exact trie-oracle rank array (whole-read lanes per block)
    import bwtmerge_tpu.ops.kfold_jax as kj
    from bwtmerge_tpu.formats.sidecar import creads_layout
    from bwtmerge_tpu.ops.search_jax import BlockedPackedRA, make_block_part
    from bwtmerge_tpu.ops.search_np import build_rank_array

    rng = np.random.default_rng(21)
    reads_a = _random_reads(rng, 8, 30)
    reads_b = _random_reads(rng, 40, 10)
    a, b = _fmi(reads_a), _fmi(reads_b)
    lens = np.array([r.size for r in reads_b], np.uint32)
    creads = creads_layout(lens, np.concatenate(reads_b))
    monkeypatch.setattr(kj, "MAX_WALK_LANES", 64)   # force many blocks
    targets = [kj.PieceIndex.from_device_index(a.device_index)]
    raw = kj.summed_packed_parts(targets, creads)
    assert len(raw) > 1
    bp = BlockedPackedRA([
        make_block_part(dc8, meta, exc4, esc, 512, b.size() + 2)
        for dc8, meta, exc4, esc in raw])
    gv, gc = bp.finish()
    wv, wc = build_rank_array(a.rank_index, a.alpha.C.astype(np.int64),
                              b.rank_index, b.alpha.C.astype(np.int64),
                              a.sequences(), b.sequences())
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gc, wc)


def test_stage_merges_overlapping_spill_files(tmp_path):
    """A step whose lane-block parts drain concurrently spills files with
    OVERLAPPING value ranges; the chain stage must k-way merge them (it once
    concatenated them, which wrote a corrupt fold on large pieces)."""
    from bwtmerge_tpu.models.kfold_stage import spill_stream
    from bwtmerge_tpu.models.spill import RankArraySpill
    from bwtmerge_tpu.ops.search_np import compact_rank_array

    rng = np.random.default_rng(11)
    spill = RankArraySpill(temp_dir=str(tmp_path), spill_threshold_runs=300,
                           compact_every=100)
    all_v, all_c = [], []
    parts = [np.sort(rng.choice(5000, size=600, replace=False))
             for _ in range(2)]
    for lo in range(0, 600, 50):          # two parts' chunks interleaved
        for v in parts:
            chunk = v[lo:lo + 50].astype(np.int64)
            c = rng.integers(1, 4, size=chunk.size).astype(np.int64)
            spill.emit(chunk, c)
            all_v.append(chunk)
            all_c.append(c)
    spill._compact()
    if spill._base is not None and spill._base[0].size:
        spill._spill()
    files = [(f.path, f.n_runs) for f in spill._files]
    assert len(files) >= 2
    want_v, want_c = compact_rank_array(np.concatenate(all_v),
                                        np.concatenate(all_c))
    got = list(spill_stream(files))
    got_v = np.concatenate([g[0] for g in got])
    got_c = np.concatenate([g[1] for g in got])
    assert np.array_equal(got_v, want_v)
    assert np.array_equal(got_c, want_c)
