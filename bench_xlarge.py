"""XLarge bench tier: ~1 Gbp 3-way fold on one device through the k-way
pairwise-decomposition engine (models/kfold.py) — the round-5 scale record.

Shape mirrors BASELINE configs[1-2]: a large base plus two inserts.  Unlike
the round-4 tier (in-memory left fold re-uploading the merged index every
fold, 0.159x baseline, 25 GB RSS), this fold:

  * never builds an intermediate merged index (device cost per insert is
    O(insert), flat in base size — the reference's defining property,
    paper.tex:266);
  * streams the merged BWT to a file through the windowed interleave chain
    (O(window) host memory, verdict r4 item 2).

Reports sustained Mbases/s over the inserted bases, a per-phase breakdown
(piece load+upload+decode dispatch, per-step walk completion, chain
interleave+write), peak RSS, and verifies the pattern-count invariant
(count_merged(p) == sum count_input_i(p), the reference -v gate,
bwt_merge.cpp:179-194) with read-derived 32-mers.  Prints ONE JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")
BASELINE_MBP_S = 9.40


def main() -> None:
    t_setup = time.monotonic()
    from bwtmerge_tpu.native.build import build_library

    build_library()

    import jax
    import jax.numpy as jnp

    from bwtmerge_tpu.utils.jax_setup import enable_compile_cache

    enable_compile_cache()

    from bwtmerge_tpu.formats.sidecar import load_creads, sidecar_path
    from bwtmerge_tpu.models.kfold import merge_files_many
    from bwtmerge_tpu.models.merge import MergeConfig

    base_path = os.path.join(CACHE, "xl_base.native")
    # BENCH_XL_PIECES=n folds n insert pieces (default 2 = the 3-way tier;
    # 9 = every cached piece, an insert-heavy 1.63 Gbp 10-way fold that
    # matches the reference benchmark's insert>base shape, paper.tex:266)
    if os.environ.get("BENCH_XL_BIG"):
        # big-piece tier: 714 Mbp base + 6 x ~510 Mbp pieces = 3.77 Gbp in
        # a 7-way fold (scripts/build_big_pieces.py; lane-blocked walks) —
        # the pairwise decomposition's walk count is K^2/2 * lanes, so
        # fewer, bigger pieces carry the same bases with ~4x less walk
        # work than the 28-way cycle below
        n_big = int(os.environ.get("BENCH_XL_BIG"))
        paths = [base_path] + [os.path.join(CACHE, f"xl_big_{i}.native")
                               for i in range(1, n_big + 1)]
        fmts = ["native"] * (n_big + 1)
    else:
        n_pieces = int(os.environ.get("BENCH_XL_PIECES", "2"))
        ids = (209, 208, 207, 206, 205, 204, 203, 202, 201)
        # beyond 9 pieces the cached set cycles (a piece file listed twice
        # is a legal input: duplicate read sets; 27 = the 3.5 Gbp tier)
        piece_ids = [ids[i % len(ids)] for i in range(n_pieces)]
        paths = [base_path] + [os.path.join(CACHE, f"xl_piece_{i}.sga")
                               for i in piece_ids]
        fmts = ["native"] + ["sga"] * len(piece_ids)
    for p in paths:
        if not os.path.exists(p):
            print(json.dumps({"metric": "xlarge 3-way fold throughput",
                              "value": 0.0, "unit": "Mbases/s/chip",
                              "vs_baseline": 0.0,
                              "extra": {"error": f"missing fixture {p} — "
                                        "run scripts/build_xlarge_fixtures.py"}}))
            return

    # pattern sample BEFORE merging: 32-mers drawn from p1/p2 read sidecars
    # (random 32-mers over sigma=4 are ~all absent)
    rng = np.random.default_rng(17)
    pats = []
    pat_sources = [os.path.join(CACHE, "xl_piece_209.sga"),
                   os.path.join(CACHE, "xl_piece_208.sga")]
    for p in pat_sources:
        creads = load_creads(sidecar_path(p))
        cols = rng.integers(0, creads.shape[1], size=2048)
        for c in cols:
            col = creads[:, c]
            if int((col > 0).sum()) >= 32:
                pats.append(col[:32][::-1].astype(np.int32))  # text order
        del creads
    pats = np.stack(pats)
    lens = np.full(pats.shape[0], 32, np.int32)
    print(f"# {pats.shape[0]} read-derived 32-mers", file=sys.stderr)

    from bwtmerge_tpu.formats.streaming_read import (alphabet_for,
                                                     read_bwt_chunks)
    from bwtmerge_tpu.ops.rank_jax import (DeviceFMIndex, backward_search,
                                           pack_nibbles_chunked)

    def dev_counts_path(path, fmt) -> tuple:
        """(pattern counts, size, sequences) of one input — chunk-streamed
        to the device at 0.5 B/pos host cost, counted, released."""
        nib, counts, size, _ = pack_nibbles_chunked(read_bwt_chunks(path, fmt))
        alpha = alphabet_for(fmt, counts, path)
        idx = DeviceFMIndex.from_nibbles(nib, alpha.counts(), size)
        del nib
        sp, ep = backward_search(idx, jnp.asarray(pats), jnp.asarray(lens), 32)
        cnt = (np.asarray(ep) - np.asarray(sp) + 1).clip(min=0)
        return cnt, size, int(alpha.counts()[0])

    t0 = time.monotonic()
    want = np.zeros(pats.shape[0], np.int64)
    sizes = []
    memo = {}
    for p, f in zip(paths, fmts):
        if p not in memo:
            memo[p] = dev_counts_path(p, f)
        c, sz, _ = memo[p]
        want += c
        sizes.append(sz)
    del memo
    verify_in_s = time.monotonic() - t0
    print(f"# input pattern counts {verify_in_s:.1f}s "
          f"(sizes {[s // 10**6 for s in sizes]} Mbp)", file=sys.stderr)
    setup_s = time.monotonic() - t_setup

    # ---- the measured fold: one k-way streaming merge to a native file ----
    out_path = os.path.join("/tmp", "xl_merged.native")
    cfg = MergeConfig(backend="jax", temp_dir="/tmp", search="auto",
                      verbose=True)
    stats: dict = {"sync_steps": True}
    t0 = time.monotonic()
    merge_files_many(paths, out_path, fmts, "native", cfg, stats=stats)
    fold_s = time.monotonic() - t0
    phases = {k: round(v, 2) for k, v in cfg.timer.phases.items()}
    print(f"# k-way fold: {fold_s:.1f}s  phases={phases}  "
          f"steps={stats.get('step_drained_s')}", file=sys.stderr)

    from bwtmerge_tpu.utils.metrics import memory_usage

    # peak RSS up to the END OF THE FOLD (the verification below may use
    # far more host memory for >2^31 outputs; that is not fold cost)
    fold_rss = memory_usage()

    total_bases = sum(sizes)
    inserted = sum(sizes[1:])

    # ---- output verification (outside the fold window, like the CLI -v) ----
    t0 = time.monotonic()
    if total_bases < 2**31:
        got_counts, out_size, _ = dev_counts_path(out_path, "native")
    else:
        # beyond the int32 device layout: host-side sparse-rank backward
        # search (ops/rank_np.SparseRankIndex — the full occ table would
        # not fit; a few hundred thousand rank queries scan O(stride) each)
        from bwtmerge_tpu.formats.streaming_read import read_bwt_streaming
        from bwtmerge_tpu.ops.rank_np import SparseRankIndex

        runs, _, alpha = read_bwt_streaming(out_path, "native")
        out_size = runs.size()
        sparse = SparseRankIndex.build(runs, alpha.sigma)
        del runs
        sp, ep = sparse.batch_backward_search(
            alpha.C.astype(np.int64), pats.astype(np.int64),
            lens.astype(np.int64))
        got_counts = np.maximum(0, ep - sp + 1)
        del sparse
    verify_out_s = time.monotonic() - t0
    assert out_size == total_bases, (out_size, total_bases)
    assert np.array_equal(got_counts, want), \
        f"pattern-count invariant FAILED ({int((got_counts != want).sum())} diffs)"
    print(f"# pattern-count invariant OK ({pats.shape[0]} patterns, "
          f"{verify_out_s:.1f}s)", file=sys.stderr)
    out_mb = os.path.getsize(out_path) / 1e6
    os.remove(out_path)

    rate = inserted / 1e6 / fold_s
    print(json.dumps({
        "metric": f"xlarge {len(paths)}-way fold throughput",
        "value": round(rate, 3),
        "unit": "Mbases/s/chip",
        "vs_baseline": round(rate / BASELINE_MBP_S, 3),
        "extra": {
            "device": str(jax.devices()[0]),
            "engine": "kway pairwise-decomposition fold (models/kfold.py)",
            "total_bases": int(total_bases),
            "base_bases": int(sizes[0]),
            "insert_bases": int(inserted),
            "fold_s": round(fold_s, 1),
            "sustained_Mbases_s": round(rate, 3),
            "phase_s": phases,
            "piece_dispatch_s": stats.get("piece_dispatch_s"),
            "step_drained_s": stats.get("step_drained_s"),
            "step_spill_files": stats.get("step_spill_files"),
                        "max_window_positions": stats.get("max_window_positions"),
            "output_MB": round(out_mb, 1),
            "peak_rss_GB": round(fold_rss / 1e9, 2),
            "patterns": int(pats.shape[0]),
            "invariant_ok": True,
            "setup_s": round(setup_s, 1),
        },
    }))


if __name__ == "__main__":
    main()
