"""bwt_merge — merge BWTs of read collections (reference bwt_merge.cpp:47-299).

Usage: python -m bwtmerge_tpu.cli.bwt_merge [options] input1 input2 [...] output

Flag parity with the reference getopt string "b:m:r:s:t:d:v:i:o:", plus
--backend to pick the compute path (numpy host oracle vs jax device engine).
Inputs are merged as a left fold of pairwise merges (bwt_merge.cpp:163-173).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..models.fmi import load_fmi, serialize_fmi
from ..models.merge import MergeConfig, merge_fmi
from ..utils.metrics import in_megabytes
from .common import check_format, print_formats, read_rows, report_totals, verify_fmi


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bwt_merge", add_help=True,
        description="Merge BWTs of DNA read collections into one BWT.",
        epilog="Formats: native, plain_default, plain_sorted, rfm, sdsl, ropebwt, sga")
    p.add_argument("files", nargs="+", metavar="FILE",
                   help="input1 input2 [input3 ...] output")
    p.add_argument("-r", dest="run_buffer", type=int, default=None, metavar="N",
                   help="run buffer size in millions of runs (default 8)")
    p.add_argument("-b", dest="thread_buffer", type=int, default=None, metavar="MB",
                   help="thread buffer size in megabytes (default 256)")
    p.add_argument("-m", dest="merge_buffers", type=int, default=None, metavar="N",
                   help="number of merge buffers (default 6)")
    p.add_argument("-s", dest="sequence_blocks", type=int, default=None, metavar="N",
                   help="sequence blocks per device (default 4)")
    p.add_argument("-t", dest="devices", type=int, default=None, metavar="N",
                   help="device/thread parallelism (default: all devices)")
    p.add_argument("--device-blocks", dest="device_blocks", type=int,
                   default=None, metavar="N",
                   help="single-device search programs per merge: block k+1's"
                        " search overlaps block k's rank-array transfer"
                        " (default: auto)")
    p.add_argument("--index-placement", dest="index_placement",
                   default="auto", choices=("auto", "replicated", "sharded"),
                   help="device index placement: replicate the record table"
                        " per device, block-shard it over the mesh (indexes"
                        " beyond one device's memory), or choose by size"
                        " (auto)")
    p.add_argument("--hbm-budget-mb", dest="hbm_budget_mb", type=int,
                   default=None, metavar="MB",
                   help="per-device memory budget driving --index-placement"
                        " auto (default: the device's reported memory limit)")
    p.add_argument("-d", dest="temp_dir", default=".", metavar="DIR",
                   help="temp directory for rank-array spills (default .)")
    p.add_argument("-v", dest="patterns", default=None, metavar="FILE",
                   help="verify pattern counts before/after the merge")
    p.add_argument("-i", dest="input_formats", default=None, metavar="FMT[,FMT...]",
                   help="input format(s), comma separated (default native)")
    p.add_argument("-o", dest="output_format", default="native", metavar="FMT",
                   help="output format (default native)")
    p.add_argument("--backend", default="jax", choices=("numpy", "jax"),
                   help="compute backend (default jax)")
    p.add_argument("--search", default="auto",
                   choices=("auto", "walk", "trie"),
                   help="search engine: per-read backward walk (needs the "
                        "read-text sidecar; 'walk' forces a one-time device "
                        "decode without one), reverse-trie wavefront, or "
                        "auto (walk when text is on hand; default)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="checkpoint each pairwise merge to DIR and resume an "
                        "interrupted k-way merge from the last completed fold")
    p.add_argument("--hash", action="store_true", dest="print_hash",
                   help="print the FNV-1a content hash of the merged BWT "
                        "(representation-independent equality check)")
    p.add_argument("--stream", action="store_true",
                   help="stream the final merged BWT straight to the output "
                        "file (never materialized in memory; native/sga only)")
    p.add_argument("--low-memory", action="store_true", dest="low_memory",
                   help="destructive-profile file-to-file folds: inputs are "
                        "released before each merge phase, which re-reads "
                        "them in bounded windows (the reference's clearUntil "
                        "memory profile); streaming output formats only")
    p.add_argument("--fold", default="auto",
                   choices=("auto", "kway", "chain"),
                   help="k-way strategy: 'kway' folds all inputs at once by "
                        "pairwise rank-array decomposition (no intermediate "
                        "merged index is ever built — flat insert rate in "
                        "base size, O(window) memory; jax backend + walk "
                        "search, streaming output formats); 'chain' is the "
                        "reference-style left fold of pairwise merges; "
                        "'auto' picks kway when eligible (default)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler device trace of the merges to "
                        "DIR (view with TensorBoard/Perfetto)")
    p.add_argument("--list-formats", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--quiet", action="store_true", help="suppress progress output")
    return p


def _load_checkpoint(ckpt_dir, inputs):
    """Returns (next_input_index, FMI | None, pre_counts | None)."""
    import json
    import os

    if not ckpt_dir:
        return 1, None, None
    state_path = os.path.join(ckpt_dir, "state.json")
    if not os.path.exists(state_path):
        return 1, None, None
    with open(state_path) as f:
        state = json.load(f)
    completed = int(state.get("completed", 0))
    if state.get("inputs") != inputs or completed < 1:
        print("bwt_merge: checkpoint input list does not match; starting fresh",
              file=sys.stderr)
        return 1, None, None
    ckpt = os.path.join(ckpt_dir, f"fold_{completed}.native")
    if not os.path.exists(ckpt):
        return 1, None, None
    index = load_fmi(ckpt, "native")
    pre = np.asarray(state.get("pre", []), dtype=np.int64)
    return completed + 1, index, pre if pre.size else None


def _save_checkpoint(ckpt_dir, inputs, completed, index, pre) -> None:
    import json
    import os

    if not ckpt_dir:
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, f"fold_{completed}.native")
    serialize_fmi(index, ckpt, "native")
    tmp = os.path.join(ckpt_dir, "state.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"inputs": inputs, "completed": completed,
                   "pre": pre.tolist()}, f)
    os.replace(tmp, os.path.join(ckpt_dir, "state.json"))
    prev = os.path.join(ckpt_dir, f"fold_{completed - 1}.native")
    if os.path.exists(prev):
        os.remove(prev)


def _low_memory_merge(args, inputs, in_formats, output, config,
                      patterns, pre, post, start) -> int:
    """File-to-file left fold via merge_files: no fold ever holds its inputs
    and its output together (reference clearUntil profile, bwt.cpp:233-265).

    Intermediates are native-format temp files (each one doubles as a crash
    checkpoint); -v pattern verification loads one input at a time.
    """
    import os
    import tempfile

    from ..formats.streaming import STREAM_WRITERS
    from ..models.merge import merge_files

    if args.output_format not in STREAM_WRITERS:
        print(f"bwt_merge: --low-memory needs a streaming output format "
              f"({', '.join(sorted(STREAM_WRITERS))}), not "
              f"'{args.output_format}'", file=sys.stderr)
        return 1
    if args.checkpoint:
        print("Warning: --checkpoint ignored with --low-memory (every "
              "intermediate fold is already a file)", file=sys.stderr)

    if patterns:
        for name, fmt in zip(inputs, in_formats):
            fmi = load_fmi(name, fmt)
            verify_fmi(fmi, "Input", patterns, pre, verbose=not args.quiet,
                       use_device=args.backend == "jax")
            del fmi

    bytes_added = 0
    cur, cur_fmt = inputs[0], in_formats[0]
    tmp_prev = None
    for i in range(1, len(inputs)):
        last = i == len(inputs) - 1
        if last:
            dst, dst_fmt = output, args.output_format
        else:
            fd, dst = tempfile.mkstemp(suffix=".native", prefix=".bwtmerge_fold_",
                                       dir=config.temp_dir)
            os.close(fd)
            dst_fmt = "native"
        merge_start = time.monotonic()
        stats: dict = {}
        with config.timer.device_trace(args.profile):
            merge_files(cur, inputs[i], dst, in_fmt=cur_fmt, out_fmt=dst_fmt,
                        config=config, stats=stats, in_fmt_b=in_formats[i])
        bytes_added += stats.get("b_bases", 0)
        if not args.quiet:
            secs = time.monotonic() - merge_start
            print(f"Merged {inputs[i]}: "
                  f"{in_megabytes(stats.get('b_bases', 0)) / max(secs, 1e-9):.2f} MB/s")
        if tmp_prev:
            os.remove(tmp_prev)
        tmp_prev = None if last else dst
        cur, cur_fmt = dst, dst_fmt

    status = 0
    if patterns or args.print_hash:
        index = load_fmi(output, args.output_format)
        verify_fmi(index, "Output", patterns, post, verbose=not args.quiet,
                   use_device=args.backend == "jax")
        if args.print_hash:
            print(f"Hash:             {index.hash():016x}")
        if patterns:
            errors = int(np.sum(pre != post))
            if errors:
                print(f"Verification failed for {errors} patterns")
                status = 2
            else:
                print("Verification successful")
            print("")

    if not args.quiet:
        report_totals(time.monotonic() - start, bytes_added)
    return status


def _kway_merge(args, inputs, in_formats, output, config,
                patterns, pre, post, start) -> int:
    """All-at-once k-way fold by pairwise rank-array decomposition
    (models/kfold.py): no intermediate merged index, O(window) host memory,
    insert rate flat in the accumulated base size."""
    from ..models.kfold import merge_files_many

    if patterns:
        for name, fmt in zip(inputs, in_formats):
            fmi = load_fmi(name, fmt)
            verify_fmi(fmi, "Input", patterns, pre, verbose=not args.quiet,
                       use_device=args.backend == "jax")
            del fmi

    stats: dict = {}
    merge_start = time.monotonic()
    with config.timer.device_trace(args.profile):
        merge_files_many(inputs, output, in_formats, args.output_format,
                         config, stats=stats)
    bytes_added = sum(stats.get("piece_bases", [0])[1:])
    if not args.quiet:
        secs = time.monotonic() - merge_start
        print(f"Merged {len(inputs)} inputs in one k-way fold: "
              f"{in_megabytes(bytes_added) / max(secs, 1e-9):.2f} MB/s")

    status = 0
    if patterns or args.print_hash:
        index = load_fmi(output, args.output_format)
        verify_fmi(index, "Output", patterns, post, verbose=not args.quiet,
                   use_device=args.backend == "jax")
        if args.print_hash:
            print(f"Hash:             {index.hash():016x}")
        if patterns:
            errors = int(np.sum(pre != post))
            if errors:
                print(f"Verification failed for {errors} patterns")
                status = 2
            else:
                print("Verification successful")
            print("")

    if not args.quiet:
        report_totals(time.monotonic() - start, bytes_added)
    return status


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_formats:
        print_formats(sys.stdout)
        return 0
    if len(args.files) < 3:
        print("bwt_merge: need at least two inputs and an output", file=sys.stderr)
        return 1

    start = time.monotonic()
    inputs, output = args.files[:-1], args.files[-1]

    in_formats = (args.input_formats.split(",") if args.input_formats else ["native"])
    if len(in_formats) == 1:
        in_formats = in_formats * len(inputs)
    if len(in_formats) != len(inputs):
        print(f"bwt_merge: Specified {len(in_formats)} formats for "
              f"{len(inputs)} inputs", file=sys.stderr)
        return 1
    for fmt in in_formats:
        check_format(fmt, "bwt_merge", "input")
    check_format(args.output_format, "bwt_merge", "output")

    if args.backend == "jax":
        from ..utils.jax_setup import enable_compile_cache

        enable_compile_cache()

    config = MergeConfig(backend=args.backend, temp_dir=args.temp_dir,
                         verbose=not args.quiet, search=args.search,
                         cache_sidecar=(args.search == "walk"))
    if args.run_buffer is not None:
        config.run_buffer_runs = args.run_buffer * 1024 * 1024
    if args.thread_buffer is not None:
        config.thread_buffer_mb = args.thread_buffer
    if args.merge_buffers is not None:
        config.merge_buffers = args.merge_buffers
    if args.sequence_blocks is not None:
        config.sequence_blocks = args.sequence_blocks
    if args.devices is not None:
        config.devices = args.devices
    if args.device_blocks is not None:
        config.device_blocks = args.device_blocks
    config.index_placement = args.index_placement
    if args.hbm_budget_mb is not None:
        config.hbm_budget_bytes = args.hbm_budget_mb << 20
    config.sanitize()

    if not args.quiet:
        print("BWT-merge")
        print("")
        for name, fmt in zip(inputs, in_formats):
            print(f"Input:            {name} ({fmt})")
        print(f"Output:           {output} ({args.output_format})")
        if args.patterns:
            print(f"Patterns:         {args.patterns}")
        print(f"Backend:          {args.backend}")
        print("")

    patterns = read_rows(args.patterns) if args.patterns else []
    pre = np.zeros(len(patterns), dtype=np.int64)
    post = np.zeros(len(patterns), dtype=np.int64)
    if patterns and not args.quiet:
        chars = sum(len(p) for p in patterns)
        print(f"Read {len(patterns)} patterns of total length {chars}")
        print("")

    from ..formats.streaming import STREAM_WRITERS as _SW

    kway_ok = (len(inputs) > 2 and args.backend == "jax"
               and args.search != "trie" and args.output_format in _SW
               and not args.checkpoint and not args.low_memory)
    if args.fold == "kway" or (args.fold == "auto" and kway_ok):
        if not kway_ok:
            why = ("needs >2 inputs, --backend jax, a walk-capable --search, "
                   "a streaming output format, and no --checkpoint/--low-memory")
            print(f"bwt_merge: --fold kway unavailable ({why}); "
                  "falling back to the pairwise chain", file=sys.stderr)
        else:
            return _kway_merge(args, inputs, in_formats, output, config,
                               patterns, pre, post, start)

    if args.low_memory:
        return _low_memory_merge(args, inputs, in_formats, output, config,
                                 patterns, pre, post, start)

    # Resume from a checkpointed fold when available (the reference's de-facto
    # restartability — any pairwise boundary is a native-format checkpoint —
    # made explicit, SURVEY.md §5).
    start_at, index, pre_restore = _load_checkpoint(args.checkpoint, inputs)
    if index is None:
        index = load_fmi(inputs[0], in_formats[0])
        verify_fmi(index, "Input", patterns, pre, verbose=not args.quiet,
                   use_device=args.backend == "jax")
        start_at = 1
    else:
        if not args.quiet:
            print(f"Resuming after {start_at - 1} merged increment(s) "
                  f"from {args.checkpoint}")
        if pre_restore is not None and pre_restore.size == pre.size:
            pre[:] = pre_restore

    from ..formats.streaming import STREAM_WRITERS

    stream_last = args.stream and args.output_format in STREAM_WRITERS \
        and not args.checkpoint
    if args.stream and not stream_last:
        reason = ("--checkpoint holds the merged index in memory between folds"
                  if args.checkpoint else
                  f"output format '{args.output_format}' has no streaming writer")
        print(f"Warning: --stream ignored ({reason}); "
              "merging fully in memory", file=sys.stderr)

    bytes_added = 0
    streamed_out = False
    for i in range(start_at, len(inputs)):
        name, fmt = inputs[i], in_formats[i]
        increment = load_fmi(name, fmt)
        bytes_added += increment.size()
        verify_fmi(increment, "Input", patterns, pre, verbose=not args.quiet,
                   use_device=args.backend == "jax")
        merge_start = time.monotonic()
        with config.timer.device_trace(args.profile):
            if stream_last and i == len(inputs) - 1:
                # final fold: stream straight to the output file
                from ..models.merge import merge_fmi_to_file

                merge_fmi_to_file(index, increment, output,
                                  args.output_format, config)
                streamed_out = True
            else:
                index = merge_fmi(index, increment, config)
        if not args.quiet:
            secs = time.monotonic() - merge_start
            print(f"Merged {name}: {in_megabytes(increment.size()) / max(secs, 1e-9):.2f} MB/s")
        if not streamed_out:
            _save_checkpoint(args.checkpoint, inputs, i, index, pre)

    if streamed_out:
        if patterns or args.print_hash:
            index = load_fmi(output, args.output_format)
            verify_fmi(index, "Output", patterns, post, verbose=not args.quiet,
                       use_device=args.backend == "jax")
    else:
        serialize_fmi(index, output, args.output_format)
        verify_fmi(index, "Output", patterns, post, verbose=not args.quiet,
                   use_device=args.backend == "jax")

    if args.print_hash:
        print(f"Hash:             {index.hash():016x}")

    status = 0
    if patterns:
        errors = int(np.sum(pre != post))
        if errors:
            print(f"Verification failed for {errors} patterns")
            status = 2
        else:
            print("Verification successful")
        print("")

    if not args.quiet:
        report_totals(time.monotonic() - start, bytes_added)
    return status


if __name__ == "__main__":
    sys.exit(main())
