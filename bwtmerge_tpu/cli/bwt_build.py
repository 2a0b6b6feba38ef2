"""bwt_build — construct a mergeable BWT from raw reads.

Usage: python -m bwtmerge_tpu.cli.bwt_build reads.txt output [-o fmt] [--rlo]

Beyond-parity tool: the reference has no builder — its workflow needs
ropebwt/ropebwt2 to produce per-sample BWTs before bwt_merge can run
(paper.tex:274).  This closes the pipeline: plain reads (one per line,
$ACGTN alphabet) -> BWT in any registered output format, with optional
reverse-lexicographic (RLO) read reordering, the run-count-minimizing order
the paper benchmarks (paper.tex:278).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..formats import write_bwt
from ..models.build import (alphabet_for, build_from_reads,
                            read_plain_reads_packed)
from ..utils.metrics import in_gigabytes, in_megabytes, memory_usage
from .common import check_format, print_formats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bwt_build",
        description="Build a BWT from plain reads (one per line, ACGTN).")
    p.add_argument("input", help="reads file: one read per line")
    p.add_argument("output")
    p.add_argument("-o", dest="output_format", default="native", metavar="FMT",
                   help="output format (default native)")
    p.add_argument("--rlo", action="store_true",
                   help="sort reads in reverse-lexicographic order first "
                        "(shrinks the run count; see paper.tex:278)")
    p.add_argument("--backend", choices=("auto", "jax", "sharded", "numpy"),
                   default="auto",
                   help="suffix sort backend: device lax.sort prefix "
                        "doubling (jax), mesh-distributed sort (sharded, for "
                        "> one device's memory), host "
                        "numpy, or auto by collection size (default)")
    p.add_argument("--no-sidecar", action="store_true",
                   help="skip the read-text sidecar (<output>.reads4); the "
                        "sidecar lets later merges use the walk search "
                        "without decoding this BWT first")
    p.add_argument("--list-formats", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_formats:
        print_formats(sys.stdout)
        return 0
    check_format(args.output_format, "bwt_build", "output")
    if args.backend != "numpy":
        from ..utils.jax_setup import enable_compile_cache

        enable_compile_cache()

    if not args.quiet:
        print("BWT builder")
        print("")
        print(f"Input:   {args.input} (plain reads)")
        print(f"Output:  {args.output} ({args.output_format})"
              + (" [RLO order]" if args.rlo else ""))
        print("")

    start = time.monotonic()
    try:
        flat, lengths = read_plain_reads_packed(args.input)
    except (OSError, ValueError) as e:
        print(f"bwt_build: {e}", file=sys.stderr)
        return 1
    if lengths.size == 0:
        print(f"bwt_build: no reads in {args.input}", file=sys.stderr)
        return 1

    runs, order = build_from_reads((flat, lengths), rlo=args.rlo,
                               backend=args.backend)
    write_bwt(args.output, args.output_format, runs, alphabet_for(runs))
    if not args.no_sidecar:
        # read-text sidecar: lets merges walk-search this BWT without a
        # device decode.  Its columns follow the BWT's sequence order
        # (sequence k is read order[k]), which the merge's sidecar
        # spot-check decodes against.
        from ..formats.sidecar import sidecar_path, write_sidecar
        from ..ops.sa_jax import _reorder_packed

        if args.rlo:
            flat, lengths = _reorder_packed(flat, lengths, order)
        write_sidecar(sidecar_path(args.output), lengths, flat)
    seconds = time.monotonic() - start

    if not args.quiet:
        bases = int(lengths.sum())
        print(f"{lengths.size} reads, {bases} bases, {runs.n_runs} runs "
              f"({in_megabytes(bases) / max(seconds, 1e-9):.2f} MB/s)")
        print(f"Total time:       {seconds:.2f} seconds")
        print(f"Peak memory:      {in_gigabytes(memory_usage()):.3f} GB")
        print("")
    return 0


if __name__ == "__main__":
    sys.exit(main())
