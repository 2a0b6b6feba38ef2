"""Build cached xlarge fixtures (~1 Gbp total) for the xlarge bench tier.

Base: 7 x 102 Mbp read sets built ON DEVICE (models/build.py prefix-doubling
SA), left-folded with the production merge engine into a ~714 Mbp native
index.  Inserts: two more 102 Mbp sets (sga + read-text sidecars).  All
cached under .bench_cache/xl_*; reruns are no-ops.
"""
import os, sys, time
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import numpy as np

CACHE = os.path.join(REPO, ".bench_cache")
from bwtmerge_tpu.native.build import build_library
build_library()

from bwtmerge_tpu.utils.jax_setup import enable_compile_cache
enable_compile_cache()

from bwtmerge_tpu.formats import read_bwt, write_bwt
from bwtmerge_tpu.formats.sidecar import sidecar_path, write_sidecar
from bwtmerge_tpu.models.build import build_from_reads
from bwtmerge_tpu.models.fmi import FMI
from bwtmerge_tpu.models.merge import MergeConfig, merge_fmi, merge_fmi_to_file
from bwtmerge_tpu.utils.alphabet import Alphabet

M, L = 2_000_000, 50          # 102 Mbp per piece (2M reads x 50bp + marks)

def piece(seed: int) -> str:
    """One 102 Mbp SGA + sidecar, built on device, cached."""
    path = os.path.join(CACHE, f"xl_piece_{seed}.sga")
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(seed)
    flat = rng.integers(1, 5, size=M * L).astype(np.int32)
    lens = np.full(M, L, np.int64)
    t0 = time.monotonic()
    runs, _ = build_from_reads((flat, lens), rlo=False, backend="jax")
    print(f"piece {seed}: device build {time.monotonic()-t0:.1f}s "
          f"({runs.size()} bases)", file=sys.stderr, flush=True)
    write_bwt(path, "sga", runs, Alphabet.from_counts(runs.counts(6)))
    write_sidecar(sidecar_path(path), lens.astype(np.uint32),
                  flat.astype(np.uint8))
    return path

BASE = os.path.join(CACHE, "xl_base.native")
SEEDS = (202, 203, 204, 205, 206, 207)


def save_native(acc, path):
    from bwtmerge_tpu.formats.streaming import write_bwt_stream

    def chunks():
        step = 1 << 22
        for s in range(0, acc.runs.syms.size, step):
            yield acc.runs.syms[s:s + step], acc.runs.lens[s:s + step]

    write_bwt_stream(path, "native", chunks(), acc.alpha)


if not os.path.exists(BASE):
    cfg = MergeConfig(backend="jax", temp_dir="/tmp", search="auto")
    t0 = time.monotonic()
    # resume from the largest fold checkpoint on disk
    start = 0
    acc = None
    for k in range(len(SEEDS), 0, -1):
        ck = os.path.join(CACHE, f"xl_fold_{k}.native")
        if os.path.exists(ck):
            runs, _, alpha = read_bwt(ck, "native")
            acc = FMI(runs=runs, alpha=alpha)
            start = k
            print(f"resumed at fold {k} ({acc.size()} bases)",
                  file=sys.stderr, flush=True)
            break
    if acc is None:
        p0 = piece(201)
        runs, _, alpha = read_bwt(p0, "sga")
        acc = FMI(runs=runs, alpha=alpha, creads_path=sidecar_path(p0))
    for k in range(start, len(SEEDS)):
        seed = SEEDS[k]
        p = piece(seed)
        runs, _, alpha = read_bwt(p, "sga")
        ins = FMI(runs=runs, alpha=alpha, creads_path=sidecar_path(p))
        t1 = time.monotonic()
        acc = merge_fmi(acc, ins, cfg)
        print(f"fold +{seed}: {time.monotonic()-t1:.1f}s "
              f"-> {acc.size()} bases", file=sys.stderr, flush=True)
        ck = os.path.join(CACHE, f"xl_fold_{k + 1}.native")
        save_native(acc, ck)
        prev = os.path.join(CACHE, f"xl_fold_{k}.native")
        if os.path.exists(prev):
            os.remove(prev)
    os.rename(os.path.join(CACHE, f"xl_fold_{len(SEEDS)}.native"), BASE)
    print(f"xl_base: {acc.size()} bases in {time.monotonic()-t0:.1f}s total",
          file=sys.stderr, flush=True)
else:
    print("xl_base cached", file=sys.stderr)

piece(208)
piece(209)
print("XLARGE FIXTURES READY", file=sys.stderr)
