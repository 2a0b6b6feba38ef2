"""Smoke run of the merge path on the GPU, through the user entry points.

    python chip_smoke.py               # one card: phases S, M, K
    python chip_smoke.py --cards 4     # four cards: the multi-device paths

Everything runs in ONE process (one JAX client per card; the compile cache
stays warm between phases) and drives the CLIs a user runs:
bwtmerge_tpu.cli.bwt_build.main and bwtmerge_tpu.cli.bwt_merge.main.  Data
is generated from --seed: a random genome of 10 Mbp, 100 bp reads sampled
at uniform positions from both strands with 0.5% substitutions.

  S  A = 20k reads, B = 10k reads; the jax backend's walk and trie merges
     must be byte-identical to the numpy backend (the host reference,
     ops/search_np.py + ops/rank_np.py).
  M  A = 4M reads (400 Mbp), B = C = 1M reads, built with `bwt_build --rlo`;
     A+B merged with the walk and with the trie, each with `-v` over 2^20
     32-mers; both must verify and be byte-identical.  Device rank probes
     (ranks_all, the -v count) are timed on A's index and checked against
     the host sparse rank index.
  K  A+B+C with `--fold kway -v` must equal `--fold chain` byte for byte.

--cards 4 runs only the multi-device paths and the one-card runs they are
compared with: the phase-M merge with `-t 4 --index-placement replicated`
(mesh walk) and `-t 4 --index-placement sharded --search trie`, and
`bwt_build --backend sharded` of B.

A host without a GPU fails.  The last stdout line is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke_work")

GENOME_BP = 10_000_000
READ_LEN = 100
ERROR_RATE = 0.005
PATTERN_LEN = 32

S_READS = (20_000, 10_000)              # A, B
M_READS = (4_000_000, 1_000_000, 1_000_000)   # A, B, C
M_PATTERNS = 1 << 20


# -- data ---------------------------------------------------------------------


def make_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    """Uniform random genome, base codes 0-3 (A, C, G, T)."""
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def sample_reads(rng: np.random.Generator, genome: np.ndarray, n: int,
                 read_len: int = READ_LEN, error_rate: float = ERROR_RATE,
                 chunk: int = 1 << 18) -> np.ndarray:
    """uint8[n, read_len] base codes: uniform start positions, half the
    reads reverse-complemented, each base substituted with probability
    error_rate.  Generated in chunks to bound host temporaries."""
    out = np.empty((n, read_len), np.uint8)
    offs = np.arange(read_len, dtype=np.int64)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        pos = rng.integers(0, genome.size - read_len + 1, size=m)
        r = genome[pos[:, None] + offs]
        rev = rng.random(m) < 0.5
        r[rev] = 3 - r[rev, ::-1]                 # complement: A<->T, C<->G
        err = rng.random((m, read_len)) < error_rate
        r[err] = (r[err] + rng.integers(1, 4, size=int(err.sum()),
                                        dtype=np.uint8)) % 4
        out[s:s + m] = r
    return out


def write_reads(path: str, reads: np.ndarray) -> None:
    """One read per line, ACGT."""
    lines = np.empty((reads.shape[0], reads.shape[1] + 1), np.uint8)
    lines[:, :-1] = np.frombuffer(b"ACGT", np.uint8)[reads]
    lines[:, -1] = ord("\n")
    lines.tofile(path)


def write_patterns(path: str, rng: np.random.Generator, reads: np.ndarray,
                   n: int, k: int = PATTERN_LEN) -> None:
    """n k-mers: half cut from the reads (occur), half uniform random."""
    half = n // 2
    rows = rng.integers(0, reads.shape[0], size=half)
    offs = rng.integers(0, reads.shape[1] - k + 1, size=half)
    from_reads = reads[rows[:, None], offs[:, None] + np.arange(k)]
    rand = rng.integers(0, 4, size=(n - half, k), dtype=np.uint8)
    write_reads(path, np.concatenate([from_reads, rand]))


# -- measurement --------------------------------------------------------------


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (or loading from
    the persistent cache), summed from its monitoring events."""

    EVENTS = ("/jax/core/compile/backend_compile_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/jaxpr_trace_duration")

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kwargs):
        if event in self.EVENTS:
            self.seconds += duration


def peak_bytes() -> list:
    import jax

    return [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
            for d in jax.local_devices()]


@contextlib.contextmanager
def phase(name: str, clock: CompileClock, record: dict):
    t0, c0 = time.monotonic(), clock.seconds
    yield
    wall = time.monotonic() - t0
    compile_s = clock.seconds - c0
    record[name] = {"wall_s": wall, "compile_s": compile_s,
                    "warm_s": wall - compile_s, "peak_bytes": peak_bytes()}
    print(f"phase {name}: wall {wall:.2f} s = compile {compile_s:.2f} s "
          f"+ warm {wall - compile_s:.2f} s; peak bytes per card "
          f"{record[name]['peak_bytes']}", flush=True)


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


# -- entry points -------------------------------------------------------------


def run_cli(main, argv) -> str:
    """Call a CLI main in this process; returns its stdout.  A non-zero
    status raises."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        status = main(argv)
    out = buf.getvalue()
    sys.stderr.write(out)
    if status:
        raise RuntimeError(f"{main.__module__} {argv} exited {status}")
    return out


def build(reads_path: str, out_path: str, *extra) -> None:
    from bwtmerge_tpu.cli import bwt_build

    run_cli(bwt_build.main, [reads_path, out_path, "-o", "sga", "--rlo",
                             *extra])


def merge(inputs, out_path: str, *extra, patterns: str | None = None) -> str:
    """bwt_merge inputs -> out_path (sga); with patterns, the -v check
    must report success.  Returns the output file's digest."""
    from bwtmerge_tpu.cli import bwt_merge

    argv = [*inputs, out_path, "-i", "sga", "-o", "sga",
            "-d", os.path.dirname(out_path), *extra]
    if patterns:
        argv += ["-v", patterns]
    out = run_cli(bwt_merge.main, argv)
    if patterns and "Verification successful" not in out:
        raise RuntimeError(f"bwt_merge {extra}: -v did not verify")
    return file_digest(out_path)


def same(label: str, digests: dict) -> None:
    """All digests equal, or fail naming them."""
    for k, v in digests.items():
        print(f"hash {label} {k}: {v}", flush=True)
    if len(set(digests.values())) != 1:
        raise RuntimeError(f"{label}: outputs differ: {digests}")


# -- phases -------------------------------------------------------------------


def phase_s(work: str, rng: np.random.Generator, genome: np.ndarray,
            n_a: int, n_b: int) -> None:
    """Plain-reference phase: jax walk and trie merges == numpy merge."""
    paths = {}
    for side, n in (("a", n_a), ("b", n_b)):
        reads = os.path.join(work, f"s_{side}.txt")
        write_reads(reads, sample_reads(rng, genome, n))
        paths[side] = os.path.join(work, f"s_{side}.sga")
        build(reads, paths[side])
    ab = [paths["a"], paths["b"]]
    same("S", {
        "numpy": merge(ab, os.path.join(work, "s_numpy.sga"),
                       "--backend", "numpy"),
        "walk": merge(ab, os.path.join(work, "s_walk.sga"), "-t", "1",
                      "--backend", "jax", "--search", "walk"),
        "trie": merge(ab, os.path.join(work, "s_trie.sga"), "-t", "1",
                      "--backend", "jax", "--search", "trie"),
    })


def build_m_inputs(work: str, rng: np.random.Generator, genome: np.ndarray,
                   sides: str) -> tuple:
    """Phase-M read sets and BWTs for `sides` (subset of "abc"), plus the
    pattern file cut from A's reads."""
    paths, reads_paths = {}, {}
    patterns = os.path.join(work, "patterns.txt")
    for side, n in zip("abc", M_READS):
        if side not in sides:
            continue
        reads = sample_reads(rng, genome, n)
        reads_paths[side] = os.path.join(work, f"m_{side}.txt")
        write_reads(reads_paths[side], reads)
        if side == "a":
            write_patterns(patterns, rng, reads, M_PATTERNS)
        del reads
        paths[side] = os.path.join(work, f"m_{side}.sga")
        build(reads_paths[side], paths[side])
    return paths, reads_paths, patterns


def time_device_probes(a_path: str, patterns: str) -> None:
    """ranks_all on 2^20 sorted and random queries and the -v count on A's
    device index, timed warm and checked against the host sparse index."""
    import jax.numpy as jnp

    from bwtmerge_tpu.cli.common import read_rows
    from bwtmerge_tpu.models.fmi import load_fmi
    from bwtmerge_tpu.ops.rank_jax import batch_count
    from bwtmerge_tpu.ops.rank_np import SparseRankIndex

    fmi = load_fmi(a_path, "sga")
    idx = fmi.device_index
    host = SparseRankIndex.build(fmi.runs)
    rng = np.random.default_rng(7)
    q = rng.integers(0, fmi.size() + 1, size=1 << 20).astype(np.int32)
    for label, qs in (("random", q), ("sorted", np.sort(q))):
        dq = jnp.asarray(qs)
        got = np.asarray(idx.ranks_all(dq))            # compile + check
        sub = rng.integers(0, qs.size, size=512)
        for c in range(1, 6):
            want = host.rank(qs[sub], np.full(sub.size, c))
            if not np.array_equal(got[sub, c], want):
                raise RuntimeError(f"ranks_all ({label}) != host rank, c={c}")
        times = []
        for _ in range(5):
            t0 = time.monotonic()
            idx.ranks_all(dq).block_until_ready()
            times.append(time.monotonic() - t0)
        print(f"ranks_all 2^20 {label} queries: median "
              f"{sorted(times)[2] * 1e3:.3f} ms (5 runs, {fmi.size()} "
              f"positions)", flush=True)

    pats = read_rows(patterns)
    batch_count(idx, pats[:1 << 16], fmi.alpha.char2comp)       # compile
    t0 = time.monotonic()
    counts = batch_count(idx, pats, fmi.alpha.char2comp)
    dt = time.monotonic() - t0
    comps = np.stack([fmi.alpha.char2comp[np.frombuffer(p.encode(), np.uint8)]
                      for p in pats[:256]]).astype(np.int64)
    sp, ep = host.batch_backward_search(
        fmi.alpha.C.astype(np.int64), comps,
        np.full(comps.shape[0], comps.shape[1], np.int64))
    if not np.array_equal(counts[:256], np.maximum(0, ep - sp + 1)):
        raise RuntimeError("batch_count != host backward search")
    print(f"-v count of {len(pats)} {PATTERN_LEN}-mers on A: {dt:.3f} s "
          f"({counts.sum()} occurrences)", flush=True)


def one_card(work: str, seed: int, clock: CompileClock, record: dict) -> None:
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, GENOME_BP)
    with phase("S", clock, record):
        phase_s(work, rng, genome, *S_READS)

    with phase("M-build", clock, record):
        paths, _, patterns = build_m_inputs(work, rng, genome, "abc")
    ab = [paths["a"], paths["b"]]
    digests = {}
    with phase("M-walk", clock, record):
        digests["walk"] = merge(ab, os.path.join(work, "m_walk.sga"),
                                "-t", "1", "--search", "walk", "--hash",
                                patterns=patterns)
    with phase("M-trie", clock, record):
        digests["trie"] = merge(ab, os.path.join(work, "m_trie.sga"),
                                "-t", "1", "--search", "trie", "--hash",
                                patterns=patterns)
    same("M", digests)
    with phase("M-probes", clock, record):
        time_device_probes(paths["a"], patterns)

    abc = [paths["a"], paths["b"], paths["c"]]
    digests = {}
    with phase("K-kway", clock, record):
        digests["kway"] = merge(abc, os.path.join(work, "k_kway.sga"),
                                "-t", "1", "--fold", "kway",
                                patterns=patterns)
    with phase("K-chain", clock, record):
        digests["chain"] = merge(abc, os.path.join(work, "k_chain.sga"),
                                 "-t", "1", "--fold", "chain")
    same("K", digests)


def four_cards(work: str, seed: int, clock: CompileClock,
               record: dict) -> None:
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, GENOME_BP)
    with phase("M-build", clock, record):
        paths, reads, _ = build_m_inputs(work, rng, genome, "ab")
    with phase("build-sharded", clock, record):
        sharded_b = os.path.join(work, "m_b_sharded.sga")
        build(reads["b"], sharded_b, "--backend", "sharded")
    same("build", {"t1": file_digest(paths["b"]),
                   "sharded": file_digest(sharded_b)})

    ab = [paths["a"], paths["b"]]
    digests = {}
    with phase("t1", clock, record):
        digests["t1"] = merge(ab, os.path.join(work, "t1.sga"), "-t", "1")
    with phase("t4-replicated", clock, record):
        digests["t4-replicated"] = merge(
            ab, os.path.join(work, "t4_rep.sga"), "-t", "4",
            "--index-placement", "replicated")
    with phase("t4-sharded-trie", clock, record):
        digests["t4-sharded-trie"] = merge(
            ab, os.path.join(work, "t4_sh.sga"), "-t", "4",
            "--index-placement", "sharded", "--search", "trie")
    same("4-card", digests)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but {len(devices)} visible",
              file=sys.stderr)
        return 1

    from bwtmerge_tpu.utils.jax_setup import enable_compile_cache
    from bwtmerge_tpu.utils.metrics import card_info

    print(card_info(), flush=True)             # name, power limit per card
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    clock = CompileClock()
    record: dict = {}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        if args.cards == 1:
            one_card(WORK, args.seed, clock, record)
        else:
            four_cards(WORK, args.seed, clock, record)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"phases": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
