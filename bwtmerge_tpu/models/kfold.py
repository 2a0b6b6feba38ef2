"""K-way fold orchestration over the pairwise rank-array decomposition.

The left-fold merge (reference bwt_merge.cpp:163-173) re-derived so that no
intermediate merged index is ever built (see ops/kfold_jax.py for the math):

  device   one resident cplane index per piece; piece k's summed rank array
           = elementwise sum of its sorted pairwise walks through pieces
           0..k-1; packed planes stream to the host (~0.5 B/run)
  host     k-1 windowed interleave passes chained as PIPELINED chunk
           generators (native/windowed.py): pass k consumes pass k-1's
           output stream, so all passes + the device walks overlap and peak
           host memory is O(window), independent of every size in sight

Fold cost per inserted base is flat in the accumulated base size by
construction — the property the reference gets from C++ pointer-chasing at
8-9 Mbp/s (paper.tex:266) and that a device left-fold loses to the
per-fold index round trip over the host link.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..utils.alphabet import Alphabet
from .fmi import FMI
from .merge import MergeConfig
from .runs import RunArrays

def _alpha_sum(alphas: List[Alphabet]) -> Alphabet:
    a0 = alphas[0]
    C = a0.C.astype(np.int64).copy()
    for a in alphas[1:]:
        if a != a0:
            raise ValueError("cannot merge BWTs with different alphabets")
        C += a.C.astype(np.int64)
    return type(a0)(char2comp=a0.char2comp.copy(),
                    comp2char=a0.comp2char.copy(),
                    C=C.astype(np.uint64))


class _FoldDevice:
    """Device residency + fold-step dispatch for a k-way fold.

    Pieces are registered in fold order; `dispatch_step(k)` walks piece k
    through every earlier piece and returns a single-part BlockedPackedRA
    whose window D2H copies are requested eagerly (pure DMA that overlaps
    later steps' walk compute — the platform executes programs in dispatch
    order, so lazily-sliced windows would queue behind them).
    """

    def __init__(self, timer=None):
        self.targets = []   # PieceIndex per registered piece
        self.timer = timer

    def _phase(self, name):
        import contextlib

        return self.timer.phase(name) if self.timer else contextlib.nullcontext()

    def add_piece(self, payload, counts: np.ndarray,
                  need_creads: bool, need_index: bool):
        """Upload piece (nibble-packed), derive cplanes (if it will be
        walked through) and device-decode its creads (if it will walk).
        The fused record table is freed on return.

        payload: RunArrays (in-memory pieces) or a ("nib", nibbles, size)
        tuple from the 0.5 B/pos chunked file loader."""
        from ..ops.kfold_jax import PieceIndex
        from ..ops.rank_jax import DeviceFMIndex
        from ..ops.walk_jax import decode_creads_dev

        if isinstance(payload, tuple) and payload[0] == "nib":
            _, nibbles, size = payload
            idx = DeviceFMIndex.from_nibbles(nibbles, counts, size)
        else:
            idx = DeviceFMIndex.build(payload, counts)
        runs_size = idx.size
        creads = None
        if need_creads:
            dec = decode_creads_dev(idx, int(counts[0]), runs_size)
            if dec is None:   # a read beyond the walk length cap
                raise _PieceTooLong()
            creads, n_reads = dec
        if need_index:
            self.targets.append(PieceIndex.from_device_index(idx))
        else:
            self.targets.append(None)
        return creads

    def step_part_thunks(self, k: int, creads, n_reads: int, chars: int):
        """Per-lane-block dispatch thunks for step k (piece k vs pieces
        0..k-1): each thunk, when called, dispatches ONE lane block's
        walks + pack + window grid and returns a single-part stream.

        Laziness is the HBM control: a 510 Mbp piece's pack is ~4 parts of
        ~1.3 GB of device planes each, so the drainer calls thunks as its
        outstanding-part budget frees up instead of holding a whole step's
        pack (ops/kfold_jax.summed_packed_parts would dispatch them all)."""
        from ..ops.kfold_jax import summed_packed_part_thunks
        from ..ops.search_jax import BlockedPackedRA, make_block_part

        targets = self.targets[:k]
        assert all(t is not None for t in targets)
        bound = chars + n_reads + 2

        def wrap(thunk):
            def run():
                dc8, meta, exc4, esc = thunk()
                part = make_block_part(dc8, meta, exc4, esc,
                                       BlockedPackedRA.CHUNK, bound)
                return BlockedPackedRA([part])
            return run

        return [wrap(t)
                for t in summed_packed_part_thunks(targets, creads,
                                                   n_reads=n_reads)]


class _PieceTooLong(Exception):
    pass


def merge_fmi_many(fmis: List[FMI], config: Optional[MergeConfig] = None
                   ) -> FMI:
    """K-way merge of in-memory FMIs via the pairwise decomposition;
    falls back to sequential pairwise merge_fmi when the fold engine is
    unavailable (numpy backend, oversized reads, walk-disabled)."""
    from .merge import merge_fmi

    config = (config or MergeConfig()).sanitize()
    if len(fmis) == 0:
        raise ValueError("merge_fmi_many needs at least one input")
    if len(fmis) == 1:
        return fmis[0]
    alpha = _alpha_sum([f.alpha for f in fmis])
    use_fold = (config.backend == "jax"
                and _search_mode_allows_walk(config)
                and len(fmis) > 2)
    if use_fold:
        try:
            chunks = _fold_chain_chunks(
                len(fmis), lambda k: (fmis[k].runs, fmis[k].alpha), config,
                a_chunks=fmis[0].runs.iter_chunks(1 << 20),
                piece_chunks=lambda k: fmis[k].runs.iter_chunks(1 << 20))
            merged = _materialize(chunks)
            return FMI(runs=merged, alpha=alpha)
        except _PieceTooLong:
            print("kfold: piece reads exceed the walk cap; falling back to "
                  "the pairwise chain", file=sys.stderr)
    acc = fmis[0]
    for f in fmis[1:]:
        acc = merge_fmi(acc, f, config)
    return acc


def merge_files_many(paths: List[str], out_path: str,
                     in_fmts, out_fmt: str = "native",
                     config: Optional[MergeConfig] = None,
                     window_positions: int = 1 << 24,
                     stats: Optional[dict] = None) -> None:
    """K-way streaming file merge: the memory-bounded production fold.

    Per piece, the runs are resident only during its device upload; the
    interleave chain re-reads every file as bounded windows.  Peak host
    memory: max piece runs (upload window) + O(window) chain state.
    """
    from ..formats.streaming import write_bwt_stream
    from ..formats.streaming_read import read_bwt_chunks
    from .merge import merge_files

    config = (config or MergeConfig()).sanitize()
    config.timer.verbose = config.verbose
    if isinstance(in_fmts, str):
        in_fmts = [in_fmts] * len(paths)
    if len(paths) < 2:
        raise ValueError("merge_files_many needs at least two inputs")

    use_fold = config.backend == "jax" and _search_mode_allows_walk(config)
    if not use_fold or len(paths) == 2:
        # pairwise chain through temp checkpoints (the round-4 path)
        import os
        import tempfile

        cur, cur_fmt = paths[0], in_fmts[0]
        tmpdir = tempfile.mkdtemp(dir=config.temp_dir, prefix=".bwtm_fold_")
        try:
            for k in range(1, len(paths)):
                out_k = (out_path if k == len(paths) - 1
                         else os.path.join(tmpdir, f"fold_{k}.native"))
                fmt_k = out_fmt if k == len(paths) - 1 else "native"
                merge_files(cur, paths[k], out_k, cur_fmt, fmt_k,
                            config, window_positions, stats,
                            in_fmt_b=in_fmts[k])
                cur, cur_fmt = out_k, fmt_k
        finally:
            import shutil

            shutil.rmtree(tmpdir, ignore_errors=True)
        return

    def loader(k):
        # chunk-stream the file straight into the 0.5 B/pos nibble upload
        # layout — run arrays for a piece are never materialized (the
        # round-4 tier's 18 GB host peak was exactly these)
        from ..formats.streaming_read import alphabet_for
        from ..ops.rank_jax import pack_nibbles_chunked

        nib, counts, size, _ = pack_nibbles_chunked(
            read_bwt_chunks(paths[k], in_fmts[k]))
        al = alphabet_for(in_fmts[k], counts, paths[k])
        if al.size() != size:
            raise ValueError(f"{paths[k]}: header size {al.size()} != "
                             f"decoded size {size}")
        return ("nib", nib, size), al

    import threading

    alphas = [None] * len(paths)
    total = [0]
    ready = threading.Event()
    error = [None]

    try:
        chunks = _fold_chain_chunks(
            len(paths), loader, config,
            a_chunks=read_bwt_chunks(paths[0], in_fmts[0]),
            piece_chunks=lambda k: read_bwt_chunks(paths[k], in_fmts[k]),
            window_positions=window_positions, stats=stats,
            alphas_out=alphas, total_out=total, ready_event=ready,
            error_out=error,
            chain=("procs" if _use_proc_stages(len(paths)) else "threads"),
            piece_files=list(zip(paths, in_fmts)))
        with config.timer.phase("fold chain (interleave+write)"):
            # the chain's stages start immediately (their RA streams gate on
            # the async loader/drainer); only the WRITER needs the summed
            # alphabet, so the header wait overlaps all piece uploads.
            # Pull the first chunk BEFORE creating the output file so loader
            # errors (incl. _PieceTooLong) surface without a torn file.
            it = iter(chunks)
            peek = next(it, None)
            ready.wait()
            if error[0] is not None:
                raise error[0]
            alpha = _alpha_sum(alphas)
            if stats is not None:
                stats["piece_bases"] = [a.size() for a in alphas]

            def with_peek():
                if peek is not None:
                    yield peek
                    yield from it

            write_bwt_stream(out_path, out_fmt, with_peek(), alpha)
    except _PieceTooLong:
        print("kfold: piece reads exceed the walk cap; falling back to the "
              "pairwise chain", file=sys.stderr)
        return merge_files_many(paths, out_path, in_fmts, out_fmt,
                                _chain_config(config), window_positions,
                                stats)
    if config.verbose:
        config.timer.report(total[0])


def _use_proc_stages(k_total: int) -> bool:
    """Subprocess chain stages for file folds with 2+ steps (disable with
    BWTMERGE_PROC_STAGES=0)."""
    return (k_total > 2
            and os.environ.get("BWTMERGE_PROC_STAGES", "1") != "0")


def _chain_config(config: MergeConfig) -> MergeConfig:
    import copy

    c = copy.copy(config)
    c.search = "trie"
    return c


def _search_mode_allows_walk(config: MergeConfig) -> bool:
    import os

    env = os.environ.get("BWTMERGE_SEARCH")
    mode = env if env in ("walk", "trie", "auto") else \
        getattr(config, "search", "auto")
    return mode != "trie"


def _fold_chain_chunks(k_total: int, loader, config: MergeConfig, a_chunks,
                       piece_chunks, window_positions: int = 1 << 24,
                       stats: Optional[dict] = None,
                       alphas_out: Optional[list] = None,
                       total_out: Optional[list] = None,
                       ready_event=None, error_out=None,
                       chain: str = "threads", piece_files=None):
    """Build the full device fold + host interleave chain; returns the
    merged run-chunk generator (ascending maximal-run-clean chunks).

    loader(k) -> (RunArrays, Alphabet) loads piece k (released after its
    upload); a_chunks/piece_chunks supply the interleave chain's INPUT
    streams (file readers or in-memory chunkers) so piece runs need not
    stay resident.
    """
    from ..native.windowed import interleave_windowed_chunks
    from ..utils.pipeline import prefetch_chunks

    import threading

    dev = _FoldDevice(timer=config.timer)
    steps = _StepDrainer(dev, k_total - 1, config, stats=stats,
                         verbose=config.verbose)
    if stats is not None:
        stats["fold_steps"] = k_total - 1

    # lookahead-1 loader pool: piece k+1's host read + nibble pack overlaps
    # piece k's upload/decode (both link/device-bound)
    import concurrent.futures as _fut

    _pool = _fut.ThreadPoolExecutor(1)

    def _produce():
        """Upload pieces and feed fold-step metadata to the drainer: piece
        k+1's upload overlaps step k's walks + drain, and the whole loop
        overlaps the consuming interleave chain."""
        t0 = time.monotonic()
        nxt = None
        try:
            with config.timer.phase("device fold dispatch"):
                for k in range(k_total):
                    payload, al = nxt.result() if nxt is not None \
                        else loader(k)
                    nxt = (_pool.submit(loader, k + 1)
                           if k + 1 < k_total else None)
                    counts = al.counts()
                    size = int(al.size())
                    if alphas_out is not None:
                        alphas_out[k] = al
                    if total_out is not None:
                        total_out[0] += size
                    creads = dev.add_piece(
                        payload, counts, need_creads=k > 0,
                        need_index=k < k_total - 1)
                    if k > 0:
                        steps.push((creads, int(counts[0]),
                                    size - int(counts[0])))
                    del creads, payload
                    if stats is not None:
                        stats.setdefault("piece_dispatch_s", []).append(
                            round(time.monotonic() - t0, 2))
                    if config.verbose:
                        print(f"kfold: piece {k} dispatched "
                              f"({time.monotonic() - t0:.1f}s)",
                              file=sys.stderr)
        except BaseException as e:  # noqa: BLE001 - surface at consumers
            steps.fail(e)
            if error_out is not None:
                error_out[0] = e
        finally:
            _pool.shutdown(wait=False)
            if ready_event is not None:
                ready_event.set()

    if ready_event is None:
        # synchronous piece loop (in-memory merges; also keeps exceptions
        # like _PieceTooLong on the caller's stack for clean fallbacks)
        _produce()
        steps.check()
    else:
        threading.Thread(target=_produce, daemon=True).start()

    if chain == "procs":
        return _proc_chain_chunks(steps, k_total, piece_files,
                                  window_positions)

    cur = a_chunks
    for k in range(1, k_total):
        cur = interleave_windowed_chunks(
            prefetch_chunks(cur, depth=2), piece_chunks(k),
            steps.ra_stream(k - 1), window_positions=window_positions,
            stats=stats)
    return prefetch_chunks(cur, depth=1)


def _proc_chain_chunks(steps, k_total: int, piece_files, window: int):
    """The interleave chain as SUBPROCESS stages connected by pipes
    (models/kfold_stage.py): each stage's windowed pass runs on its own
    core — CPython threads serialize the stages' host-side work on the GIL
    (profiled ~50% of a pass), which capped deep folds at ~1 core of chain
    throughput regardless of stage count.

    piece_files: [(path, fmt)] for all k_total pieces.  Stage k spawns when
    step k-1's rank array has drained to its spill files (children read
    and delete them); its A input is the previous stage's stdout.
    """
    import subprocess

    def gen():
        from .kfold_stage import read_frames

        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs = []
        prev = None
        try:
            for k in range(1, k_total):
                steps.wait_spill(k - 1)
                spill_args = [f"{p}:{n}"
                              for p, n in steps.spill_files(k - 1)]
                cmd = [sys.executable, "-m",
                       "bwtmerge_tpu.models.kfold_stage",
                       "--b-path", piece_files[k][0],
                       "--b-fmt", piece_files[k][1],
                       "--window", str(window), "--spill"] + spill_args
                if k == 1:
                    cmd += ["--a-path", piece_files[0][0],
                            "--a-fmt", piece_files[0][1]]
                    stdin = subprocess.DEVNULL
                else:
                    stdin = prev.stdout
                proc = subprocess.Popen(cmd, stdin=stdin,
                                        stdout=subprocess.PIPE, env=env)
                if prev is not None:
                    prev.stdout.close()    # parent's copy of the pipe
                procs.append(proc)
                prev = proc
            yield from read_frames(prev.stdout)
            for proc in procs:
                if proc.wait() != 0:
                    raise RuntimeError(
                        f"kfold stage exited with {proc.returncode}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()

    return gen()


class _StepDrainer:
    """Background thread moving each fold step's rank array device -> host
    spill ladder, strictly in fold order, as piece metadata arrives.

    Why not keep the packs device-resident until the chain consumes them:
    the chain's k-1 stages all run CONCURRENTLY (each pass's output streams
    into the next), so every step's packed planes would be live at once —
    ~0.9 GB each exceeds HBM on deep folds — and any bounded in-flight
    ladder deadlocks against the stages' back-pressure (stage k+AHEAD's RA
    wait stalls its upstream stages, which is exactly what must finish to
    advance the ladder).  Draining each step into the ENCODED host spill
    ladder (models/spill.py, delta+varint ~1-2 B/run on disk) bounds HBM to
    ~2 packs, moves the link D2H EARLY (overlapped with later steps' walk
    compute AND later pieces' uploads), engages the same out-of-core
    machinery as the reference's temp-file rank arrays (support.h:576-638),
    and lets the host chain run at memory speed with no mid-chain device
    dependency.

    Pipeline shape per iteration: dispatch step i's walks the moment its
    piece metadata arrives, then drain step i-1 — so exactly two packs are
    outstanding and step i's walk compute overlaps step i-1's D2H.
    """

    def __init__(self, dev, n_steps, config, stats=None, verbose=False):
        import queue
        import threading

        self._dev = dev
        self._n = n_steps
        # maxsize bounds decoded-creads residency: an unbounded queue let
        # the piece loader run arbitrarily far ahead of the drains and pile
        # ~0.6 GB of creads per queued 510 Mbp piece into HBM
        self._q = queue.Queue(maxsize=1)
        self._spills = [None] * n_steps
        self._events = [threading.Event() for _ in range(n_steps)]
        self._error = [None]
        self._config = config
        self._stats = stats
        self._verbose = verbose
        self._t0 = time.monotonic()
        if n_steps:
            threading.Thread(target=self._run, daemon=True).start()

    def push(self, meta) -> None:
        self._q.put(meta)

    def fail(self, e: BaseException) -> None:
        self._error[0] = e
        for ev in self._events:
            ev.set()
        self._q.put(None)   # unblock the drainer loop

    def check(self) -> None:
        if self._error[0] is not None:
            raise self._error[0]

    def _new_spill(self):
        from .spill import RankArraySpill

        cfg = self._config
        return RankArraySpill(
            temp_dir=cfg.temp_dir,
            spill_threshold_runs=max(
                cfg.run_buffer_runs * cfg.merge_buffers, 1 << 20),
            compact_every=max(cfg.thread_buffer_mb * 1024 * 1024 // 16,
                              1024))

    def _finish_step(self, i, spill):
        # force the in-memory tail to disk: a drained-but-unconsumed step
        # must hold O(file handles), not O(threshold) host runs
        spill._compact()
        if spill._base is not None and spill._base[0].size:
            spill._spill()
        self._spills[i] = spill
        self._events[i].set()
        if self._stats is not None:
            self._stats.setdefault("step_drained_s", []).append(
                round(time.monotonic() - self._t0, 2))
            self._stats.setdefault("step_spill_files", []).append(
                spill.n_spill_files)
        if self._verbose:
            print(f"kfold: step {i} rank array drained "
                  f"({time.monotonic() - self._t0:.1f}s, "
                  f"{spill.n_spill_files} spill files)", file=sys.stderr)

    def _run(self):
        import queue as queue_mod
        import threading

        # Drain at LANE-BLOCK-PART granularity: a big piece's step is
        # several ~0.8 GB packed parts, so the HBM bound must be on parts,
        # not whole packs.  Two drain workers + up to 2 parts outstanding:
        # later parts'/steps' walk COMPUTE overlaps earlier parts' D2H +
        # host decode + spill encode.  A step's parts share one spill
        # accumulator (emit under its lock — parts' value ranges overlap
        # and the ladder merges them); the step publishes when its last
        # part drains.
        #
        # Workers are plain DAEMON threads, not a ThreadPoolExecutor:
        # executor threads are non-daemon and joined at interpreter exit,
        # so a fold that errored left the PROCESS alive forever — with its
        # jax client still holding HBM, poisoning every later run on the
        # chip (the round-5 xlarge OOM cascade).
        sem = threading.Semaphore(2)
        work: queue_mod.Queue = queue_mod.Queue()

        def drain_part(i, bp, spill, lock, left):
            try:
                for v, c in bp.stream():   # device waits + native decode
                    with lock:             # per-chunk: decode overlaps emit
                        spill.emit(v, c)
                del bp
                with lock:
                    left[0] -= 1
                    last = left[0] == 0
                if last:
                    self._finish_step(i, spill)
            except BaseException as e:  # noqa: BLE001
                self.fail(e)
            finally:
                sem.release()

        def worker():
            while True:
                item = work.get()
                if item is None:
                    return
                drain_part(*item)

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(2)]
        for w in workers:
            w.start()
        try:
            for i in range(self._n):
                meta = self._q.get()
                if meta is None or self._error[0] is not None:
                    return
                creads, n_reads, chars = meta
                thunks = self._dev.step_part_thunks(i + 1, creads, n_reads,
                                                    chars)
                del creads
                spill = self._new_spill()
                lock = threading.Lock()
                left = [len(thunks)]
                for thunk in thunks:
                    sem.acquire()
                    if self._error[0] is not None:
                        return
                    bp = thunk()        # dispatches this part's walks
                    work.put((i, bp, spill, lock, left))
                    del bp
                del thunks
        except BaseException as e:  # noqa: BLE001 - surface at consumers
            self.fail(e)
        finally:
            for _ in workers:
                work.put(None)

    def ra_stream(self, k: int):
        def gen():
            self._events[k].wait()
            if self._error[0] is not None:
                raise self._error[0]
            spill = self._spills[k]
            try:
                yield from spill.stream()
            finally:
                self._spills[k] = None
                for f in getattr(spill, "_files", []):
                    try:
                        f.delete()
                    except OSError:
                        pass

        return gen()

    def wait_spill(self, k: int) -> None:
        self._events[k].wait()
        if self._error[0] is not None:
            raise self._error[0]

    def spill_files(self, k: int):
        """[(path, n_runs)] of step k's drained rank array (proc-stage
        chain: the consuming child k-way merges and deletes them; their
        value ranges overlap when the step drained several parts)."""
        spill = self._spills[k]
        self._spills[k] = None
        return [(f.path, f.n_runs) for f in spill._files]


def _materialize(chunks) -> RunArrays:
    parts_s, parts_l = [], []
    for s, l in chunks:
        # chunks are views valid only until the next iteration
        parts_s.append(np.array(s, np.uint8, copy=True))
        parts_l.append(np.array(l, np.int64, copy=True))
    if not parts_s:
        return RunArrays.empty()
    runs = RunArrays(np.concatenate(parts_s),
                     np.concatenate(parts_l).astype(np.int64))
    return runs.coalesced()
