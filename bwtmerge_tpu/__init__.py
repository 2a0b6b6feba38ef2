"""bwtmerge_tpu — a JAX BWT-merge framework.

A from-scratch re-design of the capabilities of jltsiren/bwt-merge for
accelerators: JAX/XLA on the compute path (batched LF/rank, wavefront and
walk search, segmented interleave), C++ on the byte-codec/IO runtime.

See DESIGN.md for the architecture and SURVEY.md for the reference analysis.
"""

__version__ = "0.1.0"


def _tune_host_allocator() -> None:
    """Keep freed large buffers in the malloc arena instead of munmapping.

    glibc's default policy (mmap every allocation > 128 KiB, munmap on
    free) makes each fresh numpy buffer in a streaming pipeline pay its
    first-touch page faults again; on hosts where those faults are slow
    that dominates the chunked merge.  Raising the mmap and trim thresholds
    makes the heap retain and reuse those pages.
    """
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:  # non-glibc platforms: default allocator behavior
        pass


def _disable_numpy_thp_madvise() -> None:
    """Stop numpy from madvise(MADV_HUGEPAGE)-ing large fresh buffers.

    With transparent hugepages in ``madvise``/``defrag=madvise`` mode (the
    common server config), an madvise'd region pays a *synchronous* hugepage
    compaction at every first touch: measured 63 MB/s fault-in on this class
    of host versus 2.0 GB/s for plain 4 KiB faults — a 32x slowdown on every
    fresh >4 MiB numpy allocation in the streaming merge pipeline.  The
    pipeline's buffers are RLE byte streams touched once sequentially, so the
    TLB benefit of hugepages is negligible while the fault cost dominates.
    Set BWTMERGE_THP=1 to keep numpy's default behavior.
    """
    import os

    if os.environ.get("BWTMERGE_THP") == "1":
        return
    try:
        try:
            from numpy._core import multiarray as _ma  # numpy >= 2.0
        except ImportError:  # numpy 1.x
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:
        pass


_tune_host_allocator()
_disable_numpy_thp_madvise()

from .utils.alphabet import Alphabet, AlphabeticOrder, create_alphabet, identify_alphabet
from .models.runs import RunArrays
from .models.fmi import FMI, load_fmi, serialize_fmi
from .models.merge import MergeConfig, merge_files, merge_fmi, merge_fmi_to_file
from .models.build import build_from_reads, read_plain_reads, rlo_order

__all__ = [
    "build_from_reads",
    "read_plain_reads",
    "rlo_order",
    "Alphabet",
    "AlphabeticOrder",
    "create_alphabet",
    "identify_alphabet",
    "RunArrays",
    "FMI",
    "load_fmi",
    "serialize_fmi",
    "MergeConfig",
    "merge_files",
    "merge_fmi",
    "merge_fmi_to_file",
    "__version__",
]
