"""Build ~510 Mbp insert pieces for the big-piece xlarge tier by k-way
folding groups of the cached 102 Mbp pieces (lane-blocked walks make big
pieces first-class fold inputs; fewer, bigger pieces minimize the
pairwise-decomposition's walk count: K^2/2 * piece_lanes with K*piece
fixed falls linearly in piece size)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache")

GROUPS = {
    "xl_big_1": (201, 202, 203, 204, 205),
    "xl_big_2": (205, 206, 207, 208, 209),
    "xl_big_3": (203, 204, 205, 206, 207),
    "xl_big_4": (209, 208, 202, 201, 204),
    "xl_big_5": (202, 204, 206, 208, 209),
    "xl_big_6": (201, 203, 205, 207, 209),
}


def main() -> None:
    from bwtmerge_tpu.utils.jax_setup import enable_compile_cache

    enable_compile_cache()

    from bwtmerge_tpu.models.kfold import merge_files_many
    from bwtmerge_tpu.models.merge import MergeConfig

    for name, ids in GROUPS.items():
        out = os.path.join(CACHE, f"{name}.native")
        if os.path.exists(out):
            print(f"{name}: cached")
            continue
        paths = [os.path.join(CACHE, f"xl_piece_{i}.sga") for i in ids]
        t0 = time.monotonic()
        merge_files_many(paths, out, "sga", "native",
                         MergeConfig(backend="jax", temp_dir="/tmp"))
        print(f"{name}: {time.monotonic() - t0:.1f}s "
              f"({os.path.getsize(out) / 1e6:.0f} MB)", flush=True)


if __name__ == "__main__":
    main()
