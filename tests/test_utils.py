import numpy as np
import pytest

from bwtmerge_tpu.utils.ranges import Range, get_bounds
from bwtmerge_tpu.utils.alphabet import (
    Alphabet, AlphabeticOrder, create_alphabet, identify_alphabet, compatible,
)
from bwtmerge_tpu.utils.hashing import fnv1a_bytes, fnv1a_runs, FNV_OFFSET_BASIS


class TestRange:
    def test_length_empty(self):
        assert Range.length((0, 4)) == 5
        assert Range.empty((1, 0))
        assert not Range.empty((0, 0))
        assert Range.empty(Range.empty_range())

    def test_bounds_cover_range(self):
        for total, blocks in [(10, 3), (1, 5), (100, 7), (5, 5), (3, 10)]:
            bounds = get_bounds((0, total - 1), blocks)
            assert bounds[0][0] == 0 and bounds[-1][1] == total - 1
            for (a, b), (c, d) in zip(bounds, bounds[1:]):
                assert c == b + 1
            assert len(bounds) == min(blocks, total)

    def test_bounds_empty(self):
        assert get_bounds((1, 0), 4) == []


class TestAlphabet:
    def test_default_maps(self):
        a = Alphabet()
        assert a.sigma == 6
        assert a.char2comp[ord("A")] == 1
        assert a.char2comp[ord("a")] == 1
        assert a.char2comp[ord("T")] == 4
        assert a.char2comp[ord("N")] == 5
        assert a.char2comp[ord("$")] == 0
        assert a.char2comp[0] == 0
        assert a.char2comp[ord("X")] == 5
        assert bytes(a.comp2char) == b"$ACGTN"

    def test_sorted_order(self):
        s = create_alphabet(AlphabeticOrder.SORTED)
        assert bytes(s.comp2char) == b"$ACGNT"
        assert s.sorted()
        assert not Alphabet().sorted()
        assert identify_alphabet(s) == AlphabeticOrder.SORTED
        assert identify_alphabet(Alphabet()) == AlphabeticOrder.DEFAULT

    def test_compatible(self):
        assert compatible(Alphabet(), AlphabeticOrder.DEFAULT)
        assert not compatible(Alphabet(), AlphabeticOrder.SORTED)
        assert compatible(create_alphabet(AlphabeticOrder.SORTED), AlphabeticOrder.SORTED)
        assert compatible(Alphabet(), AlphabeticOrder.ANY)

    def test_from_counts(self):
        counts = [2, 10, 5, 3, 7, 1]
        a = Alphabet.from_counts(counts)
        assert a.C.tolist() == [0, 2, 12, 17, 20, 27, 28]
        assert a.char_range(1) == (2, 11)
        assert a.size() == 28
        assert np.array_equal(a.counts(), counts)

    def test_identity(self):
        a = Alphabet.identity(6)
        assert list(a.comp2char) == list(range(6))
        assert a.sorted()


class TestHashing:
    def test_fnv_known_value(self):
        # FNV-1a of empty input is the offset basis.
        assert fnv1a_bytes(b"") == FNV_OFFSET_BASIS

    def test_runs_equals_bytes(self, rng):
        vals = rng.integers(0, 6, 100).astype(np.uint8)
        from bwtmerge_tpu.models.runs import RunArrays

        r = RunArrays.from_values(vals)
        assert fnv1a_runs(r.syms, r.lens) == fnv1a_bytes(vals)


class TestCompileCache:
    def test_env_dir_is_honoured(self, tmp_path, monkeypatch):
        """With JAX_COMPILATION_CACHE_DIR set, the helper configures
        nothing of its own."""
        import jax

        from bwtmerge_tpu.utils import jax_setup

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert jax_setup.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_dir_inside_checkout_and_ignored(self):
        import os

        from bwtmerge_tpu.utils.jax_setup import DEFAULT_CACHE_DIR

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert os.path.dirname(DEFAULT_CACHE_DIR) == repo
        ignored = open(os.path.join(repo, ".gitignore")).read().split()
        assert os.path.basename(DEFAULT_CACHE_DIR) + "/" in ignored
