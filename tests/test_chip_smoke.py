"""chip_smoke.py off the card: it refuses a host without a GPU, and its
phase-S reference comparison passes at toy size on the CPU."""

import os
import subprocess
import sys

import numpy as np

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fails_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_reads_come_from_the_genome():
    """Error-free reads are genome substrings or their reverse complements."""
    rng = np.random.default_rng(1)
    genome = chip_smoke.make_genome(rng, 2000)
    reads = chip_smoke.sample_reads(rng, genome, 64, read_len=20,
                                    error_rate=0.0)
    text = genome.tobytes()
    fwd = [r.tobytes() in text for r in reads]
    rev = [(3 - r[::-1]).tobytes() in text for r in reads]
    assert all(f or b for f, b in zip(fwd, rev))
    assert 0 < sum(fwd) < len(fwd)          # both strands drawn


def test_phase_s_matches_numpy_at_toy_size(tmp_path):
    rng = np.random.default_rng(2)
    genome = chip_smoke.make_genome(rng, 5000)
    chip_smoke.phase_s(str(tmp_path), rng, genome, 60, 30)
