"""chip_smoke.py off the card: its comparison helpers, its phases run
CPU-vs-CPU at tiny sizes (the control flow the card run takes), and its
refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compare_u8_counts_and_bounds():
    a = np.zeros((2, 3, 4), np.uint8)
    b = a.copy()
    b[0, 0, 0] = 1
    assert cs.compare_u8("one", a, b) == (1, 1)
    b[1, 2, 3] = 3
    with pytest.raises(cs.SmokeFailure):
        cs.compare_u8("two", a, b)
    with pytest.raises(cs.SmokeFailure):
        cs.compare_u8("exact", a, a + 1, max_lsb=0)
    with pytest.raises(cs.SmokeFailure):
        cs.compare_u8("shape", a, a[0])


def test_compare_bins_and_state():
    uv = np.array([[3, 4], [5, 6]], np.int32)
    assert cs.compare_bins("same", uv, uv.copy()) == 0
    with pytest.raises(cs.SmokeFailure):
        cs.compare_bins("moved", uv, uv[::-1])
    from raw_image_pipeline_tpu.pipeline import init_state

    st = jax.tree.map(np.asarray, init_state((2,)))
    cs.compare_state("same", st, st)


def test_synth_bayer_is_seeded_scene():
    a = cs.synth_bayer(3, 2, 16, 24)
    assert a.shape == (2, 16, 24) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, cs.synth_bayer(3, 2, 16, 24))
    assert not np.array_equal(a, cs.synth_bayer(4, 2, 16, 24))


def test_phases_cpu_vs_cpu_tiny():
    cpu = jax.devices("cpu")[0]
    frames, config = cs.phase_throughput(cpu, 0, batch=2, hw=(64, 96),
                                         steps=1)
    cs.phase_stream(cpu, 0, hw=(64, 96), n_frames=4)
    cs.phase_numerics(cpu, frames, config, slab=1, sweep_first=1)


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=env)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
