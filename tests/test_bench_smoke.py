"""bench.py's measurement harness must trace and run end to end: its
chain timing is exercised here on the CPU at a tiny size, and its entry
point must refuse to run without a GPU."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tpu_fps_code_path_on_cpu():
    code = """
import jax; jax.config.update("jax_platforms", "cpu")
import bench
h = bench.chain_fps(h=108, w=144, batch=2, tag="ci smoke")
assert set(h) == {"fps", "ms_per_step", "batch", "compile_s"}, sorted(h)
assert h["fps"] > 0 and h["ms_per_step"] > 0 and h["batch"] == 2
print("BENCH_SMOKE_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BENCH_SMOKE_OK" in out.stdout


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "bench.py"], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert out.stdout.strip() == ""
