"""utils.compile_cache: $JAX_COMPILATION_CACHE_DIR wins and nothing is set
in code; otherwise one fixed directory inside the checkout."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import jax
jax.config.update("jax_platforms", "cpu")
from raw_image_pipeline_tpu.utils import compile_cache as cc
got = cc.enable_compilation_cache()
print("DIR", got)
print("CFG", jax.config.jax_compilation_cache_dir)
"""


def _run(env):
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return dict(l.split(" ", 1) for l in out.stdout.splitlines()
                if l[:4] in ("DIR ", "CFG "))


def test_env_var_is_honoured(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    got = _run(env)
    assert got["DIR"] == str(tmp_path)
    # jax picks the variable up itself; the helper sets nothing
    assert got["CFG"] == str(tmp_path)


def test_default_is_fixed_inside_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    first, second = _run(env), _run(env)
    want = os.path.join(REPO, ".jax_cache")
    assert first["DIR"] == second["DIR"] == want
    assert first["CFG"] == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
