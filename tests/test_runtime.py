"""Runtime configuration and the GPU smoke script's refusal elsewhere."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "outside"])
def test_compile_cache_rule(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache goes to
    the checkout's .jax_cache, which git ignores."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    want = os.path.join(ROOT, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax, krepp_tpu; krepp_tpu.configure(); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """Without a GPU the smoke exits non-zero before building any world and
    never prints its ok line, in the checkout or copied out of it."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        cwd = str(tmp_path / "alone")
        os.makedirs(cwd)
        script = shutil.copy(script, cwd)
    work = tmp_path / "work"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script, "--workdir", str(work)],
                         env=env, cwd=cwd, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert not work.exists()
