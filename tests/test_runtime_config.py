"""Runtime configuration: where the compile cache goes, and the device
path's refusal of silent substitutes (native repair engine, profiler)."""

import os
import subprocess
import sys

import pytest

import ntedit_tpu
from ntedit_tpu.core import bloom
from ntedit_tpu.engine import native_repair, polish
from ntedit_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(ntedit_tpu.__file__)))
_PROBE = ("import ntedit_tpu, jax; "
          "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(env):
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    assert _cache_dir(env) == str(tmp_path / "cache")


def test_compile_cache_default_is_fixed_in_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    got = _cache_dir(env)
    assert got == os.path.join(REPO, ".jax_cache") == ntedit_tpu.DEFAULT_CACHE_DIR
    assert os.path.isdir(got)


def _tiny_filter():
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 12, 3, 25)
    bf.insert_seq(b"ACGT" * 20)
    return bf


def test_polisher_on_gpu_refuses_missing_native_engine(monkeypatch):
    monkeypatch.setattr(native_repair, "available", lambda: False)
    monkeypatch.setattr(native_repair, "build_error", lambda: "make exited 2")
    monkeypatch.setattr(polish.jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="make exited 2"):
        polish.Polisher(_tiny_filter())


def test_polisher_on_cpu_uses_wavefront_without_native(monkeypatch):
    monkeypatch.setattr(native_repair, "available", lambda: False)
    assert polish.Polisher(_tiny_filter()).engine == "wavefront"


def test_trace_raises_when_profiler_cannot_start(monkeypatch, tmp_path):
    import jax

    def refuse(logdir):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(jax.profiler, "start_trace", refuse)
    with pytest.raises(RuntimeError, match="no profiler"):
        with profiling.trace(str(tmp_path)):
            pass
    with profiling.trace(None):  # nothing asked for: a no-op
        pass
