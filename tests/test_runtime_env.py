"""Runtime gates and placement: the GPU-or-explicit-CPU gate, the compile
cache directory, the native build directory, the optional PIL dependency
and the legacy kernel-switch request fields."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from video_caption_tpu import env

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    before = jax.config.jax_compilation_cache_dir
    assert env.compilation_cache_dir() == str(tmp_path / "cc")
    assert env.enable_compilation_cache() == str(tmp_path / "cc")
    # JAX reads the variable itself: nothing is configured in code
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "cc").exists()


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(env.compilation_cache_dir())
    assert path == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_not_set_on_cpu_backend(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert env.enable_compilation_cache() == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == before


def test_native_loader_builds_inside_checkout():
    from video_caption_tpu.native import loader

    assert loader.BUILD_DIR == REPO / ".build" / "native"
    assert ".build/" in (REPO / ".gitignore").read_text().split()


def test_gate_allows_cpu_only_when_requested(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    env.assert_accelerator_or_cpu_requested()       # the test suite's case
    monkeypatch.setenv("JAX_PLATFORMS", "")
    with pytest.raises(env.RuntimeNotReady, match="GPU required"):
        env.assert_accelerator_or_cpu_requested()    # a silent CPU fallback


def test_require_gpu_refuses_cpu_backend():
    env.assert_core_runtime_ready()
    with pytest.raises(env.RuntimeNotReady, match=r"\['cpu'\]"):
        env.assert_core_runtime_ready(require_gpu=True)


def test_core_runtime_does_not_need_pil():
    assert "PIL" not in env._CORE_DEPS
    code = ("import sys, video_caption_tpu.engine, "
            "video_caption_tpu.preprocessing.frame_loader; "
            "print('PIL' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.strip() == "False"


def test_legacy_kernel_fields_accepted_and_ignored():
    from video_caption_tpu.server.schemas import InferRequest
    from video_caption_tpu.server.services.inference_service import request_to_config

    req = InferRequest(frames_dir="/x", use_pallas_fused_pool=True,
                       use_pallas_prefix_projector=False, compute_dtype="float32")
    cfg = request_to_config(req)
    assert cfg.compile.dtype == "float32"
    assert not [f for f in vars(cfg.compile) if "pallas" in f]
