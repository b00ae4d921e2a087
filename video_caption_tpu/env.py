"""Dependency and accelerator gates (reference: core/env.py:20-74).

Named dependency groups asserted before model load, the GPU check that
replaces the reference's CUDA availability probe, and the placement of the
persistent compilation cache.
"""
from __future__ import annotations

import importlib
import os
from pathlib import Path
from typing import Iterable


class RuntimeNotReady(RuntimeError):
    pass


# PIL is optional: the native loader decodes frames without it, and the PIL
# path imports it only when it runs (preprocessing/frame_loader.py).
_CORE_DEPS = ("jax", "jax.numpy", "numpy")
_SERVER_DEPS = ("fastapi", "uvicorn", "pydantic")
_FRONTEND_DEPS = ("httpx",)

CHECKOUT_DIR = Path(__file__).resolve().parent.parent
# Fixed cache path when JAX_COMPILATION_CACHE_DIR is unset: the path is part
# of the cache key, so a per-process or temporary directory never hits.
DEFAULT_COMPILE_CACHE = CHECKOUT_DIR / ".jax_cache"


def _assert_importable(names: Iterable[str], group: str) -> None:
    missing = []
    for name in names:
        try:
            importlib.import_module(name)
        except Exception:  # pragma: no cover - import failure path
            missing.append(name)
    if missing:
        raise RuntimeNotReady(f"missing {group} dependencies: {', '.join(missing)}")


def assert_core_runtime_ready(require_gpu: bool = False) -> None:
    _assert_importable(_CORE_DEPS, "core")
    if require_gpu:
        import jax

        kinds = {d.platform for d in jax.devices()}
        if "gpu" not in kinds:
            raise RuntimeNotReady(f"GPU required but available platforms are {sorted(kinds)}")


def assert_accelerator_or_cpu_requested() -> None:
    """Gate for the serving entry points: run on a GPU, or on the CPU only
    when ``JAX_PLATFORMS=cpu`` asked for it (as the test suite does). A JAX
    whose CUDA plugin failed to start falls back to the CPU silently; this
    refuses that case."""
    if os.environ.get("JAX_PLATFORMS", "").strip().lower() != "cpu":
        assert_core_runtime_ready(require_gpu=True)


def assert_server_runtime_ready() -> None:
    assert_core_runtime_ready()
    _assert_importable(_SERVER_DEPS, "server")


def assert_frontend_runtime_ready() -> None:
    _assert_importable(_FRONTEND_DEPS, "frontend")


def compilation_cache_dir() -> str:
    """Where compiled executables persist: ``JAX_COMPILATION_CACHE_DIR`` if
    set (JAX reads it itself), else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_COMPILE_CACHE)


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache: compiled executables survive process
    restarts, so a restarted server skips the cold compile. This is the XLA
    analog of the reference's reserved TensorRT engine files
    (core/trt/build_engine.py). Returns the directory in use.

    When ``JAX_COMPILATION_CACHE_DIR`` is set nothing is configured here.
    CPU backends are excluded: XLA:CPU AOT entries embed compile-time tuning
    features that the loader's host-feature check does not report, so any
    cross-process CPU cache load warns of a possible SIGILL. CPU is the test
    backend here with fast-compiling tiny geometries."""
    import jax

    path = compilation_cache_dir()
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or jax.default_backend() == "cpu":
        return path
    if jax.config.jax_compilation_cache_dir != path:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str:
    """The first card's name and power limit as ``nvidia-smi`` reports them
    (``NVIDIA H100 80GB HBM3, 700.00 W``): a card set below its maximum
    limit runs slower under load, so every device number carries this."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_summary() -> dict:
    """Environment fingerprint for reports (reference: benchmark_baseline.py:319-327)."""
    import jax

    devs = jax.devices()
    return {
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "num_devices": len(devs),
        "device_kind": devs[0].device_kind if devs else "none",
    }
