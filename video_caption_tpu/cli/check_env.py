"""Environment health check CLI (reference: scripts/check_project_env.ps1:
20-47 + experiments/check_gpu.py): dependency groups, accelerator
visibility, HBM snapshot, import health of the package's own modules.

Usage: python -m video_caption_tpu.cli.check_env [--require-gpu]
"""
from __future__ import annotations

import argparse
import importlib
import sys


CORE_MODULES = (
    "video_caption_tpu.config", "video_caption_tpu.engine",
    "video_caption_tpu.models.caption_model", "video_caption_tpu.decode.generate",
    "video_caption_tpu.data.data_loader", "video_caption_tpu.bench.benchmark",
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--require-gpu", action="store_true")
    args = p.parse_args(argv)
    failures = 0

    from video_caption_tpu.env import (
        RuntimeNotReady, assert_core_runtime_ready, device_summary,
    )

    try:
        assert_core_runtime_ready(require_gpu=args.require_gpu)
        print("[ok] core dependencies")
    except RuntimeNotReady as err:
        print(f"[FAIL] {err}")
        failures += 1

    for group, names in (("server", ("fastapi", "uvicorn")), ("frontend", ("httpx", "chainlit"))):
        missing = [n for n in names if importlib.util.find_spec(n) is None]
        status = "ok" if not missing else f"degraded (missing {', '.join(missing)})"
        print(f"[{'ok' if not missing else '--'}] {group}: {status}")

    for mod in CORE_MODULES:
        try:
            importlib.import_module(mod)
            print(f"[ok] import {mod}")
        except Exception as err:
            print(f"[FAIL] import {mod}: {err}")
            failures += 1

    info = device_summary()
    print(f"[ok] jax {info['jax_version']} backend={info['backend']} "
          f"devices={info['num_devices']} kind={info['device_kind']}")

    from video_caption_tpu.memory import MemoryManager

    snap = MemoryManager().snapshot()
    if snap.bytes_limit:
        print(f"[ok] device memory: {snap.bytes_in_use / 2**20:.0f} / {snap.bytes_limit / 2**20:.0f} MB")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
