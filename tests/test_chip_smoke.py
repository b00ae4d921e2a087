"""chip_smoke.py refuses to run without a GPU and without the repository,
and prints no result line in either case."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(cwd, script):
    return subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          cwd=cwd, env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)


def _has_result_line(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_refuses_cpu_backend():
    out = _run(REPO, REPO / "chip_smoke.py")
    assert out.returncode == 2
    assert "no GPU backend" in out.stderr
    assert not _has_result_line(out.stdout)


def test_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert not _has_result_line(out.stdout)


@pytest.mark.gpu
def test_smoke_numerics_on_card(gpu_device, tmp_path):
    """On the card: the bf16-vs-float32 numerics phase at full width."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    chip_smoke.phase_numerics({"tmp": str(tmp_path), "engine": lambda: _engine()})


def _engine():
    import chip_smoke
    from video_caption_tpu.server.services.model_registry import MODEL_REGISTRY

    return MODEL_REGISTRY.get_engine(chip_smoke.serving_config())
