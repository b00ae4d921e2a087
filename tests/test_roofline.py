"""Roofline / device-only throughput measurement (bench/roofline.py) — the
run_ncu.ps1 analog (reference: scripts/run_ncu.ps1:1-12)."""
import json

import numpy as np
import pytest

from video_caption_tpu.bench import roofline as rl


@pytest.fixture(scope="module")
def tiny_engine(tiny_cfg):
    from video_caption_tpu.config import InferenceConfig
    from video_caption_tpu.engine import InferenceEngine

    cfg = InferenceConfig(ckpt="/nonexistent.pt", num_frames=2, image_size=32)
    return InferenceEngine(cfg, model_cfg=tiny_cfg)


def test_measure_roofline(tiny_engine, tmp_path):
    path = tmp_path / "roofline.json"
    res = rl.measure_roofline(tiny_engine, batch=2, trials=2, report_path=str(path))
    assert res["device_caps_per_sec"] > 0
    assert res["batch"] == 2
    names = [s["stage"] for s in res["stages"]]
    assert names[0] == "encode"
    assert any(n.startswith("decode[") for n in names)
    for s in res["stages"]:
        assert s["device_ms"] > 0
        assert s["gflops"] > 0
        assert s["gbytes"] > 0
    saved = json.loads(path.read_text())
    assert saved["stages"] == res["stages"]


def test_analytic_flops_scale_with_geometry(tiny_cfg):
    small = rl.vit_encode_flops(tiny_cfg, num_frames=2)
    big = rl.vit_encode_flops(tiny_cfg, num_frames=4)
    assert big > small * 1.9  # frames dominate

    g = tiny_cfg.gpt2
    f1 = rl.decode_group_flops(g, rows=1, num_beams=1, prefill_len=4,
                               max_new_tokens=8, max_len=12)
    f2 = rl.decode_group_flops(g, rows=1, num_beams=4, prefill_len=4,
                               max_new_tokens=8, max_len=12)
    assert f2 > f1  # beams expand decode rows


def test_chip_peaks_none_on_cpu():
    # no published peaks for the CPU: the table raises instead of defaulting
    with pytest.raises(KeyError, match="no published peaks"):
        rl.chip_peaks()  # tests pin the CPU backend
    with pytest.raises(KeyError):
        rl.chip_peaks("NVIDIA H200")


def test_chip_peaks_h100_row():
    peaks = rl.chip_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16": 989e12, "fp8": 1979e12, "tf32": 495e12, "hbm": 3.35e12}
    # ridge point of the bf16 roofline: ~295 FLOP per byte
    assert 290 < peaks["bf16"] / peaks["hbm"] < 300


def test_measure_roofline_reports_platform_without_shares(tiny_engine):
    res = rl.measure_roofline(tiny_engine, batch=2, trials=1, report_path=None)
    assert res["platform"] == "cpu" and res["peaks"] is None
    assert all("pct_peak_flops" not in s for s in res["stages"])
