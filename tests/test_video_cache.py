"""Device-resident LRU video cache: repeat requests for an unchanged frames
dir skip JPEG decode and the host->device transfer."""
import os
import time

import numpy as np
import pytest
from PIL import Image


def _frames(tmp_path, name, n=2, seed=0):
    d = tmp_path / name
    d.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            d / f"frame_{i:05d}.jpg"
        )
    return str(d)


@pytest.fixture()
def engine(tiny_cfg, tiny_params):
    from video_caption_tpu.config import default_inference_config
    from video_caption_tpu.engine import InferenceEngine

    cfg = default_inference_config(
        ckpt="missing.pt", num_frames=2, image_size=32,
        preset1="precise", preset2="precise", preset3="precise",
    )
    return InferenceEngine(cfg, params=tiny_params, model_cfg=tiny_cfg)


def test_repeat_dir_hits_cache(engine, tmp_path, monkeypatch):
    d = _frames(tmp_path, "v0")
    calls = []
    import video_caption_tpu.preprocessing.frame_loader as fl_mod

    real = fl_mod.load_video_packed

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    # the batch miss path loads through load_video_packed (resolved at call
    # time from the preprocessing module)
    monkeypatch.setattr(fl_mod, "load_video_packed", counting)
    r1 = engine.infer_batch([d, d])
    n_first = len(calls)
    assert n_first >= 1
    r2 = engine.infer_batch([d, d])
    assert len(calls) == n_first, "unchanged dir must be served from the cache"
    assert [x.to_api_dict() for x in r1] == [x.to_api_dict() for x in r2]


def test_duplicate_dirs_in_one_batch_load_once(engine, tmp_path, monkeypatch):
    d = _frames(tmp_path, "v1", seed=1)
    calls = []
    import video_caption_tpu.preprocessing.frame_loader as fl_mod

    real = fl_mod.load_video_packed
    monkeypatch.setattr(
        fl_mod, "load_video_packed",
        lambda *a, **k: (calls.append(a), real(*a, **k))[1],
    )
    engine.infer_batch([d, d, d, d])
    assert len(calls) == 1, "duplicate dirs in one batch must decode once"


def test_mtime_change_invalidates(engine, tmp_path):
    d = _frames(tmp_path, "v2", seed=2)
    key1, _, _ = engine._video_cache_get(d)
    engine.infer(d)
    _, hit, _ = engine._video_cache_get(d)
    assert hit is not None
    time.sleep(0.02)
    # rewrite a frame -> its mtime changes -> cache key changes
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(
        os.path.join(d, "frame_00001.jpg")
    )
    key2, hit2, _ = engine._video_cache_get(d)
    assert key2 != key1
    assert hit2 is None


def test_non_newest_frame_replacement_invalidates(engine, tmp_path):
    """Replacing a NON-newest frame (timestamp-preserving copies keep the
    dir's max mtime) must still miss — the key digests every file's
    (name, mtime, size)."""
    d = _frames(tmp_path, "v2b", seed=7)
    # make frame_00001 strictly newer so frame_00000 is not the newest
    os.utime(os.path.join(d, "frame_00001.jpg"), ns=(2**62, 2**62))
    engine.infer(d)
    _, hit, _ = engine._video_cache_get(d)
    assert hit is not None
    # replace frame_00000 with different pixels at an OLDER mtime
    Image.fromarray(np.full((32, 32, 3), 7, np.uint8)).save(
        os.path.join(d, "frame_00000.jpg")
    )
    os.utime(os.path.join(d, "frame_00000.jpg"), ns=(1000, 1000))
    _, hit2, _ = engine._video_cache_get(d)
    assert hit2 is None


def test_capacity_eviction(engine, tmp_path):
    engine._video_cache_bytes = 8000  # one [1,2,3,32,32] u8 video = 6144 bytes
    a = _frames(tmp_path, "va", seed=3)
    b = _frames(tmp_path, "vb", seed=4)
    engine.infer(a)
    engine.infer(b)
    _, hit_a, _ = engine._video_cache_get(a)
    _, hit_b, _ = engine._video_cache_get(b)
    assert hit_b is not None and hit_a is None, "LRU must evict the older video"


def test_cache_disabled(engine, tmp_path):
    engine._video_cache_bytes = 0
    d = _frames(tmp_path, "v3", seed=5)
    engine.infer(d)
    assert len(engine._video_cache) == 0
