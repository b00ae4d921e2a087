"""Frozen-encoder feature extraction (reference: scripts/extract_features.py:
17-55): one L2-normalized embedding per video, saved as .npy files plus a
consolidated features matrix.

Videos are batched through one jitted encoder program instead of
the reference's per-video forward."""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import List, Tuple

import numpy as np

log = logging.getLogger(__name__)


def extract_features(
    ann_path: str,
    out_dir: str,
    num_frames: int = 8,
    image_size: int = 224,
    batch_size: int = 8,
    limit: int = 0,
    encoder=None,
) -> Tuple[np.ndarray, List[str]]:
    """Returns (features [N,D] L2-normalized, video_ids); writes per-video
    .npy files + features.npy + ids.json under out_dir."""
    import jax
    import jax.numpy as jnp

    from video_caption_tpu.data.data_loader import MSVDDataset

    if encoder is None:
        from video_caption_tpu.config import default_inference_config
        from video_caption_tpu.engine import load_params, model_config_from_inference
        from video_caption_tpu.models import caption_model as cm

        cfg = default_inference_config(num_frames=num_frames, image_size=image_size)
        mc = model_config_from_inference(cfg)
        params = load_params(cfg, mc)

        @jax.jit
        def encoder_fn(video):
            return cm.encode_video(params, video, mc)

        encoder = encoder_fn

    ds = MSVDDataset(ann_path, num_frames=num_frames, image_size=image_size,
                     captions_per_video=1)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    feats, ids = [], []
    batch_videos, batch_ids = [], []

    def flush():
        if not batch_videos:
            return
        videos = jnp.asarray(np.stack(batch_videos))
        emb = np.asarray(encoder(videos))
        emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        for vid, e in zip(batch_ids, emb):
            np.save(out / f"{vid}.npy", e)
            feats.append(e)
            ids.append(vid)
        batch_videos.clear()
        batch_ids.clear()

    seen = set()
    for sample in ds.samples:
        vid = sample["video_id"]
        if vid in seen:
            continue
        seen.add(vid)
        if limit and len(seen) > limit:
            break
        batch_videos.append(ds.load_video(sample["frames_dir"]))
        batch_ids.append(vid)
        if len(batch_videos) == batch_size:
            flush()
    flush()

    features = np.stack(feats) if feats else np.zeros((0, 0), np.float32)
    np.save(out / "features.npy", features)
    (out / "ids.json").write_text(json.dumps(ids))
    log.info("extracted %d features to %s", len(ids), out)
    return features, ids
