"""Frame directory -> normalized video array [1,T,3,H,W].

Bit-compatible with the reference loader (core/preprocessing/
frame_loader.py:19-49), since caption parity depends on the exact pixels:

- frames are ``frame_*.jpg`` sorted lexicographically,
- stride sampling ``files[::max(len//T, 1)][:T]``,
- PIL bilinear resize to (image_size, image_size) — torchvision's
  ``transforms.Resize`` defaults to bilinear with antialias, which for PIL
  inputs is exactly ``Image.resize((W,H), BILINEAR)``,
- scale to [0,1] then ImageNet mean/std normalization in fp32.

The host side stays numpy; the device sees one [1,T,3,H,W] fp32 transfer
(the reference's CPU->GPU boundary, SURVEY §3.1 device boundary #2).
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

log = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def list_frames(frames_dir: Union[str, Path]) -> List[Path]:
    """Frame files in the canonical preprocessed-dataset format."""
    return sorted(Path(frames_dir).glob("frame_*.jpg"))


def sample_frame_paths(files: Sequence[Path], num_frames: int) -> List[Path]:
    """Stride sampling identical to the reference (frame_loader.py:31-32)."""
    step = max(len(files) // num_frames, 1)
    return list(files[::step][:num_frames])


def load_image(path: Union[str, Path], image_size: int) -> np.ndarray:
    """One frame -> [3,H,W] fp32, ImageNet-normalized."""
    from PIL import Image

    with Image.open(path) as img:
        rgb = img.convert("RGB").resize((image_size, image_size), Image.BILINEAR)
        arr = np.asarray(rgb, np.float32) / 255.0          # [H,W,3]
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.transpose(2, 0, 1)


def load_image_u8(path: Union[str, Path], image_size: int) -> np.ndarray:
    """One frame -> [3,H,W] uint8 resized pixels (no normalization)."""
    from PIL import Image

    with Image.open(path) as img:
        rgb = img.convert("RGB").resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(rgb, np.uint8).transpose(2, 0, 1)


_USE_NATIVE = os.environ.get("VIDEO_CAPTION_NATIVE_LOADER", "1").strip().lower() not in (
    "0", "false", "no", "off",
)


def load_video_array(
    frames_dir: Union[str, Path],
    num_frames: int = 8,
    image_size: int = 224,
    pad_to_num_frames: bool = True,
    use_native: bool = _USE_NATIVE,
) -> np.ndarray:
    """frames_dir -> [1,T,3,H,W] fp32 numpy (reference: load_video_tensor).

    When fewer than ``num_frames`` frames exist, the tail frame repeats so the
    device program keeps a static shape (the reference lets T shrink, which
    would retrigger XLA compilation per video here).

    The multithreaded C++ loader (native/frame_loader.cpp) is tried first;
    PIL is the fallback and the parity reference (same graceful-fallback
    contract as the reference's CuPy ops, cupy_vit_pool.py:139-152).
    """
    frames_dir = Path(frames_dir)
    files = list_frames(frames_dir)
    if not files:
        raise FileNotFoundError(f"No frame_*.jpg files found under {frames_dir}")
    picks = sample_frame_paths(files, num_frames)

    imgs_arr = None
    if use_native:
        from video_caption_tpu.native.loader import load_frames_native

        imgs_arr = load_frames_native(picks, image_size)
    if imgs_arr is None:
        imgs_arr = np.stack([load_image(p, image_size) for p in picks])
    if pad_to_num_frames and len(picks) < num_frames:
        pad = np.repeat(imgs_arr[-1:], num_frames - len(picks), axis=0)
        imgs_arr = np.concatenate([imgs_arr, pad], axis=0)
    video = imgs_arr[None]
    log.info("frames_dir=%s total=%d sampled=%d", frames_dir, len(files), len(picks))
    return video


def load_video_array_u8(
    frames_dir: Union[str, Path],
    num_frames: int = 8,
    image_size: int = 224,
    use_native: bool = _USE_NATIVE,
) -> np.ndarray:
    """frames_dir -> [1,T,3,H,W] uint8 (normalize on-device).

    The serving fast path: 1 byte/pixel over the host->device link (4x less
    wire traffic than the fp32 path); the device program applies the same
    ImageNet normalization in fp32 before the encoder.
    """
    frames_dir = Path(frames_dir)
    files = list_frames(frames_dir)
    if not files:
        raise FileNotFoundError(f"No frame_*.jpg files found under {frames_dir}")
    picks = sample_frame_paths(files, num_frames)
    imgs_arr = None
    if use_native:
        from video_caption_tpu.native.loader import load_frames_native_u8

        imgs_arr = load_frames_native_u8(picks, image_size)
    if imgs_arr is None:
        imgs_arr = np.stack([load_image_u8(p, image_size) for p in picks])
    if len(picks) < num_frames:
        pad = np.repeat(imgs_arr[-1:], num_frames - len(picks), axis=0)
        imgs_arr = np.concatenate([imgs_arr, pad], axis=0)
    return imgs_arr[None]


def load_video_packed(
    frames_dir: Union[str, Path],
    num_frames: int = 8,
    image_size: int = 224,
    use_native: bool = _USE_NATIVE,
    allow_yuv420: bool = True,
):
    """frames_dir -> ("yuv420", [T, plane_len] uint8) or ("rgb", [1,T,3,H,W]
    uint8).

    The wire-optimal load: canonical 4:2:0 JPEGs at exactly image_size ship
    as raw decoded planes (1.5 bytes/pixel — half the RGB bytes on the
    host->device link) and the device finishes the decode bit-exactly
    (preprocessing/yuv420.py). Anything else falls back to the RGB uint8
    path for the WHOLE video (one format per video keeps the device
    conversion a single fixed-shape program)."""
    frames_dir = Path(frames_dir)
    files = list_frames(frames_dir)
    if not files:
        raise FileNotFoundError(f"No frame_*.jpg files found under {frames_dir}")
    picks = sample_frame_paths(files, num_frames)
    if use_native and allow_yuv420:
        from video_caption_tpu.native.loader import load_frames_native_yuv420

        packed = load_frames_native_yuv420(picks, image_size)
        if packed is not None:
            if len(picks) < num_frames:
                pad = np.repeat(packed[-1:], num_frames - len(picks), axis=0)
                packed = np.concatenate([packed, pad], axis=0)
            return "yuv420", packed
    return "rgb", load_video_array_u8(
        frames_dir, num_frames, image_size, use_native=use_native
    )
