"""On-device JPEG colorspace backend: 4:2:0 YCbCr planes -> RGB, bit-exact
with libjpeg (and therefore with the PIL decode path).

Why this exists: host->device bytes are a cost on the cold serving path
(32-video batches ship 77 MB of RGB pixels). JPEGs in the canonical dataset are 4:2:0 subsampled
(PIL q95 writes 2x2,1x1,1x1 — same for the reference's prepared frames), so
shipping the *raw decoded planes* (Y full-res + Cb/Cr quarter-res = 1.5
bytes/pixel) instead of upsampled RGB (3 bytes/pixel) halves the bytes on
the transfer. The native loader stops JPEG decoding at the raw-plane
stage (frame_loader.cpp vct_load_frames_yuv420) and this module finishes the
decode ON THE DEVICE:

- **h2v2 fancy upsample** (libjpeg jdsample.c h2v2_fancy_upsample): the
  triangle-filter 2x upsample libjpeg applies to chroma by default
  (do_fancy_upsampling=TRUE, which is what PIL uses). Integer arithmetic,
  replicated exactly: colsum = 3*near_row + far_row, then horizontally
  (3*this + prev + 8) >> 4 / (3*this + next + 7) >> 4 with edge clamping.
- **ycc_rgb color conversion** (libjpeg jdcolor.c build_ycc_rgb_table):
  fixed-point SCALEBITS=16 arithmetic with ONE_HALF rounding bias,
  replicated exactly (including the arithmetic right shift of the negative
  green term).

Both are elementwise/gather int32 ops — negligible device time against the
2x wire saving. Bit-exactness is asserted against PIL in
tests/test_yuv420.py; because the produced RGB bytes are identical, every
downstream consumer (normalize, ViT, captions, parity suites) is unchanged.

Reference counterpart: the CUDA-side preprocessing the reference reserved to
TensorRT plugins (core/trt/plugins/README.md) — here the device really does
own the tail of the image decode.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# libjpeg jdcolor.c fixed-point constants (SCALEBITS = 16):
# FIX(x) = int(x * 65536 + 0.5)
_FIX_1_40200 = 91881    # Cr -> R
_FIX_1_77200 = 116130   # Cb -> B
_FIX_0_34414 = 22554    # Cb -> G (negative)
_FIX_0_71414 = 46802    # Cr -> G (negative)
_ONE_HALF = 1 << 15


def packed_plane_len(size: int) -> int:
    """Bytes per frame of the packed raw-plane layout (Y | Cb | Cr)."""
    cs = (size + 1) // 2
    return size * size + 2 * cs * cs


def _fancy_upsample_h2v2(c: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """libjpeg h2v2_fancy_upsample, vectorized.

    ``c`` is [..., h2, w2] int32 chroma; returns [..., out_h, out_w] int32
    (out_h = 2*h2 or 2*h2-1 for odd sizes; same for width).
    """
    h2, w2 = c.shape[-2], c.shape[-1]
    # vertical: output row v reads near = v//2 and far = near -/+ 1 (clamped);
    # even rows look up, odd rows look down (jdsample.c: each input row pair
    # produces one row weighted 3:1 against the previous and one against the
    # next input row)
    v = jnp.arange(out_h)
    near = v // 2
    far = jnp.clip(near + jnp.where(v % 2 == 1, 1, -1), 0, h2 - 1)
    colsum = 3 * jnp.take(c, near, axis=-2) + jnp.take(c, far, axis=-2)

    # horizontal: out[2j]   = (3*s[j] + s[j-1] + 8) >> 4   (left edge: s[-1]=s[0],
    #             out[2j+1] = (3*s[j] + s[j+1] + 7) >> 4    giving (4*s+8)>>4 /
    # right edge s[w2]=s[w2-1] giving (4*s+7)>>4 — libjpeg's special cases)
    j = jnp.arange(w2)
    left = jnp.take(colsum, jnp.maximum(j - 1, 0), axis=-1)
    right = jnp.take(colsum, jnp.minimum(j + 1, w2 - 1), axis=-1)
    even = (3 * colsum + left + 8) >> 4
    odd = (3 * colsum + right + 7) >> 4
    out = jnp.stack([even, odd], axis=-1).reshape(*c.shape[:-2], out_h, 2 * w2)
    return out[..., :out_w]


def yuv420_packed_to_rgb_chw(packed: jax.Array, size: int) -> jax.Array:
    """[T, packed_plane_len] uint8 raw planes -> [T, 3, size, size] uint8 RGB,
    bit-equal to libjpeg's full decode (fancy upsample + ycc_rgb convert)."""
    t = packed.shape[0]
    cs = (size + 1) // 2
    ysz = size * size
    y = packed[:, :ysz].reshape(t, size, size).astype(jnp.int32)
    cb = packed[:, ysz : ysz + cs * cs].reshape(t, cs, cs).astype(jnp.int32)
    cr = packed[:, ysz + cs * cs :].reshape(t, cs, cs).astype(jnp.int32)

    cb = _fancy_upsample_h2v2(cb, size, size) - 128
    cr = _fancy_upsample_h2v2(cr, size, size) - 128

    # jdcolor.c ycc_rgb_convert via build_ycc_rgb_table (RIGHT_SHIFT is
    # arithmetic; jnp >> on int32 is too)
    r = y + ((_FIX_1_40200 * cr + _ONE_HALF) >> 16)
    b = y + ((_FIX_1_77200 * cb + _ONE_HALF) >> 16)
    g = y + ((-_FIX_0_34414 * cb - _FIX_0_71414 * cr + _ONE_HALF) >> 16)
    rgb = jnp.stack([r, g, b], axis=1)  # [T, 3, S, S]
    return jnp.clip(rgb, 0, 255).astype(jnp.uint8)


def yuv420_packed_to_rgb_chw_np(packed: np.ndarray, size: int) -> np.ndarray:
    """Numpy-in/numpy-out mirror of the device conversion (tests / host
    fallback); runs on the CPU backend when one is registered."""
    arr = packed
    try:
        arr = jax.device_put(arr, jax.local_devices(backend="cpu")[0])
    except Exception:
        pass  # single-platform runtime: run on the default backend
    return np.asarray(yuv420_packed_to_rgb_chw(jnp.asarray(arr), size))
