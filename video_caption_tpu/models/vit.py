"""ViT-B/16 frame encoder.

Capability parity with the reference encoder (src/models/video_encoder.py:288-326):
``[B,T,3,H,W] -> reshape(B*T) -> ViT trunk -> pool (cls|gap) -> temporal mean
-> Linear(768->256)``, output cast back to fp32
(reference casts at video_encoder.py:321-324).

Design decisions (deliberately NOT a torch translation):

- Block parameters are stacked along a leading ``depth`` axis and the trunk
  runs as one ``lax.scan`` over layers: one compiled block program instead of
  12 unrolled ones, and XLA fuses LN/bias/GELU into the surrounding matmuls —
  this subsumes the reference's hand-toggled fusion flags
  (video_encoder.py:112-174: fused_attn / tanh-GELU / in-place residual add).
- Patch embedding runs as a single [B*T*196, 768] matmul (patchify via
  reshape/transpose) or XLA's strided conv — same arithmetic, no im2col.
- Attention uses one fused QKV matmul per block; softmax in fp32.
- Compute dtype is a policy knob (bf16 by default), parameters stay fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import jax
import jax.numpy as jnp

Params = Dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    """Geometry of ``vit_base_patch16_224`` (reference: SURVEY §2.3)."""

    image_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    pool: str = "cls"          # 'cls' | 'gap' (reference: video_encoder.py:234-260)
    out_dim: int = 256
    dtype: Any = jnp.bfloat16  # compute dtype
    gelu_approx: bool = True
    """tanh-approx GELU in the MLP. The reference mutates timm's exact GELU to
    approximate='tanh' at construction (video_encoder.py:124-133,
    enable_mlp_bias_gelu_fusion default True), so its inference path runs
    tanh-GELU — matching it is required for encoder parity. Set False for
    parity with stock timm/HF ViT (exact erf GELU)."""
    gelu_f32: bool = True
    """Compute the MLP GELU in fp32 (cast up around the transcendental).
    False = evaluate GELU in the compute dtype (bf16): ~1e-2 relative
    activation noise, inside the deployment bf16-vs-fp32 alignment budget —
    measure before flipping the default."""
    patch_conv: bool = True
    """Patch embedding via XLA's native strided conv instead of the explicit
    reshape/transpose + matmul. Same arithmetic (the conv IS the reference's
    timm patch embed) without materializing the 6-D patchify transpose.
    Accumulation order differs from the matmul path by bf16 rounding (rel
    5e-3 on encoder outputs, inside the 5e-2 deployment alignment gate)."""
    remat: bool = False
    """Rematerialize each transformer block in the backward pass
    (``jax.checkpoint`` around the scanned block). Training-only lever:
    the fwd+bwd activation stash of the 12-layer trunk at fp32 is ~4 GB per
    128 frames (3x [12,N,197,768] + the [.,3072] MLP intermediates); remat
    keeps only
    the per-layer carries and recomputes the rest, trading ~33% more trunk
    FLOPs. Inference paths (no grad) are unaffected by the flag."""

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + cls token

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def init_vit_params(key: jax.Array, cfg: ViTConfig) -> Params:
    """Random-init parameter pytree with timm-compatible structure.

    Weight layout convention: every linear weight is stored ``[in, out]`` so
    forward is ``x @ w + b`` (torch nn.Linear weights are transposed by the
    converter, models/convert.py).
    """
    k = iter(jax.random.split(key, 16))
    h, d = cfg.embed_dim, cfg.depth
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_chans
    mlp = cfg.mlp_ratio * h
    trunc = jax.nn.initializers.truncated_normal(stddev=0.02)

    def tn(key, shape):
        return trunc(key, shape, jnp.float32)

    params: Params = {
        "patch_embed": {"w": tn(next(k), (patch_dim, h)), "b": jnp.zeros((h,))},
        "cls_token": tn(next(k), (1, 1, h)),
        "pos_embed": tn(next(k), (1, cfg.seq_len, h)),
        "blocks": {
            "ln1_scale": jnp.ones((d, h)),
            "ln1_bias": jnp.zeros((d, h)),
            "qkv_w": tn(next(k), (d, h, 3 * h)),
            "qkv_b": jnp.zeros((d, 3 * h)),
            "proj_w": tn(next(k), (d, h, h)),
            "proj_b": jnp.zeros((d, h)),
            "ln2_scale": jnp.ones((d, h)),
            "ln2_bias": jnp.zeros((d, h)),
            "fc1_w": tn(next(k), (d, h, mlp)),
            "fc1_b": jnp.zeros((d, mlp)),
            "fc2_w": tn(next(k), (d, mlp, h)),
            "fc2_b": jnp.zeros((d, h)),
        },
        "norm_scale": jnp.ones((h,)),
        "norm_bias": jnp.zeros((h,)),
        "head": {"w": tn(next(k), (h, cfg.out_dim)), "b": jnp.zeros((cfg.out_dim,))},
    }
    return params


def _layer_norm(x: jax.Array, scale: jax.Array, bias: jax.Array, eps: float = 1e-6) -> jax.Array:
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(x.dtype)


def _patchify(images: jax.Array, patch: int) -> jax.Array:
    """[N,3,H,W] -> [N, num_patches, patch*patch*3], matching conv-patch-embed
    arithmetic: output channel c of the conv equals dot(patch_pixels, w[:, c])
    with pixels ordered (chan, ky, kx) — the torch conv-weight layout the
    converter flattens to."""
    n, c, hh, ww = images.shape
    gh, gw = hh // patch, ww // patch
    x = images.reshape(n, c, gh, patch, gw, patch)
    x = x.transpose(0, 2, 4, 1, 3, 5)  # [N, gh, gw, c, ph, pw]
    return x.reshape(n, gh * gw, c * patch * patch)


def _attention_core(qkv: jax.Array, cfg: ViTConfig) -> jax.Array:
    """Fused-QKV activation [N,S,3H] -> merged-head attention output [N,S,H]
    (pre out-projection)."""
    n, s, _ = qkv.shape
    r = qkv.reshape(n, s, 3, cfg.num_heads, cfg.head_dim)
    q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]  # [N,S,nh,hd]
    q = q.transpose(0, 2, 1, 3)
    k = k.transpose(0, 2, 1, 3)
    v = v.transpose(0, 2, 1, 3)
    scale = cfg.head_dim ** -0.5
    logits = jnp.einsum("nhqd,nhkd->nhqk", q, k, preferred_element_type=jnp.float32) * scale
    attn = jax.nn.softmax(logits, axis=-1).astype(qkv.dtype)
    out = jnp.einsum("nhqk,nhkd->nhqd", attn, v)
    return out.transpose(0, 2, 1, 3).reshape(n, s, cfg.embed_dim)


def _attention(x: jax.Array, blk: Params, cfg: ViTConfig) -> jax.Array:
    qkv = x @ blk["qkv_w"].astype(x.dtype) + blk["qkv_b"].astype(x.dtype)  # [N,S,3H]
    out = _attention_core(qkv, cfg)
    return out @ blk["proj_w"].astype(x.dtype) + blk["proj_b"].astype(x.dtype)


def _block(x: jax.Array, blk: Params, cfg: ViTConfig) -> jax.Array:
    x = x + _attention(_layer_norm(x, blk["ln1_scale"], blk["ln1_bias"]), blk, cfg)
    y = _layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
    y = y @ blk["fc1_w"].astype(x.dtype) + blk["fc1_b"].astype(x.dtype)
    if cfg.gelu_f32:
        y = jax.nn.gelu(y.astype(jnp.float32), approximate=cfg.gelu_approx).astype(x.dtype)
    else:
        y = jax.nn.gelu(y, approximate=cfg.gelu_approx)
    y = y @ blk["fc2_w"].astype(x.dtype) + blk["fc2_b"].astype(x.dtype)
    return x + y



def vit_trunk(params: Params, images: jax.Array, cfg: ViTConfig,
              *, cls_only: bool = False) -> jax.Array:
    """[N,3,H,W] -> [N, seq_len, embed_dim] token features (post final norm).

    cls_only=True returns only the CLS token, [N, 1, embed_dim], sliced
    BEFORE the final LayerNorm. LayerNorm is per-token, so this is bitwise
    identical to `vit_trunk(...)[:, :1]` — but it drops three full-stream
    HBM passes over [N,S,H] (mean/var reduces + normalize apply) down to
    1/S of the data (the reference computes the full norm because timm's
    forward_features does: video_encoder.py:288-314)."""
    dt = cfg.dtype
    pe_w = params["patch_embed"]["w"].astype(dt)
    pe_b = params["patch_embed"]["b"].astype(dt)
    if cfg.patch_conv:
        p = cfg.patch_size
        # stored weight is [patch_dim(c,ky,kx), H] — the conv kernel view
        wk = pe_w.reshape(cfg.in_chans, p, p, -1)
        x = jax.lax.conv_general_dilated(
            images.astype(dt), wk, (p, p), "VALID",
            dimension_numbers=("NCHW", "IHWO", "NHWC"))
        x = x.reshape(images.shape[0], cfg.num_patches, -1) + pe_b
    else:
        x = _patchify(images.astype(dt), cfg.patch_size)
        x = x @ pe_w + pe_b
    n = x.shape[0]
    cls = jnp.broadcast_to(params["cls_token"].astype(dt), (n, 1, cfg.embed_dim))
    x = jnp.concatenate([cls, x], axis=1)
    x = x + params["pos_embed"].astype(dt)

    def body(carry, blk):
        return _block(carry, blk, cfg), None

    if cfg.remat:
        body = jax.checkpoint(body)
    x, _ = jax.lax.scan(body, x, params["blocks"])
    if cls_only:
        x = x[:, :1, :]
    return _layer_norm(x, params["norm_scale"], params["norm_bias"])


def pool_temporal(tokens: jax.Array, batch: int, frames: int, cfg: ViTConfig) -> jax.Array:
    """Fused spatial pool + temporal mean: [B*T, S, H] -> [B, H]
    (reference CUDA kernels: cupy_vit_pool.py:23-104). XLA fuses the slice
    or patch mean into the temporal mean; accumulation is fp32."""
    if tokens.shape[1] == 1:
        # cls_only trunk output: the spatial pool is already done; the
        # remaining [B,T,H] temporal mean is all that is left.
        if cfg.pool != "cls":
            raise ValueError(
                f"single-token trunk output is only valid for pool='cls' "
                f"(got pool={cfg.pool!r}): gap pooling excludes token 0")
        per_frame = tokens[:, 0, :].astype(jnp.float32)
        return jnp.mean(per_frame.reshape(batch, frames, -1), axis=1).astype(tokens.dtype)
    tf = tokens.astype(jnp.float32)
    if cfg.pool == "cls":
        per_frame = tf[:, 0, :]
    else:  # gap over patch tokens, skipping cls (cupy_vit_pool.py:42-61)
        per_frame = jnp.mean(tf[:, 1:, :], axis=1)
    return jnp.mean(per_frame.reshape(batch, frames, -1), axis=1).astype(tokens.dtype)


IMAGENET_MEAN = jnp.asarray([0.485, 0.456, 0.406])
IMAGENET_STD = jnp.asarray([0.229, 0.224, 0.225])


def normalize_pixels(video: jax.Array) -> jax.Array:
    """uint8 [..,3,H,W] pixels -> ImageNet-normalized fp32 — the on-device
    half of the preprocessing path: the host ships 1 byte/pixel and XLA fuses
    this normalization into the patch-embed matmul."""
    x = video.astype(jnp.float32) / 255.0
    shape = (1,) * (video.ndim - 3) + (3, 1, 1)
    return (x - IMAGENET_MEAN.reshape(shape)) / IMAGENET_STD.reshape(shape)


def vit_encode_frames(params: Params, frames: jax.Array, cfg: ViTConfig) -> jax.Array:
    """Per-frame half of ``vit_encode``: [C,3,H,W] (uint8 or fp32) ->
    per-frame pooled features [C, embed_dim] (compute dtype).

    Exists so the engine's single-request path can ENCODE each uploaded
    chunk of frames while the next chunk is still being transferred (the
    batch path already overlaps uploads).
    ``vit_encode(video) == vit_finish(vit_encode_frames(frames))`` for
    pool='cls': per-frame trunk math has no cross-frame reductions, so
    chunking the frame batch does not change any per-frame value."""
    if frames.dtype == jnp.uint8:
        frames = normalize_pixels(frames)
    if cfg.pool == "cls":
        tokens = vit_trunk(params, frames, cfg, cls_only=True)   # [C,1,H]
        return tokens[:, 0, :]
    tokens = vit_trunk(params, frames, cfg)
    return jnp.mean(tokens[:, 1:, :], axis=1)                    # gap


def vit_finish(params: Params, per_frame: jax.Array, cfg: ViTConfig) -> jax.Array:
    """Temporal half of ``vit_encode``: per-frame features [B,T,embed_dim]
    -> [B, out_dim] fp32. fp32-accumulated temporal mean matching
    pool_temporal."""
    pooled = jnp.mean(per_frame.astype(jnp.float32), axis=1).astype(per_frame.dtype)
    out = pooled @ params["head"]["w"].astype(pooled.dtype) + params["head"]["b"].astype(pooled.dtype)
    return out.astype(jnp.float32)


def vit_encode(params: Params, video: jax.Array, cfg: ViTConfig) -> jax.Array:
    """[B,T,3,H,W] -> [B, out_dim] fp32 (reference: video_encoder.py:288-326).
    Accepts fp32 normalized frames or raw uint8 (normalized on device)."""
    if video.dtype == jnp.uint8:
        video = normalize_pixels(video)
    b, t = video.shape[0], video.shape[1]
    frames = video.reshape(b * t, *video.shape[2:])
    tokens = vit_trunk(params, frames, cfg, cls_only=cfg.pool == "cls")
    pooled = pool_temporal(tokens, b, t, cfg)
    out = pooled @ params["head"]["w"].astype(pooled.dtype) + params["head"]["b"].astype(pooled.dtype)
    return out.astype(jnp.float32)
