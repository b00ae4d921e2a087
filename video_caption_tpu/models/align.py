"""Dual-encoder video<->text alignment model for retrieval.

Capability parity with ``ViTTextAlignModel`` (src/models/vit_text_align.py:54-86):
video branch = frame-wise ViT -> temporal mean -> Linear proj -> L2-normalize;
text branch = Embedding -> 2-layer bidirectional Transformer encoder
(8 heads) -> masked mean -> proj -> L2-normalize; cosine-embedding loss.

Used by retrieval feature extraction / FAISS indexing / Recall@K eval
(scripts/extract_features.py, build_index.py, eval_retrieval.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import jax
import jax.numpy as jnp

from video_caption_tpu.models import vit as vt

Params = Dict[str, Any]


@dataclass(frozen=True)
class AlignConfig:
    vit: vt.ViTConfig = field(default_factory=vt.ViTConfig)
    vocab_size: int = 50257
    max_text_len: int = 64
    text_dim: int = 256
    text_layers: int = 2
    text_heads: int = 8
    embed_dim: int = 256          # shared retrieval space
    temporal_mode: str = "mean"
    """Video-branch temporal pooling:
    - "mean": plain temporal mean (reference ViTTextAlignModel parity,
      vit_text_align.py:54-70) — motion/direction information is washed out
      by construction (mean(f(t)) is order-invariant), measured as the
      retrieval quality-loop plateau.
    - "diff": concat[temporal mean, last-frame minus first-frame features]
      before the projection — the difference term is ANTI-symmetric under
      time reversal, so direction-of-motion becomes linearly separable.
      Changes video_proj's input width to 2*vit.out_dim (not reference
      ckpt-compatible; the quality-loop/retrieval leg opts in)."""


def init_align_params(key: jax.Array, cfg: AlignConfig) -> Params:
    keys = iter(jax.random.split(key, 12))
    init = jax.nn.initializers.normal(stddev=0.02)
    d, td = cfg.text_layers, cfg.text_dim

    def nrm(shape):
        return init(next(keys), shape, jnp.float32)

    vproj_in = cfg.vit.out_dim * (2 if cfg.temporal_mode == "diff" else 1)
    return {
        "vit": vt.init_vit_params(next(keys), cfg.vit),
        "video_proj": {"w": nrm((vproj_in, cfg.embed_dim)), "b": jnp.zeros((cfg.embed_dim,))},
        "tok_embed": nrm((cfg.vocab_size, td)),
        "pos_embed": nrm((cfg.max_text_len, td)),
        "text_blocks": {
            "ln1_scale": jnp.ones((d, td)), "ln1_bias": jnp.zeros((d, td)),
            "qkv_w": nrm((d, td, 3 * td)), "qkv_b": jnp.zeros((d, 3 * td)),
            "proj_w": nrm((d, td, td)), "proj_b": jnp.zeros((d, td)),
            "ln2_scale": jnp.ones((d, td)), "ln2_bias": jnp.zeros((d, td)),
            "fc1_w": nrm((d, td, 4 * td)), "fc1_b": jnp.zeros((d, 4 * td)),
            "fc2_w": nrm((d, 4 * td, td)), "fc2_b": jnp.zeros((d, td)),
        },
        "text_proj": {"w": nrm((td, cfg.embed_dim)), "b": jnp.zeros((cfg.embed_dim,))},
    }


def _l2(x: jax.Array) -> jax.Array:
    return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def encode_video(params: Params, video: jax.Array, cfg: AlignConfig) -> jax.Array:
    """[B,T,3,H,W] -> L2-normalized [B, embed_dim]."""
    if cfg.temporal_mode == "diff":
        b, t = video.shape[0], video.shape[1]
        frames = video.reshape(b * t, *video.shape[2:])
        pf = vt.vit_encode_frames(params["vit"], frames, cfg.vit)   # [B*T, E]
        enc = params["vit"]
        pf = pf @ enc["head"]["w"].astype(pf.dtype) + enc["head"]["b"].astype(pf.dtype)
        pf = pf.reshape(b, t, -1).astype(jnp.float32)
        feat = jnp.concatenate([jnp.mean(pf, axis=1), pf[:, -1] - pf[:, 0]], axis=-1)
    else:
        feat = vt.vit_encode(params["vit"], video, cfg.vit)
    out = feat @ params["video_proj"]["w"] + params["video_proj"]["b"]
    return _l2(out)


def _ln(x, scale, bias, eps=1e-5):
    m = jnp.mean(x, -1, keepdims=True)
    v = jnp.var(x, -1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + eps) * scale + bias


def encode_text(
    params: Params, ids: jax.Array, mask: jax.Array, cfg: AlignConfig
) -> jax.Array:
    """[B,L] tokens + [B,L] mask -> L2-normalized [B, embed_dim].
    Bidirectional attention with key-padding mask (TransformerEncoder parity)."""
    b, l = ids.shape
    heads = cfg.text_heads
    hd = cfg.text_dim // heads
    x = params["tok_embed"][ids] + params["pos_embed"][None, :l]

    def body(carry, blk):
        xv = carry
        h = _ln(xv, blk["ln1_scale"], blk["ln1_bias"])
        qkv = h @ blk["qkv_w"] + blk["qkv_b"]
        qkv = qkv.reshape(b, l, 3, heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32)
        logits = logits * (hd ** -0.5)
        logits = jnp.where(mask[:, None, None, :] > 0, logits, -1e30)
        attn = jax.nn.softmax(logits, axis=-1)
        o = jnp.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, l, -1)
        xv = xv + o @ blk["proj_w"] + blk["proj_b"]
        h = _ln(xv, blk["ln2_scale"], blk["ln2_bias"])
        h = jax.nn.gelu(h @ blk["fc1_w"] + blk["fc1_b"], approximate=True)
        xv = xv + h @ blk["fc2_w"] + blk["fc2_b"]
        return xv, None

    x, _ = jax.lax.scan(body, x, params["text_blocks"])
    denom = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
    pooled = jnp.sum(x * mask[..., None], axis=1) / denom
    out = pooled @ params["text_proj"]["w"] + params["text_proj"]["b"]
    return _l2(out)


def cosine_embedding_loss(
    v_emb: jax.Array, t_emb: jax.Array, target: jax.Array, margin: float = 0.0
) -> jax.Array:
    """torch CosineEmbeddingLoss semantics (vit_text_align.py:81-86):
    target=+1 -> 1 - cos; target=-1 -> max(0, cos - margin)."""
    cos = jnp.sum(v_emb * t_emb, axis=-1)
    pos = 1.0 - cos
    neg = jnp.maximum(0.0, cos - margin)
    return jnp.mean(jnp.where(target > 0, pos, neg))
