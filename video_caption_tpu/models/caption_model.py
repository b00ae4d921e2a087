"""Composite caption model: ViT encoder + projection + prefix mapper + GPT-2.

Capability parity with ``VideoCaptionModel`` (src/models/caption_model.py:11-168)
and the prefix mapper inside ``GPT2TextDecoder`` (src/models/text_decoder.py:36-58):

- ``proj``: identity when encoder out_dim == video_dim, else a Linear adapter
  (reference: caption_model.py:60-67),
- ``mapper``: Linear(video_dim -> n_embd * prefix_len), viewed as [B,P,H]
  (reference: text_decoder.py:36-45,69); dropout is a no-op at inference,
- engine-side prefix norm (ln_scale/in_weight) lives in ops/prefix_norm.py,
- teacher-forcing loss with prefix positions masked to -100
  (reference: text_decoder.py:94-99).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from video_caption_tpu.models import gpt2 as g2
from video_caption_tpu.models import vit as vt
from video_caption_tpu.ops.prefix_norm import apply_prefix_norm

Params = Dict[str, Any]


@dataclass(frozen=True)
class CaptionModelConfig:
    vit: vt.ViTConfig = field(default_factory=vt.ViTConfig)
    gpt2: g2.GPT2Config = field(default_factory=g2.GPT2Config)
    prefix_len: int = 4
    video_dim: int = 256
    cond_mode: str = "prefix"     # 'prefix' | 'bos' (text_decoder.py:19)
    proj_hidden: int = 0
    """MLP adapter width (reference caption_model.py proj_hidden>0:
    Linear(video_dim, h) -> ReLU -> Linear(h, video_dim) after the encoder;
    0 = identity, the production default)."""
    ln_scale: float = 0.6
    in_weight: float = 0.4
    freeze_encoder: bool = False
    """Training-time: stop_gradient after the encoder. With the ViT frozen
    (the product trainer's setting, train_caption_mapper.py:199-207) the
    encoder backward pass is dead code — masking its grads to zero still
    pays for computing them; stop_gradient lets XLA eliminate the whole
    backward ViT."""

    @property
    def mapper_out(self) -> int:
        if self.cond_mode == "prefix":
            return self.gpt2.n_embd * self.prefix_len
        return self.gpt2.n_embd


def init_caption_model(key: jax.Array, cfg: CaptionModelConfig) -> Params:
    k_enc, k_proj, k_map, k_dec = jax.random.split(key, 4)
    init = jax.nn.initializers.normal(stddev=0.02)
    params: Params = {
        "encoder": vt.init_vit_params(k_enc, cfg.vit),
        "mapper": {
            "w": init(k_map, (cfg.video_dim, cfg.mapper_out), jnp.float32),
            "b": jnp.zeros((cfg.mapper_out,)),
        },
        "decoder": g2.init_gpt2_params(k_dec, cfg.gpt2),
    }
    if cfg.vit.out_dim != cfg.video_dim:  # adapter path (caption_model.py:60-67)
        params["proj"] = {
            "w": init(k_proj, (cfg.vit.out_dim, cfg.video_dim), jnp.float32),
            "b": jnp.zeros((cfg.video_dim,)),
        }
    if cfg.proj_hidden > 0:  # MLP adapter (reference caption_model.py proj_hidden>0)
        k_m1, k_m2 = jax.random.split(k_proj)
        params["proj_mlp"] = {
            "fc1": {
                "w": init(k_m1, (cfg.video_dim, cfg.proj_hidden), jnp.float32),
                "b": jnp.zeros((cfg.proj_hidden,)),
            },
            "fc2": {
                "w": init(k_m2, (cfg.proj_hidden, cfg.video_dim), jnp.float32),
                "b": jnp.zeros((cfg.video_dim,)),
            },
        }
    return params


def encode_video(params: Params, video: jax.Array, cfg: CaptionModelConfig) -> jax.Array:
    """[B,T,3,H,W] (fp32 or uint8) OR [B,T,plane_len] packed 4:2:0 planes ->
    projected video embedding [B, video_dim] fp32. The packed form is the
    YUV420 training/serving wire (1.5 B/px): the device finishes the JPEG
    decode bit-exactly (preprocessing/yuv420.py) before normalization."""
    if video.ndim == 3:
        from video_caption_tpu.preprocessing.yuv420 import yuv420_packed_to_rgb_chw

        b, t = video.shape[0], video.shape[1]
        size = cfg.vit.image_size
        rgb = yuv420_packed_to_rgb_chw(video.reshape(b * t, -1), size)
        video = rgb.reshape(b, t, 3, size, size)
    emb = vt.vit_encode(params["encoder"], video, cfg.vit)
    if "proj" in params:
        emb = emb @ params["proj"]["w"] + params["proj"]["b"]
    if "proj_mlp" in params:  # fc1 -> ReLU -> fc2 (reference caption_model.py:61-66)
        m = params["proj_mlp"]
        h = jax.nn.relu(emb @ m["fc1"]["w"] + m["fc1"]["b"])
        emb = h @ m["fc2"]["w"] + m["fc2"]["b"]
    return emb


def map_prefix(params: Params, emb: jax.Array, cfg: CaptionModelConfig) -> jax.Array:
    """Normalized video embedding -> prefix token embeddings [B,P,H].

    The mapper matmul is the op the reference offloads to a CUDA kernel
    (CuPyLinearCompat, cupy_linear_mapper.py:137); here it is one GEMM with
    the bias fused into its epilogue by XLA.
    """
    if emb.ndim == 3:
        emb = emb[:, 0, :]
    out = emb @ params["mapper"]["w"] + params["mapper"]["b"]
    if cfg.cond_mode == "bos":
        return jnp.tanh(out)[:, None, :]
    return out.reshape(emb.shape[0], cfg.prefix_len, cfg.gpt2.n_embd)


def video_to_prefix(params: Params, video: jax.Array, cfg: CaptionModelConfig) -> jax.Array:
    """Full visual branch: encode -> proj -> prefix norm -> mapper -> [B,P,H]
    (the engine path, core/engine.py:40-50 + text_decoder.py:69)."""
    emb = encode_video(params, video, cfg)
    emb = apply_prefix_norm(emb, cfg.ln_scale, cfg.in_weight)
    return map_prefix(params, emb, cfg)


def encode_frames(params: Params, frames: jax.Array, cfg: CaptionModelConfig) -> jax.Array:
    """Per-frame half of the visual branch: [C,3,H,W] uint8/fp32 ->
    per-frame ViT features [C, embed_dim]. Pairs with
    ``frames_to_prefix`` — the engine's single-request path encodes each
    uploaded CHUNK of frames while the next chunk is still in transfer
    (vit.vit_encode_frames docstring)."""
    return vt.vit_encode_frames(params["encoder"], frames, cfg.vit)


def frames_to_prefix(params: Params, per_frame: jax.Array, cfg: CaptionModelConfig) -> jax.Array:
    """Finish the visual branch from per-frame ViT features [B,T,embed_dim]:
    temporal pool + head -> proj -> prefix norm -> mapper -> [B,P,H].
    ``frames_to_prefix(encode_frames(chunks)) == video_to_prefix(video)``
    for pool='cls' (per-frame trunk math has no cross-frame reductions)."""
    emb = vt.vit_finish(params["encoder"], per_frame, cfg.vit)
    if "proj" in params:
        emb = emb @ params["proj"]["w"] + params["proj"]["b"]
    if "proj_mlp" in params:
        m = params["proj_mlp"]
        h = jax.nn.relu(emb @ m["fc1"]["w"] + m["fc1"]["b"])
        emb = h @ m["fc2"]["w"] + m["fc2"]["b"]
    emb = apply_prefix_norm(emb, cfg.ln_scale, cfg.in_weight)
    return map_prefix(params, emb, cfg)


def build_decoder_inputs(
    params: Params,
    prefix: jax.Array,        # [B,P,H]
    input_ids: jax.Array,     # [B,L]
    cfg: CaptionModelConfig,
) -> jax.Array:
    """concat(prefix_embeds, wte(input_ids)) (reference: text_decoder.py:60-74)."""
    tok = params["decoder"]["wte"][input_ids]
    return jnp.concatenate([prefix.astype(tok.dtype), tok], axis=1)


def compute_loss(
    params: Params,
    video: jax.Array,          # [B,T,3,H,W]
    input_ids: jax.Array,      # [B,L]
    attn_mask: jax.Array,      # [B,L] — 1 for real caption tokens
    cfg: CaptionModelConfig,
    labels: Optional[jax.Array] = None,
) -> jax.Array:
    """Teacher-forcing loss: prefix gets attention=1 / label=-100
    (reference: caption_model.py:104-168, text_decoder.py:94-99)."""
    b = video.shape[0]
    if cfg.freeze_encoder:
        emb = jax.lax.stop_gradient(encode_video(params, video, cfg))
        emb = apply_prefix_norm(emb, cfg.ln_scale, cfg.in_weight)
        prefix = map_prefix(params, emb, cfg)
    else:
        prefix = video_to_prefix(params, video, cfg)
    p = prefix.shape[1]
    embeds = build_decoder_inputs(params, prefix, input_ids, cfg)
    full_mask = jnp.concatenate(
        [jnp.ones((b, p), jnp.int32), attn_mask.astype(jnp.int32)], axis=1
    )
    positions = jnp.cumsum(full_mask, axis=1) - 1
    positions = jnp.maximum(positions, 0).astype(jnp.int32)
    logits = g2.gpt2_logits_nocache(params["decoder"], embeds, positions, full_mask, cfg.gpt2)
    if labels is None:
        labels = jnp.where(attn_mask > 0, input_ids, -100)
    full_labels = jnp.concatenate([jnp.full((b, p), -100, input_ids.dtype), labels], axis=1)
    return g2.lm_loss(logits, full_labels)
