"""Request/response schemas, field-compatible with the reference
(server/schemas.py:12-52) so existing clients keep working.

Legacy fields (``device``, ``vit_enable_*``, ``*cupy*``, ``use_pallas_*``)
are accepted and ignored-with-log: those fusion and kernel toggles are
XLA's job. The compute dtype policy is exposed as a new optional field.
"""
from __future__ import annotations

from typing import Dict, Optional

from pydantic import BaseModel, Field, create_model

from video_caption_tpu.config import serving_inference_config

# request defaults mirror the reference SERVING defaults (backend_config.py:
# 61-64 via server/settings.py) — preset2="detailed", heavier than the core
# default
_DEFAULT = serving_inference_config()

# Legacy compatibility fields (server/schemas.py:12-41 in the reference,
# plus the retired kernel switches): accepted so old clients keep working,
# ignored-with-log by the service layer (inference_service._IGNORED_FIELDS
# enumerates the same names).
_CUDA_ERA_FIELDS = dict.fromkeys(
    (
        "vit_enable_fp16", "vit_enable_attention_fastpath", "vit_prefer_channels_last",
        "vit_enable_torch_compile", "vit_enable_mlp_bias_gelu_fusion",
        "vit_enable_residual_layernorm_fusion", "vit_enable_cupy_fused_pool",
        "vit_cupy_pool_force_fp16", "use_cupy_prefix_projector", "cupy_prefix_force_fp16",
        "use_pallas_fused_pool", "use_pallas_prefix_projector",
    ),
    (Optional[bool], None),
)
_CUDA_ERA_FIELDS["vit_torch_compile_mode"] = (Optional[str], None)
_CUDA_ERA_FIELDS["device"] = (
    Optional[str], Field(default=None, description="Ignored: one engine per process"),
)

_CudaCompatBase = create_model("_CudaCompatBase", **_CUDA_ERA_FIELDS)


class InferRequest(_CudaCompatBase):
    frames_dir: str = Field(..., description="Directory containing frame_*.jpg")
    ckpt: str = Field(default=_DEFAULT.ckpt, description="Checkpoint path (torch .pt or orbax dir)")
    stage: str = Field(default=_DEFAULT.stage, description="Reserved for compatibility")
    vit_name: str = Field(default=_DEFAULT.vit_name)
    gpt2_name: str = Field(default=_DEFAULT.gpt2_name)
    prefix_len: int = Field(default=_DEFAULT.prefix_len)
    num_frames: int = Field(default=_DEFAULT.num_frames)
    image_size: int = Field(default=_DEFAULT.image_size)
    ln_scale: float = Field(default=_DEFAULT.ln_scale)
    in_weight: float = Field(default=_DEFAULT.in_weight)
    preset1: str = Field(default=_DEFAULT.preset1)
    preset2: str = Field(default=_DEFAULT.preset2)
    preset3: str = Field(default=_DEFAULT.preset3)
    prompt1: str = Field(default=_DEFAULT.prompt1)
    prompt2: str = Field(default=_DEFAULT.prompt2)
    prompt3: str = Field(default=_DEFAULT.prompt3)
    backend: str = Field(default=_DEFAULT.backend)
    compute_dtype: str = Field(default=_DEFAULT.compile.dtype, description="bfloat16|float32")


class InferResponse(BaseModel):
    S1: str
    S2: str
    S3: str
    BEST: Dict[str, str]


class HealthResponse(BaseModel):
    status: str
