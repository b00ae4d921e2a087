"""Request DTO -> config mapping + engine dispatch
(reference: server/services/inference_service.py:11-60)."""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict

from video_caption_tpu.config import InferenceConfig, serving_inference_config
from video_caption_tpu.server.schemas import InferRequest
from video_caption_tpu.server.services.model_registry import MODEL_REGISTRY
from video_caption_tpu.server.services.task_manager import DEVICE_TASK_MANAGER

log = logging.getLogger(__name__)

_IGNORED_FIELDS = (
    "device", "vit_enable_fp16", "vit_enable_attention_fastpath",
    "vit_prefer_channels_last", "vit_enable_torch_compile",
    "vit_torch_compile_mode", "vit_enable_mlp_bias_gelu_fusion",
    "vit_enable_residual_layernorm_fusion", "vit_enable_cupy_fused_pool",
    "vit_cupy_pool_force_fp16", "use_cupy_prefix_projector",
    "cupy_prefix_force_fp16", "use_pallas_fused_pool",
    "use_pallas_prefix_projector",
)


def request_to_config(req: InferRequest) -> InferenceConfig:
    ignored = [f for f in _IGNORED_FIELDS if getattr(req, f) is not None]
    if ignored:
        log.info("ignoring legacy request fields (XLA handles these): %s", ignored)
    base = serving_inference_config()
    compile_cfg = dataclasses.replace(base.compile, dtype=req.compute_dtype)
    return dataclasses.replace(
        base,
        ckpt=req.ckpt, stage=req.stage, vit_name=req.vit_name, gpt2_name=req.gpt2_name,
        prefix_len=req.prefix_len, num_frames=req.num_frames, image_size=req.image_size,
        ln_scale=req.ln_scale, in_weight=req.in_weight,
        preset1=req.preset1, preset2=req.preset2, preset3=req.preset3,
        prompt1=req.prompt1, prompt2=req.prompt2, prompt3=req.prompt3,
        backend=req.backend, compile=compile_cfg,
    )


import os

_BATCH_SERVING = os.environ.get("VIDEO_CAPTION_BATCH_SERVING", "1").strip().lower() not in (
    "0", "false", "no", "off",
)


class InferenceService:
    def infer(self, req: InferRequest) -> Dict:
        frames_dir = Path(req.frames_dir)
        if not frames_dir.is_dir():
            raise FileNotFoundError(f"frames_dir not found: {frames_dir}")
        config = request_to_config(req)
        engine = MODEL_REGISTRY.get_engine(config)
        if _BATCH_SERVING:
            # coalesce concurrent requests into one batched device program;
            # the queue serializes device access, replacing the semaphore.
            # max_batch trades throughput for tail latency (requests ride the
            # whole batch's service time).
            from video_caption_tpu.server.services.batching_queue import get_queue

            queue = get_queue(
                engine,
                max_batch=int(os.environ.get("VIDEO_CAPTION_SERVE_MAX_BATCH", "8")),
                max_wait_ms=float(os.environ.get("VIDEO_CAPTION_SERVE_MAX_WAIT_MS", "5")),
            )
            result = queue.infer(str(frames_dir))
        else:
            with DEVICE_TASK_MANAGER.acquire():
                result = engine.infer(str(frames_dir))
        return result.to_api_dict()


INFERENCE_SERVICE = InferenceService()
