"""Three-layer configuration stack: env vars -> module defaults -> frozen dataclasses.

Mirrors the reference's config design (backend_config.py env parsing ->
server/settings.py defaults -> core/config.py frozen dataclasses) with the
knobs an XLA program needs. The reference's ten ViT fusion switches
(core/config.py:32-45) collapse here into a dtype policy + pool mode: XLA
performs those fusions automatically under jit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field


def _env_bool(name: str, default: bool) -> bool:
    """Parse VIDEO_CAPTION_* boolean env vars (reference: backend_config.py:29-41)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in {"1", "true", "yes", "on"}


def _env_str(name: str, default: str) -> str:
    raw = os.environ.get(name)
    return default if raw is None else raw


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Module-level defaults (layer 2; reference: backend_config.py:11-68)
# ---------------------------------------------------------------------------

CKPT_PATH = _env_str("VIDEO_CAPTION_CKPT", "checkpoints/msvd_mapper_finetune_v2.pt")
VIT_NAME = _env_str("VIDEO_CAPTION_VIT", "vit_base_patch16_224")
GPT2_NAME = _env_str("VIDEO_CAPTION_GPT2", "gpt2")

DEFAULT_PRESETS = ("precise", "precise", "natural")
# The serving stack uses a heavier preset2 than the core default:
# "detailed" = beam=4 x 40 tokens (reference: backend_config.py:61-64 via
# server/settings.py:27-29 — vs core/config.py:61's "precise"). Benchmarks
# must label which workload they measured.
SERVING_PRESETS = ("precise", "detailed", "natural")
DEFAULT_PROMPTS = (
    "",
    "State the main action in one short sentence:",
    "Write a short, natural caption:",
)


@dataclass(frozen=True)
class MemoryConfig:
    """Device-memory policy for one accelerator (reference analog:
    core/config.py:6-13).

    The device's capacity is not configured here: ``MemoryManager.snapshot``
    reads it from the runtime (``memory_stats()["bytes_limit"]``).
    ``max_concurrent_device_tasks`` preserves the reference's serialize-the-
    accelerator admission contract (server/services/task_manager.py:10-22);
    the queue sits in front of compiled executables.
    """

    allow_host_fallback: bool = False
    max_concurrent_device_tasks: int = 1


@dataclass(frozen=True)
class CompileConfig:
    """XLA compilation policy.

    The replacement for both the reference's ViTOptimizeConfig flag zoo
    (core/config.py:32-45) and its reserved TensorRT backend boundary
    (core/config.py:16-28): everything compiles through XLA, which hands the
    matrix products to the vendor libraries and fuses the rest.
    """

    dtype: str = "bfloat16"          # compute dtype for matmul-heavy paths
    param_dtype: str = "float32"     # master parameter dtype
    output_fp32: bool = True         # encoder output cast back to fp32
    deferred_decode_cache_write: bool = _env_bool("VIDEO_CAPTION_DEFERRED_KV_WRITE", False)
    """Greedy/sampled decode: batch all 12 per-layer KV-cache writes into
    ONE post-loop dynamic_update_slice (g2.GPT2Config.deferred_cache_write
    docstring). Off by default; token parity with the per-layer writes is
    tested either way."""
    sample_split_cache: bool = _env_bool("VIDEO_CAPTION_SAMPLE_SPLIT_CACHE", False)
    """Greedy/sampled decode over the beam path's split KV cache (read-only
    merged-H prefill + time-major [L,N,2,B,H] gen region) instead of the
    contiguous [L,B,max_len,2,nh,hd] cache. At K=1 the step is latency- not
    bandwidth-bound and split pays two attention programs (prefill + gen)
    where contig pays one. Default = contig."""
    donate_buffers: bool = True
    fuse_request_program: bool = _env_bool("VIDEO_CAPTION_FUSE_REQUEST", False)
    """One jitted program per request (prefix + every decode group) vs one
    program per decode group with async dispatch. Separate async dispatches
    pipeline with host work for BATCHED throughput; hence off by default
    for batches."""
    fuse_single_request: bool = _env_bool("VIDEO_CAPTION_FUSE_SINGLE", True)
    """Single-video requests use the fused one-dispatch program even when
    fuse_request_program is off: one host<->device round trip instead of
    three."""
    early_stop_decode: bool = _env_bool("VIDEO_CAPTION_EARLY_STOP", False)
    yuv420_wire: bool = _env_bool("VIDEO_CAPTION_YUV420_WIRE", True)
    """Ship raw 4:2:0 JPEG planes (1.5 bytes/pixel) and finish the decode —
    chroma upsample + YCbCr->RGB, bit-exact with libjpeg/PIL — on the device
    (preprocessing/yuv420.py). Halves host->device bytes for the canonical
    224x224 4:2:0 dataset frames; per-video fallback to the RGB path when a
    frame is not 4:2:0 at the target size or the native loader is absent."""
    quantize_decoder_int8: bool = _env_bool("VIDEO_CAPTION_INT8", False)
    """Weight-only int8 for the GPT-2 block matmuls (per-output-channel
    scales): halves decode weight traffic vs bf16. Off by default —
    captions may deviate from the fp/bf16 reference tokens."""
    overlap_single_upload: bool = _env_bool("VIDEO_CAPTION_OVERLAP_UPLOAD", True)
    """Single-request (B=1) cold path: ENCODE each uploaded chunk of frames
    (ViT trunk, per-frame) as soon as its device_put lands, so the transfer
    of chunk N+1 overlaps the encode of chunk N. Only engages for pool='cls'
    on a video-cache miss; per-frame trunk math has no cross-frame
    reductions, so captions are unchanged (engine falls back to the
    whole-video program otherwise)."""
    aot_request_program: bool = _env_bool("VIDEO_CAPTION_AOT_REQUEST", True)
    """Serve single-video requests through an ahead-of-time compiled
    executable (aot.py — the XLA analog of the reference's reserved TRT
    runtime, core/trt/runtime.py:6): the fused request program is lowered +
    compiled ONCE at warmup and called directly, skipping the per-request
    jit dispatch machinery (signature hashing, arg tree matching). The
    serialized StableHLO artifact (the "engine file") can also be exported
    via aot.export_request_program for inspection/portability."""
    unified_decode: bool = _env_bool("VIDEO_CAPTION_UNIFIED_DECODE", False)
    """Decode EVERY policy group of a request batch in one compiled program
    (decode/unified.py, SURVEY §7 hard part 6): the per-step GPT-2 weight
    streaming is shared across the beam and sampled presets instead of paid
    once per group. Token outputs are identical to the grouped path. Ignored
    (grouped fallback) when only one policy group exists or under
    early_stop_decode. Off by default for batches: the engine dispatches its
    group programs async back-to-back, and unified's uniform-K dead rows
    (sampled instances ride as K_max) cost rows the grouped path never
    computes."""
    unified_fused_request: bool = _env_bool("VIDEO_CAPTION_UNIFIED_FUSED", True)
    """Use the unified mixed-policy decode INSIDE the fused request program
    (the single-video/AOT path and fuse_request_program mode). Unlike the
    batch path above, the fused program has no async pipelining to lose:
    its decode groups run SEQUENTIALLY in one XLA program, each re-streaming
    the full GPT-2 weights (~250 MB/step) — at V=1 that traffic dominates
    the whole decode, so one weight stream shared across all three presets
    reads a third of the bytes. Token outputs are identical
    (decode/unified.py guarantee). Same eligibility gates as unified_decode."""


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding seam (reference explicitly has none; SURVEY §2.9).

    A one-device mesh is the default. Multi-device batch data parallelism is
    a config change, not a rewrite: axis sizes multiply to the device
    count and the batch dim is sharded over ``data_axis``.
    """

    data: int = 1       # DP degree (batch sharding)
    model: int = 1      # TP degree (head/ffn sharding)
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class InferenceConfig:
    """Stateless inference configuration (reference: core/config.py:47-72)."""

    ckpt: str = CKPT_PATH
    stage: str = "all"
    vit_name: str = VIT_NAME
    gpt2_name: str = GPT2_NAME
    prefix_len: int = 4
    num_frames: int = 8
    image_size: int = 224
    ln_scale: float = 0.6
    in_weight: float = 0.4
    preset1: str = DEFAULT_PRESETS[0]
    preset2: str = DEFAULT_PRESETS[1]
    preset3: str = DEFAULT_PRESETS[2]
    prompt1: str = DEFAULT_PROMPTS[0]
    prompt2: str = DEFAULT_PROMPTS[1]
    prompt3: str = DEFAULT_PROMPTS[2]
    backend: str = "xla"             # "xla" (jit) — the only real backend; kept
                                     # as a field for schema parity with the
                                     # reference's torch/tensorrt axis
    max_decode_len: int = 96         # static decode buffer: prefix+prompt+new
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    compile: CompileConfig = field(default_factory=CompileConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def cache_key(self) -> str:
        """Stable hash for the compiled-engine registry
        (reference analog: server/services/model_registry.py:12-15)."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


def default_inference_config(**overrides) -> InferenceConfig:
    """Build the core-default config (reference: core/config.py:47-72)."""
    return dataclasses.replace(InferenceConfig(), **overrides) if overrides else InferenceConfig()


def serving_inference_config(**overrides) -> InferenceConfig:
    """Build the SERVING-default config (reference: server/settings.py:17-49
    <- backend_config.py:61-64): preset2 is the heavier "detailed"
    (beam=4 x 40 tokens)."""
    base = dict(
        preset1=SERVING_PRESETS[0], preset2=SERVING_PRESETS[1],
        preset3=SERVING_PRESETS[2],
    )
    base.update(overrides)
    return dataclasses.replace(InferenceConfig(), **base)
