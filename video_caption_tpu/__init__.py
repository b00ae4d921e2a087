"""video_caption_tpu — a JAX/XLA video-captioning framework that runs on NVIDIA
GPUs.

Re-implements the full capability surface of the reference video-caption
stack (video frames -> ViT-B/16 encoder -> prefix projection -> GPT-2
autoregressive decoder -> caption post-processing), redesigned for XLA:

- one jitted XLA program per (config, shape) instead of a zoo of fusion flags
  (reference: core/config.py:32-45 ViTOptimizeConfig switches),
- scan-based decode with a static-shape device KV cache instead of HF dynamic
  ``past_key_values`` (reference: src/models/text_decoder.py:105-146),
- plain XLA for the fused pool / prefix-projection hot ops the reference
  wrote as CuPy RawKernels (core/operators/cupy_vit_pool.py,
  core/operators/cupy_linear_mapper.py): XLA fuses the pool and hands the
  projection GEMM to cuBLAS,
- an engine registry keyed by config hash caching *compiled executables*
  (reference: server/services/model_registry.py caches torch engines).
"""

__version__ = "0.1.0"

from video_caption_tpu.datatypes import CaptionCandidates, InferenceResult  # noqa: F401
