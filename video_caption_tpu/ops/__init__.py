"""Hot-path operators in plain XLA (the reference's CuPy operators,
core/operators/cupy_vit_pool.py, have no hand-written counterpart here)."""

from video_caption_tpu.ops.prefix_norm import apply_prefix_norm  # noqa: F401
from video_caption_tpu.ops.temporal_pool import temporal_mean_pool  # noqa: F401
