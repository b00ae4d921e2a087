"""Autoregressive decode stack: tokenizer, logits processors, preset
registry, and scan-based greedy/sample/beam loops with a static KV cache —
the XLA replacement for HF ``model.generate``
(reference: src/models/text_decoder.py:105-146)."""

from video_caption_tpu.decode.presets import preset_to_kwargs  # noqa: F401
from video_caption_tpu.decode.tokenizer import get_tokenizer  # noqa: F401
