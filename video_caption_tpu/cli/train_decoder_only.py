"""Stage-3 LM style tune (reference: src/cli/train_decoder_only.py,
scripts/train_stage3_lm.py): pure GPT-2 causal-LM fine-tune on caption text
only — labels are the input ids with pads masked to -100; linear warmup,
grad-clip 1.0, perplexity logging, best checkpoint saved for use as the
``gpt2_name_b`` side of eval_compare.
"""
from __future__ import annotations

import argparse
import logging
import math


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", default="data/processed/msvd/train/annotations.json")
    p.add_argument("--val_ann_path", default="")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--val_every", type=int, default=200)
    p.add_argument("--out_dir", default="runs/stage3_lm")
    p.add_argument("--ckpt_path", default="checkpoints/gpt2_lm_stage3_best")
    return p.parse_args(argv)


def _text_batches(ann_path, tokenizer, batch_size, max_len):
    """Caption-only batches (no video decode needed for stage 3)."""
    import json
    from pathlib import Path

    import numpy as np

    records = json.loads(Path(ann_path).read_text(encoding="utf-8"))
    captions = []
    for rec in records:
        captions.extend(rec.get("captions") or ([rec["caption"]] if "caption" in rec else []))

    def batches():
        ids_all, mask_all = [], []
        for cap in captions:
            ids = tokenizer.encode(cap)[: max_len - 1] + [tokenizer.eos_token_id]
            pad = max_len - len(ids)
            mask_all.append([1] * len(ids) + [0] * pad)
            ids_all.append(ids + [tokenizer.pad_token_id] * pad)
            if len(ids_all) == batch_size:
                yield {
                    "caption_ids": np.asarray(ids_all, np.int32),
                    "attention_mask": np.asarray(mask_all, np.int32),
                }
                ids_all, mask_all = [], []

    return batches


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = parse_args(argv)

    from video_caption_tpu.env import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import optax

    from video_caption_tpu.decode.tokenizer import get_tokenizer
    from video_caption_tpu.models import gpt2 as g2
    from video_caption_tpu.training.loop import LoopConfig, run_training

    tokenizer = get_tokenizer()
    cfg = g2.GPT2Config()
    params = g2.init_gpt2_params(jax.random.PRNGKey(0), cfg)

    def loss_fn(p, batch):
        ids, mask = batch["caption_ids"], batch["attention_mask"]
        embeds = p["wte"][ids]
        positions = jnp.maximum(jnp.cumsum(mask, axis=1) - 1, 0).astype(jnp.int32)
        logits = g2.gpt2_logits_nocache(p, embeds, positions, mask, cfg)
        labels = jnp.where(mask > 0, ids, -100)
        return g2.lm_loss(logits, labels)

    schedule = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, args.warmup_steps, max(args.max_steps, 1000)
    )
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule))

    train_batches = _text_batches(args.ann_path, tokenizer, args.batch_size, args.max_len)
    val_batches = (
        _text_batches(args.val_ann_path, tokenizer, args.batch_size, args.max_len)()
        if args.val_ann_path else None
    )
    result = run_training(
        params, loss_fn, optimizer, train_batches(), val_batches,
        cfg=LoopConfig(
            epochs=args.epochs, max_steps=args.max_steps, val_every=args.val_every,
            out_dir=args.out_dir, ckpt_path=args.ckpt_path,
        ),
    )
    if result["best_val"] < float("inf"):
        logging.info("val ppl %.2f", math.exp(min(result["best_val"], 20.0)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
