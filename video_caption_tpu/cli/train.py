"""Dry-run trainer (reference: src/cli/train.py): the minimal runnable
SimpleAlignModel over the real dataloader — exercises data -> loss ->
optimizer before committing to the full model. Emits runs/.../events.csv.

Usage: python -m video_caption_tpu.cli.train --ann_path ... [--max_steps 50]
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", default="data/processed/msvd/train/annotations.json")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_frame", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--out_dir", default="runs/dry_run")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = parse_args(argv)

    from video_caption_tpu.env import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import optax

    from video_caption_tpu.data import build_dataloader
    from video_caption_tpu.decode.tokenizer import get_tokenizer
    from video_caption_tpu.models import toy
    from video_caption_tpu.training.loop import LoopConfig, run_training

    tokenizer = get_tokenizer()
    loader = build_dataloader(
        args.ann_path, tokenizer, batch_size=args.batch_size, max_len=args.max_len,
        num_frame=args.num_frame, image_size=args.image_size,
    )
    cfg = toy.ToyConfig(vocab_size=tokenizer.vocab_size)
    params = toy.init_simple_align(jax.random.PRNGKey(0), cfg)

    def loss_fn(p, batch):
        return toy.simple_align_loss(
            p, batch["video"], batch["caption_ids"], batch["attention_mask"]
        )

    def drop_ids(batch):
        return {k: v for k, v in batch.items() if k != "video_id"}

    result = run_training(
        params, loss_fn, optax.adamw(args.lr), loader,
        cfg=LoopConfig(epochs=args.epochs, max_steps=args.max_steps, out_dir=args.out_dir),
        batch_transform=drop_ids,
    )
    logging.info("dry run done: %d steps", result["steps"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
