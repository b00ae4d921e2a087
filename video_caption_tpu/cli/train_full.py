"""Stage-1/2 alignment trainer (reference: src/cli/train_full.py):
``--model simple`` trains SimpleAlignModel, ``--model vit`` trains the
ViT-text dual encoder. Stage 1 = joint (ViT unfrozen, higher lr); stage 2 =
lower-lr fine-tune (experiments/run_stage{1,2}*.ps1). Best-val checkpoints
carry the full metadata payload.
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", default="data/processed/msvd/train/annotations.json")
    p.add_argument("--val_ann_path", default="")
    p.add_argument("--model", choices=["simple", "vit"], default="simple")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_frame", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--val_every", type=int, default=200)
    p.add_argument("--out_dir", default="runs/stage1")
    p.add_argument("--ckpt_path", default="checkpoints/align_best")
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
    from video_caption_tpu.training.loop import LoopConfig, run_training

    tokenizer = get_tokenizer()
    loader = build_dataloader(
        args.ann_path, tokenizer, batch_size=args.batch_size, max_len=args.max_len,
        num_frame=args.num_frame, image_size=args.image_size,
    )
    val_loader = None
    if args.val_ann_path:
        val_loader = build_dataloader(
            args.val_ann_path, tokenizer, batch_size=args.batch_size,
            max_len=args.max_len, num_frame=args.num_frame,
            image_size=args.image_size, shuffle=False,
        )

    if args.model == "simple":
        from video_caption_tpu.models import toy

        cfg = toy.ToyConfig(vocab_size=tokenizer.vocab_size)
        params = toy.init_simple_align(jax.random.PRNGKey(0), cfg)

        def loss_fn(p, batch):
            return toy.simple_align_loss(
                p, batch["video"], batch["caption_ids"], batch["attention_mask"]
            )
    else:
        import jax.numpy as jnp

        from video_caption_tpu.models import align as al

        cfg = al.AlignConfig(vocab_size=tokenizer.vocab_size)
        params = al.init_align_params(jax.random.PRNGKey(0), cfg)

        def loss_fn(p, batch):
            v = al.encode_video(p, batch["video"], cfg)
            t = al.encode_text(p, batch["caption_ids"], batch["attention_mask"], cfg)
            return al.cosine_embedding_loss(v, t, jnp.ones(v.shape[0]))

    def drop_ids(batch):
        return {k: v for k, v in batch.items() if k != "video_id"}

    result = run_training(
        params, loss_fn, optax.adamw(args.lr), loader, val_loader,
        cfg=LoopConfig(
            epochs=args.epochs, max_steps=args.max_steps, val_every=args.val_every,
            out_dir=args.out_dir, ckpt_path=args.ckpt_path,
        ),
        batch_transform=drop_ids,
    )
    logging.info("training done: %d steps best_val=%.4f", result["steps"], result["best_val"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
