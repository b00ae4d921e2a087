"""Mapper fine-tune CLI — trains the captioner the product serves
(reference: src/cli/train_caption_mapper.py:165-326). Freezes ViT + GPT-2,
trains proj/mapper at --lr, optionally unfreezes the last N GPT-2 blocks at
--lr_gpt2. Multi-chip: --mesh_data / --mesh_model shard the step over ICI.
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", default="data/processed/msvd/train/annotations.json")
    p.add_argument("--val_ann_path", default="data/processed/msvd/val/annotations.json")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_frame", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr_gpt2", type=float, default=1e-5)
    p.add_argument("--unfreeze_last_gpt2", type=int, default=0)
    p.add_argument("--val_every", type=int, default=200)
    p.add_argument("--init_ckpt", default="", help="optional torch/orbax ckpt to start from")
    p.add_argument("--out_dir", default="runs/mapper_finetune")
    p.add_argument("--ckpt_path", default="checkpoints/msvd_mapper_finetune")
    p.add_argument("--mesh_data", type=int, default=0, help="0 = all devices")
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-style weight+optimizer sharding over the data axis")
    p.add_argument("--u8_pixels", action="store_true",
                   help="ship uint8 pixels; normalize on device (4x less transfer)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = parse_args(argv)

    from video_caption_tpu.env import enable_compilation_cache

    enable_compilation_cache()

    import jax

    from video_caption_tpu.config import MeshConfig, default_inference_config
    from video_caption_tpu.data import build_dataloader
    from video_caption_tpu.decode.tokenizer import get_tokenizer
    from video_caption_tpu.engine import load_params, model_config_from_inference
    from video_caption_tpu.parallel import make_mesh
    from video_caption_tpu.training.mapper_trainer import MapperTrainer, TrainArgs

    tokenizer = get_tokenizer()
    loader = build_dataloader(
        args.ann_path, tokenizer, batch_size=args.batch_size, max_len=args.max_len,
        num_frame=args.num_frame, image_size=args.image_size, num_workers=1,
        uint8_pixels=args.u8_pixels,
    )
    val_loader = build_dataloader(
        args.val_ann_path, tokenizer, batch_size=args.batch_size, max_len=args.max_len,
        num_frame=args.num_frame, image_size=args.image_size, shuffle=False,
    ) if args.val_ann_path else None

    inf_cfg = default_inference_config(
        num_frames=args.num_frame, image_size=args.image_size,
        **({"ckpt": args.init_ckpt} if args.init_ckpt else {}),
    )
    model_cfg = model_config_from_inference(inf_cfg)
    params = load_params(inf_cfg, model_cfg)

    data = args.mesh_data or len(jax.devices()) // args.mesh_model
    mesh = make_mesh(MeshConfig(data=data, model=args.mesh_model))
    trainer = MapperTrainer(
        model_cfg, params,
        TrainArgs(
            lr=args.lr, lr_gpt2=args.lr_gpt2, unfreeze_last_gpt2=args.unfreeze_last_gpt2,
            epochs=args.epochs, max_steps=args.max_steps, val_every=args.val_every,
            out_dir=args.out_dir, ckpt_path=args.ckpt_path,
        ),
        mesh=mesh,
        fsdp=args.fsdp,
    )

    def strip(b):
        return {k: v for k, v in b.items() if k != "video_id"}

    stats = trainer.fit(map(strip, loader), [strip(b) for b in val_loader] if val_loader else None)
    logging.info("mapper training done: %s", stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
