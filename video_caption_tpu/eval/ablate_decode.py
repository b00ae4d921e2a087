"""Decode-parameter ablation grid (reference: scripts/ablate_decode.py):
corpus BLEU per (beams x temperature x top_p x ngram) configuration over an
annotation split, sorted CSV output. Default grid matches the reference
(:86-89): beams [1,3,5] x T [0.7,0.8,1.0] x top_p [0.8,0.9,0.95] x ngram
[2,3,4].

Note: every grid point is its own compiled decode program; the engine's
program cache means a config costs compile once then replays per video.
"""
from __future__ import annotations

import argparse
import csv
import itertools
import json
import logging
from pathlib import Path
from typing import Dict, List, Sequence

log = logging.getLogger(__name__)

DEFAULT_GRID = {
    "num_beams": (1, 3, 5),
    "temperature": (0.7, 0.8, 1.0),
    "top_p": (0.8, 0.9, 0.95),
    "no_repeat_ngram_size": (2, 3, 4),
}


def ablate(
    ann_path: str, out_csv: str, ckpt: str = "", limit: int = 16,
    num_frames: int = 8, grid: Dict[str, Sequence] = None,
    image_size: int = 224,
) -> List[Dict]:
    import jax.numpy as jnp

    from video_caption_tpu.config import default_inference_config
    from video_caption_tpu.engine import InferenceEngine
    from video_caption_tpu.eval.bleu import corpus_bleu
    from video_caption_tpu.preprocessing.frame_loader import list_frames, load_video_array

    grid = grid or DEFAULT_GRID
    overrides = {"num_frames": num_frames, "image_size": image_size}
    if ckpt:
        overrides["ckpt"] = ckpt
    engine = InferenceEngine(default_inference_config(**overrides))

    records = [
        r for r in json.loads(Path(ann_path).read_text(encoding="utf-8"))
        if r.get("frames_dir") and list_frames(r["frames_dir"])
    ][: limit or None]
    log.info("ablating over %d videos", len(records))

    # encode every video ONCE; grid points only re-run the decode
    prefixes, refs = [], []
    for rec in records:
        video = jnp.asarray(load_video_array(rec["frames_dir"], num_frames,
                                             engine.config.image_size))
        prefixes.append(engine.compute_prefix(video))
        refs.append(rec.get("captions") or [rec.get("caption", "")])

    keys = list(grid)
    rows = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        kwargs = dict(zip(keys, combo), max_new_tokens=32, repetition_penalty=1.15)
        hyps = [engine.generate_once(p, "", **kwargs) for p in prefixes]
        bleu = corpus_bleu(hyps, refs) if hyps else 0.0
        rows.append({**{k: v for k, v in zip(keys, combo)}, "corpus_bleu": round(bleu, 3)})
        log.info("%s -> BLEU %.2f", dict(zip(keys, combo)), bleu)

    rows.sort(key=lambda r: -r["corpus_bleu"])
    out = Path(out_csv)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=keys + ["corpus_bleu"])
        writer.writeheader()
        writer.writerows(rows)
    return rows


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", required=True)
    p.add_argument("--out", default="outputs/ablate_decode.csv")
    p.add_argument("--ckpt", default="")
    p.add_argument("--limit", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=8)
    args = p.parse_args(argv)
    ablate(args.ann_path, args.out, args.ckpt, args.limit, args.num_frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
