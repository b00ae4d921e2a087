"""MSR-VTT dataset preparation.

MSR-VTT full-split feature extraction + captioning needs the dataset in the
canonical layout; the reference ships only MSVD prep, so this module
extends the same canonical layout to MSR-VTT's ``videodatainfo.json``
format (``{"videos": [{video_id, split, ...}], "sentences":
[{video_id, caption}]}``):

    <out>/<split>/frames/<video_id>/frame_%05d.jpg
    <out>/<split>/annotations.json

Decoding/sampling reuse prepare_msvd's cv2 path (center-of-bin sampling,
224 BICUBIC, JPEG q95), so everything downstream (dataloader, batch infer,
retrieval, eval) works unchanged.
"""
from __future__ import annotations

import argparse
import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

from video_caption_tpu.scripts.prepare_msvd import extract_video_frames

log = logging.getLogger(__name__)


def parse_videodatainfo(path: str) -> List[Dict]:
    """videodatainfo.json -> records with grouped captions."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    sentences: Dict[str, List[str]] = defaultdict(list)
    for s in data.get("sentences", []):
        sentences[s["video_id"]].append(s["caption"])
    records = []
    for v in data.get("videos", []):
        vid = v["video_id"]
        records.append({
            "video_id": vid,
            "split": v.get("split", "train"),
            "captions": sentences.get(vid, []),
            "category": v.get("category"),
        })
    return records


def prepare(
    videodatainfo: str, videos_dir: str, out_root: str,
    num_frames: int = 32, image_size: int = 224, limit: int = 0,
) -> Dict[str, int]:
    records = parse_videodatainfo(videodatainfo)
    if limit:
        records = records[:limit]
    videos = {
        p.stem: p for p in Path(videos_dir).iterdir()
        if p.suffix.lower() in {".mp4", ".avi", ".mkv", ".webm"}
    }
    by_split: Dict[str, List[Dict]] = defaultdict(list)
    for rec in records:
        vid = rec["video_id"]
        if vid not in videos:
            log.warning("missing video file for %s", vid)
            continue
        split = rec["split"] if rec["split"] in ("train", "val", "test") else (
            "val" if rec["split"] == "validate" else "train"
        )
        frames_dir = Path(out_root) / split / "frames" / vid
        n = extract_video_frames(str(videos[vid]), frames_dir, num_frames, image_size)
        by_split[split].append({
            "video_id": vid, "split": split, "captions": rec["captions"],
            "num_frames": n, "fps": 0, "frames_dir": str(frames_dir),
        })
    counts = {}
    for split, recs in by_split.items():
        ann = Path(out_root) / split / "annotations.json"
        ann.parent.mkdir(parents=True, exist_ok=True)
        ann.write_text(json.dumps(recs, indent=1))
        counts[split] = len(recs)
    log.info("split sizes: %s", counts)
    return counts


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--videodatainfo", required=True)
    p.add_argument("--videos_dir", required=True)
    p.add_argument("--out_root", default="data/processed/msrvtt")
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--limit", type=int, default=0)
    args = p.parse_args(argv)
    prepare(args.videodatainfo, args.videos_dir, args.out_root,
            args.num_frames, args.image_size, args.limit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
