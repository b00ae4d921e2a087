"""Stage-sliced benchmark (reference: core/scripts/benchmark_baseline.py).

Reproduces the reference's measurement design under XLA:

- the 4-stage taxonomy with one named jax.profiler scope per stage
  (NVTX-range parity, SURVEY §5.1): Preprocessing, ViT_Encoder,
  Cross_Modal_Alignment, GPT2_Decoder_Step,
- a **manual greedy decode loop** timed per token (benchmark_baseline.py:
  160-231 run_decoder_steps uses its own loop, not HF generate; here each
  single-token jitted step is block_until_ready-timed),
- warmup + N iterations, batch-size sweep 1..16 with OOM marking that stops
  larger sizes (:655-663),
- identical report files: baseline_iterations.csv, baseline_summary.json,
  benchmark_bs_comparison.csv, benchmark_bs_summary.json (+ _bf16 variants).

Stage timing uses host perf_counter around ``block_until_ready`` — the XLA
equivalent of the reference's cuda-event + synchronize brackets (:74-86).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from video_caption_tpu.bench import report as rpt
from video_caption_tpu.config import InferenceConfig, default_inference_config
from video_caption_tpu.decode.tokenizer import get_tokenizer
from video_caption_tpu.engine import load_params, model_config_from_inference
from video_caption_tpu.env import device_summary, enable_compilation_cache
from video_caption_tpu.memory import MemoryManager, is_oom_error
from video_caption_tpu.models import caption_model as cm
from video_caption_tpu.models import gpt2 as g2
from video_caption_tpu.ops.prefix_norm import apply_prefix_norm
from video_caption_tpu.preprocessing.frame_loader import load_video_array_u8

log = logging.getLogger(__name__)


class StageBench:
    """Compiled per-stage programs over one (config, batch) shape."""

    def __init__(self, config: InferenceConfig, batch_size: int, max_new_tokens: int = 24):
        enable_compilation_cache()
        self.config = config
        self.batch = batch_size
        self.max_new = max_new_tokens
        self.model_cfg = model_config_from_inference(config)
        self.params = load_params(config, self.model_cfg)
        self.tokenizer = get_tokenizer()
        self.memory = MemoryManager(config.memory)
        mc = self.model_cfg

        @jax.jit
        def encode(params, video):
            with jax.profiler.TraceAnnotation("ViT_Encoder"):
                return cm.encode_video(params, video, mc)

        @jax.jit
        def align(params, emb):
            with jax.profiler.TraceAnnotation("Cross_Modal_Alignment"):
                emb = apply_prefix_norm(emb, mc.ln_scale, mc.in_weight)
                return cm.map_prefix(params, emb, mc)

        s0 = mc.prefix_len + 1  # prefix + BOS
        max_len = s0 + max_new_tokens
        self.s0 = s0

        @jax.jit
        def prefill(params, prefix):
            bos = jnp.full((prefix.shape[0], 1), self.tokenizer.bos_token_id, jnp.int32)
            embeds = cm.build_decoder_inputs(params, prefix, bos, mc)
            cache = g2.init_cache(mc.gpt2, prefix.shape[0], max_len)
            valid = jnp.zeros((prefix.shape[0], max_len), jnp.int32)
            valid = jax.lax.dynamic_update_slice(
                valid, jnp.ones((prefix.shape[0], s0), jnp.int32), (0, 0)
            )
            positions = jnp.broadcast_to(jnp.arange(s0, dtype=jnp.int32), (prefix.shape[0], s0))
            logits, cache = g2.gpt2_forward(
                params["decoder"], embeds, positions, valid, cache, jnp.int32(0), mc.gpt2
            )
            return logits[:, -1, :], cache, valid

        @partial(jax.jit, donate_argnums=(2, 3))
        def decode_step(params, tok, cache, valid, t):
            with jax.profiler.TraceAnnotation("GPT2_Decoder_Step"):
                embeds = params["decoder"]["wte"][tok][:, None, :]
                positions = jnp.broadcast_to((s0 + t).astype(jnp.int32), (tok.shape[0], 1))
                valid = jax.lax.dynamic_update_slice(
                    valid, jnp.ones((tok.shape[0], 1), jnp.int32), (0, s0 + t)
                )
                logits, cache = g2.gpt2_forward(
                    params["decoder"], embeds, positions, valid, cache, s0 + t, mc.gpt2
                )
                return jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32), cache, valid

        self.encode_fn, self.align_fn = encode, align
        self.prefill_fn, self.decode_step_fn = prefill, decode_step

    # ------------------------------------------------------------------
    def run_iteration(self, frames_dir: str) -> Dict:
        cfg = self.config
        row: Dict = {"batch_size": self.batch, "num_frames": cfg.num_frames,
                     "max_new_tokens": self.max_new, "dtype": cfg.compile.dtype}
        t_all = time.perf_counter()

        with jax.profiler.TraceAnnotation("Preprocessing"):
            t0 = time.perf_counter()
            host = load_video_array_u8(frames_dir, cfg.num_frames, cfg.image_size)
            host = np.repeat(host, self.batch, axis=0)
            row["preprocess_ms"] = (time.perf_counter() - t0) * 1000

            t0 = time.perf_counter()
            video = jnp.asarray(host)
            video.block_until_ready()
            row["preprocess_device_ms"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        emb = self.encode_fn(self.params, video)
        emb.block_until_ready()
        row["vit_ms"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        prefix = self.align_fn(self.params, emb)
        prefix.block_until_ready()
        row["cross_modal_ms"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        logits, cache, valid = self.prefill_fn(self.params, prefix)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        token_times: List[float] = []
        eos = self.tokenizer.eos_token_id
        generated = [np.asarray(tok)]
        for t in range(self.max_new - 1):
            ts = time.perf_counter()
            tok, cache, valid = self.decode_step_fn(
                self.params, tok, cache, valid, jnp.int32(t)
            )
            tok.block_until_ready()
            token_times.append((time.perf_counter() - ts) * 1000)
            generated.append(np.asarray(tok))
        row["gpt2_ms"] = (time.perf_counter() - t0) * 1000
        row["gpt2_token_step_ms"] = float(np.mean(token_times)) if token_times else 0.0

        row["end_to_end_ms"] = (time.perf_counter() - t_all) * 1000
        row["throughput_samples_s"] = self.batch / (row["end_to_end_ms"] / 1000)

        gen = np.stack(generated, axis=1)  # [B, max_new]
        lengths = []
        for r in gen:
            stop = np.where(r == eos)[0]
            lengths.append(int(stop[0]) + 1 if len(stop) else len(r))
        row["generated_tokens"] = int(np.mean(lengths))
        row["caption_preview"] = self.tokenizer.decode(gen[0])[:60].replace("\n", " ")

        snap = self.memory.snapshot()
        row["peak_memory_mb"] = round(snap.peak_bytes_in_use / 2**20, 1) if snap.peak_bytes_in_use else ""
        return row


def benchmark_one_batch_size(
    config: InferenceConfig, frames_dir: str, batch_size: int,
    warmup: int, iters: int, max_new_tokens: int,
) -> Dict:
    bench = StageBench(config, batch_size, max_new_tokens)
    for _ in range(warmup):
        bench.run_iteration(frames_dir)
    rows = [bench.run_iteration(frames_dir) for _ in range(iters)]
    for i, row in enumerate(rows):
        row["iteration"] = i
    return {"rows": rows, "bench": bench}


def run_sweep(
    config: InferenceConfig, frames_dir: str, batch_sizes: List[int],
    warmup: int, iters: int, max_new_tokens: int, out_dir: Path, tag: str = "",
) -> Dict:
    per_bs = []
    all_rows: List[Dict] = []
    summary_per_bs = {}
    for bs in batch_sizes:
        try:
            result = benchmark_one_batch_size(config, frames_dir, bs, warmup, iters, max_new_tokens)
        except Exception as err:
            if is_oom_error(err):
                log.warning("batch %d OOM; stopping sweep (reference contract)", bs)
                per_bs.append({"batch_size": bs, "status": "OOM"})
                break
            raise
        rows = result["rows"]
        all_rows.extend(rows)
        stats = {
            "batch_size": bs, "status": "ok",
            "end_to_end_mean_ms": float(np.mean([r["end_to_end_ms"] for r in rows])),
            "end_to_end_std_ms": float(np.std([r["end_to_end_ms"] for r in rows])),
            "vit_mean_ms": float(np.mean([r["vit_ms"] for r in rows])),
            "cross_modal_mean_ms": float(np.mean([r["cross_modal_ms"] for r in rows])),
            "gpt2_mean_ms": float(np.mean([r["gpt2_ms"] for r in rows])),
            "gpt2_token_step_mean_ms": float(np.mean([r["gpt2_token_step_ms"] for r in rows])),
            "throughput_mean": float(np.mean([r["throughput_samples_s"] for r in rows])),
            "throughput_std": float(np.std([r["throughput_samples_s"] for r in rows])),
            "peak_memory_mb": rows[-1].get("peak_memory_mb", ""),
        }
        per_bs.append(stats)
        summary_per_bs[str(bs)] = stats
        log.info("bs=%d e2e=%.1fms tok=%.2fms tput=%.2f/s", bs,
                 stats["end_to_end_mean_ms"], stats["gpt2_token_step_mean_ms"],
                 stats["throughput_mean"])

    suffix = f"_{tag}" if tag else ""
    rpt.write_iteration_csv(out_dir / f"baseline_iterations{suffix}.csv", all_rows)
    rpt.write_bs_comparison(out_dir / f"benchmark_bs_comparison{suffix}.csv", per_bs)

    bs1_rows = [r for r in all_rows if r["batch_size"] == batch_sizes[0]]
    stages = {
        "preprocess": [r["preprocess_ms"] for r in bs1_rows],
        "preprocess_device": [r["preprocess_device_ms"] for r in bs1_rows],
        "vit": [r["vit_ms"] for r in bs1_rows],
        "cross_modal": [r["cross_modal_ms"] for r in bs1_rows],
        "gpt2": [r["gpt2_ms"] for r in bs1_rows],
        "gpt2_token_step": [r["gpt2_token_step_ms"] for r in bs1_rows],
        "end_to_end": [r["end_to_end_ms"] for r in bs1_rows],
    }
    summary = rpt.build_summary(
        stages,
        [r["throughput_samples_s"] for r in bs1_rows],
        env=device_summary(),
        config={**dataclasses.asdict(config), "batch_size": batch_sizes[0],
                "warmup": warmup, "iters": iters, "max_new_tokens": max_new_tokens},
        generated_tokens=[r["generated_tokens"] for r in bs1_rows],
        caption_preview=bs1_rows[-1]["caption_preview"] if bs1_rows else "",
    )
    rpt.write_json(out_dir / f"baseline_summary{suffix}.json", summary)
    rpt.write_json(out_dir / f"benchmark_bs_summary{suffix}.json", summary_per_bs)
    return summary


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--frames_dir", default="")
    p.add_argument("--ckpt", default="")
    p.add_argument("--batch-sizes", default="1,2,4,8,12,16")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--max_new_tokens", type=int, default=24)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--out_dir", default="reports")
    args = p.parse_args(argv)

    overrides = {"num_frames": args.num_frames}
    if args.ckpt:
        overrides["ckpt"] = args.ckpt
    config = default_inference_config(**overrides)
    config = dataclasses.replace(
        config, compile=dataclasses.replace(config.compile, dtype=args.dtype)
    )

    frames_dir = args.frames_dir or _make_synth_frames()

    # report-name parity: the deployment default (bf16) writes the reference's
    # plain file names (baseline_summary.json, ...); fp32 gets a suffix, like
    # the reference's fp16 variant wrote *_fp16 files
    tag = "" if args.dtype == "bfloat16" else "fp32"
    run_sweep(
        config, frames_dir, [int(b) for b in args.batch_sizes.split(",")],
        args.warmup, args.iters, args.max_new_tokens, Path(args.out_dir), tag=tag,
    )
    return 0


def _make_synth_frames() -> str:
    import tempfile

    from PIL import Image

    d = tempfile.mkdtemp(prefix="vct_bench_frames_")
    rng = np.random.RandomState(0)
    for i in range(40):
        Image.fromarray(rng.randint(0, 255, (240, 320, 3), np.uint8)).save(
            f"{d}/frame_{i:05d}.jpg", quality=95
        )
    return d


if __name__ == "__main__":
    raise SystemExit(main())
