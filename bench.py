"""Benchmark: captions/sec/device + p50 video->caption latency on 16-frame
clips.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} with
the device it ran on (platform, device_kind, device count, power limit).
Refuses to run without a GPU: a CPU number is never reported under a device
metric.

Runs the full product path on the card: JPEG frames dir -> frame loader ->
ViT-B/16 encode (once) -> three decode presets -> text cleaning ->
best-of-3. Weights are random unless the checkpoint exists — latency is
weight-independent.

Methodology:
- throughput uses k-deep pipelining (k batches in flight) over DISTINCT
  frame dirs (no page-cache/same-content best-casing), median of N trials,
- a DEVICE-ONLY captions/s + per-stage roofline (bench/roofline.py) is
  measured on a device-resident batch and written to reports/roofline.json —
  this separates device time from host decode and transfer,
- the workload is labeled: "core" = engine defaults (precise/precise/natural,
  reference core/config.py:61) or "serving" = the heavier reference serving
  workload (precise/detailed/natural, backend_config.py:61-64). Select with
  BENCH_WORKLOAD=serving or argv[4].

Usage: python bench.py [warmup] [iters] [batch] [workload]
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from collections import deque
from pathlib import Path

import numpy as np

PIPELINE_DEPTH = int(os.environ.get("BENCH_PIPELINE_DEPTH", "4"))
TRIALS = int(os.environ.get("BENCH_TRIALS", "5"))  # median of 5 trials
N_DISTINCT_DIRS = 64  # >= default batch: every request in a batch is a distinct video


def make_frames_dirs(n_dirs: int, num_frames: int = 40, size=(224, 224)) -> list:
    """n_dirs DISTINCT dirs of distinct JPEG content.

    224x224 matches the reference's canonical benchmark input: it benches
    frames from data/processed/msvd (run_profiling.ps1:1-15), and its prep
    pipeline stores processed frames at 224x224 (scripts/extract_frames.py:
    28-33, prepare_msvd.py save_frames size=224)."""
    from PIL import Image

    dirs = []
    for d_idx in range(n_dirs):
        d = tempfile.mkdtemp(prefix=f"vct_bench_{d_idx}_")
        rng = np.random.RandomState(d_idx)
        for i in range(num_frames):
            Image.fromarray(rng.randint(0, 255, (*size, 3), np.uint8)).save(
                f"{d}/frame_{i:05d}.jpg", quality=95
            )
        dirs.append(d)
    return dirs


def pipelined_throughput(engine, dirs: list, batch: int, n_batches: int,
                         depth: int) -> float:
    """captions/s with ``depth`` batches in flight: dispatch (host JPEG decode
    + async upload + program enqueue) runs ahead of collect so the host and
    the device stay busy simultaneously rather than alternating.

    Steady-state honesty: the timed window covers only batches whose dispatch
    AND collect both happen inside it — the pipeline prefill is untimed, and
    the final ``depth`` in-flight batches (whose dispatches were timed but
    which drain after the window) are not credited. Crediting the drain would
    overstate throughput by up to n_batches/(n_batches-depth)."""
    total = n_batches + depth  # prefill + timed batches
    batches = [
        [dirs[(b * batch + i) % len(dirs)] for i in range(batch)]
        for b in range(total)
    ]
    inflight: deque = deque()
    next_dispatch = 0
    while next_dispatch < min(depth, total):  # untimed prefill
        inflight.append(engine.infer_batch_dispatch(batches[next_dispatch]))
        next_dispatch += 1
    t0 = time.perf_counter()
    collected = 0
    while next_dispatch < total:
        inflight.append(engine.infer_batch_dispatch(batches[next_dispatch]))
        next_dispatch += 1
        engine.infer_batch_collect(inflight.popleft())
        collected += 1
    elapsed = time.perf_counter() - t0
    while inflight:  # drain, untimed/uncredited
        engine.infer_batch_collect(inflight.popleft())
    return batch * collected / elapsed


def main() -> None:
    import jax

    from video_caption_tpu.config import InferenceConfig, serving_inference_config
    from video_caption_tpu.engine import InferenceEngine
    from video_caption_tpu.env import assert_core_runtime_ready, gpu_name_and_power_limit

    assert_core_runtime_ready(require_gpu=True)
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform, "device_kind": dev.device_kind,
        "count": len(jax.devices()), "name_and_power_limit": gpu_name_and_power_limit(),
    }

    warmup = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 15
    batch = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    workload = (sys.argv[4] if len(sys.argv) > 4
                else os.environ.get("BENCH_WORKLOAD", "core")).lower()

    if workload == "serving":
        cfg = serving_inference_config(
            ckpt="checkpoints/msvd_mapper_finetune_v2.pt", num_frames=16
        )
    else:
        workload = "core"
        cfg = InferenceConfig(ckpt="checkpoints/msvd_mapper_finetune_v2.pt", num_frames=16)
    engine = InferenceEngine(cfg)
    # the HEADLINE is cold: every request pays JPEG decode + upload. The
    # device-resident video LRU (engine default) would otherwise serve the
    # cycled benchmark dirs from HBM after one lap — measured separately
    # below as the labeled warm-cache metric.
    cache_budget = engine._video_cache_bytes
    engine._video_cache_bytes = 0
    dirs = make_frames_dirs(N_DISTINCT_DIRS)

    # single-stream latency (p50 video->caption)
    for _ in range(warmup):
        engine.infer(dirs[0])
    lat = []
    for i in range(iters):
        t0 = time.perf_counter()
        engine.infer(dirs[i % len(dirs)])
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat)

    # companion of the e2e p50: the wall p50 of the fused request program
    # with the pixels already resident, which excludes JPEG decode and the
    # host->device transfer
    device_p50_ms = None
    try:
        import jax.numpy as jnp

        program, _, _ = engine._fused_infer_program()
        vid1 = jnp.zeros(
            (1, cfg.num_frames, 3, cfg.image_size, cfg.image_size), jnp.uint8)
        key = jax.random.PRNGKey(0)
        jax.block_until_ready(program(engine.params, vid1, key))  # compile
        dev_lat = []
        for _ in range(max(iters, 10)):
            t0 = time.perf_counter()
            jax.block_until_ready(program(engine.params, vid1, key))
            dev_lat.append(time.perf_counter() - t0)
        device_p50_ms = statistics.median(dev_lat) * 1e3
    except Exception as exc:
        print(f"device-wall probe failed ({exc})", file=sys.stderr)

    # device throughput: k-deep pipelined batches, median of TRIALS
    roofline = None
    try:
        engine.infer_batch(dirs[:1] * batch)  # compile batched programs
        n_batches = max(iters // 3, 3)
        trials = [
            pipelined_throughput(engine, dirs, batch, n_batches, PIPELINE_DEPTH)
            for _ in range(TRIALS)
        ]
        caps_per_sec = statistics.median(trials)
        # warm-cache: repeated-content serving (the working set stays device-
        # resident; decode+wire skipped) — the steady-state for popular
        # videos. Own try: a warm-pass failure must not discard the valid
        # cold headline above. Skipped entirely when the operator disabled
        # the cache (VIDEO_CAPTION_VIDEO_CACHE_MB=0, e.g. tight HBM).
        warm_caps = None
        if cache_budget > 0:
            try:
                engine._video_cache_bytes = max(cache_budget, 512 * 1024 * 1024)
                fill_batches = -(-len(dirs) // batch) + 1  # cover every dir
                pipelined_throughput(engine, dirs, batch, fill_batches, 1)
                warm_caps = pipelined_throughput(
                    engine, dirs, batch, n_batches, PIPELINE_DEPTH)
            except Exception as exc:
                print(f"warm-cache pass failed ({exc}); cold headline kept",
                      file=sys.stderr)
            finally:
                engine._video_cache_bytes = 0
                engine._video_cache.clear()
                engine._video_cache_total = 0
        try:
            from video_caption_tpu.bench.roofline import measure_roofline

            roofline = measure_roofline(engine, batch=batch, trials=5)
        except Exception as exc:
            print(f"roofline failed ({exc})", file=sys.stderr)
    except Exception as exc:  # never leave the driver without a JSON line
        print(f"batched path failed ({exc}); reporting single-stream", file=sys.stderr)
        batch = 1
        trials = []
        warm_caps = None
        caps_per_sec = 1.0 / (sum(lat) / len(lat))

    hist_path = Path("reports/bench_history.json")
    hist_path.parent.mkdir(exist_ok=True)
    history = []
    if hist_path.is_file():
        try:
            history = json.loads(hist_path.read_text())
        except Exception:
            history = []
    # the reference publishes no numbers; baseline = the first run recorded
    # on the SAME device_kind in this checkout (reports/ is gitignored)
    first = next((r["value"] for r in history
                  if r.get("device", {}).get("device_kind") == dev.device_kind), None)
    vs_baseline = (caps_per_sec / first) if first else 1.0

    record = {
        "metric": "captions_per_sec_per_device",
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "device": device,
        "value": round(caps_per_sec, 4),
        "unit": "captions/s",
        "vs_baseline": round(vs_baseline, 4),
        "p50_latency_ms": round(p50 * 1000, 2),
        "batch_size": batch,
        "iters": iters,
        "workload": workload,
        "pipeline_depth": PIPELINE_DEPTH,
        "throughput_trials": [round(t, 3) for t in trials],
    }
    if len(trials) > 1:
        record["throughput_stddev"] = round(statistics.stdev(trials), 3)
    if device_p50_ms is not None:
        record["device_p50_ms"] = round(device_p50_ms, 2)
    if warm_caps is not None:
        record["warm_cache_caps_per_sec"] = round(warm_caps, 3)
    if roofline:
        record["device_caps_per_sec"] = roofline["device_caps_per_sec"]
        record["device_total_ms"] = roofline["device_total_ms"]
        record["mfu_per_stage"] = {
            s["stage"]: s.get("pct_peak_flops") for s in roofline["stages"]
        }
    history.append(record)
    hist_path.write_text(json.dumps(history, indent=1) + "\n")

    # the required four fields first; extra keys carry the device-only
    # companions and the device the numbers came from
    extra = {k: record[k] for k in (
        "device_caps_per_sec", "warm_cache_caps_per_sec", "p50_latency_ms",
        "device_p50_ms", "batch_size", "workload", "device",
    ) if k in record}
    print(json.dumps({**{k: record[k] for k in ("metric", "value", "unit", "vs_baseline")},
                      **extra}))


if __name__ == "__main__":
    main()
