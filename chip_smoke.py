"""Bring-up check on one NVIDIA GPU: the HTTP server, the batched engine, the
mapper trainer and the bf16 numerics, at full width, in one process.

    python chip_smoke.py               # one card: serve, batch, train, numerics
    python chip_smoke.py --four-cards  # four cards: mesh training + data-parallel
                                       # inference, each against one card

Full width: ViT-B/16 at 224 px over 16 frames, the 256 -> 4x768 prefix
mapper, GPT-2 124M, the 96-slot cache and the serving presets
precise/detailed/natural. Weights are random, made from a seed (the trained
checkpoint and GPT-2 vocab files are not in the repository, so captions come
from the byte tokenizer's fallback path; speed does not depend on weights).

Every phase runs; a failed phase is reported and the script exits 1 without
its result line. Without a GPU backend it exits 2 before any phase. The last
line of a passing run is one JSON object: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import tempfile
import time
import traceback
import urllib.request

import numpy as np

SEED = 0
FRAMES = 16
SIZE = 224
SERVE_REQUESTS = 8
BATCH_VIDEOS = 64
TRAIN_BATCH, TRAIN_STEPS = 32, 5

# Mesh vs one card: the same bf16 step with other reduction orders (TP
# partial sums, sharded batch). A wrong sharding rule moves the loss by far
# more than 1% of its ~10.8-nat starting value.
TOL_MESH_LOSS = 1e-2


def write_frames(root: str, n_dirs: int, seed: int) -> list:
    """``n_dirs`` distinct directories of ``FRAMES`` 224x224 JPEGs."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    dirs = []
    base = np.linspace(0, 255, SIZE, dtype=np.float32)
    for d_idx in range(n_dirs):
        d = os.path.join(root, f"video_{seed}_{d_idx:03d}")
        os.makedirs(d)
        for i in range(FRAMES):
            # smooth content with noise: closer to a video frame than pure noise
            img = (base[None, :, None] * rng.uniform(0.2, 1.0, 3)
                   + rng.normal(0, 24, (SIZE, SIZE, 3)) + i * 4) % 256
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(d, f"frame_{i:05d}.jpg"), quality=90)
        dirs.append(d)
    return dirs


def serving_config():
    from video_caption_tpu.server.schemas import InferRequest
    from video_caption_tpu.server.services.inference_service import request_to_config

    # the config the HTTP path builds for {"num_frames": 16}
    return request_to_config(InferRequest(frames_dir=".", num_frames=FRAMES))


def phase_serve(ctx) -> None:
    from video_caption_tpu.native import loader
    from video_caption_tpu.server.stdlib_server import StdlibServer

    srv = StdlibServer("127.0.0.1", 0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/api/v1/infer"
        walls = []
        for i, d in enumerate(ctx["serve_dirs"]):
            body = json.dumps({"frames_dir": d, "num_frames": FRAMES}).encode()
            req = urllib.request.Request(url, data=body, method="POST",
                                         headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=900) as resp:
                status, payload = resp.status, json.loads(resp.read())
            walls.append(time.perf_counter() - t0)
            texts = [payload.get(k) for k in ("S1", "S2", "S3")]
            best = payload.get("BEST", {})
            print(f"serve: request {i} status {status} {walls[-1] * 1e3:.1f} ms "
                  f"best={best.get('key')}:{best.get('text')!r}")
            if status != 200 or not all(texts) or not best.get("text"):
                raise AssertionError(f"request {i}: bad response {payload}")
    finally:
        srv.stop()
    print(f"serve: first request (engine build + compile) {walls[0]:.2f} s; "
          f"p50 of the other {len(walls) - 1}: {statistics.median(walls[1:]) * 1e3:.1f} ms")
    print(f"serve: frames decoded by {loader.last_backend!r} "
          f"(native loader error: {loader.last_error!r})")


def phase_batch(ctx) -> None:
    engine = ctx["engine"]()
    budget = engine._video_cache_bytes
    engine._video_cache_bytes = 0     # every video pays decode + upload
    try:
        t0 = time.perf_counter()
        results = engine.infer_batch(ctx["batch_dirs"])
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = engine.infer_batch(ctx["batch_dirs"])
        wall = time.perf_counter() - t0
    finally:
        engine._video_cache_bytes = budget
    if len(results) != BATCH_VIDEOS or not all(r.best_text for r in results):
        raise AssertionError(f"batch: {len(results)} results, some empty")
    print(f"batch: infer_batch over {BATCH_VIDEOS} distinct videos: first call "
          f"(compile) {first:.2f} s, second {wall:.3f} s = "
          f"{BATCH_VIDEOS / wall:.1f} captions/s; e.g. {results[0].best_text!r}")


def _trainer(mesh=None, out_dir=None):
    import jax

    from video_caption_tpu.config import default_inference_config
    from video_caption_tpu.engine import model_config_from_inference
    from video_caption_tpu.models import caption_model as cm
    from video_caption_tpu.training.mapper_trainer import MapperTrainer, TrainArgs

    mc = model_config_from_inference(default_inference_config(num_frames=FRAMES))
    params = cm.init_caption_model(jax.random.PRNGKey(SEED), mc)
    return MapperTrainer(mc, params, TrainArgs(out_dir=out_dir), mesh=mesh)


def _train_batch(seed: int = SEED) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "video": rng.randint(0, 256, (TRAIN_BATCH, FRAMES, 3, SIZE, SIZE), np.uint8),
        "caption_ids": rng.randint(0, 50257, (TRAIN_BATCH, 24)).astype(np.int32),
        "attention_mask": np.ones((TRAIN_BATCH, 24), np.int32),
    }


def _run_steps(trainer, batch) -> list:
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.run_step(batch))
        walls.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    return losses, walls


def phase_train(ctx) -> None:
    trainer = _trainer(out_dir=ctx["tmp"] + "/train")
    losses, walls = _run_steps(trainer, _train_batch())
    print(f"train: {TRAIN_STEPS} mapper steps at batch {TRAIN_BATCH} x {FRAMES} frames: "
          f"losses {[round(x, 4) for x in losses]}; first step (compile) "
          f"{walls[0]:.2f} s, then median {statistics.median(walls[1:]) * 1e3:.1f} ms/step")


def phase_numerics(ctx) -> None:
    """bf16 engine programs vs a float32 reference at full width; the legs
    and their tolerances are bench/accuracy_alignment.py's."""
    from video_caption_tpu.bench.accuracy_alignment import check_alignment

    results = check_alignment(num_frames=FRAMES, seed=SEED, engine=ctx["engine"](),
                              eager=False)
    for name, r in results.items():
        if name == "all_ok":
            continue
        if "ok" in r:
            print(f"numerics: {name}: rel err {r['rel_err']:.3e} (tol {r['tol']:.0e}) "
                  f"{'ok' if r['ok'] else 'FAIL'}")
        else:
            print(f"numerics: {name}: {r['rate']:.3f} (informational: random "
                  f"weights give near-flat logits)")
    if not results["all_ok"]:
        raise AssertionError("a numerics leg is outside its tolerance")


def phase_mesh_train(ctx) -> None:
    """5 steps on a data=2 x model=2 mesh against the same steps on one card."""
    import jax

    from video_caption_tpu.config import MeshConfig
    from video_caption_tpu.parallel import make_mesh, shard_batch

    devs = jax.devices()[:4]
    one = _trainer(make_mesh(MeshConfig(1, 1), devs[:1]), ctx["tmp"] + "/one")
    ref, _ = _run_steps(one, _train_batch())
    del one
    mesh = make_mesh(MeshConfig(data=2, model=2), devs)
    trainer = _trainer(mesh, ctx["tmp"] + "/mesh")
    batch = _train_batch()
    placed = shard_batch(batch, mesh)
    qkv = trainer.params["encoder"]["blocks"]["qkv_w"]
    print(f"mesh-train: batch video sharding {placed['video'].sharding.spec} over "
          f"{len(placed['video'].sharding.device_set)} devices; encoder qkv_w "
          f"{qkv.sharding.spec} over {len(qkv.sharding.device_set)} devices")
    if len(placed["video"].sharding.device_set) != 4 or len(qkv.sharding.device_set) != 4:
        raise AssertionError("parameters or batch do not span the four devices")
    if qkv.addressable_shards[0].data.shape[-1] * 2 != qkv.shape[-1]:
        raise AssertionError("qkv_w is not split over the model axis")
    got, walls = _run_steps(trainer, batch)
    errs = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    print(f"mesh-train: one card {[round(x, 4) for x in ref]}; 2x2 mesh "
          f"{[round(x, 4) for x in got]}; max rel diff {max(errs):.2e} "
          f"(tol {TOL_MESH_LOSS:.0e}); mesh step median "
          f"{statistics.median(walls[1:]) * 1e3:.1f} ms")
    if max(errs) > TOL_MESH_LOSS:
        raise AssertionError("mesh losses differ from one card")


def phase_mesh_infer(ctx) -> None:
    """One 64-video batch with MeshConfig(data=4) against one card."""
    import dataclasses

    import jax

    from video_caption_tpu.config import MeshConfig
    from video_caption_tpu.engine import InferenceEngine

    cfg = serving_config()
    one = InferenceEngine(cfg, seed=SEED)
    one._video_cache_bytes = 0
    h_one = one.infer_batch_dispatch(ctx["batch_dirs"])
    toks_one = [np.asarray(x) for x in jax.device_get(list(h_one[0]))]
    want = [r.to_api_dict() for r in one.infer_batch_collect(h_one)]
    del one
    multi = InferenceEngine(dataclasses.replace(cfg, mesh=MeshConfig(data=4)), seed=SEED)
    t0 = time.perf_counter()
    h_multi = multi.infer_batch_dispatch(ctx["batch_dirs"])
    outs = list(h_multi[0])
    spans = {len(o.sharding.device_set) for o in outs}
    toks_multi = [np.asarray(x) for x in jax.device_get(outs)]
    got = [r.to_api_dict() for r in multi.infer_batch_collect(h_multi)]
    wall = time.perf_counter() - t0
    rows = sum(a.shape[0] for a in toks_one)
    same = sum(int((a == b).all(axis=-1).sum()) for a, b in zip(toks_one, toks_multi))
    print(f"mesh-infer: data=4 batch of {len(got)} (first call, compile included "
          f"{wall:.2f} s); decode outputs span {sorted(spans)} devices; "
          f"token rows identical to one card: {same}/{rows}; captions identical: "
          f"{sum(a == b for a, b in zip(got, want))}/{len(want)}")
    if spans != {4}:
        raise AssertionError("decode outputs do not span the four devices")
    if got != want:
        raise AssertionError("data-parallel captions differ from one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card mesh phases")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU backend (JAX platform is {devices[0].platform!r}); "
              f"refusing to run", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 2

    from video_caption_tpu.env import enable_compilation_cache, gpu_name_and_power_limit

    cache_dir = enable_compilation_cache()
    entries = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    print(f"card: {gpu_name_and_power_limit()}")
    print(f"jax {jax.__version__}; {len(devices)} x {devices[0].device_kind}; "
          f"compile cache {cache_dir} ({entries} entries at start)")

    if args.four_cards:
        phases = (("mesh-train", phase_mesh_train), ("mesh-infer", phase_mesh_infer))
    else:
        phases = (("serve", phase_serve), ("batch", phase_batch),
                  ("train", phase_train), ("numerics", phase_numerics))

    from video_caption_tpu.server.services.model_registry import MODEL_REGISTRY

    failed = []
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ctx = {
            "tmp": tmp,
            "serve_dirs": write_frames(tmp, SERVE_REQUESTS, seed=1),
            "batch_dirs": write_frames(tmp, BATCH_VIDEOS, seed=2),
            # the engine the HTTP path builds, shared by the later phases
            "engine": lambda: MODEL_REGISTRY.get_engine(serving_config()),
        }
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn(ctx)
                print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)
            except Exception:
                traceback.print_exc()
                print(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s",
                      flush=True)
                failed.append(name)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
