"""Accuracy alignment of the deployed bf16 programs against a float32
reference — the check the reference reserved but never implemented
(core/scripts/accuracy_alignment.py:5, model_loader.py:46-48 "torch vs
optimized backend comparison").

The reference runs in float32 under ``jax.default_matmul_precision
("highest")``: on a GPU a float32 matmul otherwise runs in TF32 (about three
significant digits), which would loosen the reference itself. Each leg
reports the error relative to the reference's largest magnitude against a
stated tolerance:

- encoder jit-fp32 vs eager (1e-3): the compiled program against op-by-op
  execution of the same float32 math; only reassociation differs.
- encoder bf16 vs fp32 and prefix bf16 vs fp32 (5e-2): the deployment gate.
  bf16 keeps ~3 significant digits and 12 ViT blocks compound the rounding
  to ~1e-2.
- beam-step logits bf16 vs fp32 (5e-2): one beam decode step (4 beams over
  half-filled split caches) through 12 GPT-2 blocks and the LM head.

Usage: python -m video_caption_tpu.bench.accuracy_alignment [--image_size 224]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger(__name__)

TOL_JIT = 1e-3
TOL_BF16 = 5e-2


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def beam_step_logits(dec, cfg, seed: int = 2, videos: int = 4, beams: int = 4,
                     prefill: int = 16, gen: int = 8):
    """Logits [videos*beams, vocab] of one beam step at column gen//2 over
    seeded random split caches, computed in ``cfg.dtype``."""
    from video_caption_tpu.models import gpt2 as g2

    h, L, r = cfg.n_embd, cfg.n_layer, videos * beams
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    cast = lambda x: x.astype(cfg.dtype)  # noqa: E731
    pkv = {"k": cast(jax.random.normal(keys[0], (L, videos, prefill, h)) * 0.5),
           "v": cast(jax.random.normal(keys[1], (L, videos, prefill, h)) * 0.5)}
    cache = {"kv": cast(jax.random.normal(keys[2], (L, gen, 2, r, h)) * 0.5)}
    tok = cast(jax.random.normal(keys[3], (r, h)) * 0.02)
    anc = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[:, None], (r, gen))
    t = gen // 2
    logits, _ = g2.gpt2_beam_step(
        dec, tok, jnp.full((r,), prefill + t, jnp.int32), pkv,
        jnp.ones((videos, prefill), jnp.int32), cache, anc, jnp.int32(t), beams,
        cfg, wte_t=g2.lm_head_t(dec, cfg))
    return logits[:, :cfg.vocab_size]


def check_alignment(image_size: int = 224, num_frames: int = 4, seed: int = 0,
                    engine=None, eager: bool = True) -> Dict:
    """Run every leg. With ``engine`` the bf16 side is that engine's own
    parameters and prefix program, and the reference is its parameter
    init in float32; otherwise both come from a seeded init. ``eager=False``
    skips the op-by-op leg (chip_smoke.py, which runs under a time limit,
    leaves it to the CLI and the CPU tests: eager mode compiles and
    dispatches every op separately)."""
    from video_caption_tpu.models import caption_model as cm
    from video_caption_tpu.models import gpt2 as g2
    from video_caption_tpu.models import vit as vt

    if engine is not None:
        from video_caption_tpu.engine import load_params

        mc16 = engine.model_cfg
        mc32 = dataclasses.replace(
            mc16, vit=dataclasses.replace(mc16.vit, dtype=jnp.float32),
            gpt2=dataclasses.replace(mc16.gpt2, dtype=jnp.float32))
        p32 = load_params(engine.config, mc32, seed=seed)
        p16 = engine.params
        image_size = engine.config.image_size
        prefix16 = engine.compute_prefix
    else:
        mc32 = cm.CaptionModelConfig(
            vit=vt.ViTConfig(image_size=image_size, dtype=jnp.float32),
            gpt2=g2.GPT2Config(dtype=jnp.float32))
        mc16 = dataclasses.replace(
            mc32, vit=dataclasses.replace(mc32.vit, dtype=jnp.bfloat16),
            gpt2=dataclasses.replace(mc32.gpt2, dtype=jnp.bfloat16))
        p32 = cm.init_caption_model(jax.random.PRNGKey(seed), mc32)
        p16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p32)
        prefix_fn = jax.jit(lambda p, v: cm.video_to_prefix(p, v, mc16))
        prefix16 = lambda v: prefix_fn(p16, v)  # noqa: E731
    video = jnp.asarray(np.random.RandomState(seed + 1).randint(
        0, 256, (2, num_frames, 3, image_size, image_size), np.uint8))

    results: Dict[str, Dict] = {}

    def record(name: str, got, ref, tol: float):
        err = rel_err(got, ref)
        ok = bool(np.isfinite(err) and err <= tol)
        results[name] = {"rel_err": err, "tol": tol, "ok": ok}
        log.info("%-34s rel_err=%.2e (tol %.0e) %s", name, err, tol, "OK" if ok else "FAIL")

    with jax.default_matmul_precision("highest"):
        ref_emb = jax.jit(lambda p, v: cm.encode_video(p, v, mc32))(p32, video)
        ref_prefix = jax.jit(lambda p, v: cm.video_to_prefix(p, v, mc32))(p32, video)
        ref_logits = jax.jit(lambda d: beam_step_logits(d, mc32.gpt2))(p32["decoder"])
        if eager:
            with jax.disable_jit():
                eager_emb = cm.encode_video(p32, video, mc32)
            record("encoder jit-fp32 vs eager", ref_emb, eager_emb, TOL_JIT)
    record("encoder bf16 vs fp32",
           jax.jit(lambda p, v: cm.encode_video(p, v, mc16))(p16, video), ref_emb, TOL_BF16)
    record("prefix bf16 vs fp32", prefix16(video), ref_prefix, TOL_BF16)
    logits = jax.jit(lambda d: beam_step_logits(d, mc16.gpt2))(p16["decoder"])
    record("beam-step logits bf16 vs fp32", logits, ref_logits, TOL_BF16)
    results["beam-step argmax agreement"] = {"rate": float(np.mean(
        np.argmax(np.asarray(logits), -1) == np.argmax(np.asarray(ref_logits), -1)))}
    results["all_ok"] = all(v["ok"] for v in results.values() if "ok" in v)
    return results


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_frames", type=int, default=4)
    args = p.parse_args(argv)
    results = check_alignment(args.image_size, args.num_frames)
    print(json.dumps(results, indent=1))
    return 0 if results["all_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
