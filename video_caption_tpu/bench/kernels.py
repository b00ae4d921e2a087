"""Device time of each hot op at its production shape, from a profiler trace.

Covers the ops that once had hand-written kernels — their plain XLA
forms as the model runs them, plus the library alternatives for encoder
attention (cuDNN fused attention through ``jax.nn.dot_product_attention``
and the Triton flash-attention kernel that ships with JAX in
``jax.experimental.pallas.ops.gpu.attention``) — and two calibration ops (a
large bf16 matmul and a large copy) that show what the card reaches.

Each case is compiled and warmed, timed over a window closed by
``block_until_ready`` (wall), then traced over a second window; device time
per call is the union of its kernel intervals over the window divided by
the call count (bench/trace.py). FLOPs and bytes are what the algorithm
needs, computed from the shapes; the roofline share is the larger of
FLOPs / peak FLOP/s and bytes / peak bytes/s over device time.

Usage (on the card): python -m video_caption_tpu.bench.kernels [--out FILE]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp

from video_caption_tpu.bench import trace as tr
from video_caption_tpu.bench.roofline import chip_peaks
from video_caption_tpu.models import gpt2 as g2
from video_caption_tpu.models import vit as vt

# Production geometry: 64 videos x 16 frames through ViT-B/16 at 224 px;
# GPT-2 124M decoding the serving presets at batch 64.
VIDEOS, FRAMES = 64, 16
N_FRAMES = VIDEOS * FRAMES
PREFILL = 4 + 12        # prefix tokens + a GPT-2 BPE prompt
BEAMS, NEW_BEAM = 4, 40  # "detailed" preset
NEW_SAMPLE = 24         # "natural" preset
LM_ROWS = 384           # 64 videos x 2 beam presets x 3 beams (core mix)
ITERS = 20              # calls per timed and per traced window

Case = Tuple[str, Callable, tuple, float, float]   # name, fn, args, flops, bytes


def _rand(key, shape, dtype=jnp.bfloat16, scale=1.0):
    return (jax.random.normal(jax.random.PRNGKey(key), shape, jnp.float32) * scale).astype(dtype)


def encoder_attention_cases() -> List[Case]:
    cfg = vt.ViTConfig()
    n, s, nh, hd = N_FRAMES, cfg.seq_len, cfg.num_heads, cfg.head_dim
    h = cfg.embed_dim
    qkv = _rand(1, (n, s, 3 * h))
    flops = 4.0 * n * s * s * h
    bytes_ = 2.0 * n * s * (3 * h + h)

    def plain(x):
        return vt._attention_core(x, cfg)

    def split(x):
        r = x.reshape(n, s, 3, nh, hd)
        return r[:, :, 0], r[:, :, 1], r[:, :, 2]

    def cudnn(x):
        q, k, v = split(x)
        out = jax.nn.dot_product_attention(q, k, v, implementation="cudnn")
        return out.reshape(n, s, h)

    def triton(x):
        from jax.experimental.pallas.ops.gpu.attention import mha

        q, k, v = split(x)
        sp = 256   # the kernel's blocks tile the sequence: pad 197 -> 256
        pad = ((0, 0), (0, sp - s), (0, 0), (0, 0))
        q, k, v = (jnp.pad(t, pad) for t in (q, k, v))
        seg = jnp.broadcast_to((jnp.arange(sp) < s).astype(jnp.int32), (n, sp))
        out = mha(q, k, v, seg, sm_scale=hd ** -0.5)
        return out[:, :s].reshape(n, s, h)

    return [
        ("encoder_attention/xla_einsum", jax.jit(plain), (qkv,), flops, bytes_),
        ("encoder_attention/cudnn (library)", jax.jit(cudnn), (qkv,), flops, bytes_),
        ("encoder_attention/triton mha (library)", jax.jit(triton), (qkv,), flops, bytes_),
    ]


def pool_cases() -> List[Case]:
    cfg = vt.ViTConfig()
    tokens = _rand(2, (N_FRAMES, cfg.seq_len, cfg.embed_dim))
    out = []
    for mode, read in (("gap", cfg.seq_len - 1), ("cls", 1)):
        c = dataclasses.replace(cfg, pool=mode)
        fn = jax.jit(lambda t, c=c: vt.pool_temporal(t, VIDEOS, FRAMES, c))
        out.append((f"fused_pool/{mode}", fn, (tokens,),
                    float(N_FRAMES * read * cfg.embed_dim),
                    2.0 * N_FRAMES * read * cfg.embed_dim))
    return out


def projector_case() -> Case:
    d_in, d_out = 256, 4 * 768
    emb = _rand(3, (VIDEOS, d_in), jnp.float32)
    w, b = _rand(4, (d_in, d_out), scale=0.02), _rand(5, (d_out,))
    fn = jax.jit(lambda e, w, b: e @ w + b)
    return ("prefix_projector/xla_gemm", fn, (emb, w, b),
            2.0 * VIDEOS * d_in * d_out, 2.0 * d_in * d_out + 4.0 * VIDEOS * (d_in + d_out))


def beam_attention_case() -> Case:
    cfg = g2.GPT2Config()
    L, H, r = cfg.n_layer, cfg.n_embd, VIDEOS * BEAMS
    q = _rand(6, (r, H))
    pk, pv = _rand(7, (L, VIDEOS, PREFILL, H)), _rand(8, (L, VIDEOS, PREFILL, H))
    gkv = _rand(9, (L, NEW_BEAM, 2, r, H))
    valid = jnp.ones((VIDEOS, PREFILL), jnp.int32)
    anc = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[:, None], (r, NEW_BEAM))
    t = jnp.int32(NEW_BEAM - 1)   # last step: every generated column live

    def step_attention(q, pk, pv, gkv, valid, anc):
        sel = g2.ancestry_mask(anc, VIDEOS, BEAMS, t)
        hmask = g2.head_block_mask(cfg)
        outs = [g2._beam_attend(q, pk[l], pv[l], gkv[l, :, 0], gkv[l, :, 1],
                                valid, sel, hmask, BEAMS, cfg) for l in range(L)]
        return jnp.stack(outs)

    # needed work per step: every row attends its prefill and N generated
    # columns in all 12 layers; bytes: both cache regions read once
    flops = L * 4.0 * r * H * (PREFILL + NEW_BEAM)
    bytes_ = L * 2.0 * 2 * (VIDEOS * PREFILL * H + NEW_BEAM * r * H)
    return ("beam_attention/xla (12 layers, one step)", jax.jit(step_attention),
            (q, pk, pv, gkv, valid, anc), flops, bytes_)


def lm_head_cases() -> List[Case]:
    cfg = g2.GPT2Config()
    wte_t = g2.lm_head_t({"wte": _rand(10, (cfg.vocab_size, cfg.n_embd), scale=0.02)}, cfg)
    x = _rand(11, (LM_ROWS, cfg.n_embd))
    vp = wte_t.shape[1]
    flops = 2.0 * LM_ROWS * cfg.n_embd * vp
    gemm_bytes = 2.0 * cfg.n_embd * vp + 4.0 * LM_ROWS * vp
    stats = jax.jit(lambda x, w: g2.lm_stats(x, w, cfg, need_row_stats=True))
    gemm = jax.jit(lambda x, w: g2._lm_logits_t(x, w, cfg.vocab_size))
    return [
        ("lm_head/xla logits+stats", stats, (x, wte_t), flops, gemm_bytes),
        ("lm_head/xla logits only", gemm, (x, wte_t), flops, gemm_bytes),
    ]


def decode_cases() -> List[Case]:
    """The greedy/sampled step's attention (former decode_attention kernel)
    and the whole single-token layer stack (former decode_layer kernel)."""
    cfg = g2.GPT2Config()
    L, nh, hd, H = cfg.n_layer, cfg.n_head, cfg.head_dim, cfg.n_embd
    max_len = PREFILL + NEW_SAMPLE
    b = VIDEOS
    q = _rand(12, (b, 1, nh, hd))
    kv = _rand(13, (L, b, max_len, 2, nh, hd))
    valid = jnp.ones((b, max_len), jnp.int32)
    blk = {"proj_w": jnp.eye(H, dtype=jnp.bfloat16), "proj_b": jnp.zeros((H,), jnp.bfloat16)}
    off = jnp.int32(max_len - 1)

    def attn(q, kv, valid):
        return jnp.stack([g2._attend(q, kv[l, :, :, 0], kv[l, :, :, 1], blk, off,
                                     valid, cfg) for l in range(L)])

    attn_flops = L * (4.0 * b * H * max_len + 2.0 * b * H * H)
    attn_bytes = L * (2.0 * 2 * b * max_len * H + 2.0 * H * H)

    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          g2.init_gpt2_params(jax.random.PRNGKey(14), cfg))
    wte_t = g2.lm_head_t(params, cfg)
    emb = _rand(15, (b, 1, H))
    pos = jnp.full((b, 1), max_len - 1, jnp.int32)
    cache = {"kv": kv}

    def step(params, wte_t, emb, cache, valid):
        (logits, wmax, _, _), cache = g2.gpt2_forward(
            params, emb, pos, valid, cache, off, cfg, wte_t=wte_t,
            return_stats=True, row_stats=False)
        return wmax, cache

    w_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(params["blocks"]))
    step_flops = b * (L * (24.0 * H * H + 4.0 * H * max_len) + 2.0 * H * wte_t.shape[1])
    step_bytes = w_bytes + wte_t.size * 2 + L * 2.0 * 2 * b * max_len * H
    return [
        ("decode_attention/xla (12 layers, one step)", jax.jit(attn), (q, kv, valid),
         attn_flops, attn_bytes),
        ("decode_layer/xla greedy step incl. LM head", jax.jit(step),
         (params, wte_t, emb, cache, valid), step_flops, step_bytes),
    ]


def calibration_cases() -> List[Case]:
    a, b = _rand(16, (8192, 8192)), _rand(17, (8192, 8192))
    big = _rand(18, (1 << 29,))     # 1 GiB of bf16
    return [
        ("calibration/bf16 matmul 8192^3", jax.jit(lambda a, b: a @ b), (a, b),
         2.0 * 8192 ** 3, 3 * 2.0 * 8192 ** 2),
        ("calibration/copy 1 GiB", jax.jit(lambda x: x * 2), (big,), float(big.size),
         2.0 * big.nbytes),
    ]


def measure(name, fn, args, flops, bytes_, peaks, iters: int) -> Dict:
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / iters
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(iters):
                out = fn(*args)
            jax.block_until_ready(out)
        events = tr.kernel_events(tr.latest_xspace(d))
    dev = tr.device_summary(events)
    dev_s = dev["busy_ns"] / iters / 1e9
    t_flops, t_bytes = flops / peaks["bf16"], bytes_ / peaks["hbm"]
    top = list(tr.kernel_table(events).items())[:4]
    return {
        "op": name, "compile_s": compile_s, "wall_us": wall * 1e6,
        "device_us": dev_s * 1e6, "kernels_per_call": dev["kernels"] / iters,
        "idle_share": dev["idle_share"], "gflop": flops / 1e9, "mbytes": bytes_ / 1e6,
        "bound": "compute" if t_flops >= t_bytes else "memory",
        "roofline_share": max(t_flops, t_bytes) / dev_s,
        "top_kernels": [(k, v["count"] // iters, v["total_ns"] / iters / 1e3) for k, v in top],
    }


def main(argv=None) -> int:
    from video_caption_tpu.env import (
        assert_core_runtime_ready, enable_compilation_cache, gpu_name_and_power_limit,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--out", default="", help="also write the rows to this JSON file")
    args = p.parse_args(argv)
    assert_core_runtime_ready(require_gpu=True)
    enable_compilation_cache()
    card = gpu_name_and_power_limit()
    peaks = chip_peaks()
    print(card, flush=True)
    rows = []
    groups = (calibration_cases, encoder_attention_cases, pool_cases,
              lambda: [projector_case()], lambda: [beam_attention_case()],
              lm_head_cases, decode_cases)
    for group in groups:
        for case in group():
            try:
                row = measure(*case, peaks, ITERS)
            except Exception as exc:   # report the case, measure the rest
                row = {"op": case[0], "error": f"{type(exc).__name__}: {exc}"[:400]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    result = {"card": card, "device_kind": jax.devices()[0].device_kind,
              "jax": jax.__version__, "peaks": peaks, "rows": rows}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
