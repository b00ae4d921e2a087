"""Per-stage roofline: device time, FLOPs, HBM bytes, % of chip peak.

The analog of the reference's Nsight Compute roofline runs
(scripts/run_ncu.ps1:1-12,59-61 — ``--set roofline`` on ViT_Encoder /
GPT2_Decoder_Step): each pipeline stage gets {device_ms, flops, bytes,
pct_peak_flops, pct_peak_hbm} against the device's published peaks, plus a
**device-only** captions/s that excludes JPEG decode and the host->device
transfer.

FLOPs/bytes are analytic from the model geometry (exact for dense
transformers; XLA's compiled cost_analysis undercounts the training step,
see training_step_flops).
"""
from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import jax
import numpy as np

# Published dense peaks (no sparsity) per ``device_kind``, in FLOP/s and
# bytes/s. Source: NVIDIA H100 data sheet, SXM part, at its 700 W power
# limit; a card set below that limit cannot hold its top clock under load,
# so record ``power.limit`` beside every share computed from these.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12, "fp8": 1979e12, "tf32": 495e12, "hbm": 3.35e12,
    },
}


def chip_peaks(device_kind: Optional[str] = None) -> Dict[str, float]:
    """Peaks of ``device_kind`` (default: the first device's). A device
    that is not in PEAKS is an error, never a default."""
    kind = device_kind if device_kind is not None else jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def _device_peaks() -> Optional[Dict[str, float]]:
    """Peaks for roofline shares: the GPU's row, or None on the CPU test
    backend (its times are reported, never shares of a device peak)."""
    return None if jax.devices()[0].platform == "cpu" else chip_peaks()


# ---------------------------------------------------------------------------
# analytic FLOPs / bytes
# ---------------------------------------------------------------------------

def vit_encode_flops(model_cfg, num_frames: int) -> float:
    """Dense FLOPs of one video's encode (T frames through the ViT trunk +
    pool + head + prefix mapper)."""
    v = model_cfg.vit
    s, h, L = v.seq_len, v.embed_dim, v.depth
    patch_dim = v.patch_size * v.patch_size * v.in_chans
    per_frame = 2 * v.num_patches * patch_dim * h            # patch embed
    per_block = 24 * s * h * h + 4 * s * s * h               # qkv+proj+mlp / attn
    per_frame += L * per_block
    per_frame += 2 * h * v.out_dim                           # per-frame head share
    mapper = 2 * model_cfg.video_dim * model_cfg.mapper_out
    return num_frames * per_frame + mapper


def vit_encode_bytes(params, model_cfg, num_frames: int, batch: int) -> float:
    """HBM traffic estimate: weights once + activations twice per block."""
    enc = params["encoder"]
    w_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(enc))
    v = model_cfg.vit
    act = batch * num_frames * v.seq_len * v.embed_dim * 2   # bf16 activations
    return w_bytes + 2 * v.depth * act


def gpt2_step_flops(gcfg, kv_len: int) -> float:
    """One decode step, one row: qkv+attn-proj+mlp + cache attention + lm head."""
    h = gcfg.n_embd
    return gcfg.n_layer * (24 * h * h + 4 * h * kv_len) + 2 * h * gcfg.vocab_size


def decode_group_flops(gcfg, rows: int, num_beams: int, prefill_len: int,
                       max_new_tokens: int, max_len: int) -> float:
    """Dense FLOPs of one grouped decode program (static-length scan)."""
    h, L, V = gcfg.n_embd, gcfg.n_layer, gcfg.vocab_size
    r = rows * num_beams
    prefill = rows * (prefill_len * (L * 24 * h * h) + L * 2 * prefill_len * prefill_len * h
                      + 2 * prefill_len * h * V)
    # scan runs the full static max_new_tokens; attention reads the static cache
    per_step = L * (24 * h * h + 4 * h * max_len) + 2 * h * V
    return prefill + r * max_new_tokens * per_step


def training_step_flops(mc, batch: int, num_frames: int, cap_len: int,
                        unfreeze_last_gpt2: int = 0) -> float:
    """Dense FLOPs of one mapper-trainer step (compute_loss + backward).

    Why analytic: XLA's compiled cost_analysis() has reported ~2.1 TFLOP
    for the bs=64 step whose frozen ViT forward ALONE is 512 frames x 35.1
    GFLOP = 18 TFLOP (vit_encode_flops) — an 8.5x undercount. Composition:
    - encoder forward only (stop_gradient: XLA drops its backward),
    - GPT-2 teacher-forcing forward at S = prefix + caption tokens,
    - backward as dgrad through EVERY decoder layer (the prefix gradient
      must reach the mapper) ~= 1x forward matmul cost; wgrad only for the
      unfrozen tail blocks (mapper/proj wgrad is negligible)."""
    g = mc.gpt2
    h, L, V = g.n_embd, g.n_layer, g.vocab_size
    s = mc.prefix_len + cap_len
    enc = batch * vit_encode_flops(mc, num_frames)
    per_block = 24 * h * h * s + 4 * s * s * h
    fwd = L * per_block + 2 * s * h * V
    dgrad = fwd
    wgrad = unfreeze_last_gpt2 * per_block
    return enc + batch * (fwd + dgrad + wgrad)


def decode_group_bytes(params, gcfg, rows: int, num_beams: int,
                       max_new_tokens: int, max_len: int) -> float:
    """Weight traffic dominates: whole decoder read once per step, plus the
    static KV cache read per row per step."""
    dec = params["decoder"]
    w_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(dec))
    kv = rows * num_beams * gcfg.n_layer * 2 * max_len * gcfg.n_embd * 2  # bf16 k+v
    return max_new_tokens * (w_bytes + kv)


def decode_unified_cost(params, gcfg, group_list, batch: int,
                        prefix_len: int) -> tuple:
    """(flops, bytes) of the unified mixed-policy program: all groups run a
    single scan to the longest horizon; weights stream ONCE per step."""
    h, L, V = gcfg.n_embd, gcfg.n_layer, gcfg.vocab_size
    l_max = max(ids.shape[1] for _, _, ids, _ in group_list)
    s0 = prefix_len + l_max
    n_max = max(dp.max_new_tokens for dp, *_ in group_list)
    i_tot = sum(batch * len(idxs) for _, idxs, *_ in group_list)
    r_tot = sum(batch * len(idxs) * dp.num_beams for dp, idxs, *_ in group_list)
    dec = params["decoder"]
    w_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(dec))

    prefill_flops = i_tot * (s0 * L * 24 * h * h + L * 2 * s0 * s0 * h + 2 * s0 * h * V)
    step_flops = r_tot * (L * 24 * h * h + 2 * h * V)
    for dp, idxs, *_ in group_list:
        rg = batch * len(idxs) * dp.num_beams
        step_flops += rg * L * 4 * h * (s0 + dp.num_beams * n_max)
    flops = prefill_flops + n_max * step_flops

    gen_kv = r_tot * n_max * L * 2 * h * 2        # bf16 interleaved K|V
    pre_kv = i_tot * s0 * L * 2 * h * 2
    # prefill reads the weights once; each of the n_max steps reads weights
    # ONCE for every group plus both cache regions
    bytes_ = w_bytes + n_max * (w_bytes + gen_kv + pre_kv)
    return flops, bytes_


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _timed(fn, trials: int) -> tuple:
    """(seconds per execution, last result) over a warmed window.

    One untimed call compiles and warms; then ``trials`` executions are
    dispatched back to back and the window closes on ``block_until_ready``
    of the last result. Programs run in dispatch order on one device, so
    the window is device-bound, as the engine's pipelined dispatch is."""
    jax.block_until_ready(fn())
    out = None
    t0 = time.perf_counter()
    for _ in range(trials):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / trials, out


def measure_roofline(engine, batch: int = 16, trials: int = 5,
                     report_path: Optional[str] = "reports/roofline.json",
                     ) -> Dict[str, Any]:
    """Per-stage device-time roofline on a device-resident batch.

    Returns {"stages": [...], "device_caps_per_sec": float, ...}. Programs
    must already be compiled (run ``engine.warmup`` / one infer first) or the
    timed window pays compile time.
    """
    import jax.numpy as jnp

    mc = engine.model_cfg
    c = engine.config
    video = jnp.asarray(
        np.random.RandomState(0).randint(
            0, 255, (batch, c.num_frames, 3, c.image_size, c.image_size), np.uint8
        )
    )
    jax.block_until_ready(video)
    peaks = _device_peaks()
    stages: List[Dict[str, Any]] = []

    def add_stage(name, secs, flops, bytes_):
        row = {
            "stage": name,
            "device_ms": round(secs * 1e3, 3),
            "gflops": round(flops / 1e9, 3),
            "gbytes": round(bytes_ / 1e9, 4),
            "tflops_per_sec": round(flops / secs / 1e12, 3),
            "gbytes_per_sec": round(bytes_ / secs / 1e9, 2),
        }
        if peaks:
            row["pct_peak_flops"] = round(100 * flops / secs / peaks["bf16"], 2)
            row["pct_peak_hbm"] = round(100 * bytes_ / secs / peaks["hbm"], 2)
        stages.append(row)
        return row

    # stage 1: encode (ViT trunk + pool + head + prefix mapper + norm)
    t_enc, prefix = _timed(lambda: engine._prefix_fn(engine.params, video), trials)
    add_stage("encode", t_enc,
              batch * vit_encode_flops(mc, c.num_frames),
              vit_encode_bytes(engine.params, mc, c.num_frames, batch))

    # stage 2..: one grouped decode program per distinct policy, measured
    # through the engine's own group-dispatch path (run_decode_group)
    _, group_list, _ = engine._fused_infer_program()
    total = t_enc
    dec_flops = dec_bytes = 0.0
    for gi, (dp, idxs, ids_arr, mask_arr) in enumerate(group_list):
        rows = len(idxs)
        rng = jax.random.PRNGKey(hash(("roofline", gi)) & 0x7FFFFFFF)

        def run(d=dp, ia=ids_arr, ma=mask_arr, key=rng):
            # throwaway key: must NOT consume engine._rng (would shift the
            # engine's sampled outputs for subsequent seeded inferences)
            return engine.run_decode_group(prefix, d, ia, ma, key)

        t_g, _ = _timed(run, trials)
        total += t_g
        n_rows = batch * rows
        prefill_len = mc.prefix_len + ids_arr.shape[1]
        max_len = prefill_len + dp.max_new_tokens  # generate.py:103 static cache
        g_flops = decode_group_flops(mc.gpt2, n_rows, dp.num_beams, prefill_len,
                                     dp.max_new_tokens, max_len)
        g_bytes = decode_group_bytes(engine.params, mc.gpt2, n_rows,
                                     dp.num_beams, dp.max_new_tokens, max_len)
        dec_flops += g_flops
        dec_bytes += g_bytes
        add_stage(
            f"decode[beams={dp.num_beams},new={dp.max_new_tokens},rows={rows}]",
            t_g, g_flops, g_bytes)

    # pipelined grouped decode: the engine DISPATCHES its group programs
    # async back-to-back and blocks once, so the groups' host dispatch gaps
    # overlap device work. This is the number device_caps_per_sec uses.
    if len(group_list) > 1 and not engine._unified_eligible(group_list):
        rngs_p = [jax.random.PRNGKey(200 + g) for g in range(len(group_list))]

        def run_pipelined():
            outs = [engine.run_decode_group(prefix, d, ia, ma, key)
                    for (d, _, ia, ma), key in zip(group_list, rngs_p)]
            return outs[-1]   # block only on the LAST program

        t_pipe, _ = _timed(run_pipelined, trials)
        add_stage("decode[grouped,pipelined]", t_pipe, dec_flops, dec_bytes)
        total = t_enc + t_pipe

    # unified mixed-policy program (opt-in alternative to the grouped
    # programs): ONE program for every group — measured against the
    # pipelined grouped dispatch above
    unified = engine._unified_eligible(group_list)
    if unified:
        from video_caption_tpu.decode.unified import generate_unified

        prompts = tuple((jnp.asarray(i), jnp.asarray(m))
                        for _, _, i, m in group_list)
        dps = tuple(dp for dp, *_ in group_list)
        keys = tuple(jax.random.PRNGKey(100 + g) for g in range(len(group_list)))

        def run_u():
            return generate_unified(engine.params["decoder"], mc.gpt2, prefix,
                                    prompts, dps, keys)

        t_u, _ = _timed(run_u, trials)
        uf, ub = decode_unified_cost(engine.params, mc.gpt2, group_list, batch,
                                     mc.prefix_len)
        add_stage("decode[unified]", t_u, uf, ub)
        total = t_enc + t_u   # the engine runs ONLY the unified program

    result = {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "batch": batch,
        "num_frames": c.num_frames,
        "trials": trials,
        "peaks": peaks,
        "stages": stages,
        "device_total_ms": round(total * 1e3, 2),
        "device_caps_per_sec": round(batch / total, 3),
    }
    if report_path:
        p = Path(report_path)
        p.parent.mkdir(exist_ok=True)
        p.write_text(json.dumps(result, indent=1) + "\n")
    return result


def measure_training_step(
    batch: int = 8, num_frames: int = 8, trials: int = 10,
    yuv420_wire: bool = True, unfreeze_last_gpt2: int = 0,
    report_path: Optional[str] = "reports/roofline_training.json",
    dtype: str = "float32",
) -> Dict[str, Any]:
    """Training-step roofline at full production geometry (frozen ViT-B/16 +
    mapper + GPT-2 teacher forcing — the product trainer's stage).

    Reports BOTH timings the serving roofline separates: ``device_ms``
    (batch pre-resident on device — chip speed) and ``e2e_ms`` (host batch
    shipped per step — what a real epoch pays; the gap is the transfer).
    FLOPs are analytic (training_step_flops); XLA's compiled cost analysis
    is recorded beside them as ``xla_cost_gflops``. Reference
    counterpart: no training profile exists in the reference at all; this is
    the ncu-roofline treatment applied to train_caption_mapper.py:276-306.
    """
    import jax.numpy as jnp

    from video_caption_tpu.config import default_inference_config
    from video_caption_tpu.engine import model_config_from_inference
    from video_caption_tpu.models import caption_model as cm
    from video_caption_tpu.preprocessing.yuv420 import packed_plane_len
    from video_caption_tpu.training.mapper_trainer import MapperTrainer, TrainArgs

    inf_cfg = default_inference_config(ckpt="none.pt", num_frames=num_frames)
    mc = model_config_from_inference(inf_cfg)
    # compute dtype: ALWAYS replace — the serving default config is already
    # bf16 compute, so overriding only when dtype != "float32" would run the
    # "float32" rows in bf16 too. Mixed precision: fp32 master params (init
    # below), compute in ``dtype``, autodiff of the cast returns fp32 grads,
    # optimizer math stays fp32. On the GPU a float32 matmul runs in TF32
    # unless jax_default_matmul_precision says "highest"; the float32 rows'
    # share is therefore stated against the TF32 peak.
    import dataclasses as _dc

    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.dtype(dtype)
    mc = _dc.replace(
        mc, vit=_dc.replace(mc.vit, dtype=dt),
        gpt2=_dc.replace(mc.gpt2, dtype=dt))
    params = cm.init_caption_model(jax.random.PRNGKey(0), mc)
    trainer = MapperTrainer(
        mc, params,
        TrainArgs(unfreeze_last_gpt2=unfreeze_last_gpt2,
                  out_dir=tempfile.mkdtemp(prefix="roofline_train_")),
    )
    rng = np.random.RandomState(0)
    size = inf_cfg.image_size
    if yuv420_wire:
        vid = rng.randint(0, 255,
                          (batch, num_frames, packed_plane_len(size)), np.uint8)
    else:
        vid = rng.randint(0, 255, (batch, num_frames, 3, size, size), np.uint8)
    host_batch = {
        "video": vid,
        "caption_ids": rng.randint(0, 50000, (batch, 24)).astype(np.int32),
        "attention_mask": np.ones((batch, 24), np.int32),
    }

    from video_caption_tpu.parallel.mesh import shard_batch

    def step_host():
        # params/opt_state are donated: thread them like the real loop does
        b = shard_batch(host_batch, trainer.mesh)
        trainer.params, trainer.opt_state, loss = trainer.train_step(
            trainer.params, trainer.opt_state, b)
        return loss

    t_e2e, _ = _timed(step_host, trials)

    # prefetched e2e: upload batch N+1 (async device_put) BEFORE stepping
    # batch N, so the transfer overlaps device compute — the double-buffered
    # input pipeline a real epoch should run (the plain e2e above re-pays
    # the full transfer serially every step)
    def run_prefetched(n_steps: int) -> float:
        nxt = jax.device_put(host_batch)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            cur, nxt = nxt, jax.device_put(host_batch)
            trainer.params, trainer.opt_state, loss = trainer.train_step(
                trainer.params, trainer.opt_state, cur)
        jax.block_until_ready(loss)
        return (time.perf_counter() - t0) / n_steps

    run_prefetched(2)  # warm
    t_pre = min(run_prefetched(max(trials // 2, 3)) for _ in range(3))

    dev_batch = jax.tree.map(jnp.asarray, host_batch)
    jax.block_until_ready(dev_batch)

    def step_dev():
        trainer.params, trainer.opt_state, loss = trainer.train_step(
            trainer.params, trainer.opt_state, dev_batch)
        return loss

    # device-only: state threads through, so steps serialize on device
    t_dev, _ = _timed(step_dev, trials)

    # FLOPs: analytic (training_step_flops docstring; xla_cost_gflops is
    # kept for transparency, never used for the MFU headline)
    flops = training_step_flops(
        mc, batch, num_frames, host_batch["caption_ids"].shape[1],
        unfreeze_last_gpt2)
    xla_flops = None
    try:
        lowered = trainer.train_step.lower(
            trainer.params, trainer.opt_state, dev_batch)
        ca = lowered.compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        xla_flops = float(ca.get("flops", 0.0)) or None
    except Exception:   # cost_analysis availability varies by backend
        pass

    peaks = _device_peaks()
    wire_bytes = sum(
        v.size * v.dtype.itemsize for v in host_batch.values()
    )
    result = {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "batch": batch, "num_frames": num_frames,
        "yuv420_wire": yuv420_wire,
        "unfreeze_last_gpt2": unfreeze_last_gpt2,
        "dtype": dtype,
        "trials": trials,
        "device_ms": round(t_dev * 1e3, 2),
        "e2e_ms": round(t_e2e * 1e3, 2),
        "e2e_prefetch_ms": round(t_pre * 1e3, 2),
        "wire_mb_per_step": round(wire_bytes / 1e6, 2),
        "gflops": round(flops / 1e9, 1),
        "xla_cost_gflops": round(xla_flops / 1e9, 1) if xla_flops else None,
        "tflops_per_sec": round(flops / t_dev / 1e12, 2),
    }
    if peaks:
        peak = peaks["bf16"] if dtype == "bfloat16" else peaks["tf32"]
        result["pct_peak_flops"] = round(100 * flops / t_dev / peak, 2)
    if report_path:
        p = Path(report_path)
        p.parent.mkdir(exist_ok=True)
        p.write_text(json.dumps(result, indent=1) + "\n")
    return result
