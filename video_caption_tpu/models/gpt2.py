"""GPT-2 decoder with a static-shape KV cache.

Capability parity with the reference decoder (src/models/text_decoder.py):
prefix-conditioned generation through ``inputs_embeds`` and teacher-forcing
loss. The reference leans on HF ``GPT2LMHeadModel`` with *dynamic*
``past_key_values`` (text_decoder.py:131-144) — under XLA that would
recompile every step, so this module is built around:

- a **preallocated device-resident KV cache** of static ``max_len``
  (SURVEY §5.7): ``{'kv': [L, B, max_len, 2, n_head, head_dim]}`` with K and
  V interleaved so each decode layer issues one cache write (init_cache),
- one unified forward for prefill (S>1 at offset 0) and decode (S=1 at
  offset t) so a single compiled program serves the scan-based decode loop,
- ``lax.scan`` over stacked block parameters AND the per-layer cache slices
  (cache slices ride the scan xs/ys — no Python loop over 12 layers),
- fp32 softmax + fp32 logits for decode-policy numerical stability.

Weight layout: every projection is stored ``[in, out]`` — this matches HF
GPT-2's Conv1D weights directly (the layout trap noted in SURVEY §7 hard
part 4); torch ``nn.Linear`` weights are transposed by models/convert.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, Any]
Cache = Dict[str, jax.Array]


@dataclass(frozen=True)
class GPT2Config:
    """Geometry of HF ``gpt2`` base (SURVEY §2.3)."""

    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: Any = jnp.bfloat16
    ln_eps: float = 1e-5
    deferred_cache_write: bool = False
    """Greedy/sampled decode step: hold every layer's new K/V in registers
    and write the WHOLE stack with ONE dynamic_update_slice after the layer
    loop (attention handles the current token as an explicit extra column —
    ``_attend_deferred``). Trades the 12 per-layer slab writes, each with a
    fixed launch cost, for one write plus a small stack concat. Off by
    default; token parity with the per-layer-write path is tested either
    way."""
    spmd_decode: bool = False
    """Decode will run under a multi-device mesh (engine sets this when a
    mesh is active): token selection uses the batch-preserving candidate
    gather — the single-chip flat-row form (lp._gather_windows docstring)
    flattens batch x window dims across the sharding and makes GSPMD
    all-gather the gathered candidate windows every step."""
    sample_split_cache: bool = False
    """Greedy/sampled (K=1) decode with the beam path's SPLIT cache: prefill
    K/V stored once per row ([L,B,S0,H], heads merged, never rewritten) and
    a TIME-major merged-H generated-region cache [L,N,2,B,H] whose per-step
    write is one contiguous [1,1,2,B,H] slab per layer. At K=1 the cache is
    ~6x smaller than the beam path's, the step is latency-bound, and split
    pays two attention programs (prefill + gen) where contig pays one.
    Default = contig (False); both paths stay token-parity-gated. Attention in split mode
    uses the head-blocked merged-H form (head_block_mask) with a plain
    causal mask — no ancestry machinery at K=1."""

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def init_gpt2_params(key: jax.Array, cfg: GPT2Config) -> Params:
    k = iter(jax.random.split(key, 8))
    h, d, mlp = cfg.n_embd, cfg.n_layer, 4 * cfg.n_embd
    init = jax.nn.initializers.normal(stddev=0.02)

    def nrm(key, shape):
        return init(key, shape, jnp.float32)

    return {
        "wte": nrm(next(k), (cfg.vocab_size, h)),
        "wpe": nrm(next(k), (cfg.max_position_embeddings, h)),
        "blocks": {
            "ln1_scale": jnp.ones((d, h)),
            "ln1_bias": jnp.zeros((d, h)),
            "attn_w": nrm(next(k), (d, h, 3 * h)),
            "attn_b": jnp.zeros((d, 3 * h)),
            "proj_w": nrm(next(k), (d, h, h)),
            "proj_b": jnp.zeros((d, h)),
            "ln2_scale": jnp.ones((d, h)),
            "ln2_bias": jnp.zeros((d, h)),
            "fc_w": nrm(next(k), (d, h, mlp)),
            "fc_b": jnp.zeros((d, mlp)),
            "out_w": nrm(next(k), (d, mlp, h)),
            "out_b": jnp.zeros((d, h)),
        },
        "lnf_scale": jnp.ones((h,)),
        "lnf_bias": jnp.zeros((h,)),
    }


def init_cache(cfg: GPT2Config, batch: int, max_len: int, dtype: Any = None,
               layout: str = "auto") -> Cache:
    """Preallocated static-shape KV cache (lives in HBM between steps).

    K and V are interleaved in ONE buffer ``[L, B, max_len, 2, nh, hd]``
    (index 0 = K, 1 = V): the decode step's per-layer cache write is then a
    single dynamic_update_slice instead of two. Those writes are in-place
    but launch-overhead-dominated, so halving the count halves that cost."""
    dtype = dtype or cfg.dtype
    if layout == "beam_gen":
        # beam/unified GENERATED-region cache: TIME-major
        # ``[L, max_len(N), 2, batch(R), H]`` with K|V interleaved ABOVE the
        # row dims and the head dims MERGED into one H=768 minor axis. Each
        # decode step writes one CONTIGUOUS [1,1,2,R,H] slab per layer. The
        # attention consumes merged H directly (_beam_attend's head-blocked
        # form), so no per-head reshape of the cache ever materializes.
        shape = (cfg.n_layer, max_len, 2, batch, cfg.n_embd)
        return {"kv": jnp.zeros(shape, dtype)}
    shape = (cfg.n_layer, batch, max_len, 2, cfg.n_head, cfg.head_dim)
    return {"kv": jnp.zeros(shape, dtype)}


def lm_head_t(params: Params, cfg: GPT2Config) -> jax.Array:
    """Transposed + padded LM head ``[H, Vp]`` (Vp = vocab rounded up to a
    multiple of the 128-wide selection window), cast to the compute dtype —
    computed ONCE outside the decode scan and threaded into the per-step
    forward as a loop-invariant operand.

    The ``[R,H] @ [H,Vp]`` form yields row-major logits whose [R, Vp/128,
    128] window view (exact_topk) is a free reshape, and the pad columns are
    masked to -inf in the matmul epilogue (fused). Pad-column logits are
    -inf, which every consumer treats as 'absent' (softmax weight exactly 0,
    never selected).
    """
    v = cfg.vocab_size
    vp = -(-v // 128) * 128
    wte_t = params["wte"].astype(cfg.dtype).T          # [H, V]
    if vp != v:
        wte_t = jnp.pad(wte_t, ((0, 0), (0, vp - v)))
    return wte_t


def _lm_logits_t(x: jax.Array, wte_t: jax.Array, vocab_size: int) -> jax.Array:
    """Row-major logits ``x @ wte_t`` with pad columns masked to -inf
    (fuses into the matmul epilogue). x: [..., H] -> [..., Vp] fp32."""
    logits = jnp.einsum("...h,hv->...v", x, wte_t,
                        preferred_element_type=jnp.float32)
    vp = wte_t.shape[1]
    if vp == vocab_size:
        return logits
    col = jax.lax.broadcasted_iota(jnp.int32, (vp,), 0)
    return jnp.where(col < vocab_size, logits, jnp.float32(-jnp.inf))


def lm_stats(x2: jax.Array, wte_t: jax.Array, cfg: "GPT2Config",
             need_row_stats: bool) -> Tuple:
    """LM head + the selection statistics every decode step needs.

    Returns (logits [R,Vp] f32 row-major w/ -inf pads, wmax [R,Vp/128],
    m [R] | None, l [R] | None); wmax is the per-128-column window maximum
    (exact_topk's first stage), m/l (row max, row sum-exp — the beam path's
    log-softmax shift) are only computed when ``need_row_stats``.
    """
    logits = _lm_logits_t(x2, wte_t, cfg.vocab_size)
    r, vp = logits.shape
    wmax = jnp.max(logits.reshape(r, vp // 128, 128), axis=-1)
    m = l = None
    if need_row_stats:
        m = jnp.max(logits, axis=-1)
        l = jnp.sum(jnp.exp(logits - m[:, None]), axis=-1)
    return logits, wmax, m, l


def _layer_norm(x: jax.Array, scale: jax.Array, bias: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(x.dtype)


def _attend(
    q: jax.Array,          # [B,S,nh,hd] — queries of the S new tokens
    k_cache: jax.Array,    # [B,max_len,nh,hd] — ALREADY containing the new K
    v_cache: jax.Array,
    blk: Params,
    offset: jax.Array,
    valid_mask: jax.Array,
    cfg: GPT2Config,
) -> jax.Array:
    """Attention of S new tokens at absolute positions [offset, offset+S)
    against an updated cache, plus the output projection. Returns [B,S,H].
    Shared by the scan and the unrolled-decode layer loops so both compute
    bit-identical results."""
    from video_caption_tpu.models.quantize import block_weight

    dt = cfg.dtype
    b, s = q.shape[0], q.shape[1]
    h = cfg.n_embd
    max_len = k_cache.shape[1]

    scale = cfg.head_dim ** -0.5
    logits = jnp.einsum(
        "bqhd,bkhd->bhqk", q, k_cache.astype(q.dtype), preferred_element_type=jnp.float32
    ) * scale  # [B,nh,S,max_len]

    col = jax.lax.broadcasted_iota(jnp.int32, (s, max_len), 1)
    row_abs = offset + jax.lax.broadcasted_iota(jnp.int32, (s, max_len), 0)
    causal = col <= row_abs  # [S, max_len]
    mask = causal[None, None, :, :] & (valid_mask[:, None, None, :] > 0)
    logits = jnp.where(mask, logits, jnp.float32(-1e30))
    attn = jax.nn.softmax(logits, axis=-1).astype(dt)
    out = jnp.einsum("bhqk,bkhd->bqhd", attn, v_cache.astype(dt))
    out = out.reshape(b, s, h)
    return out @ block_weight(blk, "proj_w", dt) + blk["proj_b"].astype(dt)


def _attend_deferred(
    q: jax.Array,          # [B,1,nh,hd] — the step's query
    k_cache: jax.Array,    # [B,max_len,nh,hd] — WITHOUT the new token
    v_cache: jax.Array,
    k_new: jax.Array,      # [B,1,nh,hd] — this layer's new K/V, held in
    v_new: jax.Array,      # registers until the post-loop batched write
    blk: Params,
    offset: jax.Array,
    valid_mask: jax.Array,
    cfg: GPT2Config,
) -> jax.Array:
    """Single-token decode attention for the deferred-cache-write step
    (GPT2Config.deferred_cache_write): the cache part runs STRICTLY causal
    (col < offset — the current column is stale in the pre-write cache) and
    the new token's self-attention term is appended as one extra key column.

    Numerics: identical masking/softmax formula as ``_attend``; only the
    position of the self column in the softmax reduction differs (end vs
    ``offset``), an f32 reassociation at the last-ulp level."""
    from video_caption_tpu.models.quantize import block_weight

    dt = cfg.dtype
    b = q.shape[0]
    h = cfg.n_embd
    max_len = k_cache.shape[1]
    scale = cfg.head_dim ** -0.5

    logits = jnp.einsum(
        "bqhd,bkhd->bhqk", q, k_cache.astype(q.dtype), preferred_element_type=jnp.float32
    ) * scale                                             # [B,nh,1,max_len]
    col = jax.lax.broadcasted_iota(jnp.int32, (1, max_len), 1)
    mask = (col < offset)[None, None] & (valid_mask[:, None, None, :] > 0)
    logits = jnp.where(mask, logits, jnp.float32(-1e30))
    lg_self = jnp.einsum(
        "bqhd,bqhd->bhq", q, k_new.astype(q.dtype), preferred_element_type=jnp.float32
    )[:, :, :, None] * scale                              # [B,nh,1,1]
    attn = jax.nn.softmax(
        jnp.concatenate([logits, lg_self], axis=-1), axis=-1
    ).astype(dt)                                          # [B,nh,1,max_len+1]
    out = jnp.einsum("bhqk,bkhd->bqhd", attn[:, :, :, :max_len], v_cache.astype(dt))
    out = out + attn[:, :, :, max_len:].transpose(0, 3, 1, 2) * v_new.astype(dt)
    out = out.reshape(b, 1, h)
    return out @ block_weight(blk, "proj_w", dt) + blk["proj_b"].astype(dt)


def _cached_attention(
    x: jax.Array,
    blk: Params,
    kv_cache: jax.Array,   # [B, max_len, 2, nh, hd] — one layer's interleaved K|V
    offset: jax.Array,
    valid_mask: jax.Array,
    cfg: GPT2Config,
) -> Tuple[jax.Array, jax.Array]:
    """Attention for S new tokens at absolute positions [offset, offset+S).

    ``valid_mask`` is [B, max_len] over *cache columns* (1 = real token after
    this forward's writes). Returns (output [B,S,H], new kv cache).
    """
    from video_caption_tpu.models.quantize import block_weight

    b, s, h = x.shape
    qkv = x @ block_weight(blk, "attn_w", x.dtype) + blk["attn_b"].astype(x.dtype)
    qkv = qkv.reshape(b, s, 3, cfg.n_head, cfg.head_dim)
    q = qkv[:, :, 0]                                     # [B,S,nh,hd]
    kv_new = qkv[:, :, 1:3]                              # [B,S,2,nh,hd]
    kv_cache = jax.lax.dynamic_update_slice(
        kv_cache, kv_new.astype(kv_cache.dtype), (0, offset, 0, 0, 0))
    out = _attend(q, kv_cache[:, :, 0], kv_cache[:, :, 1], blk, offset, valid_mask, cfg)
    return out, kv_cache


def gpt2_forward(
    params: Params,
    inputs_embeds: jax.Array,   # [B,S,H] fp32 or compute dtype
    positions: jax.Array,       # [B,S] int32 — absolute position ids (wpe index)
    valid_mask: jax.Array,      # [B,max_len] int32 — 1 where a real token sits
    cache: Cache,
    offset: jax.Array,          # scalar int32 — cache write offset
    cfg: GPT2Config,
    wte_t: jax.Array = None,    # [H, Vp] loop-invariant transposed LM head —
                                # decode-scan callers pass it; logits are then
                                # [B,S,Vp] row-major with -inf pad columns
    last_only: bool = False,    # prefill: LM head on the LAST position only
                                # (decode init needs just the next-token
                                # logits; the full [B,S0,V] head is S0x the
                                # matmul FLOPs for discarded rows)
    return_stats: bool = False,  # return (lm_stats 4-tuple w/ 2-D logits,
                                 # cache) instead of ([B,S,V] logits, cache)
    row_stats: bool = True,      # with return_stats: also m/l (beam shift)
) -> Tuple[jax.Array, Cache]:
    """Unified prefill/decode forward. Returns (logits [B,S,V] fp32, new cache).

    Layer-loop structure is chosen by the (static) token count:

    - prefill / training (S > 1): ``lax.scan`` over stacked blocks and
      per-layer cache slices — compact HLO, runs once per sequence.
    - decode (S == 1): PYTHON-UNROLLED layer loop over the STACKED cache
      buffers. The scan form made the cache ride xs/ys, and XLA re-stacked
      both [L,B,max_len,H] caches every token step (profiler: copies +
      dynamic-update-slices were ~58% of the decode program). Unrolled, each
      layer issues one tiny in-place dynamic_update_slice (the new token's
      K/V) against the loop-carried buffer and reads its own layer via a
      static slice that fuses into the attention ops — no restacking.
    """
    dt = cfg.dtype
    x = inputs_embeds.astype(dt) + params["wpe"][positions].astype(dt)

    from video_caption_tpu.models.quantize import block_weight

    if inputs_embeds.shape[1] == 1:
        kv_all = cache["kv"]
        deferred = cfg.deferred_cache_write
        kv_news = []
        for layer in range(cfg.n_layer):
            blk = jax.tree.map(lambda a: a[layer], params["blocks"])
            a_in = _layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
            b, s, h = a_in.shape
            qkv = a_in @ block_weight(blk, "attn_w", dt) + blk["attn_b"].astype(dt)
            qkv = qkv.reshape(b, s, 3, cfg.n_head, cfg.head_dim)
            q = qkv[:, :, 0]
            if deferred:
                # new K/V ride registers; ONE stacked write after the loop
                kv_news.append(qkv[:, :, 1:3].astype(kv_all.dtype))
                a_out = _attend_deferred(
                    q, kv_all[layer, :, :, 0], kv_all[layer, :, :, 1],
                    qkv[:, :, 1], qkv[:, :, 2], blk, offset, valid_mask, cfg)
            else:
                # ONE interleaved K|V write per layer (init_cache docstring)
                kv_all = jax.lax.dynamic_update_slice(
                    kv_all, qkv[:, :, 1:3].astype(kv_all.dtype)[None],
                    (layer, 0, offset, 0, 0, 0))
                a_out = _attend(q, kv_all[layer, :, :, 0], kv_all[layer, :, :, 1],
                                blk, offset, valid_mask, cfg)
            x = x + a_out
            m_in = _layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.ln_eps)
            m = m_in @ block_weight(blk, "fc_w", dt) + blk["fc_b"].astype(dt)
            m = jax.nn.gelu(m.astype(jnp.float32), approximate=True).astype(dt)
            m = m @ block_weight(blk, "out_w", dt) + blk["out_b"].astype(dt)
            x = x + m
        if deferred:
            # [L,B,1,2,nh,hd] stack -> single in-place slab write at `offset`
            kv_all = jax.lax.dynamic_update_slice(
                kv_all, jnp.stack(kv_news, axis=0), (0, 0, offset, 0, 0, 0))
        new_kv = kv_all
    else:
        def body(carry, xs):
            xv = carry
            blk, kvc = xs
            a_in = _layer_norm(xv, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
            a_out, kvc = _cached_attention(a_in, blk, kvc, offset, valid_mask, cfg)
            xv = xv + a_out
            m_in = _layer_norm(xv, blk["ln2_scale"], blk["ln2_bias"], cfg.ln_eps)
            m = m_in @ block_weight(blk, "fc_w", dt) + blk["fc_b"].astype(dt)
            m = jax.nn.gelu(m.astype(jnp.float32), approximate=True).astype(dt)
            m = m @ block_weight(blk, "out_w", dt) + blk["out_b"].astype(dt)
            xv = xv + m
            return xv, kvc

        x, new_kv = jax.lax.scan(body, x, (params["blocks"], cache["kv"]))
    if last_only and x.shape[1] > 1:
        x = x[:, -1:, :]
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.ln_eps)
    if return_stats:
        return lm_stats(x[:, -1, :], wte_t, cfg, need_row_stats=row_stats), \
            {"kv": new_kv}
    if wte_t is not None:
        return _lm_logits_t(x, wte_t, cfg.vocab_size), {"kv": new_kv}
    logits = jnp.einsum(
        "bsh,vh->bsv", x, params["wte"].astype(dt), preferred_element_type=jnp.float32
    )
    return logits, {"kv": new_kv}


def ancestry_mask(anc: jax.Array, b: int, k_beams: int, t: jax.Array) -> jax.Array:
    """Ancestry one-hot for the dense beam attention: sel[b, kq, j, kv] =
    "video b's query beam kq has its step-j ancestor K/V in physical row
    b*K + kv (and j <= t)". Layer-independent — computed once per step.
    ``anc`` holds flat row indices LOCAL to this group of b*k rows."""
    n = anc.shape[1]
    anc_b = anc.reshape(b, k_beams, n)
    row_of = (jnp.arange(b, dtype=anc.dtype) * k_beams)[:, None, None, None] + \
        jnp.arange(k_beams, dtype=anc.dtype)[None, None, None, :]       # [B,1,1,Kv]
    sel = (anc_b[:, :, :, None] == row_of) & \
        (jnp.arange(n, dtype=jnp.int32)[None, None, :, None] <= t)      # [B,Kq,N,Kv]
    return sel


def head_block_mask(cfg: GPT2Config) -> jax.Array:
    """[nh, H] 0/1 mask: row h is 1 exactly on head h's H-slice. The
    head-blocked attention multiplies queries by this so per-head dot
    products ride a SINGLE H=768 contraction (zeros kill the cross-head
    terms exactly) — no per-head [.., nh, hd] tensors or per-head reshapes
    of the caches in the decode step."""
    h_of = jnp.arange(cfg.n_embd, dtype=jnp.int32) // cfg.head_dim
    return (h_of[None, :] == jnp.arange(cfg.n_head, dtype=jnp.int32)[:, None])


def _beam_attend(
    q: jax.Array,               # [R, H] — this group's query rows (R = B*K)
    pk: jax.Array,              # [B, S0, H] — one layer's prefill K (heads merged)
    pv: jax.Array,              # [B, S0, H] — one layer's prefill V
    gk: jax.Array,              # [N, R, H] — one layer's gen K (TIME-major)
    gv: jax.Array,              # [N, R, H] — one layer's gen V
    prefill_valid: jax.Array,   # [B, S0]
    sel: jax.Array,             # [B,Kq,N,Kv] ancestry mask (ancestry_mask);
                                # STRICT (built with t-1) in deferred mode
    hmask: jax.Array,           # [nh, H] head_block_mask
    k_beams: int,
    cfg: GPT2Config,
    k_new: jax.Array = None,    # [R, H] deferred mode: this step's K/V, not
    v_new: jax.Array = None,    # yet in the cache — self column appended
) -> jax.Array:
    """Split-cache attention of one beam group in HEAD-BLOCKED form: queries
    are expanded to [B, K*nh, H] rows that are zero outside their own head's
    H-slice, so every logit/AV contraction runs over the full merged H with
    bit-zero cross-head terms. All matmul operands keep (rows, H) minor dims
    — no per-head reshapes of the caches. The prefill
    part is shared per video; the generated part is dense over the video's
    K physical rows with the ancestry one-hot masking non-ancestors to -inf
    (gpt2_beam_step docstring). Returns the attention output [R, H]."""
    dt = cfg.dtype
    r = q.shape[0]
    b, s0 = prefill_valid.shape
    n = gk.shape[0]
    nh = cfg.n_head
    scale = cfg.head_dim ** -0.5

    qb = q.reshape(b, k_beams, 1, cfg.n_embd)
    q_blk = (qb * hmask.astype(dt)[None, None]).reshape(b, k_beams * nh, cfg.n_embd)

    lp_ = jnp.einsum("bqh,bsh->bqs", q_blk, pk.astype(dt),
                     preferred_element_type=jnp.float32) * scale       # [B,K*nh,S0]
    lp_ = jnp.where(prefill_valid[:, None, :] > 0, lp_, jnp.float32(-1e30))

    gkb = gk.reshape(n, b, k_beams, cfg.n_embd)
    gvb = gv.reshape(n, b, k_beams, cfg.n_embd)
    lg = jnp.einsum("bqh,nbkh->bqnk", q_blk, gkb.astype(dt),
                    preferred_element_type=jnp.float32) * scale        # [B,K*nh,N,Kv]
    lg = lg.reshape(b, k_beams, nh, n, k_beams)
    lg = jnp.where(sel[:, :, None, :, :], lg, jnp.float32(-1e30))
    lg = lg.reshape(b, k_beams * nh, n * k_beams)

    parts = [lp_, lg]
    if k_new is not None:
        # deferred-write self column: at column t each row attends only its
        # OWN new K (anc[:, t] is the identity), so it's a rowwise dot
        kn = jnp.broadcast_to(
            k_new.astype(dt).reshape(b, k_beams, 1, cfg.n_embd),
            (b, k_beams, nh, cfg.n_embd)).reshape(b, k_beams * nh, cfg.n_embd)
        ls = jnp.sum(q_blk.astype(jnp.float32) * kn.astype(jnp.float32),
                     axis=-1, keepdims=True) * scale                   # [B,K*nh,1]
        parts.append(ls)
    attn = jax.nn.softmax(jnp.concatenate(parts, axis=-1), axis=-1).astype(dt)
    ap, ag = attn[..., :s0], attn[..., s0:s0 + n * k_beams]
    out_p = jnp.einsum("bqs,bsh->bqh", ap, pv.astype(dt))              # [B,K*nh,H]
    # AV over the gen region as an N-BATCHED dot + reduce, NOT one joint
    # (n,k) contraction: the joint form lets XLA pick a gen-cache layout
    # with N second-minor, which turns every per-step cache write into a
    # strided read-modify-write. Batching the dot over N keeps the
    # contraction on K alone, so the cache stays (R, H)-minor and the
    # step's slab write is contiguous.
    agn = ag.reshape(b, k_beams * nh, n, k_beams).transpose(2, 0, 1, 3)  # [N,B,Q,K]
    per_n = jnp.einsum("nbqk,nbkh->nbqh", agn, gvb.astype(dt),
                       preferred_element_type=jnp.float32)               # batch (n,b)
    out_g = per_n.sum(axis=0).astype(out_p.dtype)
    if k_new is not None:
        vn = jnp.broadcast_to(
            v_new.astype(dt).reshape(b, k_beams, 1, cfg.n_embd),
            (b, k_beams, nh, cfg.n_embd)).reshape(b, k_beams * nh, cfg.n_embd)
        out_g = out_g + attn[..., s0 + n * k_beams:] * vn
    res = (out_p + out_g).reshape(b, k_beams, nh, cfg.n_embd)
    # keep only each row's own head block and re-merge heads
    out = jnp.sum(res * hmask.astype(dt)[None, None], axis=2)          # [B,K,H]
    return out.reshape(r, cfg.n_embd)


def _sample_attend(
    q: jax.Array,               # [B, H] — one query row per sequence
    pk: jax.Array,              # [B, S0, H] — one layer's prefill K (heads merged)
    pv: jax.Array,              # [B, S0, H]
    gk: jax.Array,              # [N, B, H] — one layer's gen K (TIME-major)
    gv: jax.Array,              # [N, B, H]
    prefill_valid: jax.Array,   # [B, S0]
    t: jax.Array,               # scalar int32 — current gen column (already
                                # written; STRICTLY past in deferred mode)
    hmask: jax.Array,           # [nh, H] head_block_mask
    cfg: GPT2Config,
    k_new: jax.Array = None,    # [B, H] deferred mode: this step's K/V, not
    v_new: jax.Array = None,    # yet in the cache — self column appended
) -> jax.Array:
    """K=1 split-cache attention in head-blocked merged-H form (the beam
    path's _beam_attend without the ancestry machinery: each row attends to
    its own prefill plus its own gen columns <= t, a plain causal mask).
    All matmul operands keep (rows, H) minor dims — no per-head (nh, hd)
    tensors. The gen-region AV is an n-batched dot + f32 reduce, NOT a
    joint contraction over n — the joint form lets XLA re-layout the
    time-major cache per step (see _beam_attend's identical note). Returns [B, H]."""
    dt = cfg.dtype
    b, s0 = prefill_valid.shape
    n = gk.shape[0]
    nh = cfg.n_head
    scale = cfg.head_dim ** -0.5

    q_blk = (q[:, None, :] * hmask.astype(dt)[None]).astype(dt)      # [B,nh,H]
    lp_ = jnp.einsum("bqh,bsh->bqs", q_blk, pk.astype(dt),
                     preferred_element_type=jnp.float32) * scale     # [B,nh,S0]
    lp_ = jnp.where(prefill_valid[:, None, :] > 0, lp_, jnp.float32(-1e30))

    lg = jnp.einsum("bqh,nbh->bqn", q_blk, gk.astype(dt),
                    preferred_element_type=jnp.float32) * scale      # [B,nh,N]
    deferred = k_new is not None
    causal = (jnp.arange(n, dtype=jnp.int32) < (t if deferred else t + 1)
              )[None, None, :]
    lg = jnp.where(causal, lg, jnp.float32(-1e30))

    parts = [lp_, lg]
    if deferred:
        # self column: a rowwise dot with this step's own K
        kn = jnp.broadcast_to(k_new.astype(dt)[:, None, :], (b, nh, q.shape[-1]))
        ls = jnp.sum(q_blk.astype(jnp.float32) * kn.astype(jnp.float32),
                     axis=-1, keepdims=True) * scale                 # [B,nh,1]
        parts.append(ls)
    attn = jax.nn.softmax(jnp.concatenate(parts, axis=-1), axis=-1).astype(dt)
    ap, ag = attn[..., :s0], attn[..., s0:s0 + n]
    out_p = jnp.einsum("bqs,bsh->bqh", ap, pv.astype(dt))            # [B,nh,H]
    agn = ag.transpose(2, 0, 1)[..., None]                           # [N,B,nh,1]
    per_n = agn.astype(jnp.float32) * gv.astype(jnp.float32)[:, :, None, :]
    out_g = per_n.sum(axis=0).astype(out_p.dtype)                    # [B,nh,H]
    if deferred:
        vn = jnp.broadcast_to(v_new.astype(dt)[:, None, :], (b, nh, q.shape[-1]))
        out_g = out_g + attn[..., s0 + n:] * vn
    res = out_p + out_g
    out = jnp.sum(res * hmask.astype(dt)[None], axis=1)              # [B,H]
    return out


def gpt2_sample_step(
    params: Params,
    token_embeds: jax.Array,    # [B, H] — one new token per row
    positions: jax.Array,       # [B] int32 — absolute position ids
    prefill_cache: Cache,       # {k,v: [L, B, S0, H]} — read-only
    prefill_valid: jax.Array,   # [B, S0] int32
    gen_cache: Cache,           # {kv: [L, N, 2, B, H]} TIME-major — append-only
    t: jax.Array,               # scalar int32 — current decode step (gen column)
    cfg: GPT2Config,
    wte_t: jax.Array = None,
    return_stats: bool = False,
) -> Tuple[jax.Array, Cache]:
    """Single greedy/sampled decode step over the SPLIT KV cache
    (GPT2Config.sample_split_cache docstring) — gpt2_beam_step's structure
    at K=1 with a causal mask instead of ancestry. Returns
    (logits [B, Vp] or lm_stats tuple, new gen_cache)."""
    dt = cfg.dtype
    from video_caption_tpu.models.quantize import block_weight

    b, h = token_embeds.shape
    x = token_embeds.astype(dt) + params["wpe"][positions].astype(dt)
    hmask = head_block_mask(cfg)

    gkv_all = gen_cache["kv"]                            # [L,N,2,B,H]
    pk_all, pv_all = prefill_cache["k"], prefill_cache["v"]
    deferred = cfg.deferred_cache_write
    kv_news = []
    for layer in range(cfg.n_layer):
        blk = jax.tree.map(lambda a, _l=layer: a[_l], params["blocks"])
        a_in = _layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
        qkv = a_in @ block_weight(blk, "attn_w", dt) + blk["attn_b"].astype(dt)
        qkv = qkv.reshape(b, 3, h)
        q = qkv[:, 0]
        kv_new = jnp.swapaxes(qkv[:, 1:3], 0, 1)          # [2, B, H]
        if deferred:
            # column t rides registers; ONE stacked write after the loop
            kv_news.append(kv_new.astype(gkv_all.dtype))
            k_cur, v_cur = qkv[:, 1], qkv[:, 2]
        else:
            gkv_all = jax.lax.dynamic_update_slice(
                gkv_all, kv_new.astype(gkv_all.dtype)[None, None],
                (layer, t, 0, 0, 0))
            k_cur = v_cur = None
        out = _sample_attend(q, pk_all[layer], pv_all[layer],
                             gkv_all[layer, :, 0], gkv_all[layer, :, 1],
                             prefill_valid, t, hmask, cfg,
                             k_new=k_cur, v_new=v_cur)
        out = out @ block_weight(blk, "proj_w", dt) + blk["proj_b"].astype(dt)
        x = x + out

        m_in = _layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.ln_eps)
        m = m_in @ block_weight(blk, "fc_w", dt) + blk["fc_b"].astype(dt)
        m = jax.nn.gelu(m.astype(jnp.float32), approximate=True).astype(dt)
        m = m @ block_weight(blk, "out_w", dt) + blk["out_b"].astype(dt)
        x = x + m
    if deferred:
        # [L,2,B,H] stack -> ONE in-place [L,1,2,B,H] slab write at column t
        gkv_all = jax.lax.dynamic_update_slice(
            gkv_all, jnp.stack(kv_news, axis=0)[:, None], (0, t, 0, 0, 0))
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.ln_eps)
    if return_stats:
        return lm_stats(x, wte_t, cfg, need_row_stats=False), {"kv": gkv_all}
    if wte_t is not None:
        return _lm_logits_t(x, wte_t, cfg.vocab_size), {"kv": gkv_all}
    logits = jnp.einsum(
        "rh,vh->rv", x, params["wte"].astype(dt), preferred_element_type=jnp.float32
    )
    return logits, {"kv": gkv_all}


def gpt2_beam_step(
    params: Params,
    token_embeds: jax.Array,    # [R, H] — one new token per beam row (R = B*K)
    positions: jax.Array,       # [R] int32 — absolute position ids
    prefill_cache: Cache,       # {k,v: [L, B, S0, H]} — read-only, SHARED by beams
    prefill_valid: jax.Array,   # [B, S0] int32 — left-pad mask of the prompt
    gen_cache: Cache,           # {kv: [L, N, 2, R, H]} TIME-major — append-only
    anc: jax.Array,             # [R, N] int32 — physical gen-cache row per position
    t: jax.Array,               # scalar int32 — current decode step (gen column)
    num_beams: int,
    cfg: GPT2Config,
    wte_t: jax.Array = None,    # [H, Vp] loop-invariant transposed LM head
    return_stats: bool = False,  # also return (wmax, m, l) — see lm_stats
) -> Tuple[jax.Array, Cache]:
    """Single beam-search decode step with a SPLIT KV cache.

    Why not the classic gather-the-cache-by-parent-beam step (HF Flax / T5X
    style, as round 1 shipped): physically reordering a [L,R,max_len,nh,hd]
    cache moves ~0.5 GB per step at the production batch and breaks XLA's
    in-place aliasing of the loop carry (profiler: gather copies + full-buffer
    dynamic-update-slice ~6 ms of the 12 ms step). Instead:

    - the PREFILL region is identical across a video's beams and is stored
      once per video ([B] not [R]) and never written again,
    - the GENERATED region is append-only: row r writes step t's K/V at
      physical row r, column t; the beam reorder only permutes the tiny
      ancestry index ``anc`` (anc[r, j] = physical row whose column-j entry
      is row r's ancestor). Attention does NOT gather K/V through ``anc``
      (a [R,N,nh,hd] gather materializes ~280 MB/step of copies at the
      production batch). Instead each beam attends DENSELY to all K
      physical rows of its own video and an ancestry one-hot mask kills the
      non-ancestor columns before the softmax: masked logits are -inf, so
      their probabilities are exactly 0.0 and the weighted sum equals the
      gathered version while staying pure matmul.

    Returns (logits [R, V] fp32, new gen_cache).
    """
    dt = cfg.dtype
    from video_caption_tpu.models.quantize import block_weight

    r, h = token_embeds.shape
    b = prefill_valid.shape[0]
    k_beams = num_beams
    x = token_embeds.astype(dt) + params["wpe"][positions].astype(dt)   # [R, H]

    # head-block mask + the ancestry one-hot, once per step. Deferred mode
    # uses the STRICT mask (column t handled as the explicit self column —
    # ancestry_mask(t-1) keeps only j < t)
    hmask = head_block_mask(cfg)
    deferred = cfg.deferred_cache_write
    sel = ancestry_mask(anc, b, k_beams, t - 1 if deferred else t)

    # PYTHON-UNROLLED layer loop (same rationale as gpt2_forward's decode
    # branch): the layer-scan form re-stacked the [L,R,N,H] gen caches every
    # token step; unrolled, each layer issues in-place writes against the
    # loop-carried stacked buffers and reads its own layer as a static
    # slice that fuses into the attention einsums. K and V are SPLIT and the
    # gen cache is TIME-major (init_cache "beam_gen" docstring): the
    # per-step write is a contiguous [1,1,2,R,H] slab, and every per-step
    # read is a clean static slice.
    gkv_all = gen_cache["kv"]                           # [L,N,2,R,H]
    pk_all, pv_all = prefill_cache["k"], prefill_cache["v"]  # [L,B,S0,H]
    kv_news = []
    for layer in range(cfg.n_layer):
        blk = jax.tree.map(lambda a, _l=layer: a[_l], params["blocks"])
        a_in = _layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.ln_eps)
        qkv = a_in @ block_weight(blk, "attn_w", dt) + blk["attn_b"].astype(dt)
        qkv = qkv.reshape(r, 3, h)
        q = qkv[:, 0]                                                   # [R, H]

        kv_new = jnp.swapaxes(qkv[:, 1:3], 0, 1)        # [2, R, H]
        if deferred:
            # column t rides registers; ONE stacked write after the loop
            kv_news.append(kv_new.astype(gkv_all.dtype))
            k_cur, v_cur = qkv[:, 1], qkv[:, 2]
        else:
            gkv_all = jax.lax.dynamic_update_slice(
                gkv_all, kv_new.astype(gkv_all.dtype)[None, None],
                (layer, t, 0, 0, 0))
            k_cur = v_cur = None

        out = _beam_attend(q, pk_all[layer], pv_all[layer],
                           gkv_all[layer, :, 0], gkv_all[layer, :, 1],
                           prefill_valid, sel, hmask, k_beams, cfg,
                           k_new=k_cur, v_new=v_cur)
        out = out @ block_weight(blk, "proj_w", dt) + blk["proj_b"].astype(dt)
        x = x + out

        m_in = _layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.ln_eps)
        m = m_in @ block_weight(blk, "fc_w", dt) + blk["fc_b"].astype(dt)
        m = jax.nn.gelu(m.astype(jnp.float32), approximate=True).astype(dt)
        m = m @ block_weight(blk, "out_w", dt) + blk["out_b"].astype(dt)
        x = x + m
    if deferred:
        # [L,2,R,H] stack -> ONE in-place [L,1,2,R,H] slab write at column t
        gkv_all = jax.lax.dynamic_update_slice(
            gkv_all, jnp.stack(kv_news, axis=0)[:, None], (0, t, 0, 0, 0))
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.ln_eps)
    if return_stats:
        return lm_stats(x, wte_t, cfg, need_row_stats=True), {"kv": gkv_all}
    if wte_t is not None:
        # row-major padded logits [R, Vp] (lm_head_t docstring)
        return _lm_logits_t(x, wte_t, cfg.vocab_size), {"kv": gkv_all}
    logits = jnp.einsum(
        "rh,vh->rv", x, params["wte"].astype(dt), preferred_element_type=jnp.float32
    )
    return logits, {"kv": gkv_all}


def gpt2_logits_nocache(
    params: Params,
    inputs_embeds: jax.Array,  # [B,S,H]
    positions: jax.Array,      # [B,S]
    attn_mask: jax.Array,      # [B,S] — 1 for real tokens
    cfg: GPT2Config,
) -> jax.Array:
    """Cache-free training forward (teacher forcing; use_cache=False in the
    reference trainer, train_caption_mapper.py compute_loss_local)."""
    b, s, _ = inputs_embeds.shape
    cache = init_cache(cfg, b, s, layout="stacked")
    logits, _ = gpt2_forward(
        params, inputs_embeds, positions, attn_mask.astype(jnp.int32), cache,
        jnp.int32(0), cfg,
    )
    return logits


def lm_loss(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """HF-style shifted causal-LM loss; label -100 = ignored
    (reference: VideoCaptionModel.compute_loss, caption_model.py:104-168)."""
    shift_logits = logits[:, :-1, :]
    shift_labels = labels[:, 1:]
    mask = shift_labels != -100
    safe_labels = jnp.where(mask, shift_labels, 0)
    logp = jax.nn.log_softmax(shift_logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, safe_labels[..., None], axis=-1)[..., 0]
    denom = jnp.maximum(jnp.sum(mask), 1)
    return jnp.sum(jnp.where(mask, nll, 0.0)) / denom
