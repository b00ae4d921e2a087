"""Scan-based autoregressive generation with a static KV cache.

XLA-native replacement for HF ``model.generate`` as the reference uses it
(src/models/text_decoder.py:105-146): prefix+prompt enter via
``inputs_embeds``; greedy, temperature/top-p sampling, and beam search with
repetition penalty, no-repeat-ngram, min_new_tokens and EOS handling.

Everything is fixed-shape: the decode loop is one ``lax.scan`` whose step
runs a single-token forward against the preallocated cache; finished rows
keep stepping but their outputs are frozen to EOS (the per-sample
finished-mask semantics of benchmark_baseline.py:212-224 / HF generate).

do_sample gating replicates the reference's rule exactly:
``do_sample = (num_beams == 1 and temperature != 1.0)`` (text_decoder.py:137).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from video_caption_tpu.decode import logits_process as lp
from video_caption_tpu.models import gpt2 as g2


@dataclass(frozen=True)
class DecodeParams:
    """Static decode policy — one compiled program per distinct value."""

    max_new_tokens: int = 24
    num_beams: int = 1
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 50     # HF GenerationConfig default TopKLogitsWarper(50); the
                        # reference never passes top_k, so every sampled decode
                        # it runs carries this warper. 0 = disabled. Only
                        # consulted when do_sample (HF warper semantics).
    no_repeat_ngram_size: int = 3
    repetition_penalty: float = 1.1
    min_new_tokens: int = 8
    eos_id: int = 50256
    early_stop: bool = False
    """Run the decode loop as a while_loop that exits when every row/beam is
    finished. Saves steps with real weights + common EOS, but a while_loop
    step carries its own loop-condition round trip — off by default; token
    outputs are identical either way."""

    @property
    def do_sample(self) -> bool:
        return self.num_beams == 1 and self.temperature != 1.0


def _process_logits(
    logits: jax.Array, generated: jax.Array, t: jax.Array, dp: DecodeParams
) -> jax.Array:
    logits = lp.apply_repetition_penalty(logits, generated, t, dp.repetition_penalty)
    logits = lp.apply_no_repeat_ngram(logits, generated, t, dp.no_repeat_ngram_size)
    logits = lp.apply_min_new_tokens(logits, t, dp.min_new_tokens, dp.eos_id)
    return logits


def _candidate_path_ok(dp: DecodeParams) -> bool:
    """The candidate-set processor shortcut (lp.topk_processed) is exact only
    when every processor can only LOWER scores — i.e. repetition_penalty >= 1
    (all preset values are; HF default is 1.0). Otherwise the scatter-based
    full-vocab chain runs."""
    return dp.repetition_penalty >= 1.0


def _topk_processed(last_scores, generated, t, k, dp: DecodeParams, wmax=None,
                    spmd=False):
    return lp.topk_processed(
        last_scores, generated, t, k,
        dp.repetition_penalty, dp.no_repeat_ngram_size, dp.min_new_tokens, dp.eos_id,
        wmax=wmax, spmd=spmd,
    )


def _prefill(
    gpt2_params,
    gpt2_cfg: g2.GPT2Config,
    inputs_embeds: jax.Array,
    max_len: int,
    prefill_mask: Optional[jax.Array] = None,   # [B, S0]; 1 = real token
    cache_layout: str = "auto",
    wte_t: Optional[jax.Array] = None,          # [H, Vp] transposed LM head
    return_stats: bool = False,                 # first slot becomes the
                                                # lm_stats 4-tuple (2-D logits)
    row_stats: bool = True,
) -> Tuple[jax.Array, g2.Cache, jax.Array, jax.Array]:
    """Run the prompt through the model.

    ``prefill_mask`` enables LEFT-padded batching of prompts with different
    lengths (the multi-preset engine path): pad columns are excluded from
    attention and position ids count only real tokens. Returns
    (last-token logits, cache, valid, row_lengths). When ``wte_t`` is given
    the logits are [B, Vp] row-major with -inf pad columns and the LM head
    runs on the LAST position only (g2.lm_head_t docstring)."""
    b, s0, _ = inputs_embeds.shape
    split = cache_layout == "split"
    cache = g2.init_cache(gpt2_cfg, b, max_len,
                          layout="stacked" if split else cache_layout)
    if prefill_mask is None:
        mask = jnp.ones((b, s0), jnp.int32)
    else:
        mask = prefill_mask.astype(jnp.int32)
    valid = jnp.zeros((b, max_len), jnp.int32)
    valid = jax.lax.dynamic_update_slice(valid, mask, (0, 0))
    positions = jnp.maximum(jnp.cumsum(mask, axis=1) - 1, 0).astype(jnp.int32)
    logits, cache = g2.gpt2_forward(
        gpt2_params, inputs_embeds, positions, valid, cache, jnp.int32(0), gpt2_cfg,
        wte_t=wte_t, last_only=wte_t is not None, return_stats=return_stats,
        row_stats=row_stats,
    )
    if split:
        # repack ONCE into contiguous per-tensor K/V with the head dims
        # MERGED ([L,B,S0,H]) — the beam/unified step's head-blocked
        # attention consumes merged H, and reading the interleaved
        # per-head buffer forced a layout-transposing copy per step
        kv = cache["kv"]                    # [L,B,S0,2,nh,hd]
        l, bb, s, _, nh, hd = kv.shape
        cache = {"k": kv[:, :, :, 0].reshape(l, bb, s, nh * hd),
                 "v": kv[:, :, :, 1].reshape(l, bb, s, nh * hd)}
    row_lengths = jnp.sum(mask, axis=1).astype(jnp.int32)
    if return_stats:
        return logits, cache, valid, row_lengths   # lm_stats 4-tuple
    return logits[:, -1, :], cache, valid, row_lengths


def sample_select(
    last_logits: jax.Array,   # [B, V] raw logits from the previous forward
    generated: jax.Array,     # [B, N] int32
    finished: jax.Array,      # [B] bool
    t: jax.Array,             # scalar int32
    dp: DecodeParams,
    rng: jax.Array,
    wmax: jax.Array = None,   # [B, V/128] precomputed window maxima (lm_stats)
    spmd: bool = False,       # mesh-safe candidate gather (GPT2Config.spmd_decode)
):
    """One greedy/sampled token-selection step (the non-forward half of
    ``greedy_or_sample``'s scan body, shared with the unified mixed-policy
    decode). Returns (token [B], new_generated, new_finished, new_rng)."""
    b = last_logits.shape[0]
    fast = _candidate_path_ok(dp) and (not dp.do_sample or dp.top_k > 0)
    if fast:
        # candidate-set path: processors touch only the raw top-(k+bound)
        # values — no [B,V] scatter passes (lp.topk_processed docstring)
        if dp.do_sample:
            rng, sub = jax.random.split(rng)
            vals, idxs = _topk_processed(last_logits, generated, t, dp.top_k, dp,
                                         wmax=wmax, spmd=spmd)
            vals = lp.apply_temperature(vals, dp.temperature)
            token = lp.sample_sorted_top_p(sub, vals, idxs, dp.top_p)
        else:
            _, idxs = _topk_processed(last_logits, generated, t, 1, dp, wmax=wmax,
                                      spmd=spmd)
            token = idxs[:, 0]
    else:
        logits = _process_logits(last_logits, generated, t, dp)
        if dp.do_sample:
            logits = lp.apply_temperature(logits, dp.temperature)
            rng, sub = jax.random.split(rng)
            if dp.top_k > 0:
                # k-way sampling: one partial-sort, no [B,V] filter pass
                # or full-vocab categorical (distribution-exact; see
                # logits_process.sample_top_k_top_p)
                token = lp.sample_top_k_top_p(sub, logits, dp.top_k, dp.top_p)
            else:
                logits = lp.apply_top_p(logits, dp.top_p)
                token = jax.random.categorical(sub, logits, axis=-1)
        else:
            token = jnp.argmax(logits, axis=-1)
    token = jnp.where(finished, dp.eos_id, token.astype(jnp.int32))
    generated = jax.lax.dynamic_update_slice(generated, token[:, None], (0, t))
    finished = finished | (token == dp.eos_id)
    return token, generated, finished, rng


def greedy_or_sample(
    gpt2_params,
    gpt2_cfg: g2.GPT2Config,
    inputs_embeds: jax.Array,        # [B, S0, H]
    dp: DecodeParams,
    rng: Optional[jax.Array] = None,
    prefill_mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Greedy or top-p sampled decode. Returns generated ids [B, max_new_tokens]
    (EOS-padded after a row finishes, matching pad_token_id=eos)."""
    b, s0, _ = inputs_embeds.shape
    n = dp.max_new_tokens
    split = gpt2_cfg.sample_split_cache
    max_len = s0 if split else s0 + n
    # transposed+padded LM head, hoisted out of the scan (loop-invariant);
    # the forward returns (logits, wmax, ...) so the selection's first
    # top-k stage is fused with the LM head (g2.lm_stats)
    wte_t = g2.lm_head_t(gpt2_params, gpt2_cfg)
    (last_logits, last_wmax, _, _), cache, valid, row_len = _prefill(
        gpt2_params, gpt2_cfg, inputs_embeds, max_len, prefill_mask, wte_t=wte_t,
        return_stats=True, row_stats=False,
        cache_layout="split" if split else "auto",
    )
    if split:
        # TIME-major merged-H gen-region cache; the contiguous prefill cache
        # above is read-only from here (GPT2Config.sample_split_cache)
        gen_cache = g2.init_cache(gpt2_cfg, b, n, layout="beam_gen")
    generated = jnp.full((b, n), dp.eos_id, jnp.int32)
    finished = jnp.zeros((b,), bool)
    if rng is None:
        rng = jax.random.PRNGKey(0)

    # FORWARD-THEN-SELECT loop order: token t's selection runs in the SAME
    # step as the forward that produced its logits, and the scan carries only
    # the token — not the [B, Vp] logits. The select-then-forward body
    # (a) carried the full-vocab logits across the scan back-edge, and
    # (b) ran one final forward whose logits nobody consumed — 1/N of the
    # whole decode wasted. Token outputs are bit-identical: same ops in
    # the same per-token order, minus the discarded forward.
    token0, generated, finished, rng = sample_select(
        last_logits, generated, finished, jnp.int32(0), dp, rng, wmax=last_wmax,
        spmd=gpt2_cfg.spmd_decode,
    )

    if split:
        def step(carry, t):
            token_prev, gen_cache, generated, finished, rng = carry
            # forward of token t-1: its K/V lands at gen column t-1 and the
            # causal mask exposes gen columns <= t-1 (g2.gpt2_sample_step)
            embeds = gpt2_params["wte"][token_prev]
            positions = row_len + t - 1
            (logits, wmax, _, _), gen_cache = g2.gpt2_sample_step(
                gpt2_params, embeds, positions, cache, valid, gen_cache,
                t - 1, gpt2_cfg, wte_t=wte_t, return_stats=True,
            )
            token, generated, finished, rng = sample_select(
                logits, generated, finished, t, dp, rng, wmax=wmax,
                spmd=gpt2_cfg.spmd_decode,
            )
            return (token, gen_cache, generated, finished, rng), None

        carry = (token0, gen_cache, generated, finished, rng)
        if dp.early_stop:
            def cond(state):
                t, (_, _, _, fin, _) = state
                return (t < n) & ~jnp.all(fin)

            def body(state):
                t, c = state
                c, _ = step(c, t)
                return t + 1, c

            _, carry = jax.lax.while_loop(cond, body, (jnp.int32(1), carry))
        else:
            carry, _ = jax.lax.scan(step, carry, jnp.arange(1, n, dtype=jnp.int32))
        return carry[2]

    def step(carry, t):
        token_prev, cache, valid, generated, finished, rng = carry
        # feed the previous token in; position ids count only real tokens
        # per row (left-padded batching); its K/V lands at column s0 + t - 1
        embeds = gpt2_params["wte"][token_prev][:, None, :]
        positions = (row_len + t - 1)[:, None]
        valid = jax.lax.dynamic_update_slice(
            valid, jnp.ones((b, 1), jnp.int32), (0, s0 + t - 1))
        (logits, wmax, _, _), cache = g2.gpt2_forward(
            gpt2_params, embeds, positions, valid, cache, s0 + t - 1, gpt2_cfg,
            wte_t=wte_t, return_stats=True, row_stats=False,
        )
        token, generated, finished, rng = sample_select(
            logits, generated, finished, t, dp, rng, wmax=wmax,
            spmd=gpt2_cfg.spmd_decode,
        )
        return (token, cache, valid, generated, finished, rng), None

    carry = (token0, cache, valid, generated, finished, rng)
    if dp.early_stop:
        # while_loop exits once every row finished (per-sample finished-mask
        # semantics of benchmark_baseline.py:212-224 plus a whole-batch stop)
        def cond(state):
            t, (_, _, _, _, fin, _) = state
            return (t < n) & ~jnp.all(fin)

        def body(state):
            t, c = state
            c, _ = step(c, t)
            return t + 1, c

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(1), carry))
    else:
        carry, _ = jax.lax.scan(step, carry, jnp.arange(1, n, dtype=jnp.int32))
    return carry[3]


def beam_select(
    last_logits: jax.Array,   # [B*K, V] raw logits from the previous forward
    beam_scores: jax.Array,   # [B, K]
    generated: jax.Array,     # [B, K, N]
    fin_scores: jax.Array,    # [B, K]
    fin_seqs: jax.Array,      # [B, K, N]
    t: jax.Array,             # scalar int32
    dp: DecodeParams,
    k: int,
    stats=None,               # optional (wmax [B*K, V/128], m [B*K], l [B*K])
                              # from g2.lm_stats — skips the in-loop row
                              # max / sum-exp / window-max recomputation
    spmd: bool = False,       # mesh-safe candidate gather (GPT2Config.spmd_decode)
):
    """One beam-search selection step (the non-forward half of
    ``beam_search``'s scan body, shared with the unified mixed-policy
    decode): HF semantics — 2K candidate expansion, EOS candidates move to
    the finished-hypothesis set, best K non-EOS continue. Returns
    (new_token [B,K], flat_parent [B*K], new_scores, new_gen,
    new_fin_scores, new_fin_seqs)."""
    b = generated.shape[0]
    n = generated.shape[2]
    neg_inf = jnp.float32(-1e9)
    flat_gen = generated.reshape(b * k, n)
    # HF beam semantics: processors run on LOG-SOFTMAX scores (greedy runs
    # them on raw logits) — order matters for repetition penalty.
    if _candidate_path_ok(dp):
        # candidate-set path: per-row exact top-2K of the processed
        # scores from the raw top-(2K+bound) (lp.topk_processed), then
        # the cross-beam top-2K runs over [B, K*2K] instead of [B, K*V]
        # — deletes the [R,V] scatter passes AND shrinks the big sort.
        # Ranking runs on RAW logits; only the candidates are converted to
        # log-softmax values (bit-identical — topk_processed docstring).
        lx = last_logits.astype(jnp.float32)
        if stats is not None:
            wmax, m, l = stats
            ls = jnp.log(l)
        else:
            wmax = None
            m = jnp.max(lx, axis=-1)
            ls = jnp.log(jnp.sum(jnp.exp(lx - m[:, None]), axis=-1))
        row_vals, row_idx = lp.topk_processed(
            lx, flat_gen, t, 2 * k,
            dp.repetition_penalty, dp.no_repeat_ngram_size, dp.min_new_tokens,
            dp.eos_id, shift_max=m, shift_logsum=ls, wmax=wmax, spmd=spmd,
        )
        cand = beam_scores.reshape(b * k, 1) + row_vals       # [B*K, 2K]
        cand = cand.reshape(b, k * 2 * k)
        top_scores, pick = jax.lax.top_k(cand, 2 * k)         # [B, 2K]
        parent = pick // (2 * k)                              # beam index
        token = jnp.take_along_axis(row_idx.reshape(b, k * 2 * k), pick, axis=1)
        token = token.astype(jnp.int32)
    else:
        logp = jax.nn.log_softmax(last_logits.astype(jnp.float32), axis=-1)
        logp = _process_logits(logp, flat_gen, t, dp)
        v = logp.shape[-1]
        cand = beam_scores.reshape(b * k, 1) + logp
        cand = cand.reshape(b, k * v)
        top_scores, top_idx = jax.lax.top_k(cand, 2 * k)      # [B, 2K]
        parent = top_idx // v                                  # beam index
        token = (top_idx % v).astype(jnp.int32)

    is_eos = token == dp.eos_id
    # --- finished-hypothesis update (normalized by generated length incl. eos)
    eos_norm = jnp.where(is_eos, top_scores / (t.astype(jnp.float32) + 1.0), -jnp.inf)
    cand_seqs = jnp.take_along_axis(generated, parent[..., None], axis=1)  # [B,2K,N]
    eos_col = jnp.broadcast_to(token[..., None], cand_seqs.shape[:2] + (1,))
    cand_seqs = jax.lax.dynamic_update_slice_in_dim(
        cand_seqs, eos_col, t, axis=2
    )
    all_scores = jnp.concatenate([fin_scores, eos_norm], axis=1)          # [B, 3K]
    all_seqs = jnp.concatenate([fin_seqs, cand_seqs], axis=1)             # [B, 3K, N]
    new_fin_scores, fin_pick = jax.lax.top_k(all_scores, k)
    new_fin_seqs = jnp.take_along_axis(all_seqs, fin_pick[..., None], axis=1)

    # --- continuing beams: best K non-eos among the 2K
    cont_rank = top_scores + jnp.where(is_eos, neg_inf * 2, 0.0)
    _, cont_pick = jax.lax.top_k(cont_rank, k)                             # [B, K]
    new_scores = jnp.take_along_axis(top_scores, cont_pick, axis=1)
    new_parent = jnp.take_along_axis(parent, cont_pick, axis=1)           # [B, K]
    new_token = jnp.take_along_axis(token, cont_pick, axis=1)

    new_gen = jnp.take_along_axis(generated, new_parent[..., None], axis=1)
    new_gen = jax.lax.dynamic_update_slice_in_dim(
        new_gen, new_token[..., None], t, axis=2
    )

    # beam reorder = permute the tiny ancestry index, NOT the cache
    flat_parent = (new_parent + jnp.arange(b)[:, None] * k).reshape(-1)
    return new_token, flat_parent, new_scores, new_gen, new_fin_scores, new_fin_seqs


def beam_finalize(
    beam_scores: jax.Array,   # [B, K]
    generated: jax.Array,     # [B, K, N]
    fin_scores: jax.Array,    # [B, K]
    fin_seqs: jax.Array,      # [B, K, N]
    n: int,
) -> jax.Array:
    """Merge running (unfinished) beams, normalized by full length (HF
    finalize); returns the best sequence per batch row [B, N]."""
    run_norm = beam_scores / float(n)
    all_scores = jnp.concatenate([fin_scores, run_norm], axis=1)
    all_seqs = jnp.concatenate([fin_seqs, generated], axis=1)
    best = jnp.argmax(all_scores, axis=1)
    return jnp.take_along_axis(all_seqs, best[:, None, None], axis=1)[:, 0, :]


def beam_search(
    gpt2_params,
    gpt2_cfg: g2.GPT2Config,
    inputs_embeds: jax.Array,        # [B, S0, H]
    dp: DecodeParams,
    prefill_mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Fixed-shape beam search (HF semantics: 2K candidate expansion, EOS
    candidates move to a finished-hypothesis set scored with length_penalty=1,
    survivors continue; best finished hypothesis wins, running beams are
    merged in at the end if unfinished). Returns ids [B, max_new_tokens]."""
    b, s0, h = inputs_embeds.shape
    k = dp.num_beams
    n = dp.max_new_tokens
    neg_inf = jnp.float32(-1e9)
    r = b * k

    # prefill ONCE per video at B rows; beams share it read-only (the split
    # cache: g2.gpt2_beam_step docstring explains why this replaces the
    # classic gather-the-cache-by-parent step). Beam search always uses the
    # split K/V layouts (gpt2_beam_step's dense-masked attention).
    wte_t = g2.lm_head_t(gpt2_params, gpt2_cfg)   # hoisted out of the scan
    (last_logits, last_wmax, last_m, last_l), prefill_cache, prefill_valid, \
        row_len = _prefill(
            gpt2_params, gpt2_cfg, inputs_embeds, s0, prefill_mask,
            cache_layout="split", wte_t=wte_t, return_stats=True,
        )
    last_logits = jnp.repeat(last_logits, k, axis=0)    # [R, V]
    last_wmax = jnp.repeat(last_wmax, k, axis=0)
    last_m = jnp.repeat(last_m, k, axis=0)
    last_l = jnp.repeat(last_l, k, axis=0)
    row_len_flat = jnp.repeat(row_len, k, axis=0)       # [R]

    gen_cache = g2.init_cache(gpt2_cfg, r, n, layout="beam_gen")  # {kv: [L,N,2,R,H]}
    anc = jnp.zeros((r, n), jnp.int32)                  # ancestry: col j's writer row

    beam_scores = jnp.tile(jnp.concatenate([jnp.zeros((1,)), jnp.full((k - 1,), neg_inf)]), (b, 1))
    generated = jnp.full((b, k, n), dp.eos_id, jnp.int32)
    fin_scores = jnp.full((b, k), -jnp.inf, jnp.float32)
    fin_seqs = jnp.full((b, k, n), dp.eos_id, jnp.int32)

    # FORWARD-THEN-SELECT loop order (see greedy_or_sample): the scan carries
    # the selected token instead of the [R, Vp] logits + stats, the step-0
    # selection runs on the prefill stats outside the loop, and the final
    # (discarded) forward of the select-then-forward form is never executed.
    new_token, flat_parent, beam_scores, generated, fin_scores, fin_seqs = \
        beam_select(last_logits, beam_scores, generated, fin_scores, fin_seqs,
                    jnp.int32(0), dp, k, stats=(last_wmax, last_m, last_l),
                    spmd=gpt2_cfg.spmd_decode)
    anc = anc[flat_parent].at[:, 0].set(jnp.arange(r, dtype=jnp.int32))

    def step(carry, t):
        token_prev, gen_cache, anc, beam_scores, generated, fin_scores, fin_seqs = carry
        # forward of token t-1: its K/V lands at gen column t-1, attention
        # sees columns <= t-1; position ids count only real tokens per row
        embeds = gpt2_params["wte"][token_prev.reshape(-1)]
        positions = row_len_flat + t - 1
        (logits, wmax, m, l), gen_cache = g2.gpt2_beam_step(
            gpt2_params, embeds, positions, prefill_cache, prefill_valid,
            gen_cache, anc, t - 1, k, gpt2_cfg, wte_t=wte_t, return_stats=True,
        )
        new_token, flat_parent, beam_scores, generated, fin_scores, fin_seqs = \
            beam_select(logits, beam_scores, generated, fin_scores, fin_seqs,
                        t, dp, k, stats=(wmax, m, l),
                        spmd=gpt2_cfg.spmd_decode)
        anc = anc[flat_parent].at[:, t].set(jnp.arange(r, dtype=jnp.int32))
        carry = (
            new_token, gen_cache, anc, beam_scores, generated,
            fin_scores, fin_seqs,
        )
        return carry, None

    carry = (new_token, gen_cache, anc, beam_scores, generated,
             fin_scores, fin_seqs)
    if dp.early_stop:
        # HF is_done (early_stopping=False): a batch is done when its K
        # finished hypotheses all beat the best running beam's attainable
        # score (best_sum_logprobs / cur_len); log-probs only decrease, so
        # stopping then is exact.
        def cond(state):
            t, c = state
            _, _, _, bscores, _, fscores, _ = c
            best_possible = jnp.max(bscores, axis=1) / jnp.maximum(t.astype(jnp.float32), 1.0)
            done = jnp.min(fscores, axis=1) >= best_possible
            return (t < n) & ~jnp.all(done)

        def body(state):
            t, c = state
            c, _ = step(c, t)
            return t + 1, c

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(1), carry))
    else:
        carry, _ = jax.lax.scan(step, carry, jnp.arange(1, n, dtype=jnp.int32))
    _, _, _, beam_scores, generated, fin_scores, fin_seqs = carry
    return beam_finalize(beam_scores, generated, fin_scores, fin_seqs, n)


@partial(jax.jit, static_argnames=("gpt2_cfg", "dp"))
def generate_prefixed(
    gpt2_params,
    gpt2_cfg: g2.GPT2Config,
    prefix: jax.Array,        # [B, P, H] visual prefix embeddings
    prompt_ids: jax.Array,    # [B, L] LEFT-padded prompt token ids
    prompt_mask: jax.Array,   # [B, L] 1 = real prompt token
    dp: DecodeParams,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    """One-dispatch decode: wte lookup, prefix|prompt concat, prefill and the
    whole scan run inside a single compiled program (eager embedding
    construction costs one dispatch per op).

    Layout per row is [prefix, pad..., prompt]; the pads sit BETWEEN prefix
    and prompt but carry mask 0, which is attention- and position-equivalent
    to left padding (positions are cumsum over the mask)."""
    tok = gpt2_params["wte"][prompt_ids]
    embeds = jnp.concatenate([prefix.astype(tok.dtype), tok], axis=1)
    mask = jnp.concatenate(
        [jnp.ones(prefix.shape[:2], jnp.int32), prompt_mask.astype(jnp.int32)], axis=1
    )
    if dp.num_beams > 1:
        return beam_search(gpt2_params, gpt2_cfg, embeds, dp, mask)
    return greedy_or_sample(gpt2_params, gpt2_cfg, embeds, dp, rng, mask)


@partial(jax.jit, static_argnames=("gpt2_cfg", "dp"))
def generate(
    gpt2_params,
    gpt2_cfg: g2.GPT2Config,
    inputs_embeds: jax.Array,
    dp: DecodeParams,
    rng: Optional[jax.Array] = None,
    prefill_mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Dispatch on the (static) decode policy. Returns ids [B, max_new_tokens].

    ``prefill_mask`` [B, S0] marks real (non-pad) prompt tokens for
    LEFT-padded batching of different-length prompts in one program — the
    multi-preset engine optimization (SURVEY §7 hard part 6).
    """
    if dp.num_beams > 1:
        return beam_search(gpt2_params, gpt2_cfg, inputs_embeds, dp, prefill_mask)
    return greedy_or_sample(gpt2_params, gpt2_cfg, inputs_embeds, dp, rng, prefill_mask)
