"""Unified per-row-policy decode: every preset of every video in ONE program.

SURVEY §7 hard part 6. The reference answers "3 presets per request" with
3 sequential full decodes (core/engine.py:75-79); round 2 of this rebuild
merged *identical* policies into batched programs, but different policies
(the beam presets vs the sampled preset) still ran as separate programs —
each re-streaming the full GPT-2 weights every decode step.

This module decodes ALL policy groups in one compiled program, laid out
UNIFORMLY: every prompt instance carries K_max = max(num_beams) decode rows,
so the transformer step is exactly ``g2.gpt2_beam_step`` over the whole
instance set — one qkv/proj/MLP/LM-head weight stream and one attention
einsum chain for every policy at once. Narrower groups pad with dead rows
(identity ancestry, EOS tokens, never selected); a sampled/greedy row is the
k=0 live row of its instance block. Token selection runs per group (static
slices) through the exact single-policy helpers (``beam_select`` /
``sample_select``), so outputs are identical to the grouped path; groups
with a shorter ``max_new_tokens`` FREEZE (carry held via ``jnp.where``)
while the shared scan runs to the longest horizon.

Row uniformity: per-group attention over row slices of the shared caches
makes XLA materialize the `cache[layer, a:b]` slices every step; uniform
rows remove every per-group cache slice at the cost of dead-row compute in
the (cheap) activation matmuls.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from video_caption_tpu.decode.generate import (
    DecodeParams, _prefill, beam_finalize, beam_select, sample_select,
)
from video_caption_tpu.models import gpt2 as g2


@partial(jax.jit, static_argnames=("gpt2_cfg", "dps"))
def generate_unified(
    gpt2_params,
    gpt2_cfg: g2.GPT2Config,
    prefix: jax.Array,              # [V, P, H] visual prefix embeddings
    prompts: Tuple[Tuple[jax.Array, jax.Array], ...],  # per group: (ids [n_g,L_g], mask [n_g,L_g])
    dps: Tuple[DecodeParams, ...],  # static — one policy per group
    rngs: Tuple[jax.Array, ...],    # one key per group (sampled groups consume it)
) -> Tuple[jax.Array, ...]:
    """Decode V videos under every policy group at once.

    Group g contributes I_g = V * n_g prompt instances (video-major row
    order, matching the grouped engine path) and returns ids
    [I_g, dp.max_new_tokens]. Row order inside a group and the returned
    token ids are IDENTICAL to running ``generate_prefixed`` per group
    with the same per-group rng keys.
    """
    v, p, h = prefix.shape
    wte = gpt2_params["wte"]
    l_max = max(int(ids.shape[1]) for ids, _ in prompts)
    n_max = max(dp.max_new_tokens for dp in dps)
    k_max = max(dp.num_beams for dp in dps)
    s0 = p + l_max

    # ---- prefill rows: group-major, video-major within a group ------------
    emb_rows, mask_rows, n_inst = [], [], []
    for ids_g, mask_g in prompts:
        n_g, l_g = ids_g.shape
        tok = wte[ids_g]                                    # [n_g, L_g, H]
        mask_g = mask_g.astype(jnp.int32)
        if l_g < l_max:
            # extra pad sits BETWEEN prefix and prompt with mask 0 — position-
            # and attention-equivalent to the group's own shorter padding
            tok = jnp.pad(tok, ((0, 0), (l_max - l_g, 0), (0, 0)))
            mask_g = jnp.pad(mask_g, ((0, 0), (l_max - l_g, 0)))
        tok_v = jnp.tile(tok, (v, 1, 1))                    # [(V*n_g), L_max, H]
        mask_v = jnp.tile(mask_g, (v, 1))
        pre = jnp.repeat(prefix, n_g, axis=0)               # [(V*n_g), P, H]
        emb_rows.append(jnp.concatenate([pre.astype(tok_v.dtype), tok_v], axis=1))
        mask_rows.append(jnp.concatenate(
            [jnp.ones((v * n_g, p), jnp.int32), mask_v], axis=1))
        n_inst.append(v * n_g)
    embeds = jnp.concatenate(emb_rows, axis=0)              # [I_tot, S0, H]
    pmask = jnp.concatenate(mask_rows, axis=0)
    i_tot = sum(n_inst)
    r_tot = i_tot * k_max

    # ONE prefill for every instance of every group (weights stream once);
    # transposed+padded LM head hoisted out of the scan (g2.lm_head_t), and
    # the selection statistics (window maxima + row max/sum-exp) computed in
    # the same pass (g2.lm_stats) — threaded through the scan carry so every
    # group's selection skips its [R, V]-wide reductions
    wte_t = g2.lm_head_t(gpt2_params, gpt2_cfg)
    (last_inst, wmax_inst, m_inst, l_inst), prefill_cache, prefill_valid, \
        row_len = _prefill(
            gpt2_params, gpt2_cfg, embeds, s0, pmask, cache_layout="split",
            wte_t=wte_t, return_stats=True,
        )

    # ---- uniform decode rows: instance i owns rows [i*K_max, (i+1)*K_max);
    # live rows are the first K_g of the block, the rest are dead padding --
    neg_inf = jnp.float32(-1e9)
    states, ll_rows, anc_rows, stat_rows = [], [], [], []
    i_off = 0
    for g, dp in enumerate(dps):
        i, k, n = n_inst[g], dp.num_beams, dp.max_new_tokens
        ll = last_inst[i_off:i_off + i]
        # every row of the block (live or dead) gets the instance's prefill
        # logits — dead rows' selections are never read
        ll_rows.append(jnp.repeat(ll, k_max, axis=0))
        stat_rows.append(tuple(
            jnp.repeat(s[i_off:i_off + i], k_max, axis=0)
            for s in (wmax_inst, m_inst, l_inst)))
        block_ids = ((i_off + jnp.arange(i, dtype=jnp.int32))[:, None] * k_max
                     + jnp.arange(k_max, dtype=jnp.int32)[None, :])  # [I_g, K_max]
        if k > 1:
            # live beam rows start with the zeros ancestry of beam_search;
            # dead rows keep identity ancestry forever
            anc_g = jnp.where(
                (jnp.arange(k_max) < k)[None, :, None],
                jnp.zeros((i, k_max, n_max), jnp.int32),
                jnp.broadcast_to(block_ids[:, :, None], (i, k_max, n_max)),
            )
            beam_scores = jnp.tile(jnp.concatenate(
                [jnp.zeros((1,)), jnp.full((k - 1,), neg_inf)]), (i, 1))
            states.append((
                beam_scores,
                jnp.full((i, k, n), dp.eos_id, jnp.int32),
                jnp.full((i, k), -jnp.inf, jnp.float32),
                jnp.full((i, k, n), dp.eos_id, jnp.int32),
            ))
        else:
            # sampled/greedy: the k=0 row is live with identity ancestry
            anc_g = jnp.broadcast_to(block_ids[:, :, None], (i, k_max, n_max))
            states.append((
                jnp.full((i, n), dp.eos_id, jnp.int32),
                jnp.zeros((i,), bool),
                rngs[g],
            ))
        anc_rows.append(anc_g.reshape(i * k_max, n_max))
        i_off += i
    last_logits = jnp.concatenate(ll_rows, axis=0)          # [R_tot, V]
    last_wmax = jnp.concatenate([s[0] for s in stat_rows], axis=0)
    last_m = jnp.concatenate([s[1] for s in stat_rows], axis=0)
    last_l = jnp.concatenate([s[2] for s in stat_rows], axis=0)
    anc0 = jnp.concatenate(anc_rows, axis=0)                # [R_tot, N_max]
    row_len_rows = jnp.repeat(row_len, k_max, axis=0)       # [R_tot]
    gen_cache = g2.init_cache(gpt2_cfg, r_tot, n_max, layout="beam_gen")

    def select_all(stats, anc, states, t):
        """One selection pass over every group (the non-forward half of the
        step). Returns (token_vec [R_tot], new anc, new states)."""
        last_logits, last_wmax, last_m, last_l = stats
        tokens, anc_parts, new_states = [], [], []
        i_off = 0
        for g, dp in enumerate(dps):
            i, k, n = n_inst[g], dp.num_beams, dp.max_new_tokens
            r0 = i_off * k_max
            rg = i * k_max
            blk_ll = last_logits[r0:r0 + rg].reshape(i, k_max, -1)
            blk_wmax = last_wmax[r0:r0 + rg].reshape(i, k_max, -1)
            blk_m = last_m[r0:r0 + rg].reshape(i, k_max)
            blk_l = last_l[r0:r0 + rg].reshape(i, k_max)
            blk_anc = anc[r0:r0 + rg].reshape(i, k_max, n_max)
            live = t < n            # False once this group's horizon passed
            own_idx = ((i_off + jnp.arange(i, dtype=jnp.int32))[:, None] * k_max
                       + jnp.arange(k, dtype=jnp.int32)[None, :]).reshape(-1)
            if k > 1:
                bs, gen, fs, fseq = states[g]
                ll_live = blk_ll[:, :k].reshape(i * k, -1)
                stats_live = (blk_wmax[:, :k].reshape(i * k, -1),
                              blk_m[:, :k].reshape(i * k),
                              blk_l[:, :k].reshape(i * k))
                tok2d, flat_parent, nbs, ngen, nfs, nfseq = beam_select(
                    ll_live, bs, gen, fs, fseq, t, dp, k, stats=stats_live,
                    spmd=gpt2_cfg.spmd_decode)
                live_anc = blk_anc[:, :k].reshape(i * k, n_max)
                new_live = live_anc[flat_parent].at[:, t].set(own_idx)
                anc_new = (jnp.concatenate(
                    [new_live.reshape(i, k, n_max), blk_anc[:, k:]], axis=1)
                    if k < k_max else new_live.reshape(i, k, n_max))
                tok_blk = jnp.full((i, k_max), dp.eos_id, jnp.int32)
                tok_blk = tok_blk.at[:, :k].set(tok2d)
                if n < n_max:       # freeze past the group's horizon
                    nbs = jnp.where(live, nbs, bs)
                    ngen = jnp.where(live, ngen, gen)
                    nfs = jnp.where(live, nfs, fs)
                    nfseq = jnp.where(live, nfseq, fseq)
                    anc_new = jnp.where(live, anc_new, blk_anc)
                    tok_blk = jnp.where(live, tok_blk, dp.eos_id)
                new_states.append((nbs, ngen, nfs, nfseq))
            else:
                gen, fin, rng_g = states[g]
                tok, ngen, nfin, nrng = sample_select(
                    blk_ll[:, 0], gen, fin, t, dp, rng_g, wmax=blk_wmax[:, 0],
                    spmd=gpt2_cfg.spmd_decode)
                anc_new = blk_anc     # identity ancestry never changes
                tok_blk = jnp.full((i, k_max), dp.eos_id, jnp.int32)
                tok_blk = tok_blk.at[:, 0].set(tok)
                if n < n_max:
                    ngen = jnp.where(live, ngen, gen)
                    nfin = jnp.where(live, nfin, fin)
                    tok_blk = jnp.where(live, tok_blk, dp.eos_id)
                new_states.append((ngen, nfin, nrng))
            tokens.append(tok_blk.reshape(-1))
            anc_parts.append(anc_new.reshape(rg, n_max))
            i_off += i
        return (jnp.concatenate(tokens), jnp.concatenate(anc_parts, axis=0),
                tuple(new_states))

    # FORWARD-THEN-SELECT loop order (generate.greedy_or_sample docstring):
    # the step-0 selection runs on the prefill stats outside the loop, the
    # scan carries only the token vector (not the [R_tot, Vp] logits + stats
    # whose back-edge layout forced a full relayout copy per step), and the
    # final discarded forward of the select-then-forward form never runs.
    token_vec, anc, states = select_all(
        (last_logits, last_wmax, last_m, last_l), anc0, tuple(states),
        jnp.int32(0))

    def step(carry, t):
        token_prev, gen_kv, anc, states = carry
        embeds = wte[token_prev]
        positions = row_len_rows + t - 1
        stats, new_cache = g2.gpt2_beam_step(
            gpt2_params, embeds, positions, prefill_cache, prefill_valid,
            {"kv": gen_kv}, anc, t - 1, k_max, gpt2_cfg, wte_t=wte_t,
            return_stats=True,
        )
        token_vec, anc, states = select_all(stats, anc, states, t)
        return (token_vec, new_cache["kv"], anc, states), None

    carry = (token_vec, gen_cache["kv"], anc, states)
    carry, _ = jax.lax.scan(step, carry, jnp.arange(1, n_max, dtype=jnp.int32))
    states = carry[-1]

    outs = []
    for g, dp in enumerate(dps):
        if dp.num_beams > 1:
            bs, gen, fs, fseq = states[g]
            outs.append(beam_finalize(bs, gen, fs, fseq, dp.max_new_tokens))
        else:
            outs.append(states[g][0])
    return tuple(outs)
