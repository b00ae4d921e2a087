"""Jit-friendly logits processors reproducing HF generate semantics over
fixed-size generated-token buffers (SURVEY §7 hard parts 1-3).

Semantics notes (matching HF when called with ``inputs_embeds`` only, as the
reference does at text_decoder.py:131-144): the prompt is consumed as embeds,
so repetition penalty and no-repeat-ngram operate on **generated tokens
only**; ``min_new_tokens`` bans EOS until the threshold.

All functions take ``generated [B, N]`` (static N = max_new_tokens) plus the
current step ``t`` (traced scalar) and mask by position — no dynamic shapes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def apply_repetition_penalty(
    logits: jax.Array,      # [B, V] fp32
    generated: jax.Array,   # [B, N] int32
    t: jax.Array,           # scalar int32 — tokens generated so far
    penalty: float,
) -> jax.Array:
    """HF CFG-style penalty: seen & score>0 -> score/p, seen & score<=0 -> score*p.

    Implemented exactly like HF's RepetitionPenaltyLogitsProcessor — gather
    the [B,N] seen scores, penalize, scatter back — instead of materializing
    a [B,V] presence buffer (a 38 MB broadcast+scatter+select per decode step
    at B=192/V=50257 on the profiler trace). Duplicate seen tokens scatter
    identical values; not-yet-generated positions scatter out-of-bounds and
    are dropped."""
    if penalty == 1.0:
        return logits
    b, v = logits.shape
    n = generated.shape[1]
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, n), 1)
    seen = pos < t
    rows = jax.lax.broadcasted_iota(jnp.int32, (b, n), 0)
    cur = logits[rows, generated]                            # gather [B, N]
    pen = jnp.where(cur > 0, cur / penalty, cur * penalty)
    idx = jnp.where(seen, generated, v)                      # OOB => dropped
    return logits.at[rows, idx].set(pen, mode="drop")


def _ngram_banned(generated: jax.Array, t: jax.Array, ngram_size: int):
    """Tokens banned by the no-repeat-ngram rule at step t.

    Returns (banned_tok [B, starts], match [B, starts]): ban token
    banned_tok[b, i] for row b iff match[b, i]. For each start i <= t-n,
    the (n-1)-token context ending at t-1 is compared against
    generated[i : i+n-1]; matching starts ban generated[i+n-1]."""
    b, n_buf = generated.shape
    ctx = ngram_size - 1
    # context tokens generated[t-ctx : t]: dynamic_slice (start clamps into
    # range exactly like the old clipped-gather; t < ctx rows are masked by
    # ``valid`` below either way)
    ctx_tok = jax.lax.dynamic_slice_in_dim(generated, t - ctx, ctx, axis=1)

    starts = n_buf - ctx  # candidate start positions 0..starts-1
    # windows[:, i, j] = generated[:, i+j] — STATIC slices stacked over the
    # (static) ctx axis. A fancy-index form generated[:, win_idx] lowers to
    # a gather for what is a view-shift of the buffer.
    windows = jnp.stack(
        [generated[:, j:j + starts] for j in range(ctx)], axis=-1
    )                                                        # [B, starts, ctx]
    match = jnp.all(windows == ctx_tok[:, None, :], axis=-1)  # [B, starts]
    # start i is a *completed* ngram only if its last token i+ctx-1 <= t-1
    # and the banned continuation i+ctx <= t-1 was itself generated
    i_pos = jax.lax.broadcasted_iota(jnp.int32, (b, starts), 1)
    valid = (i_pos + ctx <= t - 1) & (t >= ctx)
    return generated[:, ctx:], match & valid


def apply_no_repeat_ngram(
    logits: jax.Array,      # [B, V]
    generated: jax.Array,   # [B, N]
    t: jax.Array,           # scalar — next token index to be generated
    ngram_size: int,
) -> jax.Array:
    """Ban token x if (generated[t-n+1 : t], x) already occurred as an n-gram."""
    if ngram_size <= 0:
        return logits
    b, v = logits.shape
    if generated.shape[1] < ngram_size:
        return logits
    banned_tok, match = _ngram_banned(generated, t, ngram_size)
    starts = banned_tok.shape[1]
    rows = jax.lax.broadcasted_iota(jnp.int32, (b, starts), 0)
    # scatter -inf at matched continuations only (OOB index => dropped);
    # avoids a [B,V] ban buffer per step
    ban_idx = jnp.where(match, banned_tok, v)
    return logits.at[rows, ban_idx].set(jnp.float32(-jnp.inf), mode="drop")


def exact_topk(scores: jax.Array, k: int, window: int = 0,
               wmax: jax.Array = None, spmd: bool = False):
    """Exact top-k over the vocab axis via a two-stage windowed reduction:
    per-window max -> top-k windows -> top-k within the gathered window
    contents. Returns (vals [B,k], idxs [B,k]) descending.

    Exactness: if value v is in the true top-k, fewer than k windows have a
    max exceeding v (each such window would contribute an element above v),
    so v's window is always among the top-k window maxima. The full [B,V]
    buffer is read ONCE (a max reduce that fuses into its producer);
    everything after runs on [B, k·window]-sized data, instead of one sort
    over the whole vocabulary per row.

    Tie-break: equal values resolve by (window max-rank, in-window position)
    rather than lax.top_k's global ascending index; observable only when the
    same f32 value straddles the k-th place across different windows — for
    continuous logits that is the all--inf tail case, where every returned
    score is identically -inf anyway (candidate sets differing only among
    -inf entries select nothing downstream: processors and samplers see
    -inf). ``lax.top_k`` is used unchanged for the small final sorts.
    """
    b, v = scores.shape
    if k >= v:
        return jax.lax.top_k(scores, v)
    if wmax is not None:
        # precomputed window maxima (g2.lm_stats computes them beside the
        # logits); scores must already be an exact multiple of the window
        # with -inf pads
        nwin = wmax.shape[1]
        window = v // nwin
        assert nwin * window == v, (v, nwin)
        kw = min(k, nwin)
        _, widx = jax.lax.top_k(wmax, kw)
        cand = _gather_windows(scores, widx, nwin, window, spmd)
        vals, ci = _topk_flat(cand.reshape(b, kw * window), k, spmd=spmd)
        idxs = jnp.take_along_axis(widx, ci // window, axis=1) * window + ci % window
        return vals, idxs
    if window <= 0:
        # the LM head pads the vocabulary to a multiple of 128
        # (g2.lm_head_t), so its logits take this window with no copy
        window = 128
    nwin = -(-v // window)
    pad = nwin * window - v
    if pad:
        scores_p = jnp.pad(scores, ((0, 0), (0, pad)),
                           constant_values=jnp.float32(-jnp.inf))
    else:
        scores_p = scores
    # gathering candidates elementwise (take_along_axis with [B,k*w]
    # indices) is a scattered gather; the BLOCK gather below reads whole
    # windows along axis 1.
    sw = scores_p.reshape(b, nwin, window)
    wmax = jnp.max(sw, axis=-1)                              # [B, nwin]
    kw = min(k, nwin)
    _, widx = jax.lax.top_k(wmax, kw)                        # [B, kw]
    cand = _gather_windows(scores_p, widx, nwin, window, spmd)  # [B, kw, w]
    # the flat candidate set [B, kw*window] can still be thousands wide, so
    # recurse with a narrow sub-window until the final sort is small
    vals, ci = _topk_flat(cand.reshape(b, kw * window), k, spmd=spmd)
    idxs = jnp.take_along_axis(widx, ci // window, axis=1) * window + ci % window
    return vals, idxs


def _gather_windows(scores_p: jax.Array, widx: jax.Array,
                    nwin: int, window: int, spmd: bool = False) -> jax.Array:
    """Gather whole windows of the padded [B, nwin*window] score buffer as
    ROWS of its flat [B*nwin, window] view (embedding-lookup shape: slice
    size [1, window] along the major axis of a row-major operand).

    ``take_along_axis(sw, widx[:, :, None], axis=1)`` is the same gather;
    the flat-row form consumes the row-major buffer in place without a
    relayout of the logits. Pure data movement — bit-identical values."""
    b = scores_p.shape[0]
    if spmd:
        # batch-preserving form: the flat-row gather below flattens batch x
        # window across the mesh sharding, and GSPMD answers with an
        # all-gather of the gathered candidate windows EVERY decode step
        # (caught by the graft-entry decode-collective gate).
        sw = scores_p.reshape(b, nwin, window)
        return jnp.take_along_axis(sw, widx[:, :, None], axis=1)
    flat = scores_p.reshape(b * nwin, window)
    rows = jnp.arange(b, dtype=widx.dtype)[:, None] * nwin + widx   # [B, kw]
    return flat[rows.reshape(-1)].reshape(b, widx.shape[1], window)


def _topk_flat(flat: jax.Array, k: int, sub: int = 8, small: int = 512,
               spmd: bool = False):
    """top-k of [B, M] via recursive windowed reduction (same exactness
    argument as exact_topk: the true top-k lie in the top-k sub-windows by
    max). Terminates at lax.top_k once M <= max(small, k*sub)."""
    b, m = flat.shape
    if m <= max(small, k * sub):
        return jax.lax.top_k(flat, k)
    nsub = -(-m // sub)
    if nsub * sub != m:
        flat = jnp.pad(flat, ((0, 0), (0, nsub * sub - m)),
                       constant_values=jnp.float32(-jnp.inf))
    fw = flat.reshape(b, nsub, sub)
    smax = jnp.max(fw, axis=-1)                              # [B, nsub]
    _, sidx = jax.lax.top_k(smax, k)                         # [B, k]
    cand = _gather_windows(flat, sidx, nsub, sub, spmd)      # [B, k, sub]
    vals, ci = jax.lax.top_k(cand.reshape(b, k * sub), k)
    idxs = jnp.take_along_axis(sidx, ci // sub, axis=1) * sub + ci % sub
    return vals, idxs


def topk_processed(
    scores: jax.Array,      # [B, V] raw logits or log-probs
    generated: jax.Array,   # [B, N] int32
    t: jax.Array,           # scalar int32 — tokens generated so far
    k: int,
    repetition_penalty: float,
    ngram_size: int,
    min_new_tokens: int,
    eos_id: int,
    shift_max: jax.Array = None,      # [B] optional log-softmax conversion:
    shift_logsum: jax.Array = None,   # vals := (vals - max) - logsum
    wmax: jax.Array = None,           # [B, V/window] precomputed window maxima
    spmd: bool = False,               # mesh-safe candidate gather (exact_topk)
):
    """Top-k of the processor-chain-modified scores WITHOUT materializing or
    scattering into [B, V]: returns (vals [B, k], idxs [B, k]) sorted by
    modified score, descending.

    The full-vocab processor chain (apply_repetition_penalty ->
    apply_no_repeat_ngram -> apply_min_new_tokens) costs two scatter passes
    over [B, V] per decode step. But when ``repetition_penalty >= 1`` every
    processor only LOWERS scores, and only of a known small set: at most
    N (repetition) + N-ngram+1 (ngram bans) + 1 (eos) tokens per row. Any
    token in the modified top-k therefore sits within the RAW top-(k+bound):
    a non-penalized token outranked in raw order only by penalized tokens
    can drop past at most ``bound`` of them, and a penalized token in the
    modified top-k was already in the raw top-k. So: take the raw
    top-(k+bound) candidates once, apply the chain to those C values via
    membership tests against the [B, N] generated buffer (O(B*C*N) ops),
    and re-rank — EXACT, one partial sort, zero [B, V] writes.

    Tie-break: equal modified scores resolve by raw-score rank instead of
    HF's token-id order — observable only on exact f32 ties, i.e. -inf vs
    -inf when a row has fewer than k finite candidates.

    Callers must check ``repetition_penalty >= 1`` (penalty < 1 RAISES seen
    scores and breaks the containment bound — take the scatter path).
    """
    b, v = scores.shape
    k = min(k, v)  # tiny-vocab configs: degrade exactly like sample_top_k_top_p
    n_buf = generated.shape[1]
    # the penalized superset is {generated tokens} ∪ {eos}: repetition touches
    # exactly the generated buffer, and every ngram-banned continuation
    # generated[i+ctx] IS a generated token — so bound = N + 1, not
    # N + (N-ngram+1) + 1
    bound = n_buf + 1
    c = min(k + bound, v)
    # exact top-C via the two-stage windowed reduction (exact_topk): one
    # fused read of [B,V] + small sorts instead of a full-vocab sort.
    vals, idxs = exact_topk(scores, c, wmax=wmax, spmd=spmd)  # [B,C] desc
    if shift_max is not None:
        # beam path: rank on RAW logits (log-softmax is monotone per row, so
        # candidate CONTAINMENT and order are unchanged), then convert only
        # the C candidate values — ((x - max) - logsum) in exactly
        # jax.nn.log_softmax's association, so the values are bit-identical
        # to extracting from a materialized [B,V] log-softmax. Skips two
        # full-vocab passes + a layout-transposing copy per decode step.
        vals = (vals - shift_max[:, None]) - shift_logsum[:, None]

    pos = jax.lax.broadcasted_iota(jnp.int32, (b, n_buf), 1)
    gen_seen = pos < t                                       # [B, N]
    # candidate membership in the generated buffer: [B, C, N] compare
    hits = (idxs[:, :, None] == generated[:, None, :]) & gen_seen[:, None, :]

    if repetition_penalty != 1.0:
        seen = jnp.any(hits, axis=-1)                        # [B, C]
        pen = jnp.where(vals > 0, vals / repetition_penalty, vals * repetition_penalty)
        vals = jnp.where(seen, pen, vals)
    if ngram_size > 0 and n_buf >= ngram_size:
        banned_tok, match = _ngram_banned(generated, t, ngram_size)
        banned = jnp.any(
            (idxs[:, :, None] == banned_tok[:, None, :]) & match[:, None, :], axis=-1
        )
        vals = jnp.where(banned, jnp.float32(-jnp.inf), vals)
    if min_new_tokens > 0:
        ban_eos = (idxs == eos_id) & (t < min_new_tokens)
        vals = jnp.where(ban_eos, jnp.float32(-jnp.inf), vals)

    # always re-rank: the penalties just applied can reorder the C set
    top_vals, pick = jax.lax.top_k(vals, k)
    return top_vals, jnp.take_along_axis(idxs, pick, axis=-1)


def apply_min_new_tokens(
    logits: jax.Array, t: jax.Array, min_new_tokens: int, eos_id: int
) -> jax.Array:
    """EOS is unreachable until ``min_new_tokens`` have been generated
    (HF MinNewTokensLengthLogitsProcessor; reference default min_new=8,
    text_decoder.py:114)."""
    if min_new_tokens <= 0:
        return logits
    ban = t < min_new_tokens
    eos_col = logits[:, eos_id]
    new_col = jnp.where(ban, jnp.float32(-jnp.inf), eos_col)
    return logits.at[:, eos_id].set(new_col)


def apply_temperature(logits: jax.Array, temperature: float) -> jax.Array:
    if temperature == 1.0 or temperature <= 0:
        return logits
    return logits / jnp.float32(temperature)


def apply_top_k(logits: jax.Array, top_k: int) -> jax.Array:
    """Keep only the top_k logits per row (HF TopKLogitsWarper)."""
    if top_k <= 0:
        return logits
    v = logits.shape[-1]
    k = min(top_k, v)
    kth = jax.lax.top_k(logits, k)[0][..., -1:]
    return jnp.where(logits < kth, jnp.float32(-jnp.inf), logits)


def apply_top_k_top_p(logits: jax.Array, top_k: int, top_p: float) -> jax.Array:
    """Fused HF warper chain TopK(k) -> TopP(p) with ONE lax.top_k pass.

    HF applies TopP on the TopK-filtered logits, so the nucleus always lies
    within the top-k set — softmax over the filtered distribution equals
    softmax over just the top-k values. EXACT equivalence to the sequential
    warpers, at one [B,V] partial-sort instead of two (the second of which
    was the 2048-wide nucleus sort).
    """
    if top_k <= 0:
        return apply_top_p(logits, top_p)
    if top_p >= 1.0:
        return apply_top_k(logits, top_k)
    v = logits.shape[-1]
    k = min(top_k, v)
    top_vals, _ = jax.lax.top_k(logits, k)                       # descending
    kth = top_vals[..., -1:]
    # softmax over the top-k set == softmax over TopK-filtered logits
    lse = jax.nn.logsumexp(top_vals, axis=-1, keepdims=True)
    probs = jnp.exp(top_vals - lse)
    cum = jnp.cumsum(probs, axis=-1)
    keep_sorted = (cum - probs) < top_p
    nucleus_thresh = jnp.min(
        jnp.where(keep_sorted, top_vals, jnp.float32(jnp.inf)), axis=-1, keepdims=True
    )
    thresh = jnp.maximum(kth, nucleus_thresh)
    return jnp.where(logits >= thresh, logits, jnp.float32(-jnp.inf))


def sample_top_k_top_p(
    rng: jax.Array, logits: jax.Array, top_k: int, top_p: float
) -> jax.Array:
    """Draw one token per row from the TopK->TopP-filtered distribution
    WITHOUT materializing filtered [B,V] logits or a [B,V] categorical.

    Distribution-exact shortcut: tokens outside the top-k have zero
    probability after the warpers, so sampling the k-way renormalized
    nucleus and mapping through the top-k indices equals a full-vocab
    categorical over the filtered logits. One [B,V] partial-sort total.
    """
    v = logits.shape[-1]
    k = min(top_k if top_k > 0 else v, v)
    vals, idxs = exact_topk(logits, k)                       # [B, k] descending
    return sample_sorted_top_p(rng, vals, idxs, top_p)


def sample_sorted_top_p(
    rng: jax.Array,
    vals: jax.Array,    # [B, k] candidate scores, sorted descending per row
    idxs: jax.Array,    # [B, k] the candidates' vocab ids
    top_p: float,
) -> jax.Array:
    """Nucleus-filter + categorical over an already-selected sorted top-k
    candidate set; returns one vocab id per row. The tail half of
    sample_top_k_top_p, shared with the candidate-set decode path
    (topk_processed) so both sample identically given identical values."""
    if top_p < 1.0:
        lse = jax.nn.logsumexp(vals, axis=-1, keepdims=True)
        probs = jnp.exp(vals - lse)
        cum = jnp.cumsum(probs, axis=-1)
        keep = (cum - probs) < top_p
        vals = jnp.where(keep, vals, jnp.float32(-jnp.inf))
    choice = jax.random.categorical(rng, vals, axis=-1)      # [B] in [0, k)
    return jnp.take_along_axis(idxs, choice[:, None], axis=-1)[:, 0]


def apply_top_p(logits: jax.Array, top_p: float, nucleus_cap: int = 2048) -> jax.Array:
    """Nucleus filtering (HF TopPLogitsWarper, min_tokens_to_keep=1).

    A full [B, 50k] sort per decode step is a hidden hot spot; instead
    the nucleus is computed within the top ``nucleus_cap`` logits via
    lax.top_k (O(V) vs O(V log V)). Exactness: identical to the full sort
    whenever the nucleus fits in the cap — for top_p<=0.95 on a trained LM
    the nucleus is tens of tokens; a pathologically flat distribution is
    truncated to the cap (documented deviation). cap >= vocab degenerates to
    the exact algorithm.
    """
    if top_p >= 1.0:
        return logits
    v = logits.shape[-1]
    k = min(nucleus_cap, v)
    top_logits, _ = jax.lax.top_k(logits, k)                      # descending
    # softmax over the FULL vocab (HF semantics), evaluated on the top-k set
    lse = jax.nn.logsumexp(logits, axis=-1, keepdims=True)
    probs = jnp.exp(top_logits - lse)
    cum = jnp.cumsum(probs, axis=-1)
    keep_sorted = (cum - probs) < top_p
    thresholds = jnp.min(
        jnp.where(keep_sorted, top_logits, jnp.float32(jnp.inf)), axis=-1, keepdims=True
    )
    return jnp.where(logits >= thresholds, logits, jnp.float32(-jnp.inf))
