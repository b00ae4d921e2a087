"""The plain XLA paths that replaced the hand-written kernels, each against
an independent NumPy float64 reference: temporal pool (cls/gap), prefix
projector, encoder attention and its gradient, beam decode attention
(including more than 256 beam rows) and the LM-head selection statistics."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_caption_tpu.models import caption_model as cm
from video_caption_tpu.models import gpt2 as g2
from video_caption_tpu.models import vit as vt


def _np(x):
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("mode", ["cls", "gap"])
def test_pool_temporal_matches_numpy(mode, dtype):
    b, t, s, h = 3, 4, 7, 32
    tokens = jax.random.normal(jax.random.PRNGKey(0), (b * t, s, h)).astype(dtype)
    cfg = vt.ViTConfig(pool=mode)
    out = vt.pool_temporal(tokens, b, t, cfg)
    x = _np(tokens.astype(jnp.float32)).reshape(b, t, s, h)
    per_frame = x[:, :, 0] if mode == "cls" else x[:, :, 1:].mean(axis=2)
    ref = per_frame.mean(axis=1)
    assert out.shape == (b, h) and out.dtype == dtype
    tol = 1e-6 if dtype == jnp.float32 else 1e-2
    np.testing.assert_allclose(_np(out.astype(jnp.float32)), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("cond_mode", ["prefix", "bos"])
def test_prefix_projector_matches_numpy(cond_mode):
    cfg = cm.CaptionModelConfig(
        gpt2=g2.GPT2Config(n_embd=64, n_layer=1, n_head=2, vocab_size=128),
        prefix_len=4, video_dim=16, cond_mode=cond_mode)
    rng = np.random.RandomState(0)
    w = rng.randn(16, cfg.mapper_out).astype(np.float32)
    b = rng.randn(cfg.mapper_out).astype(np.float32)
    emb = rng.randn(5, 16).astype(np.float32)
    out = cm.map_prefix({"mapper": {"w": jnp.asarray(w), "b": jnp.asarray(b)}},
                        jnp.asarray(emb), cfg)
    ref = _np(emb) @ _np(w) + _np(b)
    if cond_mode == "bos":
        ref = np.tanh(ref)[:, None, :]
    else:
        ref = ref.reshape(5, 4, 64)
    np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-5)


def _attention_ref(qkv, nh):
    """Per-frame, per-head softmax attention in float64."""
    n, s, three_h = qkv.shape
    h = three_h // 3
    hd = h // nh
    x = _np(qkv).reshape(n, s, 3, nh, hd)
    out = np.empty((n, s, nh, hd))
    for i in range(n):
        for head in range(nh):
            q, k, v = x[i, :, 0, head], x[i, :, 1, head], x[i, :, 2, head]
            logits = q @ k.T / np.sqrt(hd)
            p = np.exp(logits - logits.max(axis=-1, keepdims=True))
            out[i, :, head] = (p / p.sum(axis=-1, keepdims=True)) @ v
    return out.reshape(n, s, h)


@pytest.mark.parametrize("seq", [13, 197])   # odd lengths, as the ViT's 197
def test_encoder_attention_matches_numpy(seq):
    cfg = vt.ViTConfig(embed_dim=128, num_heads=2, dtype=jnp.float32)
    qkv = jax.random.normal(jax.random.PRNGKey(1), (2, seq, 3 * 128))
    out = vt._attention_core(qkv, cfg)
    np.testing.assert_allclose(_np(out), _attention_ref(qkv, 2), rtol=1e-5, atol=1e-5)


def test_encoder_attention_gradient_matches_numpy_rule():
    """Backprop through the plain attention (joint training differentiates
    the trunk) against the closed-form softmax-attention gradient."""
    nh, hd, s = 2, 8, 5
    cfg = vt.ViTConfig(embed_dim=nh * hd, num_heads=nh, dtype=jnp.float32)
    qkv = jax.random.normal(jax.random.PRNGKey(2), (1, s, 3 * nh * hd))
    g_out = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, s, nh * hd)), np.float64)
    grad = jax.grad(lambda x: jnp.sum(vt._attention_core(x, cfg) * g_out))(qkv)

    x = _np(qkv).reshape(s, 3, nh, hd)
    ref = np.zeros_like(x)
    for head in range(nh):
        q, k, v = x[:, 0, head], x[:, 1, head], x[:, 2, head]
        p = np.exp(q @ k.T / np.sqrt(hd))
        p /= p.sum(axis=-1, keepdims=True)
        do = g_out[0].reshape(s, nh, hd)[:, head]
        dp = do @ v.T
        ds = p * (dp - (dp * p).sum(axis=-1, keepdims=True)) / np.sqrt(hd)
        ref[:, 0, head], ref[:, 1, head], ref[:, 2, head] = ds @ k, ds.T @ q, p.T @ do
    np.testing.assert_allclose(_np(grad).reshape(s, 3, nh, hd), ref, rtol=1e-4, atol=1e-5)


def _beam_ref(q, pk, pv, gk, gv, valid, anc, t, k_beams, nh):
    """Gather-by-ancestry beam attention in float64: row r attends its
    video's valid prefill columns and, for j <= t, the column-j entry of
    its step-j ancestor row anc[r, j]."""
    r, h = q.shape
    hd = h // nh
    out = np.zeros((r, h))
    for row in range(r):
        vid = row // k_beams
        keys = [pk[vid, c] for c in range(pk.shape[1]) if valid[vid, c]]
        vals = [pv[vid, c] for c in range(pk.shape[1]) if valid[vid, c]]
        for j in range(t + 1):
            keys.append(gk[j, anc[row, j]])
            vals.append(gv[j, anc[row, j]])
        kk, vv = np.stack(keys), np.stack(vals)
        for head in range(nh):
            sl = slice(head * hd, (head + 1) * hd)
            logits = kk[:, sl] @ q[row, sl] / np.sqrt(hd)
            p = np.exp(logits - logits.max())
            out[row, sl] = (p / p.sum()) @ vv[:, sl]
    return out


@pytest.mark.parametrize("b,k_beams", [(2, 4), (66, 4)])   # 8 and 264 beam rows
def test_beam_attend_matches_gathered_reference(b, k_beams):
    cfg = g2.GPT2Config(n_embd=32, n_head=2, n_layer=1, vocab_size=64, dtype=jnp.float32)
    r, s0, n, t = b * k_beams, 3, 5, 3
    rng = np.random.RandomState(b)
    q, pk, pv = rng.randn(r, 32), rng.randn(b, s0, 32), rng.randn(b, s0, 32)
    gk, gv = rng.randn(n, r, 32), rng.randn(n, r, 32)
    valid = np.ones((b, s0), np.int32)
    valid[0, 0] = 0                                  # a left-padded prompt
    # ancestors stay inside the row's own video; column j written by row j's owner
    anc = (np.arange(r)[:, None] // k_beams) * k_beams + rng.randint(0, k_beams, (r, n))
    anc = anc.astype(np.int32)
    sel = g2.ancestry_mask(jnp.asarray(anc), b, k_beams, jnp.int32(t))
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    out = g2._beam_attend(f32(q), f32(pk), f32(pv), f32(gk), f32(gv), jnp.asarray(valid),
                          sel, g2.head_block_mask(cfg), k_beams, cfg)
    ref = _beam_ref(q, pk, pv, gk, gv, valid, anc, t, k_beams, 2)
    np.testing.assert_allclose(_np(out), ref, rtol=1e-4, atol=1e-4)


def test_beam_attend_deferred_self_column_matches_written_cache():
    """Deferred mode (this step's K/V not yet in the cache, appended as the
    self column) equals the same attention after the write."""
    cfg = g2.GPT2Config(n_embd=32, n_head=2, n_layer=1, vocab_size=64, dtype=jnp.float32)
    b, k_beams, s0, n, t = 2, 3, 4, 6, 2
    r = b * k_beams
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    q = jax.random.normal(keys[0], (r, 32))
    pk, pv = jax.random.normal(keys[1], (b, s0, 32)), jax.random.normal(keys[2], (b, s0, 32))
    gk, gv = jax.random.normal(keys[3], (n, r, 32)), jax.random.normal(keys[4], (n, r, 32))
    k_new, v_new = jax.random.normal(keys[5], (2, r, 32))
    anc = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[:, None], (r, n))
    valid = jnp.ones((b, s0), jnp.int32)
    hmask = g2.head_block_mask(cfg)
    written = g2._beam_attend(q, pk, pv, gk.at[t].set(k_new), gv.at[t].set(v_new), valid,
                              g2.ancestry_mask(anc, b, k_beams, jnp.int32(t)), hmask,
                              k_beams, cfg)
    deferred = g2._beam_attend(q, pk, pv, gk, gv, valid,
                               g2.ancestry_mask(anc, b, k_beams, jnp.int32(t - 1)), hmask,
                               k_beams, cfg, k_new=k_new, v_new=v_new)
    np.testing.assert_allclose(_np(deferred), _np(written), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vocab", [1337, 1408])   # with and without pad columns
def test_lm_stats_match_numpy(vocab):
    cfg = g2.GPT2Config(vocab_size=vocab, n_embd=64, n_head=2, n_layer=1, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    wte = rng.randn(vocab, 64).astype(np.float32) * 0.1
    x = rng.randn(6, 64).astype(np.float32)
    wte_t = g2.lm_head_t({"wte": jnp.asarray(wte)}, cfg)
    vp = -(-vocab // 128) * 128
    assert wte_t.shape == (64, vp)
    logits, wmax, m, l = g2.lm_stats(jnp.asarray(x), wte_t, cfg, need_row_stats=True)
    ref = np.full((6, vp), -np.inf)
    ref[:, :vocab] = _np(x) @ _np(wte).T
    np.testing.assert_allclose(_np(logits), ref, rtol=1e-5, atol=1e-5)
    assert np.all(np.isneginf(np.asarray(logits)[:, vocab:]))
    np.testing.assert_allclose(_np(wmax), ref.reshape(6, vp // 128, 128).max(-1),
                               rtol=1e-5, atol=1e-5)
    ref_m = ref.max(-1)
    np.testing.assert_allclose(_np(m), ref_m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(l), np.exp(ref - ref_m[:, None]).sum(-1), rtol=1e-5)


def test_lm_stats_skips_row_stats_when_not_needed():
    cfg = g2.GPT2Config(vocab_size=300, n_embd=16, n_head=2, n_layer=1, dtype=jnp.float32)
    wte_t = g2.lm_head_t({"wte": jnp.ones((300, 16))}, cfg)
    logits, wmax, m, l = g2.lm_stats(jnp.ones((3, 16)), wte_t, cfg, need_row_stats=False)
    assert logits.shape == (3, 384) and wmax.shape == (3, 3)
    assert m is None and l is None


def test_vit_config_has_no_kernel_switches():
    """The model configs carry no per-kernel flags: one plain path each."""
    for cls in (vt.ViTConfig, g2.GPT2Config, cm.CaptionModelConfig):
        names = {f.name for f in dataclasses.fields(cls)}
        assert not {n for n in names if "pallas" in n}, cls
