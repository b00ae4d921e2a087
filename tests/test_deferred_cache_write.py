"""Token parity of the deferred single-DUS decode cache write
(GPT2Config.deferred_cache_write) against the per-layer-write path.

The deferred step holds every layer's new K/V in registers, attends the
current token as an explicit extra softmax column (models/gpt2.py::
_attend_deferred), and issues ONE [L,B,1,2,nh,hd] dynamic_update_slice per
step instead of 12. The only numeric difference is the position of the self
column inside the f32 softmax reduction — tokens must not change."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_caption_tpu.decode.generate import DecodeParams, greedy_or_sample
from video_caption_tpu.models import gpt2 as g2


@pytest.fixture(scope="module")
def small_gpt2():
    cfg = g2.GPT2Config(
        vocab_size=97, n_embd=32, n_head=4, n_layer=3,
        max_position_embeddings=64, dtype=jnp.float32,
    )
    params = g2.init_gpt2_params(jax.random.PRNGKey(3), cfg)
    return cfg, params


def _embeds(params, ids):
    return params["wte"][ids]


@pytest.mark.parametrize("temperature", [1.0, 0.8])
def test_deferred_write_token_parity(small_gpt2, temperature):
    cfg, params = small_gpt2
    cfg_def = dataclasses.replace(cfg, deferred_cache_write=True)
    rng = np.random.RandomState(0)
    ids = jnp.asarray(rng.randint(1, 96, (4, 5)))
    # left-padded second row exercises the valid-mask path
    mask = jnp.asarray([[1] * 5, [0, 0, 1, 1, 1], [1] * 5, [0, 1, 1, 1, 1]],
                       jnp.int32)
    # temperature 1.0 = greedy, 0.8 = sampled (DecodeParams.do_sample rule)
    dp = DecodeParams(
        max_new_tokens=12, num_beams=1, top_k=20, top_p=0.9,
        temperature=temperature, repetition_penalty=1.3,
        no_repeat_ngram_size=2, min_new_tokens=2, eos_id=0, early_stop=False,
    )
    key = jax.random.PRNGKey(11)
    out_base = greedy_or_sample(
        params, cfg, _embeds(params, ids), dp, rng=key, prefill_mask=mask)
    out_def = greedy_or_sample(
        params, cfg_def, _embeds(params, ids), dp, rng=key, prefill_mask=mask)
    np.testing.assert_array_equal(np.asarray(out_base), np.asarray(out_def))


def test_deferred_write_cache_contents_match(small_gpt2):
    """The post-step cache buffers match to f32 rounding: the same values
    land at the same slots; tiny diffs come from the softmax-reassociation
    of earlier steps propagating through the residual stream (the deferred
    path's self column sits at the end of the reduction)."""
    cfg, params = small_gpt2
    cfg_def = dataclasses.replace(cfg, deferred_cache_write=True)
    b, s0, n = 2, 4, 3
    rng = np.random.RandomState(1)
    ids = jnp.asarray(rng.randint(1, 96, (b, s0)))
    embeds = params["wte"][ids]
    outs = {}
    for name, c in (("base", cfg), ("deferred", cfg_def)):
        cache = g2.init_cache(c, b, s0 + n)
        valid = jnp.zeros((b, s0 + n), jnp.int32)
        valid = valid.at[:, :s0].set(1)
        pos = jnp.broadcast_to(jnp.arange(s0), (b, s0))
        logits, cache = g2.gpt2_forward(
            params, embeds, pos, valid, cache, jnp.int32(0), c)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)
        for t in range(n):
            valid = valid.at[:, s0 + t].set(1)
            e = params["wte"][tok][:, None, :]
            p = jnp.full((b, 1), s0 + t, jnp.int32)
            logits, cache = g2.gpt2_forward(
                params, e, p, valid, cache, jnp.int32(s0 + t), c)
            tok = jnp.argmax(logits[:, -1, :], axis=-1)
        outs[name] = np.asarray(cache["kv"])
    np.testing.assert_allclose(outs["base"], outs["deferred"], rtol=0, atol=1e-6)


def test_deferred_write_beam_token_parity():
    """beam_search with deferred_cache_write on vs off (XLA path): tokens
    must match — column t is handled as the explicit self column and the
    batched write lands the same values."""
    from video_caption_tpu.decode.generate import generate

    cfg = g2.GPT2Config(vocab_size=256, n_embd=64, n_layer=3, n_head=2,
                        dtype=jnp.float32)
    cfg_def = dataclasses.replace(cfg, deferred_cache_write=True)
    params = g2.init_gpt2_params(jax.random.PRNGKey(0), cfg)
    embeds = jax.random.normal(jax.random.PRNGKey(1), (2, 5, 64))
    mask = jnp.asarray([[1] * 5, [0, 0, 1, 1, 1]], jnp.int32)
    dp = DecodeParams(max_new_tokens=8, num_beams=3, min_new_tokens=2,
                      eos_id=255)
    base = generate(params, cfg, embeds, dp, prefill_mask=mask)
    deferred = generate(params, cfg_def, embeds, dp, prefill_mask=mask)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(deferred))

