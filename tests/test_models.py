"""Shape/dtype/grad contracts for the functional models."""
import jax
import jax.numpy as jnp
import numpy as np

from video_caption_tpu.models import caption_model as cm
from video_caption_tpu.models import gpt2 as g2


def test_encode_video_shape_and_dtype(tiny_params, tiny_cfg):
    video = jax.random.normal(jax.random.PRNGKey(1), (2, 3, 3, 32, 32))
    emb = cm.encode_video(tiny_params, video, tiny_cfg)
    assert emb.shape == (2, tiny_cfg.video_dim)
    assert emb.dtype == jnp.float32  # output always cast to fp32 (video_encoder.py:321-324)


def test_prefix_shape(tiny_params, tiny_cfg):
    video = jax.random.normal(jax.random.PRNGKey(1), (2, 3, 3, 32, 32))
    prefix = cm.video_to_prefix(tiny_params, video, tiny_cfg)
    assert prefix.shape == (2, tiny_cfg.prefix_len, tiny_cfg.gpt2.n_embd)


def test_gpt2_prefill_then_decode_consistent(tiny_params, tiny_cfg):
    """Incremental decode must produce identical logits to one full forward."""
    gcfg = tiny_cfg.gpt2
    params = tiny_params["decoder"]
    b, s = 2, 6
    rng = jax.random.PRNGKey(3)
    embeds = jax.random.normal(rng, (b, s, gcfg.n_embd))
    positions = jnp.broadcast_to(jnp.arange(s), (b, s)).astype(jnp.int32)
    mask = jnp.ones((b, s), jnp.int32)

    # full forward
    full_logits = g2.gpt2_logits_nocache(params, embeds, positions, mask, gcfg)

    # prefill 4, then decode steps 4 and 5 incrementally
    max_len = s
    cache = g2.init_cache(gcfg, b, max_len)
    valid = jnp.concatenate([jnp.ones((b, 4), jnp.int32), jnp.zeros((b, 2), jnp.int32)], 1)
    lg, cache = g2.gpt2_forward(params, embeds[:, :4], positions[:, :4], valid, cache, jnp.int32(0), gcfg)
    np.testing.assert_allclose(lg, full_logits[:, :4], rtol=5e-4, atol=5e-4)
    for t in range(4, s):
        valid = valid.at[:, t].set(1)
        lg, cache = g2.gpt2_forward(
            params, embeds[:, t : t + 1], positions[:, t : t + 1], valid, cache,
            jnp.int32(t), gcfg,
        )
        np.testing.assert_allclose(lg[:, 0], full_logits[:, t], rtol=5e-4, atol=5e-4)


def test_compute_loss_finite_and_differentiable(tiny_params, tiny_cfg):
    video = jax.random.normal(jax.random.PRNGKey(5), (2, 3, 3, 32, 32))
    ids = jnp.array([[5, 6, 7, 127], [8, 9, 127, 127]], jnp.int32)
    mask = jnp.array([[1, 1, 1, 1], [1, 1, 1, 0]], jnp.int32)

    def loss_fn(p):
        return cm.compute_loss(p, video, ids, mask, tiny_cfg)

    loss, grads = jax.value_and_grad(loss_fn)(tiny_params)
    assert np.isfinite(float(loss))
    gnorm = jax.tree_util.tree_reduce(
        lambda a, x: a + float(jnp.sum(jnp.abs(x))), grads, 0.0
    )
    assert gnorm > 0


def test_loss_ignores_padding(tiny_params, tiny_cfg):
    """Changing a masked (pad) token must not change the loss."""
    video = jax.random.normal(jax.random.PRNGKey(5), (1, 3, 3, 32, 32))
    mask = jnp.array([[1, 1, 1, 0]], jnp.int32)
    ids_a = jnp.array([[5, 6, 7, 0]], jnp.int32)
    ids_b = jnp.array([[5, 6, 7, 99]], jnp.int32)
    la = cm.compute_loss(tiny_params, video, ids_a, mask, tiny_cfg)
    lb = cm.compute_loss(tiny_params, video, ids_b, mask, tiny_cfg)
    np.testing.assert_allclose(la, lb, rtol=1e-6)


def test_vit_trunk_remat_grad_parity():
    """remat=True recomputes the forward in the backward — values AND grads
    must match the stashed-activation path exactly (same ops, same order)."""
    import dataclasses

    from video_caption_tpu.models import vit as vt

    cfg = vt.ViTConfig(image_size=32, patch_size=16, embed_dim=48, depth=2,
                       num_heads=4, dtype=jnp.float32)
    params = vt.init_vit_params(jax.random.PRNGKey(0), cfg)
    images = jax.random.normal(jax.random.PRNGKey(1), (2, 3, 32, 32))

    def loss(p, c):
        return jnp.sum(vt.vit_trunk(p, images, c) ** 2)

    cfg_r = dataclasses.replace(cfg, remat=True)
    l0, g0 = jax.value_and_grad(loss)(params, cfg)
    l1, g1 = jax.value_and_grad(loss)(params, cfg_r)
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6),
                 g0, g1)


def test_vit_trunk_cls_only_bitwise():
    """cls_only slices the CLS token BEFORE the final LayerNorm; LN is
    per-token so the result must be bitwise identical to slicing after —
    values and (sliced) gradients."""
    from video_caption_tpu.models import vit as vt

    cfg = vt.ViTConfig(image_size=32, patch_size=16, embed_dim=48, depth=2,
                       num_heads=4, dtype=jnp.float32)
    params = vt.init_vit_params(jax.random.PRNGKey(0), cfg)
    images = jax.random.normal(jax.random.PRNGKey(1), (4, 3, 32, 32))
    full = vt.vit_trunk(params, images, cfg)
    cls = vt.vit_trunk(params, images, cfg, cls_only=True)
    assert cls.shape == (4, 1, cfg.embed_dim)
    np.testing.assert_array_equal(np.asarray(full[:, :1, :]), np.asarray(cls))

    def loss(p, cls_only):
        return jnp.sum(vt.vit_trunk(p, images, cfg, cls_only=cls_only)[:, 0] ** 2)

    g_full, g_cls = jax.grad(loss)(params, False), jax.grad(loss)(params, True)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7),
                 g_full, g_cls)


def test_vit_encode_cls_matches_full_stream_composition():
    """vit_encode's cls fast path (trunk cls_only + tiny temporal mean) must
    match the full-stream trunk + pool_temporal composition it replaced."""
    from video_caption_tpu.models import vit as vt

    cfg = vt.ViTConfig(image_size=32, patch_size=16, embed_dim=48, depth=2,
                       num_heads=4, out_dim=24, dtype=jnp.float32)
    params = vt.init_vit_params(jax.random.PRNGKey(0), cfg)
    video = jax.random.normal(jax.random.PRNGKey(1), (2, 4, 3, 32, 32))
    out = vt.vit_encode(params, video, cfg)
    frames = video.reshape(8, 3, 32, 32)
    tokens = vt.vit_trunk(params, frames, cfg)
    pooled = vt.pool_temporal(tokens, 2, 4, cfg)
    ref = (pooled @ params["head"]["w"].astype(pooled.dtype)
           + params["head"]["b"].astype(pooled.dtype)).astype(jnp.float32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6, atol=1e-6)
