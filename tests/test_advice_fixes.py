"""Regression tests for the round-1 advisor findings.

1. restore_params must restore checkpoints that carry opt_state (high).
2. engine.load_params must fail loudly on an unrestorable existing ckpt.
3. Sampled presets carry HF's default top_k=50 warper (medium).
4. MLP-adapter (proj_hidden>0) checkpoints are wired into encode_video (low).
5. BatchingQueue coalescing delay is bounded by max_wait_ms absolute (low).
6. Unsafe pickle fallback is opt-in via VCT_ALLOW_UNSAFE_PICKLE (low).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_caption_tpu.decode.presets import preset_to_kwargs
from video_caption_tpu.models import caption_model as cm
from video_caption_tpu.training.checkpoint import restore_params, save_checkpoint


# ---- 1: opt_state-bearing checkpoints restore -------------------------------

def test_restore_with_opt_state(tmp_path):
    params = {"w": jnp.ones((4, 4)), "b": jnp.zeros((4,))}
    opt_state = {"mu": {"w": jnp.full((4, 4), 0.5), "b": jnp.zeros((4,))}}
    path = tmp_path / "ckpt"
    save_checkpoint(str(path), params, step=7, opt_state=opt_state)
    like = jax.tree.map(lambda x: jnp.zeros_like(x), params)
    restored = restore_params(str(path), like)
    assert restored is not None, "opt_state-bearing checkpoint must restore"
    np.testing.assert_allclose(np.asarray(restored["w"]), np.ones((4, 4)))


def test_restore_params_only_checkpoint(tmp_path):
    params = {"w": jnp.full((2, 3), 2.0)}
    path = tmp_path / "ckpt"
    save_checkpoint(str(path), params)
    restored = restore_params(str(path), params)
    assert restored is not None
    np.testing.assert_allclose(np.asarray(restored["w"]), 2.0)


def test_restore_missing_path_returns_none(tmp_path):
    assert restore_params(str(tmp_path / "nope"), {"w": jnp.zeros(2)}) is None


# ---- 2: existing-but-broken checkpoint fails loudly -------------------------

def test_load_params_raises_on_corrupt_existing_ckpt(tmp_path, tiny_cfg):
    from video_caption_tpu.config import InferenceConfig
    from video_caption_tpu.engine import load_params

    bad = tmp_path / "broken_ckpt"
    bad.mkdir()
    (bad / "garbage").write_text("not an orbax checkpoint")
    config = InferenceConfig(ckpt=str(bad))
    with pytest.raises(RuntimeError, match="could not be restored"):
        load_params(config, tiny_cfg)


# ---- 3: sampled presets match HF's default warper chain ---------------------

def test_sampled_presets_have_hf_default_top_k():
    for name in ("natural", "safe_sample"):
        kw = preset_to_kwargs(name)
        assert kw.get("top_k") == 50, f"{name} must carry HF default top_k=50"
    for name in ("precise", "detailed"):
        assert "top_k" not in preset_to_kwargs(name) or not preset_to_kwargs(name).get("top_k")


# ---- 4: MLP adapter wiring --------------------------------------------------

def _mlp_cfg(tiny_cfg):
    from dataclasses import replace
    return replace(tiny_cfg, proj_hidden=8)


def test_proj_mlp_init_and_forward(tiny_cfg):
    cfg = _mlp_cfg(tiny_cfg)
    params = cm.init_caption_model(jax.random.PRNGKey(0), cfg)
    assert "proj_mlp" in params
    video = jnp.zeros((1, 2, 3, cfg.vit.image_size, cfg.vit.image_size))
    emb_mlp = cm.encode_video(params, video, cfg)
    # removing the adapter changes the embedding -> it is actually applied
    no_mlp = {k: v for k, v in params.items() if k != "proj_mlp"}
    emb_plain = cm.encode_video(no_mlp, video, cfg)
    assert emb_mlp.shape == emb_plain.shape == (1, cfg.video_dim)
    assert not np.allclose(np.asarray(emb_mlp), np.asarray(emb_plain))


def test_proj_mlp_matches_torch_reference_semantics(tiny_cfg):
    """fc1 -> ReLU -> fc2 must equal torch nn.Sequential(Linear,ReLU,Linear)."""
    torch = pytest.importorskip("torch")
    cfg = _mlp_cfg(tiny_cfg)
    params = cm.init_caption_model(jax.random.PRNGKey(1), cfg)
    x = np.random.default_rng(0).standard_normal((3, cfg.video_dim)).astype(np.float32)

    m = params["proj_mlp"]
    h = np.maximum(x @ np.asarray(m["fc1"]["w"]) + np.asarray(m["fc1"]["b"]), 0)
    ours = h @ np.asarray(m["fc2"]["w"]) + np.asarray(m["fc2"]["b"])

    seq = torch.nn.Sequential(
        torch.nn.Linear(cfg.video_dim, cfg.proj_hidden),
        torch.nn.ReLU(),
        torch.nn.Linear(cfg.proj_hidden, cfg.video_dim),
    )
    with torch.no_grad():
        seq[0].weight.copy_(torch.from_numpy(np.asarray(m["fc1"]["w"]).T.copy()))
        seq[0].bias.copy_(torch.from_numpy(np.asarray(m["fc1"]["b"])))
        seq[2].weight.copy_(torch.from_numpy(np.asarray(m["fc2"]["w"]).T.copy()))
        seq[2].bias.copy_(torch.from_numpy(np.asarray(m["fc2"]["b"])))
        theirs = seq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_merge_params_keeps_proj_mlp(tiny_cfg):
    from video_caption_tpu.models.convert import merge_params

    cfg = _mlp_cfg(tiny_cfg)
    init = cm.init_caption_model(jax.random.PRNGKey(0), cfg)
    converted = {
        "proj_mlp": {
            "fc1": {"w": np.ones((cfg.video_dim, cfg.proj_hidden), np.float32),
                    "b": np.zeros((cfg.proj_hidden,), np.float32)},
            "fc2": {"w": np.ones((cfg.proj_hidden, cfg.video_dim), np.float32),
                    "b": np.zeros((cfg.video_dim,), np.float32)},
        }
    }
    merged = merge_params(init, converted)
    np.testing.assert_allclose(np.asarray(merged["proj_mlp"]["fc1"]["w"]), 1.0)


# ---- 5: coalescing delay bounded by absolute deadline -----------------------

class _SlowTrickleEngine:
    """Engine stub; requests arrive slower than max_wait so a per-get reset
    would extend the window indefinitely."""

    def infer_batch_dispatch(self, dirs):
        return list(dirs)

    def infer_batch_collect(self, handle):
        return [f"cap:{d}" for d in handle]

    def infer(self, d):
        return f"cap:{d}"


def test_batching_queue_absolute_deadline():
    from video_caption_tpu.server.services.batching_queue import BatchingQueue

    q = BatchingQueue(_SlowTrickleEngine(), max_batch=64, max_wait_ms=120.0)
    try:
        start = time.monotonic()
        futs = [q.submit("a")]
        # trickle more requests every 50ms; with the per-get reset bug the
        # window re-arms forever and the first future resolves only at
        # max_batch; with an absolute deadline it resolves ~max_wait later
        for _ in range(6):
            time.sleep(0.05)
            futs.append(q.submit("b"))
        first = futs[0].result(timeout=5)
        elapsed = time.monotonic() - start
        assert first == "cap:a"
        assert elapsed < 1.0, f"coalescing delay {elapsed:.2f}s not bounded by max_wait"
    finally:
        q.stop()


# ---- 6: unsafe pickle fallback is gated -------------------------------------

def test_unsafe_pickle_requires_opt_in(tmp_path, monkeypatch):
    torch = pytest.importorskip("torch")
    import argparse

    from video_caption_tpu.models.convert import load_torch_checkpoint

    path = tmp_path / "with_args.pt"
    torch.save(
        {"model_state": {"w": torch.ones(2)}, "args": argparse.Namespace(lr=1e-4)},
        str(path),
    )
    # confirm the fixture actually trips the safe loader; if a future torch
    # allowlists Namespace the gate is simply never reached (fine)
    try:
        torch.load(str(path), map_location="cpu", weights_only=True)
        pytest.skip("this torch version safe-loads Namespace; gate not reachable")
    except TypeError:
        pytest.skip("old torch without weights_only kwarg")
    except Exception:
        pass

    monkeypatch.delenv("VCT_ALLOW_UNSAFE_PICKLE", raising=False)
    with pytest.raises(RuntimeError, match="VCT_ALLOW_UNSAFE_PICKLE"):
        load_torch_checkpoint(str(path))

    monkeypatch.setenv("VCT_ALLOW_UNSAFE_PICKLE", "1")
    state = load_torch_checkpoint(str(path))
    np.testing.assert_allclose(state["w"], 1.0)


def test_restore_rejects_wrong_geometry(tmp_path):
    """A checkpoint from a DIFFERENT model geometry must not restore
    'successfully' (it would crash later with an opaque XLA shape error)."""
    params = {"w": jnp.ones((4, 4))}
    path = tmp_path / "ckpt"
    save_checkpoint(str(path), params)
    # wrong shape
    assert restore_params(str(path), {"w": jnp.zeros((8, 8))}) is None
    # wrong tree structure
    assert restore_params(str(path), {"w": jnp.zeros((4, 4)), "b": jnp.zeros(4)}) is None
    # right geometry still restores
    assert restore_params(str(path), {"w": jnp.zeros((4, 4))}) is not None
