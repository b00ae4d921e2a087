"""Token-for-token differential tests against the ACTUAL reference stack.

The north-star parity check (SURVEY §6 / VERDICT round-1 item 2): one shared
random-init checkpoint is pushed through BOTH stacks —

  reference: experiments/inference.py run_one_video (real VideoCaptionModel,
             real GPT2TextDecoder + HF generate, real clean/rank), torch CPU
  ours:      models/convert.py -> InferenceEngine, JAX CPU

— and the resulting captions must be string-identical for greedy, beam=3
(precise) and beam=4 (detailed) presets, including the BEST selection.

The ViT backbone uses a faithful timm stand-in (tests/refstack_helpers.py;
timm itself is not installed here) — every other reference line is real.
Sampled presets are excluded: torch and JAX RNGs cannot match.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import refstack_helpers as rsh  # noqa: E402

torch = pytest.importorskip("torch")

CORPUS = (
    "State the main action in one short sentence: "
    "Write a short, natural caption: "
    "a man is playing a guitar on the stage "
    "a woman is cooking food in the kitchen "
    "the dog runs through the field and jumps over a fence "
    "someone is slicing vegetables with a knife "
    "people are dancing together in a room "
)

N_EMBD, N_LAYER, N_HEAD = 128, 2, 4


@pytest.fixture(scope="module")
def refstack(tmp_path_factory):
    if not Path(rsh.REFERENCE_ROOT).is_dir():
        pytest.skip(f"reference checkout not present at {rsh.REFERENCE_ROOT}")
    assets = tmp_path_factory.mktemp("gpt2_local")
    vocab_size = rsh.build_synthetic_gpt2_vocab(assets, CORPUS, n_merges=32)
    rsh.build_local_gpt2_model_dir(assets, vocab_size, N_EMBD, N_LAYER, N_HEAD)

    # our tokenizer must read the same files
    import os

    os.environ["VIDEO_CAPTION_TOKENIZER_DIR"] = str(assets)
    import video_caption_tpu.decode.tokenizer as tok_mod

    tok_mod._TOKENIZER = None  # reset singleton

    refinf = rsh.install_reference_stack()

    # shared random checkpoint in the reference's on-disk format
    torch.manual_seed(7)
    model = refinf.VideoCaptionModel(
        vit_name="vit_base_patch16_224", gpt2_name=str(assets),
        cond_mode="prefix", prefix_len=4, freeze_vit=True, unfreeze_last=0,
    ).eval()
    ckpt = assets / "shared_random.pt"
    torch.save({"model_state": model.state_dict()}, str(ckpt))

    # frames dir: 20 deterministic JPEGs
    frames = tmp_path_factory.mktemp("frames")
    from PIL import Image

    rng = np.random.RandomState(42)
    for i in range(20):
        Image.fromarray(
            rng.randint(0, 255, (240, 320, 3), np.uint8)
        ).save(frames / f"frame_{i:05d}.jpg")

    yield {
        "assets": assets, "ckpt": ckpt, "frames": frames,
        "refinf": refinf, "vocab_size": vocab_size,
    }
    tok_mod._TOKENIZER = None
    os.environ.pop("VIDEO_CAPTION_TOKENIZER_DIR", None)


def _our_model_cfg(vocab_size):
    import jax.numpy as jnp

    from video_caption_tpu.models import caption_model as cm
    from video_caption_tpu.models import gpt2 as g2
    from video_caption_tpu.models import vit as vt

    g = rsh.VIT_GEOMETRY
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(
            image_size=224, patch_size=g["patch_size"], embed_dim=g["embed_dim"],
            depth=g["depth"], num_heads=g["num_heads"], out_dim=256,
            dtype=jnp.float32, gelu_approx=True,
        ),
        gpt2=g2.GPT2Config(
            vocab_size=vocab_size, n_embd=N_EMBD, n_layer=N_LAYER,
            n_head=N_HEAD, dtype=jnp.float32,
        ),
        prefix_len=4, video_dim=256,
    )


@pytest.fixture(scope="module")
def our_engine(refstack):
    from video_caption_tpu.config import InferenceConfig
    from video_caption_tpu.engine import InferenceEngine

    # the engine's default native (C++) loader stays ENABLED here: its resize
    # reproduces PIL's fixed-point Resample.c bit-exactly (test_native_loader),
    # so the full differential runs through the production fast path
    config = InferenceConfig(
        ckpt=str(refstack["ckpt"]), num_frames=8,
        preset1="precise", preset2="detailed", preset3="precise",
    )
    return InferenceEngine(config, model_cfg=_our_model_cfg(refstack["vocab_size"]))


# ---------------------------------------------------------------------------


def test_tokenizer_matches_gpt2tokenizerfast(refstack):
    from transformers import GPT2TokenizerFast

    from video_caption_tpu.decode.tokenizer import get_tokenizer

    hf = GPT2TokenizerFast.from_pretrained(str(refstack["assets"]))
    ours = get_tokenizer()
    assert ours.eos_token_id == hf.eos_token_id
    for text in (
        "State the main action in one short sentence:",
        "Write a short, natural caption:",
        "a man is playing a guitar on the stage.",
        "The dog, quickly, jumps! Over 2 fences...",
        "unusual word-pieces & punctuation; don't",
    ):
        assert ours.encode(text) == hf(text).input_ids, text
        assert ours.decode(hf(text).input_ids) == hf.decode(
            hf(text).input_ids, skip_special_tokens=True
        )


def test_encoder_differential(refstack, our_engine):
    """Reference encoder (timm-named torch modules) vs our converted JAX ViT
    on identical frames: [B,256] embeddings must match to fp32 tolerance."""
    refinf = refstack["refinf"]
    frames = refinf.load_frames(Path(refstack["frames"]), num_frames=8,
                                image_size=224, device="cpu")
    model = refinf.VideoCaptionModel(
        vit_name="vit_base_patch16_224", gpt2_name=str(refstack["assets"]),
        cond_mode="prefix", prefix_len=4, freeze_vit=True, unfreeze_last=0,
    ).eval()
    state = torch.load(str(refstack["ckpt"]), map_location="cpu")["model_state"]
    model.load_state_dict(state, strict=False)
    with torch.no_grad():
        ref_emb = model.proj(model.encoder(frames)).numpy()

    from video_caption_tpu.models import caption_model as cm

    video = np.asarray(frames.numpy())
    our_emb = np.asarray(
        cm.encode_video(our_engine.params, video, our_engine.model_cfg)
    )
    np.testing.assert_allclose(our_emb, ref_emb, atol=2e-4, rtol=1e-3)


def test_full_pipeline_differential(refstack, our_engine):
    """run_one_video vs engine.infer: S1 (beam=3), S2 (beam=4), S3 and BEST
    must be string-identical."""
    refinf = refstack["refinf"]
    ref = refinf.run_one_video(
        str(refstack["frames"]), str(refstack["ckpt"]),
        gpt2_name=str(refstack["assets"]), num_frames=8,
        preset1="precise", preset2="detailed", preset3="precise",
    )
    ours = our_engine.infer(str(refstack["frames"])).to_api_dict()
    assert ours["S1"] == ref["S1"]
    assert ours["S2"] == ref["S2"]
    assert ours["S3"] == ref["S3"]
    assert ours["BEST"]["key"] == ref["BEST"]["key"]
    assert ours["BEST"]["text"] == ref["BEST"]["text"]


def test_greedy_differential(refstack, our_engine):
    """Pure greedy (num_beams=1, temperature=1.0 -> do_sample=False) through
    both stacks' generate_once."""
    refinf = refstack["refinf"]
    frames = refinf.load_frames(Path(refstack["frames"]), num_frames=8,
                                image_size=224, device="cpu")
    model = refinf.VideoCaptionModel(
        vit_name="vit_base_patch16_224", gpt2_name=str(refstack["assets"]),
        cond_mode="prefix", prefix_len=4, freeze_vit=True, unfreeze_last=0,
    ).eval()
    state = torch.load(str(refstack["ckpt"]), map_location="cpu")["model_state"]
    model.load_state_dict(state, strict=False)

    greedy = dict(num_beams=1, max_new_tokens=24, temperature=1.0, top_p=1.0,
                  no_repeat_ngram_size=3, repetition_penalty=1.1)
    for prompt in ("", "State the main action in one short sentence:"):
        ref_text = refinf.generate_once(model, frames, prompt, 0.6, 0.4, **greedy)
        import jax.numpy as jnp

        video = jnp.asarray(frames.numpy())
        prefix = our_engine.compute_prefix(video)
        our_text = our_engine.generate_once(prefix, prompt, **greedy)
        assert our_text == ref_text, f"greedy mismatch for prompt={prompt!r}"


def test_legacy_vit_key_remap_through_reference_state(refstack):
    """Legacy ``vit.*`` checkpoints (tools/debug_chain.py:48-60) must convert
    identically to ``encoder.backbone.*`` ones — exercised on the reference's
    own (timm-named) state dict, not a synthetic fixture (VERDICT r1 #8)."""
    from video_caption_tpu.models.convert import convert_caption_checkpoint

    state = torch.load(str(refstack["ckpt"]), map_location="cpu")["model_state"]
    legacy = {}
    for k, v in state.items():
        if k.startswith("encoder.backbone."):
            legacy["vit." + k[len("encoder.backbone."):]] = v
        else:
            legacy[k] = v

    cfg = _our_model_cfg(refstack["vocab_size"])
    a = convert_caption_checkpoint(state, cfg)
    b = convert_caption_checkpoint(legacy, cfg)
    import jax

    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) and len(la) > 10
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.skipif("RUN_FULL_GEOMETRY_DIFF" not in __import__("os").environ,
                    reason="slow (~8 min CPU); set RUN_FULL_GEOMETRY_DIFF=1")
def test_full_geometry_differential():
    """The differential at COMPLETE production geometry (ViT-B/16 depth 12 +
    GPT-2 124M): catches depth-dependent numeric drift the suite's depth-2
    geometry cannot."""
    import subprocess
    import sys as _sys

    proc = subprocess.run(
        [_sys.executable, str(Path(__file__).parent / "full_geometry_differential.py")],
        capture_output=True, text=True, timeout=1800,
    )
    assert proc.returncode == 0 and "FULL-GEOMETRY-DIFFERENTIAL-OK" in proc.stdout, (
        proc.stdout[-500:] + proc.stderr[-500:]
    )


def test_export_torch_state_round_trip(refstack):
    """JAX pytree -> reference torch key space must reproduce the ORIGINAL
    reference state dict exactly (both directions of migration work)."""
    from video_caption_tpu.models.convert import (
        convert_caption_checkpoint, export_torch_state, load_torch_checkpoint,
        merge_params, save_torch_checkpoint,
    )

    orig = {k: v.numpy() for k, v in torch.load(
        str(refstack["ckpt"]), map_location="cpu")["model_state"].items()}
    cfg = _our_model_cfg(refstack["vocab_size"])
    params = convert_caption_checkpoint(orig, cfg)
    exported = export_torch_state(params, cfg)

    missing = set(orig) - set(exported)
    assert not missing, f"exporter misses reference keys: {sorted(missing)[:8]}"
    for k, v in exported.items():
        if k in orig:
            np.testing.assert_allclose(v, orig[k], atol=1e-6, err_msg=k)

    # on-disk round trip: save in reference format, reload through our loader
    out = refstack["assets"] / "exported.pt"
    save_torch_checkpoint(str(out), params, cfg, step=3)
    state2 = load_torch_checkpoint(str(out))
    re_params = convert_caption_checkpoint(state2, cfg)
    import jax

    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(re_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
