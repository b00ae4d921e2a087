"""Test harness: CPU backend with 8 virtual devices so multi-device sharding
paths (jax.sharding.Mesh over data/model axes) are exercised without an
accelerator. Must run before jax initializes.

Tests that need the card carry the ``gpu`` marker and skip through the
``gpu_device`` fixture when no GPU backend is present; whether one is present
is decided inside the fixture, never at import."""
import os

# CPU with 8 virtual devices unless an accelerator platform is asked for
# explicitly (JAX_PLATFORMS=cuda runs the ``gpu``-marked tests on the card).
ON_CPU = os.environ.get("JAX_PLATFORMS", "").strip().lower() in ("", "cpu")
if ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# XLA:CPU's default matmul runs in reduced (bf16-like) precision, and a GPU
# runs float32 matmuls in TF32; both are far too loose for token-level
# parity tests (observed 6e-2 error on a tiny fp32 matmul). Force full fp32
# matmuls under test; the production path manages precision explicitly via
# its dtype policy.
jax.config.update("jax_default_matmul_precision", "highest")
if ON_CPU:
    # An installed accelerator plugin can take precedence over
    # JAX_PLATFORMS; pin the platform through the config knob, plus 8
    # virtual CPU devices for multi-device sharding tests.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from video_caption_tpu.models import caption_model as cm  # noqa: E402
from video_caption_tpu.models import gpt2 as g2  # noqa: E402
from video_caption_tpu.models import vit as vt  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU backend")
    config.addinivalue_line("markers", "slow: long-running; the tier-1 run deselects it")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when this process has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU backend (run on the card with JAX_PLATFORMS unset)")
    return gpus[0]


@pytest.fixture(scope="session")
def tiny_cfg() -> cm.CaptionModelConfig:
    """Small geometry for fast CPU tests; same structure as the real model."""
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(
            image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            out_dim=16, dtype=jnp.float32,
        ),
        gpt2=g2.GPT2Config(
            vocab_size=128, max_position_embeddings=64, n_embd=64, n_layer=2,
            n_head=4, dtype=jnp.float32,
        ),
        prefix_len=4,
        video_dim=16,
    )


@pytest.fixture(scope="session")
def tiny_params(tiny_cfg):
    return cm.init_caption_model(jax.random.PRNGKey(0), tiny_cfg)
