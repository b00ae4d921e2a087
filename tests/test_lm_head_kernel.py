"""The wmax-precomputed exact_topk path (the LM head's window maxima feed
the first selection stage)."""
import jax
import jax.numpy as jnp
import numpy as np

from video_caption_tpu.decode.logits_process import exact_topk


def test_exact_topk_wmax_path_exact():
    rng = np.random.RandomState(1)
    scores = jnp.asarray(rng.randn(8, 1024).astype(np.float32))
    wmax = jnp.max(scores.reshape(8, 8, 128), axis=-1)
    v_ref, i_ref = jax.lax.top_k(scores, 17)
    v_got, i_got = exact_topk(scores, 17, wmax=wmax)
    np.testing.assert_array_equal(np.asarray(v_got), np.asarray(v_ref))
    np.testing.assert_array_equal(np.asarray(i_got), np.asarray(i_ref))
