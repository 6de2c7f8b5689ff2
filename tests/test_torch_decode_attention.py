"""Decode attention: the PyTorch port against the JAX Pallas kernel.

On the CPU the port's `decode_attention` runs its plain version
(gqa_attention at S = 1 on the layer slice); it is held against JAX
`decode_attention(..., interpret=True)` at every block size the JAX tests
use, and against JAX `gqa_attention`, mirroring tests/test_decode_attention.py
for the bf16/f32 (unquantized) cases. atol=2e-5: float32 on both sides. The
CUDA kernel is held against the plain version on the card in
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.ops.attention import gqa_attention as jax_gqa
from symmetry_tpu.ops.decode_attention import decode_attention as jax_decode
from symmetry_tpu_torch.ops.decode_attention import decode_attention

ATOL = 2e-5


def make_case(B=3, T=64, K=2, G=4, D=128, L=2, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, K * G, D)).astype(np.float32)
    k = rng.normal(size=(L, B, T, K, D)).astype(np.float32)
    v = rng.normal(size=(L, B, T, K, D)).astype(np.float32)
    # ragged: slot 0 nearly full, slot 1 short, slot 2 mid
    if lengths is None:
        lengths = [T - 3, 5, T // 2][:B]
    return q, k, v, np.asarray(lengths, np.int32)


def port(q, k, v, layer, lengths, window=None):
    return decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), layer,
                            torch.from_numpy(lengths), window=window).numpy()


def jax_kernel(q, k, v, layer, lengths, block_t, window=None):
    return np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(layer),
                                 jnp.asarray(lengths), block_t=block_t,
                                 window=window, interpret=True))


def jax_reference(q, k_layer, v_layer, lengths, window=None):
    positions = (lengths - 1)[:, None]
    return np.asarray(jax_gqa(jnp.asarray(q)[:, None], jnp.asarray(k_layer),
                              jnp.asarray(v_layer), jnp.asarray(positions),
                              jnp.asarray(lengths),
                              sliding_window=window))[:, 0]


class TestDecodeAttentionPlain:
    @pytest.mark.parametrize("layer", [0, 1])
    @pytest.mark.parametrize("block_t", [16, 32, 64])
    def test_matches_jax_kernel(self, layer, block_t):
        q, k, v, lengths = make_case()
        got = port(q, k, v, layer, lengths)
        np.testing.assert_allclose(
            got, jax_kernel(q, k, v, layer, lengths, block_t), atol=ATOL,
            rtol=0)
        np.testing.assert_allclose(
            got, jax_reference(q, k[layer], v[layer], lengths), atol=ATOL,
            rtol=0)

    def test_empty_slot_no_nan(self):
        q, k, v, lengths = make_case()
        lengths[1] = 0  # empty slot: garbage out, not NaN
        got = port(q, k, v, 0, lengths)
        assert np.isfinite(got).all()
        want = jax_kernel(q, k, v, 0, lengths, 32)
        np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=ATOL,
                                   rtol=0)

    def test_single_block(self):
        q, k, v, lengths = make_case(T=32)
        np.testing.assert_allclose(
            port(q, k, v, 0, lengths),
            jax_kernel(q, k, v, 0, lengths, 256),  # clamped to T
            atol=ATOL, rtol=0)

    def test_slot_at_full_capacity(self):
        q, k, v, lengths = make_case(T=64, lengths=[64, 64, 1])
        np.testing.assert_allclose(
            port(q, k, v, 1, lengths), jax_kernel(q, k, v, 1, lengths, 32),
            atol=ATOL, rtol=0)

    @pytest.mark.parametrize("G", [1, 2, 8])
    def test_group_sizes(self, G):
        q, k, v, lengths = make_case(G=G, D=32, seed=2)
        np.testing.assert_allclose(
            port(q, k, v, 1, lengths), jax_kernel(q, k, v, 1, lengths, 16),
            atol=ATOL, rtol=0)

    def test_rejects_bad_layer(self):
        q, k, v, lengths = make_case()
        with pytest.raises(ValueError, match="layer"):
            port(q, k, v, 2, lengths)


class TestSlidingWindow:
    @pytest.mark.parametrize("window", [8, 24, 48, 200])
    @pytest.mark.parametrize("block_t", [16, 32])
    def test_matches_jax_sliding(self, window, block_t):
        q, k, v, lengths = make_case(seed=3)
        got = port(q, k, v, 0, lengths, window=window)
        np.testing.assert_allclose(
            got, jax_kernel(q, k, v, 0, lengths, block_t, window=window),
            atol=ATOL, rtol=0)
        np.testing.assert_allclose(
            got, jax_reference(q, k[0], v[0], lengths, window=window),
            atol=ATOL, rtol=0)

    def test_window_larger_than_length_is_full_attention(self):
        q, k, v, lengths = make_case(seed=5)
        np.testing.assert_allclose(
            port(q, k, v, 0, lengths, window=10_000),
            port(q, k, v, 0, lengths), atol=ATOL, rtol=0)
