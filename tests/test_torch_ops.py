"""PyTorch ops against their JAX twins (CPU, float32).

The same numpy inputs, made from a seed, go through symmetry_tpu.ops and
symmetry_tpu_torch.ops. Tolerance: atol=1e-5 — both sides compute in float32
(tests/conftest.py pins JAX matmuls to "highest"), so the only differences
are summation order and transcendental rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.models.llama import _norm_w as jax_norm_w
from symmetry_tpu.models.llama import preset as jax_preset
from symmetry_tpu.ops.attention import gqa_attention as jax_gqa
from symmetry_tpu.ops.norm import rms_norm as jax_rms_norm
from symmetry_tpu.ops.rope import apply_rope as jax_apply_rope
from symmetry_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from symmetry_tpu.ops.sampling import _masked_top_logits as jax_masked_top
from symmetry_tpu.ops.sampling import sample_tokens as jax_sample_tokens
from symmetry_tpu_torch.ops.attention import gqa_attention
from symmetry_tpu_torch.ops.norm import norm_weight, rms_norm
from symmetry_tpu_torch.ops.quant import qmatmul
from symmetry_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from symmetry_tpu_torch.ops.sampling import (
    masked_top_logits,
    sample_tokens,
    uniform_noise,
)

ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestRope:
    @pytest.mark.parametrize("theta", [10000.0, 500000.0])
    def test_cos_sin(self, theta):
        pos = np.random.default_rng(0).integers(0, 4096, (2, 7)).astype(np.int32)
        want = jax_rope_cos_sin(jnp.asarray(pos), 32, theta)
        got = rope_cos_sin(t(pos), 32, theta)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)

    @pytest.mark.parametrize("head_dim", [16, 128])
    def test_apply_rope(self, head_dim):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(2, 5, 4, head_dim)).astype(np.float32)
        pos = rng.integers(0, 2048, (2, 5)).astype(np.int32)
        want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
        got = apply_rope(t(x), t(pos), 10000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


class TestNorm:
    @pytest.mark.parametrize("plus_one", [False, True])
    def test_rms_norm(self, plus_one):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 5, 64)).astype(np.float32)
        w = (0.1 * rng.normal(size=(64,))).astype(np.float32)
        cfg = dataclasses.replace(jax_preset("tiny"), norm_plus_one=plus_one)
        want = jax_rms_norm(jnp.asarray(x), jax_norm_w(jnp.asarray(w), cfg),
                            1e-6)
        got = rms_norm(t(x), norm_weight(t(w), plus_one), 1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_plus_one_runs_in_float32(self):
        w = torch.zeros(4, dtype=torch.bfloat16)
        assert norm_weight(w, True).dtype == torch.float32
        assert norm_weight(w, False) is w


class TestQmatmul:
    def test_dense_is_matmul(self):
        rng = np.random.default_rng(3)
        x, w = rng.normal(size=(2, 3, 8)), rng.normal(size=(8, 5))
        np.testing.assert_allclose(qmatmul(t(x), t(w)).numpy(), x @ w,
                                   atol=1e-12)

    def test_int8_weights_refused(self):
        """A bare int8 tensor has no scales: int8 weights come as
        QuantizedTensor leaves (tests/test_torch_quant.py)."""
        with pytest.raises(TypeError, match="QuantizedTensor"):
            qmatmul(torch.zeros(2, 4), torch.zeros(4, 4, dtype=torch.int8))


def gqa_case(seed, B=3, S=6, T=24, nq=4, nkv=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, nq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, nkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, nkv, D)).astype(np.float32)
    # ragged: each slot's S new positions follow a different cached prefix
    start = np.array([0, 5, 13][:B], np.int32)
    pos = (start[:, None] + np.arange(S, dtype=np.int32)[None]).astype(np.int32)
    kv_len = (start + np.array([S, 3, S][:B], np.int32)).astype(np.int32)
    return q, k, v, pos, kv_len


class TestGqaAttention:
    @pytest.mark.parametrize("window", [None, 4, 9])
    @pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 4), (8, 1)])
    def test_matches_jax(self, window, nq, nkv):
        q, k, v, pos, kv_len = gqa_case(4, nq=nq, nkv=nkv)
        want = jax_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(pos), jnp.asarray(kv_len),
                       sliding_window=window)
        got = gqa_attention(t(q), t(k), t(v), t(pos), t(kv_len),
                            sliding_window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_decode_shape_empty_slot_finite(self):
        q, k, v, pos, kv_len = gqa_case(5, S=1)
        kv_len[1] = 0
        got = gqa_attention(t(q), t(k), t(v), t(pos), t(kv_len))
        assert torch.isfinite(got).all()


class TestSampling:
    def controls(self, B):
        temp = np.array([0.0, 0.7, 1.0, 1.3, 0.0, 0.9][:B], np.float32)
        top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.3, 0.05][:B], np.float32)
        top_k = np.array([0, 5, 0, 70, 3, 0][:B], np.int32)
        return temp, top_p, top_k

    def test_masked_top_cap_logits_match(self):
        rng = np.random.default_rng(6)
        logits = (3 * rng.normal(size=(6, 512))).astype(np.float32)
        temp, top_p, top_k = self.controls(6)
        want_m, want_i = jax_masked_top(jnp.asarray(logits), jnp.asarray(temp),
                                        jnp.asarray(top_p), jnp.asarray(top_k),
                                        64)
        got_m, got_i = masked_top_logits(t(logits), t(temp), t(top_p),
                                         t(top_k), 64)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                                   atol=ATOL)

    def test_greedy_matches_jax_exactly(self):
        rng = np.random.default_rng(7)
        logits = (3 * rng.normal(size=(8, 512))).astype(np.float32)
        B = logits.shape[0]
        zeros = np.zeros(B, np.float32)
        want = jax_sample_tokens(
            jnp.asarray(logits), jax.random.split(jax.random.key(0), B),
            jnp.asarray(zeros), jnp.ones(B), jnp.zeros(B, jnp.int32))
        got = sample_tokens(t(logits), torch.arange(B), torch.zeros(B).long(),
                            t(zeros), torch.ones(B), torch.zeros(B).long())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))

    def test_seeded_draws_reproduce_and_respect_top_k(self):
        rng = np.random.default_rng(8)
        logits = t(rng.normal(size=(4, 512)).astype(np.float32))
        temp = torch.ones(4)
        top_k = torch.full((4,), 3).long()
        seed = torch.tensor([1, 1, 2, 2**62 + 5])
        draws = [sample_tokens(logits, seed, torch.full((4,), s).long(), temp,
                               torch.ones(4), top_k) for s in range(40)]
        again = [sample_tokens(logits, seed, torch.full((4,), s).long(), temp,
                               torch.ones(4), top_k) for s in range(40)]
        draws, again = torch.stack(draws), torch.stack(again)
        assert torch.equal(draws, again)
        top3 = torch.topk(logits, 3, dim=-1).indices
        for b in range(4):
            assert set(draws[:, b].tolist()) <= set(top3[b].tolist())
            assert len(set(draws[:, b].tolist())) > 1  # not stuck on one
        # rows 0 and 1 share (seed, step): identical noise
        u = uniform_noise(seed, torch.full((4,), 7).long(), 64)
        assert torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])

    def test_noise_is_uniform_in_open_interval(self):
        u = uniform_noise(torch.arange(64), torch.zeros(64).long(), 256)
        assert float(u.min()) > 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.01
