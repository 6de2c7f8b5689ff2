"""Flash prefill: the PyTorch port against the JAX Pallas kernel.

On the CPU the port's `flash_prefill` runs its plain version; it is held
against JAX `flash_prefill(..., interpret=True)` on the same numpy inputs,
mirroring tests/test_flash.py. Valid rows are compared at atol=2e-5
(float32 on both sides; the kernel's online softmax and the plain
version's one-shot softmax differ only in summation order). The CUDA kernels
are held against the plain version on the card in tests/test_torch_gpu.py;
`flash_variant`, the one gate the wrapper routes by, must send bf16 at every
production preset's head dim to the tensor-core kernel and float32 to the
FMA kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.models import init_cache as jax_init_cache
from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.models.llama import forward_hidden as jax_forward_hidden
from symmetry_tpu.ops.flash import flash_prefill as jax_flash
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.models.llama import (
    PRESETS,
    forward_hidden,
    init_cache,
    preset,
)
from symmetry_tpu_torch.ops.flash import HEAD_DIMS, flash_prefill, flash_variant

ATOL = 2e-5


def case(seed, B, S, nq, nkv, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, nq, D)).astype(dtype)
    k = rng.normal(size=(B, S, nkv, D)).astype(dtype)
    v = rng.normal(size=(B, S, nkv, D)).astype(dtype)
    return q, k, v


def both(q, k, v, seq_lens, window=None):
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(seq_lens), block_q=16,
                                block_k=16, window=window, interpret=True))
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(seq_lens),
                        window=window).numpy()
    return got, want


def assert_valid_rows(got, want, seq_lens, atol=ATOL):
    for b, n in enumerate(seq_lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=atol,
                                   rtol=0)


class TestFlashPlain:
    @pytest.mark.parametrize("nq,nkv,S", [(4, 4, 32), (4, 2, 64), (8, 1, 32)])
    def test_matches_jax_full_length(self, nq, nkv, S):
        q, k, v = case(0, 2, S, nq, nkv, 32)
        seq_lens = np.array([S, S], np.int32)
        got, want = both(q, k, v, seq_lens)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    def test_ragged_lengths_masked(self):
        q, k, v = case(1, 2, 32, 2, 2, 16)
        seq_lens = np.array([20, 7], np.int32)
        got, want = both(q, k, v, seq_lens)
        assert_valid_rows(got, want, seq_lens)
        assert np.isfinite(got).all(), "padded rows must not be NaN"

    @pytest.mark.parametrize("window", [8, 17, 64])
    def test_window_matches_jax(self, window):
        q, k, v = case(3, 2, 64, 4, 2, 32)
        seq_lens = np.array([64, 41], np.int32)
        got, want = both(q, k, v, seq_lens, window=window)
        assert_valid_rows(got, want, seq_lens)

    def test_rejects_unaligned(self):
        q = torch.zeros((1, 200, 2, 16))
        with pytest.raises(ValueError, match="not a multiple"):
            flash_prefill(q, q, q, torch.tensor([20], dtype=torch.int32))

    def test_zero_length_row_is_finite(self):
        q, k, v = case(4, 2, 16, 4, 2, 16)
        seq_lens = np.array([0, 16], np.int32)
        got, want = both(q, k, v, seq_lens)
        assert np.isfinite(got).all()
        assert_valid_rows(got, want, seq_lens)


class TestFlashInModel:
    @pytest.mark.parametrize("window", [None, 12])
    def test_prefill_flash_matches_jax_trunk(self, window):
        """forward_hidden(prefill_flash=True): port vs JAX on one weight set."""
        jcfg = dataclasses.replace(jax_preset("tiny"), sliding_window=window)
        cfg = dataclasses.replace(preset("tiny"), sliding_window=window)
        jparams = jax_init_params(jcfg, jax.random.key(0), jnp.float32)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        tokens = np.random.default_rng(2).integers(0, 512, (2, 32))
        seq_lens = np.array([32, 11], np.int32)
        h_want, c_want = jax_forward_hidden(
            jparams, jcfg, jnp.asarray(tokens, jnp.int32),
            jax_init_cache(jcfg, 2, 32, jnp.float32),
            seq_lens=jnp.asarray(seq_lens), prefill_flash=True)
        h_got, c_got = forward_hidden(
            params, cfg, torch.from_numpy(tokens),
            init_cache(cfg, 2, 32, torch.float32, device="cpu"),
            seq_lens=torch.from_numpy(seq_lens), prefill_flash=True)
        # A whole trunk (two layers of matmuls, norms and MLPs around the
        # attention; layer 1's K/V depend on layer 0's output) accumulates
        # float32 rounding: atol=1e-4, as the model tests use.
        assert_valid_rows(h_got.numpy(), np.asarray(h_want), seq_lens,
                          atol=1e-4)
        np.testing.assert_allclose(c_got.k.numpy(), np.asarray(c_want.k),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(c_got.lengths.numpy(), seq_lens)


class TestFlashVariant:
    PRODUCTION = sorted(n for n in PRESETS if not n.startswith("tiny"))

    @pytest.mark.parametrize("name", PRODUCTION)
    def test_bf16_production_presets_take_tensor_cores(self, name):
        assert flash_variant(torch.bfloat16,
                             PRESETS[name].dim_per_head) == "tensor_core"

    @pytest.mark.parametrize("head_dim", HEAD_DIMS)
    def test_float32_takes_fma(self, head_dim):
        assert flash_variant(torch.float32, head_dim) == "fma"

    def test_production_head_dims_covered(self):
        """llama3.2-1b (64), the 8b-class models (128) and gemma (256)."""
        dims = {PRESETS[n].dim_per_head for n in self.PRODUCTION}
        assert dims == {64, 128, 256}

    def test_cpu_counts_no_launch(self):
        before = (flash_prefill.launches, dict(flash_prefill.variant_launches))
        q, k, v = (torch.from_numpy(a) for a in case(5, 1, 16, 2, 1, 64))
        flash_prefill(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                      torch.tensor([16], dtype=torch.int32))
        assert (flash_prefill.launches,
                flash_prefill.variant_launches) == before
