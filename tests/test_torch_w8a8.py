"""W8A8 (ops/qmm.py): the PyTorch port's plain version against the JAX
package's Pallas kernel in interpret mode, on the cases of
tests/test_qmm.py (CPU).

`quantize_rows` is compared bit for bit with the JAX function run op by
op (IEEE division by the scale tensor and round half to even on both
sides). The int32 accumulator is compared exactly against numpy's integer
product. Given the same row scales, the port's epilogue reproduces the JAX
kernel's output bit for bit. Inside the JAX kernel's jit, XLA rewrites the
scale division and some row scales land one float32 ULP away, so the
end-to-end output is held to the JAX kernel within 4 float32 ULPs (two
multiplies by a scale one ULP off). The JAX test's own tolerance against
its integer reference is rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.ops import qmm as jqmm
from symmetry_tpu.ops import quant as jquant
from symmetry_tpu_torch.ops.qmm import (
    _int_product,
    quantize_rows,
    w8a8_kernel_supports,
    w8a8_matmul,
    w8a8_reference,
)
from symmetry_tpu_torch.ops.quant import quantize

MAX_ULPS = 4


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place (same signs)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.signbit(a), np.signbit(b))
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def case(M=64, K=128, N=256, seed=0):
    """x [M, K] and w [K, N] float32 from numpy, and w quantized by each
    package (bit-equal, tests/test_torch_quant.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    return x, w, quantize(torch.from_numpy(w)), jquant.quantize_jit(
        jnp.asarray(w))


class TestQuantizeRows:
    @pytest.mark.parametrize("shape", [(64, 128), (1, 16), (7, 96)])
    def test_bit_equal_to_jax(self, shape):
        x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
        x[0, :3] = [0.0, 1e-9, -1e-9]
        q, s = quantize_rows(torch.from_numpy(x))
        jq, js = jqmm.quantize_rows(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.shape == (shape[0], 1)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    def test_zero_row_keeps_floor_scale(self):
        q, s = quantize_rows(torch.zeros((2, 16)))
        assert torch.equal(q, torch.zeros((2, 16), dtype=torch.int8))
        np.testing.assert_array_equal(
            s.numpy(), np.float32(np.float32(1e-8) / np.float32(127.0)))


class TestW8A8:
    def test_integer_accumulator_exact(self):
        x, _, wq, _ = case()
        xq, _ = quantize_rows(torch.from_numpy(x))
        acc = _int_product(xq, wq.q)
        want = xq.numpy().astype(np.int64) @ wq.q.numpy().astype(np.int64)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), want)

    def test_matches_integer_reference(self):
        """The epilogue in the stated order on numpy's exact sums."""
        x, _, wq, _ = case()
        got = w8a8_reference(torch.from_numpy(x), wq.q, wq.scale)
        xq, xs = quantize_rows(torch.from_numpy(x))
        acc = xq.numpy().astype(np.int32) @ wq.q.numpy().astype(np.int32)
        want = (acc.astype(np.float32) * xs.numpy()) * wq.scale.numpy()[None]
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("M,K,N", [(64, 128, 256), (32, 192, 320),
                                       (128, 512, 512)])
    def test_matches_jax_interpret(self, M, K, N):
        x, _, wq, jwq = case(M, K, N, seed=M + K)
        got = w8a8_matmul(torch.from_numpy(x), wq.q, wq.scale)
        want = np.asarray(jqmm.w8a8_matmul(jnp.asarray(x), jwq.q, jwq.scale,
                                           interpret=True))
        assert got.shape == (M, N) and got.dtype == torch.float32
        assert ulps(got.numpy(), want) <= MAX_ULPS

    @pytest.mark.parametrize("M,K,N", [(64, 128, 256), (32, 192, 320)])
    def test_bit_equal_to_jax_given_its_row_scales(self, M, K, N):
        """The JAX kernel's rows quantize identically; with the row scales
        its jit computes, the port's exact sums and epilogue give its
        output bit for bit."""
        x, _, wq, jwq = case(M, K, N, seed=M + K)
        jq, js = jax.jit(jqmm.quantize_rows)(jnp.asarray(x))
        xq, _ = quantize_rows(torch.from_numpy(x))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
        acc = _int_product(xq, wq.q)
        mine = ((acc.float() * torch.from_numpy(np.asarray(js)))
                * wq.scale[None, :])
        want = np.asarray(jqmm.w8a8_matmul(jnp.asarray(x), jwq.q, jwq.scale,
                                           interpret=True))
        np.testing.assert_array_equal(mine.numpy(), want)

    def test_close_to_dense(self):
        x, w, wq, _ = case()
        got = w8a8_matmul(torch.from_numpy(x), wq.q, wq.scale).numpy()
        want = x @ w
        # both operands are 8-bit: ~1% relative on a 128-deep contraction
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert err < 0.02, err

    def test_out_dtype(self):
        x, _, wq, jwq = case()
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = w8a8_matmul(xb, wq.q, wq.scale)
        assert got.dtype == torch.bfloat16
        got32 = w8a8_matmul(xb, wq.q, wq.scale, out_dtype=torch.float32)
        assert got32.dtype == torch.float32
        # the cast is the last step: bit-equal to the float32 result cast
        assert torch.equal(got, got32.to(torch.bfloat16))
        # bf16 rows tie more often, so a row scale one ULP off in the JAX
        # jit (module docstring) can move an int8 step: one bf16 step of
        # the largest output
        want = np.asarray(jqmm.w8a8_matmul(
            jnp.asarray(x, jnp.bfloat16), jwq.q, jwq.scale,
            interpret=True)).astype(np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2.0 ** -7 * np.abs(want).max(), err

    def test_block_fallback_shapes(self):
        """Shapes the TPU kernel tiles with its smaller blocks (K=192,
        N=320) at its MIN_ROWS edge."""
        x = torch.ones((jqmm.MIN_ROWS, 192))
        w = quantize(torch.ones((192, 320)))
        got = w8a8_matmul(x, w.q, w.scale)
        assert got.shape == (jqmm.MIN_ROWS, 320)
        want = np.asarray(jqmm.w8a8_matmul(
            jnp.ones((jqmm.MIN_ROWS, 192)), jnp.asarray(w.q.numpy()),
            jnp.asarray(w.scale.numpy()), interpret=True))
        assert ulps(got.numpy(), want) <= MAX_ULPS

    def test_rejects_mismatched_shapes(self):
        _, _, wq, _ = case()
        with pytest.raises(ValueError):
            w8a8_matmul(torch.ones((4, 64)), wq.q, wq.scale)
        with pytest.raises(ValueError):
            w8a8_matmul(torch.ones((4, 128)), wq.q, wq.scale[:8])


class TestGate:
    def test_card_gate(self):
        """The port's gate keeps the shape reasons that hold on the card
        (K in whole 16s, N in whole 8s) and drops the TPU-only ones."""
        assert w8a8_kernel_supports(128, 4096, 14336)
        assert w8a8_kernel_supports(128, 4096, 128256)  # llama3 lm_head
        assert w8a8_kernel_supports(jqmm.MIN_ROWS - 1, 4096, 14336)
        assert w8a8_kernel_supports(1, 16, 8)
        assert not w8a8_kernel_supports(128, 100, 14336)  # K untileable
        assert not w8a8_kernel_supports(128, 4096, 258)   # N untileable
        assert not w8a8_kernel_supports(0, 4096, 14336)

    def test_tpu_gate_reasons_differ(self):
        """The JAX gate refuses MIN_ROWS - 1 rows and the CPU backend; the
        port's wrapper takes both (the CPU runs the plain version)."""
        assert not jqmm.supports(jqmm.MIN_ROWS - 1, 4096, 14336, "tpu")
        assert not jqmm.supports(128, 4096, 14336, "cpu")
        x, _, wq, _ = case(M=jqmm.MIN_ROWS - 1)
        assert w8a8_matmul(torch.from_numpy(x), wq.q, wq.scale).shape == (
            jqmm.MIN_ROWS - 1, 256)
