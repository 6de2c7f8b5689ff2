"""Int8 quantization and the W8A16 product: the PyTorch port against the JAX
package on the same numpy inputs (CPU).

Payloads and scales are compared bit for bit: round half to even and IEEE
division on both sides (weight scales: amax times float32(1 / 127), as the
JAX package's jitted quantize computes them). Products in float32 at 1e-5, the JAX
package's own W8A16 tolerance (tests/test_qmm.py): only the summation order
differs. The W8A16 plain version is held against JAX
`w8a16_matmul(..., interpret=True)` over the shape families of
tests/test_qmm.py; shapes the port's kernel cannot take stay flat and go
through the mixed dot, held against the same JAX kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.ops import qmm as jqmm
from symmetry_tpu.ops import quant as jquant
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.ops.attention import gqa_attention
from symmetry_tpu_torch.ops.qmm import (
    GemvPlan,
    gemv_plan,
    kernel_supports,
    w8a16_apply,
    w8a16_matmul,
)
from symmetry_tpu_torch.ops.quant import (
    PackedQuantizedTensor,
    QuantizedTensor,
    dequantize,
    pack_quantized,
    pack_tree,
    qmatmul,
    quantize,
    quantize_kv,
    unpack_quantized,
)

ATOL = 1e-5


def weight(shape, seed, scale=0.05):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


class TestQuantize:
    @pytest.mark.parametrize("shape", [(64, 32), (3, 128, 96), (1, 7)])
    def test_quantize_matches_jax(self, shape):
        w = weight(shape, 0, scale=1.0)
        got = quantize(torch.from_numpy(w))
        # quantize_jit: how the JAX package quantizes every served weight
        # (quantize_params, int8 init); eager jnp division differs from it
        # in the last bit of some scales.
        want = jquant.quantize_jit(jnp.asarray(w))
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        np.testing.assert_array_equal(dequantize(got).numpy(),
                                      np.asarray(jquant.dequantize(want)))

    def test_round_half_to_even(self):
        """Exact halves (amax 127 -> scale 1) round to even, as jnp.round."""
        w = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32).T
        got = quantize(torch.from_numpy(w)).q.numpy()[:, 0]
        np.testing.assert_array_equal(got, [0, 2, 2, 0, -2, 127])
        np.testing.assert_array_equal(
            got, np.asarray(jquant.quantize(jnp.asarray(w)).q)[:, 0])

    @pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
    def test_quantize_kv_matches_jax(self, dtype):
        x = weight((2, 5, 3, 16), 1, scale=3.0)
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x)
        if dtype == "bfloat16":
            tx = tx.to(torch.bfloat16)
        q, s = quantize_kv(tx)
        jq, js = jquant.quantize_kv(jx)
        assert q.dtype == torch.int8 and s.shape == (2, 5, 3)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    @pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
    def test_mixed_dot_matches_jax(self, lead):
        w = weight((64, 96), 2)
        x = weight((*lead, 5, 64), 3, scale=1.0)
        qt, jqt = quantize(torch.from_numpy(w)), jquant.quantize(
            jnp.asarray(w))
        got = qmatmul(torch.from_numpy(x), qt)
        want = jquant.qmatmul(jnp.asarray(x), jqt)
        assert got.shape == (*lead, 5, 96)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)

    def test_mixed_dot_bf16_activation(self):
        w = weight((64, 64), 4)
        x = weight((6, 64), 5, scale=1.0)
        got = qmatmul(torch.from_numpy(x).to(torch.bfloat16),
                      quantize(torch.from_numpy(w)))
        want = jquant.qmatmul(jnp.asarray(x, jnp.bfloat16),
                              jquant.quantize(jnp.asarray(w)))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   atol=1e-2, rtol=0)

    def test_dense_leaf_is_plain_matmul(self):
        x, w = torch.randn(3, 8), torch.randn(8, 5)
        torch.testing.assert_close(qmatmul(x, w), x @ w)

    def test_int8_kv_scale_folding_matches_jax(self):
        """gqa_attention over an int8 cache: k scales on the scores, v scales
        on the probabilities, against the JAX version (float32)."""
        rng = np.random.default_rng(6)
        B, S, T, K, G, D = 2, 3, 12, 2, 2, 16
        q = rng.normal(size=(B, S, K * G, D)).astype(np.float32)
        kq, ks = jquant.quantize_kv(jnp.asarray(rng.normal(size=(B, T, K, D)),
                                                jnp.float32))
        vq, vs = jquant.quantize_kv(jnp.asarray(rng.normal(size=(B, T, K, D)),
                                                jnp.float32))
        ks, vs = jnp.moveaxis(ks, 1, 2), jnp.moveaxis(vs, 1, 2)
        pos = np.array([[7, 8, 9], [2, 3, 4]], np.int32)
        lengths = np.array([10, 5], np.int32)
        from symmetry_tpu.ops.attention import gqa_attention as jgqa

        want = jgqa(jnp.asarray(q), kq, vq, jnp.asarray(pos),
                    jnp.asarray(lengths), k_scale=ks, v_scale=vs)
        got = gqa_attention(
            torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                                   for a in (kq, vq)),
            torch.from_numpy(pos), torch.from_numpy(lengths),
            k_scale=torch.from_numpy(np.array(ks)),
            v_scale=torch.from_numpy(np.array(vs)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)

    def test_mesh_refused(self):
        qt = quantize(torch.randn(64, 64))
        with pytest.raises(NotImplementedError, match="item 14"):
            pack_quantized(qt, mesh=object(), n_axis="model")
        with pytest.raises(NotImplementedError, match="item 14"):
            pack_tree({"wq": qt}, ("wq",), mesh=object())


class TestPacking:
    def test_roundtrip_bit_exact(self):
        qt = quantize(torch.from_numpy(weight((192, 320), 7)))
        pt = pack_quantized(qt)
        assert isinstance(pt, PackedQuantizedTensor)
        assert pt.q.shape == (5, 192, 64) and pt.scale.shape == (320,)
        rt = unpack_quantized(pt)
        assert torch.equal(rt.q, qt.q) and torch.equal(rt.scale, qt.scale)

    def test_stacked_layers_pack_per_layer(self):
        qt = quantize(torch.from_numpy(weight((3, 64, 128), 8)))
        pt = pack_quantized(qt)
        assert pt.q.shape == (3, 2, 64, 64) and pt.scale.shape == (3, 128)
        one = pack_quantized(QuantizedTensor(qt.q[1], qt.scale[1]))
        assert torch.equal(pt.q[1], one.q)

    def test_untileable_stays_flat(self):
        qt = quantize(torch.ones(100, 96))
        assert isinstance(pack_quantized(qt), QuantizedTensor)
        assert not kernel_supports(100, 96) and not kernel_supports(64, 32)
        assert kernel_supports(4096, 128256) and kernel_supports(14336, 4096)

    def test_pack_tree_reports_degrades(self):
        tree = {"layers": {
            "wq": quantize(torch.randn(2, 64, 64)),
            "wk": quantize(torch.randn(2, 64, 32)),      # N not a panel
            "wg": quantize(torch.randn(2, 4, 64, 64)),   # expert stack
            "attn_norm": torch.ones(2, 64)},
            "lm_head": quantize(torch.randn(64, 512))}
        report = []
        pack_tree(tree, ("wq", "wk", "wg", "lm_head"), report=report)
        assert isinstance(tree["layers"]["wq"], PackedQuantizedTensor)
        assert isinstance(tree["lm_head"], PackedQuantizedTensor)
        assert isinstance(tree["layers"]["wk"], QuantizedTensor)
        assert sorted(report) == [("layers/wg", "expert_stack"),
                                  ("layers/wk", "untileable")]

    def test_gemv_splits_fill_the_card(self):
        # float32 rows take the GEMV's one deal (`gemv_plan`, K splits on a
        # thread-block cluster, no scratch): wk at decode, 16 panels, split
        # 8 ways over K; lm_head never splits; wd's splits whole 64-row
        # steps
        cap = {1: 132, 2: 66, 4: 32, 8: 16}
        assert gemv_plan(8, 4096, 1024, cap) == GemvPlan(8, 8, 512, 16)
        assert gemv_plan(8, 4096, 128256, cap).cluster == 1
        plan = gemv_plan(8, 14336, 4096, cap)
        assert (plan.cluster * plan.k_per_split >= 14336
                and plan.k_per_split % 64 == 0)


class TestConverter:
    def test_flat_jax_leaves(self):
        jtree = {"layers": {"wq": jquant.quantize(jnp.asarray(
            weight((2, 64, 64), 9))), "norm": jnp.ones((2, 64))}}
        tree = params_from_numpy(jax.tree.map(np.asarray, jtree),
                                 device="cpu", dtype=torch.bfloat16)
        wq = tree["layers"]["wq"]
        assert isinstance(wq, QuantizedTensor)
        assert wq.q.dtype == torch.int8 and wq.scale.dtype == torch.float32
        np.testing.assert_array_equal(wq.q.numpy(),
                                      np.asarray(jtree["layers"]["wq"].q))
        assert tree["layers"]["norm"].dtype == torch.bfloat16

    def test_packed_jax_leaves_repack(self):
        """JAX [K/bk, N/bn, bk, bn] tiles unpack and repack into the port's
        panels; a weight the panel kernel cannot take stays flat."""
        jqt = jquant.quantize(jnp.asarray(weight((2, 128, 192), 10)))
        narrow = jquant.quantize(jnp.asarray(weight((64, 32), 11)))
        jtree = {"wq": jquant.pack_quantized(jqt, bk=32, bn=64),
                 "wk": jquant.pack_quantized(narrow, bk=16, bn=16)}
        tree = params_from_numpy(jax.tree.map(np.asarray, jtree),
                                 device="cpu")
        assert isinstance(tree["wq"], PackedQuantizedTensor)
        np.testing.assert_array_equal(
            unpack_quantized(tree["wq"]).q.numpy(), np.asarray(jqt.q))
        np.testing.assert_array_equal(tree["wq"].scale.numpy(),
                                      np.asarray(jqt.scale))
        assert isinstance(tree["wk"], QuantizedTensor)
        np.testing.assert_array_equal(tree["wk"].q.numpy(),
                                      np.asarray(narrow.q))


# (M, K, N) families of tests/test_qmm.py: decode batch, GQA-narrow N, wide
# FFN, FFN contraction, vocab-wide N, ragged K/N, single row, tiny batch,
# verify-block rows.
TRUNK_SHAPES = [(128, 64, 64), (128, 64, 32), (128, 64, 128), (128, 128, 64),
                (128, 64, 512), (32, 192, 320), (1, 64, 512), (2, 64, 64),
                (1152, 64, 64)]


class TestW8A16:
    @pytest.mark.parametrize("m,k,n", TRUNK_SHAPES)
    def test_plain_matches_jax_kernel(self, m, k, n):
        rng = np.random.default_rng(m + k + n)
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = weight((k, n), m * k + n)
        jqt = jquant.quantize(jnp.asarray(w))
        jpt = jquant.pack_quantized(jqt)
        want = np.asarray(jqmm.w8a16_matmul(jnp.asarray(x), jpt.q, jpt.scale,
                                            interpret=True))
        qt = quantize(torch.from_numpy(w))
        leaf = pack_quantized(qt)
        assert isinstance(leaf, PackedQuantizedTensor) == kernel_supports(k, n)
        got = qmatmul(torch.from_numpy(x), leaf).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)

    @pytest.mark.parametrize("m", [8, 96])
    def test_raw_sums_without_scale(self, m):
        rng = np.random.default_rng(m)
        x = rng.normal(size=(m, 128)).astype(np.float32)
        w = weight((128, 128), 12)
        jpt = jquant.pack_quantized(jquant.quantize(jnp.asarray(w)))
        want = np.asarray(jqmm.w8a16_matmul(
            jnp.asarray(x), jpt.q, jpt.scale, out_dtype=jnp.float32,
            apply_scale=False, interpret=True))
        pt = pack_quantized(quantize(torch.from_numpy(w)))
        got = w8a16_matmul(torch.from_numpy(x), pt.q, pt.scale,
                           out_dtype=torch.float32, apply_scale=False)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-6)

    def test_out_dtype_follows_activation(self):
        pt = pack_quantized(quantize(torch.randn(64, 64)))
        x = torch.randn(8, 64, dtype=torch.bfloat16)
        assert w8a16_matmul(x, pt.q, pt.scale).dtype == torch.bfloat16
        assert w8a16_matmul(x, pt.q, pt.scale,
                            out_dtype=torch.float32).dtype == torch.float32

    def test_apply_flattens_leading_dims(self):
        qt = quantize(torch.randn(64, 128))
        pt = pack_quantized(qt)
        x = torch.randn(2, 3, 64)
        got = w8a16_apply(x, pt.q, pt.scale)
        assert got.shape == (2, 3, 128)
        torch.testing.assert_close(got, qmatmul(x, qt), atol=ATOL, rtol=0)

    def test_rejects_mismatched_weight(self):
        pt = pack_quantized(quantize(torch.randn(64, 64)))
        with pytest.raises(ValueError, match="against weight"):
            w8a16_matmul(torch.randn(4, 32), pt.q, pt.scale)
