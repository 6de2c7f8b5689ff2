"""Fused KV append: the PyTorch port's plain version against the JAX Pallas
kernel in interpret mode (tests/test_kv_append.py's cases).

Both quantize the new row exactly as quantize_kv does and write it at
(layer, slot, min(pos, T - 1)) in place. Payloads are compared bit for
bit; scales at rtol 1e-6 (one float32 ULP: interpret mode may associate the
max and the division differently from the port), and everything not
written must be untouched. The CUDA kernel is held against the plain
version on the card (bit for bit) in tests/test_torch_gpu.py.

The serving path writes a decode row inside the decode-attention launch
(`decode_attention(..., append=...)`); its plain version is held here
against the same JAX kernel on the same cases, and its output against JAX
`decode_attention(interpret=True)` over the caches the JAX kernel wrote
(atol 2e-5, float32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.ops import kv_append as jkva
from symmetry_tpu.ops.decode_attention import decode_attention as jdecode
from symmetry_tpu.ops.quant import quantize_kv as jquantize_kv
from symmetry_tpu_torch.ops.decode_attention import decode_attention
from symmetry_tpu_torch.ops.kv_append import kv_append

L, B, T, K, D = 3, 8, 64, 2, 128


def make_state(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-127, 128, (L, B, T, K, D)).astype(np.int8),
            rng.integers(-127, 128, (L, B, T, K, D)).astype(np.int8),
            rng.uniform(size=(L, B, K, T)).astype(np.float32),
            rng.uniform(size=(L, B, K, T)).astype(np.float32),
            (rng.normal(size=(B, K, D)) * 3.0).astype(np.float32),
            (rng.normal(size=(B, K, D)) * 3.0).astype(np.float32)]


def jax_append(state, layer, positions):
    out = jkva.kv_append(*(jnp.asarray(a) for a in state), jnp.int32(layer),
                         jnp.asarray(positions, jnp.int32), interpret=True)
    return [np.asarray(a) for a in out]


def port_append(state, layer, positions):
    tensors = [torch.from_numpy(a.copy()) for a in state]
    kv_append(*tensors, layer, torch.tensor(positions, dtype=torch.int32))
    return [t.numpy() for t in tensors[:4]]


def assert_same(got, want):
    for g, w, name in zip(got[:2], want[:2], ("k", "v")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w, name in zip(got[2:], want[2:], ("ks", "vs")):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)


class TestKvAppendParity:
    @pytest.mark.parametrize("layer", [0, 2])
    def test_matches_jax_kernel(self, layer):
        # positions spread across scale blocks, incl. block edges
        positions = [0, 1, 31, 32, 33, 62, 63, 40]
        state = make_state(layer)
        assert_same(port_append(state, layer, positions),
                    jax_append(state, layer, positions))

    def test_untouched_rows_survive(self):
        state = make_state(7)
        got = port_append(state, 1, [10] * B)
        assert_same(got, jax_append(state, 1, [10] * B))
        # other layers and other positions bit-identical
        np.testing.assert_array_equal(got[0][0], state[0][0])
        np.testing.assert_array_equal(got[0][1, :, 11:], state[0][1, :, 11:])
        np.testing.assert_array_equal(got[2][2], state[2][2])
        # scale neighbours of the written position survive
        np.testing.assert_array_equal(got[2][1, :, :, :10],
                                      state[2][1, :, :, :10])
        np.testing.assert_array_equal(got[2][1, :, :, 11:],
                                      state[2][1, :, :, 11:])

    def test_out_of_range_position_clamps(self):
        """A stale slot at capacity writes the last row of its own lane."""
        positions = [T, T + 5] + [4] * (B - 2)
        state = make_state(3)
        got = port_append(state, 0, positions)
        assert_same(got, jax_append(state, 0, positions))
        want_q, _ = jquantize_kv(jnp.asarray(state[4][0]))
        np.testing.assert_array_equal(got[0][0, 0, T - 1],
                                      np.asarray(want_q))

    def test_bf16_rows(self):
        """The kernel quantizes its operand's dtype (bf16 upcast to f32)."""
        state = make_state(5)
        rows = [jnp.asarray(a, jnp.bfloat16) for a in state[4:]]
        want = jkva.kv_append(*(jnp.asarray(a) for a in state[:4]), *rows,
                              jnp.int32(1), jnp.arange(B, dtype=jnp.int32),
                              interpret=True)
        tensors = [torch.from_numpy(a.copy()) for a in state[:4]]
        kv_append(*tensors,
                  *(torch.from_numpy(np.asarray(r, np.float32)).to(
                      torch.bfloat16) for r in rows),
                  1, torch.arange(B, dtype=torch.int32))
        assert_same([t.numpy() for t in tensors],
                    [np.asarray(a) for a in want])

    def test_rejects_mismatched_shapes(self):
        tensors = [torch.from_numpy(a) for a in make_state(0)]
        with pytest.raises(ValueError, match="kv_append"):
            kv_append(*tensors[:4], tensors[4][:, :1], tensors[5], 0,
                      torch.zeros(B, dtype=torch.int32))
        with pytest.raises(ValueError, match="layer"):
            kv_append(*tensors, L, torch.zeros(B, dtype=torch.int32))


class TestFusedIntoDecode:
    """The decode launch's own write (append mode) leaves the caches the
    JAX kernel leaves, and attends over them as JAX's decode kernel does."""

    @pytest.mark.parametrize("layer", [0, 2])
    @pytest.mark.parametrize("positions", [
        [0, 1, 31, 32, 33, 62, 63, 40],           # across scale blocks
        [T, T + 5, T - 1, 0, 4, 4, 17, 63]])      # stale slots at capacity
    def test_matches_jax_kernel_then_decode(self, layer, positions):
        # caches as quantize_kv writes them (unit-normal rows), not
        # make_state's arbitrary payloads and scales, whose scores saturate
        # the softmax
        rng = np.random.default_rng(layer)
        (kq, ks), (vq, vs) = (jquantize_kv(jnp.asarray(
            rng.normal(size=(L, B, T, K, D)).astype(np.float32)))
            for _ in range(2))
        state = [np.array(a) for a in (kq, vq, jnp.moveaxis(ks, -1, -2),
                                       jnp.moveaxis(vs, -1, -2))]
        state += make_state(layer + 11)[4:]
        q = rng.normal(size=(B, 4 * K, D)).astype(np.float32)
        lengths = np.minimum(np.asarray(positions) + 1, T).astype(np.int32)
        lengths[3] = 0  # an empty slot still gets its row
        tensors = [torch.from_numpy(a.copy()) for a in state]
        got = decode_attention(
            torch.from_numpy(q), tensors[0], tensors[1], layer,
            torch.from_numpy(lengths), tensors[2], tensors[3],
            append=(tensors[4], tensors[5],
                    torch.tensor(positions, dtype=torch.int32))).numpy()
        want_caches = jax_append(state, layer, positions)
        assert_same([t.numpy() for t in tensors[:4]], want_caches)
        want = np.asarray(jdecode(
            jnp.asarray(q), *(jnp.asarray(a) for a in want_caches[:2]),
            jnp.int32(layer), jnp.asarray(lengths),
            k_scale=jnp.asarray(want_caches[2]),
            v_scale=jnp.asarray(want_caches[3]), interpret=True))
        live = lengths > 0  # an empty slot's output is garbage by contract
        np.testing.assert_allclose(got[live], want[live], atol=2e-5, rtol=0)


def test_jax_is_cpu():
    assert jax.default_backend() == "cpu"
