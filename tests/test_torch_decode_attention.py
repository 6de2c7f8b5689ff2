"""Decode attention: the PyTorch port against the JAX Pallas kernel.

On the CPU the port's `decode_attention` runs its plain version
(gqa_attention at S = 1 on the layer slice); it is held against JAX
`decode_attention(..., interpret=True)` at every block size the JAX tests
use, and against JAX `gqa_attention`, mirroring tests/test_decode_attention.py
for the bf16/f32 cases and the int8 cases (int8 payload, [L, B, K, T]
scales folded into scores and probabilities). atol=2e-5: float32 on both
sides. The CUDA kernels are held against the plain version on the card in
tests/test_torch_gpu.py; `kernel_supports`, the one gate the wrapper uses,
must take every preset's head dim and group size. The CUDA kernels split
each slot's capacity into the spans of `split_plan` and merge the spans'
partial softmaxes: the plan must cover the capacity exactly, and a torch
model of that arithmetic (float32 partials per live span, then the merge)
must equal the JAX kernel at the same atol.

Append mode (`decode_attention(..., append=(k_new, v_new, positions))`, the
serving path's decode write): the port's plain version (write, then
attend) against JAX `kv_append(interpret=True)` or the JAX engine's index
assignment, then JAX `decode_attention(interpret=True)` on the caches JAX
wrote. Caches bit-equal to the JAX engine's own write (quantize_kv and
`.at[].set`); against the JAX kv_append kernel the payload bit for bit and
the scales at rtol 1e-6 (tests/test_torch_kv_append.py: its interpret mode
rounds the scale's division differently by one float32 ULP). Outputs at
ATOL for float32 q over an int8 cache; bf16 outputs within one bf16 step of
the largest output (2**-7 max|y|: both sides sum in float32 in other
orders, then round). Which split-kernel block stores the row
(`append_writes`) must give exactly one writer per (slot, KV head) whatever
the lengths and windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.models import PRESETS as JAX_PRESETS
from symmetry_tpu.ops.attention import gqa_attention as jax_gqa
from symmetry_tpu.ops import kv_append as jax_kva
from symmetry_tpu.ops.decode_attention import decode_attention as jax_decode
from symmetry_tpu.ops.quant import quantize_kv as jax_quantize_kv
from symmetry_tpu_torch.models.llama import PRESETS
from symmetry_tpu_torch.ops.decode_attention import (
    SPAN,
    append_writes,
    decode_attention,
    group_tile,
    kernel_supports,
    live_blocks,
    split_plan,
)

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

    @pytest.mark.parametrize("G", [1, 2, 4, 7, 8])
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


def quantized(k, v):
    """int8 caches and position-minor [L, B, K, T] scales (JAX quantize_kv,
    as the JAX tests build them)."""
    kq, ks = jax_quantize_kv(jnp.asarray(k))
    vq, vs = jax_quantize_kv(jnp.asarray(v))
    return [np.array(a) for a in (kq, vq, jnp.moveaxis(ks, -1, -2),
                                  jnp.moveaxis(vs, -1, -2))]


def port_int8(q, kq, vq, ks, vs, layer, lengths, window=None):
    t = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs)]
    return decode_attention(t[0], t[1], t[2], layer,
                            torch.from_numpy(lengths), t[3], t[4],
                            window=window).numpy()


def jax_int8(q, kq, vq, ks, vs, layer, lengths, block_t, window=None):
    return np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.int32(layer),
        jnp.asarray(lengths), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), block_t=block_t, window=window,
        interpret=True))


class TestInt8Cache:
    @pytest.mark.parametrize("layer", [0, 1])
    def test_quantized_matches_folded(self, layer):
        q, k, v, lengths = make_case(seed=1)
        kq, vq, ks, vs = quantized(k, v)
        got = port_int8(q, kq, vq, ks, vs, layer, lengths)
        np.testing.assert_allclose(
            got, jax_int8(q, kq, vq, ks, vs, layer, lengths, 32), atol=ATOL,
            rtol=0)
        want = np.asarray(jax_gqa(
            jnp.asarray(q)[:, None], jnp.asarray(kq[layer]),
            jnp.asarray(vq[layer]), jnp.asarray((lengths - 1)[:, None]),
            jnp.asarray(lengths), k_scale=jnp.asarray(ks[layer]),
            v_scale=jnp.asarray(vs[layer])))[:, 0]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("window", [8, 24])
    def test_quantized_sliding(self, window):
        q, k, v, lengths = make_case(seed=4)
        kq, vq, ks, vs = quantized(k, v)
        np.testing.assert_allclose(
            port_int8(q, kq, vq, ks, vs, 1, lengths, window=window),
            jax_int8(q, kq, vq, ks, vs, 1, lengths, 16, window=window),
            atol=ATOL, rtol=0)

    def test_quantized_empty_slot(self):
        q, k, v, lengths = make_case(seed=6)
        lengths[1] = 0
        kq, vq, ks, vs = quantized(k, v)
        got = port_int8(q, kq, vq, ks, vs, 0, lengths)
        assert np.isfinite(got).all()
        want = jax_int8(q, kq, vq, ks, vs, 0, lengths, 32)
        np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=ATOL,
                                   rtol=0)

    @pytest.mark.parametrize("G", [1, 2, 4, 7, 8])
    def test_quantized_group_sizes(self, G):
        q, k, v, lengths = make_case(G=G, D=32, seed=7)
        kq, vq, ks, vs = quantized(k, v)
        np.testing.assert_allclose(
            port_int8(q, kq, vq, ks, vs, 1, lengths),
            jax_int8(q, kq, vq, ks, vs, 1, lengths, 16), atol=ATOL, rtol=0)

    def test_scales_required_with_int8(self):
        q, k, v, lengths = make_case()
        kq, vq, ks, _ = quantized(k, v)
        t = [torch.from_numpy(a) for a in (q, kq, vq, ks)]
        with pytest.raises(ValueError, match="scale"):
            decode_attention(t[0], t[1], t[2], 0, torch.from_numpy(lengths))
        with pytest.raises(ValueError, match="scale"):
            decode_attention(t[0], t[1], t[2], 0, torch.from_numpy(lengths),
                             t[3], None)


class TestKernelGate:
    def test_every_preset_runs_the_kernel(self):
        """The repaired gate: qwen2-7b's group of 7 (28 heads over 4) and
        every other preset's (head_dim, group) take the CUDA kernel."""
        assert PRESETS.keys() == JAX_PRESETS.keys()
        pairs = {(c.dim_per_head, c.num_heads // c.num_kv_heads)
                 for c in PRESETS.values()}
        assert (128, 7) in pairs
        for d, g in sorted(pairs):
            assert kernel_supports(d, g), (d, g)

    @pytest.mark.parametrize("group", [1, 3, 5, 6, 7, 12, 16])
    def test_any_group_size(self, group):
        assert kernel_supports(128, group)

    @pytest.mark.parametrize("head_dim", [16, 24, 40, 80, 96, 112, 136,
                                          192, 256])
    def test_head_dims(self, head_dim):
        """Every multiple of 8 from 16 to 256 runs (at the next built size
        on the card), as the JAX engine serves any head dim; wider, ragged
        or empty groups do not."""
        assert kernel_supports(head_dim, 4)
        assert not kernel_supports(512, 1) and not kernel_supports(100, 1)
        assert not kernel_supports(8, 1) and not kernel_supports(128, 0)


class TestSplitPlan:
    @pytest.mark.parametrize("capacity", [16, 64, 2048, 4096, 32768])
    def test_spans_cover_capacity_exactly(self, capacity):
        plan = split_plan(capacity)
        assert plan[0][0] == 0 and plan[-1][1] == capacity
        for (a, b), (c, _) in zip(plan, plan[1:]):
            assert b == c, "gap or overlap between spans"
        assert all(0 < b - a <= SPAN for a, b in plan)
        assert len(plan) == -(-capacity // SPAN)
        for name, c in PRESETS.items():
            K, G = c.num_kv_heads, c.num_heads // c.num_kv_heads
            chunks = -(-G // group_tile(G))
            # a full slot makes every span live; an empty one none
            assert live_blocks([capacity], capacity, K, G) == (
                len(plan) * K * chunks), name
            assert live_blocks([0], capacity, K, G) == 0, name

    def test_llama3_8b_fills_the_card(self):
        """llama3-8b, 8 slots, capacity 4096, chip_smoke phase 3's lengths:
        at least one live block for each of the H100's 132 SMs."""
        c = PRESETS["llama3-8b"]
        lengths = [0, 1, 4096, 1024, 777, 3000, 2048, 64]
        assert live_blocks(lengths, 4096, c.num_kv_heads,
                           c.num_heads // c.num_kv_heads) >= 132

    def test_window_floor_skips_spans(self):
        # length 600, window 50: rows [550, 600) live only in span 2
        assert live_blocks([600], 768, 1, 1, window=50) == 1
        # length 600, window 100: rows [500, 600) in spans 1 and 2, not 0
        assert live_blocks([600], 768, 1, 1, window=100) == 2
        # length 300, window 100: the floor 200 crosses the edge at 256
        assert live_blocks([300], 768, 1, 1, window=100) == 2

    @pytest.mark.parametrize("group,tile", [(1, 1), (2, 2), (3, 4), (4, 4),
                                            (7, 8), (8, 8), (16, 8)])
    def test_group_tile(self, group, tile):
        assert group_tile(group) == tile


def split_model(q, k, v, lengths, window=None, ks=None, vs=None):
    """The split kernels' arithmetic in float32 torch: per slot and query
    head, one partial (max, sum, unnormalized output) for each span of
    split_plan holding live rows [max(len - window, 0), len), then their
    merge. q [B, nq, D]; k, v [B, T, K, D] (one layer); ks, vs [B, K, T]."""
    B, nq, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = nq // K
    out = torch.zeros((B, nq, D), dtype=torch.float32)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        lo = max(n - window, 0) if window else 0
        for h in range(nq):
            kv = h // G
            parts = []
            for a, e in split_plan(T):
                a, e = max(a, lo), min(e, n)
                if a >= e:
                    continue  # the block exits at once
                s = (k[b, a:e, kv] @ q[b, h]) * D ** -0.5
                if ks is not None:
                    s = s * ks[b, kv, a:e]
                m = s.max()
                p = torch.exp(s - m)
                w = p * vs[b, kv, a:e] if vs is not None else p
                parts.append((m, p.sum(), w @ v[b, a:e, kv]))
            if not parts:
                continue  # finite zeros
            mx = max(m for m, _, _ in parts)
            den = sum(l * torch.exp(m - mx) for m, l, _ in parts)
            num = sum(acc * torch.exp(m - mx) for m, _, acc in parts)
            out[b, h] = num / torch.clamp(den, min=1e-30)
    return out


class TestSplitModel:
    """Lengths on, one before and one past a span edge, 0, T and past T;
    empty spans below the length, above it and below a window floor."""
    T = 3 * SPAN

    def case(self, seed, lengths):
        q, k, v, lengths = make_case(B=len(lengths), T=self.T, K=2, G=4,
                                     D=64, seed=seed, lengths=lengths)
        # bf16-valued float32 inputs, as the card's bf16 path sees them
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
        return q, k, v, lengths

    @pytest.mark.parametrize("window", [None, 100])
    def test_bf16_valued_matches_jax(self, window):
        T = self.T
        lengths = ([0, 1, SPAN - 1, SPAN, SPAN + 1, 300, T, T + 37]
                   if window is None else [0, 1, SPAN + 1, 300, 600, T])
        q, k, v, lengths = self.case(8, lengths)
        got = split_model(torch.from_numpy(q), torch.from_numpy(k[1]),
                          torch.from_numpy(v[1]), lengths, window).numpy()
        want = jax_kernel(q, k, v, 1, np.minimum(lengths, T), 256,
                          window=window)
        assert np.isfinite(got).all()
        live = lengths > 0  # an empty slot's output is garbage by contract
        np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)

    @pytest.mark.parametrize("window", [None, 100])
    def test_int8_matches_jax(self, window):
        T = self.T
        lengths = ([0, 1, SPAN, SPAN + 1, T, T + 5] if window is None
                   else [0, 2, SPAN + 1, 300, 600, T])
        q, k, v, lengths = self.case(9, lengths)
        kq, vq, ks, vs = quantized(k, v)
        got = split_model(*(torch.from_numpy(a) for a in (
            q, kq[0].astype(np.float32), vq[0].astype(np.float32))),
            lengths, window, torch.from_numpy(ks[0]),
            torch.from_numpy(vs[0])).numpy()
        want = jax_int8(q, kq, vq, ks, vs, 0, np.minimum(lengths, T), 256,
                        window=window)
        assert np.isfinite(got).all()
        live = lengths > 0
        np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)


# Append mode: a capacity of two spans and five slots, the step's position
# at a span's first row, at the span before's last row, at T - 1, stale past
# the capacity (written at T - 1), and past its slot's kv_length (written,
# not read).
APPEND_T = 2 * SPAN
APPEND_POS = [SPAN, SPAN - 1, APPEND_T - 1, APPEND_T + 88, 300]
APPEND_LEN = [SPAN + 1, SPAN, APPEND_T, APPEND_T, 100]


def append_case(G, D, seed, bf16=False):
    """q [B, K G, D], caches [2, B, T, K, D], new rows [B, K, D] (float32,
    bf16 values when bf16), positions and lengths, from numpy."""
    q, k, v, lengths = make_case(B=5, T=APPEND_T, K=2, G=G, D=D, seed=seed,
                                 lengths=APPEND_LEN)
    rng = np.random.default_rng(seed + 1)
    k_new, v_new = ((rng.normal(size=(5, 2, D)) * 3).astype(np.float32)
                    for _ in range(2))
    arrays = [q, k, v, k_new, v_new]
    if bf16:
        arrays = [torch.from_numpy(a).bfloat16().float().numpy()
                  for a in arrays]
    return (*arrays, np.asarray(APPEND_POS, np.int32), lengths)


def jax_index_write(cache, layer, rows, pos):
    """The JAX engine's decode write: rows at (layer, slot, min(pos, T-1))."""
    p = jnp.clip(jnp.asarray(pos), 0, cache.shape[2] - 1)
    return cache.at[layer, jnp.arange(cache.shape[1]), p].set(
        rows.astype(cache.dtype))


class TestAppendPlain:
    @pytest.mark.parametrize("D", [128, 96])
    @pytest.mark.parametrize("G", [1, 4, 7, 16])
    def test_int8_matches_jax_kv_append_then_decode(self, G, D):
        layer = 1
        q, k, v, k_new, v_new, pos, lengths = append_case(G, D, G + D)
        kq, vq, ks, vs = quantized(k, v)
        jax_caches = [np.asarray(a) for a in jax_kva.kv_append(
            *(jnp.asarray(a) for a in (kq, vq, ks, vs, k_new, v_new)),
            jnp.int32(layer), jnp.asarray(pos), interpret=True)]
        # the JAX engine's own int8 write: quantize_kv and index assignment
        (jk, jks), (jv, jvs) = (jax_quantize_kv(jnp.asarray(a))
                                for a in (k_new, v_new))
        engine = [np.asarray(jax_index_write(jnp.asarray(c), layer, r, pos))
                  for c, r in ((kq, jk), (vq, jv))]
        for sc, r in ((ks, jks), (vs, jvs)):  # [L, B, K, T], position minor
            moved = jnp.moveaxis(jnp.asarray(sc), -1, -2)
            engine.append(np.array(jnp.moveaxis(
                jax_index_write(moved, layer, r, pos), -1, -2)))
        t = [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)]
        got = decode_attention(
            torch.from_numpy(q), t[0], t[1], layer,
            torch.from_numpy(lengths), t[2], t[3],
            append=(torch.from_numpy(k_new), torch.from_numpy(v_new),
                    torch.from_numpy(pos))).numpy()
        for mine, exact, kernel, name in zip(t, engine, jax_caches,
                                             ("k", "v", "ks", "vs")):
            np.testing.assert_array_equal(mine.numpy(), exact, err_msg=name)
            if name in ("k", "v"):
                np.testing.assert_array_equal(mine.numpy(), kernel,
                                              err_msg=name)
            else:
                np.testing.assert_allclose(mine.numpy(), kernel, rtol=1e-6,
                                           atol=0, err_msg=name)
        want = jax_int8(q, *jax_caches, layer, lengths, SPAN)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("D", [128, 96])
    @pytest.mark.parametrize("G", [1, 4, 7, 16])
    def test_bf16_matches_jax_write_then_decode(self, G, D):
        layer = 0
        q, k, v, k_new, v_new, pos, lengths = append_case(G, D, 50 + G + D,
                                                          bf16=True)
        jq, jk_new, jv_new = (jnp.asarray(a, jnp.bfloat16)
                              for a in (q, k_new, v_new))
        jk, jv = (jax_index_write(jnp.asarray(c, jnp.bfloat16), layer, r,
                                  pos)
                  for c, r in ((k, jk_new), (v, jv_new)))
        want = np.asarray(jax_decode(jq, jk, jv, jnp.int32(layer),
                                     jnp.asarray(lengths), block_t=SPAN,
                                     interpret=True)).astype(np.float32)
        tk, tv = (torch.from_numpy(a).bfloat16() for a in (k, v))
        got = decode_attention(
            torch.from_numpy(q).bfloat16(), tk, tv, layer,
            torch.from_numpy(lengths),
            append=(torch.from_numpy(k_new).bfloat16(),
                    torch.from_numpy(v_new).bfloat16(),
                    torch.from_numpy(pos))).float().numpy()
        for mine, theirs in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(
                mine.float().numpy(), np.asarray(theirs).astype(np.float32))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(want).max())

    def test_stale_slot_past_capacity_writes_last_row_only(self):
        """A position past capacity writes row T - 1 of its own slot and
        layer; every other row, slot and layer is untouched."""
        q, k, v, k_new, v_new, pos, lengths = append_case(4, 128, 3)
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        decode_attention(torch.from_numpy(q), tk, tv, 1,
                         torch.from_numpy(lengths),
                         append=(torch.from_numpy(k_new),
                                 torch.from_numpy(v_new),
                                 torch.from_numpy(pos)))
        written = np.zeros((5, APPEND_T), bool)
        written[np.arange(5), np.clip(pos, 0, APPEND_T - 1)] = True
        np.testing.assert_array_equal(tk.numpy()[1][written],
                                      k_new[[0, 1, 2, 3, 4]])
        np.testing.assert_array_equal(tk.numpy()[1][~written], k[1][~written])
        np.testing.assert_array_equal(tv.numpy()[0], v[0])

    def test_rejects_mismatched_rows(self):
        q, k, v, k_new, v_new, pos, lengths = append_case(4, 128, 4)
        t = [torch.from_numpy(a) for a in (q, k, v, k_new, v_new, pos,
                                           lengths)]
        with pytest.raises(ValueError, match="append"):
            decode_attention(t[0], t[1], t[2], 0, t[6],
                             append=(t[3][:, :1], t[4], t[5]))
        with pytest.raises(ValueError, match="append"):
            decode_attention(t[0], t[1], t[2], 0, t[6],
                             append=(t[3], t[4], t[5][:3]))


class TestAppendOwner:
    """The owner rule over the split kernel's whole grid (K x chunks, B,
    spans): one writer per (slot, KV head), in the span holding the clamped
    position, whatever the lengths and the window -- including blocks that
    find no live row and exit, which must write first."""

    @pytest.mark.parametrize("capacity", [16, 255, 256, 257, 512, 1000,
                                          4096])
    @pytest.mark.parametrize("group", [1, 2, 4, 7, 8, 12, 16])
    def test_one_writer_per_slot_and_head(self, capacity, group):
        K = 2
        chunks = -(-group // group_tile(group))
        spans = len(split_plan(capacity))
        positions = [-3, 0, SPAN - 1, SPAN, capacity - 1, capacity,
                     capacity + 77, capacity // 2]
        B = len(positions)
        rng = np.random.default_rng(capacity + group)
        exiting_writers = 0
        for lengths in ([0] * B, [capacity] * B,
                        [p + 1 for p in positions],
                        rng.integers(0, capacity + 50, B).tolist()):
            for window in (None, 1, 100):
                writers = {}
                for x in range(K * chunks):
                    for b in range(B):
                        for sp in range(spans):
                            if not append_writes((x, b, sp), positions,
                                                 capacity, group):
                                continue
                            key = (b, x // chunks)
                            writers[key] = writers.get(key, 0) + 1
                            p = min(max(positions[b], 0), capacity - 1)
                            assert x % chunks == 0
                            assert sp * SPAN <= p < (sp + 1) * SPAN
                            n = min(max(lengths[b], 0), capacity)
                            lo = max(n - window, 0) if window else 0
                            if max(sp * SPAN, lo) >= min((sp + 1) * SPAN, n):
                                exiting_writers += 1  # writes, then exits
                assert writers == {(b, kv): 1 for b in range(B)
                                   for kv in range(K)}
        assert exiting_writers > 0  # the sweep does cover that case
