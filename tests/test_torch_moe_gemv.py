"""The MoE mixture's int8 expert products on the grouped GEMV
(ops/moe_gemv.py, csrc/moe_gemv.cu).

On the CPU: the wrapper's plain version against the float32-copy
arithmetic the mixture ran before it (each expert's payload copied to
float32, a float32 matmul, the scale, the cast; written out here), bit for
bit; the kernel's work deal covers every (expert, row, column, K row) once;
the wrapper refuses what the kernel does not take; and `moe_mlp` routes
int8 expert products of at most 64 rows an expert to the wrapper and larger
ones past it.

On the card (marker `gpu`; this file imports nothing of JAX, so there it
runs as `python -m pytest --noconftest -m gpu tests/test_torch_moe_gemv.py`):
the kernel against its plain version at Mixtral's widths and ragged edges,
a Mixtral-width `moe_mlp` at 8 rows against the plain path, two calls
bit-equal, and 100 calls under a second stream's load.
Tolerances are stated beside each comparison.
"""

import dataclasses
import math

import pytest
import torch

from symmetry_tpu_torch.models import moe
from symmetry_tpu_torch.models.llama import preset
from symmetry_tpu_torch.ops import moe_gemv as mg
from symmetry_tpu_torch.ops.quant import QuantizedTensor, quantize

# Clusters of 1, 2, 4 and 8 blocks a card holds at once (GPCs of 16 or 18
# SMs; a card with two GPCs of 14), and a 32-row tile's table, where no
# cluster of more than 2 fits.
CAPACITIES = {"gpc16": {1: 132, 2: 66, 4: 32, 8: 16},
              "gpc14": {1: 132, 2: 66, 4: 30, 8: 14},
              "rows32": {1: 132, 2: 66, 4: 0, 8: 0}}
MIXTRAL = [(4096, 14336), (14336, 4096)]


def _stack(X, K, N, seed, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    return quantize(torch.randn((X, K, N), generator=g) * scale)


def _float32_copy_products(x, w, out_dtype=None, apply_scale=True):
    """The mixture's int8 expert products before the grouped GEMV:
    x [X or 1, M, K] against each expert's payload copied to float32,
    stacked, times the scales, cast."""
    y = torch.stack([torch.matmul(x[e if x.shape[0] > 1 else 0].float(),
                                  w.q[e].float())
                     for e in range(w.q.shape[0])])
    if apply_scale:
        y = y * w.scale[:, None, :]
    return y.to(out_dtype or x.dtype)


class TestPlainVersion:
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("shared", [True, False])
    @pytest.mark.parametrize("apply_scale", [True, False])
    @pytest.mark.parametrize("M", [1, 8, 64])
    def test_equals_float32_copy_products(self, dtype, shared, apply_scale,
                                          M):
        w = _stack(4, 96, 192, M)
        g = torch.Generator().manual_seed(M + 1)
        x = torch.randn((1 if shared else 4, M, 96), generator=g).to(dtype)
        out = torch.float32 if not apply_scale else None
        got = mg.moe_gemv(x, w.q, w.scale, out_dtype=out,
                          apply_scale=apply_scale)
        want = _float32_copy_products(x, w, out, apply_scale)
        assert got.shape == (4, M, 192) and got.dtype == want.dtype
        assert torch.equal(got, want)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_mixture_products_bit_equal(self, dtype):
        """qmatmul_experts, _expert_matmul and _expert_down give what the
        float32-copy products gave, in the layouts they return."""
        w = _stack(4, 64, 128, 3)
        g = torch.Generator().manual_seed(4)
        x = torch.randn((2, 3, 64), generator=g).to(dtype)
        want = _float32_copy_products(x.reshape(1, 6, 64), w)
        got = moe.qmatmul_experts(x, w)
        assert torch.equal(got, want.permute(1, 0, 2).reshape(2, 3, 4, 128))
        xg = torch.randn((4, 5, 64), generator=g).to(dtype)
        want = _float32_copy_products(xg, w)
        assert torch.equal(moe._expert_matmul(xg, w), want)
        assert torch.equal(moe._expert_down(xg, w, None), want)

    def test_more_rows_keep_the_float32_path(self, monkeypatch):
        """Past 64 rows an expert the products bypass the wrapper and are
        the same arithmetic."""
        monkeypatch.setattr(moe, "moe_gemv", _refuse)
        w = _stack(2, 64, 128, 5)
        xg = torch.randn((2, 65, 64), generator=torch.Generator()
                         .manual_seed(6)).to(torch.bfloat16)
        assert torch.equal(moe._expert_matmul(xg, w),
                           _float32_copy_products(xg, w))


def _refuse(*args, **kw):
    raise AssertionError("the grouped GEMV was called")


def _cover(plan, X, M, K, N):
    """Every (expert, row tile, column tile) once per K split, the tiles a
    partition of the rows and columns, the K splits of each a partition of
    [0, K)."""
    spans = {}
    for block, e, row0, n0, k0, k1 in mg.moe_gemv_items(plan, X, M, K, N):
        assert block < plan.cluster * plan.clusters
        assert k1 > k0
        spans.setdefault((e, row0, n0), []).append((k0, k1))
    tiles = [(e, r, n) for e in range(X)
             for r in range(0, M, plan.rows) for n in range(0, N, plan.cols)]
    assert sorted(spans) == sorted(tiles)
    for s in spans.values():
        at = 0
        for k0, k1 in sorted(s):
            assert k0 == at
            at = k1
        assert at == K


class TestDeal:
    @pytest.mark.parametrize("M", [1, 8, 16, 63, 64])
    @pytest.mark.parametrize("X", [8, 4])
    @pytest.mark.parametrize("K,N", MIXTRAL + [(14336, 1024), (96, 192)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("table", sorted(CAPACITIES))
    def test_items_cover_every_product_once(self, M, X, K, N, dtype, table):
        rows, cols = mg.row_tile(M, dtype), mg.tile_cols(dtype)
        cap = CAPACITIES[table]
        plan = mg.moe_gemv_plan(X, M, K, N, rows, cols, cap)
        assert plan.clusters <= cap[plan.cluster]
        assert rows in (mg.BF16_TILES if dtype == torch.bfloat16
                        else mg.F32_TILES)
        if M <= rows:
            assert rows == min(t for t in (mg.BF16_TILES if dtype ==
                                           torch.bfloat16 else mg.F32_TILES)
                               if t >= M)
        if plan.cluster > 1:
            assert plan.k_per_split % 64 == 0
        _cover(plan, X, M, K, N)

    def test_mixtral_decode_is_not_split_and_a_narrow_stack_is(self):
        cap = CAPACITIES["gpc16"]
        for K, N in MIXTRAL:
            plan = mg.moe_gemv_plan(8, 8, K, N, 8, 128, cap)
            assert plan.cluster == 1 and plan.clusters == 132
        for cols in (64, 128):
            assert mg.moe_gemv_plan(2, 8, 14336, 1024, 8, cols,
                                    cap).cluster > 1

    def test_tiles(self):
        assert [mg.row_tile(m, torch.bfloat16) for m in (1, 8, 9, 17, 33,
                                                         64)] == [
            8, 8, 16, 32, 32, 32]
        assert [mg.row_tile(m, torch.float32) for m in (1, 8, 9, 64)] == [
            8, 8, 16, 16]
        assert (mg.tile_cols(torch.bfloat16), mg.tile_cols(torch.float32)) \
            == (128, 64)


class TestRefusals:
    def _ok(self):
        w = _stack(4, 64, 128, 7)
        x = torch.zeros((4, 8, 64), dtype=torch.bfloat16)
        return x, w.q, w.scale

    def test_wrong_shapes(self):
        x, q, s = self._ok()
        for bad in ((x[0], q, s), (x, q[0], s), (x[:, :, :32], q, s),
                    (x[:2], q, s), (x, q, s[:, :64]), (x[:, :0], q, s)):
            with pytest.raises(ValueError):
                mg.moe_gemv(*bad)

    def test_more_than_64_rows(self):
        x, q, s = self._ok()
        with pytest.raises(ValueError, match="rows an expert"):
            mg.moe_gemv(torch.zeros((4, 65, 64)), q, s)

    def test_wrong_dtypes(self):
        x, q, s = self._ok()
        with pytest.raises(TypeError):
            mg.moe_gemv(x, q.float(), s)
        with pytest.raises(TypeError):
            mg.moe_gemv(x, q, s.to(torch.bfloat16))
        with pytest.raises(TypeError):
            mg.check_kernel_operands(x.half(), q, s)

    def test_wrong_devices(self):
        x, q, s = self._ok()
        with pytest.raises(ValueError, match="unsupported device"):
            mg.moe_gemv(x.to("meta"), q.to("meta"), s.to("meta"))
        with pytest.raises(ValueError, match="on meta"):
            mg.check_kernel_operands(x, q.to("meta"), s)

    def test_misalignment_and_untileable_slabs(self):
        x, q, s = self._ok()
        mg.check_kernel_operands(x, q, s)
        shifted = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
        for bad in ((shifted, q, s), (x.transpose(1, 2), q, s)):
            with pytest.raises(ValueError, match="aligned"):
                mg.check_kernel_operands(*bad)
        # TMA's row pitches: K a multiple of 8, N of 16; a ragged last
        # step or column tile is fine
        for K, N in ((48, 96), (40, 80), (24, 48)):
            w = _stack(2, K, N, K + N)
            mg.check_kernel_operands(x[:2, :, :K].contiguous(), w.q, w.scale)
        w = _stack(2, 44, 128, 8)
        with pytest.raises(ValueError, match="whole"):
            mg.check_kernel_operands(x[:2, :, :44].contiguous(), w.q,
                                     w.scale)
        w = _stack(2, 64, 72, 9)
        with pytest.raises(ValueError, match="whole"):
            mg.check_kernel_operands(x[:2], w.q, w.scale)


def _moe_params(cfg, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    E, F, X = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    return {
        "router": (torch.randn((E, X), generator=g) * E ** -0.5).to(dtype),
        "wg": quantize(torch.randn((X, E, F), generator=g) * E ** -0.5),
        "wu": quantize(torch.randn((X, E, F), generator=g) * E ** -0.5),
        "wd": quantize(torch.randn((X, F, E), generator=g) * F ** -0.5),
    }


class TestRouting:
    def _counted(self, monkeypatch):
        calls = []
        real = mg.moe_gemv

        def counted(x, q, scale, **kw):
            calls.append(tuple(x.shape))
            return real(x, q, scale, **kw)

        monkeypatch.setattr(moe, "moe_gemv", counted)
        return calls

    def test_dense_mixture_takes_the_wrapper(self, monkeypatch):
        cfg = preset("tiny-moe")
        lp = _moe_params(cfg, 11)
        calls = self._counted(monkeypatch)
        x = torch.randn((8, 1, cfg.hidden_size))
        y = moe.moe_mlp(x, lp, cfg)
        X, E, F = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        # wg and wu with x shared by every expert, then wd expert-major
        assert calls == [(1, 8, E), (1, 8, E), (X, 8, F)]
        assert y.shape == x.shape
        calls.clear()
        moe.moe_mlp(torch.randn((3, 7, cfg.hidden_size)), lp, cfg)
        assert calls == [(1, 21, E), (1, 21, E), (X, 21, F)]

    def test_dispatch_past_64_rows_does_not(self, monkeypatch):
        cfg = preset("tiny-moe")  # 4 experts, top 2, capacity 2.0: C = T
        lp = _moe_params(cfg, 12)
        calls = self._counted(monkeypatch)
        moe.moe_mlp(torch.randn((1, 128, cfg.hidden_size)), lp, cfg)
        assert calls == []

    def test_dispatch_of_at_most_64_rows_does(self, monkeypatch):
        cfg = dataclasses.replace(preset("tiny-moe"), num_experts=8)
        lp = _moe_params(cfg, 13)
        calls = self._counted(monkeypatch)
        moe.moe_mlp(torch.randn((1, 64, cfg.hidden_size)), lp, cfg)
        C = math.ceil(64 * 2 / 8 * moe.CAPACITY_FACTOR)
        assert C <= mg.EXPERT_ROWS
        assert [c[1] for c in calls] == [C, C, C]

    @pytest.mark.parametrize("K,N", [(64, 128), (64, 32), (44, 72)])
    def test_off_the_cpu_no_float32_path(self, K, N):
        """Off the CPU the products of at most 64 rows go to the kernel's
        wrapper whatever the slabs (`tiny-moe` at {model: 4} has F = 32 a
        rank), which launches or raises: on meta tensors, where the float32
        copy and matmul would run, the wrapper refuses the device."""
        w = _stack(4, K, N, K + N)
        w = QuantizedTensor(w.q.to("meta"), w.scale.to("meta"))
        for x in (torch.zeros((1, 8, K), device="meta"),
                  torch.zeros((4, 64, K), device="meta")):
            with pytest.raises(ValueError, match="unsupported device"):
                moe._int8_experts(x, w)
        assert moe._int8_experts(torch.zeros((4, 65, K), device="meta"),
                                 w).shape == (4, 65, N)

    def test_bf16_stacks_keep_their_matmul(self, monkeypatch):
        cfg = preset("tiny-moe")
        lp = {k: (v.q.float() * v.scale[:, None, :]
                  if isinstance(v, QuantizedTensor) else v)
              for k, v in _moe_params(cfg, 14).items()}
        monkeypatch.setattr(moe, "moe_gemv", _refuse)
        moe.moe_mlp(torch.randn((8, 1, cfg.hidden_size)), lp, cfg)


# ---- On the card -----------------------------------------------------------


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest --noconftest "
                    "-m gpu tests/test_torch_moe_gemv.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_stack(X, K, N, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return quantize(torch.randn((X, K, N), generator=g, device=dev,
                                dtype=torch.bfloat16).mul_(K ** -0.5))


@pytest.mark.gpu
class TestKernelOnCard:
    @pytest.fixture(scope="class")
    def stacks(self):
        dev = cuda_or_skip()
        return {kn: _card_stack(8, *kn, sum(kn), dev)
                for kn in MIXTRAL + [(14336, 1024)]}

    @pytest.mark.parametrize("K,N", MIXTRAL)
    @pytest.mark.parametrize("X", [8, 4])
    @pytest.mark.parametrize("M", [1, 8, 16, 63, 64])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("apply_scale", [True, False])
    def test_kernel_matches_plain(self, stacks, K, N, X, M, dtype,
                                  apply_scale):
        """bf16 rows scaled to bf16: within 2**-7 max|y| (one output
        rounding; float32 sums in another order). Raw float32 sums, and
        float32 rows: within 3e-5 max|y| (float32 sums of up to 14,336
        terms in another order, ~sqrt(K) 2**-24 of their scale)."""
        dev = cuda_or_skip()
        w = stacks[(K, N)]
        q, s = w.q[:X], w.scale[:X]
        g = torch.Generator(device=dev).manual_seed(M * X + K)
        shared = X == 8  # wg / wu take x shared; wd each expert's own
        x = torch.randn((1 if shared else X, M, K), generator=g,
                        device=dev).to(dtype)
        out = None if apply_scale else torch.float32
        before = mg.moe_gemv.launches
        got = mg.moe_gemv(x, q, s, out_dtype=out, apply_scale=apply_scale)
        torch.cuda.synchronize()
        assert mg.moe_gemv.launches == before + 1
        want = mg.moe_gemv_reference(x, q, s, out_dtype=out,
                                     apply_scale=apply_scale)
        assert got.shape == want.shape and got.dtype == want.dtype
        mag = float(want.float().abs().max())
        coarse = dtype == torch.bfloat16 and apply_scale
        tol = (2.0 ** -7 if coarse else 3e-5) * mag
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)

    @pytest.mark.parametrize("K,N", [(64, 128), (128, 64), (96, 192),
                                     (40, 80), (24, 48), (64, 32),
                                     (4104, 14352)])
    @pytest.mark.parametrize("M", [1, 8, 40])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_ragged_edges_match_plain(self, K, N, M, dtype):
        """`tiny-moe`'s slabs (whole and at {model: 4}, F = 32), a K of one
        and a half steps and N of one and a half bf16 tiles, K and N short
        of one step and one tile, and Mixtral's widths one pitch past
        theirs: the boxes' zeros past K and N add nothing and the columns
        past N are not stored. Tolerances as above."""
        dev = cuda_or_skip()
        w = _card_stack(4, K, N, K + N, dev)
        x = torch.randn((4, M, K), device=dev).to(dtype)
        got = mg.moe_gemv(x, w.q, w.scale)
        want = mg.moe_gemv_reference(x, w.q, w.scale)
        mag = float(want.float().abs().max())
        tol = (2.0 ** -7 if dtype == torch.bfloat16 else 3e-5) * mag
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_split_k_matches_plain(self, stacks, dtype):
        """Few items and a long K: the K splits of a cluster summed in rank
        order; tolerances as above."""
        dev = cuda_or_skip()
        w = stacks[(14336, 1024)]
        q, s = w.q[:2], w.scale[:2]
        plan = mg.moe_gemv_plan(2, 8, 14336, 1024, 8, mg.tile_cols(dtype),
                                mg.moe_gemv_capacity(dev, dtype, 8))
        assert plan.cluster > 1
        x = torch.randn((2, 8, 14336), device=dev).to(dtype)
        got = mg.moe_gemv(x, q, s)
        want = mg.moe_gemv_reference(x, q, s)
        mag = float(want.float().abs().max())
        tol = (2.0 ** -7 if dtype == torch.bfloat16 else 3e-5) * mag
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)

    @pytest.mark.parametrize("K,N", MIXTRAL + [(14336, 1024)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_two_calls_bit_equal(self, stacks, K, N, dtype):
        """K sums in a fixed order: the same bits on a second call, raw
        float32 sums included."""
        dev = cuda_or_skip()
        w = stacks[(K, N)]
        x = torch.randn((8, 8, K), device=dev).to(dtype)
        for kw in ({}, {"out_dtype": torch.float32, "apply_scale": False}):
            a = mg.moe_gemv(x, w.q, w.scale, **kw)
            b = mg.moe_gemv(x, w.q, w.scale, **kw)
            torch.cuda.synchronize()
            assert torch.equal(a, b)

    @pytest.mark.parametrize("X,K,N", [(8, 192, 16384), (4, 448, 8192),
                                       (8, 4096, 14336)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_under_a_second_streams_load(self, X, K, N, dtype):
        """Many items a block and steps an item that are not a multiple of
        the four consuming warpgroups (3 and 7; Mixtral's `wg` 64), 100
        calls while a second stream runs matmuls of varied sizes: every
        call finishes, each the first call's bits, the first within the
        tolerances above of the plain version."""
        dev = cuda_or_skip()
        w = _card_stack(X, K, N, X + K + N, dev)
        x = torch.randn((1, 8, K), device=dev).to(dtype)
        first = mg.moe_gemv(x, w.q, w.scale)
        want = mg.moe_gemv_reference(x, w.q, w.scale)
        tol = (2.0 ** -7 if dtype == torch.bfloat16 else 3e-5) * float(
            want.float().abs().max())
        torch.testing.assert_close(first.float(), want.float(), atol=tol,
                                   rtol=0)
        side = torch.cuda.Stream()
        load = torch.randn((2048, 2048), device=dev)
        torch.cuda.synchronize()
        differ = 0
        for i in range(100):
            with torch.cuda.stream(side):
                torch.matmul(load[:128 * (1 + i % 16)], load)
            differ += not torch.equal(mg.moe_gemv(x, w.q, w.scale), first)
        torch.cuda.synchronize()
        assert differ == 0

    def test_mixtral_mlp_at_8_rows(self, monkeypatch):
        """One Mixtral-width layer's mixture at 8 decode rows, bf16, against
        the same call on the plain version: the gates are the same (the
        router runs before the experts); g and u may each differ by one
        bf16 rounding (2**-8 relative), h by about 2**-7, the down
        product's sum of such errors stays within 2**-7 of its scale, and
        the output rounds once more: within 2**-6 max|y|."""
        dev = cuda_or_skip()
        cfg = preset("mixtral-8x7b")
        E, F, X = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
        g = torch.Generator(device=dev).manual_seed(8)
        lp = {"router": torch.randn((E, X), generator=g, device=dev,
                                    dtype=torch.bfloat16).mul_(E ** -0.5),
              "wg": _card_stack(X, E, F, 1, dev),
              "wu": _card_stack(X, E, F, 2, dev),
              "wd": _card_stack(X, F, E, 3, dev)}
        x = torch.randn((8, 1, E), generator=g, device=dev,
                        dtype=torch.bfloat16)
        before = mg.moe_gemv.launches
        got = moe.moe_mlp(x, lp, cfg)
        torch.cuda.synchronize()
        assert mg.moe_gemv.launches == before + 3
        monkeypatch.setattr(moe, "moe_gemv", mg.moe_gemv_reference)
        want = moe.moe_mlp(x, lp, cfg)
        mag = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=2.0 ** -6 * mag, rtol=0)
