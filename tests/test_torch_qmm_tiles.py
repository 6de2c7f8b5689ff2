"""The tensor-core matrix kernels' host-side plans and torch models of what
they do to bytes in shared memory (CPU).

The CUDA kernels (csrc/w8a16.cu, csrc/w8a8.cu) run only on the card; what
can be held here is everything around the tensor-core instructions: which
kernel a call takes, how the output is cut into tiles and K splits, that
the int8 -> bf16 conversion by a magic float is exact, that the swizzled
staging layouts the kernels write are read back by the wgmma operand
address maps as `q` (W8A16, MN-major) and `q.T` (W8A8, K-major after the
in-register byte transposition), and that int32 partial sums over K splits
give `w8a8_reference` bit for bit. The W8A16 plain version is held against
the JAX kernel (`w8a16_matmul(interpret=True)`, or the `qmatmul` mixed dot
where that kernel does not tile the shape) at the tensor-core kernel's edge
rows, at the JAX package's own W8A16 tolerance (atol 1e-5 + rtol 1e-5 in
float32: only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.ops import qmm as jqmm
from symmetry_tpu.ops import quant as jquant
from symmetry_tpu_torch.models.llama import PRESETS
from symmetry_tpu_torch.ops import qmm
from symmetry_tpu_torch.ops.quant import (
    PackedQuantizedTensor,
    pack_quantized,
    qmatmul,
    quantize,
)

ROWS = [17, 64, 128, 129, 256, 2000, 2048, 8192]


def leaves(cfg) -> dict[str, tuple[int, int]]:
    """[K, N] of every weight a preset multiplies by."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    return {"wq": (h, cfg.q_dim), "wk": (h, cfg.kv_dim), "wo": (cfg.q_dim, h),
            "wg": (h, i), "wd": (i, h), "lm_head": (h, cfg.vocab_size)}


LEAF_SHAPES = sorted({kn for cfg in PRESETS.values()
                      for kn in leaves(cfg).values()})


def assert_partition(spans: set[tuple[int, int]], total: int) -> None:
    """(start, length) spans tile [0, total) with no gap and no overlap."""
    at = 0
    for start, length in sorted(spans):
        assert start == at and length > 0
        at += length
    assert at == total


class TestTilePlan:
    @pytest.mark.parametrize("k,n", LEAF_SHAPES)
    @pytest.mark.parametrize("m", ROWS)
    def test_w8a16_tiles_cover_output_once(self, m, k, n):
        if not qmm.kernel_supports(k, n):
            pytest.skip(f"[{k}, {n}] stays on the mixed dot")
        rows = qmm.tc_tile_rows(m, n)
        assert rows in qmm.TILE_ROWS
        plan = list(qmm.tiles(m, n, rows))
        # a full cross product of row spans and column spans, each once
        assert len(set(plan)) == len(plan)
        row_spans = {(m0, mr) for m0, _, mr, _ in plan}
        col_spans = {(n0, nc) for _, n0, _, nc in plan}
        assert len(plan) == len(row_spans) * len(col_spans)
        assert_partition(row_spans, m)
        assert_partition(col_spans, n)
        assert all(mr <= rows and nc <= qmm.TILE_COLS for _, _, mr, nc in plan)
        # M fastest: the first tiles share the first column tile
        assert [t[1] for t in plan[:len(row_spans)]] == [0] * len(row_spans)
        # the card is filled where the shape allows: fewer than 128 blocks
        # only when the shortest tile gives no more either, or only by
        # running a second wave of them
        if len(plan) < 128 and rows != min(qmm.TILE_ROWS):
            short = -(-m // min(qmm.TILE_ROWS)) * len(col_spans)
            assert short < 128 or short > qmm._SMS

    @pytest.mark.parametrize("k,n", LEAF_SHAPES)
    @pytest.mark.parametrize("m", [1, 32] + ROWS)
    def test_w8a8_items_cover_output_and_k_once(self, m, k, n):
        if not qmm.w8a8_kernel_supports(m, k, n):
            pytest.skip(f"[{k}, {n}] is outside the W8A8 gate")
        rows, splits, per = qmm.w8a8_plan(m, k, n)
        assert rows in qmm.TILE_ROWS and per % qmm.W8A8_K_STEP == 0
        # the splits partition K (the last may be short, none is empty)
        assert (splits - 1) * per < k <= splits * per
        plan = list(qmm.tiles(m, n, rows))
        assert_partition({(m0, mr) for m0, _, mr, _ in plan}, m)
        assert_partition({(n0, nc) for _, n0, _, nc in plan}, n)
        items = len(plan) * splits
        if splits > 1:
            # split only when the tiles alone leave SMs idle, never past
            # one item per SM, never below four steps a split
            assert len(plan) < 128 and items <= 132
            assert per >= 4 * qmm.W8A8_K_STEP

    def test_prefill_shapes_fill_the_card(self):
        """llama3-8b at the 2048-row budget: 256-row tiles where they give
        at least 128 blocks, 128-row tiles for the narrow K/V leaves."""
        assert qmm.tc_tile_rows(2048, 14336) == 256
        assert qmm.tc_tile_rows(2048, 4096) == 256
        assert qmm.tc_tile_rows(2048, 1024) == 128
        assert len(list(qmm.tiles(2048, 1024, 128))) == 128
        assert qmm.tc_tile_rows(128, 4096) == 128   # the 128 bucket
        assert qmm.tc_tile_rows(17, 14336) == 128
        # `wd` at the 128 bucket: 32 tiles, K = 14336 cut four ways
        assert qmm.w8a8_plan(128, 14336, 4096) == (128, 4, 3584)
        assert qmm.w8a8_plan(128, 4096, 4096) == (128, 4, 1024)
        assert qmm.w8a8_plan(2048, 14336, 4096) == (256, 1, 14336)

    @pytest.mark.parametrize("m", [1, 8, 16, 17, 2048])
    def test_regime(self, m):
        assert qmm.w8a16_regime(m, torch.float32) == "gemv"
        assert qmm.w8a16_regime(m, torch.bfloat16) == (
            "gemv" if m <= qmm.GEMV_ROWS else "tc")

    def test_gate_unchanged(self):
        """K in whole 32s still passes: the tensor-core kernel zero-fills a
        half last step instead of refusing it."""
        assert qmm.kernel_supports(96, 128) and qmm.kernel_supports(32, 64)
        assert not qmm.kernel_supports(48, 64)
        assert qmm.K_GRAIN == 32


# ---------------------------------------------------------------------------
# Torch models of the kernels' byte handling


def byte_perm(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm for selector nibbles 0..7 (no sign replication):
    output byte i is byte sel[i] of the eight bytes (a, b)."""
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def magic_int8_to_float(word: np.ndarray, lane: int) -> np.ndarray:
    """The converter's cvt4 for byte `lane` of a 32-bit word of four int8
    values: flip the sign bits, permute the byte into the mantissa of
    2**23, subtract 2**23 + 128."""
    flipped = word ^ np.uint32(0x80808080)
    bits = byte_perm(flipped, np.full_like(word, 0x4B000000), 0x7650 + lane)
    return bits.view(np.float32) - np.float32(8388736.0)


class TestConversion:
    def test_magic_number_exact_for_every_byte(self):
        values = np.arange(-128, 128, dtype=np.int8)
        for lane in range(4):
            word = (values.view(np.uint8).astype(np.uint32) << (8 * lane)
                    | np.uint32(0x5A5A5A5A) & ~np.uint32(0xFF << (8 * lane)))
            got = magic_int8_to_float(word, lane)
            np.testing.assert_array_equal(got, values.astype(np.float32))
            # and the bf16 the kernel packs is the same number
            bf = torch.from_numpy(got.copy()).to(torch.bfloat16)
            assert torch.equal(bf.float(), torch.from_numpy(
                values.astype(np.float32)))

    def test_transpose4_selectors(self):
        """The transposer's 4 x 4 byte transposition: r[i] = bytes (k = i,
        n = 0..3) in, c[j] = bytes (k = 0..3, n = j) out."""
        rng = np.random.default_rng(0)
        block = rng.integers(0, 256, (4, 4), dtype=np.uint32)  # [k][n]
        r = [np.array([sum(int(block[k, n]) << (8 * n) for n in range(4))],
                      dtype=np.uint32) for k in range(4)]
        t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
        t2, t3 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
        c = [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
             byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]
        for n in range(4):
            want = sum(int(block[k, n]) << (8 * k) for k in range(4))
            assert int(c[n][0]) == want


def w8a16_stage_model(stage: np.ndarray) -> np.ndarray:
    """The converter's writes: the int8 stage [2 panels][64 k][64 n] as 512
    sixteen-byte pieces; piece j (row = j // 4 = panel * 64 + k, quarter
    q = j % 4) becomes bf16 chunks 2q and 2q + 1 of its row, stored at
    chunk ^ (row % 8) of the 128-byte row. Returns the staging tile as
    [128 rows][8 chunks][8 values] (float32 holding the bf16 numbers)."""
    flat = stage.reshape(512, 16)
    out = np.full((128, 8, 8), np.nan, np.float32)
    for j in range(512):
        row, q = j >> 2, j & 3
        for h in range(2):
            chunk = (2 * q + h) ^ (row & 7)
            assert np.isnan(out[row, chunk]).all()  # written once
            out[row, chunk] = flat[j, 8 * h:8 * h + 8]
    return out


def w8a16_operand_model(tile: np.ndarray) -> np.ndarray:
    """What wgmma reads as B [64 k][128 n] through the MN-major descriptor
    (start + 2048 per 16 k, 64-column blocks 8192 bytes apart, 8-row groups
    1024 apart, 128-byte swizzle): element (k, n) of panel n // 64 sits in
    row panel * 64 + k at chunk (n % 64 // 8) ^ (k % 8)."""
    out = np.empty((64, 128), np.float32)
    for k in range(64):
        for n in range(128):
            row = (n // 64) * 64 + k
            out[k, n] = tile[row, ((n % 64) // 8) ^ (k % 8), n % 8]
    return out


def w8a8_stage_model(w_step: np.ndarray) -> np.ndarray:
    """The transposer's writes for one step: w_step [128 k][128 n] int8
    (rows of the flat weight). Thread (warp q, lane l) holds k block
    c = l % 8 (16 rows) and columns 32 q + 8 (l // 8) .. + 7, and stores,
    for each of its 8 columns, the 16 k values as chunk c ^ (n % 8) of row
    n. Returns [128 n][8 chunks][16 bytes]."""
    out = np.full((128, 8, 16), -999, np.int32)
    for warp in range(4):
        for lane in range(32):
            c, nl = lane & 7, warp * 32 + (lane >> 3) * 8
            for row in range(8):
                n = nl + row
                assert (out[n, c ^ (n % 8)] == -999).all()  # written once
                out[n, c ^ (n % 8)] = w_step[16 * c:16 * c + 16, n]
    return out


def w8a8_operand_model(tile: np.ndarray) -> np.ndarray:
    """What the integer wgmma reads as B through the K-major descriptor
    (rows of 128 bytes, a 32-deep slice a 32-byte offset, 128-byte
    swizzle): element (n, k) at chunk (k // 16) ^ (n % 8) of row n."""
    out = np.empty((128, 128), np.int32)
    for n in range(128):
        for k in range(128):
            out[n, k] = tile[n, (k // 16) ^ (n % 8), k % 16]
    return out


class TestStagingMaps:
    def test_w8a16_mn_major_staging_gives_back_q(self):
        rng = np.random.default_rng(1)
        q = rng.integers(-128, 128, (64, 128)).astype(np.int8)  # [k][n]
        # the packed panel layout of one step: [panel][k][64]
        stage = np.stack([q[:, :64], q[:, 64:]])
        tile = w8a16_stage_model(stage.astype(np.float32))
        assert not np.isnan(tile).any()  # a bijection: every chunk written
        np.testing.assert_array_equal(w8a16_operand_model(tile),
                                      q.astype(np.float32))

    def test_w8a16_quarter_warp_stores_spread_over_banks(self):
        """Eight neighbouring lanes (two rows x four quarters) store to
        eight distinct 16-byte chunk slots of the 128-byte bank row."""
        for j0 in range(0, 512, 8):
            for h in range(2):
                slots = {(2 * (j & 3) + h) ^ ((j >> 2) & 7)
                         for j in range(j0, j0 + 8)}
                assert len(slots) == 8

    def test_w8a8_k_major_staging_gives_back_q_transposed(self):
        rng = np.random.default_rng(2)
        w_step = rng.integers(-128, 128, (128, 128)).astype(np.int8)
        tile = w8a8_stage_model(w_step)
        assert (tile != -999).all()
        np.testing.assert_array_equal(w8a8_operand_model(tile),
                                      w_step.T.astype(np.int32))

    def test_w8a8_quarter_warp_stores_one_whole_row(self):
        for lane0 in range(0, 32, 8):
            for row in range(8):
                assert {(lane & 7) ^ row
                        for lane in range(lane0, lane0 + 8)} == set(range(8))


class TestSplitK:
    @pytest.mark.parametrize("m,k,n", [(32, 4096, 1024), (128, 14336, 256),
                                       (5, 1024, 64), (129, 2048, 128)])
    def test_partial_sums_bit_equal_to_reference(self, m, k, n):
        """int32 partials over the plan's K splits, summed, then the two
        rounded multiplies: the plain version bit for bit."""
        rng = np.random.default_rng(m + k + n)
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        wq = quantize(torch.from_numpy(
            (rng.normal(size=(k, n)) * 0.05).astype(np.float32)))
        _, splits, per = qmm.w8a8_plan(m, k, n)
        assert splits > 1
        xq, xs = qmm.quantize_rows(x)
        part = torch.stack([
            qmm._int_product(xq[:, s * per:(s + 1) * per],
                             wq.q[s * per:(s + 1) * per])
            for s in range(splits)])
        assert part.dtype == torch.int32
        got = (part.sum(0, dtype=torch.int32).float() * xs) * wq.scale[None]
        assert torch.equal(got, qmm.w8a8_reference(x, wq.q, wq.scale))


class TestEdgeRowsAgainstJax:
    @pytest.mark.parametrize("m", [17, 65, 129, 255])
    @pytest.mark.parametrize("k,n", [(128, 128), (96, 192)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_jax(self, m, k, n, dtype):
        rng = np.random.default_rng(m * 3 + k + n)
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
        jqt = jquant.quantize(jnp.asarray(w))
        jx = jnp.asarray(x).astype(dtype)
        jpt = jquant.pack_quantized(jqt)
        try:  # the Pallas kernel where it tiles the shape
            assert isinstance(jpt, jquant.PackedQuantizedTensor)
            want = jqmm.w8a16_matmul(jx, jpt.q, jpt.scale, interpret=True)
        except (AssertionError, ValueError):
            want = jquant.qmatmul(jx, jqt)  # else the mixed dot
        want = np.asarray(want).astype(np.float32)
        leaf = pack_quantized(quantize(torch.from_numpy(w)))
        assert isinstance(leaf, PackedQuantizedTensor)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        assert qmm.w8a16_regime(m, tx.dtype) == (
            "gemv" if dtype == "float32" else "tc")
        got = qmatmul(tx, leaf).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:  # one bf16 rounding of the output on each side
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2.0 ** -7 * np.abs(want).max())
