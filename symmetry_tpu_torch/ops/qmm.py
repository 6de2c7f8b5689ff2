"""Quantized-weight matrix products: W8A16 (the serving path's
`fused_dequant`) and W8A8 (a tested building block that no serving path
routes, in either package).

Port of symmetry_tpu/ops/qmm.py. On a CUDA tensor each wrapper launches its
hand-written Hopper kernel (csrc/w8a16.cu, csrc/w8a8.cu); on a CPU tensor it
runs its plain version. There is no fallback from a CUDA tensor to the
plain version.

W8A16 (`w8a16_matmul` / `w8a16_apply`, Pallas `_w8a16_kernel`): activations
in bf16 or float32 against int8 weights in the panel layout of ops/quant.py
PackedQuantizedTensor. Numerics are the mixed dot's: float32 products and
sums, the per-output-channel scale applied after the K sum (off with
apply_scale=False, which returns the raw sums), cast to out_dtype (default
the activation's). Kernel regimes (csrc/w8a16.cu, chosen by
`w8a16_regime`):
  - "gemv": up to GEMV_ROWS bf16 rows (decode), bytes bound. The panels'
    columns are the 64-row side of swap-AB wgmma products, x's rows the
    narrow side, so one read of the weight serves every row; each 64-deep
    step's weight and x tile stream through a bulk-copied ring, the weight
    is converted to bf16 in the pipeline, and a panel's K splits run on one
    thread-block cluster whose blocks sum their partials through
    distributed shared memory in a fixed order (`gemv_plan` deals the
    (panel, K split) items);
  - "gemv_f32": float32 activations at any row count, the same ring,
    deal and cluster sums with the products on CUDA-core FMAs (exact
    enough that float32 serving reproduces the CPU's greedy tokens), in
    tiles of up to 16 rows (`gemv_plan` deals row tiles x panels);
  - "tc": more bf16 rows (prefill), operations bound: x by TMA, the int8
    weight by bulk copies into a ring, converted to bf16 inside the
    pipeline, wgmma products, a persistent grid over the output tiles
    `tc_tile_rows` sizes and `tiles` orders.
Launches are counted per kernel (`w8a16_matmul.launches_gemv`,
`.launches_gemv_f32`, `.launches_tc`; `.launches` is their sum). No regime
allocates scratch.

W8A8 (`w8a8_matmul`, Pallas `_kernel`): the activation is quantized per row
to int8 (`quantize_rows`, plain torch, as the JAX package computes it in
XLA outside the kernel), the s8 x s8 product is summed exactly in int32
(int8 wgmma; the flat [K, N] weight is transposed inside the kernel), and
the epilogue is (f32(acc) * row scale) * column scale, two rounded
multiplies in that order, so the kernel equals `w8a8_reference` bit for
bit given the same quantized rows. Few output tiles with a long K are
split over K (`w8a8_plan`); the int32 partials are summed, exactly, by a
second kernel that applies the scales.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple

import torch

from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.quant import mixed_dot

PANEL = 64          # output columns per packed panel
K_GRAIN = 32        # K comes in whole 32-row steps (a GEMV block's rows per
                    # step; the tensor-core kernel zero-fills a half step)
GEMV_ROWS = 16      # bf16 rows up to which the GEMV kernel runs; the
                    # float32 GEMV's row tile
GEMV_STEP = 64      # K rows a GEMV step: 4,096 bytes of a panel
GEMV_CLUSTERS = (1, 2, 4, 8)  # K splits of a panel: its cluster's blocks
# What an item costs beyond its steps, in steps: the hand-off of its sums
# and the pipeline's turn between panels.
_GEMV_ITEM_OVERHEAD = 3
TILE_COLS = 128     # output columns of a tensor-core tile (a panel pair)
TILE_ROWS = (256, 128)  # tile heights both tensor-core kernels are built for
W8A8_K_STEP = 128   # K values the W8A8 kernel multiplies a step
_SMS = 132          # streaming multiprocessors of an H100
# What a tile costs beyond its rows, in rows: the weight step it converts
# (or transposes) and its prologue and epilogue, which a taller tile
# spreads over more rows. From the kernels' times on an H100: a 128-row
# W8A16 tile takes about 0.73 of a 256-row tile's time.
_TILE_OVERHEAD_ROWS = 192


def kernel_supports(k: int, n: int) -> bool:
    """True when the kernels take a [k, n] weight: whole panels of 64
    output columns and a contraction in whole 32-row steps, of any length.
    Every preset's projection and LM head passes; leaves that do not stay
    flat on the mixed dot (pack_tree reports them)."""
    return k > 0 and n > 0 and k % K_GRAIN == 0 and n % PANEL == 0


_REGIME_CODE = {"gemv": 0, "gemv_f32": 1, "tc": 2}  # csrc/w8a16.cu Regime


def w8a16_regime(m: int, dtype: torch.dtype) -> str:
    """Which W8A16 kernel takes m rows of `dtype`: "gemv" (bf16 up to
    GEMV_ROWS rows: bytes bound, swap-AB on the tensor cores), "gemv_f32"
    (every float32 activation, on CUDA-core FMAs) or "tc" (more bf16 rows:
    operations bound, on the tensor cores)."""
    if dtype == torch.float32:
        return "gemv_f32"
    return "gemv" if m <= GEMV_ROWS else "tc"


_gemv_capacity: dict[tuple[int, int], dict[int, int]] = {}


def gemv_capacity(device: torch.device,
                  dtype: torch.dtype = torch.bfloat16) -> dict[int, int]:
    """{cluster size: clusters of it the card holds at once} for the GEMV
    kernel of `dtype` rows (bf16: tensor cores; float32: FMAs), from the
    kernel's occupancy on `device` (how a card's SMs fall into GPCs varies
    from card to card). Asked once a device and dtype; a host query, no
    device synchronization."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    code = kernels.dtype_code(dtype)
    if (index, code) not in _gemv_capacity:
        lib = kernels.library("w8a16")
        table = {}
        with torch.cuda.device(index):
            for c in GEMV_CLUSTERS:
                fit = ctypes.c_int(0)
                kernels.check(lib.w8a16_gemv_capacity(code, c,
                                                      ctypes.byref(fit)),
                              "w8a16_gemv_capacity")
                table[c] = fit.value
        _gemv_capacity[(index, code)] = table
    return _gemv_capacity[(index, code)]


class GemvPlan(NamedTuple):
    """A GEMV launch: x rows in tiles of `rows` (8 or 16: wgmma's N for
    bf16, the FMA tile for float32; rows past m zero); K cut into `cluster`
    splits of `k_per_split` rows, the blocks of one cluster; `clusters`
    clusters, cluster c taking items c, c + clusters, ... of the row tiles
    x panels, row tile fastest."""
    rows: int
    cluster: int
    k_per_split: int
    clusters: int


def gemv_plan(m: int, k: int, n: int,
              capacity: dict[int, int]) -> GemvPlan:
    """The GEMV's work deal for [m, k] x [k, n] (m <= 16 bf16 rows, or
    float32 rows at any m), on a card that holds `capacity[c]` clusters of
    c blocks at once (`gemv_capacity`). Plain Python on the shapes (no
    tensor value), and the launch's only deal: the kernel runs `clusters`
    clusters of `cluster` blocks as given, never more than are resident at
    once. Items are (row tile, panel, K split), all of one size; for each
    cluster size (= splits) that cuts K into that many non-empty splits, a
    block's time is its item count (the items of its cluster) times an
    item's steps plus a fixed hand-off; the least wins, the smaller cluster
    on a tie. So on a card that holds 16 eight-block clusters `wk` (16
    panels) splits 8 ways, and `lm_head` (2,004 panels) is not split."""
    rows = 8 if m <= 8 else GEMV_ROWS
    items = (n // PANEL) * -(-m // rows)
    steps = -(-k // GEMV_STEP)
    best = None
    for c in GEMV_CLUSTERS:  # c = 1 qualifies on any card
        per = -(-steps // c)
        if -(-steps // per) != c or capacity.get(c, 0) < 1:
            continue  # fewer splits than blocks, or no such cluster fits
        clusters = min(items, capacity[c])
        cost = -(-items // clusters) * (per + _GEMV_ITEM_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, GemvPlan(rows, c, per * GEMV_STEP, clusters))
    return best[1]


def gemv_items(plan: GemvPlan, m: int, k: int, n: int
               ) -> Iterator[tuple[int, int, int, int, int]]:
    """The items of a GEMV launch in the kernel's deal: (block, first row,
    panel, first K row, end K row). Block b is rank b % cluster (split b %
    cluster) of cluster b // cluster, which takes items cluster_id,
    cluster_id + clusters, ... of the row tiles x panels, row tile
    fastest."""
    tiles = -(-m // plan.rows)
    for cl in range(plan.clusters):
        for r in range(plan.cluster):
            k0 = r * plan.k_per_split
            k1 = min(k, k0 + plan.k_per_split)
            for t in range(cl, (n // PANEL) * tiles, plan.clusters):
                yield (cl * plan.cluster + r, t % tiles * plan.rows,
                       t // tiles, k0, k1)


def tc_tile_rows(m: int, n: int, work: int = 1) -> int:
    """Rows of an output tile ([rows, TILE_COLS]) for an [m, n] output on a
    persistent grid of one block per SM. A block's time is its tile count
    (`work` units of K for each: the W8A8 kernel's K splits) times a
    tile's cost, rows plus a fixed overhead; the height with the least is
    taken, the taller on a tie. So a large output takes 256 rows (each
    weight step feeds more rows), one whose 256-row tiles would leave SMs
    idle or mostly masked takes 128."""
    col_tiles = -(-n // TILE_COLS)

    def cost(rows: int) -> int:
        items = -(-m // rows) * col_tiles * work
        return -(-items // _SMS) * (rows + _TILE_OVERHEAD_ROWS)

    return min(TILE_ROWS, key=lambda rows: (cost(rows), -rows))


def tiles(m: int, n: int, rows: int) -> Iterator[tuple[int, int, int, int]]:
    """The output tiles of both tensor-core kernels in the order a
    persistent grid walks them (block b of G takes tiles b, b + G, ...):
    (first row, first column, valid rows, valid columns), M fastest, so
    the blocks running together share few weight column tiles and read
    each from device memory once."""
    row_tiles = -(-m // rows)
    for t in range(row_tiles * -(-n // TILE_COLS)):
        m0, n0 = (t % row_tiles) * rows, (t // row_tiles) * TILE_COLS
        yield m0, n0, min(rows, m - m0), min(TILE_COLS, n - n0)


def _unpack(w_packed: torch.Tensor) -> torch.Tensor:
    n_panels, K, panel = w_packed.shape
    return w_packed.transpose(0, 1).reshape(K, n_panels * panel)


def w8a16_reference(x: torch.Tensor, w_packed: torch.Tensor,
                    w_scale: torch.Tensor, *,
                    out_dtype: torch.dtype | None = None,
                    apply_scale: bool = True) -> torch.Tensor:
    """Plain version: the mixed dot, (x.float() @ q.float()) * scale ->
    out_dtype, on the unpacked [K, N] weight."""
    return mixed_dot(x, _unpack(w_packed), w_scale, out_dtype=out_dtype,
                     apply_scale=apply_scale)


def w8a16_matmul(
    x: torch.Tensor,         # [M, K] bf16/f32
    w_packed: torch.Tensor,  # [N / PANEL, K, PANEL] int8
    w_scale: torch.Tensor,   # [N] f32 per output channel
    *,
    out_dtype: torch.dtype | None = None,
    apply_scale: bool = True,
) -> torch.Tensor:
    """x @ dequant(w) -> [M, N] in out_dtype (default x's dtype)."""
    if x.ndim != 2 or w_packed.ndim != 3 or w_packed.shape[2] != PANEL:
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)}, packed weight "
                         f"{tuple(w_packed.shape)}")
    M, K = x.shape
    N = w_packed.shape[0] * PANEL
    if w_packed.shape[1] != K or w_scale.shape != (N,):
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)} against weight "
                         f"{tuple(w_packed.shape)} / scale "
                         f"{tuple(w_scale.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return w8a16_reference(x, w_packed, w_scale, out_dtype=out_dtype,
                               apply_scale=apply_scale)
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: unsupported device {x.device}")
    for name, t in (("w_packed", w_packed), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"w8a16_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
    if w_packed.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError("w8a16_matmul: the weight must be int8 with float32 "
                        "scales")
    if not kernel_supports(K, N):
        raise ValueError(f"w8a16_matmul: weight [{K}, {N}] is not in whole "
                         f"{K_GRAIN}-row steps and {PANEL}-column panels")
    for name, t in (("x", x), ("w_packed", w_packed), ("w_scale", w_scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w8a16_matmul: {name} must be contiguous and "
                             f"16-byte aligned")
    x_code = kernels.dtype_code(x.dtype)
    out_code = kernels.dtype_code(out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    regime = w8a16_regime(M, x.dtype)
    # each kernel's own arguments; csrc/w8a16.cu refuses any other
    splits, per, clusters, tile_rows = 1, K, 0, 0
    if regime == "tc":
        tile_rows = tc_tile_rows(M, N)
    else:
        plan = gemv_plan(M, K, N, gemv_capacity(x.device, x.dtype))
        splits, per, clusters = plan.cluster, plan.k_per_split, plan.clusters
    lib = kernels.library("w8a16")
    rc = lib.w8a16_launch(
        _REGIME_CODE[regime], x_code, out_code, x.data_ptr(),
        w_packed.data_ptr(), w_scale.data_ptr(), out.data_ptr(), M, K, N,
        splits, per, clusters, int(apply_scale), tile_rows,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "w8a16_matmul")
    w8a16_matmul.launches += 1
    setattr(w8a16_matmul, f"launches_{regime}",
            getattr(w8a16_matmul, f"launches_{regime}") + 1)
    return out


# launches = launches_gemv + launches_gemv_f32 + launches_tc
w8a16_matmul.launches = 0
w8a16_matmul.launches_gemv = 0
w8a16_matmul.launches_gemv_f32 = 0
w8a16_matmul.launches_tc = 0


def w8a8_kernel_supports(m: int, k: int, n: int) -> bool:
    """True when the W8A8 kernel takes an [m, k] x [k, n] product:
    contiguous 16-byte rows of x (k % 16) and 8-byte weight-row chunks
    (n % 8). The JAX gate's other reasons do not hold on the card: there is
    no minimum row count (the TPU's MIN_ROWS kept the MXU busy; a short
    tile only idles some of a block's rows here) and no block divisor
    (ragged tiles are masked in the kernel)."""
    return m > 0 and k > 0 and n > 0 and k % 16 == 0 and n % 8 == 0


def w8a8_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(tile rows, K splits, K values per split) for the W8A8 kernel. K is
    cut only when even 128-row tiles leave most SMs without one (a long K
    against few rows: `wd` at the 128 bucket), into at most one item per
    SM and never below four 128-deep steps a split; each split's length
    is a whole number of steps."""
    steps = -(-k // W8A8_K_STEP)
    short_tiles = -(-m // min(TILE_ROWS)) * -(-n // TILE_COLS)
    splits = max(1, min(_SMS // short_tiles, steps // 4))
    per = -(-steps // splits)
    splits = -(-steps // per)
    return tc_tile_rows(m, n, splits), splits, per * W8A8_K_STEP


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: x [M, K] -> (q [M, K] int8, scale [M, 1]
    float32), scale = max(|x|, 1e-8) / 127, q = clip(round(x / scale),
    -127, 127) with round half to even. Divides by the scale tensor (IEEE
    division, as the JAX package), never by a Python scalar (which torch
    turns into a multiply by its reciprocal)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product xq @ wq. On the CPU, an int32 matmul; on the
    card (which has no integer matmul outside a library), a float64 one:
    every partial sum is an integer below 2**53, so it is exact too."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.to(torch.int32), wq.to(torch.int32))
    return torch.matmul(xq.to(torch.float64),
                        wq.to(torch.float64)).to(torch.int32)


def w8a8_reference(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                   *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: quantize_rows, the exact int32 product, then
    (acc.float() * x_scale) * w_scale, cast to out_dtype (default x's)."""
    xq, xs = quantize_rows(x)
    acc = _int_product(xq, wq)
    y = (acc.to(torch.float32) * xs) * w_scale.to(torch.float32)[None, :]
    return y.to(out_dtype or x.dtype)


def w8a8_matmul(
    x: torch.Tensor,         # [M, K] bf16/f32
    wq: torch.Tensor,        # [K, N] int8 (flat QuantizedTensor payload)
    w_scale: torch.Tensor,   # [N] f32 per output channel
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """x @ dequant(wq) with x quantized per row to int8 and the product
    computed as s8 x s8 -> s32 -> [M, N] in out_dtype (default x's)."""
    if x.ndim != 2 or wq.ndim != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"w8a8_matmul: x {tuple(x.shape)} against weight "
                         f"{tuple(wq.shape)}")
    M, K = x.shape
    N = wq.shape[1]
    if w_scale.shape != (N,):
        raise ValueError(f"w8a8_matmul: scale {tuple(w_scale.shape)} for "
                         f"{N} output columns")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return w8a8_reference(x, wq, w_scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {x.device}")
    for name, t in (("wq", wq), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"w8a8_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
    if wq.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError("w8a8_matmul: the weight must be int8 with float32 "
                        "scales")
    if not w8a8_kernel_supports(M, K, N):
        raise ValueError(f"w8a8_matmul: [{M}, {K}] x [{K}, {N}] needs K in "
                         f"whole 16s and N in whole 8s")
    xq, xs = quantize_rows(x)
    for name, t in (("wq", wq), ("w_scale", w_scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w8a8_matmul: {name} must be contiguous and "
                             f"16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    tile_rows, splits, per = w8a8_plan(M, K, N)
    part = (torch.empty((splits, M, N), dtype=torch.int32, device=x.device)
            if splits > 1 else None)
    lib = kernels.library("w8a8")
    rc = lib.w8a8_launch(
        kernels.dtype_code(out_dtype), xq.data_ptr(), wq.data_ptr(),
        xs.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, M, K, N, splits, per,
        tile_rows, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def w8a16_apply(x: torch.Tensor, w_packed: torch.Tensor,
                w_scale: torch.Tensor, *, out_dtype: torch.dtype | None = None,
                apply_scale: bool = True) -> torch.Tensor:
    """qmatmul's packed-leaf entry: any leading shape on x, flattened to
    rows for the kernel."""
    *lead, K = x.shape
    out = w8a16_matmul(x.reshape(-1, K).contiguous(), w_packed, w_scale,
                       out_dtype=out_dtype, apply_scale=apply_scale)
    return out.reshape(*lead, out.shape[-1])


def w8a16_apply_sharded(x: torch.Tensor, w) -> torch.Tensor:
    """qmatmul's entry for a mesh-sharded PackedQuantizedTensor (ops/quant.py:
    the leaf names its mesh axes; the counterpart of the JAX package's
    shard_map'd per-shard kernel): the same kernel on this rank's block.
    Column-parallel (n_axis set: wq/wk/wv/wg/wu/lm_head): x holds the full
    K, the block is an N-slice, the output stays N-sharded and no
    collective runs. Row-parallel (k_axis set: wo/wd): x holds this rank's
    K-slice, the kernel runs with the epilogue scale off into float32, the
    partials are summed over the axis, and the per-column scale applies
    after the sum, then the cast: the JAX package's reduce-then-scale
    order, which the unsharded mixed dot under GSPMD also lowers to."""
    if w.k_axis is None:
        return w8a16_apply(x, w.q, w.scale)
    part = w8a16_apply(x, w.q, w.scale, out_dtype=torch.float32,
                       apply_scale=False)
    return (w.mesh.all_reduce(part, w.k_axis) * w.scale).to(x.dtype)
