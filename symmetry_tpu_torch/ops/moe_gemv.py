"""The int8 expert products of the MoE mixture on a grouped GEMV.

`moe_gemv(x, q, scale)`: for every expert e of a flat int8 stack q [X, K, N]
(QuantizedTensor payload, as pack_tree leaves expert stacks) with float32
scales [X, N], y[e] = (x[e] @ f32(q[e])) * scale[e] cast to out_dtype
(default x's), the scale off with apply_scale=False (the raw float32 sums
of the `model` axis's reduce-then-scale). x is [X, M, K], or [1, M, K]
shared by every expert, with at most EXPERT_ROWS rows an expert; the
output is [X, M, N], expert-major.

On a CUDA tensor the wrapper launches csrc/moe_gemv.cu (one launch for the
whole stack; the card's kernel replaces no pallas_call: the JAX package's
mixed dot is XLA's) or raises; on a CPU tensor it runs the plain version,
the mixed dot of each expert (`moe_gemv_reference`). There is no fallback
from a CUDA tensor to the plain version. `moe_gemv.launches` counts
launches.

The kernel's work deal (`moe_gemv_plan`, `moe_gemv_items`) is the W8A16
GEMV's (ops/qmm.py gemv_plan) with the expert as one more axis: items are
(expert, column tile, row tile, K split), K splits on the blocks of one
thread-block cluster, clusters as many as the card holds at once. Column
tiles are 128 wide for bf16 rows (the last one may reach past N) and 64
for float32 rows; row tiles hold 8, 16 or 32 bf16 rows (one read of a tile
serves every row of it; 33 to 64 rows take two) or 8 or 16 float32 rows.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple

import torch

from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.qmm import GEMV_CLUSTERS, split_deal
from symmetry_tpu_torch.ops.quant import mixed_dot

EXPERT_ROWS = 64      # rows an expert up to which the grouped GEMV runs
# TMA reads x and the stack with row pitches of whole 16 bytes: K a
# multiple of 8 (bf16 x; float32 x needs 4), N of 16 (int8). The boxes'
# zeros fill a ragged last step of K and a ragged last column tile.
K_ALIGN = 8
N_ALIGN = 16
BF16_TILES = (8, 16, 32)  # bf16 row tiles: wgmma's narrow side
F32_TILES = (8, 16)   # float32 row tiles (FMAs)


def row_tile(m: int, dtype: torch.dtype) -> int:
    """Rows of the kernel's row tile for m rows an expert: the smallest
    tile that holds them all, else the largest (more rows run in more
    tiles)."""
    tiles = F32_TILES if dtype == torch.float32 else BF16_TILES
    return next((t for t in tiles if t >= m), tiles[-1])


def tile_cols(dtype: torch.dtype) -> int:
    """Columns of the kernel's column tile: 64 for float32 rows, 128 for
    bf16 rows."""
    return 64 if dtype == torch.float32 else 128


class MoeGemvPlan(NamedTuple):
    """A launch: rows in tiles of `rows`, columns in tiles of `cols`; K cut
    into `cluster` splits of `k_per_split` rows, the blocks of one
    cluster; `clusters` clusters, cluster c taking items c, c + clusters,
    ... of the experts x column tiles x row tiles, row tile fastest, then
    column tile."""
    rows: int
    cols: int
    cluster: int
    k_per_split: int
    clusters: int


def moe_gemv_plan(experts: int, m: int, k: int, n: int, rows: int,
                  cols: int, capacity: dict[int, int]) -> MoeGemvPlan:
    """The deal for `experts` products [m, k] x [k, n] in tiles of `rows`
    x `cols`, on a card that holds `capacity[c]` clusters of c blocks at
    once (`moe_gemv_capacity`): the W8A16 GEMV's K splits and clusters
    (ops/qmm.py split_deal) over this launch's items. Plain Python on the
    shapes. Mixtral's decode (8 experts, 8 bf16 rows) splits no stack: 896
    `wg` items and 256 `wd` items keep 132 blocks busy unsplit."""
    items = experts * -(-n // cols) * -(-m // rows)
    return MoeGemvPlan(rows, cols, *split_deal(items, k, capacity))


def moe_gemv_items(plan: MoeGemvPlan, experts: int, m: int, k: int, n: int
                   ) -> Iterator[tuple[int, int, int, int, int, int]]:
    """The items of a launch in the kernel's deal (csrc/moe_gemv.cu Deal):
    (block, expert, first row, first column, first K row, end K row).
    Block b is rank b % cluster (split b % cluster) of cluster
    b // cluster."""
    row_tiles = -(-m // plan.rows)
    col_tiles = -(-n // plan.cols)
    for cl in range(plan.clusters):
        for r in range(plan.cluster):
            k0 = r * plan.k_per_split
            k1 = min(k, k0 + plan.k_per_split)
            for t in range(cl, experts * col_tiles * row_tiles,
                           plan.clusters):
                yield (cl * plan.cluster + r, t // (row_tiles * col_tiles),
                       t % row_tiles * plan.rows,
                       t // row_tiles % col_tiles * plan.cols, k0, k1)


_capacity: dict[tuple[int, int, int], dict[int, int]] = {}
# (device, dtype, X, M, K, N) -> the launch's plan
_plans: dict[tuple, MoeGemvPlan] = {}


def moe_gemv_capacity(device: torch.device, dtype: torch.dtype,
                      rows: int) -> dict[int, int]:
    """{cluster size: clusters of it the card holds at once} for the kernel
    of `dtype` rows in tiles of `rows`, from its occupancy on `device`.
    Asked once a device, dtype and tile; a host query, no device
    synchronization."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    code = kernels.dtype_code(dtype)
    key = (index, code, rows)
    if key not in _capacity:
        lib = kernels.library("moe_gemv")
        table = {}
        with torch.cuda.device(index):
            for c in GEMV_CLUSTERS:
                fit = ctypes.c_int(0)
                kernels.check(lib.moe_gemv_capacity(code, rows, c,
                                                    ctypes.byref(fit)),
                              "moe_gemv_capacity")
                table[c] = fit.value
        _capacity[key] = table
    return _capacity[key]


def moe_gemv_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       *, out_dtype: torch.dtype | None = None,
                       apply_scale: bool = True) -> torch.Tensor:
    """Plain version: the mixed dot of each expert, stacked ([X, M, N])."""
    return torch.stack([
        mixed_dot(x[e if x.shape[0] > 1 else 0], q[e], scale[e],
                  out_dtype=out_dtype, apply_scale=apply_scale)
        for e in range(q.shape[0])])


def check_kernel_operands(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> None:
    """Raise unless the kernel takes these operands: slabs whose K and N
    are whole multiples of K_ALIGN and N_ALIGN, every tensor contiguous and
    16-byte aligned, all on x's device, x bf16 or float32."""
    K, N = q.shape[1:]
    if K % K_ALIGN or N % N_ALIGN:
        raise ValueError(f"moe_gemv: slabs [{K}, {N}] are not whole "
                         f"multiples of {K_ALIGN} rows and {N_ALIGN} "
                         f"columns")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"moe_gemv: x must be bf16 or float32, got "
                        f"{x.dtype}")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"moe_gemv: {name} on {t.device}, x on "
                             f"{x.device}")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_gemv: {name} must be contiguous and "
                             f"16-byte aligned")


def moe_gemv(
    x: torch.Tensor,       # [X, M, K] or [1, M, K], bf16/f32
    q: torch.Tensor,       # [X, K, N] int8
    scale: torch.Tensor,   # [X, N] f32
    *,
    out_dtype: torch.dtype | None = None,
    apply_scale: bool = True,
) -> torch.Tensor:
    """Every expert's x @ dequant(q) -> [X, M, N] in out_dtype (default
    x's dtype)."""
    if x.ndim != 3 or q.ndim != 3:
        raise ValueError(f"moe_gemv: x {tuple(x.shape)}, stack "
                         f"{tuple(q.shape)}")
    X, K, N = q.shape
    xe, M, xk = x.shape
    if xe not in (1, X) or xk != K or scale.shape != (X, N):
        raise ValueError(f"moe_gemv: x {tuple(x.shape)} against stack "
                         f"{tuple(q.shape)} / scale {tuple(scale.shape)}")
    if not 1 <= M <= EXPERT_ROWS:
        raise ValueError(f"moe_gemv: {M} rows an expert; the kernel takes "
                         f"1 to {EXPERT_ROWS}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("moe_gemv: the stack must be int8 with float32 "
                        "scales")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return moe_gemv_reference(x, q, scale, out_dtype=out_dtype,
                                  apply_scale=apply_scale)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemv: unsupported device {x.device}")
    check_kernel_operands(x, q, scale)
    key = (x.device, x.dtype, X, M, K, N)
    plan = _plans.get(key)
    if plan is None:  # a decode step asks the same few shapes every layer
        rows = row_tile(M, x.dtype)
        plan = _plans[key] = moe_gemv_plan(
            X, M, K, N, rows, tile_cols(x.dtype),
            moe_gemv_capacity(x.device, x.dtype, rows))
    out = torch.empty((X, M, N), dtype=out_dtype, device=x.device)
    lib = kernels.library("moe_gemv")
    rc = lib.moe_gemv_launch(
        kernels.dtype_code(x.dtype), kernels.dtype_code(out_dtype),
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), X,
        int(xe == 1), M, K, N, plan.rows, plan.cols, plan.cluster,
        plan.k_per_split, plan.clusters, int(apply_scale),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "moe_gemv")
    moe_gemv.launches += 1
    return out


moe_gemv.launches = 0
