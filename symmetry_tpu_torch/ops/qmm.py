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
the activation's). Kernel regimes (csrc/w8a16.cu): up to GEMV_ROWS rows,
and every float32 activation, take the bytes-bound GEMV kernel, split over
K when the output has too few panels to fill the card; more bf16 rows take
the WMMA tensor-core kernel.

W8A8 (`w8a8_matmul`, Pallas `_kernel`): the activation is quantized per row
to int8 (`quantize_rows`, plain torch, as the JAX package computes it in
XLA outside the kernel), the s8 x s8 product is summed exactly in int32,
and the epilogue is (f32(acc) * row scale) * column scale, two rounded
multiplies in that order, so the kernel equals `w8a8_reference` bit for
bit given the same quantized rows.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.quant import mixed_dot

PANEL = 64          # output columns per packed panel
K_STEP = 32         # the WMMA kernel's K step
GEMV_ROWS = 16      # bf16 rows up to which the GEMV kernel runs
_GEMV_ROW_TILE = 8  # x rows per GEMV block
_GEMV_K_CHUNK = 256  # K rows a GEMV block stages at a time
_TARGET_BLOCKS = 264  # two blocks per SM of an H100


def kernel_supports(k: int, n: int) -> bool:
    """True when the kernel takes a [k, n] weight: whole panels of 64
    output columns and a contraction in whole 32-row steps. Every preset's
    projection and LM head passes; leaves that do not stay flat on the
    mixed dot (pack_tree reports them)."""
    return k > 0 and n > 0 and k % K_STEP == 0 and n % PANEL == 0


def gemv_splits(m: int, k: int, n: int) -> tuple[int, int]:
    """(splits, rows per split) of the K dimension for the GEMV kernel:
    enough splits that about _TARGET_BLOCKS blocks run, each split a whole
    number of staged chunks."""
    blocks = (n // PANEL) * -(-m // _GEMV_ROW_TILE)
    want = max(1, -(-_TARGET_BLOCKS // blocks))
    per = -(-k // want)
    per = -(-per // _GEMV_K_CHUNK) * _GEMV_K_CHUNK
    return -(-k // per), per


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
                         f"{K_STEP}-row steps and {PANEL}-column panels")
    for name, t in (("x", x), ("w_packed", w_packed), ("w_scale", w_scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w8a16_matmul: {name} must be contiguous and "
                             f"16-byte aligned")
    x_code = kernels.dtype_code(x.dtype)
    out_code = kernels.dtype_code(out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    splits, per = 1, K
    part = None
    if x.dtype == torch.float32 or M <= GEMV_ROWS:
        splits, per = gemv_splits(M, K, N)
        if splits > 1:
            part = torch.empty((splits, M, N), dtype=torch.float32,
                               device=x.device)
    lib = kernels.library("w8a16")
    rc = lib.w8a16_launch(
        x_code, out_code, x.data_ptr(), w_packed.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, M, K, N, splits, per,
        int(apply_scale), torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "w8a16_matmul")
    w8a16_matmul.launches += 1
    return out


w8a16_matmul.launches = 0


def w8a8_kernel_supports(m: int, k: int, n: int) -> bool:
    """True when the W8A8 kernel takes an [m, k] x [k, n] product:
    contiguous 16-byte rows of x (k % 16) and 8-byte weight-row chunks
    (n % 8). The JAX gate's other reasons do not hold on the card: there is
    no minimum row count (the TPU's MIN_ROWS kept the MXU busy; a short
    tile only idles some of a block's rows here) and no block divisor
    (ragged tiles are masked in the kernel)."""
    return m > 0 and k > 0 and n > 0 and k % 16 == 0 and n % 8 == 0


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
    lib = kernels.library("w8a8")
    rc = lib.w8a8_launch(
        kernels.dtype_code(out_dtype), xq.data_ptr(), wq.data_ptr(),
        xs.data_ptr(), w_scale.data_ptr(), out.data_ptr(), M, K, N,
        torch.cuda.current_stream(x.device).cuda_stream)
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
