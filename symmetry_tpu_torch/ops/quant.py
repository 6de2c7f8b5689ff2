"""Int8 weight and KV quantization (port of symmetry_tpu/ops/quant.py).

Symmetric per-output-channel int8: for w [.., in, out], each output column
gets scale = max|column| / 127, q = round(w / scale). The matmul computes
(x @ q) * scale, exact with respect to per-column scaling; the int8 weight
halves the bytes a decode step streams against bf16.

Weights come in three layouts, and the layout is the routing in `qmatmul`:
  - a dense tensor: x @ w;
  - QuantizedTensor (flat [.., K, N] int8 + [.., N] scales): the mixed dot
    in plain torch -- float32 products and sums, the scale, a cast back to
    the activation dtype -- as XLA computes it outside any Pallas kernel;
  - PackedQuantizedTensor: the hand-written W8A16 kernel (ops/qmm.py).

Rounding is half to even (torch.round, like jnp.round) and the divisions
are IEEE, so payloads are bit-equal to the JAX package's on the same input
(weights: as its jitted quantize computes them; see `quantize`).
Meshes are not ported: mesh arguments raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MESH_NOT_PORTED = ("mesh-sharded int8 packing is not ported yet "
                   "(ROADMAP Queue 1 item 14)")


class QuantizedTensor(NamedTuple):
    q: torch.Tensor      # int8, same shape as the dense weight [.., K, N]
    scale: torch.Tensor  # float32, weight shape minus the contraction dim


class PackedQuantizedTensor(NamedTuple):
    """Int8 weight in the W8A16 kernel's layout (ops/qmm.py).

    q is [.., N / PANEL, K, PANEL] int8 (PANEL = 64 output columns): the
    flat [.., K, N] payload cut into column panels, each panel one
    contiguous run of K rows of 64 bytes. A kernel block owns one panel and
    streams it front to back, so every weight byte is read once, by 8-byte
    loads of neighbouring threads, with no strided gather. (The JAX
    package's [K/bk, N/bn, bk, bn] tiles are a TPU DMA choice.) scale stays
    the flat per-output-channel [.., N] float32. Packing moves bytes only:
    unpack_quantized gives back the flat leaf bit for bit."""

    q: torch.Tensor
    scale: torch.Tensor


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 by IEEE division. PyTorch divides by a Python (or 0-d)
    scalar as a multiply by the scalar's reciprocal, which is one ULP off
    for some x; an elementwise divisor divides for real, as the kernels and
    XLA do."""
    return x / torch.full_like(x, 127.0)


def quantize(w: torch.Tensor, *, contract_axis: int = -2) -> QuantizedTensor:
    """Quantize a dense weight along its contraction (input) axis, with the
    arithmetic of the JAX package's `quantize_jit` (what its
    quantize_params and int8 init run): under jit XLA folds the division
    of amax by 127 into a multiply by float32(1 / 127), so the scale is
    computed so here, and payloads and scales are bit-equal to its."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    amax = torch.clamp_min(amax, 1e-8)
    scale = amax * torch.full_like(amax, 1 / 127)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale.squeeze(contract_axis))


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.float32,
               *, contract_axis: int = -2) -> torch.Tensor:
    scale = qt.scale.unsqueeze(contract_axis)
    return (qt.q.to(torch.float32) * scale).to(dtype)


def mixed_dot(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
              out_dtype: torch.dtype | None = None,
              apply_scale: bool = True) -> torch.Tensor:
    """(x @ q) with float32 products and sums, times the per-column scale
    (unless apply_scale=False), cast to out_dtype (default x's dtype)."""
    y = torch.matmul(x.to(torch.float32), q.to(torch.float32))
    if apply_scale:
        y = y * scale
    return y.to(out_dtype or x.dtype)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense tensor, a QuantizedTensor or a
    PackedQuantizedTensor ([in, out] contraction)."""
    if isinstance(w, PackedQuantizedTensor):
        from symmetry_tpu_torch.ops.qmm import w8a16_apply

        return w8a16_apply(x, w.q, w.scale)
    if isinstance(w, QuantizedTensor):
        return mixed_dot(x, w.q, w.scale)
    if w.dtype == torch.int8:
        raise TypeError("an int8 weight comes as a QuantizedTensor (payload "
                        "and per-column scales), not a bare int8 tensor")
    return x @ w


def quantize_tree(params: dict, keys: tuple[str, ...]) -> dict:
    """Quantize the named leaves of a params dict in place, one leaf at a
    time (each dense original is dropped as its int8 copy lands)."""

    def visit(node):
        for name, child in list(node.items()):
            if isinstance(child, dict):
                visit(child)
            elif name in keys and isinstance(child, torch.Tensor):
                node[name] = quantize(child)

    visit(params)
    return params


# ---------------------------------------------------------------------------
# W8A16 panel packing (`fused_dequant`), performed once at weight load.


def _pack_reason(qt: QuantizedTensor) -> str | None:
    from symmetry_tpu_torch.ops.qmm import kernel_supports

    *_, K, N = qt.q.shape
    return None if kernel_supports(K, N) else "untileable"


def _pack_payload(q: torch.Tensor) -> torch.Tensor:
    from symmetry_tpu_torch.ops.qmm import PANEL

    *lead, K, N = q.shape
    return (q.reshape(*lead, K, N // PANEL, PANEL).transpose(-3, -2)
            .contiguous())


def pack_quantized(qt: QuantizedTensor, *, mesh=None, k_axis=None,
                   n_axis=None):
    """Pack one QuantizedTensor into the kernel's panel layout, or return
    it unchanged when the kernel cannot take its shape (the leaf then keeps
    the mixed dot)."""
    if mesh is not None or k_axis is not None or n_axis is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    if _pack_reason(qt) is not None:
        return qt
    return PackedQuantizedTensor(q=_pack_payload(qt.q), scale=qt.scale)


def unpack_quantized(pt: PackedQuantizedTensor) -> QuantizedTensor:
    """Panel layout back to flat [.., K, N]."""
    *lead, n_panels, K, panel = pt.q.shape
    q = pt.q.transpose(-3, -2).reshape(*lead, K, n_panels * panel)
    return QuantizedTensor(q=q.contiguous(), scale=pt.scale)


def pack_tree(params: dict, keys: tuple[str, ...], *, axes: dict | None = None,
              mesh=None, report: list | None = None) -> dict:
    """Pack the named QuantizedTensor leaves of a params dict in place.
    Only 2-D weights and [L, K, N] layer stacks pack; `report`, when given,
    collects (path, reason) for every int8 leaf that stayed flat:
    "expert_stack" (MoE [L, E, K, N]) or "untileable" (a shape the kernel
    cannot take)."""
    if mesh is not None or axes:
        raise NotImplementedError(MESH_NOT_PORTED)

    def note(path, reason):
        if report is not None:
            report.append((path, reason))

    def visit(node, prefix):
        for name, child in list(node.items()):
            if isinstance(child, dict):
                visit(child, prefix + (name,))
            elif name in keys and isinstance(child, QuantizedTensor):
                path = "/".join(prefix + (name,))
                if child.q.ndim not in (2, 3):
                    note(path, "expert_stack")
                    continue
                reason = _pack_reason(child)
                if reason is not None:
                    note(path, reason)
                    continue
                node[name] = PackedQuantizedTensor(
                    q=_pack_payload(child.q), scale=child.scale)

    visit(params, ())
    return params


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8 for KV cache entries.

    x [..., D] -> (q int8 [..., D], scale float32 [...]): one scale per
    leading index (token x kv-head), amax over the head_dim axis."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _div127(torch.clamp_min(amax, 1e-8))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)
