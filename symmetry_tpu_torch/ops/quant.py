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

On a mesh (parallel/), each rank packs its own block of a leaf, and the
packed leaf names the mesh axes its contraction and output dims are
sharded over, as the JAX package's does; qmatmul then routes it through
ops/qmm.py w8a16_apply_sharded. Only the `model` axis shards a packed leaf
(ROADMAP Queue 1 item 14 brings the others).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class QuantizedTensor(NamedTuple):
    q: torch.Tensor      # int8, same shape as the dense weight [.., K, N]
    scale: torch.Tensor  # float32, weight shape minus the contraction dim


class _Packed(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor


class PackedQuantizedTensor(_Packed):
    """Int8 weight in the W8A16 kernel's layout (ops/qmm.py).

    q is [.., N / PANEL, K, PANEL] int8 (PANEL = 64 output columns): the
    flat [.., K, N] payload cut into column panels, each panel one
    contiguous run of K rows of 64 bytes. A kernel block owns one panel and
    streams it front to back, so every weight byte is read once, by 8-byte
    loads of neighbouring threads, with no strided gather. (The JAX
    package's [K/bk, N/bn, bk, bn] tiles are a TPU DMA choice.) scale stays
    the flat per-output-channel [.., N] float32. Packing moves bytes only:
    unpack_quantized gives back the flat leaf bit for bit.

    Mesh-aware, as the JAX package's: `k_axis`/`n_axis` name the mesh axes
    the contraction/output dims are sharded over (None = replicated) and
    `mesh` is this rank's Mesh; q and scale then hold this rank's block.
    They are attributes, not tuple fields: the leaf iterates as its two
    tensors, and `_replace` keeps them."""

    def __new__(cls, q: torch.Tensor, scale: torch.Tensor, *,
                k_axis: str | None = None, n_axis: str | None = None,
                mesh: Any = None) -> "PackedQuantizedTensor":
        self = super().__new__(cls, q, scale)
        self.k_axis = k_axis
        self.n_axis = n_axis
        self.mesh = mesh
        return self

    def _replace(self, **tensors) -> "PackedQuantizedTensor":
        return PackedQuantizedTensor(
            tensors.get("q", self.q), tensors.get("scale", self.scale),
            k_axis=self.k_axis, n_axis=self.n_axis, mesh=self.mesh)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 by IEEE division. PyTorch divides by a Python (or 0-d)
    scalar as a multiply by the scalar's reciprocal, which is one ULP off
    for some x; an elementwise divisor divides for real, as the kernels and
    XLA do."""
    return x / torch.full_like(x, 127.0)


def quantize(w: torch.Tensor, *, contract_axis: int = -2,
             amax_reduce=None) -> QuantizedTensor:
    """Quantize a dense weight along its contraction (input) axis, with the
    arithmetic of the JAX package's `quantize_jit` (what its
    quantize_params and int8 init run): under jit XLA folds the division
    of amax by 127 into a multiply by float32(1 / 127), so the scale is
    computed so here, and payloads and scales are bit-equal to its.

    `amax_reduce` maps the per-column amax of this block before the scale
    is taken: a rank holding one K-slice of a row-parallel leaf passes the
    max over the mesh axis, so its scales and payload equal the full
    leaf's, sliced."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
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
        from symmetry_tpu_torch.ops.qmm import (w8a16_apply,
                                                w8a16_apply_sharded)

        if w.mesh is not None:
            return w8a16_apply_sharded(x, w)
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


def _pack_payload(q: torch.Tensor) -> torch.Tensor:
    from symmetry_tpu_torch.ops.qmm import PANEL

    *lead, K, N = q.shape
    return (q.reshape(*lead, K, N // PANEL, PANEL).transpose(-3, -2)
            .contiguous())


def _axis_size(mesh, axis: str | None) -> int:
    return 1 if mesh is None or axis is None else mesh.axis_size(axis)


def pack_reason(k: int, n: int, k_parts: int = 1, n_parts: int = 1
                ) -> str | None:
    """Why a full [k, n] int8 leaf cut into k_parts x n_parts blocks stays
    flat, as the JAX package names it, or None when it packs:
    "shard_indivisible" (the mesh axes do not divide k or n),
    "shard_untileable" (a block the kernel cannot take, on a mesh) or
    "untileable" (the same on one device)."""
    from symmetry_tpu_torch.ops.qmm import kernel_supports

    if k % k_parts or n % n_parts:
        return "shard_indivisible"
    if kernel_supports(k // k_parts, n // n_parts):
        return None
    return "shard_untileable" if k_parts * n_parts > 1 else "untileable"


def _pack_quantized_report(qt: QuantizedTensor, *, k_axis: str | None = None,
                           n_axis: str | None = None, mesh=None) -> tuple:
    """pack_quantized plus the degrade reason: (leaf, reason), reason None
    when the leaf packed. `qt` is this rank's block; the full leaf is it
    times the axes' sizes."""
    for axis in (k_axis, n_axis):
        if axis not in (None, "model") and _axis_size(mesh, axis) > 1:
            raise NotImplementedError(
                f"packing over mesh axis {axis!r} is not ported yet "
                f"(ROADMAP Queue 1 item 14)")
    # A mesh axis of size 1 shards nothing: the leaf keeps the plain
    # single-device dispatch.
    k_axis = k_axis if _axis_size(mesh, k_axis) > 1 else None
    n_axis = n_axis if _axis_size(mesh, n_axis) > 1 else None
    if k_axis is None and n_axis is None:
        mesh = None
    k_parts, n_parts = _axis_size(mesh, k_axis), _axis_size(mesh, n_axis)
    *_, K, N = qt.q.shape
    reason = pack_reason(K * k_parts, N * n_parts, k_parts, n_parts)
    if reason is not None:
        return qt, reason
    return PackedQuantizedTensor(_pack_payload(qt.q), qt.scale,
                                 k_axis=k_axis, n_axis=n_axis,
                                 mesh=mesh), None


def pack_quantized(qt: QuantizedTensor, *, mesh=None, k_axis=None,
                   n_axis=None):
    """Pack one QuantizedTensor (this rank's block on a mesh) into the
    kernel's panel layout, or return it unchanged when the kernel cannot
    take its shape (the leaf then keeps the mixed dot)."""
    return _pack_quantized_report(qt, k_axis=k_axis, n_axis=n_axis,
                                  mesh=mesh)[0]


def unpack_quantized(pt: PackedQuantizedTensor) -> QuantizedTensor:
    """Panel layout back to flat [.., K, N]."""
    *lead, n_panels, K, panel = pt.q.shape
    q = pt.q.transpose(-3, -2).reshape(*lead, K, n_panels * panel)
    return QuantizedTensor(q=q.contiguous(), scale=pt.scale)


def pack_tree(params: dict, keys: tuple[str, ...], *, axes: dict | None = None,
              mesh=None, report: list | None = None) -> dict:
    """Pack the named QuantizedTensor leaves of a params dict in place.
    Only 2-D weights and [L, K, N] layer stacks pack; `axes` maps a leaf
    name to its (k_axis, n_axis) on `mesh` (models/llama.py
    packed_shard_axes). `report`, when given, collects (path, reason) for
    every int8 leaf that stayed flat: "expert_stack" (MoE [L, E, K, N]) or
    a pack_reason."""

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
                k_axis, n_axis = (axes or {}).get(name, (None, None))
                node[name], reason = _pack_quantized_report(
                    child, k_axis=k_axis, n_axis=n_axis, mesh=mesh)
                if reason is not None:
                    note(path, reason)

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
