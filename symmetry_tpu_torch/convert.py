"""Parameters from the JAX package's tree, as numpy, to this package's dict.

The JAX package's `init_params` / `load_checkpoint` return a nested dict of
arrays; `jax.tree.map(np.asarray, params)` turns it into numpy. Both
packages use the same key names and stacked layout, so the conversion is a
key-by-key copy, and both packages then compute with the same weights.

Int8 leaves are recognised by duck typing, never by importing the JAX
classes: a leaf with `q` and `scale` is a QuantizedTensor when q has one
dim more than scale (flat [.., K, N]), and a JAX PackedQuantizedTensor when
it has three more ([.., K/bk, N/bn, bk, bn] tiles). Packed tiles are
unpacked and repacked into this package's panel layout (ops/quant.py);
a weight the panel kernel cannot take stays flat, as the JAX package keeps
its untileable leaves flat.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from symmetry_tpu_torch.ops.quant import QuantizedTensor, pack_quantized


def _tensor(arr: Any, device, dtype: torch.dtype | None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    elif arr.dtype.kind in "fiub":
        t = torch.from_numpy(np.ascontiguousarray(arr))
    else:
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Any, *, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> Any:
    """Map every array leaf of `tree` (dicts of numpy arrays) to a tensor on
    `device`, cast to `dtype` when given (else the leaf's own dtype;
    bfloat16 leaves, which numpy holds as ml_dtypes, arrive as
    torch.bfloat16). Int8 leaves keep their int8 payload and float32
    scales whatever `dtype` says."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        q, scale = np.asarray(tree.q), np.asarray(tree.scale)
        extra = q.ndim - scale.ndim
        if extra == 3:  # JAX tiles [.., K/bk, N/bn, bk, bn] -> flat [.., K, N]
            *lead, n_kt, n_nt, bk, bn = q.shape
            q = np.swapaxes(q, -3, -2).reshape(*lead, n_kt * bk, n_nt * bn)
            packed = True
        elif extra == 1:
            packed = False
        else:
            raise TypeError(f"int8 leaf with payload {q.shape} and scale "
                            f"{scale.shape} is neither flat nor tiled")
        qt = QuantizedTensor(q=_tensor(q, device, torch.int8),
                             scale=_tensor(scale, device, torch.float32))
        return pack_quantized(qt) if packed else qt
    if isinstance(tree, tuple):
        raise TypeError(f"unsupported tuple leaf {type(tree).__name__}")
    return _tensor(tree, device, dtype)
