"""Parameters from the JAX package's tree, as numpy, to this package's dict.

The JAX package's `init_params` / `load_checkpoint` return a nested dict of
arrays; `jax.tree.map(np.asarray, params)` turns it into numpy. Both
packages use the same key names and stacked layout, so the conversion is a
key-by-key copy, and both packages then compute with the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, *, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> Any:
    """Map every array leaf of `tree` (dicts of numpy arrays) to a tensor on
    `device`, cast to `dtype` when given (else the leaf's own dtype;
    bfloat16 leaves, which numpy holds as ml_dtypes, arrive as
    torch.bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        raise TypeError("int8 weight leaves (QuantizedTensor) are not ported "
                        "yet (ROADMAP Queue 1 item 9)")
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    elif arr.dtype.kind in "fiub":
        t = torch.from_numpy(np.ascontiguousarray(arr))
    else:
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return t.to(device=device, dtype=dtype or t.dtype)
