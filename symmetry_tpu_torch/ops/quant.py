"""Weight matmul entry point (symmetry_tpu/ops/quant.py `qmatmul`).

Only the dense branch is ported: a plain matrix product, which the JAX
package also leaves to its compiler outside any Pallas kernel. Int8 weights
(QuantizedTensor and the W8A16 packed layout) arrive with the int8 slice,
ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import torch


def qmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w [in, out]."""
    if not isinstance(w, torch.Tensor) or w.dtype == torch.int8:
        raise NotImplementedError(
            "int8 weights are not ported yet (ROADMAP Queue 1 item 9)")
    return x @ w
