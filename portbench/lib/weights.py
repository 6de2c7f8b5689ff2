"""Seeded model weights: the same seed gives the same tensors, every time.

Both sides of the comparison read the weights from here, and neither takes
them from the other. The program gets the whole tree at once in its stacked
layout; the reference draws one layer at a time again from the same seed,
after the program has been freed, so it never needs the program's memory.

Every (leaf, layer) pair has a generator of its own, seeded from
(run seed, leaf, layer), so any one layer can be drawn again alone. A slab
is always drawn by the same call with the same shape, whichever side asks,
and then copied into place: the random stream does not depend on where the
result lands.

Dense leaves are normal draws scaled by 1 / sqrt(fan-in) (0.02 for the
embedding and the LM head); norm scales are uniform in [0.8, 1.2]. An int8
leaf is what a quantized checkpoint ships: int8 payloads uniform in
[-127, 127] and one float32 scale per output column, uniform within 25% of
the scale that gives the dense leaf's standard deviation. The weight is
payload x scale.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch

# Leaves held as int8 payloads and scales when the configuration states int8
# weights: every large product. The embedding is gathered, not multiplied,
# and the router is small; both stay in the configuration's dtype.
QUANT_LEAVES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "lm_head")
# Standard deviation of a payload uniform over [-127, 127].
_Q_STD = 127 / math.sqrt(3.0)


@dataclass(frozen=True)
class Dims:
    """The model's shape, read from a published config.json's keys."""

    vocab: int
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    tie: bool = False

    @classmethod
    def from_hf(cls, hf: dict) -> "Dims":
        heads = hf["num_attention_heads"]
        return cls(
            vocab=hf["vocab_size"], hidden=hf["hidden_size"],
            inter=hf["intermediate_size"], layers=hf["num_hidden_layers"],
            heads=heads,
            kv_heads=hf.get("num_key_value_heads", heads),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            eps=float(hf.get("rms_norm_eps", 1e-5)),
            experts=int(hf.get("num_local_experts") or 0),
            top_k=int(hf.get("num_experts_per_tok") or 0),
            tie=bool(hf.get("tie_word_embeddings", False)))

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def layer_shapes(d: Dims) -> dict[str, tuple[int, ...]]:
    """One layer's leaves, as (contraction, output) for a product."""
    shapes = {"attn_norm": (d.hidden,), "mlp_norm": (d.hidden,),
              "wq": (d.hidden, d.q_dim), "wk": (d.hidden, d.kv_dim),
              "wv": (d.hidden, d.kv_dim), "wo": (d.q_dim, d.hidden)}
    if d.experts:
        shapes.update(wg=(d.experts, d.hidden, d.inter),
                      wu=(d.experts, d.hidden, d.inter),
                      wd=(d.experts, d.inter, d.hidden),
                      router=(d.hidden, d.experts))
    else:
        shapes.update(wg=(d.hidden, d.inter), wu=(d.hidden, d.inter),
                      wd=(d.inter, d.hidden))
    return shapes


def top_shapes(d: Dims) -> dict[str, tuple[int, ...]]:
    shapes = {"embed": (d.vocab, d.hidden), "final_norm": (d.hidden,)}
    if not d.tie:
        shapes["lm_head"] = (d.hidden, d.vocab)
    return shapes


def _generator(seed: int, name: str, layer: int,
               device: torch.device) -> torch.Generator:
    digest = hashlib.sha256(f"portbench/{seed}/{name}/{layer}".encode())
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest.digest()[:8], "little") >> 1)


def _std(name: str, shape: tuple[int, ...]) -> float:
    if name in ("embed", "lm_head"):
        return 0.02
    return shape[-2] ** -0.5


def draw(seed: int, name: str, layer: int, shape: tuple[int, ...], *,
         quant: bool, dtype: torch.dtype, device: torch.device):
    """One slab: a dense tensor in `dtype`, or (int8 payload, float32
    scales) where `quant` and the leaf is one of QUANT_LEAVES."""
    g = _generator(seed, name, layer, device)
    if name.endswith("norm"):
        w = torch.rand(shape, generator=g, dtype=torch.float32,
                       device=device)
        return w.mul_(0.4).add_(0.8).to(dtype)
    std = _std(name, shape)
    if quant and name in QUANT_LEAVES:
        q = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8,
                          device=device)
        scale = torch.rand((*shape[:-2], shape[-1]), generator=g,
                           dtype=torch.float32, device=device)
        scale.mul_(0.5).add_(0.75).mul_(std / _Q_STD)
        return q, scale
    return torch.randn(shape, generator=g, dtype=dtype,
                       device=device).mul_(std)


def program_params(d: Dims, seed: int, *, quant: bool, dtype: torch.dtype,
                   device: torch.device, quantized_type=None) -> dict:
    """The whole tree in the port's stacked layout ([L, ...] per layer
    leaf). `quantized_type(q, scale)` wraps an int8 leaf (the port's
    QuantizedTensor); the caller passes it, so this module imports nothing
    of the program."""
    params: dict = {"layers": {}}
    for name, shape in layer_shapes(d).items():
        q8 = quant and name in QUANT_LEAVES
        if q8:
            q = torch.empty((d.layers, *shape), dtype=torch.int8,
                            device=device)
            s = torch.empty((d.layers, *shape[:-2], shape[-1]),
                            dtype=torch.float32, device=device)
        else:
            w = torch.empty((d.layers, *shape), dtype=dtype, device=device)
        for layer in range(d.layers):
            slab = draw(seed, name, layer, shape, quant=quant, dtype=dtype,
                        device=device)
            if q8:
                q[layer].copy_(slab[0])
                s[layer].copy_(slab[1])
            else:
                w[layer].copy_(slab)
            del slab
        params["layers"][name] = quantized_type(q, s) if q8 else w
    for name, shape in top_shapes(d).items():
        slab = draw(seed, name, -1, shape, quant=quant, dtype=dtype,
                    device=device)
        params[name] = (quantized_type(*slab) if isinstance(slab, tuple)
                        else slab)
    return params


def as_float(slab) -> torch.Tensor:
    """A slab as float32: payload x per-column scale for an int8 one."""
    if isinstance(slab, tuple):
        q, scale = slab
        return q.to(torch.float32) * scale.unsqueeze(-2)
    return slab.to(torch.float32)


def reference_layer(d: Dims, seed: int, layer: int, *, quant: bool,
                    dtype: torch.dtype, device: torch.device,
                    transform=None) -> dict[str, torch.Tensor]:
    """Layer `layer`'s leaves drawn again from the seed, as float32.
    `transform(name, w)` may replace a product's weight (the control's
    lower precision)."""
    out = {}
    for name, shape in layer_shapes(d).items():
        w = as_float(draw(seed, name, layer, shape, quant=quant, dtype=dtype,
                          device=device))
        if transform is not None and not name.endswith("norm"):
            w = transform(name, w)
        out[name] = w
    return out


def reference_top(d: Dims, seed: int, *, quant: bool, dtype: torch.dtype,
                  device: torch.device, transform=None
                  ) -> dict[str, torch.Tensor]:
    out = {}
    for name, shape in top_shapes(d).items():
        w = as_float(draw(seed, name, -1, shape, quant=quant, dtype=dtype,
                          device=device))
        if transform is not None and name == "lm_head":
            w = transform(name, w)
        out[name] = w
    return out
