"""The float32 reference against the port's own CPU forward at test sizes.

Only this test imports the port; the reference imports nothing of it. Both
get the same seeded weights (weights.py), the port in its stacked layout,
the reference one layer at a time, drawn again."""

import json
from pathlib import Path

import pytest
import torch

from portbench.lib import reference as R
from portbench.lib import weights as W

DATA = Path(__file__).resolve().parent / "data"


def _port_logits(hf, params, tokens):
    from symmetry_tpu_torch.models.llama import (
        config_from_hf,
        forward_hidden,
        init_cache,
        logits_from_hidden,
    )

    config = config_from_hf(hf)
    cache = init_cache(config, 1, 256, torch.float32, device="cpu")
    h, _ = forward_hidden(params, config, torch.tensor([tokens]), cache,
                          prefill_flash=True)
    return logits_from_hidden(params, config, h)[0]


@pytest.mark.parametrize("name,quant,length", [
    ("tiny", False, 20), ("tiny", False, 100), ("tiny-moe", False, 20),
    ("tiny-moe", False, 80), ("tiny-moe", True, 20), ("tiny-moe", True, 80)])
def test_reference_matches_the_port(name, quant, length):
    from symmetry_tpu_torch.ops.quant import QuantizedTensor

    hf = json.loads((DATA / f"{name}.json").read_text())["model"]
    d = W.Dims.from_hf(hf)
    seed, cpu = 2**33 + 9, torch.device("cpu")
    params = W.program_params(d, seed, quant=quant, dtype=torch.float32,
                              device=cpu, quantized_type=QuantizedTensor)
    tokens = torch.randint(0, d.vocab, (length,),
                           generator=torch.Generator().manual_seed(1))
    tokens = tokens.tolist()
    port = _port_logits(hf, params, tokens)
    R.exact_float32()
    ref = R.logits_at(
        d, [tokens], [list(range(length))],
        lambda li: W.reference_layer(d, seed, li, quant=quant,
                                     dtype=torch.float32, device=cpu),
        W.reference_top(d, seed, quant=quant, dtype=torch.float32,
                        device=cpu), cpu)[0]
    assert torch.allclose(ref, port, atol=1e-4, rtol=1e-4), (
        (ref - port).abs().max())


def test_layer_drawn_again_equals_the_stacked_leaf():
    hf = json.loads((DATA / "tiny-moe.json").read_text())["model"]
    d = W.Dims.from_hf(hf)
    cpu = torch.device("cpu")
    params = W.program_params(d, 7, quant=True, dtype=torch.bfloat16,
                              device=cpu, quantized_type=lambda q, s: (q, s))
    lw = W.reference_layer(d, 7, 1, quant=True, dtype=torch.bfloat16,
                           device=cpu)
    q, s = params["layers"]["wg"]
    assert torch.equal(lw["wg"], q[1].float() * s[1][:, None, :])
    assert torch.equal(lw["router"], params["layers"]["router"][1].float())


def test_lower_precisions_round():
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    for step in ("bfloat16", "int8"):
        low = R.lower_transform(step)("wq", w)
        assert low.shape == w.shape and not torch.equal(low, w)
        assert (low - w).abs().max() < 0.2 * w.abs().max()
    assert torch.equal(R.lower_transform("int8")("router", w), w)
    assert R.int4_columns(w).unique().numel() <= 15 * 32
