"""How `correct` is decided: served tokens against the float32 reference.

Once the window has closed, the requests in flight have run on (no new one
sent) until `check_requests` have finished or the drain's time is up, and
the program is freed, a sample of the requests it finished, in the ramp,
the window or the drain, drawn from the seed and holding the longest, is run
once through the reference (reference.py) over each prompt with its served
tokens. Every served token was the program's greedy choice, so its logit
should be the reference's best up to rounding: the gap by which its logit
lies below the reference's best logit at its position measures how far it
is off. A request that failed, or ended short of its token budget, is
wrong outright.

The numbers compared are those the configuration's `check` names: the
widest gap over every served token of the sample, the mean gap, or the
share of served tokens more than t below the best (`share_gap_over_<t>`). A
configuration compares those that its control separates from its sound
runs (PERF.md).

The control is the reference computed in the next precision below the
configuration's, put in the program's place: at the same positions of the
same prompts and tokens, the token it puts first is judged by the same
numbers and limits (control_checks), and has to come out not correct. The
benchmark's own runs never run it (calibrate.py and the tests do).
"""

from __future__ import annotations

import random

import torch

from portbench.lib import reference as R
from portbench.lib import weights as W


def sample(done: list, seed: int, n: int) -> list:
    """n finished requests drawn from the seed, the longest among them."""
    if not done:
        return []
    ordered = sorted(done, key=lambda r: (r.client, r.index))
    longest = max(ordered, key=lambda r: len(r.prompt) + len(r.tokens))
    rest = [r for r in ordered if r is not longest]
    random.Random(seed).shuffle(rest)
    return [longest] + rest[:n - 1]


def _weights(cfg_file: dict):
    dep = cfg_file["deployment"]
    quant = dep.get("quantization") == "int8"
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float16": torch.float16}[dep.get("dtype", "bfloat16")]
    return W.Dims.from_hf(cfg_file["model"]), quant, dtype


def stated_precision(cfg_file: dict) -> str:
    """The weights' precision the configuration states."""
    dep = cfg_file["deployment"]
    if dep.get("quantization") == "int8":
        return "int8"
    return dep.get("dtype", "bfloat16")


def lower(cfg_file: dict):
    """The control's weight transform for this configuration."""
    return R.lower_transform(stated_precision(cfg_file))


def logits(cfg_file: dict, seed: int, recs: list, device: torch.device,
           transform=None) -> list[torch.Tensor]:
    """Reference logits at each served token's position, per request."""
    d, quant, dtype = _weights(cfg_file)
    R.exact_float32()
    top = W.reference_top(d, seed, quant=quant, dtype=dtype, device=device,
                          transform=transform)
    seqs = [r.prompt + r.tokens[:-1] for r in recs]
    pos = [list(range(len(r.prompt) - 1, len(r.prompt) + len(r.tokens) - 1))
           for r in recs]
    with torch.no_grad():
        return R.logits_at(
            d, seqs, pos,
            lambda li: W.reference_layer(d, seed, li, quant=quant,
                                         dtype=dtype, device=device,
                                         transform=transform),
            top, device)


def _gaps(ref: list[torch.Tensor], picks: list[torch.Tensor]
          ) -> torch.Tensor:
    """(best logit - picked token's logit) in the reference, at every
    position of every request."""
    return torch.cat([lg.max(-1).values - lg.gather(1, p[:, None])[:, 0]
                      for lg, p in zip(ref, picks)])


# The numbers a configuration may compare (its `check` keys), and the
# gap_stats entry each reads; and `share_gap_over_<t>`, the share of served
# tokens more than t below the best.
COMPARED = {"max_logit_gap": "max", "mean_logit_gap": "mean"}
SHARE = "share_gap_over_"


def thresholds(limits: dict) -> list[float]:
    return [float(k[len(SHARE):]) for k in limits if k.startswith(SHARE)]


def gap_stats(ref: list[torch.Tensor], picks: list[torch.Tensor],
              over: list[float] = ()) -> dict:
    """The gap's distribution over every position: widest, mean, and the
    share of positions more than t below the best, for each t of `over`."""
    g = _gaps(ref, picks)
    out = {"max": float(g.max()), "mean": float(g.mean())}
    for t in over:
        out[f"{SHARE}{t:g}"] = float((g > t).float().mean())
    return out


def checks(limits: dict, gaps: dict | None, n_failed: int, n_short: int,
           n_checked: int) -> dict:
    """Each number `correct` compares, beside its limit: the gaps the
    configuration's `check` names (no gaps: no finished request to check,
    which fails), failed and short requests, and the served tokens
    checked."""
    keys = dict(COMPARED, **{f"{SHARE}{t:g}": f"{SHARE}{t:g}"
                             for t in thresholds(limits)})
    out = {
        name: {"value": gaps[key] if gaps is not None else float("inf"),
               "limit": float(limits[name]), "bound": "max"}
        for name, key in keys.items() if name in limits}
    out.update({
        "failed_requests": {"value": n_failed, "limit": 0, "bound": "max"},
        "short_requests": {"value": n_short, "limit": 0, "bound": "max"},
        "served_tokens_checked": {
            "value": n_checked, "limit": int(limits["min_served_tokens"]),
            "bound": "min"},
    })
    return out


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["bound"] == "max"
               else c["value"] >= c["limit"] for c in checks.values())


def control_checks(cfg_file: dict, seed: int, picked: list,
                   ref: list[torch.Tensor], device: torch.device
                   ) -> tuple[dict, dict]:
    """The control in the program's place: the reference one precision
    below the configuration's (lower()) puts its first token at each
    position of the same prompts and served tokens, and that token is
    judged against `ref` as the program's are, by checks(). Returns its
    gap_stats and its checks."""
    low = logits(cfg_file, seed, picked, device,
                 transform=lower(cfg_file))
    gaps = gap_stats(ref, [lw.argmax(-1) for lw in low],
                     thresholds(cfg_file["check"]))
    return gaps, checks(cfg_file["check"], gaps, 0, 0,
                        sum(len(r.tokens) for r in picked))
