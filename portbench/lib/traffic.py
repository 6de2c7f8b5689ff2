"""The one traffic generator: a mix is a data file of parameters, read here.

A mix file (`traffic/<name>.json`) holds:

  source               where its length distributions come from
  clients              closed-loop clients, each sending its next request
                       when its last one ends
  prompt_tokens        a request's own prompt tokens, as a log-normal
                       distribution: {"mean", "sigma", "min", "max"}
  output_tokens        its token budget (no end-of-sequence id ends a
                       request early), the same way
  shared_prefixes      how many shared prefixes (0: none)
  prefix_tokens        the length of each shared prefix, put before the
                       request's own prompt tokens
  grid_points          sizes drawn from each distribution (below)
  requests_per_client  the length of each client's plan
  check_requests       finished requests the correctness check samples
  trace_seconds        the traced stretch of the window (`--trace 1`)

Lengths are heavy-tailed, as in served traffic: log-normal with the given
mean and shape `sigma` (of the log), clipped to [min, max]. Each
distribution is drawn as `grid_points` quantiles, at the midpoints of
equal-probability bins, so every seed serves the same set of sizes, in an
order the seed draws. Client c's k-th request takes the (c + k)-th value of
that order (a Latin square): at every round of requests the clients hold
the whole set, whatever the seed. The prefix a request uses cycles the same
way. Token ids are drawn from the seed, uniform over the vocabulary, when
the request is sent.
"""

from __future__ import annotations

import hashlib
import math
from statistics import NormalDist

import numpy as np

KEYS = ("source", "clients", "prompt_tokens", "output_tokens",
        "shared_prefixes", "prefix_tokens", "grid_points",
        "requests_per_client", "check_requests", "trace_seconds")
DIST_KEYS = ("mean", "sigma", "min", "max")


def _rng(seed: int, *parts) -> np.random.Generator:
    digest = hashlib.sha256("/".join(map(str, (seed, *parts))).encode())
    return np.random.default_rng(
        int.from_bytes(digest.digest()[:16], "little"))


def quantiles(dist: dict, n: int) -> list[int]:
    """n sizes of a log-normal distribution of the given mean and sigma:
    its quantiles at the midpoints of n equal-probability bins, rounded and
    clipped to [min, max]."""
    sigma = float(dist["sigma"])
    median = dist["mean"] * math.exp(-sigma * sigma / 2)
    unit = NormalDist()
    return [int(min(dist["max"], max(dist["min"], round(
        median * math.exp(sigma * unit.inv_cdf((i + 0.5) / n))))))
        for i in range(n)]


def validate(mix: dict) -> dict:
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    for key in ("prompt_tokens", "output_tokens"):
        dist = mix[key]
        if not isinstance(dist, dict) or set(dist) != set(DIST_KEYS):
            raise ValueError(f"traffic {key} takes exactly {DIST_KEYS}")
        if not (1 <= dist["min"] <= dist["max"] and dist["mean"] > 0
                and dist["sigma"] >= 0):
            raise ValueError(f"traffic {key} {dist} is not a distribution")
    return mix


def plan(mix: dict, seed: int, vocab: int) -> list[list]:
    """plan[c][i]() -> (prompt ids, max new tokens) of client c's i-th
    request. Each maker draws its ids when called, so a long plan costs
    nothing until it is used."""
    validate(mix)
    n = mix["requests_per_client"]
    g = mix["grid_points"]
    n_pre = mix["shared_prefixes"]
    prefixes = [_rng(seed, "prefix", p).integers(
        0, vocab, mix["prefix_tokens"]).tolist() for p in range(n_pre)]
    order = _rng(seed, "order")
    prompt_grid = order.permutation(quantiles(mix["prompt_tokens"], g))
    output_grid = order.permutation(quantiles(mix["output_tokens"], g))
    pre_order = order.permutation(n_pre).tolist() if n_pre else []
    out = []
    for c in range(mix["clients"]):
        prompts = [int(prompt_grid[(c + k) % g]) for k in range(n)]
        outputs = [int(output_grid[(c + k) % g]) for k in range(n)]
        which = ([pre_order[(c + k) % n_pre] for k in range(n)]
                 if n_pre else [None] * n)

        def maker(i, body=prompts, budget=outputs, pre=which, c=c):
            def make():
                own = _rng(seed, "prompt", c, i).integers(
                    0, vocab, body[i]).tolist()
                head = prefixes[pre[i]] if pre[i] is not None else []
                return head + own, budget[i]
            return make

        out.append([maker(i) for i in range(n)])
    return out
