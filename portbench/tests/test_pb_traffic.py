"""The traffic generator repeats from the seed, draws the order of sizes
from it, and keeps the set of sizes fixed."""

import json
import math
from collections import Counter
from pathlib import Path

import pytest

from portbench.lib import traffic

BENCH = Path(__file__).resolve().parents[1]
MIXES = sorted((BENCH / "traffic").glob("*.json")) + [
    BENCH / "tests" / "data" / "tiny-mix.json"]


def _draw(mix, seed, vocab=32768, n=6):
    plan = traffic.plan(mix, seed, vocab)
    return [[make() for make in client[:n]] for client in plan]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    mix = json.loads(path.read_text())
    assert _draw(mix, 2**31 + 77) == _draw(mix, 2**31 + 77)
    assert _draw(mix, 2**31 + 77) != _draw(mix, 2**31 + 78)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_seed_draws_the_same_sizes_each_round(path):
    """At every round, the clients' prompt lengths are the whole set of
    quantiles whatever the seed, and so are their output lengths; the
    seed draws who gets which, and when."""
    mix = json.loads(path.read_text())
    g = mix["grid_points"]
    assert mix["clients"] % g == 0
    pre = mix["prefix_tokens"] if mix["shared_prefixes"] else 0
    times = mix["clients"] // g

    def rounds(seed):
        reqs = _draw(mix, seed, n=3)
        return [(sorted(len(c[k][0]) for c in reqs),
                 sorted(c[k][1] for c in reqs)) for k in range(3)]

    want = (sorted(n + pre for n in traffic.quantiles(
                mix["prompt_tokens"], g) * times),
            sorted(traffic.quantiles(mix["output_tokens"], g) * times))
    orders = set()
    for seed in (1, 999_999_999_999, 2**31 + 5):
        for prompts, outputs in rounds(seed):
            assert (prompts, outputs) == want
        orders.add(tuple(m for _, m in _draw(mix, seed, n=1)[0]))
        orders.add(tuple(c[0][1] for c in _draw(mix, seed, n=1)))
    assert len(orders) > 1


def test_quantiles_of_a_log_normal():
    """Midpoint quantiles of a log-normal: symmetric in the log about the
    median, mean exp(mu + sigma^2 / 2) = the given mean, clipped."""
    dist = {"mean": 100.0, "sigma": 1.0, "min": 1, "max": 10**6}
    q = traffic.quantiles(dist, 2)
    median = 100.0 * math.exp(-0.5)
    lo, hi = median * math.exp(-0.6745), median * math.exp(0.6745)
    assert q == [round(lo), round(hi)]
    many = traffic.quantiles(dist, 4000)
    assert abs(sum(many) / len(many) - 100.0) < 1.5
    assert traffic.quantiles(dict(dist, min=40, max=70), 2) == [40, 70]
    assert traffic.quantiles(dict(dist, sigma=0.0), 3) == [100] * 3


def test_shared_prefixes_are_shared_and_cycled():
    mix = json.loads((BENCH / "tests" / "data" / "tiny-mix.json")
                     .read_text())
    reqs = [r for client in _draw(mix, 3, n=8) for r in client]
    heads = Counter(tuple(p[:mix["prefix_tokens"]]) for p, _ in reqs)
    assert len(heads) == mix["shared_prefixes"]
    own = [tuple(p[mix["prefix_tokens"]:]) for p, _ in reqs]
    assert len(set(own)) == len(own)


def test_validate_refuses_what_is_no_mix():
    mix = json.loads(MIXES[0].read_text())
    with pytest.raises(ValueError):
        traffic.validate({"clients": 1})
    with pytest.raises(ValueError):
        traffic.validate(dict(mix, prompt_tokens=[16, 1024]))
    with pytest.raises(ValueError):
        traffic.validate(dict(mix, output_tokens=dict(
            mix["output_tokens"], min=0)))
