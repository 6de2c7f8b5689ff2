"""The metrics' arithmetic on hand-made timestamps, intervals and shapes."""

import math

import pytest

from portbench.lib import stats, work
from portbench.lib.weights import Dims


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, float("inf")], 95) == float("inf")


def test_spread_is_quartile_distance_over_median():
    vals = [10, 10, 10, 12, 14, 14]
    q1, _, q3 = 10.0, 11.0, 14.0
    assert stats.spread(vals) == pytest.approx((q3 - q1) / 11.0)


def test_token_times_spread_a_block_over_its_interval():
    events = [(1.0, 1), (2.0, 4), (4.0, 2)]
    assert stats.token_times(events) == [1.0, 1.25, 1.5, 1.75, 2.0, 3.0, 4.0]
    assert stats.tokens_in(events, 1.5, 3.5) == 4


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (8, 20)]
    assert stats.union_length(iv, 0, 10) == 3 + 1 + 2
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_flash_counts():
    flops, nbytes = work.flash_prefill([4], heads=2, kv_heads=1, head_dim=8)
    assert flops == 4 * 2 * 8 * 10
    assert nbytes == 4 * 8 * 2 * (2 * 2 + 2 * 1)


def test_decode_attention_counts():
    flops, nbytes = work.decode_attention([10], heads=4, kv_heads=2,
                                          head_dim=8, kv_elem=1,
                                          act_elem=2, scales=True)
    per_pos = 2 * 2 * 8 * 1 + 2 * 2 * 4
    assert flops == 4 * 4 * 8 * 10
    assert nbytes == 10 * per_pos + 2 * 4 * 8 * 2 + 2 * 16 * 2 + per_pos


def test_w8a16_counts():
    assert work.w8a16_product(16, 4096, 1024) == (
        2 * 16 * 4096 * 1024, 4096 * 1024 + 4 * 1024 + 16 * 4096 * 2
        + 16 * 1024 * 2)


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_match_hand_counts():
    mistral = Dims(vocab=32768, hidden=4096, inter=14336, layers=32,
                   heads=32, kv_heads=8, head_dim=128, rope_theta=1e6,
                   eps=1e-5)
    # 6.98 B parameters in the layers' products, 0.134 B in the head
    assert work.matmul_params(mistral, False) == 32 * (
        2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336)
    mixtral = Dims(vocab=32000, hidden=4096, inter=14336, layers=32,
                   heads=32, kv_heads=8, head_dim=128, rope_theta=1e6,
                   eps=1e-5, experts=8, top_k=2)
    active = work.matmul_params(mixtral, True)
    assert active == 32 * (2 * 4096 * 4096 + 2 * 4096 * 1024
                           + 2 * 3 * 4096 * 14336 + 4096 * 8) + 4096 * 32000
    # Mixtral's published 12.9 B active parameters count the embedding
    assert math.isclose((active + 4096 * 32000) / 1e9, 12.9, rel_tol=0.01)
    span = work.span_flops(mistral, 100, 164, True)
    each = sum(work.token_flops(mistral, p, False) for p in range(100, 164))
    assert span == pytest.approx(each + 2 * 4096 * 32768)
