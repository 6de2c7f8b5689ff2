"""moe_expert_roofline.tok on a synthetic trace: the share of the grouped
expert GEMV's roofline, None without its operations; and the W8A16 GEMV's
and decode attention's readers unmoved by them."""

from types import SimpleNamespace

import pytest

from portbench.lib import harness, work
from portbench.lib.trace import DeviceOp, Trace
from portbench.lib.weights import Dims

MIXTRAL = Dims(vocab=32000, hidden=4096, inter=14336, layers=32, heads=32,
               kv_heads=8, head_dim=128, rope_theta=1e6, eps=1e-5,
               experts=8, top_k=2)
MOE = "void symtorch::mg::moe_gemv_tc_kernel<8, __nv_bfloat16>(...)"
OTHERS = [("void symtorch::gv::w8a16_gemv_tc_kernel<8, float>(...)", 2e6),
          ("decode_split_kernel<int8>", 5e5), ("decode_combine", 1e5),
          ("sgemm_largek", 3e6)]


def _ctx(moe_ns: float, steps=(16, 16)):
    """Two decode calls inside the traced stretch, one outside it; each
    call launched the operations named above and, given a time, the
    grouped GEMV's, for that many ns in each call."""
    ops, ranges, t = [], {}, 1000
    for i, n in enumerate(steps):
        ranges[i] = ("decode", t, t + 10**8)
        for name, ns in OTHERS + ([(MOE, moe_ns)] if moe_ns else []):
            ops.append(DeviceOp(name, t, t + int(ns), call=i))
        t += 2 * 10**8
    ranges[9] = ("decode", t + 10**9, t + 2 * 10**9)  # outside the window
    ops.append(DeviceOp(MOE, t + 10**9, t + 2 * 10**9, call=9))
    trace = Trace(window=(0, t), ops=ops, ranges=ranges)
    calls = {i: SimpleNamespace(meta={"steps": n})
             for i, n in enumerate(steps)}
    calls[9] = SimpleNamespace(meta={"steps": 16})
    return SimpleNamespace(dims=MIXTRAL, deployment={"dtype": "bfloat16"},
                           trace=trace, calls_by_index=calls,
                           lengths={0: [100] * 8, 1: [116] * 8})


def test_share_of_the_roofline():
    read = harness.reader("moe_expert_roofline.tok")
    ctx = _ctx(moe_ns=16 * 15e6)  # 15 ms a step
    per_expert = [work.w8a16_product(8, 4096, 14336)] * 2 + [
        work.w8a16_product(8, 14336, 4096)]
    nbytes = 32 * 32 * 8 * sum(b for _, b in per_expert)
    # bytes bound: 45.1 GB of expert stacks a step at 3.35 TB/s
    assert nbytes / 32 == pytest.approx(45.10e9, rel=0.01)
    want = 100 * (nbytes / work.PEAK_BYTES) / (2 * 16 * 15e-3)
    assert read(ctx) == pytest.approx(want)
    assert 89 < read(ctx) < 91


def test_none_without_the_kernel():
    assert harness.reader("moe_expert_roofline.tok")(_ctx(moe_ns=0)) is None


@pytest.mark.parametrize("name", ["w8a16_gemv_roofline.tok",
                                  "decode_attention_roofline.tok"])
def test_other_rooflines_ignore_the_kernel(name):
    read = harness.reader(name)
    without, with_moe = read(_ctx(moe_ns=0)), read(_ctx(moe_ns=16 * 15e6))
    assert without is not None and without == with_moe
