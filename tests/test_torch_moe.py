"""The mixtral family in the PyTorch port against the JAX package (CPU,
float32 unless named).

Weights are drawn from a numpy seed in the JAX package's layout, each
matmul weight scaled by 1/sqrt(fan-in) so activations stay O(1), and go to
both packages (`params_from_numpy` for the port). Tolerances:

- routing gates at atol 1e-6 (float32 and bf16), top-k indices equal to
  `jax.lax.top_k`'s, ties included;
- expert products and the mixtures at atol 1e-5: float32 sums over at
  most 128 terms of O(1) values; the dispatch at no-drop capacity against
  the dense mixture at 2e-4, as tests/test_moe.py holds it;
- model logits at 1e-4, the port's ATOL (tests/test_torch_model.py);
- greedy tokens through each package's Scheduler identical;
- checkpoints, warm caches and int8 trees bit-equal.

The JAX prefill runs flash in interpret mode, as the other parity tests
run it.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.engine import weights as jax_weights
from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.engine import SamplingParams as JaxSampling
from symmetry_tpu.engine.scheduler import GenRequest as JaxRequest
from symmetry_tpu.engine.scheduler import Scheduler as JaxScheduler
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu.models import forward as jax_forward
from symmetry_tpu.models import init_cache as jax_init_cache
from symmetry_tpu.models import llama as jax_llama
from symmetry_tpu.models import moe as jax_moe
from symmetry_tpu.models.llama import forward_hidden as jax_forward_hidden
from symmetry_tpu.models.llama import logits_from_hidden as jax_logits
from symmetry_tpu.ops import quant as jax_quant
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine import weights
from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models import llama, moe
from symmetry_tpu_torch.ops.quant import (
    PackedQuantizedTensor,
    QuantizedTensor,
    quantize,
)

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = llama.preset("tiny-moe")
JCFG = jax_llama.preset("tiny-moe")
NO_DROP = CFG.num_experts / CFG.num_experts_per_tok


def moe_tree(cfg=JCFG, seed=0) -> dict:
    """A `tiny-moe`-shaped params tree of numpy float32 arrays in the JAX
    layout: 1/sqrt(fan-in) matmul weights, norms perturbed around 1."""
    rng = np.random.default_rng(seed)
    L, E, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    X, V = cfg.num_experts, cfg.vocab_size

    def w(*shape):
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(np.float32)

    def norm(*shape):
        return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)

    return {
        "embed": rng.normal(size=(V, E)).astype(np.float32),
        "layers": {
            "attn_norm": norm(L, E), "mlp_norm": norm(L, E),
            "wq": w(L, E, cfg.q_dim), "wk": w(L, E, cfg.kv_dim),
            "wv": w(L, E, cfg.kv_dim), "wo": w(L, cfg.q_dim, E),
            "wg": w(L, X, E, F), "wu": w(L, X, E, F), "wd": w(L, X, F, E),
            "router": w(L, E, X),
        },
        "final_norm": norm(E),
        "lm_head": w(E, V),
    }


def both(tree):
    """(JAX params, the port's params) over the same numpy tree."""
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree,
                                                              device="cpu")


def jax_int8(tree):
    """JAX quantize_params over the tree, as numpy (flat int8 leaves)."""
    q = jax_llama.quantize_params(jax.tree.map(jnp.asarray, tree))
    return jax.tree.map(np.asarray, q)


def j_leaf(v):
    if hasattr(v, "q"):
        return jax_quant.QuantizedTensor(jnp.asarray(v.q),
                                         jnp.asarray(v.scale))
    return jnp.asarray(v)


def j_layer0(tree):
    out = {}
    for k, v in tree["layers"].items():
        out[k] = (jax_quant.QuantizedTensor(jnp.asarray(v.q[0]),
                                            jnp.asarray(v.scale[0]))
                  if hasattr(v, "q") else jnp.asarray(v[0]))
    return out


def t_layer0(params):
    return {k: llama.layer_slice(v, 0) for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# Routing


class TestRouting:
    def test_random_logits(self):
        logits = np.random.default_rng(0).normal(size=(2, 3, 8)).astype(
            np.float32)
        want = np.asarray(jax_moe.route_top_k(jnp.asarray(logits), 2))
        got = moe.route_top_k(torch.from_numpy(logits), 2).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert ((got > 0).sum(-1) == 2).all()

    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_ties_select_as_lax_top_k(self, k):
        """torch.topk picks [4, 7] among the tied 3s of this row; JAX takes
        the lowest indices, [1, 2], and so does the port."""
        rows = [[1, 3, 3, 0.5, 3, -1, 2, 3]]
        rng = np.random.default_rng(1)
        rows += rng.integers(-2, 3, size=(63, 8)).tolist()  # dense ties
        logits = np.asarray(rows, np.float32)
        _, jidx = jax.lax.top_k(jnp.asarray(logits), k)
        _, idx = moe.top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        if k == 2:
            assert idx[0].tolist() == [1, 2]
            assert torch.topk(torch.from_numpy(logits[:1]), 2)[1][0].tolist() \
                != [1, 2]
        # gates over [B, S, X] logits
        want = np.asarray(jax_moe.route_top_k(jnp.asarray(logits[None]), k))
        got = moe.route_top_k(torch.from_numpy(logits[None]), k).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    def test_bf16_logits(self):
        logits = np.random.default_rng(2).normal(size=(4, 16, 8)).astype(
            np.float32)
        jl = jnp.asarray(logits, jnp.bfloat16)
        tl = torch.from_numpy(logits).to(torch.bfloat16)
        want = np.asarray(jax_moe.route_top_k(jl, 2).astype(jnp.float32))
        got = moe.route_top_k(tl, 2)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                                   rtol=0)


# ---------------------------------------------------------------------------
# Expert products and the two mixtures


@pytest.fixture(scope="module")
def tree():
    return moe_tree()


@pytest.fixture(scope="module")
def tree_int8(tree):
    return jax_int8(tree)


class TestExpertProducts:
    @pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
    def test_qmatmul_experts(self, tree, tree_int8, int8):
        src = tree_int8 if int8 else tree
        x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(
            np.float32)
        for name in ("wg", "wu"):
            jw = j_layer0(src)[name]
            tw = t_layer0(params_from_numpy(src, device="cpu"))[name]
            assert isinstance(tw, QuantizedTensor) == int8
            want = np.asarray(jax_moe.qmatmul_experts(jnp.asarray(x), jw))
            got = moe.qmatmul_experts(torch.from_numpy(x), tw).numpy()
            assert got.shape == (2, 5, 4, 128)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    @pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
    def test_expert_matmul(self, tree, tree_int8, int8):
        src = tree_int8 if int8 else tree
        rng = np.random.default_rng(4)
        tparams = t_layer0(params_from_numpy(src, device="cpu"))
        for name, width in (("wg", 64), ("wd", 128)):
            xg = rng.normal(size=(4, 6, width)).astype(np.float32)
            want = np.asarray(jax_moe._expert_matmul(
                jnp.asarray(xg), j_layer0(src)[name]))
            got = moe._expert_matmul(torch.from_numpy(xg),
                                     tparams[name]).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def dropped_pairs(idx: np.ndarray, C: int) -> set:
    """(token, choice) pairs past their expert's capacity, from top-k
    indices [T, k], in the dispatch's flat order."""
    seen: dict[int, int] = {}
    out = set()
    for p, e in enumerate(idx.reshape(-1).tolist()):
        if seen.get(e, 0) >= C:
            out.add(divmod(p, idx.shape[1]))
        seen[e] = seen.get(e, 0) + 1
    return out


class TestMixture:
    @pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
    def test_dense_mixture_at_decode(self, tree, tree_int8, int8):
        src = tree_int8 if int8 else tree
        x = np.random.default_rng(5).normal(size=(8, 1, 64)).astype(
            np.float32)
        want = np.asarray(jax_moe.moe_mlp(jnp.asarray(x), j_layer0(src),
                                          JCFG))
        got = moe.moe_mlp(torch.from_numpy(x),
                          t_layer0(params_from_numpy(src, device="cpu")),
                          CFG).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def test_no_drop_dispatch_equals_dense_mixture(self, tree):
        cfg = dataclasses.replace(CFG, moe_capacity_factor=NO_DROP)
        x = torch.from_numpy(np.random.default_rng(6).normal(
            size=(4, 32, 64)).astype(np.float32))
        lp = t_layer0(params_from_numpy(tree, device="cpu"))
        got = moe.moe_mlp_dispatch(x, lp, cfg)
        dense = torch.cat([moe.moe_mlp(x[:, s:s + 1], lp, cfg)
                           for s in range(32)], dim=1)
        torch.testing.assert_close(got, dense, atol=2e-4, rtol=2e-4)

    @pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
    @pytest.mark.parametrize("cf", ["no-drop", "default", 0.5])
    def test_dispatch_equals_jax(self, tree, tree_int8, cf, int8):
        """At no-drop capacity, the default 2.0 and 0.5 (drops): the
        port's output equals the JAX dispatch's, and both drop the same
        (token, choice) pairs."""
        src = tree_int8 if int8 else tree
        cf = {"no-drop": NO_DROP, "default": None}.get(cf, cf)
        jcfg = dataclasses.replace(JCFG, moe_capacity_factor=cf)
        cfg = dataclasses.replace(CFG, moe_capacity_factor=cf)
        x = np.random.default_rng(7).normal(size=(2, 48, 64)).astype(
            np.float32)
        jlp = j_layer0(src)
        tlp = t_layer0(params_from_numpy(src, device="cpu"))
        want = np.asarray(jax_moe.moe_mlp_dispatch(jnp.asarray(x), jlp, jcfg))
        got = moe.moe_mlp_dispatch(torch.from_numpy(x), tlp, cfg).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        # the same pairs dropped: routing from each package's own logits
        T, X, k = 96, CFG.num_experts, CFG.num_experts_per_tok
        C = min(T, math.ceil(T * k / X * (cf or moe.CAPACITY_FACTOR)))
        xf = x.reshape(T, 64)
        _, jidx = jax.lax.top_k(jnp.asarray(xf) @ jlp["router"], k)
        _, tidx = moe.top_k(torch.from_numpy(xf) @ tlp["router"], k)
        jdrop = dropped_pairs(np.asarray(jidx), C)
        assert dropped_pairs(tidx.numpy(), C) == jdrop
        assert bool(jdrop) == (cf == 0.5)

    def test_moe_mlp_routes_by_token_count(self, tree):
        """B * S >= 64 at S > 1 dispatches (its capacity drops pairs at
        cf 0.5, so it differs from the dense mixture); fewer tokens, or
        S == 1, take the dense mixture."""
        cfg = dataclasses.replace(CFG, moe_capacity_factor=0.5)
        lp = t_layer0(params_from_numpy(tree, device="cpu"))
        rng = np.random.default_rng(8)
        big = torch.from_numpy(rng.normal(size=(2, 32, 64)).astype(
            np.float32))
        torch.testing.assert_close(moe.moe_mlp(big, lp, cfg),
                                   moe.moe_mlp_dispatch(big, lp, cfg),
                                   atol=0, rtol=0)
        small = big[:1, :31]
        dense = torch.cat([moe.moe_mlp(small[:, s:s + 1], lp, cfg)
                           for s in range(31)], dim=1)
        torch.testing.assert_close(moe.moe_mlp(small, lp, cfg), dense,
                                   atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# The model


class TestModel:
    @pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
    def test_prefill_dispatch_then_decode(self, tree, tree_int8, int8):
        """Prefill of 2 x 40 tokens (80 >= 64: the dispatch) through flash,
        then four decode steps (the dense mixture); int8 weights with an
        int8 cache."""
        src = tree_int8 if int8 else tree
        jparams = jax.tree.map(j_leaf, src, is_leaf=lambda v: hasattr(
            v, "q") or isinstance(v, np.ndarray))
        params = params_from_numpy(src, device="cpu")
        rng = np.random.default_rng(9)
        B, S, T = 2, 40, 64
        tokens = rng.integers(0, 512, (B, S))
        seq_lens = np.array([40, 27], np.int32)
        jcache = jax_init_cache(JCFG, B, T, jnp.float32, quantized=int8)
        jh, jcache = jax_forward_hidden(
            jparams, JCFG, jnp.asarray(tokens, jnp.int32), jcache,
            seq_lens=jnp.asarray(seq_lens), prefill_flash=True)
        cache = llama.init_cache(CFG, B, T, torch.float32, quantized=int8,
                                 device="cpu")
        h, cache = llama.forward_hidden(
            params, CFG, torch.from_numpy(tokens), cache,
            seq_lens=torch.from_numpy(seq_lens), prefill_flash=True)
        want = np.asarray(jax_logits(jparams, JCFG, jh))
        got = llama.logits_from_hidden(params, CFG, h).numpy()
        for b, n in enumerate(seq_lens):
            np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL,
                                       rtol=0)
        for step in range(4):
            nxt = rng.integers(0, 512, (B, 1))
            jl, jcache = jax_forward(jparams, JCFG,
                                     jnp.asarray(nxt, jnp.int32), jcache)
            logits, cache = llama.forward(params, CFG, torch.from_numpy(nxt),
                                          cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"decode step {step}")

    def test_continuation_dispatch(self, tree):
        """S > 1 without flash over a live cache (chunks, cached suffixes):
        2 x 8 tokens (the dense mixture), then 2 x 36 (the dispatch)."""
        jparams, params = both(tree)
        rng = np.random.default_rng(10)
        jcache = jax_init_cache(JCFG, 2, 64, jnp.float32)
        cache = llama.init_cache(CFG, 2, 64, torch.float32, device="cpu")
        for chunk in (rng.integers(0, 512, (2, 8)),
                      rng.integers(0, 512, (2, 36))):
            jl, jcache = jax_forward(jparams, JCFG,
                                     jnp.asarray(chunk, jnp.int32), jcache)
            logits, cache = llama.forward(params, CFG,
                                          torch.from_numpy(chunk), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0)


class TestInt8:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                             ids=["f32", "bf16"])
    def test_quantize_tree_bit_equal_on_expert_stacks(self, tree, dtype):
        jtree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        want = jax.tree.map(np.asarray, jax_llama.quantize_params(
            {**jtree, "layers": dict(jtree["layers"])}))
        got = llama.quantize_params(params_from_numpy(
            jax.tree.map(np.asarray, jtree), device="cpu"))
        for name in ("wg", "wu", "wd"):
            leaf = got["layers"][name]
            assert isinstance(leaf, QuantizedTensor) and leaf.q.ndim == 4
            np.testing.assert_array_equal(leaf.q.numpy(),
                                          want["layers"][name].q)
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          want["layers"][name].scale)
        # the router stays dense (not a QUANT_KEYS leaf), as in JAX
        assert isinstance(got["layers"]["router"], torch.Tensor)
        assert not hasattr(want["layers"]["router"], "q")

    def test_init_quantized_per_slab(self):
        """init_params(quantize=True) draws, scales and quantizes one
        (layer, expert) [K, N] slab at a time: its payloads and scales
        equal `quantize` over the same draws (a dense init from the same
        seed), slab by slab."""
        dense = llama.init_params(CFG, torch.Generator().manual_seed(3),
                                  torch.float32)
        q = llama.init_params(CFG, torch.Generator().manual_seed(3),
                              torch.float32, quantize=True)
        for name in ("wg", "wu", "wd"):
            leaf = q["layers"][name]
            assert leaf.q.shape == dense["layers"][name].shape
            assert leaf.scale.shape == (2, 4, leaf.q.shape[-1])
            for layer in range(2):
                for e in range(4):
                    ref = quantize(dense["layers"][name][layer, e])
                    assert torch.equal(leaf.q[layer, e], ref.q)
                    assert torch.equal(leaf.scale[layer, e], ref.scale)
        assert torch.equal(q["layers"]["router"], dense["layers"]["router"])

    def test_pack_report_lists_the_expert_stacks(self, tree):
        params = llama.quantize_params(params_from_numpy(tree, device="cpu"))
        report = []
        llama.pack_params(params, report=report)
        assert sorted(p for p, r in report if r == "expert_stack") == [
            "layers/wd", "layers/wg", "layers/wu"]
        for name in ("wg", "wu", "wd"):
            assert isinstance(params["layers"][name], QuantizedTensor)
        assert isinstance(params["layers"]["wq"], PackedQuantizedTensor)
        assert isinstance(params["lm_head"], PackedQuantizedTensor)

    def test_params_from_numpy_maps_the_jax_int8_moe_tree(self, tree):
        """The JAX package's packed int8 MoE tree: expert stacks flat
        (extra == 1, kept flat), attention leaves and the head in tiles
        (repacked into panels)."""
        jparams = jax_llama.pack_params(jax_llama.quantize_params(
            jax.tree.map(jnp.asarray, tree)))
        assert isinstance(jparams["layers"]["wg"], jax_quant.QuantizedTensor)
        assert isinstance(jparams["layers"]["wq"],
                          jax_quant.PackedQuantizedTensor)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        flat = jax_int8(tree)
        for name in ("wg", "wu", "wd"):
            leaf = params["layers"][name]
            assert isinstance(leaf, QuantizedTensor)
            np.testing.assert_array_equal(leaf.q.numpy(),
                                          flat["layers"][name].q)
        assert isinstance(params["layers"]["wq"], PackedQuantizedTensor)


# ---------------------------------------------------------------------------
# Serving through each package's Scheduler


ID_BASE = 0x4E00
PROMPTS = [list(range(7, 77)), list(range(200, 220)), list(range(300, 400))]
MAX_NEW = 10


class JaxIdTokenizer(JaxByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


def serve(scheduler, request_cls, sampling_cls):
    events = {i: [] for i in range(len(PROMPTS))}
    done = {i: threading.Event() for i in range(len(PROMPTS))}
    for i, ids in enumerate(PROMPTS):
        def emit(ev, i=i):
            events[i].append(ev)
            if ev.done:
                done[i].set()
        scheduler.submit(request_cls(prompt_ids=list(ids),
                                     sampling=sampling_cls(),
                                     max_new_tokens=MAX_NEW, emit=emit,
                                     id=f"r{i}"))
    scheduler.start()
    try:
        for ev in done.values():
            assert ev.wait(180), "request did not complete"
    finally:
        scheduler.stop()
    return [([ord(c) - ID_BASE for c in "".join(ev.text for ev in events[i])],
             events[i][-1].finish_reason) for i in range(len(PROMPTS))]


SERVE_CASES = {
    # buckets 32/128: the 70- and 100-token prompts prefill through the
    # dispatch, the 20-token one through the dense mixture
    "dense": dict(prefill_chunk=None),
    "dense-cf0.5": dict(prefill_chunk=None, cf=0.5),
    "int8": dict(prefill_chunk=None, int8=True),
    # 64-token chunks dispatch with their own capacity
    "chunked": dict(prefill_chunk=64),
    "chunked-cf0.5": dict(prefill_chunk=64, cf=0.5),
}


class TestServe:
    @pytest.mark.parametrize("case", list(SERVE_CASES))
    def test_greedy_tokens_equal_the_jax_engine(self, tree, tree_int8, case):
        spec = SERVE_CASES[case]
        int8 = spec.get("int8", False)
        src = tree_int8 if int8 else tree
        jcfg = dataclasses.replace(JCFG, moe_capacity_factor=spec.get("cf"))
        cfg = dataclasses.replace(CFG, moe_capacity_factor=spec.get("cf"))
        kw = dict(max_slots=2, max_seq_len=192, prefill_buckets=(32, 128),
                  decode_block=4, kv_quant=int8, fused_dequant=int8,
                  prefill_chunk=spec["prefill_chunk"])
        jparams = jax.tree.map(j_leaf, src, is_leaf=lambda v: hasattr(
            v, "q") or isinstance(v, np.ndarray))
        jengine = JaxEngine(jcfg, jparams, JaxIdTokenizer(512),
                            cache_dtype=jnp.float32, **kw)
        want = serve(JaxScheduler(jengine, debug_invariants=True), JaxRequest,
                     JaxSampling)
        engine = InferenceEngine(cfg, params_from_numpy(src, device="cpu"),
                                 IdTokenizer(512), cache_dtype=torch.float32,
                                 device="cpu", **kw)
        if int8:
            assert isinstance(engine.params["layers"]["wq"],
                              PackedQuantizedTensor)
            assert isinstance(engine.params["layers"]["wg"], QuantizedTensor)
        got = serve(Scheduler(engine, debug_invariants=True), GenRequest,
                    SamplingParams)
        assert got == want
        for ids, reason in got:
            assert reason in ("length", "stop") and len(ids) >= 1

    def test_greedy_deterministic_across_slots(self, tree):
        """Slot 1's traffic does not perturb slot 0's greedy tokens (as
        tests/test_moe.py holds the JAX engine), and both equal the JAX
        engine's."""
        def run(eng, sampling, batched):
            out = [eng.prefill_and_insert(0, list(b"abc"), sampling())]
            if batched:
                eng.prefill_and_insert(1, list(b"other stream"), sampling())
            out += [int(eng.decode_step()[0]) for _ in range(5)]
            return out

        kw = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16,))
        results = []
        for batched in (False, True):
            port = InferenceEngine(CFG, params_from_numpy(tree, device="cpu"),
                                   ByteTokenizer(), cache_dtype=torch.float32,
                                   device="cpu", **kw)
            ref = JaxEngine(JCFG, jax.tree.map(jnp.asarray, tree),
                            JaxByteTokenizer(), cache_dtype=jnp.float32, **kw)
            results += [run(port, SamplingParams, batched),
                        run(ref, JaxSampling, batched)]
        assert results[0] == results[1] == results[2] == results[3]

    def test_padded_prefill_installs_each_slots_last_row(self, tree):
        """A coalesced prefill pads its batch by replaying the last request
        into that slot, and under capacity dispatch the pad row can differ
        from the real one. Each slot takes its LAST row, as a sequential
        scatter (the CPU's, the JAX engine's) leaves it, and the scatter
        names each slot once: a CUDA scatter with a repeated index writes
        in no fixed order."""
        engine = InferenceEngine(CFG, params_from_numpy(tree, device="cpu"),
                                 ByteTokenizer(), cache_dtype=torch.float32,
                                 device="cpu", max_slots=2, max_seq_len=64,
                                 prefill_buckets=(16,))
        st = engine.state
        L, _, _, K, D = st.cache.k.shape
        k = torch.arange(L * 3 * 16 * K * D, dtype=torch.float32).reshape(
            L, 3, 16, K, D)
        prefix = llama.KVCache(k=k, v=-k,
                               lengths=torch.zeros(3, dtype=torch.int32))
        written = []
        dev = engine._dev

        def spy(a):
            written.append(np.asarray(a).copy())
            return dev(a)
        engine._dev = spy
        row = torch.tensor
        engine._insert_all(prefix, np.array([0, 1, 1]),
                           row([5, 6, 7], dtype=torch.int32),
                           row([10, 11, 12]), row([0.0, 0.5, 1.0]),
                           row([1.0, 0.9, 0.8]), row([0, 4, 8]),
                           row([[1, 2], [3, 4], [5, 6]]))
        assert [w.tolist() for w in written] == [[0, 2], [0, 1]]
        assert torch.equal(st.cache.k[:, 0, :16], k[:, 0])
        assert torch.equal(st.cache.k[:, 1, :16], k[:, 2])
        assert torch.equal(st.cache.v[:, 1, :16], -k[:, 2])
        assert st.cache.lengths.tolist() == [5, 7]
        assert st.last_token.tolist() == [10, 12]
        assert st.top_k.tolist() == [0, 8]
        assert st.rng.tolist() == [[1, 2], [5, 6]]

    def test_engine_surface(self):
        """from_tpu_config on tiny-moe int8 (kv_quant + fused_dequant):
        the expert stacks stay flat, weight_stream_bytes counts every leaf
        but the embedding."""
        from symmetry_tpu_torch.provider.config import TpuConfig

        engine = InferenceEngine.from_tpu_config(TpuConfig.from_dict(
            {"model_preset": "tiny-moe", "dtype": "float32",
             "quantization": "int8", "kv_quantization": "int8",
             "fused_dequant": True, "max_batch_size": 2, "max_seq_len": 128,
             "prefill_buckets": [32, 128]}), device="cpu")
        layers = engine.params["layers"]
        assert layers["wg"].q.shape == (2, 4, 64, 128)
        assert isinstance(layers["wd"], QuantizedTensor)
        assert isinstance(layers["wq"], PackedQuantizedTensor)
        assert layers["router"].dtype == torch.float32

        def nbytes(tree):
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            if isinstance(tree, tuple):
                return sum(nbytes(t) for t in tree)
            return tree.numel() * tree.element_size()

        embed = engine.params["embed"]
        assert engine.weight_stream_bytes() == (
            nbytes(engine.params) - embed.numel() * embed.element_size())
        experts = sum(nbytes(layers[k]) for k in ("wg", "wu", "wd"))
        # int8 payloads [2, 4, 64, 128] x 3 and float32 scales [2, 4, N]
        assert experts == 3 * 2 * 4 * 64 * 128 + 2 * 4 * 4 * (128 + 128 + 64)


# ---------------------------------------------------------------------------
# Checkpoints and the warm cache


def hf_dict(tree, cfg=JCFG) -> dict:
    """A mixtral-layout HF state dict authored from the tree."""
    out = {"model.embed_tokens.weight": tree["embed"],
           "model.norm.weight": tree["final_norm"],
           "lm_head.weight": np.ascontiguousarray(tree["lm_head"].T)}
    lay = tree["layers"]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = lay["attn_norm"][i]
        out[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"),
                         ("wv", "v_proj"), ("wo", "o_proj")):
            out[p + f"self_attn.{hf}.weight"] = np.ascontiguousarray(
                lay[ours][i].T)
        out[p + "block_sparse_moe.gate.weight"] = np.ascontiguousarray(
            lay["router"][i].T)
        for ours in ("wg", "wu", "wd"):
            for e in range(cfg.num_experts):
                out[jax_llama.hf_expert_name(i, e, ours)] = (
                    np.ascontiguousarray(lay[ours][i, e].T))
    return out


def assert_trees_equal(port, ref):
    assert set(port) == set(ref)
    for key, value in ref.items():
        got = port[key]
        if isinstance(value, dict):
            assert_trees_equal(got, value)
        elif hasattr(value, "q"):
            assert isinstance(got, QuantizedTensor), key
            for a, b in ((got.q, value.q), (got.scale, value.scale)):
                np.testing.assert_array_equal(_np(a), _np(b), err_msg=key)
        else:
            a, b = _np(got), _np(value)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=key)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.fixture
def mixtral_checkpoint(tmp_path, tree):
    """A tiny mixtral checkpoint written by the port's writer."""
    path = str(tmp_path / "mixtral")
    weights.save_checkpoint(path, params_from_numpy(tree, device="cpu"), CFG)
    return path


class TestCheckpoint:
    def test_convert_hf_state_dict_equals_jax(self, tree):
        tensors = hf_dict(tree)
        got = weights.convert_hf_state_dict(tensors, CFG)
        want = jax_weights.convert_hf_state_dict(tensors, JCFG)
        assert_trees_equal(got, want)
        assert_trees_equal(got, tree)
        bad = dict(tensors)
        bad.pop(jax_llama.hf_expert_name(1, 3, "wd"))
        with pytest.raises(weights.CheckpointError, match="'wd'"):
            weights.convert_hf_state_dict(bad, CFG)

    def test_port_checkpoint_read_by_jax(self, mixtral_checkpoint, tree):
        cfg_json = json.load(open(os.path.join(mixtral_checkpoint,
                                               "config.json")))
        assert cfg_json["architectures"] == ["MixtralForCausalLM"]
        assert cfg_json["num_local_experts"] == 4
        assert cfg_json["num_experts_per_tok"] == 2
        params, jcfg = jax_weights.load_checkpoint(mixtral_checkpoint,
                                                   dtype=jnp.float32)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(CFG)
        assert_trees_equal(jax.tree.map(np.asarray, params), tree)
        # the same files as the JAX writer's
        jax_out = mixtral_checkpoint + "-jax"
        jax_weights.save_checkpoint(jax_out, jax.tree.map(jnp.asarray, tree),
                                    JCFG)
        assert (json.load(open(os.path.join(jax_out, "config.json")))
                == cfg_json)
        mine = weights.SafetensorsFile(os.path.join(mixtral_checkpoint,
                                                    "model.safetensors"))
        theirs = weights.SafetensorsFile(os.path.join(jax_out,
                                                      "model.safetensors"))
        assert sorted(mine.keys()) == sorted(theirs.keys())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    def test_jax_checkpoint_read_by_the_port(self, tmp_path, tree, dtype):
        path = str(tmp_path / "jax-mixtral")
        jax_weights.save_checkpoint(path, jax.tree.map(jnp.asarray, tree),
                                    JCFG)
        params, cfg = weights.load_checkpoint(path, dtype=dtype,
                                              device="cpu")
        assert cfg == CFG and isinstance(cfg, llama.MoEConfig)
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        ref, _ = jax_weights.load_checkpoint(path, dtype=jdtype)
        assert_trees_equal(params, jax.tree.map(np.asarray, ref))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    def test_load_quantized_equals_jax(self, mixtral_checkpoint, dtype,
                                       monkeypatch):
        """load_checkpoint(quantize=True) quantizes one (layer, expert)
        slab at a time as it is read, in column blocks (48 here: several a
        slab, a partial one last), into the int8 expert stacks: bit-equal
        to the JAX package's quantize_params of its dense load."""
        monkeypatch.setattr(weights, "_QUANT_COLS", 48)
        params, _ = weights.load_checkpoint(mixtral_checkpoint, dtype=dtype,
                                            device="cpu", quantize=True)
        assert all(isinstance(params["layers"][k], QuantizedTensor)
                   for k in ("wg", "wu", "wd"))
        assert not isinstance(params["layers"]["router"], QuantizedTensor)
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        ref, _ = jax_weights.load_checkpoint(mixtral_checkpoint,
                                             dtype=jdtype)
        assert_trees_equal(params, jax.tree.map(
            np.asarray, jax_llama.quantize_params(ref)))

    @pytest.mark.parametrize("quantize", [False, True],
                             ids=["dense", "int8"])
    def test_warm_cache_both_ways(self, mixtral_checkpoint, quantize):
        ck = mixtral_checkpoint
        # the JAX package's cache, read by the port
        jparams, jcfg = jax_weights.load_checkpoint(ck, dtype=jnp.bfloat16)
        if quantize:
            jparams = jax_llama.quantize_params(jparams)
        jax_weights.save_warm_cache(ck, jparams, jcfg, dtype=jnp.bfloat16,
                                    quantize=quantize)
        warm = weights.load_warm_cache(ck, dtype=torch.bfloat16,
                                       quantize=quantize, device="cpu")
        assert warm is not None and isinstance(warm[1], llama.MoEConfig)
        assert dataclasses.asdict(warm[1]) == dataclasses.asdict(jcfg)
        assert_trees_equal(warm[0], jax.tree.map(np.asarray, jparams))
        # the port's cache, read by the JAX package
        params, cfg = weights.load_checkpoint(ck, dtype=torch.bfloat16,
                                              device="cpu")
        if quantize:
            params = llama.quantize_params(params)
        weights.save_warm_cache(ck, params, cfg, dtype=torch.bfloat16,
                                quantize=quantize)
        meta = json.load(open(os.path.join(weights._warm_path(
            ck, torch.bfloat16, quantize), "meta.json")))
        assert meta["config_class"] == "MoEConfig"
        jwarm = jax_weights.load_warm_cache(ck, dtype=jnp.bfloat16,
                                            quantize=quantize)
        assert jwarm is not None
        assert type(jwarm[1]).__name__ == "MoEConfig"
        assert dataclasses.asdict(jwarm[1]) == dataclasses.asdict(cfg)
        assert_trees_equal(params, jax.tree.map(np.asarray, jwarm[0]))

    def test_from_tpu_config_cold_then_warm(self, mixtral_checkpoint):
        from symmetry_tpu_torch.provider.config import TpuConfig

        tpu = TpuConfig.from_dict({
            "checkpoint_path": mixtral_checkpoint, "dtype": "float32",
            "quantization": "int8", "max_batch_size": 2, "max_seq_len": 128,
            "prefill_buckets": [32, 128]})
        tokens = []
        for _ in range(2):  # cold (writes the cache), then warm
            eng = InferenceEngine.from_tpu_config(tpu, device="cpu")
            assert isinstance(eng.config, llama.MoEConfig)
            tokens.append(eng.prefill_and_insert(0, PROMPTS[0],
                                                 SamplingParams()))
        assert tokens[0] == tokens[1]
        assert weights.load_warm_cache(mixtral_checkpoint,
                                       dtype=torch.float32, quantize=True,
                                       device="cpu") is not None


# ---------------------------------------------------------------------------
# The engine host


def test_engine_host_serves_tiny_moe(tmp_path):
    """`python -m symmetry_tpu_torch.engine.host <cfg> --device cpu` starts
    on model_preset tiny-moe and streams a chat to its end."""
    cfg = {"name": "moe-host", "public": False, "serverKey": "00" * 32,
           "modelName": "tiny-moe:test", "apiProvider": "tpu_native",
           "dataCollectionEnabled": False,
           "tpu": {"model_preset": "tiny-moe", "dtype": "float32",
                   "max_batch_size": 2, "max_seq_len": 256,
                   "prefill_buckets": [32, 128], "prefill_chunk": 64,
                   "decode_block": 4, "compile_cache": False}}
    path = tmp_path / "host.json"
    path.write_text(json.dumps(cfg))
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "symmetry_tpu_torch.engine.host", str(path),
         "--device", "cpu"], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    try:
        frames = []

        def read_until(pred):
            for line in proc.stdout:
                frame = json.loads(line)
                frames.append(frame)
                if pred(frame):
                    return frame
            raise AssertionError(f"host ended: {proc.stderr.read()[-2000:]}")

        read_until(lambda f: f.get("op") == "ready")
        proc.stdin.write(json.dumps({
            "op": "submit", "id": "c1", "max_new": 12,
            "sampling": {"temperature": 0.0},
            "messages": [{"role": "user", "content":
                          "a chat to a mixture of experts, long enough to "
                          "prefill through the dispatch"}]}) + "\n")
        proc.stdin.flush()

        def events(f):
            if f.get("op") == "event":
                return [f]
            return f.get("events", []) if f.get("op") == "events" else []

        read_until(lambda f: any(e.get("done") for e in events(f)))
        evs = [e for f in frames for e in events(f) if e.get("id") == "c1"]
        assert evs[-1]["finish_reason"] in ("length", "stop")
        assert evs[-1]["tokens"] >= 1
        proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
        proc.stdin.flush()
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
