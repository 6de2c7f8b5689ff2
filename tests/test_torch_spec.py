"""Speculative decoding in the PyTorch port against the JAX package (CPU).

tests/test_spec.py's cases, each also held against the JAX engine on the
same weights (the JAX tree converted with params_from_numpy):

- the drafter copy proposes what the JAX drafter proposes on the same
  streams (hypothesis), and parses the knob as it does;
- `verify_tokens` equals the JAX function on the same logits and keys:
  greedy lanes bit-equal; sampled lanes give the same tokens and counts on
  the seeds used (threefry bits and uniforms are bit-equal; the Gumbel
  logs agree within 2 ulp, ops/prng.py, which moves no argmax here);
- engine `verify_step` tokens, `n_emit` and cache lengths equal the JAX
  engine's, a slot next to capacity included, and verify interleaves with
  decode blocks;
- Scheduler greedy output is identical with speculation on and off and
  identical to the JAX engine's, dense and int8 (`kv_quant` +
  `fused_dequant`), with a per-request opt-out, an EOS inside an accepted
  run, a budget finish and a seeded stream;
- the port's host with `speculative: {k_draft: 4}` streams what the JAX
  host streams.
"""

import json
import queue
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.engine import SamplingParams as JaxSampling
from symmetry_tpu.engine.host import EngineHost as JaxHost
from symmetry_tpu.engine.scheduler import GenRequest as JaxRequest
from symmetry_tpu.engine.scheduler import Scheduler as JaxScheduler
from symmetry_tpu.engine.spec import NGramDrafter as JaxDrafter
from symmetry_tpu.engine.spec import SpecConfig as JaxSpecConfig
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu.engine.tokenizer import get_tokenizer as jax_get_tokenizer
from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.models.llama import quantize_params as jax_quantize_params
from symmetry_tpu.ops.sampling import verify_tokens as jax_verify_tokens
from symmetry_tpu.provider.config import ConfigManager as JaxConfigManager
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine.engine import (
    EngineError,
    InferenceEngine,
    SamplingParams,
)
from symmetry_tpu_torch.engine.host import EngineHost
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.spec import NGramDrafter, SpecConfig
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer, get_tokenizer
from symmetry_tpu_torch.models.llama import preset
from symmetry_tpu_torch.ops.sampling import sample_tokens, verify_tokens
from symmetry_tpu_torch.provider.config import ConfigManager

CYCLE_TOKEN = 120


def numpy_weights(bias_token=None, seed=0):
    """tiny's JAX float32 weights as numpy; `bias_token` lifts one LM-head
    column so greedy generation settles into that token (the drafter then
    matches constantly, tests/test_spec.py cycling_params)."""
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_preset("tiny"), jax.random.key(seed), jnp.float32))
    if bias_token is not None:
        tree["lm_head"] = tree["lm_head"].copy()
        tree["lm_head"][:, bias_token] = 10.0
    return tree


def both(tree, int8=False):
    """(JAX params, port params) from one numpy tree; int8 quantizes in
    JAX and hands the int8 tree to the port."""
    jparams = jax.tree.map(jnp.asarray, tree)
    if int8:
        jparams = jax_quantize_params(jparams)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


@pytest.fixture(scope="module")
def plain_weights():
    return both(numpy_weights())


@pytest.fixture(scope="module")
def cycling_weights():
    return both(numpy_weights(CYCLE_TOKEN))


BUCKETS = (16, 32, 64)


def jax_engine(jparams, spec=None, slots=2, seq=128, block=4, int8=False):
    # the JAX engine packs a params dict in place: hand it a copy
    return JaxEngine(jax_preset("tiny"), jax.tree.map(lambda a: a, jparams),
                     JaxByteTokenizer(), max_slots=slots, max_seq_len=seq,
                     prefill_buckets=BUCKETS, cache_dtype=jnp.float32,
                     decode_block=block, prefill_chunk=None,
                     speculative=JaxSpecConfig(k_draft=spec) if spec else None,
                     kv_quant=int8, fused_dequant=int8)


def port_engine(params, spec=None, slots=2, seq=128, block=4, int8=False):
    return InferenceEngine(preset("tiny"), params, ByteTokenizer(),
                           max_slots=slots, max_seq_len=seq,
                           prefill_buckets=BUCKETS,
                           cache_dtype=torch.float32, decode_block=block,
                           speculative=SpecConfig(k_draft=spec) if spec
                           else None, kv_quant=int8, fused_dequant=int8,
                           device="cpu")


# ---------------------------------------------------------------------------
# The drafter copy


class TestDrafter:
    @pytest.mark.parametrize("knob", [None, False, 0, True, 4,
                                      {"k_draft": 6, "ngram_max": 2},
                                      {"k_draft": 2, "ngram_min": 2,
                                       "ngram_max": 4,
                                       "max_index_tokens": 64}])
    def test_knob_parsing_equals_jax(self, knob):
        got, want = SpecConfig.from_knob(knob), JaxSpecConfig.from_knob(knob)
        assert (got is None) == (want is None)
        if got is not None:
            assert vars(got) == vars(want)

    @pytest.mark.parametrize("bad", [{"bogus": 1}, "yes", {"k_draft": 0},
                                     {"ngram_min": 3, "ngram_max": 2}])
    def test_bad_knobs_raise(self, bad):
        with pytest.raises(ValueError):
            SpecConfig.from_knob(bad)
        with pytest.raises(ValueError):
            JaxSpecConfig.from_knob(bad)

    @pytest.mark.parametrize("prompt,first,k,want", [
        ([1, 2, 3, 4, 5], 6, 4, []),
        ([7, 8, 9, 50, 7, 8], 9, 4, [50, 7, 8, 9]),
        ([9] * 12, 9, 5, [9] * 5),
    ])
    def test_spec_cases(self, prompt, first, k, want):
        for cls, cfg in ((NGramDrafter, SpecConfig),
                         (JaxDrafter, JaxSpecConfig)):
            d = cls(cfg(k_draft=k))
            d.begin(0, prompt, first)
            assert d.propose(0) == want

    @settings(max_examples=60, deadline=None)
    @given(k=st.integers(1, 6), ngram_max=st.integers(1, 4),
           index=st.integers(10, 40),
           ops=st.lists(st.tuples(
               st.sampled_from(["begin", "extend", "propose", "release"]),
               st.integers(0, 2),
               st.lists(st.integers(0, 5), min_size=1, max_size=30)),
               max_size=30))
    def test_proposals_equal_jax(self, k, ngram_max, index, ops):
        index = max(index, ngram_max + k)
        cfgs = (SpecConfig(k_draft=k, ngram_max=ngram_max,
                           max_index_tokens=index),
                JaxSpecConfig(k_draft=k, ngram_max=ngram_max,
                              max_index_tokens=index))
        port, ref = NGramDrafter(cfgs[0]), JaxDrafter(cfgs[1])
        for op, slot, toks in ops:
            if op == "begin":
                port.begin(slot, toks[:-1], toks[-1])
                ref.begin(slot, toks[:-1], toks[-1])
            elif op == "extend":
                port.extend(slot, toks)
                ref.extend(slot, toks)
            elif op == "release":
                port.release(slot)
                ref.release(slot)
            for s in range(3):
                assert port.propose(s) == ref.propose(s)
            assert port.active_slots() == ref.active_slots()


# ---------------------------------------------------------------------------
# verify_tokens


def logits_case(B, S, V, seed):
    return (np.random.default_rng(seed).normal(size=(B, S, V)) * 3.0
            ).astype(np.float32)


def run_both(logits, draft, n_draft, key_seed, temperature, top_p, top_k):
    """verify_tokens of both packages on the same inputs and keys."""
    B = logits.shape[0]
    keys = jax.random.split(jax.random.key(key_seed), B)
    jout, jn = jax_verify_tokens(
        jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
        jnp.asarray(n_draft, jnp.int32), keys, jnp.asarray(temperature),
        jnp.asarray(top_p), jnp.asarray(top_k, jnp.int32))
    key_data = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    out, n = verify_tokens(
        torch.from_numpy(logits), torch.from_numpy(draft.astype(np.int64)),
        torch.from_numpy(n_draft.astype(np.int32)),
        torch.from_numpy(key_data), torch.tensor(temperature),
        torch.tensor(top_p), torch.tensor(top_k))
    return (out.numpy(), n.numpy()), (np.asarray(jout), np.asarray(jn))


class TestVerifyTokens:
    @pytest.mark.parametrize("seed", range(4))
    def test_greedy_bit_equal(self, seed):
        B, k, V = 4, 5, 50
        logits = logits_case(B, 1 + k, V, seed)
        greedy = logits.argmax(-1)
        draft = greedy[:, :k].copy()
        draft[1, 2] = (draft[1, 2] + 1) % V     # wrong at position 2
        draft[2, 0] = (draft[2, 0] + 7) % V     # wrong at once
        n_draft = np.array([k, k, k, 0], np.int32)
        if seed % 2:
            n_draft[0] = 3                      # a short draft
        zeros = np.zeros((B,), np.float32)
        (out, n), (jout, jn) = run_both(logits, draft, n_draft, seed, zeros,
                                        np.ones((B,), np.float32),
                                        np.zeros((B,), np.int32))
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(out, jout)
        assert n.tolist() == [n_draft[0] + 1, 3, 1, 1]
        for b in range(B):
            assert out[b, :n[b]].tolist() == greedy[b, :n[b]].tolist()

    @pytest.mark.parametrize("seed", range(6))
    def test_sampled_lanes_equal_jax(self, seed):
        """Temperature, top-k and top-p lanes on seeds 0-5: the same tokens
        and counts as the JAX function (exact equality: the draws are the
        same bits; the Gumbel logs' 2-ulp spread moves no argmax here)."""
        B, k, V = 6, 4, 64
        logits = logits_case(B, 1 + k, V, 10 + seed)
        rng = np.random.default_rng(seed)
        draft = np.where(rng.random((B, k)) < 0.6, logits.argmax(-1)[:, :k],
                         rng.integers(0, V, (B, k)))
        n_draft = rng.integers(0, k + 1, B).astype(np.int32)
        temperature = np.array([0.8, 1.0, 0.5, 0.0, 1.3, 0.9], np.float32)
        top_p = np.array([1.0, 0.9, 1.0, 1.0, 0.7, 1.0], np.float32)
        top_k = np.array([0, 0, 2, 0, 10, 5], np.int32)
        (out, n), (jout, jn) = run_both(logits, draft, n_draft, 100 + seed,
                                        temperature, top_p, top_k)
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(out, jout)

    def test_zero_draft_matches_sample_tokens(self):
        """A no-proposal greedy slot advances exactly like a decode step."""
        B, V = 4, 32
        logits = torch.from_numpy(logits_case(B, 1, V, 7))
        keys = torch.tensor([[0, 1], [0, 2], [3, 4], [5, 6]])
        greedy = (torch.zeros(B), torch.ones(B),
                  torch.zeros(B, dtype=torch.int64))
        out, n = verify_tokens(logits, torch.zeros((B, 0), dtype=torch.int64),
                               torch.zeros(B, dtype=torch.int32), keys,
                               *greedy)
        assert n.tolist() == [1] * B
        assert out[:, 0].tolist() == sample_tokens(logits[:, 0], keys,
                                                   *greedy).tolist()

    def test_sampled_lane_emits_kept_tokens_only(self):
        B, k, V = 8, 3, 64
        logits = torch.from_numpy(logits_case(B, 1 + k, V, 3))
        top2 = torch.topk(logits, 2, dim=-1).indices
        draft = torch.randint(0, V, (B, k),
                              generator=torch.Generator().manual_seed(4))
        out, n = verify_tokens(logits, draft, torch.full((B,), k,
                                                         dtype=torch.int32),
                               torch.stack([torch.zeros(B, dtype=torch.int64),
                                            torch.arange(B)], 1),
                               torch.full((B,), 0.8), torch.ones(B),
                               torch.full((B,), 2))
        for b in range(B):
            for j in range(int(n[b])):
                assert out[b, j] in top2[b, j]


# ---------------------------------------------------------------------------
# The engine's verify step


def greedy_chain(params, prompt, n, seq=128):
    plain = port_engine(params, block=1, seq=seq)
    out = [plain.prefill_and_insert(0, prompt, SamplingParams())]
    out += [int(plain.decode_step()[0]) for _ in range(n - 1)]
    return out


class TestEngineVerify:
    def test_verify_step_equals_jax(self, plain_weights):
        """True, garbage and no drafts, per slot: tokens, n_emit and cache
        lengths equal the JAX engine's at every verify, and the emitted
        run reproduces the plain greedy chain."""
        jparams, params = plain_weights
        prompts = [list(b"verify chain"), list(b"a second prompt")]
        ref = greedy_chain(params, prompts[0], 16)
        engines = (port_engine(params, spec=4, block=1),
                   jax_engine(jparams, spec=4, block=1))
        for e in engines:
            for slot, p in enumerate(prompts):
                e.prefill_and_insert(slot, p, SamplingParams()
                                     if e is engines[0] else JaxSampling())
        got = [ref[0]]
        variants = [lambda nxt: (nxt, len(nxt)), lambda nxt: ([1, 2, 3, 4], 4),
                    lambda nxt: ([], 0), lambda nxt: (nxt[:2], 2)]
        i = 0
        while len(got) < 16:
            draft = np.zeros((2, 4), np.int32)
            n_draft = np.zeros((2,), np.int32)
            prop, n = variants[i % 4](ref[len(got):len(got) + 4])
            draft[0, :len(prop)] = prop
            n_draft[0] = n
            draft[1] = [7, 7, 7, 7]
            n_draft[1] = i % 3
            (toks, n_emit), (jtoks, jn) = (e.verify_step(draft, n_draft)
                                           for e in engines)
            np.testing.assert_array_equal(n_emit, jn)
            np.testing.assert_array_equal(toks, jtoks)
            assert [engines[0].slot_length(s) for s in (0, 1)] == [
                engines[1].slot_length(s) for s in (0, 1)]
            got.extend(int(toks[j, 0]) for j in range(int(n_emit[0])))
            i += 1
        assert got[:16] == ref

    @pytest.mark.parametrize("prompt_len", [52, 56, 60])
    def test_slot_next_to_capacity(self, plain_weights, prompt_len):
        """A slot whose length + 1 + k passes the capacity (64): the JAX
        package drops the writes past it, the port clamps them onto row
        T - 1 with that row's own K/V; tokens, n_emit and lengths equal."""
        jparams, params = plain_weights
        prompt = [(7 * i) % 200 + 30 for i in range(prompt_len)]
        engines = (port_engine(params, spec=8, seq=64, block=1),
                   jax_engine(jparams, spec=8, seq=64, block=1))
        # the plain chain from a roomier engine: true drafts
        ref = greedy_chain(params, prompt, 10, seq=128)
        draft = np.zeros((2, 8), np.int32)
        draft[0] = ref[1:9]
        draft[1] = ref[1:9]
        outs = []
        for e, sp in zip(engines, (SamplingParams(), JaxSampling())):
            e.prefill_and_insert(0, prompt, sp)
            e.prefill_and_insert(1, prompt[:20], sp)
            outs.append(e.verify_step(draft, np.array([8, 3], np.int32)))
        (toks, n_emit), (jtoks, jn) = outs
        np.testing.assert_array_equal(n_emit, jn)
        np.testing.assert_array_equal(toks, jtoks)
        assert [engines[0].slot_length(s) for s in (0, 1)] == [
            engines[1].slot_length(s) for s in (0, 1)]
        assert engines[0].slot_length(0) == prompt_len + int(n_emit[0])

    def test_verify_interleaves_with_decode_blocks(self, plain_weights):
        """The rollback leaves no stale last_token or length: a plain block
        after a verify continues exactly where the plain run does, as in
        the JAX engine."""
        jparams, params = plain_weights
        prompt = list(b"mixed mode")
        ref = greedy_chain(params, prompt, 20)
        runs = []
        for e, sp in ((port_engine(params, spec=4, block=2), SamplingParams()),
                      (jax_engine(jparams, spec=4, block=2), JaxSampling())):
            got = [e.prefill_and_insert(0, prompt, sp)]
            draft = np.zeros((2, 4), np.int32)
            draft[0] = [9, 9, 9, 9]  # all rejected -> rollback to +1
            toks, n_emit = e.verify_step(draft, np.array([4, 0], np.int32))
            got.extend(int(toks[j, 0]) for j in range(int(n_emit[0])))
            got.extend(int(t) for t in np.asarray(e.decode_steps())[:, 0])
            draft[0] = ref[len(got):len(got) + 4]
            toks, n_emit = e.verify_step(draft, np.array([4, 0], np.int32))
            got.extend(int(toks[j, 0]) for j in range(int(n_emit[0])))
            got.extend(int(t) for t in np.asarray(e.decode_steps())[:, 0])
            runs.append((got, e.slot_length(0)))
        assert runs[0] == runs[1]
        got = runs[0][0]
        assert len(got) >= 9 and got == ref[:len(got)]

    def test_dispatch_returns_futures(self, plain_weights):
        _, params = plain_weights
        e = port_engine(params, spec=3)
        e.prefill_and_insert(0, [5, 6, 7], SamplingParams())
        toks, n_emit = e.verify_step_dispatch(np.zeros((2, 3), np.int32),
                                              np.zeros((2,), np.int32))
        assert np.asarray(toks).shape == (4, 2)
        assert np.asarray(n_emit).tolist() == [1, 1]
        with pytest.raises(EngineError, match="draft shape"):
            e.verify_step(np.zeros((2, 4), np.int32), np.zeros(2, np.int32))

    def test_disabled_engine_has_no_verify_path(self, plain_weights):
        _, params = plain_weights
        e = port_engine(params)
        assert e.spec is None
        with pytest.raises(EngineError, match="not enabled"):
            e.verify_step(np.zeros((2, 4), np.int32), np.zeros(2, np.int32))

    def test_warmup_runs_the_verify_shape(self, plain_weights):
        _, params = plain_weights
        e = port_engine(params, spec=2)
        e.warmup()
        prompt = list(b"after warmup")
        ref = greedy_chain(params, prompt, 4)
        got = [e.prefill_and_insert(0, prompt, SamplingParams())]
        draft = np.zeros((2, 2), np.int32)
        draft[0] = ref[1:3]
        toks, n_emit = e.verify_step(draft, np.array([2, 0], np.int32))
        got.extend(int(toks[j, 0]) for j in range(int(n_emit[0])))
        assert got == ref[:len(got)] and len(got) == 4

    def test_k_draft_must_fit_context(self, plain_weights):
        _, params = plain_weights
        with pytest.raises(EngineError, match="k_draft"):
            port_engine(params, spec=256, seq=64)


# ---------------------------------------------------------------------------
# Through the Scheduler


def run_requests(engine, requests, request_cls, opt_out=()):
    """requests: (prompt ids, sampling, max_new). Returns (events per
    request, scheduler)."""
    sched_cls = Scheduler if request_cls is GenRequest else JaxScheduler
    sched = sched_cls(engine, debug_invariants=True)
    results = {i: [] for i in range(len(requests))}
    done = {i: threading.Event() for i in range(len(requests))}
    for i, (ids, sampling, max_new) in enumerate(requests):
        def emit(ev, i=i):
            results[i].append(ev)
            if ev.done:
                done[i].set()
        sched.submit(request_cls(prompt_ids=list(ids), sampling=sampling,
                                 max_new_tokens=max_new, emit=emit,
                                 id=f"r{i}",
                                 speculative=False if i in opt_out else None))
    sched.start()
    try:
        for ev in done.values():
            assert ev.wait(120), "request did not complete"
    finally:
        sched.stop()
    return results, sched


def streams(results):
    return [("".join(ev.text for ev in evs), evs[-1].tokens_generated,
             evs[-1].finish_reason) for _, evs in sorted(results.items())]


def serve_three(jparams, params, requests, *, int8=False, opt_out=(),
                spec=4):
    """(port spec on, port spec off, JAX spec on) streams and the port's
    spec-on scheduler."""
    port_req = [(p, SamplingParams(**s), n) for p, s, n in requests]
    jax_req = [(p, JaxSampling(**s), n) for p, s, n in requests]
    on, sched = run_requests(port_engine(params, spec=spec, int8=int8),
                             port_req, GenRequest, opt_out)
    off, _ = run_requests(port_engine(params, int8=int8), port_req,
                          GenRequest, opt_out)
    jon, _ = run_requests(jax_engine(jparams, spec=spec, int8=int8),
                          jax_req, JaxRequest, opt_out)
    return streams(on), streams(off), streams(jon), sched


class TestSchedulerSpeculative:
    @pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
    def test_greedy_identical_on_off_and_to_jax(self, int8):
        jparams, params = both(numpy_weights(CYCLE_TOKEN), int8=int8)
        reqs = [(list(b"spec request one"), {}, 30), (list(b"two!"), {}, 30)]
        on, off, jon, sched = serve_three(jparams, params, reqs, int8=int8)
        assert on == off == jon
        spec = sched.stats()["speculative"]
        assert spec["verify_blocks"] > 0 and spec["accepted"] > 0
        assert spec["drafted"] == spec["accepted"] + spec["rolled_back"]
        assert sched.metrics["tokens"] == sum(n for _, n, _ in on)

    def test_no_proposals_keeps_the_plain_path(self, plain_weights):
        jparams, params = plain_weights
        reqs = [(list(b"abcdefgh"), {}, 16)]
        on, off, jon, sched = serve_three(jparams, params, reqs)
        assert on == off == jon
        assert sched.metrics["spec_drafted"] <= 4

    def test_off_means_off(self, plain_weights):
        _, params = plain_weights
        _, sched = run_requests(port_engine(params),
                                [(list(b"plain"), SamplingParams(), 8)],
                                GenRequest)
        assert sched._drafter is None
        assert "speculative" not in sched.stats()
        assert sched.metrics["spec_verify_blocks"] == 0

    def test_per_request_opt_out(self, cycling_weights):
        jparams, params = cycling_weights
        reqs = [(list(b"opted out"), {}, 24), (list(b"speculates"), {}, 24)]
        on, off, jon, sched = serve_three(jparams, params, reqs,
                                          opt_out=(0,))
        assert on == off == jon
        assert sched.metrics["spec_verify_blocks"] > 0

    def test_eos_inside_accepted_run(self):
        eos = ByteTokenizer().EOS
        jparams, params = both(numpy_weights(eos))
        on, off, jon, _ = serve_three(jparams, params,
                                      [(list(b"stop it"), {}, 50)])
        assert on == off == jon
        assert on[0][2] == "stop"

    @pytest.mark.parametrize("budget", [7, 10])
    def test_budget_finish(self, cycling_weights, budget):
        jparams, params = cycling_weights
        on, off, jon, _ = serve_three(jparams, params,
                                      [(list(b"budget"), {}, budget)])
        assert on == off == jon
        assert on[0][1] == budget and on[0][2] == "length"

    def test_seeded_stream_equals_jax(self, cycling_weights):
        """A seeded sampled stream with speculation on runs to its budget
        and samples the JAX engine's tokens (spec on in both: rejection
        sampling draws differently from plain decode)."""
        jparams, params = cycling_weights
        reqs = [(list(b"sampled"), {"temperature": 0.9, "seed": 4}, 24)]
        port_req = [(p, SamplingParams(**s), n) for p, s, n in reqs]
        jax_req = [(p, JaxSampling(**s), n) for p, s, n in reqs]
        on, sched = run_requests(port_engine(params, spec=4), port_req,
                                 GenRequest)
        jon, _ = run_requests(jax_engine(jparams, spec=4), jax_req,
                              JaxRequest)
        assert streams(on) == streams(jon)
        assert streams(on)[0][1] == 24
        assert sched.metrics["spec_verify_blocks"] > 0


# ---------------------------------------------------------------------------
# The engine host with tpu.speculative


class Stdin:
    def __init__(self):
        self._q = queue.Queue()

    def send(self, obj):
        self._q.put(json.dumps(obj) + "\n")

    def __iter__(self):
        while (line := self._q.get()) is not None:
            yield line


class Stdout:
    def __init__(self):
        self.frames = []
        self._buf = ""
        self._cv = threading.Condition()

    def write(self, s):
        with self._cv:
            self._buf += s
            *lines, self._buf = self._buf.split("\n")
            self.frames += [json.loads(line) for line in lines if line]
            self._cv.notify_all()

    def flush(self):
        pass

    def wait_for(self, pred, timeout=120):
        with self._cv:
            assert self._cv.wait_for(
                lambda: any(pred(f) for f in self.frames), timeout)
            return next(f for f in self.frames if pred(f))


def events_of(frames, req_id):
    out = []
    for f in frames:
        if f.get("op") == "event" and f.get("id") == req_id:
            out.append(f)
        elif f.get("op") == "events":
            out += [e for e in f["events"] if e["id"] == req_id]
    return out


HOST_TPU = {"model_preset": "tiny", "dtype": "float32", "max_batch_size": 2,
            "max_seq_len": 128, "prefill_buckets": [32, 64],
            "decode_block": 4, "speculative": {"k_draft": 4},
            "compile_cache": False}


def drive(serve, frames, stdin):
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    frames.wait_for(lambda f: f.get("op") == "ready")
    out = []
    for i, (content, spec) in enumerate([("hello", None), ("again", False),
                                         ("hello", None)]):
        msg = {"op": "submit", "id": f"r{i}", "max_new": 20,
               "messages": [{"role": "user", "content": content}],
               "sampling": {"temperature": 0.0}}
        if spec is not None:
            msg["speculative"] = spec
        stdin.send(msg)
        frames.wait_for(lambda f, i=i: any(
            e.get("done") for e in events_of([f], f"r{i}")))
        evs = events_of(frames.frames, f"r{i}")
        out.append(("".join(e["text"] for e in evs), evs[-1]["tokens"],
                    evs[-1]["finish_reason"]))
    stdin.send({"op": "stats"})
    stats = frames.wait_for(lambda f: f.get("op") == "stats")
    stdin.send({"op": "shutdown"})
    t.join(60)
    assert not t.is_alive()
    return out, stats


def test_host_streams_what_the_jax_host_streams(monkeypatch, cycling_weights):
    """Both hosts from one provider config with `speculative: {k_draft:
    4}` (each package's from_tpu_config building its engine over the same
    cycling weights through the knob): the same streamed text, token counts
    and finish reasons, a per-request opt-out included, and verify blocks
    in the port's stats."""
    jparams, params = cycling_weights
    geometry = dict(max_slots=2, max_seq_len=128, prefill_buckets=(32, 64),
                    decode_block=4)

    def jax_build(cls, tpu_cfg, **kw):
        return JaxEngine(jax_preset("tiny"), jax.tree.map(lambda a: a,
                                                          jparams),
                         jax_get_tokenizer(None, vocab_size=512),
                         cache_dtype=jnp.float32,
                         speculative=JaxSpecConfig.from_knob(
                             tpu_cfg.speculative), **geometry)

    def port_build(cls, tpu_cfg, *, device="cuda"):
        assert device == "cpu"
        return InferenceEngine(preset("tiny"), params,
                               get_tokenizer(None, vocab_size=512),
                               cache_dtype=torch.float32, device=device,
                               speculative=SpecConfig.from_knob(
                                   tpu_cfg.speculative), **geometry)

    def config(cls):
        return cls(config={"name": "spec-host", "public": False,
                           "serverKey": "00" * 32, "modelName": "tiny:spec",
                           "apiProvider": "tpu_native",
                           "dataCollectionEnabled": False, "tpu": HOST_TPU})

    monkeypatch.setattr(JaxEngine, "from_tpu_config", classmethod(jax_build))
    jin, jout = Stdin(), Stdout()
    jhost = JaxHost(config(JaxConfigManager))
    monkeypatch.setattr(sys, "stdout", jout)
    monkeypatch.setattr(sys, "stdin", jin)
    want, jstats = drive(lambda: jhost.serve_forever(), jout, jin)
    monkeypatch.undo()
    monkeypatch.setattr(InferenceEngine, "from_tpu_config",
                        classmethod(port_build))
    pin, pout = Stdin(), Stdout()
    host = EngineHost(config(ConfigManager), device="cpu", out=pout)
    got, stats = drive(lambda: host.serve_forever(stdin=pin), pout, pin)
    assert got == want
    assert stats["speculative"]["verify_blocks"] > 0
    assert stats["speculative"]["k_draft"] == 4
    assert jstats["speculative"]["verify_blocks"] > 0
