"""The int8 serving configuration: the PyTorch port against the JAX package.

int8 weights (`quantize_params`, optionally packed for the W8A16 kernel by
`pack_params`) and an int8 KV cache (`init_cache(quantized=True)`), on the
CPU in float32, where the port runs its kernels' plain versions and the JAX
package runs its Pallas W8A16 kernel in interpret mode (packed leaves) and
its XLA paths elsewhere. Both packages get the same int8 weights: the JAX
tree converted with params_from_numpy.

- Model logits at atol 1e-4, as tests/test_torch_model.py: float32 on both
  sides, and int8 payloads are bit-equal for equal inputs (test_torch_quant),
  so only summation order differs; the cache's scales at rtol 1e-5, as they
  follow the trunk's float32 K rows. Prefill (flash) then single-position
  decode steps (KV append + int8 decode attention), and a multi-position
  continuation over the int8 cache.
- Greedy tokens through each package's Scheduler with kv_quant and
  fused_dequant on (prefill_chunk=None): identical ids and finish reasons.
- Fused on and off give identical greedy tokens in the port.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.engine import SamplingParams as JaxSampling
from symmetry_tpu.engine.scheduler import GenRequest as JaxRequest
from symmetry_tpu.engine.scheduler import Scheduler as JaxScheduler
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu.models import forward as jax_forward
from symmetry_tpu.models import init_cache as jax_init_cache
from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.models.llama import forward_hidden as jax_forward_hidden
from symmetry_tpu.models.llama import logits_from_hidden as jax_logits
from symmetry_tpu.models.llama import pack_params as jax_pack_params
from symmetry_tpu.models.llama import quantize_params as jax_quantize_params
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models.llama import (
    forward,
    forward_hidden,
    init_cache,
    init_params,
    logits_from_hidden,
    pack_params,
    preset,
    quantize_params,
)
from symmetry_tpu_torch.ops.quant import PackedQuantizedTensor, QuantizedTensor

ATOL = 1e-4
ID_BASE = 0x4E00


def int8_weights(name, seed=0, packed=False):
    """JAX int8 params (norms and biases perturbed from a numpy seed) and
    the same weights as the port's dict."""
    jcfg = jax_preset(name)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.key(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    layers = tree["layers"]
    for key in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
        if key in layers:
            base = 0.0 if key.startswith("b") or jcfg.norm_plus_one else 1.0
            layers[key] = (base + 0.1 * rng.normal(
                size=layers[key].shape)).astype(np.float32)
    jparams = jax_quantize_params(jax.tree.map(jnp.asarray, tree))
    if packed:
        jparams = jax_pack_params(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, params


class TestForwardParity:
    @pytest.mark.parametrize("packed", [False, True])
    @pytest.mark.parametrize("name", ["tiny", "tiny-qwen", "tiny-gemma"])
    def test_prefill_then_decode(self, name, packed):
        jcfg, jparams, params = int8_weights(name, packed=packed)
        cfg = preset(name)
        if packed:
            assert isinstance(params["layers"]["wq"], PackedQuantizedTensor)
        rng = np.random.default_rng(1)
        B, S, T = 2, 16, 32
        tokens = rng.integers(0, jcfg.vocab_size, (B, S))
        seq_lens = np.array([16, 9], np.int32)

        jcache = jax_init_cache(jcfg, B, T, jnp.float32, quantized=True)
        jh, jcache = jax_forward_hidden(jparams, jcfg,
                                        jnp.asarray(tokens, jnp.int32),
                                        jcache, seq_lens=jnp.asarray(seq_lens),
                                        prefill_flash=True)
        cache = init_cache(cfg, B, T, torch.float32, quantized=True,
                           device="cpu")
        h, cache = forward_hidden(params, cfg, torch.from_numpy(tokens), cache,
                                  seq_lens=torch.from_numpy(seq_lens),
                                  prefill_flash=True)
        want = np.asarray(jax_logits(jparams, jcfg, jh))
        got = logits_from_hidden(params, cfg, h).numpy()
        for b, n in enumerate(seq_lens):
            np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL,
                                       rtol=0)
            # the rows quantized are the trunk's float32 K, which differs by
            # summation order: at most one step at a rounding boundary
            np.testing.assert_array_less(
                np.abs(cache.k.numpy()[:, b, :n].astype(np.int32)
                       - np.asarray(jcache.k)[:, b, :n]), 2)

        for step in range(4):
            nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
            jl, jcache = jax_forward(jparams, jcfg,
                                     jnp.asarray(nxt, jnp.int32), jcache)
            logits, cache = forward(params, cfg, torch.from_numpy(nxt), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"decode step {step}")
        np.testing.assert_array_equal(cache.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        for b, n in enumerate(np.asarray(jcache.lengths)):
            np.testing.assert_allclose(
                cache.k_scale.numpy()[:, b, :, :n],
                np.asarray(jcache.k_scale)[:, b, :, :n], rtol=1e-5, atol=0)

    @pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
    def test_continuation_over_int8_cache(self, name):
        """S > 1 without flash: quantize_kv writes and the masked gqa path
        with the scales folded in, then a second chunk."""
        jcfg, jparams, params = int8_weights(name, seed=2)
        cfg = preset(name)
        rng = np.random.default_rng(3)
        jcache = jax_init_cache(jcfg, 2, 32, jnp.float32, quantized=True)
        cache = init_cache(cfg, 2, 32, torch.float32, quantized=True,
                           device="cpu")
        for chunk in (rng.integers(0, 512, (2, 8)),
                      rng.integers(0, 512, (2, 5))):
            jl, jcache = jax_forward(jparams, jcfg,
                                     jnp.asarray(chunk, jnp.int32), jcache)
            logits, cache = forward(params, cfg, torch.from_numpy(chunk),
                                    cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0)

    def test_sliding_window_int8(self):
        jcfg, jparams, params = int8_weights("tiny", seed=4)
        jcfg = dataclasses.replace(jcfg, sliding_window=6)
        cfg = dataclasses.replace(preset("tiny"), sliding_window=6)
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, 512, (2, 16))
        jcache = jax_init_cache(jcfg, 2, 32, jnp.float32, quantized=True)
        cache = init_cache(cfg, 2, 32, torch.float32, quantized=True,
                           device="cpu")
        for chunk in (tokens, rng.integers(0, 512, (2, 1)),
                      rng.integers(0, 512, (2, 1))):
            jl, jcache = jax_forward(jparams, jcfg,
                                     jnp.asarray(chunk, jnp.int32), jcache)
            logits, cache = forward(params, cfg, torch.from_numpy(chunk),
                                    cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0)


class TestQuantizedInit:
    def test_init_quantized_leaves(self):
        cfg = preset("tiny")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, quantize=True)
        for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
            leaf = params["layers"][name]
            assert isinstance(leaf, QuantizedTensor), name
            assert leaf.q.dtype == torch.int8 and leaf.q.shape[0] == 2
            assert leaf.scale.shape == (2, leaf.q.shape[-1])
        assert isinstance(params["lm_head"], QuantizedTensor)
        assert params["embed"].dtype == torch.float32

    def test_quantize_then_pack_params(self):
        cfg = preset("tiny")
        params = quantize_params(init_params(
            cfg, torch.Generator().manual_seed(0), torch.float32))
        report = []
        pack_params(params, report=report)
        assert isinstance(params["layers"]["wq"], PackedQuantizedTensor)
        assert isinstance(params["lm_head"], PackedQuantizedTensor)
        # tiny's kv_dim (32) is narrower than one 64-column panel
        assert sorted(report) == [("layers/wk", "untileable"),
                                  ("layers/wv", "untileable")]
        with pytest.raises(NotImplementedError, match="item 14"):
            pack_params(params, mesh=object())


# ---------------------------------------------------------------------------
# Greedy serving through each package's Scheduler


class JaxIdTokenizer(JaxByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


PROMPTS = [list(range(7, 12)), list(range(40, 54)), list(range(100, 127))]
MAX_NEW = 12


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


def port_engine(params, block, fused):
    return InferenceEngine(preset("tiny"), params, IdTokenizer(512),
                           max_slots=2, max_seq_len=64,
                           prefill_buckets=(16, 32), cache_dtype=torch.float32,
                           decode_block=block, kv_quant=True,
                           fused_dequant=fused, device="cpu")


@pytest.fixture(scope="module")
def tiny_int8():
    _, jparams, params = int8_weights("tiny")
    return jparams, params


class TestSchedulerParity:
    @pytest.mark.parametrize("block", [1, 4])
    def test_greedy_tokens_identical_to_jax(self, tiny_int8, block):
        jparams, params = tiny_int8
        # the JAX engine packs its params dict in place: hand it a copy
        jparams = jax.tree.map(lambda a: a, jparams)
        jengine = JaxEngine(jax_preset("tiny"), jparams, JaxIdTokenizer(512),
                            max_slots=2, max_seq_len=64,
                            prefill_buckets=(16, 32), cache_dtype=jnp.float32,
                            decode_block=block, kv_quant=True,
                            fused_dequant=True, prefill_chunk=None)
        want = serve(JaxScheduler(jengine, debug_invariants=True), JaxRequest,
                     JaxSampling)
        engine = port_engine(params, block, fused=True)
        assert isinstance(engine.params["layers"]["wq"],
                          PackedQuantizedTensor)
        assert engine.state.cache.k.dtype == torch.int8
        got = serve(Scheduler(engine, debug_invariants=True), GenRequest,
                    SamplingParams)
        assert got == want
        for ids, reason in got:
            assert reason in ("length", "stop") and len(ids) >= 1

    def test_fused_on_off_identical(self, tiny_int8):
        _, params = tiny_int8
        outs = []
        for fused in (False, True):
            eng = port_engine(params, 1, fused)
            toks = [eng.prefill_and_insert(0, PROMPTS[1], SamplingParams())]
            toks += [int(eng.decode_step()[0]) for _ in range(11)]
            outs.append(toks)
        assert outs[0] == outs[1]
