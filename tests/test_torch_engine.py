"""The PyTorch engine + its Scheduler against the JAX engine + Scheduler.

Both engines get the same `tiny` weights (float32, JAX init converted with
params_from_numpy), 2 slots, buckets (16, 32) and prefill_chunk=None, and
both schedulers serve the same three greedy requests of different prompt
lengths. A test tokenizer maps every id to its own character, so the
streamed text carries the exact token ids: they must be identical, and so
must the finish reasons. Also here: every knob outside the slice raises
EngineError, tier roles and the probes build under their contracts,
fused_dequant refuses dense weights and counts the int8 leaves it leaves
flat, seeded sampling reproduces, and the package (the int8 modules
included) imports nothing of JAX.
"""

import dataclasses
import os
import subprocess
import sys
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
from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec
from symmetry_tpu_torch.engine.engine import (
    EngineError,
    InferenceEngine,
    SamplingParams,
)
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models.llama import forward, init_cache, preset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ID_BASE = 0x4E00  # one printable character per token id


class JaxIdTokenizer(JaxByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_preset("tiny"), jax.random.key(0), jnp.float32))
    return tree, params_from_numpy(tree, device="cpu")


PROMPTS = [list(range(7, 12)), list(range(40, 54)), list(range(100, 127))]
MAX_NEW = 12


def serve(scheduler, request_cls, sampling_cls, prompts, max_new):
    """Submit every prompt, run to completion; per request: (ids, reason)."""
    events = {i: [] for i in range(len(prompts))}
    done = {i: threading.Event() for i in range(len(prompts))}
    for i, ids in enumerate(prompts):
        def emit(ev, i=i):
            events[i].append(ev)
            if ev.done:
                done[i].set()
        scheduler.submit(request_cls(prompt_ids=list(ids),
                                     sampling=sampling_cls(),
                                     max_new_tokens=max_new, emit=emit,
                                     id=f"r{i}"))
    scheduler.start()
    try:
        for ev in done.values():
            assert ev.wait(120), "request did not complete"
    finally:
        scheduler.stop()
    out = []
    for i in range(len(prompts)):
        text = "".join(ev.text for ev in events[i])
        out.append(([ord(c) - ID_BASE for c in text],
                    events[i][-1].finish_reason))
    return out


def port_engine(params, block, **kw):
    return InferenceEngine(preset("tiny"), params, IdTokenizer(512),
                           max_slots=2, max_seq_len=64,
                           prefill_buckets=(16, 32), cache_dtype=torch.float32,
                           decode_block=block, device="cpu", **kw)


class TestSchedulerParity:
    @pytest.mark.parametrize("block", [1, 4])
    def test_greedy_tokens_identical_to_jax(self, weights, block):
        tree, params = weights
        jengine = JaxEngine(jax_preset("tiny"), jax.tree.map(jnp.asarray, tree),
                            JaxIdTokenizer(512), max_slots=2, max_seq_len=64,
                            prefill_buckets=(16, 32), cache_dtype=jnp.float32,
                            decode_block=block, prefill_chunk=None)
        want = serve(JaxScheduler(jengine, debug_invariants=True), JaxRequest,
                     JaxSampling, PROMPTS, MAX_NEW)
        got = serve(Scheduler(port_engine(params, block),
                              debug_invariants=True),
                    GenRequest, SamplingParams, PROMPTS, MAX_NEW)
        assert got == want
        for ids, reason in got:
            assert reason in ("length", "stop")
            assert len(ids) >= 1

    def test_head_dim_96_greedy_identical_to_jax(self):
        """A head dim between the kernels' built sizes (96: HF configs
        carry 80, 96, 112 and 192) serves, and its greedy tokens equal the
        JAX engine's: the gates pass it (`flash.kernel_supports`,
        `decode_attention.kernel_supports`), so the card runs it too."""
        jcfg = dataclasses.replace(jax_preset("tiny"), head_dim=96)
        cfg = dataclasses.replace(preset("tiny"), head_dim=96)
        tree = jax.tree.map(np.asarray, jax_init_params(
            jcfg, jax.random.key(3), jnp.float32))
        jengine = JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                            JaxIdTokenizer(512), max_slots=2, max_seq_len=64,
                            prefill_buckets=(16, 32), cache_dtype=jnp.float32,
                            decode_block=1, prefill_chunk=None)
        want = serve(JaxScheduler(jengine, debug_invariants=True), JaxRequest,
                     JaxSampling, PROMPTS, MAX_NEW)
        engine = InferenceEngine(cfg, params_from_numpy(tree, device="cpu"),
                                 IdTokenizer(512), max_slots=2,
                                 max_seq_len=64, prefill_buckets=(16, 32),
                                 cache_dtype=torch.float32, device="cpu")
        got = serve(Scheduler(engine, debug_invariants=True), GenRequest,
                    SamplingParams, PROMPTS, MAX_NEW)
        assert got == want

    def test_engine_matches_own_forward_loop(self, weights):
        """Slot batching is invisible: engine greedy == a plain loop."""
        _, params = weights
        cfg = preset("tiny")
        engine = port_engine(params, 1)
        prompt = PROMPTS[1]
        got = [engine.prefill_and_insert(1, prompt, SamplingParams())]
        for _ in range(5):
            got.append(int(engine.decode_step()[1]))
        cache = init_cache(cfg, 1, 64, torch.float32, device="cpu")
        logits, cache = forward(params, cfg, torch.tensor([prompt]), cache)
        want = [int(logits[0, -1].argmax())]
        for _ in range(5):
            logits, cache = forward(params, cfg, torch.tensor([[want[-1]]]),
                                    cache)
            want.append(int(logits[0, 0].argmax()))
        assert got == want

    def test_coalesced_prefill_pads_rows(self, weights):
        """Three requests at bucket 16 (batch 4: one pad row replaying the
        last request) give the same first tokens as one at a time."""
        _, params = weights
        prompts = [[5, 6, 7], [8, 9], [10, 11, 12, 13]]
        many = InferenceEngine(preset("tiny"), params, IdTokenizer(512),
                               max_slots=4, max_seq_len=64,
                               prefill_buckets=(16,),
                               cache_dtype=torch.float32, device="cpu")
        firsts = many.prefill_and_insert_many(
            [(i, p, SamplingParams()) for i, p in enumerate(prompts)])
        one = port_engine(params, 1)
        assert firsts == [one.prefill_and_insert(0, p, SamplingParams())
                          for p in prompts]
        assert [many.slot_length(i) for i in range(3)] == [3, 2, 4]


class TestSampling:
    def test_seeded_requests_reproduce(self, weights):
        _, params = weights
        sp = SamplingParams(temperature=1.0, top_k=20, seed=1234)

        def run(engine, sampling, n):
            toks = [engine.prefill_and_insert(0, PROMPTS[0], sampling)]
            toks += [int(engine.decode_step()[0]) for _ in range(n - 1)]
            return toks

        a = run(port_engine(params, 1), sp, 8)
        assert a == run(port_engine(params, 1), sp, 8)
        # Another seed draws differently.
        assert a != run(port_engine(params, 1),
                        SamplingParams(temperature=1.0, top_k=20, seed=99), 8)

    def test_seeded_resume_continues_the_stream(self, weights):
        """A resume after 3 tokens prefills prompt + those 3 tokens with
        rng_skip=3 and samples exactly the uninterrupted run's tail."""
        _, params = weights
        sp = SamplingParams(temperature=1.0, top_k=20, seed=7)
        eng = port_engine(params, 1)
        full = [eng.prefill_and_insert(0, PROMPTS[0], sp)]
        full += [int(eng.decode_step()[0]) for _ in range(5)]
        eng2 = port_engine(params, 1)
        rs = SamplingParams(temperature=1.0, top_k=20, seed=7, rng_skip=3)
        tail = [eng2.prefill_and_insert(0, PROMPTS[0] + full[:3], rs)]
        tail += [int(eng2.decode_step()[0]) for _ in range(2)]
        assert tail == full[3:]


class TestEngineSurface:
    @pytest.mark.parametrize("knob,value,item", [
        # a data axis (the model axis serves: tests/test_torch_tp.py)
        ("mesh", Mesh(MeshSpec(data=2)), "item 14"),
        ("pipeline_microbatches", 2, "item 14"),
    ])
    def test_knobs_outside_the_slice_raise(self, weights, knob, value, item):
        _, params = weights
        with pytest.raises(EngineError, match=item):
            port_engine(params, 1, **{knob: value})

    @pytest.mark.parametrize("knob,value,contract", [
        ("role", "prefill", "prefill_chunk"),
        ("role", "decode", "prefix cache"),
        ("profile_sample", 4, None),
    ])
    def test_items_11_and_12_build_under_their_contracts(
            self, weights, knob, value, contract):
        """Tier roles and the probes (once refused as items 11 and 12)
        build; a tier role without what it needs raises the JAX engine's
        contract, and builds once given it."""
        _, params = weights
        if contract is not None:
            with pytest.raises(EngineError, match=contract):
                port_engine(params, 1, **{knob: value})
        engine = port_engine(params, 1, prefill_chunk=8,
                             prefix_cache_bytes=2**20,
                             prefix_block_tokens=8, **{knob: value})
        if knob == "role":
            assert engine.role == value and not engine.devprof.enabled
        else:
            assert engine.role == "unified"
            assert engine.devprof.sample_every == value

    @pytest.mark.parametrize("k_draft", [1, 4])
    def test_speculative_sets_engine_spec(self, weights, k_draft):
        """`speculative` (once refused as item 7) builds an engine with
        engine.spec set and a verify step; k_draft must fit the context."""
        from symmetry_tpu_torch.engine.spec import SpecConfig

        _, params = weights
        engine = port_engine(params, 1, speculative=SpecConfig(k_draft))
        assert engine.spec.k_draft == k_draft
        toks, n_emit = engine.verify_step(np.zeros((2, k_draft), np.int64),
                                          np.zeros((2,), np.int32))
        assert toks.shape == (1 + k_draft, 2) and n_emit.tolist() == [1, 1]
        with pytest.raises(EngineError, match="k_draft"):
            port_engine(params, 1, speculative=SpecConfig(k_draft=64))

    def test_fused_dequant_needs_int8_weights(self, weights):
        """The JAX engine's refusal: fused_dequant on dense weights would be
        silently inert, so it raises."""
        _, params = weights
        with pytest.raises(EngineError, match="int8"):
            port_engine(params, 1, fused_dequant=True)

    def test_untileable_leaves_stay_flat_and_are_counted(self, weights):
        """tiny's wk/wv (kv_dim 32) are narrower than one 64-column panel:
        they stay QuantizedTensors on the mixed dot, each logged and counted
        in sym_qmm_fallback_total{reason="untileable"}; the rest pack."""
        from symmetry_tpu_torch.models.llama import quantize_params
        from symmetry_tpu_torch.ops.quant import (PackedQuantizedTensor,
                                                  QuantizedTensor)
        from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

        _, params = weights
        counter = METRICS.counter(MetricName.QMM_FALLBACK,
                                  labels=("reason",))
        before = counter.value(reason="untileable")
        int8 = quantize_params({**params, "layers": dict(params["layers"])})
        engine = port_engine(int8, 1, fused_dequant=True, kv_quant=True)
        layers = engine.params["layers"]
        assert isinstance(layers["wk"], QuantizedTensor)
        assert isinstance(layers["wv"], QuantizedTensor)
        for name in ("wq", "wo", "wg", "wu", "wd"):
            assert isinstance(layers[name], PackedQuantizedTensor), name
        assert isinstance(engine.params["lm_head"], PackedQuantizedTensor)
        assert counter.value(reason="untileable") == before + 2
        # int8 payload + float32 scales, embedding excluded (untied)
        want = sum(t.numel() * t.element_size()
                   for leaf in (*layers.values(), engine.params["lm_head"],
                                engine.params["final_norm"])
                   for t in (leaf if isinstance(leaf, tuple) else (leaf,)))
        assert engine.weight_stream_bytes() == want
        assert engine.prefill_and_insert(0, [1, 2, 3], SamplingParams()) >= 0

    def test_no_cuda_raises_instead_of_falling_back(self, weights,
                                                     monkeypatch):
        _, params = weights
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(EngineError, match="CUDA"):
            InferenceEngine(preset("tiny"), params, IdTokenizer(512),
                            device="cuda")

    def test_host_api(self, weights):
        _, params = weights
        engine = port_engine(params, 4)
        engine.warmup()
        assert engine.bucket_for(3) == 16 and engine.bucket_for(17) == 32
        with pytest.raises(EngineError, match="exceeds"):
            engine.bucket_for(33)
        assert engine.prefill_batches_for(16) == (1, 2)
        assert engine.slot_capacity == 64
        assert engine.compile_cache_sizes() == {}
        n = sum(t.numel() for t in params["layers"].values())
        n += params["final_norm"].numel() + params["lm_head"].numel()
        assert engine.weight_stream_bytes() == 4 * n
        engine.prefill_and_insert(1, [1, 2, 3], SamplingParams())
        assert engine.slot_length(1) == 3
        toks = np.asarray(engine.decode_steps_dispatch())
        assert toks.shape == (4, 2) and engine.slot_length(1) == 7
        with pytest.raises(EngineError, match="decode_block=1"):
            engine.decode_step()
        with pytest.raises(EngineError, match="empty prompt"):
            engine.prefill_and_insert(0, [], SamplingParams())


def test_package_imports_nothing_of_jax():
    """Import every module of symmetry_tpu_torch in a fresh interpreter:
    no jax* module, no symmetry_tpu / symmetry_tpu.* module, and none of
    safetensors, transformers, ml_dtypes and aiohttp (absent on the card's
    machine; the proxy backend imports aiohttp when it starts) may load."""
    code = """
import importlib, pkgutil, sys
import symmetry_tpu_torch
names = [m.name for m in pkgutil.walk_packages(symmetry_tpu_torch.__path__,
                                               "symmetry_tpu_torch.")]
assert len(names) >= 77, names
for new in ("models.moe", "ops.quant", "ops.qmm", "ops.kv_append", "ops.decode_attention",
            "convert", "engine.host", "engine.prefix_cache", "provider.config",
            "protocol.keys", "engine.weights", "engine.safetensors_io",
            "engine.spec", "engine.spec.drafter", "engine.disagg",
            "engine.disagg.frames", "utils.devprof", "utils.compile_cache",
            "utils.json", "protocol.messages", "protocol.framing",
            "identity", "identity.identity", "identity.noise", "transport",
            "transport.base", "transport.memory", "transport.tcp",
            "transport.udp", "network", "network.peer", "network.relay",
            "network.dht", "network.natpunch", "server", "server.__main__",
            "server.tokens", "server.registry", "server.broker",
            "provider", "provider.__main__", "provider.provider",
            "provider.collect", "provider.backends",
            "provider.backends.base", "provider.backends.echo",
            "provider.backends.proxy", "provider.backends.tpu_native",
            "engine.disagg.broker", "engine.disagg.net",
            "engine.disagg.pool", "engine.disagg.node",
            "engine.disagg.autoscale", "client", "client.__main__",
            "client.client"):
    assert "symmetry_tpu_torch." + new in names, new
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "symmetry_tpu" or m.startswith("symmetry_tpu.")
             or m.split(".")[0] in ("safetensors", "transformers",
                                    "ml_dtypes", "aiohttp"))
print(len(names), bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
