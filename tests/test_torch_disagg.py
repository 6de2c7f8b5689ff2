"""Disaggregated prefill/decode in the PyTorch port, against the JAX package.

All on the CPU at `tiny` (float32 compute; float32 and int8 KV), the JAX
weights carried across by params_from_numpy:

- Frames: symmetry_tpu_torch/engine/disagg/frames.py is a copy of the JAX
  codec whose bfloat16 payloads travel as uint16 words. A frame the JAX
  package cuts decodes in the port's copy and the reverse, arrays and
  manifests equal, for float32, int8 with scales and bfloat16 (ml_dtypes on
  the JAX side), and the port re-encodes a JAX frame byte for byte.
- Role contracts (tests/test_disagg.py TestRoleContracts on the port).
- Identity: greedy token ids through a port prefill engine and a port decode
  engine equal a port unified run and the JAX unified run, with the same
  per-role Scheduler stats; a frame cut by the JAX prefill engine and
  adopted by the port's decode engine (and the reverse) gives the JAX
  unified run's tokens; the float32 logits of the first decode step after
  adoption agree with the JAX unified engine's within ATOL (1e-4, as
  tests/test_torch_model.py: only summation order differs); an adoption the
  budget rejects is still token-identical.
- The port's host over its pipe: `adopt` with no frame, a corrupt frame and
  a geometry mismatch each fail one request; `handoff` frames carry `p`,
  `blocks` and `shipped` (a repeated prompt ships the manifest only);
  `profile` replies with a path; `trace` carries a `device` component.
- Through the JAX provider: its `tpu.role: disagg` backend runs two port
  hosts (the `_host_argv` seam) and streams what a unified port host
  streams.
"""

import asyncio
import base64
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from symmetry_tpu.engine.disagg import decode_kv_handoff as jax_decode
from symmetry_tpu.engine.disagg import encode_kv_handoff as jax_encode
from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.engine import SamplingParams as JaxSampling
from symmetry_tpu.engine.scheduler import GenRequest as JaxRequest
from symmetry_tpu.engine.scheduler import Scheduler as JaxScheduler
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu.models import forward as jax_forward
from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.provider.backends.tpu_native import TpuNativeBackend
from symmetry_tpu.provider.config import ConfigManager as JaxConfigManager
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine.disagg import (
    BFloat16Array,
    FrameError,
    decode_frame,
    decode_kv_handoff,
    encode_frame,
    encode_kv_handoff,
)
from symmetry_tpu_torch.engine.engine import (
    EngineError,
    InferenceEngine,
    SamplingParams,
    from_numpy_plane,
    to_numpy_plane,
)
from symmetry_tpu_torch.engine.host import EngineHost
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models.llama import forward, preset
from symmetry_tpu_torch.provider.config import ConfigManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
ID_BASE = 0x4E00  # one printable character per token id
MAX_NEW = 6

PROMPTS = [
    list(b"hello world prefix!"),            # 19 tokens: p = 16
    list(b"hi"),                             # 2 tokens: routing-only
    list(b"a longer prompt that needs chunked prefill")[:30],  # p = 24,
                                             # multi-chunk at chunk 8
    list(b"hello world prefill"),            # shares a block with #0
]


class JaxIdTokenizer(JaxByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


def gqa_arrays(L=3, K=2, D=8, p=16, dtype=np.float32):
    rng = np.random.default_rng(0)
    return {"k": rng.standard_normal((L, 1, p, K, D)).astype(dtype),
            "v": rng.standard_normal((L, 1, p, K, D)).astype(dtype)}


def int8_arrays(L=2, K=4, D=4, p=8):
    rng = np.random.default_rng(1)
    return {"k": rng.integers(-127, 128, (L, 1, p, K, D), dtype=np.int8),
            "v": rng.integers(-127, 128, (L, 1, p, K, D), dtype=np.int8),
            "k_scale": rng.random((L, 1, K, p), dtype=np.float32),
            "v_scale": rng.random((L, 1, K, p), dtype=np.float32)}


# ---------------------------------------------------------------------------
# Frames


class TestFrames:
    @pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
    def test_frames_interchange_byte_for_byte(self, kind):
        """The same KV through each package's encoder gives the same bytes;
        each decodes the other's; the port re-encodes what it decoded into
        the JAX frame's bytes."""
        tokens = list(range(100, 140))
        quant = kind == "int8"
        if quant:
            arrays, p = int8_arrays(p=32), 32
        else:
            arrays, p = gqa_arrays(p=32), 32
        jax_arrays = dict(arrays)
        port_arrays = dict(arrays)
        if kind == "bfloat16":
            jax_arrays = {k: v.astype(ml_dtypes.bfloat16)
                          for k, v in arrays.items()}
            port_arrays = {k: v.view(np.uint16).view(BFloat16Array)
                           for k, v in jax_arrays.items()}
        kw = dict(kv_quant=quant, block_size=8, skip=[1])
        jbuf = jax_encode("r", tokens, p, jax_arrays, **kw)
        pbuf = encode_kv_handoff("r", tokens, p, port_arrays, **kw)
        assert pbuf == jbuf
        got = decode_kv_handoff(jbuf)
        want = jax_decode(pbuf)
        assert (got.request_id, got.tokens, got.p, got.block_size,
                got.kv_quant, got.digests, got.shipped) == (
            want.request_id, want.tokens, want.p, want.block_size,
            want.kv_quant, want.digests, want.shipped)
        assert got.shipped == [0, 2, 3]
        for j in got.shipped:
            for key, arr in got.blocks[j].items():
                ref = want.blocks[j][key]
                if kind == "bfloat16":
                    assert isinstance(arr, BFloat16Array)
                    assert ref.dtype == ml_dtypes.bfloat16
                    ref = ref.view(np.uint16)
                assert arr.dtype == ref.dtype and arr.shape == ref.shape
                np.testing.assert_array_equal(np.asarray(arr), ref)
        meta, arrays, flags = decode_frame(jbuf)
        assert encode_frame(meta, arrays, flags=flags) == jbuf

    def test_routing_only_frame_both_ways(self):
        buf = encode_kv_handoff("r0", [1, 2, 3], 0, None)
        assert buf == jax_encode("r0", [1, 2, 3], 0, None)
        h = decode_kv_handoff(buf)
        assert h.p == 0 and h.blocks == {} and h.tokens == (1, 2, 3)

    def test_rejects_what_the_jax_codec_rejects(self):
        buf = bytearray(encode_kv_handoff("c", list(range(20)), 16,
                                          gqa_arrays()))
        with pytest.raises(FrameError, match="truncated"):
            decode_kv_handoff(bytes(buf[:len(buf) // 2]))
        buf[len(buf) // 2] ^= 0xFF
        with pytest.raises(FrameError, match="checksum"):
            decode_kv_handoff(bytes(buf))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
    def test_planes_round_trip_through_numpy(self, dtype):
        t = (torch.randn((2, 1, 4, 2, 8)) * 50).to(dtype)
        a = to_numpy_plane(t)
        assert isinstance(a, BFloat16Array) == (dtype == torch.bfloat16)
        back = from_numpy_plane(a, torch.device("cpu"))
        assert back.dtype == dtype and torch.equal(back, t)


# ---------------------------------------------------------------------------
# Engines


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_preset("tiny"), jax.random.key(0), jnp.float32))
    return tree, params_from_numpy(tree, device="cpu")


GEOMETRY = dict(max_slots=4, max_seq_len=64, prefill_buckets=(16, 32),
                prefix_block_tokens=8)


def port_engine(weights, role="unified", cache_mb=16, chunk=8, **kw):
    return InferenceEngine(
        preset("tiny"), weights[1], IdTokenizer(512),
        cache_dtype=torch.float32, prefill_chunk=chunk,
        prefix_cache_bytes=int(cache_mb * 2**20), role=role, device="cpu",
        **GEOMETRY, **kw)


def jax_engine(weights, role="unified", cache_mb=16, chunk=8, **kw):
    return JaxEngine(
        jax_preset("tiny"), jax.tree.map(jnp.asarray, weights[0]),
        JaxIdTokenizer(512), cache_dtype=jnp.float32, prefill_chunk=chunk,
        prefix_cache_bytes=int(cache_mb * 2**20), role=role, **GEOMETRY,
        **kw)


def drive(sched, request_cls, sampling_cls, prompts, max_new=MAX_NEW,
          timeout=120):
    """Greedy requests one by one through a started scheduler; per request
    (token ids, finish reason, error)."""
    out = []
    for i, ids in enumerate(prompts):
        events, done = [], threading.Event()

        def emit(ev, events=events, done=done):
            events.append(ev)
            if ev.done:
                done.set()

        sched.submit(request_cls(prompt_ids=list(ids),
                                 sampling=sampling_cls(),
                                 max_new_tokens=max_new, emit=emit,
                                 id=f"r{i}"))
        assert done.wait(timeout), f"request {i} did not finish: {events}"
        text = "".join(ev.text for ev in events)
        out.append(([ord(c) - ID_BASE for c in text],
                    events[-1].finish_reason, events[-1].error))
    return out


def port_frame(engine, slot, req):
    """What the port host's handoff sink does (engine/host.py), without the
    ledger: the whole-block slot-lane KV, serialized blockwise."""
    n, PB = len(req.prompt_ids), engine.prefix_block
    p = PB * ((n - 1) // PB)
    arrays = None
    if p > 0:
        cache = engine.extract_slot_kv(slot, p)
        arrays = {"k": to_numpy_plane(cache.k[:, :, :p]),
                  "v": to_numpy_plane(cache.v[:, :, :p])}
        if engine.kv_quant:
            arrays["k_scale"] = to_numpy_plane(cache.k_scale[..., :p])
            arrays["v_scale"] = to_numpy_plane(cache.v_scale[..., :p])
    return encode_kv_handoff(req.id, req.prompt_ids, p, arrays,
                             kv_quant=engine.kv_quant, block_size=PB)


def jax_frame(engine, slot, req):
    """The JAX host's sink (tests/test_disagg.py host_style_handoff)."""
    n, PB = len(req.prompt_ids), engine.prefix_block
    p = PB * ((n - 1) // PB)
    arrays = None
    if p > 0:
        cache = engine.extract_slot_kv(slot, p)
        arrays = {"k": np.asarray(cache.k)[:, :, :p],
                  "v": np.asarray(cache.v)[:, :, :p]}
        if engine.kv_quant:
            arrays["k_scale"] = np.asarray(cache.k_scale)[:, :, :, :p]
            arrays["v_scale"] = np.asarray(cache.v_scale)[:, :, :, :p]
    return jax_encode(req.id, req.prompt_ids, p, arrays,
                      kv_quant=engine.kv_quant, block_size=PB)


def prefill_tier(engine, sched_cls, request_cls, sampling_cls, cut):
    """Run PROMPTS through a prefill-role engine; returns (frames by id,
    scheduler stats)."""
    frames, events = {}, []
    sched = sched_cls(engine, handoff=lambda slot, req, first: frames
                      .__setitem__(req.id, cut(engine, slot, req)))
    sched.start()
    try:
        for i, ids in enumerate(PROMPTS):
            sched.submit(request_cls(
                prompt_ids=list(ids), sampling=sampling_cls(),
                max_new_tokens=MAX_NEW, emit=events.append, id=f"r{i}"))
        deadline = time.monotonic() + 120
        while len(frames) < len(PROMPTS):
            assert time.monotonic() < deadline, (sorted(frames), events)
            time.sleep(0.02)
        stats = sched.stats()
    finally:
        sched.stop()
    assert not events  # no token event ever leaves the prefill tier
    return frames, stats


def decode_tier(engine, sched_cls, request_cls, sampling_cls, frames,
                decode):
    for i in range(len(PROMPTS)):
        h = decode(frames[f"r{i}"])
        if h.p:
            assert engine.adopt_prefix(h)
    sched = sched_cls(engine)
    sched.start()
    try:
        return drive(sched, request_cls, sampling_cls, PROMPTS), \
            sched.stats()
    finally:
        sched.stop()


@pytest.fixture(scope="module", params=[False, True], ids=["f32kv", "int8kv"])
def reference(request, weights):
    """(kv_quant, the JAX unified engine's greedy tokens, the port's)."""
    kv_quant = request.param
    want = drive_started(JaxScheduler(jax_engine(
        weights, cache_mb=0, kv_quant=kv_quant)), JaxRequest, JaxSampling)
    port = port_engine(weights, cache_mb=0, kv_quant=kv_quant)
    port.warmup()
    got = drive_started(Scheduler(port), GenRequest, SamplingParams)
    return kv_quant, want, got


def drive_started(sched, request_cls, sampling_cls):
    sched.start()
    try:
        return drive(sched, request_cls, sampling_cls, PROMPTS)
    finally:
        sched.stop()


class TestRoleContracts:
    def test_bad_role_rejected(self, weights):
        with pytest.raises(EngineError, match="unknown engine role"):
            port_engine(weights, role="disagg")

    def test_decode_role_requires_prefix_store(self, weights):
        with pytest.raises(EngineError, match="prefix cache"):
            port_engine(weights, role="decode", cache_mb=0)

    def test_prefill_role_requires_chunk(self, weights):
        with pytest.raises(EngineError, match="prefill_chunk"):
            port_engine(weights, role="prefill", chunk=None)

    def test_prefill_scheduler_requires_sink(self, weights):
        with pytest.raises(ValueError, match="handoff sink"):
            Scheduler(port_engine(weights, role="prefill"))

    def test_decode_pool_floor_matches_jax(self, weights):
        port = port_engine(weights, role="decode", cache_mb=1e-4)
        jeng = jax_engine(weights, role="decode", cache_mb=1e-4)
        assert port.block_pool.n_blocks == jeng.block_pool.n_blocks == 8

    def test_adoption_rejects_mismatches(self, weights):
        cfg = preset("tiny")
        L, K, D = cfg.num_layers, cfg.num_kv_heads, cfg.dim_per_head
        engine = port_engine(weights, role="decode")
        good = gqa_arrays(L=L, K=K, D=D, p=16)
        h = decode_kv_handoff(encode_kv_handoff(
            "x", list(range(20)), 16, gqa_arrays(L=L + 1, K=K, D=D, p=16)))
        with pytest.raises(EngineError, match="shape"):
            engine.adopt_prefix(h)
        for dtype in (np.float16, np.uint16):
            h = decode_kv_handoff(encode_kv_handoff(
                "x", list(range(20)), 16,
                {k: v.astype(dtype) for k, v in good.items()}))
            with pytest.raises(EngineError, match="dtype"):
                engine.adopt_prefix(h)
        h = decode_kv_handoff(encode_kv_handoff(
            "x", list(range(20)), 16,
            {k: v.view(np.uint16)[..., ::2].copy().view(BFloat16Array)
             for k, v in good.items()}))
        with pytest.raises(EngineError, match="bfloat16"):
            engine.adopt_prefix(h)
        h = decode_kv_handoff(encode_kv_handoff(
            "x", list(range(20)), 16, int8_arrays(L=L, K=K, D=D, p=16),
            kv_quant=True))
        with pytest.raises(EngineError, match="quantization"):
            engine.adopt_prefix(h)
        # non-whole-block prefix: adoption floors to whole engine blocks
        h = decode_kv_handoff(encode_kv_handoff(
            "y", list(range(100, 120)), 12, gqa_arrays(L=L, K=K, D=D, p=12)))
        assert engine.adopt_prefix(h) is True
        assert engine.prefix_index.match_len(list(range(100, 120))) == 8
        # a frame block straddling the pool's (bs 12 over PB 8) clips
        h = decode_kv_handoff(encode_kv_handoff(
            "z", list(range(200, 236)), 36, gqa_arrays(L=L, K=K, D=D, p=36),
            block_size=12))
        assert engine.adopt_prefix(h) is True
        assert engine.prefix_index.match_len(list(range(200, 236))) == 32
        h = decode_kv_handoff(encode_kv_handoff("x", list(range(20)), 16,
                                                good))
        assert engine.adopt_prefix(h) is True
        assert engine.adopt_prefix(h) is True  # idempotent (resident)
        h_skip = decode_kv_handoff(encode_kv_handoff(
            "x", list(range(20)), 16, good, block_size=8, skip=[0, 1]))
        assert engine.adopt_prefix(h_skip) is True  # by reference
        fresh = port_engine(weights, role="decode")
        assert fresh.adopt_prefix(h_skip) is False
        routing = decode_kv_handoff(encode_kv_handoff("w", [1, 2], 0, None))
        assert fresh.adopt_prefix(routing) is False

    def test_adopted_blocks_hold_the_frame(self, weights):
        """The pool holds exactly the frame's planes after adoption, and a
        lookup hits at the adopted length (int8 with scales)."""
        cfg = preset("tiny")
        L, K, D = cfg.num_layers, cfg.num_kv_heads, cfg.dim_per_head
        engine = port_engine(weights, role="decode", kv_quant=True)
        arrays = int8_arrays(L=L, K=K, D=D, p=16)
        tokens = list(range(300, 320))
        assert engine.adopt_prefix(decode_kv_handoff(encode_kv_handoff(
            "q", tokens, 16, arrays, kv_quant=True, block_size=8)))
        hit = engine.prefix_lookup(tokens)
        try:
            assert hit.length == 16
            pool = engine._pool_kv
            for j, block in enumerate(hit.blocks):
                sl = slice(8 * j, 8 * j + 8)
                assert np.array_equal(pool.k[:, block].numpy(),
                                      arrays["k"][:, 0, sl])
                assert np.array_equal(pool.v_scale[:, block].numpy(),
                                      arrays["v_scale"][:, 0, :, sl])
        finally:
            hit.release()


class TestDisaggIdentity:
    def test_port_unified_equals_jax_unified(self, reference):
        _, want, got = reference
        assert got == want
        assert all(r[1] in ("length", "stop") and r[2] is None for r in got)

    def test_port_tiers_equal_unified_with_per_role_stats(self, weights,
                                                          reference):
        kv_quant, want, _ = reference
        eng_p = port_engine(weights, role="prefill", kv_quant=kv_quant)
        eng_p.warmup()
        eng_d = port_engine(weights, role="decode", kv_quant=kv_quant)
        eng_d.warmup()
        frames, ps = prefill_tier(eng_p, Scheduler, GenRequest,
                                  SamplingParams, port_frame)
        assert ps["role"] == "prefill"
        assert ps["handoffs"] == len(PROMPTS) and ps["handoff_s"] > 0
        assert ps["block_syncs"] == 0 and ps["tokens"] == 0
        got, ds = decode_tier(eng_d, Scheduler, GenRequest, SamplingParams,
                              frames, decode_kv_handoff)
        assert got == want
        assert ds["role"] == "decode"
        # A decode host books adoption dispatches; the only admit dispatch
        # is the routing-only prompt's full prefill.
        assert ds["adopt_dispatches"] >= 2
        assert ds["admit_dispatches"] == 1
        assert ds["adopt_s"] > 0 and "adopt_dispatch_s" in ds

    def test_jax_frames_adopted_by_the_port(self, weights, reference):
        kv_quant, want, _ = reference
        frames, _ = prefill_tier(
            jax_engine(weights, role="prefill", kv_quant=kv_quant),
            JaxScheduler, JaxRequest, JaxSampling, jax_frame)
        eng_d = port_engine(weights, role="decode", kv_quant=kv_quant)
        got, _ = decode_tier(eng_d, Scheduler, GenRequest, SamplingParams,
                             frames, decode_kv_handoff)
        assert got == want

    def test_port_frames_adopted_by_jax(self, weights, reference):
        kv_quant, want, _ = reference
        eng_p = port_engine(weights, role="prefill", kv_quant=kv_quant)
        frames, _ = prefill_tier(eng_p, Scheduler, GenRequest,
                                 SamplingParams, port_frame)
        got, _ = decode_tier(
            jax_engine(weights, role="decode", kv_quant=kv_quant),
            JaxScheduler, JaxRequest, JaxSampling, frames, jax_decode)
        assert got == want

    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_first_decode_logits_after_adoption(self, weights, kv_quant):
        """A JAX prefill engine's frame adopted by the port's decode engine:
        the first token equals the JAX unified engine's, and the float32
        logits of the next decode step agree within ATOL."""
        prompt = PROMPTS[2]
        jp = jax_engine(weights, role="prefill", kv_quant=kv_quant)
        jp.prefill_and_insert(1, prompt, JaxSampling())
        frame = jax_frame(jp, 1, SimpleNamespace(prompt_ids=prompt, id="q"))
        port = port_engine(weights, role="decode", kv_quant=kv_quant)
        assert port.adopt_prefix(decode_kv_handoff(frame))
        hit = port.prefix_lookup(prompt)
        assert hit.length == 24
        first = port.prefill_and_insert_cached(
            [(0, prompt, SamplingParams())], hit)[0]
        ju = jax_engine(weights, cache_mb=0, kv_quant=kv_quant)
        assert first == ju.prefill_and_insert(0, prompt, JaxSampling())
        st, jst = port.state, ju.state
        logits, _ = forward(port.params, port.config,
                            st.last_token[:, None], st.cache)
        jlogits, _ = jax_forward(ju.params, ju.config,
                                 jst.last_token[:, None], jst.cache)
        np.testing.assert_allclose(logits[0, 0].numpy(),
                                   np.asarray(jlogits)[0, 0],
                                   atol=ATOL, rtol=0)

    def test_budget_rejected_adoption_still_token_identical(self, weights,
                                                            reference):
        kv_quant, want, _ = reference
        eng_d = port_engine(weights, role="decode", cache_mb=1e-4,
                            kv_quant=kv_quant)
        assert eng_d.block_pool.budget_bytes >= \
            2 * 32 * eng_d.kv_bytes_per_token()
        # No headroom: every block allocated outside the tree, so nothing
        # is evictable and plan_insert rejects.
        eng_d.block_pool.alloc(eng_d.block_pool.free_count)
        eng_d.warmup()
        cfg = preset("tiny")
        arrays = (int8_arrays if kv_quant else gqa_arrays)(
            L=cfg.num_layers, K=cfg.num_kv_heads, D=cfg.dim_per_head, p=16)
        # random planes, not the prompt's KV: adopting them would change
        # the text
        h = decode_kv_handoff(encode_kv_handoff(
            "r0", PROMPTS[0], 16, arrays, kv_quant=kv_quant))
        assert eng_d.adopt_prefix(h) is False
        sched = Scheduler(eng_d)
        sched.start()
        try:
            got = drive(sched, GenRequest, SamplingParams, [PROMPTS[0]])
        finally:
            sched.stop()
        assert got[0] == want[0]


# ---------------------------------------------------------------------------
# The port's host over its pipe


class Stdin:
    def __init__(self):
        import queue

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
                lambda: any(pred(f) for f in self.frames), timeout), \
                f"no matching frame in {self.frames[-3:]}"
            return next(f for f in self.frames if pred(f))


# Blocks of 32 tokens: "hi" under the chat template is 21 tokens, no whole
# block, so the prefill host routes it without a prefill.
TPU = {"model_preset": "tiny", "dtype": "float32", "max_batch_size": 2,
       "max_seq_len": 256, "prefill_buckets": [32, 64, 128, 256],
       "prefill_chunk": 32, "decode_block": 4, "prefix_block_tokens": 32,
       "compile_cache": False}


def host_config(tpu, cls=ConfigManager):
    return cls(config={
        "name": "port-host", "public": False, "serverKey": "00" * 32,
        "modelName": "tiny:test", "apiProvider": "tpu_native",
        "dataCollectionEnabled": False, "tpu": {**TPU, **tpu}})


def done_events(frames, req_id):
    out = []
    for f in frames.frames:
        evs = [f] if f.get("op") == "event" else f.get("events", [])
        out += [e for e in evs if e.get("id") == req_id]
    return out


class HostThread:
    def __init__(self, tpu):
        self.stdin, self.out = Stdin(), Stdout()
        self.host = EngineHost(host_config(tpu), device="cpu", out=self.out)
        self.thread = threading.Thread(
            target=self.host.serve_forever, args=(self.stdin,), daemon=True)
        self.thread.start()
        self.ready = self.out.wait_for(lambda f: f.get("op") == "ready")

    def stop(self):
        self.stdin.send({"op": "shutdown"})
        self.thread.join(60)
        assert not self.thread.is_alive()

    def text(self, req_id):
        self.out.wait_for(lambda f: any(
            e.get("done") for e in done_events(self.out, req_id)))
        evs = done_events(self.out, req_id)
        return "".join(e["text"] for e in evs), evs[-1]


class TestHostPipe:
    LONG = ("please summarize this rather long message so that its prompt "
            "spans several prefill chunks of the engine")

    def test_tier_pair_over_the_pipe(self, tmp_path):
        """Submits to a prefill host, each `handoff` frame piped into a
        decode host's `adopt` (as the broker does): the text equals a
        unified host's; a repeated prompt ships only its manifest; bad
        adopt ops fail their own request; profile and trace answer."""
        messages = [[{"role": "user", "content": "hi"}],
                    [{"role": "user", "content": self.LONG}],
                    [{"role": "user", "content": self.LONG}]]
        unified = HostThread({"prefix_cache_mb": 1})
        try:
            want = []
            for i, m in enumerate(messages):
                unified.stdin.send({"op": "submit", "id": f"u{i}",
                                    "messages": m, "max_new": 8,
                                    "sampling": {"temperature": 0.0}})
                want.append(unified.text(f"u{i}")[0])
        finally:
            unified.stop()
        pre = HostThread({"role": "prefill", "prefix_cache_mb": 1})
        dec = HostThread({"role": "decode", "prefix_cache_mb": 1,
                          "profile_sample": 1})
        try:
            assert (pre.ready["role"], dec.ready["role"]) == ("prefill",
                                                              "decode")
            got, handoffs = [], []
            for i, m in enumerate(messages):
                pre.stdin.send({"op": "submit", "id": f"d{i}",
                                "messages": m, "max_new": 8,
                                "sampling": {"temperature": 0.0}})
                h = pre.out.wait_for(lambda f, i=i: f.get("op") == "handoff"
                                     and f.get("id") == f"d{i}")
                handoffs.append(h)
                dec.stdin.send({"op": "adopt", "id": h["id"],
                                "frame": h["frame"], "max_new": 8,
                                "sampling": {"temperature": 0.0}})
                got.append(dec.text(f"d{i}")[0])
            assert got == want and all(got)
            assert handoffs[0]["p"] == 0 and handoffs[0]["blocks"] == 0
            assert handoffs[1]["p"] > 0
            assert handoffs[1]["shipped"] == handoffs[1]["blocks"] > 0
            assert handoffs[2]["blocks"] == handoffs[1]["blocks"]
            assert handoffs[2]["shipped"] == 0  # manifest only

            # Bad adopt ops: each fails its own request only.
            frame = base64.b64decode(handoffs[1]["frame"])
            corrupt = bytearray(frame)
            corrupt[len(corrupt) // 2] ^= 0xFF
            # three layers where tiny has two
            wrong = encode_kv_handoff(
                "g", list(range(40)), 32,
                gqa_arrays(L=3, K=2, D=16, p=32), block_size=32)
            for rid, b64, why in (
                    ("e0", None, "carries no frame"),
                    ("e1", base64.b64encode(bytes(corrupt)).decode(),
                     "checksum"),
                    ("g", base64.b64encode(wrong).decode(), "shape")):
                msg = {"op": "adopt", "id": rid, "max_new": 4}
                if b64 is not None:
                    msg["frame"] = b64
                dec.stdin.send(msg)
                _, last = dec.text(rid)
                assert last["finish_reason"] == "error"
                assert "handoff adoption failed" in last["error"]
                assert why in last["error"]

            dec.stdin.send({"op": "stats"})
            stats = dec.out.wait_for(lambda f: f.get("op") == "stats")
            assert stats["role"] == "decode"
            assert stats["adopt"]["frames"] == 3
            assert stats["adopt"]["errors"] == 3
            assert stats["adopt"]["adopted"] == 2
            assert stats["devprof"]["probes"]["decode_block"] > 0
            assert stats["devprof"]["probes"]["adopt"] >= 1
            pre.stdin.send({"op": "stats"})
            pstats = pre.out.wait_for(lambda f: f.get("op") == "stats")
            assert pstats["handoff"]["frames"] == 3
            assert pstats["handoff"]["routing_only"] == 1
            assert pstats["handoff"]["blocks_shipped"] == \
                handoffs[1]["blocks"]

            dec.stdin.send({"op": "trace"})
            trace = dec.out.wait_for(lambda f: f.get("op") == "trace")
            names = [c["name"] for c in trace["components"]]
            assert names[-1] == "device" and len(names) == 3
            spans = {s["name"] for s in trace["components"][-1]["spans"]}
            assert {"decode_block", "adopt", "dispatch_gap"} <= spans

            dec.stdin.send({"op": "profile", "duration_s": 0.05,
                            "dir": str(tmp_path)})
            prof = dec.out.wait_for(lambda f: f.get("op") == "profile")
            assert os.path.isfile(os.path.join(prof["path"], "trace.json"))
            assert prof["path"].startswith(str(tmp_path))
        finally:
            pre.stop()
            dec.stop()


# ---------------------------------------------------------------------------
# Through the JAX provider's disagg backend


class PortHostBackend(TpuNativeBackend):
    def _host_argv(self, cfg_path):
        return [sys.executable, "-m", "symmetry_tpu_torch.engine.host",
                cfg_path, "--device", "cpu"]


def backend_texts(role, contents):
    from symmetry_tpu.provider.backends.base import InferenceRequest

    cfg = JaxConfigManager(config={
        "name": "disagg-id", "public": False, "serverKey": "00" * 32,
        "modelName": "tiny:test", "apiProvider": "tpu_native",
        "dataCollectionEnabled": False,
        "tpu": {"model_preset": "tiny", "dtype": "float32",
                "max_batch_size": 4, "max_seq_len": 128,
                "prefill_buckets": [32, 64], "prefill_chunk": 16,
                "engine_isolation": "process", "role": role,
                "compile_cache": False}})

    async def go():
        backend = PortHostBackend(cfg)
        await backend.start()
        try:
            out = []
            for content in contents:
                text = []
                async for chunk in backend.stream(InferenceRequest(
                        messages=[{"role": "user", "content": content}],
                        max_tokens=8, temperature=0.0)):
                    if chunk.text:
                        text.append(chunk.text)
                out.append("".join(text))
            return out, await backend.engine_stats()
        finally:
            await backend.stop()

    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(go(), 240))


def test_provider_disagg_backend_runs_two_port_hosts(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    contents = ["tell me about disagg serving", "hi"]
    unified, _ = backend_texts("unified", contents)
    disagg, stats = backend_texts("disagg", contents)
    assert disagg == unified and all(unified)
    dg = stats.get("disagg") or {}
    assert dg.get("handoff_frames") == 2
    assert dg.get("handoff_bytes", 0) > 0
    assert (dg.get("prefill_host") or {}).get("role") == "prefill"
