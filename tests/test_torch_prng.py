"""Threefry keys and draws (ops/prng.py) against jax.random, and seeded
token streams through the port's Scheduler against the JAX engine's.

Key data, `split`, `fold_in`, 32-bit `bits` and `uniform` are held bit for
bit against the installed JAX at its defaults (jax_threefry_partitionable
on, 64-bit types off; both asserted, so a change of JAX's default shows as
a failure, not a drift). The Gumbel draw is -log(-log(u)): `torch.log` and
XLA's `log` may differ in the last bit, so each log is held within 2 ulp of
XLA's, and the composed noise within that inner error carried through the
outer log. Seeded requests -- several seeds, at temperature, top-p and
top-k settings, beside a greedy one -- give the JAX engine's tokens on
`tiny`: dense float32, int8 weights with an int8 KV cache, and chunked
prefill with the radix prefix cache; a resume with `rng_skip` gives both
the uninterrupted run's tail and the JAX engine's resume.
"""

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
from symmetry_tpu.models.llama import quantize_params as jax_quantize_params
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models.llama import preset
from symmetry_tpu_torch.ops import prng

ID_BASE = 0x4E00
SEEDS = [0, 1, 7, 1234, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, -1, -77,
         2**40 + 3, 2**63 - 1]


def jkey(seed):
    return jax.random.key(seed)


def data(jax_keys) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(jax.random.key_data(jax_keys)).astype(np.int64))


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 steps (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


class TestJaxDefaults:
    def test_partitionable_threefry_and_32_bit(self):
        assert jax.config.jax_threefry_partitionable is True
        assert jax.config.jax_enable_x64 is False


class TestKeys:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_key_data(self, seed):
        assert prng.key_data(seed) == tuple(
            int(v) for v in np.asarray(jax.random.key_data(jkey(seed))))

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("num", [1, 2, 3, 8, 64])
    def test_split(self, seed, num):
        want = data(jax.random.split(jkey(seed), num))
        got = prng.split(torch.tensor(prng.key_data(seed)), num)
        assert torch.equal(got, want)
        assert [tuple(int(v) for v in row) for row in want] == [
            tuple(int(v) for v in k)
            for k in prng.split_key(prng.key_data(seed), num)]

    def test_split_batched(self):
        """[B, 2] keys split in one pass as jax.vmap(split) does."""
        keys = jax.random.split(jkey(9), 16)
        want = data(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
        assert torch.equal(prng.split(data(keys), 3), want)

    @pytest.mark.parametrize("seed", SEEDS[:8])
    @pytest.mark.parametrize("datum", [0, 1, 5, 123456, 2**32 - 1])
    def test_fold_in(self, seed, datum):
        want = data(jax.random.fold_in(jkey(seed), datum))
        assert prng.fold_in_key(prng.key_data(seed), datum) == tuple(
            int(v) for v in want)

    def test_chain_of_splits(self):
        """The decode chain: 50 steps of (key, step key) = split(key)."""
        jk, k = jkey(3), torch.tensor(prng.key_data(3))
        for _ in range(50):
            jk, jstep = jax.random.split(jk)
            k, step = prng.split(k)
            assert torch.equal(step, data(jstep))
        assert torch.equal(k, data(jk))


class TestDraws:
    @pytest.mark.parametrize("seed", SEEDS[:6])
    @pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
    def test_bits(self, seed, n):
        want = np.asarray(jax.random.bits(jkey(seed), (n,))).astype(np.int64)
        got = prng.bits(torch.tensor(prng.key_data(seed)), n)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_bits_batched(self):
        keys = jax.random.split(jkey(11), 8)
        want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (64,)))(
            keys)).astype(np.int64)
        np.testing.assert_array_equal(prng.bits(data(keys), 64).numpy(), want)

    @pytest.mark.parametrize("seed", SEEDS[:6])
    @pytest.mark.parametrize("minval", [0.0, float(np.finfo(np.float32).tiny)])
    def test_uniform_bit_equal(self, seed, minval):
        want = np.asarray(jax.random.uniform(jkey(seed), (4096,),
                                             minval=minval, maxval=1.0))
        got = prng.uniform(torch.tensor(prng.key_data(seed)), 4096,
                           minval=minval).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))

    @pytest.mark.parametrize("seed", SEEDS[:6])
    def test_gumbel_within_two_ulp_per_log(self, seed):
        tiny = float(np.finfo(np.float32).tiny)
        key = torch.tensor(prng.key_data(seed))
        u = prng.uniform(key, 4096, minval=tiny)
        # each of the two logs within 2 ulp of XLA's on the same input
        inner_t = -torch.log(u)
        inner_j = np.asarray(-jnp.log(jnp.asarray(u.numpy())))
        assert ulps(inner_t.numpy(), inner_j).max() <= 2
        outer_t = -torch.log(torch.from_numpy(inner_j.copy()))
        outer_j = np.asarray(-jnp.log(jnp.asarray(inner_j)))
        assert ulps(outer_t.numpy(), outer_j).max() <= 2
        # composed: the inner error, carried through the outer log
        # (d log x = dx / x), plus 2 ulp of the result
        got = prng.gumbel(key, 4096).numpy().astype(np.float64)
        want = np.asarray(jax.random.gumbel(jkey(seed), (4096,))).astype(
            np.float64)
        bound = (2 * np.spacing(inner_j.astype(np.float32)) / inner_j
                 + 2 * np.spacing(np.abs(want).astype(np.float32)))
        assert (np.abs(got - want) <= bound).all()

    @pytest.mark.parametrize("seed", SEEDS[:6])
    def test_categorical(self, seed):
        rng = np.random.default_rng(seed & 0xFFFF)
        logits = (2 * rng.normal(size=(8, 64))).astype(np.float32)
        keys = jax.random.split(jkey(seed), 8)
        want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits))
        got = prng.categorical(data(keys), torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Seeded streams: the port's Scheduler against the JAX engine's


class JaxIdTokenizer(JaxByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


def settings(seed):
    """Three seeded requests (temperature; top-p; top-k) and a greedy one."""
    return [dict(temperature=0.8, seed=seed),
            dict(temperature=1.0, top_p=0.9, seed=seed + 1),
            dict(temperature=1.3, top_k=5, seed=seed + 2),
            dict()]


def serve(scheduler, request_cls, sampling_cls, prompts, kws, max_new):
    events = {i: [] for i in range(len(prompts))}
    done = {i: threading.Event() for i in range(len(prompts))}
    for i, (ids, kw) in enumerate(zip(prompts, kws)):
        def emit(ev, i=i):
            events[i].append(ev)
            if ev.done:
                done[i].set()
        scheduler.submit(request_cls(prompt_ids=list(ids),
                                     sampling=sampling_cls(**kw),
                                     max_new_tokens=max_new, emit=emit,
                                     id=f"r{i}"))
    scheduler.start()
    try:
        for ev in done.values():
            assert ev.wait(180), "request did not complete"
    finally:
        scheduler.stop()
    return [[ord(c) - ID_BASE for c in "".join(ev.text for ev in events[i])]
            for i in range(len(prompts))]


def weights(int8=False):
    jparams = jax_init_params(jax_preset("tiny"), jax.random.key(0),
                              jnp.float32)
    if int8:
        jparams = jax_quantize_params(jparams)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


@pytest.fixture(scope="module")
def dense():
    return weights()


@pytest.fixture(scope="module")
def int8():
    return weights(int8=True)


PROMPTS = [list(range(7, 12)), list(range(40, 54)), list(range(100, 127)),
           list(range(300, 309))]
BASE_KW = dict(max_slots=4, max_seq_len=64, prefill_buckets=(16, 32))


def both(jparams, params, kw, prompts=PROMPTS, max_new=10, seed=5,
         warmup=False):
    jparams = jax.tree.map(lambda a: a, jparams)  # the JAX engine packs
    jengine = JaxEngine(jax_preset("tiny"), jparams, JaxIdTokenizer(512),
                        cache_dtype=jnp.float32,
                        **{"prefill_chunk": None, **kw})
    engine = InferenceEngine(preset("tiny"), params, IdTokenizer(512),
                             cache_dtype=torch.float32, device="cpu", **kw)
    if warmup:
        engine.warmup()
    kws = settings(seed)
    want = serve(JaxScheduler(jengine, debug_invariants=True), JaxRequest,
                 JaxSampling, prompts, kws, max_new)
    got = serve(Scheduler(engine, debug_invariants=True), GenRequest,
                SamplingParams, prompts, kws, max_new)
    return got, want


class TestSeededStreams:
    @pytest.mark.parametrize("seed", [5, 42, 2024])
    @pytest.mark.parametrize("block", [1, 4])
    def test_dense_equal_jax(self, dense, seed, block):
        got, want = both(*dense, dict(BASE_KW, decode_block=block),
                         seed=seed)
        assert got == want
        assert all(len(ids) == 10 for ids in got)

    @pytest.mark.parametrize("seed", [5, 99])
    def test_int8_equal_jax(self, int8, seed):
        got, want = both(*int8, dict(BASE_KW, decode_block=4, kv_quant=True,
                                     fused_dequant=True), seed=seed)
        assert got == want

    @pytest.mark.parametrize("seed", [5, 31])
    def test_chunked_prefix_cache_equal_jax(self, dense, seed):
        """Chunked prompts, then, on the same engines, a second wave that
        shares the first's prefixes: one-dispatch hits and seeded chunked
        hits draw from the same chains as in the JAX engine."""
        jparams, params = dense
        kw = dict(max_slots=4, max_seq_len=96, prefill_buckets=(16, 32, 64),
                  decode_block=4, prefill_chunk=8,
                  prefix_cache_bytes=16 * 2**20, prefix_block_tokens=8)
        jengine = JaxEngine(jax_preset("tiny"),
                            jax.tree.map(lambda a: a, jparams),
                            JaxIdTokenizer(512), cache_dtype=jnp.float32,
                            **kw)
        engine = InferenceEngine(preset("tiny"), params, IdTokenizer(512),
                                 cache_dtype=torch.float32, device="cpu",
                                 **kw)
        rng = np.random.default_rng(seed)
        wave1 = [rng.integers(0, 500, n).tolist() for n in (19, 30, 12, 40)]
        wave2 = [wave1[0][:16] + [7, 8], wave1[1][:24] + [9],
                 wave1[3][:16] + rng.integers(0, 500, 20).tolist(),
                 wave1[3][:32] + [11, 12, 13]]
        for i, wave in enumerate((wave1, wave2)):
            kws = settings(seed + 10 * i)
            want = serve(JaxScheduler(jengine, debug_invariants=True),
                         JaxRequest, JaxSampling, wave, kws, 8)
            got = serve(Scheduler(engine, debug_invariants=True), GenRequest,
                        SamplingParams, wave, kws, 8)
            assert got == want
        assert engine.prefix_index.stats()["hits"] >= 2


class TestResume:
    def test_rng_skip_equals_uninterrupted_and_jax(self, dense):
        """A seeded stream cut after 4 tokens and resumed with rng_skip=4
        (prompt + those tokens) gives the uninterrupted tail, and the JAX
        engine's resume gives the same."""
        jparams, params = dense
        kw = dict(BASE_KW, decode_block=1, prefill_chunk=None)
        sp = dict(temperature=1.0, top_k=20, seed=77)

        def run_port(prompt, n, **extra):
            eng = InferenceEngine(preset("tiny"), params, IdTokenizer(512),
                                  cache_dtype=torch.float32, device="cpu",
                                  **kw)
            toks = [eng.prefill_and_insert(0, prompt,
                                           SamplingParams(**sp, **extra))]
            return toks + [int(eng.decode_step()[0]) for _ in range(n - 1)]

        def run_jax(prompt, n, **extra):
            eng = JaxEngine(jax_preset("tiny"), jparams, JaxIdTokenizer(512),
                            cache_dtype=jnp.float32, **kw)
            toks = [eng.prefill_and_insert(0, prompt,
                                           JaxSampling(**sp, **extra))]
            return toks + [int(eng.decode_step()[0]) for _ in range(n - 1)]

        prompt = PROMPTS[1]
        full = run_port(prompt, 10)
        assert full == run_jax(prompt, 10)
        tail = run_port(prompt + full[:4], 6, rng_skip=4)
        assert tail == full[4:]
        assert run_jax(prompt + full[:4], 6, rng_skip=4) == tail
