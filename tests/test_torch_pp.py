"""The `stage` mesh axis in the port (parallel/pipeline.py) against the JAX
package on its CPU mesh.

The JAX references run here on the conftest's virtual CPU devices
(`build_mesh(MeshSpec(stage=2))`, params sharded with PIPELINE_RULES). The
port's ranks are processes (tests/torch_tp_worker.py) joined by
torch.distributed over gloo on the CPU: each stage rank holds its block of
the layers of the params and of every cache, runs them over each
microbatch and hands the activation to the next stage; rank 0's
Scheduler drives both ranks through the command loop. One spawn of two
ranks runs every job.

  - pipeline_forward_hidden at 1 and 2 microbatches, dense and int8 KV
    cache: logits within 1e-5 of the JAX pipeline's (float32); each rank's
    cache block is the JAX stage block (bit-equal to one port rank's layer
    at one microbatch);
  - greedy Scheduler tokens (chunked and coalesced prefill, prefix hits)
    equal the JAX engine's at {stage: 2}, with 1 and 2 microbatches; a
    seeded stream; int8 weights + int8 KV + fused_dequant, which degrades
    on both packages with QMM_FALLBACK{reason="stage_axis"};
  - every rank records the same tokens; a rank's decode cache and prefix
    pool hold its layer; weight_stream_bytes_per_device equals the JAX
    engine's (279,296 B for `tiny` in float32);
  - one call of each dispatching kind through the facade (speculative
    verify included) gives one rank's outputs;
  - sharded cold and warm loads, bf16 and int8, are a one-rank load's
    layer blocks;
  - the engine host and a `--worker` rank serve at {stage: 2}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu.models import llama as jax_llama
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.parallel import MeshSpec as JaxMeshSpec
from symmetry_tpu.parallel import build_mesh as jax_build_mesh
from symmetry_tpu.parallel import shardings_for as jax_shardings_for
from symmetry_tpu.parallel.pipeline import PIPELINE_RULES as JAX_PP_RULES
from symmetry_tpu.parallel.pipeline import (
    pipeline_forward_hidden as jax_pipeline)
from symmetry_tpu.utils.metrics import METRICS as JAX_METRICS
from symmetry_tpu.utils.metrics import MetricName as JaxMetricName
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine import weights
from symmetry_tpu_torch.engine.engine import EngineError, InferenceEngine
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models import llama
from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec
from symmetry_tpu_torch.parallel.pipeline import pipeline_forward_hidden
from symmetry_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                  PIPELINE_RULES, mesh_rules)
from test_torch_dp import SEEDED, serve_together
from test_torch_tp import (HostProc, children, gone, jax_serve, jax_tree,
                           load_out, run_ranks, to_npz)

STAGE = {"stage": 2}
GEOMETRY = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
                decode_block=2, prefill_chunk=16, prefix_cache_bytes=2**20)
MICRO = (1, 2)
ATOL = 1e-5
_rng = np.random.default_rng(0)
PP_TOKENS = _rng.integers(0, 512, (4, 16))
PP_LENS = [16, 9, 16, 4]
PP_STEPS = _rng.integers(0, 512, (4, 3))


def jax_stage_mesh():
    return jax_build_mesh(JaxMeshSpec(stage=2), jax.devices()[:2])


def jax_pp_params(tree, cfg, mesh, *, quantized=False):
    """The JAX tree placed as the JAX engine serves a stage axis: layers
    over `stage` (PIPELINE_RULES)."""
    axes = jax_llama.param_logical_axes(cfg)
    if quantized:
        axes = jax_llama.quantized_logical_axes(axes)
    return jax.device_put(jax.tree.map(jnp.asarray, tree),
                          jax_shardings_for(axes, mesh, JAX_PP_RULES))


@functools.lru_cache(maxsize=None)
def jax_pipeline_fn(n_micro: int):
    cfg, mesh = jax_preset("tiny"), jax_stage_mesh()
    return jax.jit(lambda p, t, c, s: jax_pipeline(
        p, cfg, t, c, mesh, s, n_microbatches=n_micro))


def jax_pipeline_ref(tree, n_micro: int, kv_quant: bool):
    """The JAX pipeline's prefill of PP_TOKENS then three decode steps:
    (prefill logits, step logits [3, B, 1, V], the cache)."""
    cfg = jax_preset("tiny")
    params = jax_pp_params(tree, cfg, jax_stage_mesh())
    fn = jax_pipeline_fn(n_micro)
    cache = jax_llama.init_cache(cfg, 4, 16 + 3, jnp.float32,
                                 quantized=kv_quant)
    h, cache = fn(params, jnp.asarray(PP_TOKENS, jnp.int32), cache,
                  jnp.asarray(PP_LENS, jnp.int32))
    logits = [np.asarray(jax_llama.logits_from_hidden(params, cfg, h))]
    for i in range(PP_STEPS.shape[1]):
        h, cache = fn(params, jnp.asarray(PP_STEPS[:, i:i + 1], jnp.int32),
                      cache, jnp.full((4,), 1, jnp.int32))
        logits.append(np.asarray(jax_llama.logits_from_hidden(params, cfg,
                                                               h)))
    return logits[0], np.stack(logits[1:]), jax.tree.map(np.asarray, cache)


def jax_pipeline_hidden(tree, n_micro: int, kv_quant: bool):
    """The JAX pipeline's hidden states over the same calls: (prefill,
    steps [3, B, 1, E])."""
    cfg = jax_preset("tiny")
    params = jax_pp_params(tree, cfg, jax_stage_mesh())
    fn = jax_pipeline_fn(n_micro)
    cache = jax_llama.init_cache(cfg, 4, 16 + 3, jnp.float32,
                                 quantized=kv_quant)
    h, cache = fn(params, jnp.asarray(PP_TOKENS, jnp.int32), cache,
                  jnp.asarray(PP_LENS, jnp.int32))
    steps = []
    for i in range(PP_STEPS.shape[1]):
        hs, cache = fn(params, jnp.asarray(PP_STEPS[:, i:i + 1], jnp.int32),
                       cache, jnp.full((4,), 1, jnp.int32))
        steps.append(np.asarray(hs))
    return np.asarray(h), np.stack(steps)


def port_forward_ref(tree, kv_quant: bool, flash: bool = False):
    """One port rank's forward_hidden over the same inputs: (prefill h,
    step h [3, B, 1, E], cache)."""
    cfg = llama.preset("tiny")
    params = params_from_numpy(tree, device="cpu")
    cache = llama.init_cache(cfg, 4, 16 + 3, torch.float32, device="cpu",
                             quantized=kv_quant)
    h, cache = llama.forward_hidden(params, cfg, torch.from_numpy(PP_TOKENS),
                                    cache, torch.tensor(PP_LENS,
                                                        dtype=torch.int32),
                                    prefill_flash=flash)
    steps = []
    for i in range(PP_STEPS.shape[1]):
        hs, cache = llama.forward_hidden(
            params, cfg, torch.from_numpy(PP_STEPS[:, i:i + 1]), cache)
        steps.append(hs.numpy())
    return h.numpy(), np.stack(steps), cache


def port_logits(tree, h: np.ndarray) -> np.ndarray:
    cfg = llama.preset("tiny")
    params = params_from_numpy(tree, device="cpu")
    return llama.logits_from_hidden(params, cfg, torch.from_numpy(h)).numpy()


def pipeline_job(name, weights_file, micro, kv_quant, flash=False) -> dict:
    return dict(name=name, kind="pipeline", preset="tiny",
                weights=weights_file, tokens=PP_TOKENS.tolist(),
                seq_lens=PP_LENS, steps=PP_STEPS.shape[1],
                step_tokens=PP_STEPS.tolist(), micro=micro,
                kv_quant=kv_quant, flash=flash)


def engine_job(name: str, weights_file: str, **engine) -> dict:
    from test_torch_tp import MAX_NEW, PROMPTS

    return dict(kind="engine", name=name, preset="tiny",
                weights=weights_file, prompts=PROMPTS, max_new=MAX_NEW,
                rounds=2, engine={k: list(v) if isinstance(v, tuple) else v
                                  for k, v in {**GEOMETRY, **engine}.items()})


@pytest.fixture(scope="module")
def trees():
    return {"tiny": jax_tree("tiny", 0),
            "int8": jax_tree("tiny", 0, quantize=True)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A float32 `tiny` checkpoint (2 shards) with bf16 and int8 warm
    caches written by single-rank loads."""
    path = str(tmp_path_factory.mktemp("pp_ckpt"))
    cfg = llama.preset("tiny")
    weights.save_checkpoint(path, llama.init_params(
        cfg, torch.Generator().manual_seed(5), torch.float32), cfg, shards=2)
    for quantize in (False, True):
        full, got = weights.load_checkpoint(path, dtype=torch.bfloat16,
                                            quantize=quantize, device="cpu")
        weights.save_warm_cache(path, full, got, dtype=torch.bfloat16,
                                quantize=quantize)
    return path


@pytest.fixture(scope="module")
def stage2(tmp_path_factory, trees, ckpt):
    from test_torch_tp import GEOMETRY as TP_GEOMETRY

    tmp = tmp_path_factory.mktemp("pp2")
    files = {k: to_npz(t, str(tmp / f"{k}.npz")) for k, t in trees.items()}
    jobs = [pipeline_job(f"pp_m{m}_{'q' if q else 'f'}", files["tiny"], m, q)
            for m in MICRO for q in (False, True)]
    jobs.append(pipeline_job("pp_flash", files["tiny"], 2, False, True))
    for m in MICRO:
        jobs += [
            engine_job(f"serve_f32_m{m}", files["tiny"],
                       pipeline_microbatches=m),
            engine_job(f"serve_int8_m{m}", files["int8"], kv_quant=True,
                       fused_dequant=True, pipeline_microbatches=m)]
    jobs.append(dict(engine_job("serve_seeded", files["tiny"],
                                pipeline_microbatches=2), sampling=SEEDED))
    jobs.append(dict(name="direct", kind="direct", preset="tiny",
                     weights=files["tiny"], engine={
                         **{k: list(v) if isinstance(v, tuple) else v
                            for k, v in TP_GEOMETRY.items()},
                         "pipeline_microbatches": 2}))
    jobs += [dict(name=f"load_{'warm' if warm else 'cold'}_"
                       f"{'int8' if quantize else 'bf16'}", kind="load",
                  path=ckpt, dtype="bfloat16", quantize=quantize, warm=warm)
             for warm in (False, True) for quantize in (False, True)]
    out = run_ranks(tmp, jobs, world=2, mesh=STAGE)
    return types.SimpleNamespace(out=out)


def stage_mesh(rank: int) -> Mesh:
    """A rank's view of {stage: 2}, for shape arithmetic (no group)."""
    return Mesh(MeshSpec(stage=2), rank=rank)


class TestRules:
    def test_pipeline_rules_equal_jax(self):
        assert PIPELINE_RULES == JAX_PP_RULES
        assert mesh_rules(stage_mesh(0)) is PIPELINE_RULES
        assert mesh_rules(Mesh(MeshSpec(model=2))) is DEFAULT_RULES
        assert mesh_rules(None) is DEFAULT_RULES

    @pytest.mark.parametrize("quantized", [False, True])
    def test_stage_blocks_equal_named_sharding(self, trees, quantized):
        """Every leaf of a stage rank's params (int8 scales included) is
        the block NamedSharding gives the device at its place on the JAX
        stage mesh."""
        cfg = jax_preset("tiny")
        mesh = jax_stage_mesh()
        tree = trees["int8" if quantized else "tiny"]
        placed = jax_pp_params(tree, cfg, mesh, quantized=quantized)
        for rank in range(2):
            got = weights._flatten_params(params_from_numpy(
                tree, device="cpu", mesh=stage_mesh(rank),
                config=llama.preset("tiny")))
            leaves = dict(got)
            flat = jax.tree_util.tree_flatten_with_path(placed)[0]
            assert len(flat) == len(leaves)
            for path, arr in flat:
                key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                               for p in path)
                key = key.replace("/q", ":q").replace("/scale", ":scale")
                shard = next(s for s in arr.addressable_shards
                             if s.device == jax.devices()[rank])
                np.testing.assert_array_equal(
                    leaves[key].numpy(), np.asarray(shard.data),
                    err_msg=key)


class TestPipelineForward:
    @pytest.mark.parametrize("micro", MICRO)
    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_logits_equal_jax_pipeline(self, stage2, trees, micro, kv_quant):
        """Prefill, then three decode steps, on every rank: the prefill's
        logits over the valid positions within 1e-5 of the JAX pipeline's
        at the same microbatches, and every hidden state within 2e-4 of
        its (the JAX pipeline test's tolerance on these inputs). The decode
        steps' logits are held to one port rank's forward at 1e-5 (bit for
        bit at one microbatch): on this input one port rank's first decode
        step is itself 1.78e-5 from the JAX forward's in one row (float32
        summation order; tests/test_torch_model.py holds the one-rank
        forward to JAX), which the pipeline neither adds to nor takes
        away."""
        want_p, want_s, _ = jax_pipeline_ref(trees["tiny"], micro, kv_quant)
        jh_p, jh_s = jax_pipeline_hidden(trees["tiny"], micro, kv_quant)
        one_h, one_s, _ = port_forward_ref(trees["tiny"], kv_quant)
        for rank in range(2):
            got = load_out(stage2.out,
                           f"pp_m{micro}_{'q' if kv_quant else 'f'}", rank)
            logits = port_logits(trees["tiny"], got["prefill_h"])
            for b, n in enumerate(PP_LENS):
                np.testing.assert_allclose(logits[b, :n], want_p[b, :n],
                                           atol=ATOL, rtol=0)
                np.testing.assert_allclose(got["prefill_h"][b, :n],
                                           jh_p[b, :n], atol=2e-4, rtol=2e-4)
            np.testing.assert_allclose(got["step_h"], jh_s, atol=2e-4,
                                       rtol=2e-4)
            steps = [port_logits(trees["tiny"], h) for h in got["step_h"]]
            mine = [port_logits(trees["tiny"], h) for h in one_s]
            if micro == 1:
                np.testing.assert_array_equal(np.stack(steps),
                                              np.stack(mine))
            np.testing.assert_allclose(np.stack(steps), np.stack(mine),
                                       atol=ATOL, rtol=0)
            np.testing.assert_array_equal(got["lengths"],
                                          np.asarray(PP_LENS) + 3)

    @pytest.mark.parametrize("micro", MICRO)
    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_cache_block_is_the_stage_block(self, stage2, trees, micro,
                                            kv_quant):
        """A rank's cache holds its layer: the JAX stage block (the JAX
        pipeline's cache at that layer, within float32 summation order;
        int8 payloads within one step of a rounding boundary) and, at one
        microbatch, one port rank's cache at that layer bit for bit (at
        two, within 1e-4: the CPU's matmul rounds differently at half the
        rows)."""
        _, _, jcache = jax_pipeline_ref(trees["tiny"], micro, kv_quant)
        _, _, mine = port_forward_ref(trees["tiny"], kv_quant)
        valid = np.asarray(PP_LENS) + 3
        for rank in range(2):
            got = load_out(stage2.out, f"pp_m{micro}_{'q' if kv_quant else 'f'}",
                           rank)
            for name in ("k", "v") + (("k_scale", "v_scale") if kv_quant
                                      else ()):
                block = got[f"cache_{name}"]
                jblock = getattr(jcache, name)[rank:rank + 1]
                one = getattr(mine, name)[rank:rank + 1].float().numpy()
                assert block.shape == jblock.shape
                for b, n in enumerate(valid):
                    sl = (slice(None), b, slice(None), slice(0, n)) \
                        if name.endswith("scale") \
                        else (slice(None), b, slice(0, n))
                    if name in ("k", "v") and kv_quant:
                        assert np.abs(block[sl].astype(np.int32)
                                      - jblock[sl]).max() <= 1
                    else:
                        np.testing.assert_allclose(block[sl], jblock[sl],
                                                   atol=1e-4, rtol=1e-4)
                    if micro == 1:
                        np.testing.assert_array_equal(block[sl], one[sl])
                    else:
                        np.testing.assert_allclose(block[sl], one[sl],
                                                   atol=1e-4, rtol=1e-4)

    def test_flash_prefill_equals_one_rank(self, stage2, trees):
        """prefill_flash runs each stage's attention through the flash
        route (its plain version here): the same hidden states as one
        rank's flash forward over the valid positions."""
        want_h, want_s, _ = port_forward_ref(trees["tiny"], False, flash=True)
        got = load_out(stage2.out, "pp_flash", 0)
        for b, n in enumerate(PP_LENS):
            np.testing.assert_allclose(got["prefill_h"][b, :n],
                                       want_h[b, :n], atol=ATOL, rtol=0)
        np.testing.assert_allclose(got["step_h"], want_s, atol=1e-4,
                                   rtol=1e-4)

    @pytest.mark.parametrize("what,kw,words", [
        ("microbatches", dict(micro=3), "not divisible by 3 microbatches"),
        ("layers", dict(layers=3), "3 layers not divisible by 2 stages"),
        ("stage_only", dict(mesh={"stage": 2, "model": 2}),
         "shards only the stage axis"),
    ])
    def test_refusals_use_the_jax_words(self, trees, what, kw, words):
        """Both packages refuse a batch the microbatches do not divide,
        layers the stages do not divide and a mesh with another axis, with
        the same words."""
        cfg = llama.preset("tiny")
        jcfg = jax_preset("tiny")
        if "layers" in kw:
            cfg = dataclasses.replace(cfg, num_layers=kw["layers"])
            jcfg = dataclasses.replace(jcfg, num_layers=kw["layers"])
        shape = kw.get("mesh", STAGE)
        mesh = Mesh(MeshSpec(**shape), rank=0)
        jmesh = jax_build_mesh(JaxMeshSpec(**shape),
                               jax.devices()[:MeshSpec(**shape).size])
        micro = kw.get("micro", 2)
        params = params_from_numpy(trees["tiny"], device="cpu")
        with pytest.raises(ValueError, match=words):
            pipeline_forward_hidden(
                params, cfg, torch.from_numpy(PP_TOKENS),
                llama.init_cache(llama.preset("tiny"), 4, 19, torch.float32,
                                 device="cpu"), mesh,
                n_microbatches=micro)
        with pytest.raises(ValueError, match=words):
            jax_pipeline(jax.tree.map(jnp.asarray, trees["tiny"]), jcfg,
                         jnp.asarray(PP_TOKENS, jnp.int32),
                         jax_llama.init_cache(jax_preset("tiny"), 4, 19,
                                              jnp.float32), jmesh,
                         n_microbatches=micro)


def jax_stage_serve(tree, micro: int, **kw):
    return jax_serve(tree, jax_preset("tiny"), jax_stage_mesh(), 2,
                     geometry={**GEOMETRY, "pipeline_microbatches": micro},
                     **kw)


class TestStageEngine:
    @pytest.mark.parametrize("job,micro,sampling", [
        ("serve_f32_m1", 1, None), ("serve_f32_m2", 2, None),
        ("serve_seeded", 2, SEEDED)])
    def test_scheduler_tokens_equal_jax_engine(self, stage2, trees, job,
                                               micro, sampling):
        """Greedy and seeded tokens of the Scheduler at {stage: 2} (chunked
        and coalesced prefill, a second round of prefix hits) equal the JAX
        engine's on its stage mesh."""
        want, _ = jax_stage_serve(trees["tiny"], micro, sampling=sampling)
        got = load_out(stage2.out, job, 0)
        assert got["served"] == want
        assert got["prefix_cache"]["hits"] > 0

    @pytest.mark.parametrize("micro", MICRO)
    def test_int8_fused_dequant_degrades_as_in_jax(self, stage2, trees,
                                                   micro):
        """Int8 weights + int8 KV + fused_dequant: both packages keep every
        int8 leaf on the mixed dot under a stage axis and count it once
        under reason `stage_axis`; the tokens are the JAX engine's."""
        counter = JAX_METRICS.counter(JaxMetricName.QMM_FALLBACK, "",
                                      labels=("reason",))
        before = counter.value(reason="stage_axis")
        want, _ = jax_serve(trees["int8"], jax_preset("tiny"),
                            jax_stage_mesh(), 2, quantized=True,
                            kv_quant=True, geometry={
                                **GEOMETRY, "pipeline_microbatches": micro,
                                "fused_dequant": True})
        jax_count = counter.value(reason="stage_axis") - before
        assert jax_count == 1
        for rank in range(2):
            got = load_out(stage2.out, f"serve_int8_m{micro}", rank)
            assert got["stage_axis_fallbacks"] == jax_count
        assert load_out(stage2.out, f"serve_int8_m{micro}", 0)[
            "served"] == want

    @pytest.mark.parametrize("job", ["serve_f32_m1", "serve_f32_m2",
                                     "serve_int8_m2", "serve_seeded"])
    def test_ranks_in_lockstep(self, stage2, job):
        ranks = [load_out(stage2.out, job, r) for r in range(2)]
        assert ranks[0]["recorded"]
        assert ranks[1]["recorded"] == ranks[0]["recorded"]
        assert ranks[1]["lengths"] == ranks[0]["lengths"]

    def test_each_rank_holds_its_layers(self, stage2):
        """The decode cache, the prefix pool and the weights of a stage
        rank are its one layer of two: its KV cache is half of one rank's."""
        cfg = llama.preset("tiny")
        one = InferenceEngine(
            cfg, llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   torch.float32),
            None, device="cpu", cache_dtype=torch.float32, **GEOMETRY)
        for rank in range(2):
            got = load_out(stage2.out, "serve_f32_m2", rank)
            assert got["kv_layers"] == got["pool_layers"] == 1
            assert 2 * got["kv_cache_bytes"] == one.kv_cache_bytes()

    def test_weight_stream_bytes_equal_jax(self, stage2, trees):
        """A stage rank streams its layer plus the head and final norm:
        the JAX engine's per-device bytes on its stage mesh (279,296 B),
        and the whole model's in total."""
        cfg, mesh = jax_preset("tiny"), jax_stage_mesh()
        jengine = JaxEngine(cfg, jax_pp_params(trees["tiny"], cfg, mesh),
                            JaxByteTokenizer(), mesh=mesh, max_slots=4,
                            max_seq_len=32, prefill_buckets=(16,),
                            cache_dtype=jnp.float32)
        assert jengine.weight_stream_bytes_per_device() == 279_296
        for rank in range(2):
            got = load_out(stage2.out, "serve_f32_m1", rank)
            assert got["weight_stream_bytes_per_device"] == 279_296
            assert got["weight_stream_bytes"] == (
                jengine.weight_stream_bytes())

    def test_every_command_kind_equals_one_rank(self, stage2, trees):
        """One call of each dispatching kind through the facade (single,
        coalesced, chunked and cached prefill, decode, a speculative
        verify, a released slot) at {stage: 2} with two microbatches gives
        one rank's outputs; both ranks end with its slot lengths."""
        from symmetry_tpu_torch.engine.spec import SpecConfig
        from test_torch_tp import GEOMETRY as TP_GEOMETRY
        from torch_tp_worker import direct_calls

        cfg = llama.preset("tiny")
        engine = InferenceEngine(
            cfg, params_from_numpy(trees["tiny"], device="cpu"),
            ByteTokenizer(cfg.vocab_size), device="cpu",
            cache_dtype=torch.float32, speculative=SpecConfig(k_draft=2),
            **TP_GEOMETRY)
        want = direct_calls(engine)
        r0, r1 = (load_out(stage2.out, "direct", r) for r in range(2))
        assert r0["calls"] == [list(map(int, c)) for c in want]
        assert r0["lengths"] == r1["lengths"] == [
            engine.slot_length(s) for s in range(2)]

    @pytest.mark.parametrize("name", ["load_cold_bf16", "load_cold_int8",
                                      "load_warm_bf16", "load_warm_int8"])
    def test_sharded_load_takes_the_stage_block(self, stage2, ckpt, name):
        """A stage rank's cold or warm load (bf16, and int8 quantized as it
        is read) is the one-rank load's block of layers, bit for bit."""
        quantize = name.endswith("int8")
        load = (weights.load_warm_cache if name.startswith("load_warm")
                else weights.load_checkpoint)
        full, cfg = load(ckpt, dtype=torch.bfloat16, quantize=quantize,
                         device="cpu")
        for rank in range(2):
            want = dict(weights._flatten_params(
                llama.shard_params(full, cfg, stage_mesh(rank))))
            got = load_out(stage2.out, name, rank)
            assert sorted(got) == sorted(want)
            assert got["layers/wq" + (":q" if quantize else "")].shape[0] == 1
            for key, leaf in want.items():
                arr = (leaf.float().numpy() if leaf.dtype == torch.bfloat16
                       else leaf.numpy())
                np.testing.assert_array_equal(got[key], arr, err_msg=key)


def test_refused_at_construction_with_the_jax_words():
    """The stage axis beside another axis above 1, layers it does not
    divide, and microbatches that do not divide the slots or have no stage
    axis, are refused when the engine is built."""
    cfg = llama.preset("tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32)
    cases = [
        (Mesh(MeshSpec(stage=2, data=2)), {}, "stage-only"),
        (Mesh(MeshSpec(stage=2)), {"pipeline_microbatches": 3},
         "must divide into 3 pipeline microbatches"),
        (None, {"pipeline_microbatches": 2},
         "requires a mesh with a stage axis"),
    ]
    for mesh, kw, words in cases:
        with pytest.raises(EngineError, match=words):
            InferenceEngine(cfg, params, ByteTokenizer(512), mesh=mesh,
                            device="cpu", max_slots=4, **kw)
    with pytest.raises(EngineError, match="3 layers not divisible by 2"):
        InferenceEngine(dataclasses.replace(cfg, num_layers=3), params,
                        ByteTokenizer(512), mesh=Mesh(MeshSpec(stage=2)),
                        device="cpu")


def test_host_serves_the_single_rank_text(tmp_path):
    """The engine host with tpu.mesh {stage: 2} and two microbatches
    starts its follower rank and streams the single-rank host's text for
    chats submitted together; stats show the layout; the follower dies
    with the host."""
    four = {"max_batch_size": 4}
    single = HostProc(tmp_path, four, "single")
    want = serve_together(single)
    assert single.close() == 0
    host = HostProc(tmp_path, {**four, "mesh": STAGE,
                               "pipeline_microbatches": 2}, "pp2")
    follower, = children(host.proc.pid)
    got = serve_together(host)
    host.send({"op": "stats"})
    stats = host.frame("stats")
    assert host.close() == 0
    assert got == want and all(got)
    assert stats["mesh"]["shape"] == STAGE
    assert gone(follower)


def test_worker_rank_serves_a_stage(tmp_path):
    """tpu.multihost at 2 processes with {stage: 2}: the in-process
    backend as rank 0 (stage 0) serves a chat with `python -m
    symmetry_tpu_torch.provider --worker` as rank 1 (stage 1), the text
    of a one-rank backend."""
    import asyncio
    import subprocess
    import sys

    from symmetry_tpu_torch.provider.backends.tpu_native import (
        TpuNativeBackend)
    from symmetry_tpu_torch.provider.config import ConfigManager
    from test_torch_tp import REPO, _collect, env, free_port, mh_config

    def config(port, rank):
        cfg = mh_config(port, rank)
        cfg["tpu"]["mesh"] = STAGE
        return cfg

    async def serve(cfg):
        backend = TpuNativeBackend(ConfigManager(config=cfg), device="cpu")
        await backend.start()
        try:
            return await _collect(backend)
        finally:
            await backend.stop()

    one = config(0, 0)
    one["tpu"].pop("mesh")
    one["tpu"].pop("multihost")
    want = asyncio.new_event_loop().run_until_complete(serve(one))
    port = free_port()
    wpath = tmp_path / "worker.json"
    wpath.write_text(json.dumps(config(port, 1)))
    worker = subprocess.Popen(
        [sys.executable, "-m", "symmetry_tpu_torch.provider", "-c",
         str(wpath), "--worker", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env(),
        cwd=REPO)
    try:
        got = asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(serve(config(port, 0)), 180))
        _, err = worker.communicate(timeout=60)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    assert worker.returncode == 0, err[-3000:]
    assert got and got == want
