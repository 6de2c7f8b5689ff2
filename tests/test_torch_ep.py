"""MoE on every mesh axis in the port, the `expert` axis and `dcn_data`,
against the JAX package on its CPU mesh.

The JAX references run here on the conftest's virtual CPU devices. The
port's ranks are processes (tests/torch_tp_worker.py) joined by
torch.distributed over gloo on the CPU: one spawn of two ranks, one of
four and one of eight (the {data: 2, expert: 2, model: 2} forward), run
together, each job on its own mesh. The `tiny-moe` weights are numpy
draws in the JAX layout, 1/sqrt(fan-in) scaled (tests/test_torch_moe.py
`moe_tree`), float32.

  - the MoE layer, the dense mixture and the dispatch (capacity factor 1,
    so pairs drop), float32 and int8, at {expert: 2} and {expert: 2,
    model: 2}: within 1e-5 of the JAX layer on the same mesh;
  - the forward at {data: 2, expert: 2, model: 2}: within 2e-4 of the JAX
    forward on the mesh (tests/test_moe.py TestExpertParallel's bound);
  - greedy Scheduler tokens on {expert: 2}, {expert: 2, model: 2},
    {data: 2, expert: 2}, {model: 2}, {stage: 2} and {context: 2} equal
    the JAX engine's on the same mesh, float32 and int8 (+ int8 KV; the
    JAX engine's unfused path), with every rank in lockstep;
  - a verify on {data: 2} whose whole batch (8 slots x 8 positions) takes
    the dispatch while each rank's half does not, at a capacity factor that
    drops pairs: tokens equal the JAX engine's;
  - `ring_mesh` over a context-only mesh runs the MoE layers: one rank's
    hidden states;
  - sharded checkpoint and warm-cache loads, bf16 and int8, at {expert: 2},
    {stage: 2} and {expert: 2, model: 2}, bit-equal to slicing one load;
    so are quantize_params on a rank's blocks and init_params(mesh=);
  - weight_stream_bytes_per_device equal to the JAX engine's;
  - dcn_data 2 x ici {model: 2}: four ranks laid out as the JAX mesh
    {data: 2, model: 2} and serving its engine's tokens.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.spec import SpecConfig as JaxSpecConfig
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu.models import llama as jax_llama
from symmetry_tpu.models import moe as jax_moe
from symmetry_tpu.parallel import MeshSpec as JaxMeshSpec
from symmetry_tpu.parallel import build_mesh as jax_build_mesh
from symmetry_tpu.parallel import shardings_for as jax_shardings_for
from symmetry_tpu.parallel.pipeline import PIPELINE_RULES as JAX_PP_RULES
from symmetry_tpu_torch.engine import weights
from symmetry_tpu_torch.engine.engine import EngineError, check_mesh
from symmetry_tpu_torch.models import llama
from symmetry_tpu_torch.parallel import multihost
from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec
from test_torch_moe import jax_int8, moe_tree
from test_torch_tp import (MAX_NEW, PROMPTS, TOKENS, load_out, run_ranks,
                           to_npz)
from test_torch_tp import jax_serve as tp_jax_serve

JCFG = jax_llama.preset("tiny-moe")
CFG = llama.preset("tiny-moe")
# Four slots (data=2 gives each rank two); the 40-token prompt prefills
# alone at the 64 bucket, so its layers take the dispatch.
GEOMETRY = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
                decode_block=2, prefill_chunk=64, prefix_cache_bytes=2**20)
MESHES = {"ep2": {"expert": 2}, "tp2": {"model": 2}, "pp2": {"stage": 2},
          "cp2": {"context": 2}, "ep2tp2": {"expert": 2, "model": 2},
          "dp2ep2": {"data": 2, "expert": 2}}
TWO = ("ep2", "tp2", "pp2", "cp2")
FOUR = ("ep2tp2", "dp2ep2")
LAYER_MESHES = ("ep2", "ep2tp2")
LOAD_MESHES = ("ep2", "pp2", "ep2tp2")
LOADS = [f"load_{w}_{d}" for w in ("cold", "warm")
         for d in ("bf16", "int8")]
# The layer inputs: a decode-sized call (the dense mixture) and 80 tokens
# (the dispatch); capacity factor 1 drops pairs at 80.
LAYER_CF = 1.0
# The verify: 8 slots, k_draft 7 (64 positions in all, 32 a data rank),
# capacity factor 0.5.
VERIFY_CF = 0.5
VERIFY_GEOMETRY = dict(max_slots=8, max_seq_len=64, prefill_buckets=(16,),
                       decode_block=1, prefill_chunk=None)
RING_TOKENS = np.random.default_rng(5).integers(0, 512, (2, 32)).astype(
    np.int32)


def jax_mesh(shape: dict):
    spec = JaxMeshSpec(**shape)
    return jax_build_mesh(spec, jax.devices()[:spec.size])


def jax_place(tree, cfg, mesh, *, quantized=False):
    """The JAX tree on the mesh as the JAX engine serves it: the default
    rules, PIPELINE_RULES under a stage axis."""
    axes = jax_llama.param_logical_axes(cfg)
    if quantized:
        axes = jax_llama.quantized_logical_axes(axes)
    rules = JAX_PP_RULES if mesh.shape.get("stage", 1) > 1 else None
    return jax.device_put(jax.tree.map(jnp.asarray, tree),
                          jax_shardings_for(axes, mesh, rules))


def geometry(name: str) -> dict:
    return {**GEOMETRY, **({"pipeline_microbatches": 2}
                           if name == "pp2" else {})}


def listed(d: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def engine_job(name: str, mesh: str, weights_path: str, **engine) -> dict:
    return dict(kind="engine", name=name, preset="tiny-moe",
                weights=weights_path, prompts=PROMPTS, max_new=MAX_NEW,
                rounds=1, mesh=MESHES[mesh], engine=listed({**geometry(mesh),
                                                  **engine}))


def verify_inputs() -> dict:
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).tolist() for n in range(5, 13)]
    drafts = [rng.integers(0, 512, (8, 7)).tolist() for _ in range(2)]
    n_drafts = [[7, 7, 7, 7, 3, 0, 7, 5], [7, 2, 7, 7, 7, 7, 0, 7]]
    return dict(prompts=prompts, drafts=drafts, n_drafts=n_drafts)


@pytest.fixture(scope="module")
def trees():
    tree = moe_tree()
    return {"f32": tree, "int8": jax_int8(tree)}


@pytest.fixture(scope="module")
def layer_inputs():
    rng = np.random.default_rng(4)
    return {"dense": rng.normal(size=(2, 3, 64)).astype(np.float32),
            "dispatch": rng.normal(size=(2, 40, 64)).astype(np.float32)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A float32 `tiny-moe` checkpoint (2 shards) with bf16 and int8 warm
    caches written by single-rank loads."""
    path = str(tmp_path_factory.mktemp("ep_ckpt"))
    params = llama.init_params(CFG, torch.Generator().manual_seed(3),
                               torch.float32)
    weights.save_checkpoint(path, params, CFG, shards=2)
    for quantize in (False, True):
        full, got = weights.load_checkpoint(path, dtype=torch.bfloat16,
                                            quantize=quantize, device="cpu")
        weights.save_warm_cache(path, full, got, dtype=torch.bfloat16,
                                quantize=quantize)
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, trees, layer_inputs, ckpt):
    """The two-, four- and eight-rank spawns, run together."""
    tmp = tmp_path_factory.mktemp("ep")
    files = {k: to_npz(t, str(tmp / f"{k}.npz")) for k, t in trees.items()}
    data = str(tmp / "layer.npz")
    np.savez(data, **layer_inputs)
    jobs: dict[str, list] = {"two": [], "four": [], "eight": []}
    for mesh in TWO + FOUR:
        group = jobs["two" if mesh in TWO else "four"]
        group += [engine_job(f"serve_f32_{mesh}", mesh, files["f32"]),
                  engine_job(f"serve_int8_{mesh}", mesh, files["int8"],
                             kv_quant=True, fused_dequant=True)]
        if mesh in LAYER_MESHES:
            group += [dict(kind="moe", name=f"moe_{d}_{mesh}",
                           preset="tiny-moe", weights=files[d], data=data,
                           mesh=MESHES[mesh],
                           config={"moe_capacity_factor": LAYER_CF})
                      for d in ("f32", "int8")]
        if mesh in LOAD_MESHES:
            group += [dict(kind="load", name=f"{name}_{mesh}", path=ckpt,
                           dtype="bfloat16", quantize=name.endswith("int8"),
                           warm="warm" in name, mesh=MESHES[mesh])
                      for name in LOADS]
    jobs["two"] += [
        dict(kind="verify", name="verify_dp2", preset="tiny-moe",
             weights=files["f32"], mesh={"data": 2},
             config={"moe_capacity_factor": VERIFY_CF},
             engine=listed(VERIFY_GEOMETRY), **verify_inputs()),
        dict(kind="ring_fwd", name="ring_cp2", preset="tiny-moe",
             weights=files["f32"], mesh={"context": 2},
             tokens=RING_TOKENS.tolist(), seq_lens=[32, 27])]
    jobs["four"].append(dict(engine_job("serve_dcn", "tp2", files["f32"]),
                             dcn_data=2))
    jobs["four"].append(dict(kind="quantize", name="quantize_ep2tp2",
                             preset="tiny-moe", weights=files["f32"],
                             mesh=MESHES["ep2tp2"]))
    jobs["eight"].append(dict(
        kind="forward", name="fwd_dp2ep2tp2", preset="tiny-moe",
        weights=files["f32"], tokens=TOKENS.tolist(), split_batch=True,
        mesh={"data": 2, "expert": 2, "model": 2}))
    worlds = {"two": 2, "four": 4, "eight": 8}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {
            group: pool.submit(run_ranks, tmp_path_factory.mktemp(group),
                               jobs[group], worlds[group],
                               jobs[group][0]["mesh"])
            for group in jobs}
        return types.SimpleNamespace(
            **{group: f.result() for group, f in futures.items()})


def out_dir(ranks, mesh: str) -> str:
    return ranks.two if mesh in TWO else ranks.four


def world(mesh: str) -> int:
    return int(np.prod(list(MESHES[mesh].values())))


class TestLayer:
    @pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
    @pytest.mark.parametrize("mesh", LAYER_MESHES)
    def test_moe_layer_equals_jax_on_the_mesh(self, ranks, trees,
                                              layer_inputs, mesh, int8):
        """Each rank's moe_mlp on its experts (and F block), summed over
        the axes: the dense mixture and the dispatch within 1e-5 of the
        JAX layer on the same mesh, on every rank."""
        src = trees["int8" if int8 else "f32"]
        jmesh = jax_mesh(MESHES[mesh])
        jcfg = dataclasses.replace(JCFG, moe_capacity_factor=LAYER_CF)
        params = jax_place(src, JCFG, jmesh, quantized=int8)

        @jax.jit
        def layer0(p, x):
            lp = jax.tree.map(lambda a: a[0], p["layers"])
            return jax_moe.moe_mlp(x, lp, jcfg)

        for rank in range(world(mesh)):
            got = load_out(ranks.four if mesh in FOUR else ranks.two,
                           f"moe_{'int8' if int8 else 'f32'}_{mesh}", rank)
            for name, x in layer_inputs.items():
                want = np.asarray(layer0(params, jnp.asarray(x)))
                np.testing.assert_allclose(got[name], want, atol=1e-5,
                                           rtol=0, err_msg=(name, rank))

    def test_dispatch_drops_pairs(self, trees, layer_inputs):
        """The layer inputs exercise drops: at capacity factor 1 the
        80-token call's capacity is under some expert's demand."""
        x = layer_inputs["dispatch"].reshape(-1, 64)
        router = trees["f32"]["layers"]["router"][0]
        idx = np.argsort(-(x @ router), axis=-1, kind="stable")[:, :2]
        C = int(np.ceil(x.shape[0] * 2 / 4 * LAYER_CF))
        assert np.bincount(idx.ravel(), minlength=4).max() > C

    def test_forward_at_data_expert_model(self, ranks, trees):
        """The tiny-moe forward on eight ranks, {data: 2, expert: 2, model:
        2}, each data rank its block of the batch: prefill and decode
        logits within 2e-4 of the JAX forward on the same mesh."""
        shape = {"data": 2, "expert": 2, "model": 2}
        jmesh = jax_mesh(shape)
        params = jax_place(trees["f32"], JCFG, jmesh)
        B, S = TOKENS.shape
        cache = jax_llama.init_cache(JCFG, B, S + 4, jnp.float32)
        fwd = jax.jit(jax_llama.forward, static_argnums=(1,))
        logits, cache = fwd(params, JCFG, jnp.asarray(TOKENS), cache)
        step, _ = fwd(params, JCFG, jnp.asarray(TOKENS[:, -1:]), cache)
        for rank in range(8):
            got = load_out(ranks.eight, "fwd_dp2ep2tp2", rank)
            np.testing.assert_allclose(got["prefill"], np.asarray(logits),
                                       atol=2e-4, rtol=0)
            np.testing.assert_allclose(got["decode"], np.asarray(step),
                                       atol=2e-4, rtol=0)

    def test_ring_mesh_runs_moe_layers(self, ranks, trees):
        """forward_hidden with a context-only ring_mesh (ring and Ulysses)
        over a 64-token batch, whose MoE layers take the dispatch on every
        rank: one rank's flash forward within 1e-5."""
        from symmetry_tpu_torch.convert import params_from_numpy

        params = params_from_numpy(trees["f32"], device="cpu")
        tokens = torch.from_numpy(RING_TOKENS)
        lens = torch.tensor([32, 27], dtype=torch.int32)
        cache = llama.init_cache(CFG, 2, 32, torch.float32, device="cpu")
        want, _ = llama.forward_hidden(params, CFG, tokens, cache, lens,
                                       prefill_flash=True)
        for rank in range(2):
            got = load_out(ranks.two, "ring_cp2", rank)
            for mode in ("ring", "ulysses"):
                np.testing.assert_allclose(
                    got[f"{mode}_h"][:, :27], want.numpy()[:, :27],
                    atol=1e-5, rtol=0, err_msg=mode)


def jax_serve(tree, shape: dict, geom: dict, **kw) -> list:
    """The JAX engine on the mesh through its Scheduler, the prompts
    submitted together, one round: tokens per prompt."""
    return tp_jax_serve(tree, JCFG, jax_mesh(shape), 1, geometry=geom,
                        **kw)[0][0]


class TestServe:
    @pytest.mark.parametrize("mesh", TWO + FOUR)
    def test_scheduler_tokens_equal_jax_engine(self, ranks, trees, mesh):
        """Greedy float32 tokens of the Scheduler on the mesh equal the
        JAX engine's on the same mesh."""
        want = jax_serve(trees["f32"], MESHES[mesh], geometry(mesh))
        assert load_out(out_dir(ranks, mesh), f"serve_f32_{mesh}",
                        0)["served"][0] == want

    @pytest.mark.parametrize("mesh", TWO + FOUR)
    def test_int8_tokens_equal_jax_engine(self, ranks, trees, mesh):
        """Int8 weights (attention and head packed on each rank, expert
        stacks flat on the mixed dot; under a stage axis all flat) with an
        int8 KV cache: the JAX engine's int8 tokens with kv_quant on the
        mesh, its unfused path."""
        want = jax_serve(trees["int8"], MESHES[mesh], geometry(mesh),
                         quantized=True, kv_quant=True)
        assert load_out(out_dir(ranks, mesh), f"serve_int8_{mesh}",
                        0)["served"][0] == want

    @pytest.mark.parametrize("job", ["serve_f32", "serve_int8"])
    @pytest.mark.parametrize("mesh", TWO + FOUR)
    def test_ranks_in_lockstep(self, ranks, mesh, job):
        """Every rank produced the same tokens at every command and holds
        the same slot lengths."""
        got = [load_out(out_dir(ranks, mesh), f"{job}_{mesh}", r)
               for r in range(world(mesh))]
        assert got[0]["recorded"]
        for r in got[1:]:
            assert r["recorded"] == got[0]["recorded"]
            assert r["lengths"] == got[0]["lengths"]

    @pytest.mark.parametrize("mesh", TWO + FOUR)
    def test_weight_stream_bytes_equal_jax(self, ranks, trees, mesh):
        """A rank streams its block of every leaf (its experts, its model
        block, its layers): the JAX engine's per-device figure on the same
        mesh, and the whole model's."""
        jmesh = jax_mesh(MESHES[mesh])
        jengine = JaxEngine(JCFG, jax_place(trees["f32"], JCFG, jmesh),
                            JaxByteTokenizer(), mesh=jmesh,
                            cache_dtype=jnp.float32, **geometry(mesh))
        for rank in range(world(mesh)):
            got = load_out(out_dir(ranks, mesh), f"serve_f32_{mesh}", rank)
            assert got["weight_stream_bytes"] == (
                jengine.weight_stream_bytes())
            assert got["weight_stream_bytes_per_device"] == (
                jengine.weight_stream_bytes_per_device())

    def test_expert_rank_streams_half_the_experts(self, ranks):
        """At {expert: 2} a rank streams half of the expert stacks and
        every other leaf whole."""
        c = CFG
        experts = (c.num_layers * c.num_experts * 3 * c.hidden_size
                   * c.intermediate_size * 4)
        for rank in range(2):
            got = load_out(ranks.two, "serve_f32_ep2", rank)
            assert (got["weight_stream_bytes"]
                    - got["weight_stream_bytes_per_device"]) == experts // 2


class TestDataAxisVerify:
    def test_whole_batch_dispatch_equals_jax_engine(self, ranks, trees):
        """A verify of 8 slots x 8 positions on {data: 2}: the whole batch
        is 64 tokens (the dispatch, capacity 16 at factor 0.5, so pairs
        drop) while each rank's half is 32 (the dense mixture). The ranks
        run the MoE layers over the whole batch, as the JAX engine's one
        program does: verify and decode tokens equal its."""
        jmesh = jax_mesh({"data": 2})
        jcfg = dataclasses.replace(JCFG, moe_capacity_factor=VERIFY_CF)
        jengine = JaxEngine(jcfg, jax_place(trees["f32"], jcfg, jmesh),
                            JaxByteTokenizer(), mesh=jmesh,
                            cache_dtype=jnp.float32,
                            speculative=JaxSpecConfig(k_draft=7),
                            **VERIFY_GEOMETRY)
        from symmetry_tpu.engine.engine import SamplingParams as JaxSampling
        from torch_tp_worker import verify_calls

        inputs = verify_inputs()
        want = verify_calls(jengine, inputs["prompts"], inputs["drafts"],
                            inputs["n_drafts"], JaxSampling())
        got = load_out(ranks.two, "verify_dp2", 0)["calls"]
        assert got == [list(map(int, c)) for c in want]

    def test_the_call_takes_the_dispatch_only_whole(self):
        """The geometry's premise: the whole verify reaches
        MIN_DISPATCH_TOKENS and a data rank's half does not."""
        from symmetry_tpu_torch.models.moe import MIN_DISPATCH_TOKENS

        S = 1 + 7
        B = VERIFY_GEOMETRY["max_slots"]
        assert B * S >= MIN_DISPATCH_TOKENS > B // 2 * S


class TestLoads:
    @pytest.mark.parametrize("name", LOADS)
    @pytest.mark.parametrize("mesh", LOAD_MESHES)
    def test_sharded_load_equals_slicing_one_load(self, ranks, ckpt, mesh,
                                                  name):
        """A rank's cold or warm load, bf16 or int8 (scales included), is
        the single-rank load sliced at its place: its experts at {expert:
        2}, its layers' router and experts at {stage: 2}, its experts'
        F block at {expert: 2, model: 2} (the int8 amax over the model
        axis)."""
        quantize = name.endswith("int8")
        full, cfg = weights.load_checkpoint(ckpt, dtype=torch.bfloat16,
                                            quantize=quantize, device="cpu")
        for rank in range(world(mesh)):
            mesh_r = Mesh(MeshSpec(**MESHES[mesh]), rank=rank)
            want = dict(weights._flatten_params(
                llama.shard_params(full, cfg, mesh_r)))
            got = load_out(out_dir(ranks, mesh), f"{name}_{mesh}", rank)
            assert sorted(got) == sorted(want)
            for key, leaf in want.items():
                arr = (leaf.float().numpy() if leaf.dtype == torch.bfloat16
                       else leaf.numpy())
                np.testing.assert_array_equal(got[key], arr,
                                              err_msg=(key, rank))


class TestInt8Blocks:
    def test_quantize_params_on_the_mesh(self, ranks, trees):
        """quantize_params on a rank's float32 blocks at {expert: 2, model:
        2} (the row-parallel wo and expert wd take the amax over `model`)
        is the whole tree quantized, sliced."""
        from symmetry_tpu_torch.convert import params_from_numpy

        full = llama.quantize_params(params_from_numpy(trees["f32"],
                                                       device="cpu"))
        for rank in range(4):
            want = dict(weights._flatten_params(llama.shard_params(
                full, CFG, Mesh(MeshSpec(**MESHES["ep2tp2"]), rank=rank))))
            got = load_out(ranks.four, "quantize_ep2tp2", rank)
            assert sorted(got) == sorted(want)
            for key, leaf in want.items():
                np.testing.assert_array_equal(got[key], leaf.numpy(),
                                              err_msg=(key, rank))

    @pytest.mark.parametrize("quantize", [False, True],
                             ids=["dense", "int8"])
    @pytest.mark.parametrize("mesh", ["ep2", "ep2tp2", "pp2"])
    def test_init_params_keeps_a_ranks_slabs(self, mesh, quantize):
        """init_params(mesh=) draws what one rank draws, slab by slab, and
        keeps only this rank's block: every rank's tree is the
        single-device tree sliced (a rank view of the mesh: no collective
        runs while drawing)."""
        full = llama.init_params(CFG, torch.Generator().manual_seed(1),
                                 torch.float32, quantize=quantize)
        for rank in range(world(mesh)):
            m = Mesh(MeshSpec(**MESHES[mesh]), rank=rank)
            got = dict(weights._flatten_params(llama.init_params(
                CFG, torch.Generator().manual_seed(1), torch.float32,
                quantize=quantize, mesh=m)))
            want = dict(weights._flatten_params(
                llama.shard_params(full, CFG, m)))
            assert sorted(got) == sorted(want)
            for key in want:
                assert torch.equal(got[key], want[key]), (key, rank)


class TestDcnData:
    def test_layout_and_tokens_equal_jax_data_model_mesh(self, ranks,
                                                         trees):
        """dcn_data 2 over ici {model: 2}: four ranks, host-major (ranks
        0-1 data index 0, ranks 2-3 data index 1), each at the place the
        JAX mesh {data: 2, model: 2} gives the device of its number, and
        the tokens are that mesh's JAX engine's."""
        jmesh = jax_mesh({"data": 2, "model": 2})
        names = list(jmesh.axis_names)
        for rank in range(4):
            got = load_out(ranks.four, "serve_dcn", rank)
            where = np.argwhere(jmesh.devices == jax.devices()[rank])[0]
            want = {a: int(i) for a, i in zip(names, where)}
            assert got["coords"] == want
            assert got["coords"]["data"] == rank // 2
        want = jax_serve(trees["f32"], {"data": 2, "model": 2}, GEOMETRY)
        assert load_out(ranks.four, "serve_dcn", 0)["served"][0] == want

    def test_whole_mesh_and_world_check(self):
        """The job's mesh is ici with dcn_data times its data axis; a job
        of the wrong size is refused in the JAX words, and a stage axis
        beside the hosts' data axis names item 14."""
        spec = multihost.multihost_spec({"model": 2}, 2)
        assert spec.shape() == MeshSpec(data=2, model=2).shape()
        assert multihost.multihost_spec({"data": 2, "expert": 2},
                                        3).data == 6
        with pytest.raises(ValueError,
                           match="every global device must be in the mesh"):
            multihost.build_multihost_mesh({"model": 2}, 2)
        with pytest.raises(EngineError, match="item 14"):
            check_mesh(multihost.multihost_spec({"stage": 2}, 2).shape())
