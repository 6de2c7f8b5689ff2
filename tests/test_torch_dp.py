"""The `data` mesh axis in the port against the JAX package on its CPU mesh.

The JAX references run here on the conftest's virtual CPU devices
(`build_mesh(MeshSpec(data=2))` and `MeshSpec(data=2, model=2)`), where
the decode cache's slot dimension is sharded over `data` and the rest of
the state is replicated. The port's ranks are processes
(tests/torch_tp_worker.py) joined by torch.distributed over gloo on the
CPU: each data rank holds its block of the slots, decodes only those
rows and all-gathers the tokens; rank 0's Scheduler drives every rank
through the command loop. One spawn a mesh runs every job.

  - the forward with each data rank's block of the batch: logits within
    1e-5 of the JAX forward on the mesh (float32);
  - greedy Scheduler tokens (chunked and coalesced prefill, a second round
    of prefix hits) and a seeded stream equal the JAX engine's on the
    mesh; int8 weights with an int8 KV cache equal its kv_quant run;
  - every rank records the same tokens, and each rank's decode cache holds
    max_slots / data slots, its own block;
  - one call of each dispatching kind through the facade gives one rank's
    outputs;
  - the engine host with `tpu.mesh: {data: 2}` serves the single-rank
    host's text.
"""

from __future__ import annotations

import json
import types

import jax
import numpy as np
import pytest
import torch

from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.parallel import MeshSpec as JaxMeshSpec
from symmetry_tpu.parallel import build_mesh as jax_build_mesh
from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu_torch.engine import weights
from symmetry_tpu_torch.engine.engine import EngineError, InferenceEngine
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models import llama
from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec
from test_torch_tp import (MAX_NEW, PROMPTS, TOKENS, HostProc,
                           jax_forward_ref, jax_sharded, jax_tree, load_out,
                           run_ranks, to_npz)
from test_torch_tp import jax_serve as tp_jax_serve

# Four slots: over data=2 each rank owns two, and the three prompts,
# submitted together, land in both blocks.
GEOMETRY = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
                decode_block=2, prefill_chunk=16, prefix_cache_bytes=2**20)
SEEDED = dict(temperature=0.8, top_p=0.9, top_k=20, seed=1234)
MESHES = {"data2": {"data": 2}, "data2_model2": {"data": 2, "model": 2}}


def jax_mesh(shape: dict):
    spec = JaxMeshSpec(**shape)
    return jax_build_mesh(spec, jax.devices()[:spec.size])


def engine_job(name: str, weights: str, **engine) -> dict:
    return dict(kind="engine", name=name, preset="tiny", weights=weights,
                prompts=PROMPTS, max_new=MAX_NEW, rounds=2,
                engine={k: list(v) if isinstance(v, tuple) else v
                        for k, v in {**GEOMETRY, **engine}.items()})


def jax_serve(tree, mesh, **kw) -> list:
    """The JAX engine on the mesh through its Scheduler, the three prompts
    submitted together over four slots, two rounds."""
    return tp_jax_serve(tree, jax_preset("tiny"), mesh, 2,
                        geometry=GEOMETRY, **kw)[0]


@pytest.fixture(scope="module")
def trees():
    return {"tiny": jax_tree("tiny", 0),
            "int8": jax_tree("tiny", 0, quantize=True)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A float32 `tiny` checkpoint with an int8 warm cache written by a
    single-rank load."""
    path = str(tmp_path_factory.mktemp("dp_ckpt"))
    cfg = llama.preset("tiny")
    weights.save_checkpoint(path, llama.init_params(
        cfg, torch.Generator().manual_seed(3), torch.float32), cfg, shards=2)
    full, got = weights.load_checkpoint(path, dtype=torch.bfloat16,
                                        quantize=True, device="cpu")
    weights.save_warm_cache(path, full, got, dtype=torch.bfloat16,
                            quantize=True)
    return path


def spawn(tmp_path_factory, trees, tag: str, shape: dict, direct: bool,
          ckpt: str | None = None):
    tmp = tmp_path_factory.mktemp(tag)
    files = {k: to_npz(t, str(tmp / f"{k}.npz")) for k, t in trees.items()}
    jobs = [
        dict(name="fwd", kind="forward", preset="tiny",
             weights=files["tiny"], tokens=TOKENS.tolist(),
             split_batch=True),
        engine_job("serve_f32", files["tiny"]),
        dict(engine_job("serve_seeded", files["tiny"]), sampling=SEEDED),
        engine_job("serve_int8", files["int8"], kv_quant=True,
                   fused_dequant=True),
    ]
    if direct:
        from test_torch_tp import GEOMETRY as TP_GEOMETRY

        jobs.append(dict(name="direct", kind="direct", preset="tiny",
                         weights=files["tiny"], engine={
                             k: list(v) if isinstance(v, tuple) else v
                             for k, v in TP_GEOMETRY.items()}))
    if ckpt is not None:
        jobs += [dict(name=f"load_{'warm' if warm else 'cold'}",
                      kind="load", path=ckpt, dtype="bfloat16",
                      quantize=True, warm=warm) for warm in (False, True)]
    world = int(np.prod(list(shape.values())))
    out = run_ranks(tmp, jobs, world=world, mesh=shape)
    return types.SimpleNamespace(out=out, world=world, shape=shape)


@pytest.fixture(scope="module")
def data2(tmp_path_factory, trees):
    return spawn(tmp_path_factory, trees, "dp2", MESHES["data2"], True)


@pytest.fixture(scope="module")
def data2_model2(tmp_path_factory, trees, ckpt):
    return spawn(tmp_path_factory, trees, "dp2tp2", MESHES["data2_model2"],
                 False, ckpt)


@pytest.fixture(params=sorted(MESHES))
def run(request):
    return request.getfixturevalue(request.param)


class TestDataAxis:
    def test_forward_equals_jax_mesh(self, run, trees):
        """Each data rank's block of the rows through the forward (its
        model block of the weights), gathered: prefill logits and the next
        decode step's within 1e-5 of the JAX forward on the mesh."""
        want = jax_forward_ref(trees["tiny"], jax_preset("tiny"),
                               jax_mesh(run.shape), TOKENS)
        for rank in range(run.world):
            got = load_out(run.out, "fwd", rank)
            np.testing.assert_allclose(got["prefill"], want[0], atol=1e-5,
                                       rtol=0)
            np.testing.assert_allclose(got["decode"], want[1], atol=1e-5,
                                       rtol=0)

    @pytest.mark.parametrize("job,sampling", [
        ("serve_f32", None), ("serve_seeded", SEEDED)])
    def test_scheduler_tokens_equal_jax_engine(self, run, trees, job,
                                               sampling):
        """Greedy and seeded tokens of the Scheduler over the mesh
        (chunked and coalesced prefill, a second round of prefix hits)
        equal the JAX engine's on the same mesh."""
        want = jax_serve(trees["tiny"], jax_mesh(run.shape),
                         sampling=sampling)
        got = load_out(run.out, job, 0)
        assert got["served"] == want
        assert got["prefix_cache"]["hits"] > 0

    def test_int8_kv_quant_tokens_equal_jax_engine(self, run, trees):
        """Int8 weights, packed on each rank (fused_dequant), with an int8
        KV cache, against the JAX engine's int8 weights with kv_quant on
        the mesh (its unfused path)."""
        want = jax_serve(trees["int8"], jax_mesh(run.shape), quantized=True,
                         kv_quant=True)
        assert load_out(run.out, "serve_int8", 0)["served"] == want

    @pytest.mark.parametrize("job", ["serve_f32", "serve_seeded",
                                     "serve_int8"])
    def test_ranks_in_lockstep(self, run, job):
        """Every rank produced the same (gathered) tokens at every command
        and holds the same slot lengths."""
        ranks = [load_out(run.out, job, r) for r in range(run.world)]
        assert ranks[0]["recorded"]
        for r in ranks[1:]:
            assert r["recorded"] == ranks[0]["recorded"]
            assert r["lengths"] == ranks[0]["lengths"]

    def test_each_rank_holds_its_block_of_slots(self, run):
        """A rank's decode cache holds max_slots / data slots: the block
        that the JAX engine's NamedSharding of the cache gives the device
        at the same place on the mesh."""
        from jax.sharding import NamedSharding

        from symmetry_tpu.models.llama import cache_logical_axes
        from symmetry_tpu.parallel import shardings_for as jax_shardings_for

        cfg = jax_preset("tiny")
        mesh = jax_mesh(run.shape)
        shape = (cfg.num_layers, GEOMETRY["max_slots"],
                 GEOMETRY["max_seq_len"], cfg.num_kv_heads, cfg.dim_per_head)
        where = NamedSharding(mesh, jax_shardings_for(
            cache_logical_axes().k, mesh).spec).devices_indices_map(shape)
        one_rank = InferenceEngine(
            llama.preset("tiny"), llama.init_params(
                llama.preset("tiny"), torch.Generator().manual_seed(0),
                torch.float32),
            None, device="cpu", cache_dtype=torch.float32,
            **GEOMETRY).kv_cache_bytes()
        for rank in range(run.world):
            got = load_out(run.out, "serve_f32", rank)
            block = where[jax.devices()[rank]][1]
            assert got["slot_block"] == [block.start or 0,
                                         block.stop or shape[1]]
            assert got["kv_slots"] == shape[1] // run.shape["data"]
            assert got["kv_cache_bytes"] * run.world == one_rank

    def test_weight_stream_bytes_equal_jax(self, run, trees):
        """Weights are replicated over `data`: a rank streams its model
        block, the JAX engine's per-device figure on the same mesh."""
        mesh = jax_mesh(run.shape)
        cfg = jax_preset("tiny")
        jengine = JaxEngine(cfg, jax_sharded(trees["tiny"], cfg, mesh),
                            JaxByteTokenizer(), mesh=mesh, max_slots=4,
                            max_seq_len=32, prefill_buckets=(16,),
                            cache_dtype=jax.numpy.float32)
        for rank in range(run.world):
            got = load_out(run.out, "serve_f32", rank)
            assert got["weight_stream_bytes"] == (
                jengine.weight_stream_bytes())
            assert got["weight_stream_bytes_per_device"] == (
                jengine.weight_stream_bytes_per_device())

    @pytest.mark.parametrize("name", ["load_cold", "load_warm"])
    def test_sharded_load_takes_the_model_coordinate(self, data2_model2,
                                                     ckpt, name):
        """At {data: 2, model: 2} a rank's int8 blocks of a cold or warm
        load are the single-rank load sliced at its model coordinate, the
        same on both data replicas (the amax is the model axis's)."""
        full, cfg = weights.load_checkpoint(ckpt, dtype=torch.bfloat16,
                                            quantize=True, device="cpu")
        for rank in range(4):
            mesh = Mesh(MeshSpec(**MESHES["data2_model2"]), rank=rank)
            want = dict(weights._flatten_params(
                llama.shard_params(full, cfg, mesh)))
            got = load_out(data2_model2.out, name, rank)
            assert sorted(got) == sorted(want)
            for key, leaf in want.items():
                arr = (leaf.float().numpy() if leaf.dtype == torch.bfloat16
                       else leaf.numpy())
                np.testing.assert_array_equal(got[key], arr, err_msg=key)

    def test_every_command_kind_equals_one_rank(self, data2, trees):
        """One call of each dispatching kind through the facade (single,
        coalesced, chunked and cached prefill, decode, a speculative
        verify, a released slot) on two data ranks of one slot each gives
        one rank's outputs, and both ranks end with its slot lengths."""
        from symmetry_tpu_torch.convert import params_from_numpy
        from symmetry_tpu_torch.engine.spec import SpecConfig
        from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
        from test_torch_tp import GEOMETRY as TP_GEOMETRY
        from torch_tp_worker import direct_calls

        cfg = llama.preset("tiny")
        engine = InferenceEngine(
            cfg, params_from_numpy(trees["tiny"], device="cpu"),
            ByteTokenizer(cfg.vocab_size), device="cpu",
            cache_dtype=torch.float32, speculative=SpecConfig(k_draft=2),
            **TP_GEOMETRY)
        want = direct_calls(engine)
        r0, r1 = (load_out(data2.out, "direct", r) for r in range(2))
        assert r0["calls"] == [list(map(int, c)) for c in want]
        assert r0["lengths"] == r1["lengths"] == [
            engine.slot_length(s) for s in range(2)]


def test_role_needs_one_device_on_a_data_mesh():
    """The tiers' handoff snapshots the whole cache host-side: refused on
    a data mesh as on a model one, as in the JAX package."""
    cfg = llama.preset("tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32)
    with pytest.raises(EngineError, match="single-device"):
        InferenceEngine(cfg, params, ByteTokenizer(512),
                        mesh=Mesh(MeshSpec(data=2), rank=1), role="prefill",
                        prefill_chunk=8, device="cpu")


CHATS = ["hello there",
         "hello there, and a longer message that runs past one chunk of "
         "thirty-two tokens",
         "and a third, shorter one"]


def serve_together(host: HostProc) -> list[str]:
    """Submit every chat before reading any event: the requests take
    slots 0-2, in both data ranks' blocks."""
    for i, content in enumerate(CHATS):
        host.send({"op": "submit", "id": f"r{i}", "max_new": 12,
                   "messages": [{"role": "user", "content": content}],
                   "sampling": {"temperature": 0.0}})
    texts = {f"r{i}": "" for i in range(len(CHATS))}
    done: set[str] = set()
    while len(done) < len(CHATS):
        line = host.proc.stdout.readline()
        assert line, "host exited; see its log"
        f = json.loads(line)
        if f.get("op") not in ("event", "events"):
            continue
        for e in [f] if f["op"] == "event" else f["events"]:
            texts[e["id"]] += e.get("text", "")
            if e.get("done"):
                done.add(e["id"])
    return [texts[f"r{i}"] for i in range(len(CHATS))]


def test_host_serves_the_single_rank_text(tmp_path):
    """The engine host with tpu.mesh {data: 2} starts its follower rank
    and streams the single-rank host's text for chats submitted together;
    stats show the layout."""
    four = {"max_batch_size": 4}
    single = HostProc(tmp_path, four, "single")
    want = serve_together(single)
    assert single.close() == 0
    host = HostProc(tmp_path, {**four, "mesh": {"data": 2}}, "dp2")
    got = serve_together(host)
    host.send({"op": "stats"})
    stats = host.frame("stats")
    assert host.close() == 0
    assert got == want and all(got)
    assert stats["mesh"]["shape"] == {"data": 2}
    assert stats["mesh"]["backend"] == "gloo"
