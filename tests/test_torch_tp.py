"""Tensor parallelism in the port (symmetry_tpu_torch/parallel/) against the
JAX package on its CPU mesh.

The JAX references run here, over the conftest's virtual CPU devices
(`build_mesh(MeshSpec(model=N))`). The port's ranks are real processes
(tests/torch_tp_worker.py) joined by torch.distributed over gloo on the
CPU; they import torch alone. One spawn of two ranks runs every job of
TestTwoRanks (forward, Scheduler, lockstep, int8, sharded loads), so the
file pays for one process group.

  - sharding: logical specs, local shapes and block placement equal
    NamedSharding's; pack degrade reasons equal the JAX package's;
  - the command vector: Command.encode equals the JAX package's;
  - TP=2: the forward of `tiny` and `tiny-qwen` within 1e-5 of the JAX
    forward on the mesh in float32; greedy Scheduler tokens equal the JAX
    engine's on the mesh (float32, and int8 against its unfused path);
    every rank records the same tokens; weight_stream_bytes_per_device
    equals the JAX engine's; sharded checkpoint and warm-cache loads are
    bit-equal to slicing a single-rank load, int8 scales included;
  - the engine host with `tpu.mesh: {model: 2}` starts its follower, serves
    the single-rank host's text, and its follower dies with it;
  - the provider's in-process backend as rank 0 of a `tpu.multihost` job
    with a `--worker` rank, its command loop under the engine gate;
  - what stays refused names ROADMAP item 14.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

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
from symmetry_tpu.models import llama as jax_llama
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.parallel import MeshSpec as JaxMeshSpec
from symmetry_tpu.parallel import build_mesh as jax_build_mesh
from symmetry_tpu.parallel import multihost as jax_multihost
from symmetry_tpu.parallel import shardings_for as jax_shardings_for
from symmetry_tpu_torch.engine import weights
from symmetry_tpu_torch.engine.engine import EngineError, InferenceEngine
from symmetry_tpu_torch.models import llama
from symmetry_tpu_torch.parallel import multihost
from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec
from symmetry_tpu_torch.parallel.sharding import (Sharding, logical_to_spec,
                                                  shardings_for)
from symmetry_tpu_torch.provider.config import ConfigManager, TpuConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
SPAWN_TIMEOUT = 300

PROMPTS = [list(range(7, 12)), list(range(40, 54)), list(range(100, 140))]
MAX_NEW = 10
# The engine geometry of the Scheduler runs: the 64 bucket holds more than
# one 16-token chunk (chunked prefill) and the pool serves the second
# round's prefix hits.
GEOMETRY = dict(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32, 64),
                decode_block=2, prefill_chunk=16, prefix_cache_bytes=2**20)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env() -> dict:
    # A rank imports torch and the port only.
    return {**{k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")},
            "PYTHONPATH": REPO}


def jax_tree(name: str, seed: int, *, quantize: bool = False) -> dict:
    cfg = jax_preset(name)
    tree = jax_init_params(cfg, jax.random.key(seed), jnp.float32)
    if cfg.attention_bias:
        # nonzero q/k/v biases, so their sharding shows
        keys = jax.random.split(jax.random.key(seed + 1), 3)
        for key, b in zip(keys, ("bq", "bk", "bv")):
            tree["layers"][b] = 0.1 * jax.random.normal(
                key, tree["layers"][b].shape, jnp.float32)
    if quantize:
        tree = jax_llama.quantize_params(tree)
    return jax.tree.map(np.asarray, tree)


def to_npz(tree: dict, path: str) -> str:
    flat = {}

    def visit(node, prefix):
        for k, v in node.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                visit(v, key + "/")
            elif hasattr(v, "q"):
                flat[key + ":q"] = np.asarray(v.q)
                flat[key + ":scale"] = np.asarray(v.scale)
            else:
                flat[key] = np.asarray(v)

    visit(tree, "")
    np.savez(path, **flat)
    return path


def jax_mesh(tp: int):
    return jax_build_mesh(JaxMeshSpec(model=tp), jax.devices()[:tp])


def jax_sharded(tree: dict, cfg, mesh, *, quantized: bool = False):
    axes = jax_llama.param_logical_axes(cfg)
    if quantized:
        axes = jax_llama.quantized_logical_axes(axes)
    return jax.device_put(jax.tree.map(jnp.asarray, tree),
                          jax_shardings_for(axes, mesh))


def port_mesh(tp: int, rank: int) -> Mesh:
    """A rank's view of an N-rank model mesh, for shape arithmetic only (no
    process group)."""
    return Mesh(MeshSpec(model=tp), rank=rank)


def run_ranks(tmp_path, jobs: list[dict], world: int = 2) -> str:
    """Run `jobs` on `world` ranks; returns the output directory."""
    out = str(tmp_path)
    spec = {"port": free_port(), "world": world, "out": out, "jobs": jobs}
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w", encoding="utf-8") as fh:
        json.dump(spec, fh)
    procs = [subprocess.Popen([sys.executable, WORKER, spec_path, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env(), cwd=REPO)
             for r in range(world)]
    try:
        results = [p.communicate(timeout=SPAWN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    return out


def load_out(out: str, name: str, rank: int):
    arrays = {}
    if os.path.exists(os.path.join(out, f"{name}.{rank}.npz")):
        with np.load(os.path.join(out, f"{name}.{rank}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
    path = os.path.join(out, f"{name}.{rank}.json")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as fh:
            arrays.update(json.load(fh))
    return arrays


# ---------------------------------------------------------------------------
# Sharding arithmetic and the command vector (no process group)


def leaf_axes(name: str, quantized: bool):
    """(name, logical axes, full shape) of every leaf of a params tree and
    the KV cache, int8 scales included; the port's axes, which equal the
    JAX package's."""
    cfg = jax_preset(name)
    tree = jax.eval_shape(lambda: jax_init_params(
        cfg, jax.random.key(0), jnp.float32, quantize=quantized))
    axes = llama.param_logical_axes(llama.preset(name))
    assert axes == jax_llama.param_logical_axes(cfg)
    out = []

    def visit(node, ax, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v, ax[k], prefix + k + "/")
            elif hasattr(v, "q"):
                out.append((prefix + k + ":q", ax[k], v.q.shape))
                out.append((prefix + k + ":scale", llama.scale_axes(ax[k]),
                            v.scale.shape))
            else:
                out.append((prefix + k, ax[k], v.shape))

    visit(tree, axes, "")
    cache = llama.cache_logical_axes(quantized=quantized)
    assert cache == jax_llama.cache_logical_axes(quantized=quantized)
    shapes = {"k": (cfg.num_layers, 2, 32, cfg.num_kv_heads,
                    cfg.dim_per_head),
              "k_scale": (cfg.num_layers, 2, cfg.num_kv_heads, 32)}
    for name in ("k", "k_scale") if quantized else ("k",):
        out.append(("cache/" + name, getattr(cache, name), shapes[name]))
    return out


class TestSharding:
    @pytest.mark.parametrize("name,tp,quantized", [
        ("tiny", 2, False), ("tiny", 2, True), ("tiny-qwen", 2, False),
        ("tiny-mha", 4, True), ("llama3-8b", 2, True),
        ("llama3-8b", 4, False)])
    def test_blocks_equal_named_sharding(self, name, tp, quantized):
        """Every leaf's spec, local shape and block position on every rank
        equal the JAX package's NamedSharding over its CPU mesh."""
        mesh = jax_mesh(tp)
        for leaf, axes, shape in leaf_axes(name, quantized):
            jspec = jax_shardings_for(axes, mesh).spec
            assert logical_to_spec(axes) == tuple(jspec) + (None,) * (
                len(axes) - len(jspec)), leaf
            jsh = jax.sharding.NamedSharding(mesh, jspec)
            where = jsh.devices_indices_map(tuple(shape))
            for rank in range(tp):
                sh = Sharding(port_mesh(tp, rank), logical_to_spec(axes))
                assert sh.shard_shape(shape) == jsh.shard_shape(
                    tuple(shape)), leaf
                want = tuple(slice(s.start or 0, shape[i] if s.stop is None
                                   else s.stop)
                             for i, s in enumerate(where[
                                 jax.devices()[rank]]))
                assert sh.slices(shape) == want, (leaf, rank)

    def test_shardings_for_mirrors_the_tree(self):
        axes = llama.param_logical_axes(llama.preset("tiny-qwen"))
        tree = shardings_for(axes, port_mesh(2, 1))
        assert tree["layers"]["bk"].spec == (None, "model")
        assert tree["embed"].spec == ("model", None)
        assert tree["lm_head"].parts() == 2
        assert tree["final_norm"].parts() == 1
        with pytest.raises(ValueError, match="evenly"):
            Sharding(port_mesh(4, 0), ("model",)).slices((6,))

    @pytest.mark.parametrize("k,n,tp,axis", [
        (64, 128, 2, "n"),     # packs
        (128, 64, 2, "k"),     # packs
        (64, 20, 4, "n"),      # 5 columns a rank: no tile either way
        (64, 100, 4, "n"),     # 100 % 4: indivisible
        (64, 4, 1, "n"),       # single device, untileable
    ])
    def test_pack_reasons_equal_jax(self, k, n, tp, axis):
        """The degrade reason of a full [k, n] leaf split over the model
        axis is the JAX package's, for shapes both kernels' tilings agree
        on (the port's panels are 64 wide and K steps 32; the JAX CPU
        tiles 8)."""
        from symmetry_tpu.ops.quant import _pack_quantized_report
        from symmetry_tpu.ops.quant import quantize as jax_quantize
        from symmetry_tpu_torch.ops.quant import pack_reason

        qt = jax_quantize(jax.random.normal(jax.random.key(0), (k, n)))
        kw = {"k_axis" if axis == "k" else "n_axis": "model"}
        _, want = _pack_quantized_report(qt, mesh=jax_mesh(tp), **kw)
        parts = (tp, 1) if axis == "k" else (1, tp)
        assert pack_reason(k, n, *parts) == want

    def test_size_one_axis_packs_single_device(self):
        from symmetry_tpu_torch.ops.quant import pack_quantized, quantize

        leaf = pack_quantized(quantize(torch.randn(64, 128)),
                              mesh=port_mesh(1, 0), n_axis="model")
        assert leaf.mesh is None and leaf.n_axis is None

    @pytest.mark.parametrize("cmd", [
        dict(kind=1, slot=1, true_len=5, bucket=16, temperature=0.7,
             top_p=0.9, top_k=40, seed=12345,
             tokens=np.arange(3, 8, dtype=np.int32)),
        dict(kind=2),
        dict(kind=1, slot=0, true_len=2, bucket=16, temperature=0.0,
             top_p=1.0, tokens=np.array([9, 8], np.int32)),
        dict(kind=4),
        dict(kind=3),
    ])
    def test_command_vector_equals_jax(self, cmd):
        port = multihost.Command(**cmd).encode(16)
        want = jax_multihost.Command(**cmd).encode(16)
        np.testing.assert_array_equal(port, want)
        assert port.dtype == want.dtype
        back = multihost.Command.decode(port)
        jback = jax_multihost.Command.decode(want)
        for field in ("kind", "slot", "true_len", "bucket", "temperature",
                      "top_p", "top_k", "seed"):
            assert getattr(back, field) == getattr(jback, field), field
        np.testing.assert_array_equal(back.tokens, jback.tokens)

    def test_payload_round_trip(self):
        from symmetry_tpu_torch.engine.engine import SamplingParams

        assignments = [(1, [5, 6, 7], SamplingParams(0.5, 0.75, 3, 9, 2)),
                       (0, [1], SamplingParams(seed=4))]
        words = np.asarray(multihost._encode_assignments(assignments),
                           np.int32)
        assert multihost._decode_assignments(words) == assignments


class TestRefusals:
    @pytest.mark.parametrize("raw", [
        {"mesh": {"data": 2}},
        {"mesh": {"model": 2, "context": 2}},
        {"mesh": {"stage": 2}},
        {"mesh": {"expert": 2}},
        {"model_preset": "tiny-moe", "mesh": {"model": 2}},
        {"mesh": {"model": 2}, "multihost": {
            "coordinator": "127.0.0.1:1", "num_processes": 4,
            "process_id": 0, "dcn_data": 2}},
        {"pipeline_microbatches": 2},
    ])
    def test_out_of_slice_names_item_14(self, raw):
        """Refused before any process group is joined (a multihost section
        pointing nowhere is never dialled)."""
        with pytest.raises(EngineError, match="item 14"):
            InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                            device="cpu")

    def test_mesh_without_a_job_says_how_to_run_it(self):
        with pytest.raises(EngineError, match="engine host"):
            InferenceEngine.from_tpu_config(
                TpuConfig.from_dict({"mesh": {"model": 2}}), device="cpu")

    def test_indivisible_heads_refused(self):
        with pytest.raises(EngineError, match="num_kv_heads"):
            InferenceEngine.from_tpu_config(
                TpuConfig.from_dict({"mesh": {"model": 4}}), device="cpu")

    def test_role_needs_one_device(self):
        params = llama.init_params(llama.preset("tiny"),
                                   torch.Generator().manual_seed(0),
                                   torch.float32)
        from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer

        with pytest.raises(EngineError, match="single-device"):
            InferenceEngine(llama.preset("tiny"), params, ByteTokenizer(512),
                            mesh=port_mesh(2, 0), role="prefill",
                            prefill_chunk=8, device="cpu")

    def test_ring_mesh_refused(self):
        cfg = llama.preset("tiny")
        params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   torch.float32)
        cache = llama.init_cache(cfg, 1, 8, torch.float32, device="cpu")
        with pytest.raises(NotImplementedError, match="item 14"):
            llama.forward_hidden(params, cfg, torch.zeros((1, 4),
                                                          dtype=torch.long),
                                 cache, prefill_flash=True,
                                 ring_mesh=object())


# ---------------------------------------------------------------------------
# Two ranks on the CPU


def jax_forward_ref(tree, cfg, mesh, tokens, *, quantized=False):
    params = jax_sharded(tree, cfg, mesh, quantized=quantized)
    B, S = tokens.shape
    cache = jax_llama.init_cache(cfg, B, S + 4, jnp.float32)
    fwd = jax.jit(jax_llama.forward, static_argnums=(1,))
    logits, cache = fwd(params, cfg, jnp.asarray(tokens), cache)
    step, _ = fwd(params, cfg, jnp.asarray(tokens[:, -1:]), cache)
    return np.asarray(logits), np.asarray(step)


def jax_serve(tree, cfg, mesh, rounds: int, *, quantized=False,
              kv_quant=False):
    """The JAX engine on the mesh, through its Scheduler, greedy: each
    round's tokens per prompt."""
    engine = JaxEngine(cfg, jax_sharded(tree, cfg, mesh, quantized=quantized),
                       JaxByteTokenizer(), mesh=mesh, kv_quant=kv_quant,
                       cache_dtype=jnp.float32, **GEOMETRY)
    out = []
    for rnd in range(rounds):
        sched = JaxScheduler(engine)
        ids = [[] for _ in PROMPTS]
        done = [threading.Event() for _ in PROMPTS]
        for i, prompt in enumerate(PROMPTS):
            def emit(ev, i=i):
                if ev.token_id is not None:
                    ids[i].append(int(ev.token_id))
                if ev.done:
                    done[i].set()
            sched.submit(JaxRequest(prompt_ids=list(prompt),
                                    sampling=JaxSampling(),
                                    max_new_tokens=MAX_NEW, emit=emit,
                                    id=f"j{rnd}-{i}"))
        sched.start()
        try:
            for ev in done:
                assert ev.wait(120)
        finally:
            sched.stop()
        out.append(ids)
    return out, engine


TOKENS = np.array([[3, 17, 91, 200, 5, 44, 8, 120, 7, 63],
                   [9, 8, 7, 6, 5, 4, 3, 2, 1, 0]], np.int32)
ENGINE_JOB = dict(kind="engine", prompts=PROMPTS, max_new=MAX_NEW, rounds=2,
                  engine={k: list(v) if isinstance(v, tuple) else v
                          for k, v in GEOMETRY.items()})


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A float32 `tiny` checkpoint (2 shards) with bf16 and int8 warm
    caches written by single-rank loads."""
    path = str(tmp_path_factory.mktemp("tp_ckpt"))
    cfg = llama.preset("tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(3),
                               torch.float32)
    weights.save_checkpoint(path, params, cfg, shards=2)
    for quantize in (False, True):
        full, got = weights.load_checkpoint(path, dtype=torch.bfloat16,
                                            quantize=quantize, device="cpu")
        weights.save_warm_cache(path, full, got, dtype=torch.bfloat16,
                                quantize=quantize)
    return path


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, ckpt):
    tmp = tmp_path_factory.mktemp("tp_run")
    trees = {"tiny": jax_tree("tiny", 0), "tiny-qwen": jax_tree("tiny-qwen", 1),
             "int8": jax_tree("tiny", 0, quantize=True)}
    files = {k: to_npz(t, str(tmp / f"{k}.npz")) for k, t in trees.items()}
    rng = np.random.default_rng(0)
    qmm = {}
    for mode, (k, n) in (("row", (256, 128)), ("col", (128, 256))):
        w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
        amax = np.maximum(np.abs(w).max(axis=0), 1e-8)
        scale = (amax * np.float32(1 / 127)).astype(np.float32)
        q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        x = rng.standard_normal((2, 3, k)).astype(np.float32)
        qmm[mode] = (x, q, scale)
        np.savez(str(tmp / f"qmm_{mode}.npz"), x=x, q=q, scale=scale)
    jobs = [
        dict(name="fwd_tiny", kind="forward", preset="tiny",
             weights=files["tiny"], tokens=TOKENS.tolist()),
        dict(name="fwd_qwen", kind="forward", preset="tiny-qwen",
             weights=files["tiny-qwen"], tokens=TOKENS.tolist()),
        dict(name="fwd_bf16", kind="forward", preset="tiny",
             weights=files["tiny"], tokens=TOKENS.tolist(),
             dtype="bfloat16"),
        dict(name="fwd_int8", kind="forward", preset="tiny",
             weights=files["int8"], tokens=TOKENS.tolist()),
        dict(name="fwd_int8_packed", kind="forward", preset="tiny",
             weights=files["int8"], tokens=TOKENS.tolist(), pack=True),
        dict(ENGINE_JOB, name="serve_f32", preset="tiny",
             weights=files["tiny"]),
        dict(name="direct", kind="direct", preset="tiny",
             weights=files["tiny"], engine={
                 k: list(v) if isinstance(v, tuple) else v
                 for k, v in GEOMETRY.items()}),
        dict(ENGINE_JOB, name="serve_int8", preset="tiny",
             weights=files["int8"]),
        dict(ENGINE_JOB, name="serve_int8_fused", preset="tiny",
             weights=files["int8"],
             engine=dict(ENGINE_JOB["engine"], fused_dequant=True,
                         kv_quant=True)),
        *[dict(name=f"load_{'warm' if warm else 'cold'}_"
                    f"{'int8' if quantize else 'bf16'}", kind="load",
               path=ckpt, dtype="bfloat16", quantize=quantize, warm=warm)
          for warm in (False, True) for quantize in (False, True)],
        dict(name="qmm_row", kind="qmm", data=str(tmp / "qmm_row.npz"),
             k_axis="model", n_axis=None),
        dict(name="qmm_col", kind="qmm", data=str(tmp / "qmm_col.npz"),
             k_axis=None, n_axis="model"),
    ]
    out = run_ranks(tmp, jobs)
    return types.SimpleNamespace(out=out, trees=trees, qmm=qmm)


class TestTwoRanks:
    @pytest.mark.parametrize("job,tree,name", [
        ("fwd_tiny", "tiny", "tiny"), ("fwd_qwen", "tiny-qwen", "tiny-qwen")])
    def test_forward_equals_jax_mesh(self, two_ranks, job, tree, name):
        """Prefill logits over every position and the next decode step's,
        within 1e-5 of the JAX forward on a model=2 mesh, on every rank."""
        cfg = jax_preset(name)
        want = jax_forward_ref(two_ranks.trees[tree], cfg, jax_mesh(2),
                               TOKENS)
        for rank in range(2):
            got = load_out(two_ranks.out, job, rank)
            np.testing.assert_allclose(got["prefill"], want[0], atol=1e-5,
                                       rtol=0)
            np.testing.assert_allclose(got["decode"], want[1], atol=1e-5,
                                       rtol=0)

    def test_bf16_forward_equals_one_rank(self, two_ranks):
        """In bf16 the row-parallel sums run in float32 and round once, as
        GSPMD lowers the JAX package's sharded dot (and as one rank's bf16
        product rounds its float32 sum once): the TP=2 logits equal one
        rank's within one bf16 step of the largest."""
        from symmetry_tpu_torch.convert import params_from_numpy

        cfg = llama.preset("tiny")
        params = params_from_numpy(two_ranks.trees["tiny"], device="cpu",
                                   dtype=torch.bfloat16)
        tokens = torch.from_numpy(TOKENS)
        cache = llama.init_cache(cfg, 2, TOKENS.shape[1] + 4, torch.bfloat16,
                                 device="cpu")
        logits, cache = llama.forward(params, cfg, tokens, cache)
        step, _ = llama.forward(params, cfg, tokens[:, -1:], cache)
        got = load_out(two_ranks.out, "fwd_bf16", 0)
        for key, ref in (("prefill", logits), ("decode", step)):
            ref = ref.float().numpy()
            tol = 2.0 ** -7 * float(np.abs(ref).max())
            np.testing.assert_allclose(got[key], ref, atol=tol, rtol=0)

    def test_cache_holds_this_ranks_kv_heads(self, two_ranks):
        cfg = llama.preset("tiny")
        for rank in range(2):
            k = load_out(two_ranks.out, "fwd_tiny", rank)["cache_k"]
            assert k.shape[3] == cfg.num_kv_heads // 2

    @pytest.mark.parametrize("job", ["fwd_int8", "fwd_int8_packed"])
    def test_int8_forward_equals_jax_mesh(self, two_ranks, job):
        """Int8 weights, flat (the mixed dot, reduce then scale) and packed
        (W8A16 on each rank's block, row- and column-parallel), against the
        JAX int8 forward on the mesh (its unfused path)."""
        want = jax_forward_ref(two_ranks.trees["int8"], jax_preset("tiny"),
                               jax_mesh(2), TOKENS, quantized=True)
        got = load_out(two_ranks.out, job, 0)
        np.testing.assert_allclose(got["prefill"], want[0], atol=1e-5,
                                   rtol=0)
        if job == "fwd_int8":
            np.testing.assert_allclose(got["decode"], want[1], atol=1e-5,
                                       rtol=0)

    @pytest.mark.parametrize("job,quantized,kv_quant", [
        ("serve_f32", False, False), ("serve_int8", True, False),
        ("serve_int8_fused", True, True)])
    def test_scheduler_tokens_equal_jax_engine(self, two_ranks, job,
                                               quantized, kv_quant):
        """Greedy tokens of the Scheduler over the TP=2 engine (chunked
        prefill, coalesced prefill, and a second round of prefix hits)
        equal the JAX engine's on a model=2 mesh; int8 against its
        fused_dequant-off path (the port's fused run with an int8 KV
        cache, against the JAX engine's kv_quant)."""
        tree = two_ranks.trees["int8" if quantized else "tiny"]
        want, jengine = jax_serve(tree, jax_preset("tiny"), jax_mesh(2),
                                  rounds=2, quantized=quantized,
                                  kv_quant=kv_quant)
        got = load_out(two_ranks.out, job, 0)
        assert got["served"] == want
        assert got["prefix_cache"]["hits"] > 0
        if job == "serve_f32":
            assert got["weight_stream_bytes"] == jengine.weight_stream_bytes()
            assert (got["weight_stream_bytes_per_device"]
                    == jengine.weight_stream_bytes_per_device())

    def test_int8_weight_stream_bytes_equal_jax(self, two_ranks):
        jengine = JaxEngine(
            jax_preset("tiny"), jax_sharded(two_ranks.trees["int8"],
                                            jax_preset("tiny"), jax_mesh(2),
                                            quantized=True),
            JaxByteTokenizer(), mesh=jax_mesh(2), max_slots=2,
            max_seq_len=32, prefill_buckets=(16,), cache_dtype=jnp.float32)
        for job in ("serve_int8", "serve_int8_fused"):
            got = load_out(two_ranks.out, job, 1)
            assert got["weight_stream_bytes"] == jengine.weight_stream_bytes()
            assert (got["weight_stream_bytes_per_device"]
                    == jengine.weight_stream_bytes_per_device())
            assert got["weight_stream_bytes_per_device"] < got[
                "weight_stream_bytes"]

    def test_every_command_kind_equals_one_rank(self, two_ranks):
        """One call of each dispatching kind through the command loop's
        facade (single, coalesced, chunked and cached prefill, a hit and a
        miss, decode, a speculative verify, a released slot) gives one
        port rank's outputs; both ranks end with the same slot lengths."""
        from symmetry_tpu_torch.convert import params_from_numpy
        from symmetry_tpu_torch.engine.spec import SpecConfig
        from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
        from torch_tp_worker import direct_calls

        cfg = llama.preset("tiny")
        engine = InferenceEngine(
            cfg, params_from_numpy(two_ranks.trees["tiny"], device="cpu"),
            ByteTokenizer(cfg.vocab_size), device="cpu",
            cache_dtype=torch.float32, speculative=SpecConfig(k_draft=2),
            **GEOMETRY)
        want = direct_calls(engine)
        r0, r1 = (load_out(two_ranks.out, "direct", r) for r in range(2))
        assert r0["calls"] == [list(map(int, c)) for c in want]
        assert r0["lengths"] == r1["lengths"] == [
            engine.slot_length(s) for s in range(2)]
        assert want[5] == [32]   # the lookup hit two 16-token blocks

    @pytest.mark.parametrize("job", ["serve_f32", "serve_int8",
                                     "serve_int8_fused"])
    def test_ranks_in_lockstep(self, two_ranks, job):
        """Every rank's engine produced the same tokens at every command
        and ends with the same slot lengths (the port of the JAX package's
        two-process lockstep test)."""
        r0, r1 = (load_out(two_ranks.out, job, r) for r in range(2))
        assert r0["recorded"] and r0["recorded"] == r1["recorded"]
        assert r0["lengths"] == r1["lengths"]

    @pytest.mark.parametrize("name", ["load_cold_bf16", "load_cold_int8",
                                      "load_warm_bf16", "load_warm_int8"])
    def test_sharded_load_equals_sliced_single_load(self, two_ranks, ckpt,
                                                    name):
        """Each rank's blocks are bit-equal to slicing the single-rank load
        of the same checkpoint: the cold int8 load's row-parallel scales
        take the amax over every rank's rows."""
        quantize = name.endswith("int8")
        if name.startswith("load_warm"):
            full, cfg = weights.load_warm_cache(
                ckpt, dtype=torch.bfloat16, quantize=quantize, device="cpu")
        else:
            full, cfg = weights.load_checkpoint(
                ckpt, dtype=torch.bfloat16, quantize=quantize, device="cpu")
        for rank in range(2):
            want = llama.shard_params(full, cfg, port_mesh(2, rank))
            got = load_out(two_ranks.out, name, rank)
            flat = {}
            for key, leaf in weights._flatten_params(want):
                flat[key] = leaf.float().numpy() \
                    if leaf.dtype == torch.bfloat16 else leaf.numpy()
            assert sorted(got) == sorted(flat)
            for key, arr in flat.items():
                np.testing.assert_array_equal(got[key], arr, err_msg=key)
            if quantize:
                # wo is row-parallel: its scales are the whole leaf's
                assert np.array_equal(got["layers/wo:scale"],
                                      full["layers"]["wo"].scale.numpy())

    @pytest.mark.parametrize("mode", ["row", "col"])
    def test_sharded_w8a16_against_numpy_reference(self, two_ranks, mode):
        """w8a16_apply_sharded on each rank's block against the numpy
        reference of tests/test_qmm_mesh.py: row-parallel sums the float32
        partials and scales after the sum; column-parallel gives each rank
        its output columns."""
        x, q, scale = two_ranks.qmm[mode]
        acc = x.astype(np.float32) @ q.astype(np.float32)
        want = (acc * scale[None, :]).astype(x.dtype)
        for rank in range(2):
            got = load_out(two_ranks.out, f"qmm_{mode}", rank)["y"]
            block = (want if mode == "row"
                     else want[..., rank * 128:(rank + 1) * 128])
            np.testing.assert_allclose(got, block, atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# The engine host with a one-host mesh


TPU = {"model_preset": "tiny", "dtype": "float32", "max_batch_size": 2,
       "max_seq_len": 256, "prefill_buckets": [32, 64, 128, 256],
       "prefill_chunk": 32, "prefix_cache_mb": 1, "decode_block": 4,
       "compile_cache": False}
CHATS = ["hello there",
         "hello there, and a longer message that runs past one chunk of "
         "thirty-two tokens",
         "hello there, and a longer message that runs past one chunk of "
         "thirty-two tokens, once more"]


class HostProc:
    """`python -m symmetry_tpu_torch.engine.host cfg --device cpu`."""

    def __init__(self, tmp_path, tpu: dict, tag: str) -> None:
        cfg = {"name": "tp-host", "public": False, "serverKey": "00" * 32,
               "modelName": "tiny:tp", "apiProvider": "tpu_native",
               "tpu": {**TPU, **tpu}}
        path = tmp_path / f"{tag}.json"
        path.write_text(json.dumps(cfg))
        self.log = open(tmp_path / f"{tag}.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "symmetry_tpu_torch.engine.host",
             str(path), "--device", "cpu"], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.log, text=True, env=env(),
            cwd=REPO)
        self.ready = self.frame("ready")

    def frame(self, op=None, req=None, timeout=120):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                raise AssertionError("host exited; see its log")
            f = json.loads(line)
            if op is not None and f.get("op") == op:
                return f
            if req is not None and f.get("op") in ("event", "events"):
                evs = [f] if f["op"] == "event" else f["events"]
                for e in evs:
                    if e["id"] == req:
                        self.text += e.get("text", "")
                        if e.get("done"):
                            return e
        raise AssertionError(f"no {op or req} frame in {timeout} s")

    def send(self, obj) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def chat(self, i: int, content: str) -> str:
        self.text = ""
        self.send({"op": "submit", "id": f"r{i}", "max_new": 12,
                   "messages": [{"role": "user", "content": content}],
                   "sampling": {"temperature": 0.0}})
        self.frame(req=f"r{i}")
        return self.text

    def close(self) -> int:
        if self.proc.poll() is None:
            self.send({"op": "shutdown"})
        try:
            return self.proc.wait(60)
        finally:
            self.log.close()


def children(pid: int) -> list[int]:
    with open(f"/proc/{pid}/task/{pid}/children", encoding="utf-8") as fh:
        return [int(c) for c in fh.read().split()]


def gone(pid: int, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.1)
    return False


class TestHostMesh:
    def test_host_serves_the_single_rank_text(self, tmp_path):
        """The host with tpu.mesh {model: 2} starts its follower rank and
        streams the single-rank host's text, through chunked prefill and
        prefix hits; stats show the layout."""
        single = HostProc(tmp_path, {}, "single")
        want = [single.chat(i, c) for i, c in enumerate(CHATS)]
        assert single.close() == 0
        host = HostProc(tmp_path, {"mesh": {"model": 2}}, "tp2")
        follower, = children(host.proc.pid)
        got = [host.chat(i, c) for i, c in enumerate(CHATS)]
        host.send({"op": "stats"})
        stats = host.frame("stats")
        assert host.close() == 0
        assert got == want
        assert stats["mesh"] == {"shape": {"model": 2}, "rank": 0,
                                 "device": "cpu", "devices": ["cpu", "cpu"],
                                 "backend": "gloo", "shared_device": False}
        assert stats["prefix_cache"]["hits"] >= 1
        assert gone(follower)

    def test_follower_dies_with_its_host(self, tmp_path):
        """A SIGKILLed host (a supervisor's respawn) leaves no follower
        rank behind."""
        host = HostProc(tmp_path, {"mesh": {"model": 2}}, "killed")
        follower, = children(host.proc.pid)
        host.proc.send_signal(signal.SIGKILL)
        host.proc.wait(30)
        host.log.close()
        assert gone(follower)


# ---------------------------------------------------------------------------
# The provider: the in-process backend as rank 0, a --worker rank


def mh_config(port: int, rank: int) -> dict:
    return {"name": "mh", "public": False, "serverKey": "00" * 32,
            "modelName": "tiny:mh", "apiProvider": "tpu_native",
            "tpu": {"model_preset": "tiny", "dtype": "float32",
                    "max_batch_size": 2, "max_seq_len": 64,
                    "prefill_buckets": [32], "decode_block": 2,
                    "engine_isolation": "inproc", "compile_cache": False,
                    "mesh": {"model": 2},
                    "multihost": {"coordinator": f"127.0.0.1:{port}",
                                  "num_processes": 2, "process_id": rank}}}


def test_inproc_rank0_serves_with_a_worker_under_the_gate(tmp_path):
    """tpu.multihost at 2 processes (gloo, CPU): the in-process backend's
    rank 0 serves a chat with `python -m symmetry_tpu_torch.provider
    --worker` as rank 1. Its command loop executes every engine call
    holding the device gate, so a profiler capture holding the gate stops
    the loop until it lets go."""
    from symmetry_tpu_torch.provider.backends.tpu_native import (
        TpuNativeBackend)

    port = free_port()
    wpath = tmp_path / "worker.json"
    wpath.write_text(json.dumps(mh_config(port, 1)))
    worker = subprocess.Popen(
        [sys.executable, "-m", "symmetry_tpu_torch.provider", "-c",
         str(wpath), "--worker", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env(),
        cwd=REPO)
    backend = TpuNativeBackend(ConfigManager(config=mh_config(port, 0)),
                               device="cpu")
    held = []

    async def main():
        await backend.start()
        try:
            gate = backend._device_gate
            engine = backend._engine
            decode = engine.decode_steps_dispatch

            def watched(_engine):
                held.append(gate._is_owned())
                return decode()

            engine.decode_steps_dispatch = types.MethodType(watched, engine)
            first = await _collect(backend)
            # A capture holds the gate: the loop waits for it.
            gate.acquire()
            try:
                task = asyncio.ensure_future(_collect(backend))
                await asyncio.sleep(1.0)
                assert not task.done()
                n_held = len(held)
            finally:
                gate.release()
            second = await asyncio.wait_for(task, 60)
            assert len(held) > n_held
            return first, second
        finally:
            await backend.stop()

    try:
        first, second = asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(main(), 180))
        out, err = worker.communicate(timeout=60)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    assert worker.returncode == 0, err[-3000:]
    assert first and first == second
    assert held and all(held)


async def _collect(backend) -> str:
    from symmetry_tpu_torch.provider.backends.base import InferenceRequest

    request = InferenceRequest(messages=[{"role": "user", "content": "hi"}],
                               max_tokens=8, temperature=0.0)
    return "".join([c.text async for c in backend.stream(request)])


@pytest.mark.slow  # as the JAX package's: three processes and a server
def test_multihost_provider_end_to_end(tmp_path):
    """Full system: server + rank-0 provider (its engine host is rank 0) +
    client in one process, a `--worker` rank following in another: one
    logical provider, two processes, tensor-parallel over the model axis."""
    port = free_port()
    wpath = tmp_path / "worker.json"
    wcfg = mh_config(port, 1)
    wcfg["tpu"].pop("engine_isolation")
    wpath.write_text(json.dumps(wcfg))
    rank0 = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_tp_provider_rank0.py"),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env(), cwd=REPO)
    worker = subprocess.Popen(
        [sys.executable, "-m", "symmetry_tpu_torch.provider", "--worker",
         "-c", str(wpath), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env(),
        cwd=REPO)
    try:
        out0, err0 = rank0.communicate(timeout=280)
        assert rank0.returncode == 0, f"rank0 failed:\n{err0[-3000:]}"
        _, errw = worker.communicate(timeout=60)
        assert worker.returncode == 0, f"worker failed:\n{errw[-3000:]}"
    finally:
        for p in (rank0, worker):
            if p.poll() is None:
                p.kill()
                p.wait()
    result = next(json.loads(line[len("RESULT "):])
                  for line in out0.splitlines() if line.startswith("RESULT "))
    assert result["ok"] and result["text_len"] > 0
