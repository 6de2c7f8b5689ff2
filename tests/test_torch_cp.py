"""The `context` mesh axis in the port (parallel/ring.py, ulysses.py and
forward_hidden's `ring_mesh`) against the JAX package on its CPU mesh.

The JAX references run here on the conftest's virtual CPU devices
(`build_mesh(MeshSpec(context=N))`, alone or beside another axis). The
port's ranks are processes (tests/torch_tp_worker.py) joined by
torch.distributed over gloo on the CPU. One spawn of two ranks runs the
{context: 2} jobs; one spawn of four runs ring and Ulysses at context 4
(the mesh tests/test_ring.py and tests/test_ulysses.py use), the engine
at {context: 2, model: 2} and {data: 2, context: 2}, and forward_hidden
with ring_mesh beside the other axes, each job on its own mesh.

  - ring_attention and ulysses_attention within 2e-4 of the JAX functions
    at context 2 and 4, (nq, nkv) (4, 4) and (4, 2) (Ulysses at 4 ranks:
    (8, 8) and (8, 4), its heads split four ways), ragged seq_lens; their
    refusals in the JAX words;
  - forward_hidden(ring_mesh, sp_mode), both modes: hidden states within
    2e-4 of the JAX forward on its context mesh, with the JAX forward's
    cache, and logits within 1e-5 of one port rank's flash forward;
  - the same beside the other axes, each rank holding its blocks:
    `tiny` at {context: 2, model: 2} (Ulysses gathers the heads: one kv
    head a rank) and {data: 2, context: 2}, float32 and int8 KV,
    `tiny-mha` at {context: 2, model: 2} (Ulysses scatters a rank's own
    heads), `tiny-moe` at {context: 2, expert: 2}, and a whole `tiny`
    tree over {stage: 2, context: 2} (the stage ranks replicas): every
    rank's hidden states within 2e-4 of the JAX forward on the same mesh,
    its cache the matching head block of the JAX cache; Ulysses at
    {context: 4, model: 2} refused in the JAX words;
  - the engine (whose context ranks are replicas, as the JAX engine's)
    gives the JAX engine's greedy tokens on the same mesh;
  - the engine host with `tpu.mesh: {context: 2}` starts its follower,
    which dies with it.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.models import llama as jax_llama
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.parallel import MeshSpec as JaxMeshSpec
from symmetry_tpu.parallel import build_mesh as jax_build_mesh
from symmetry_tpu.parallel.ring import ring_attention as jax_ring
from symmetry_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.models import llama
from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec
from symmetry_tpu_torch.parallel.ring import ring_attention
from symmetry_tpu_torch.parallel.ulysses import ulysses_attention
from test_torch_dp import serve_together
from test_torch_moe import moe_tree
from test_torch_tp import (HostProc, children, gone, jax_serve, jax_sharded,
                           jax_tree, load_out, run_ranks, to_npz)

SP_TOL = 2e-4   # the JAX ring and Ulysses tests' tolerance
ATOL = 1e-5
GEOMETRY = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
                decode_block=2, prefill_chunk=16, prefix_cache_bytes=2**20)
# (ranks, nq, nkv): the JAX tests' head counts (Ulysses at four ranks
# needs both counts divisible by four).
SP_CASES = [(2, 4, 4), (2, 4, 2), (4, 4, 4), (4, 4, 2), (4, 8, 8), (4, 8, 4)]
SP_LENS = [64, 50]
FWD_LENS = [64, 40]
_rng = np.random.default_rng(1)
FWD_TOKENS = _rng.integers(0, 512, (2, 64))
MESHES = {"context2_model2": {"context": 2, "model": 2},
          "data2_context2": {"data": 2, "context": 2}}
# forward_hidden(ring_mesh) beside another axis, on four ranks: job ->
# (preset, mesh, sharded: the ranks hold their blocks and pass `mesh`;
# else the whole tree, the other axis's ranks replicas).
RING_MESH = {
    "tiny_context2_model2": ("tiny", MESHES["context2_model2"], True),
    "mha_context2_model2": ("tiny-mha", MESHES["context2_model2"], True),
    "tiny_data2_context2": ("tiny", MESHES["data2_context2"], True),
    "moe_context2_expert2": ("tiny-moe", {"context": 2, "expert": 2}, True),
    "tiny_stage2_context2": ("tiny", {"stage": 2, "context": 2}, False),
}
RING_MESH_INT8_KV = ("tiny_context2_model2", "tiny_data2_context2")
RING_MESH_RUNS = [(job, q) for job in RING_MESH
                  for q in (False, True) if not q or job in RING_MESH_INT8_KV]


def jax_mesh(shape: dict):
    spec = JaxMeshSpec(**shape)
    return jax_build_mesh(spec, jax.devices()[:spec.size])


def sp_inputs(nq: int, nkv: int) -> dict:
    rng = np.random.default_rng(nq * 10 + nkv)
    B, S, D = 2, 64, 16
    return {"q": rng.normal(size=(B, S, nq, D)).astype(np.float32),
            "k": rng.normal(size=(B, S, nkv, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, nkv, D)).astype(np.float32),
            "seq_lens": np.array(SP_LENS, np.int32)}


def sp_name(ranks, nq, nkv) -> str:
    return f"sp{ranks}_{nq}_{nkv}"


def sp_jobs(tmp, ranks: int) -> list[dict]:
    jobs = []
    for n, nq, nkv in SP_CASES:
        if n != ranks:
            continue
        path = str(tmp / f"{sp_name(n, nq, nkv)}.npz")
        np.savez(path, **sp_inputs(nq, nkv))
        jobs.append(dict(name=sp_name(n, nq, nkv), kind="sp", data=path,
                         mesh={"context": n}, ulysses=nkv % n == 0))
    return jobs


def engine_job(name: str, weights: str, mesh: dict, **engine) -> dict:
    from test_torch_tp import MAX_NEW, PROMPTS

    return dict(kind="engine", name=name, preset="tiny", weights=weights,
                prompts=PROMPTS, max_new=MAX_NEW, rounds=2, mesh=mesh,
                engine={k: list(v) if isinstance(v, tuple) else v
                        for k, v in {**GEOMETRY, **engine}.items()})


@pytest.fixture(scope="module")
def trees():
    return {"tiny": jax_tree("tiny", 0),
            "int8": jax_tree("tiny", 0, quantize=True),
            "tiny-mha": jax_tree("tiny-mha", 0), "tiny-moe": moe_tree()}


def ring_mesh_name(job: str, kv_quant: bool) -> str:
    return f"ringfwd_{job}{'_q' if kv_quant else ''}"


def ring_mesh_jobs(files: dict) -> list[dict]:
    jobs = []
    for job, kv_quant in RING_MESH_RUNS:
        name, shape, sharded = RING_MESH[job]
        jobs.append(dict(name=ring_mesh_name(job, kv_quant), kind="ring_fwd",
                         preset=name, weights=files[name], sharded=sharded,
                         tokens=FWD_TOKENS.tolist(), seq_lens=FWD_LENS,
                         kv_quant=kv_quant, mesh=shape))
    return jobs


@pytest.fixture(scope="module")
def context2(tmp_path_factory, trees):
    tmp = tmp_path_factory.mktemp("cp2")
    files = {k: to_npz(t, str(tmp / f"{k}.npz")) for k, t in trees.items()}
    ctx = {"context": 2}
    jobs = sp_jobs(tmp, 2)
    jobs[0]["refusals"] = [["ring", 31, 2, 2], ["ulysses", 31, 2, 2],
                           ["ulysses", 32, 3, 3]]
    jobs += [dict(name=f"ring_fwd{'_q' if q else ''}", kind="ring_fwd",
                  preset="tiny", weights=files["tiny"],
                  tokens=FWD_TOKENS.tolist(), seq_lens=FWD_LENS, kv_quant=q,
                  mesh=ctx) for q in (False, True)]
    jobs += [engine_job("serve_f32", files["tiny"], ctx),
             engine_job("serve_int8", files["int8"], ctx, kv_quant=True,
                        fused_dequant=True)]
    out = run_ranks(tmp, jobs, world=2, mesh=ctx)
    return types.SimpleNamespace(out=out, world=2)


@pytest.fixture(scope="module")
def four(tmp_path_factory, trees):
    tmp = tmp_path_factory.mktemp("cp4")
    files = {k: to_npz(trees[k], str(tmp / f"{k}.npz"))
             for k in ("tiny", "tiny-mha", "tiny-moe")}
    jobs = sp_jobs(tmp, 4)
    jobs += [engine_job(f"serve_{name}", files["tiny"], shape)
             for name, shape in MESHES.items()]
    jobs += ring_mesh_jobs(files)
    out = run_ranks(tmp, jobs, world=4, mesh={"context": 4})
    return types.SimpleNamespace(out=out, world=4)


class TestSequenceParallelAttention:
    @pytest.mark.parametrize("ranks,nq,nkv", SP_CASES)
    def test_equal_jax_functions(self, context2, four, ranks, nq, nkv):
        """Every rank's whole output (the shards all-gathered) within 2e-4
        of the JAX ring (and Ulysses, where the kv heads divide the ranks)
        over the valid rows of each sequence, and finite everywhere."""
        run = context2 if ranks == 2 else four
        x = sp_inputs(nq, nkv)
        mesh = jax_mesh({"context": ranks})
        args = [jnp.asarray(x[n]) for n in ("q", "k", "v", "seq_lens")]
        want = {"ring": np.asarray(jax.jit(
            lambda *a: jax_ring(*a, mesh))(*args))}
        if nkv % ranks == 0:
            want["ulysses"] = np.asarray(jax.jit(
                lambda *a: jax_ulysses(*a, mesh))(*args))
        for rank in range(run.world):
            got = load_out(run.out, sp_name(ranks, nq, nkv), rank)
            assert sorted(k for k in got if k != "refused") == sorted(want)
            for mode, ref in want.items():
                assert np.isfinite(got[mode]).all()
                for b, n in enumerate(SP_LENS):
                    np.testing.assert_allclose(got[mode][b, :n], ref[b, :n],
                                               rtol=SP_TOL, atol=SP_TOL,
                                               err_msg=mode)
            if "ulysses" in want:
                np.testing.assert_allclose(got["ulysses"], got["ring"],
                                           rtol=SP_TOL, atol=SP_TOL)

    def test_refusals_use_the_jax_words(self, context2):
        """A sequence the ranks do not divide, and (Ulysses) heads they do
        not divide, are refused with the JAX functions' words."""
        mesh = jax_mesh({"context": 2})
        want = []
        for fn, S, H in ((jax_ring, 31, 2), (jax_ulysses, 31, 2),
                         (jax_ulysses, 32, 3)):
            q = jnp.ones((1, S, H, 8))
            with pytest.raises(ValueError) as exc:
                fn(q, q, q, jnp.asarray([S]), mesh)
            want.append(str(exc.value))
        for rank in range(2):
            got = load_out(context2.out, sp_name(2, 4, 4), rank)
            assert got["refused"] == want

    def test_single_rank_mesh_is_plain_attention(self):
        """On a one-rank axis both are the whole-sequence attention."""
        from symmetry_tpu_torch.ops.attention import gqa_attention

        x = {k: torch.from_numpy(v) for k, v in sp_inputs(4, 2).items()}
        mesh = Mesh(MeshSpec())
        pos = torch.arange(64, dtype=torch.int32)[None].expand(2, 64)
        want = gqa_attention(x["q"], x["k"], x["v"], pos, x["seq_lens"])
        for fn in (ring_attention, ulysses_attention):
            got = fn(x["q"], x["k"], x["v"], x["seq_lens"], mesh)
            for b, n in enumerate(SP_LENS):
                torch.testing.assert_close(got[b, :n], want[b, :n],
                                           rtol=SP_TOL, atol=SP_TOL)


def jax_ring_forward(tree, mode: str, kv_quant: bool, name: str = "tiny",
                     shape: dict | None = None):
    """The JAX forward_hidden with ring_mesh on its mesh (`shape`, by
    default context=2; params placed by the default rules):
    (hidden states, the cache)."""
    cfg = jax_preset(name)
    mesh = jax_mesh(shape or {"context": 2})
    params = (jax.tree.map(jnp.asarray, tree) if shape is None
              else jax_sharded(tree, cfg, mesh))
    cache = jax_llama.init_cache(cfg, 2, 64, jnp.float32, quantized=kv_quant)
    fwd = jax.jit(lambda p, t, c, n: jax_llama.forward_hidden(
        p, cfg, t, c, seq_lens=n, prefill_flash=True, ring_mesh=mesh,
        sp_mode=mode))
    h, cache = fwd(params, jnp.asarray(FWD_TOKENS, jnp.int32), cache,
                   jnp.asarray(FWD_LENS, jnp.int32))
    return np.asarray(h), jax.tree.map(np.asarray, cache)


class TestRingForward:
    @pytest.mark.parametrize("mode", ["ring", "ulysses"])
    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_equal_jax_forward(self, context2, trees, mode, kv_quant):
        """The trunk with `ring_mesh` on two ranks, over the valid
        positions: hidden states within 2e-4 of the JAX forward on its
        context mesh (the JAX ring test's tolerance on these inputs), every
        rank holding the JAX forward's whole cache (the K/V the projections
        write, within float32 summation order: 5e-4 on planes that reach
        11 in magnitude; int8 payloads within one step of a rounding
        boundary) and its lengths; logits within 1e-5 of
        one port rank's flash forward. On this 64-token input one port
        rank's flash forward is itself 1.19e-5 from the JAX one-device
        flash forward's logits (float32 summation order), which the
        sequence-parallel schemes neither add to nor take away."""
        want_h, jcache = jax_ring_forward(trees["tiny"], mode, kv_quant)
        params = params_from_numpy(trees["tiny"], device="cpu")
        cfg = llama.preset("tiny")
        cache = llama.init_cache(cfg, 2, 64, torch.float32, device="cpu",
                                 quantized=kv_quant)
        one, _ = llama.forward_hidden(
            params, cfg, torch.from_numpy(FWD_TOKENS), cache,
            torch.tensor(FWD_LENS, dtype=torch.int32), prefill_flash=True)
        want = llama.logits_from_hidden(params, cfg, one).numpy()
        for rank in range(2):
            got = load_out(context2.out,
                           f"ring_fwd{'_q' if kv_quant else ''}", rank)
            logits = llama.logits_from_hidden(
                params, cfg, torch.from_numpy(got[f"{mode}_h"])).numpy()
            np.testing.assert_array_equal(got[f"{mode}_lengths"], FWD_LENS)
            for b, n in enumerate(FWD_LENS):
                np.testing.assert_allclose(got[f"{mode}_h"][b, :n],
                                           want_h[b, :n], atol=SP_TOL,
                                           rtol=SP_TOL)
                np.testing.assert_allclose(logits[b, :n], want[b, :n],
                                           atol=ATOL, rtol=0)
                for name in ("k", "v"):
                    block = got[f"{mode}_{name}"][:, b, :n]
                    ref = getattr(jcache, name)[:, b, :n]
                    if kv_quant:
                        assert np.abs(block.astype(np.int32) - ref).max() <= 1
                    else:
                        np.testing.assert_allclose(block, ref, atol=5e-4,
                                                   rtol=1e-4)

    def test_contract(self, trees):
        """ring_mesh requires the prefill-from-empty contract. Beside
        another axis above 1 it is served (the four-rank jobs below): at
        {context: 2, model: 2} a one-position call, which shards nothing,
        runs as with no ring_mesh. A stage rank's block of the layers
        (`mesh` with a stage axis) is refused, since the pipeline takes no
        ring_mesh, and so is a `mesh` of another shape than ring_mesh."""
        cfg = llama.preset("tiny")
        params = params_from_numpy(trees["tiny"], device="cpu")
        tokens = torch.from_numpy(FWD_TOKENS)
        cache = llama.init_cache(cfg, 2, 64, torch.float32, device="cpu")
        with pytest.raises(ValueError, match="prefill_flash"):
            llama.forward_hidden(params, cfg, tokens, cache,
                                 ring_mesh=Mesh(MeshSpec(context=2)))
        outs = []
        for ring in (None, Mesh(MeshSpec(context=2, model=2))):
            cache = llama.init_cache(cfg, 2, 64, torch.float32, device="cpu")
            h, _ = llama.forward_hidden(params, cfg, tokens[:, :1], cache,
                                        prefill_flash=True, ring_mesh=ring)
            outs.append(h)
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
        stage = Mesh(MeshSpec(stage=2, context=2))
        with pytest.raises(ValueError, match="pipeline_forward_hidden takes "
                                             "no ring_mesh"):
            llama.forward_hidden(params, cfg, tokens, cache,
                                 prefill_flash=True, ring_mesh=stage,
                                 mesh=stage)
        with pytest.raises(ValueError, match="differ"):
            llama.forward_hidden(params, cfg, tokens, cache,
                                 prefill_flash=True,
                                 ring_mesh=Mesh(MeshSpec(context=2)),
                                 mesh=Mesh(MeshSpec(model=2)))

    @pytest.mark.parametrize("mode", ["ring", "ulysses"])
    @pytest.mark.parametrize("job,kv_quant", RING_MESH_RUNS)
    def test_beside_other_axes_equal_jax_forward(self, four, trees, job,
                                                 kv_quant, mode):
        """forward_hidden(ring_mesh) on a mesh with another axis above 1,
        over the valid positions of every rank: hidden states within 2e-4
        of the JAX forward on the same mesh of the virtual devices (params
        placed by the default rules), the cache the JAX cache's block of
        this rank's kv heads (its `model` coordinate's; whole without one,
        or on a whole tree) within float32 summation order (int8 payloads
        within one step of a rounding boundary), and the lengths."""
        name, shape, sharded = RING_MESH[job]
        want_h, jcache = jax_ring_forward(trees[name], mode, kv_quant, name,
                                          shape)
        spec = MeshSpec(**shape)
        kv = llama.preset(name).num_kv_heads // (spec.model if sharded
                                                 else 1)
        for rank in range(spec.size):
            got = load_out(four.out, ring_mesh_name(job, kv_quant), rank)
            h0 = Mesh(spec, rank=rank).axis_index("model") * kv
            np.testing.assert_array_equal(got[f"{mode}_lengths"], FWD_LENS)
            for b, n in enumerate(FWD_LENS):
                np.testing.assert_allclose(got[f"{mode}_h"][b, :n],
                                           want_h[b, :n], atol=SP_TOL,
                                           rtol=SP_TOL, err_msg=f"rank {rank}")
                for nm in ("k", "v"):
                    block = got[f"{mode}_{nm}"][:, b, :n]
                    ref = getattr(jcache, nm)[:, b, :n, h0:h0 + kv]
                    assert block.shape == ref.shape
                    if kv_quant:
                        assert np.abs(block.astype(np.int32) - ref).max() <= 1
                    else:
                        np.testing.assert_allclose(block, ref, atol=5e-4,
                                                   rtol=1e-4)

    def test_ulysses_refused_at_context4_model2(self, trees):
        """Ulysses for `tiny` at {context: 4, model: 2}: four shards do not
        divide its two kv heads, so the JAX forward raises its ValueError;
        the port raises the same words, judged on the whole heads, before
        any layer runs, on a whole tree and on a rank's blocks (whose one
        local kv head is not what JAX judges)."""
        shape = {"context": 4, "model": 2}
        with pytest.raises(ValueError) as want:
            jax_ring_forward(trees["tiny"], "ulysses", False, "tiny", shape)
        assert "H=4, K=2, n=4" in str(want.value)
        cfg = llama.preset("tiny")
        for rank in (0, 5):
            mesh = Mesh(MeshSpec(**shape), rank=rank)
            for block in (None, mesh):
                params = params_from_numpy(trees["tiny"], device="cpu",
                                           mesh=block, config=cfg)
                cache = llama.init_cache(cfg, 2, 64, torch.float32,
                                         device="cpu", mesh=block)
                with pytest.raises(ValueError) as got:
                    llama.forward_hidden(
                        params, cfg, torch.from_numpy(FWD_TOKENS), cache,
                        torch.tensor(FWD_LENS, dtype=torch.int32),
                        prefill_flash=True, ring_mesh=mesh,
                        sp_mode="ulysses", mesh=block)
                assert str(got.value) == str(want.value)

    def test_unused_at_one_position_and_for_windows(self, trees):
        """At S == 1, and for a sliding-window model, the trunk does not
        shard the sequence: a one-rank context mesh, which has no process
        group, runs the same as no mesh."""
        import dataclasses

        cfg = llama.preset("tiny")
        params = params_from_numpy(trees["tiny"], device="cpu")
        for c, tokens in ((cfg, torch.from_numpy(FWD_TOKENS[:, :1])),
                          (dataclasses.replace(cfg, sliding_window=8),
                           torch.from_numpy(FWD_TOKENS))):
            outs = []
            for ring in (None, Mesh(MeshSpec(context=2))):
                cache = llama.init_cache(c, 2, 64, torch.float32,
                                         device="cpu")
                h, _ = llama.forward_hidden(params, c, tokens, cache,
                                            prefill_flash=True,
                                            ring_mesh=ring)
                outs.append(h)
            torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


class TestContextEngine:
    def test_tokens_equal_jax_engine(self, context2, trees):
        """{context: 2}: greedy Scheduler tokens (chunked and coalesced
        prefill, prefix hits) equal the JAX engine's on the mesh, on both
        ranks (replicas)."""
        want, _ = jax_serve(trees["tiny"], jax_preset("tiny"),
                            jax_mesh({"context": 2}), 2, geometry=GEOMETRY)
        for rank in range(2):
            got = load_out(context2.out, "serve_f32", rank)
            assert got["recorded"]
            if rank == 0:
                assert got["served"] == want
                assert got["prefix_cache"]["hits"] > 0
        r0, r1 = (load_out(context2.out, "serve_f32", r) for r in range(2))
        assert r0["recorded"] == r1["recorded"]
        assert r0["kv_cache_bytes"] == r1["kv_cache_bytes"]

    def test_int8_tokens_equal_jax_engine(self, context2, trees):
        """Int8 weights packed on each rank (fused_dequant) with an int8 KV
        cache, against the JAX engine's int8 kv_quant run on the mesh (its
        unfused path, as tests/test_torch_tp.py holds TP)."""
        want, _ = jax_serve(trees["int8"], jax_preset("tiny"),
                            jax_mesh({"context": 2}), 2, quantized=True,
                            kv_quant=True, geometry=GEOMETRY)
        assert load_out(context2.out, "serve_int8", 0)["served"] == want

    @pytest.mark.parametrize("mesh", sorted(MESHES))
    def test_with_model_or_data_equal_jax_engine(self, four, trees, mesh):
        """{context: 2, model: 2} and {data: 2, context: 2} on four ranks:
        greedy tokens equal the JAX engine's on the same mesh, every rank
        in lockstep."""
        want, _ = jax_serve(trees["tiny"], jax_preset("tiny"),
                            jax_mesh(MESHES[mesh]), 2, geometry=GEOMETRY)
        ranks = [load_out(four.out, f"serve_{mesh}", r) for r in range(4)]
        assert ranks[0]["served"] == want
        for r in ranks[1:]:
            assert r["recorded"] == ranks[0]["recorded"]
            assert r["lengths"] == ranks[0]["lengths"]


def test_host_serves_the_single_rank_text(tmp_path):
    """The engine host with tpu.mesh {context: 2} starts its follower rank
    and streams the single-rank host's text; the follower dies with it."""
    four = {"max_batch_size": 4}
    single = HostProc(tmp_path, four, "single")
    want = serve_together(single)
    assert single.close() == 0
    host = HostProc(tmp_path, {**four, "mesh": {"context": 2}}, "cp2")
    follower, = children(host.proc.pid)
    got = serve_together(host)
    host.send({"op": "stats"})
    stats = host.frame("stats")
    assert host.close() == 0
    assert got == want and all(got)
    assert stats["mesh"]["shape"] == {"context": 2}
    assert gone(follower)
