"""One rank of the mesh tests (tests/test_torch_tp.py, test_torch_dp.py,
test_torch_cp.py, test_torch_pp.py, test_torch_ep.py).

Runs as N real OS processes joined by torch.distributed over gloo on the
CPU; imports torch and the port only (the parent holds the JAX references).

    python tests/torch_tp_worker.py <spec.json> <rank>

The spec names the coordinator port, the world size, the mesh (default
the `model` axis over every rank; a job may name its own, built once per
shape, and a `dcn_data`, the hosts along its data axis), an output
directory and a list of jobs; a job may override fields of its preset
(`config`, e.g. an MoE capacity factor), and each writes
`<out>/<job>.<rank>.npz` (and the engine jobs a json of the tokens this
rank recorded). Jobs:

  forward  the port's forward of a preset on numpy weights on the mesh:
           prefill logits over every position, then one decode step's
           (with `split_batch`, each data rank runs its block of the rows
           and the logits are gathered over the data axis);
  engine   an engine on the mesh; rank 0 serves prompts greedily through
           the Scheduler and the command loop, every rank records the
           tokens its own engine produced (the lockstep check);
  direct   rank 0 makes one call of every dispatching kind through the
           command loop's facade (`direct_calls`, verify included);
  load     sharded load_checkpoint / load_warm_cache of a checkpoint dir;
  qmm      w8a16_apply_sharded on one leaf, row- and column-parallel;
  sp       ring_attention and ulysses_attention on numpy q/k/v;
  ring_fwd forward_hidden with `ring_mesh`, sp_mode "ring" and "ulysses",
           on whole weights or (`sharded`) this rank's blocks;
  pipeline pipeline_forward_hidden: a prefill, then decode steps, each
           rank's block of the cache after each;
  moe      models/moe.py's moe_mlp on one layer's blocks of numpy
           weights, at each of the job's inputs;
  verify   rank 0 prefills every slot and makes verify and decode calls
           with the job's drafts through the command loop's facade;
  quantize models/llama.py quantize_params on this rank's blocks of numpy
           weights.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import types

import numpy as np


def tree_from_npz(path: str) -> dict:
    """A params tree from flat "a/b" (and "a/b:q", "a/b:scale") keys."""
    tree: dict = {}
    with np.load(path) as z:
        items = {k: z[k] for k in z.files}
    quant: dict = {}
    for key, arr in items.items():
        base, _, part = key.partition(":")
        if part:
            quant.setdefault(base, {})[part] = arr
            continue
        node = tree
        *head, last = base.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = arr
    for base, parts in quant.items():
        node = tree
        *head, last = base.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = types.SimpleNamespace(q=parts["q"], scale=parts["scale"])
    return tree


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "/"))
        elif hasattr(v, "q"):
            from symmetry_tpu_torch.ops.quant import (PackedQuantizedTensor,
                                                      unpack_quantized)

            if isinstance(v, PackedQuantizedTensor):
                v = unpack_quantized(v)
            out[key + ":q"] = v.q.numpy()
            out[key + ":scale"] = v.scale.numpy()
        else:
            out[key] = v.float().numpy() if v.dtype.is_floating_point \
                else v.numpy()
    return out


def job_config(job):
    """The job's preset, with the fields its `config` overrides."""
    import dataclasses

    from symmetry_tpu_torch.models.llama import preset

    return dataclasses.replace(preset(job["preset"]), **job.get("config", {}))


def job_moe(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.models import moe
    from symmetry_tpu_torch.models.llama import layer_slice

    cfg = job_config(job)
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg)
    lp = {k: layer_slice(v, 0) for k, v in params["layers"].items()}
    with np.load(job["data"]) as z:
        xs = {k: torch.from_numpy(z[k]) for k in z.files}
    return {k: moe.moe_mlp(x, lp, cfg, mesh).numpy() for k, x in xs.items()}


def job_quantize(job, mesh, rank):
    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.models.llama import quantize_params

    cfg = job_config(job)
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg)
    return flat(quantize_params(params, config=cfg, mesh=mesh))


def job_sp(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.parallel.ring import ring_attention
    from symmetry_tpu_torch.parallel.ulysses import ulysses_attention

    with np.load(job["data"]) as z:
        q, k, v, lens = (torch.from_numpy(z[n]) for n in
                         ("q", "k", "v", "seq_lens"))
    out = {"ring": ring_attention(q, k, v, lens, mesh).numpy()}
    if job.get("ulysses", True):
        out["ulysses"] = ulysses_attention(q, k, v, lens, mesh).numpy()
    for fn, S, H, K in job.get("refusals", []):
        q, kv = torch.zeros((1, S, H, 8)), torch.zeros((1, S, K, 8))
        try:
            (ulysses_attention if fn == "ulysses" else ring_attention)(
                q, kv, kv, torch.tensor([S]), mesh)
            out.setdefault("refused", []).append("")
        except ValueError as exc:
            out.setdefault("refused", []).append(str(exc))
    return out


def job_ring_fwd(job, mesh, rank):
    """forward_hidden with ring_mesh = the job's mesh; with `sharded`,
    params and cache are this rank's blocks of it (`mesh` passed too),
    else whole (the other axes' ranks replicas)."""
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.models.llama import forward_hidden, init_cache

    cfg = job_config(job)
    block = mesh if job.get("sharded") else None
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=block, config=cfg)
    tokens = torch.tensor(job["tokens"])
    lens = torch.tensor(job["seq_lens"], dtype=torch.int32)
    B, S = tokens.shape
    out = {}
    for mode in ("ring", "ulysses"):
        cache = init_cache(cfg, B, S, torch.float32, device="cpu",
                           quantized=bool(job.get("kv_quant")), mesh=block)
        h, cache = forward_hidden(params, cfg, tokens, cache, lens,
                                  prefill_flash=True, ring_mesh=mesh,
                                  sp_mode=mode, mesh=block)
        out[f"{mode}_h"] = h.numpy()
        out[f"{mode}_k"] = cache.k.float().numpy()
        out[f"{mode}_v"] = cache.v.float().numpy()
        out[f"{mode}_lengths"] = cache.lengths.numpy()
    return out


def job_pipeline(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.models.llama import init_cache
    from symmetry_tpu_torch.parallel.pipeline import pipeline_forward_hidden

    cfg = job_config(job)
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg)
    tokens = torch.tensor(job["tokens"])
    lens = torch.tensor(job["seq_lens"], dtype=torch.int32)
    B, S = tokens.shape
    quant = bool(job.get("kv_quant"))
    cache = init_cache(cfg, B, S + job["steps"], torch.float32,
                       device="cpu", quantized=quant, mesh=mesh)
    out = {}
    h, cache = pipeline_forward_hidden(
        params, cfg, tokens, cache, mesh, lens,
        n_microbatches=job["micro"], prefill_flash=job.get("flash", False))
    out["prefill_h"] = h.numpy()
    steps = []
    step_tokens = torch.tensor(job["step_tokens"])
    for i in range(job["steps"]):
        h, cache = pipeline_forward_hidden(
            params, cfg, step_tokens[:, i:i + 1], cache, mesh,
            n_microbatches=job["micro"])
        steps.append(h.numpy())
    out["step_h"] = np.stack(steps)
    out["lengths"] = cache.lengths.numpy()
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(cache, name)
        if t is not None:
            out[f"cache_{name}"] = t.float().numpy() if t.dtype != torch.int8 \
                else t.numpy()
    return out


def job_forward(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.models.llama import (forward, init_cache,
                                                 pack_params)

    cfg = job_config(job)
    dtype = getattr(torch, job.get("dtype", "float32"))
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg, dtype=dtype)
    if job.get("pack"):
        pack_params(params, config=cfg, mesh=mesh)
    tokens = torch.tensor(job["tokens"])
    if job.get("split_batch"):
        from symmetry_tpu_torch.parallel.sharding import Sharding

        tokens = Sharding(mesh, ("data", None))(tokens)
    B, S = tokens.shape
    cache = init_cache(cfg, B, S + 4, dtype, device="cpu",
                       quantized=bool(job.get("kv_quant")), mesh=mesh)
    logits, cache = forward(params, cfg, tokens, cache, mesh=mesh)
    step, _ = forward(params, cfg, tokens[:, -1:], cache, mesh=mesh)
    if job.get("split_batch"):
        logits = mesh.all_gather(logits, "data", 0)
        step = mesh.all_gather(step, "data", 0)
    return {"prefill": logits.numpy(), "decode": step.numpy(),
            "cache_k": cache.k.float().numpy()}


def _stage_fallbacks() -> float:
    """QMM_FALLBACK{reason="stage_axis"} in this process so far."""
    from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

    return METRICS.counter(MetricName.QMM_FALLBACK, "",
                           labels=("reason",)).value(reason="stage_axis")


def job_engine(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                  SamplingParams)
    from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
    from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
    from symmetry_tpu_torch.parallel.multihost import (
        CMD_CHUNK_ADVANCE, CMD_DECODE, CMD_PREFILL, CMD_PREFILL_CACHED,
        CMD_PREFILL_MANY, CMD_VERIFY, CommandLoop, MultihostEngine)

    cfg = job_config(job)
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg)
    fallbacks0 = _stage_fallbacks()
    kw = dict(job.get("engine", {}))
    if "speculative" in kw:
        from symmetry_tpu_torch.engine.spec import SpecConfig

        kw["speculative"] = SpecConfig.from_knob(kw["speculative"])
    engine = InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                             mesh=mesh, device="cpu",
                             cache_dtype=torch.float32, **kw)
    loop = CommandLoop(engine, is_coordinator=rank == 0)
    recorded: list[list[int]] = []
    orig = loop._execute

    def record(cmd):
        out = orig(cmd)
        if cmd.kind in (CMD_PREFILL, CMD_PREFILL_MANY, CMD_PREFILL_CACHED):
            recorded.append([int(t) for t in np.atleast_1d(out)])
        elif cmd.kind == CMD_CHUNK_ADVANCE and out is not None:
            recorded.append([int(out)])
        elif cmd.kind == CMD_DECODE:
            recorded.append(np.asarray(out).ravel().tolist())
        elif cmd.kind == CMD_VERIFY:
            recorded.append(np.asarray(out[0]).ravel().tolist()
                            + np.asarray(out[1]).tolist())
        return out

    loop._execute = record
    result = {}
    if rank == 0:
        facade = MultihostEngine(loop)
        served = []
        for rnd in range(job.get("rounds", 1)):
            sched = Scheduler(facade)
            done = [threading.Event() for _ in job["prompts"]]
            ids = [[] for _ in job["prompts"]]
            for i, prompt in enumerate(job["prompts"]):
                def emit(ev, i=i):
                    if ev.token_id is not None:
                        ids[i].append(int(ev.token_id))
                    if ev.done:
                        done[i].set()
                sampling = SamplingParams(**job.get("sampling", {}))
                if sampling.seed is not None:
                    # one seed a request, the same in every round
                    sampling = SamplingParams(**{**job["sampling"],
                                                 "seed": sampling.seed + i})
                sched.submit(GenRequest(
                    prompt_ids=list(prompt), sampling=sampling,
                    max_new_tokens=job["max_new"], emit=emit,
                    id=f"r{rnd}-{i}"))
            sched.start()
            try:
                for ev in done:
                    if not ev.wait(120):
                        raise RuntimeError("request did not complete")
            finally:
                sched.stop()
            served.append(ids)
        loop.stop()
        result["served"] = served
        result["prefix_cache"] = engine.prefix_cache_stats()
    else:
        loop.follow_forever()
    result["recorded"] = recorded
    result["lengths"] = [engine.slot_length(s)
                         for s in range(engine.max_slots)]
    result["kv_slots"] = int(engine.state.cache.k.shape[1])
    result["kv_cache_bytes"] = engine.kv_cache_bytes()
    result["slot_block"] = list(engine.slot_block)
    result["weight_stream_bytes"] = engine.weight_stream_bytes()
    result["weight_stream_bytes_per_device"] = (
        engine.weight_stream_bytes_per_device())
    result["stage_axis_fallbacks"] = _stage_fallbacks() - fallbacks0
    result["kv_layers"] = int(engine.state.cache.k.shape[0])
    result["coords"] = mesh.coords
    if engine._pool_kv is not None:
        result["pool_layers"] = int(engine._pool_kv.k.shape[0])
    return result


def direct_calls(engine) -> list:
    """A fixed sequence of the engine calls the Scheduler makes, one of
    each dispatching kind (a single and a coalesced prefill, a chunked
    prefill, a prefix hit admitted through the cached path, decode, a
    speculative verify, a released slot); greedy, so one rank's engine
    and a mesh's facade give the same outputs."""
    from symmetry_tpu_torch.engine.engine import SamplingParams

    greedy = SamplingParams()
    p0, p1 = list(range(3, 19)), list(range(30, 45))
    out = [[engine.prefill_and_insert(0, p0, greedy)]]
    out.append(engine.prefill_and_insert_many([(1, p1, greedy)]))
    out.append(np.asarray(engine.decode_steps()).ravel().tolist())
    draft = np.array([[5, 6], [7, 8]], np.int64)
    toks, n_emit = engine.verify_step(draft, np.array([2, 1], np.int32))
    out.append(np.asarray(toks).ravel().tolist() + np.asarray(n_emit).tolist())
    engine.release_slot(1)
    job = engine.start_chunked_prefill(1, list(range(50, 90)), greedy)
    while (tok := engine.advance_chunked_prefill(job)) is None:
        pass
    out.append([tok])
    hit = engine.prefix_lookup(list(range(50, 90)) + [9, 9])
    out.append([hit.length])
    out.append(engine.prefill_and_insert_cached(
        [(0, list(range(50, 90)) + [9, 9], greedy)], hit))
    miss = engine.prefix_lookup(list(range(200, 240)))
    out.append([0 if miss is None else miss.length])
    if miss is not None:
        miss.release()
    out.append(np.asarray(engine.decode_steps()).ravel().tolist())
    return out


def job_direct(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.engine.spec import SpecConfig
    from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
    from symmetry_tpu_torch.parallel.multihost import (CommandLoop,
                                                       MultihostEngine)

    cfg = job_config(job)
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg)
    engine = InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                             mesh=mesh, device="cpu",
                             cache_dtype=torch.float32,
                             speculative=SpecConfig(k_draft=2),
                             **job["engine"])
    loop = CommandLoop(engine, is_coordinator=rank == 0)
    slots = range(engine.max_slots)
    if rank != 0:
        loop.follow_forever()
        return {"lengths": [engine.slot_length(s) for s in slots]}
    calls = direct_calls(MultihostEngine(loop))
    loop.stop()
    return {"calls": calls,
            "lengths": [engine.slot_length(s) for s in slots]}


def verify_calls(engine, prompts, drafts, n_drafts, greedy=None) -> list:
    """Every slot prefilled from `prompts` with `greedy` sampling (the
    port's by default), then per round one verify of its drafts and one
    decode block: the outputs, as lists."""
    if greedy is None:
        from symmetry_tpu_torch.engine.engine import SamplingParams

        greedy = SamplingParams()
    out = [[engine.prefill_and_insert(slot, list(p), greedy)
            for slot, p in enumerate(prompts)]]
    for draft, n_draft in zip(drafts, n_drafts):
        toks, n_emit = engine.verify_step(np.asarray(draft, np.int64),
                                          np.asarray(n_draft, np.int32))
        out.append(np.asarray(toks).ravel().tolist()
                   + np.asarray(n_emit).tolist())
        out.append(np.asarray(engine.decode_steps()).ravel().tolist())
    return out


def job_verify(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.engine.spec import SpecConfig
    from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
    from symmetry_tpu_torch.parallel.multihost import (CommandLoop,
                                                       MultihostEngine)

    cfg = job_config(job)
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg)
    engine = InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), mesh=mesh, device="cpu",
        cache_dtype=torch.float32,
        speculative=SpecConfig(k_draft=len(job["drafts"][0][0])),
        **job["engine"])
    loop = CommandLoop(engine, is_coordinator=rank == 0)
    if rank != 0:
        loop.follow_forever()
        return {}
    calls = verify_calls(MultihostEngine(loop), job["prompts"],
                         job["drafts"], job["n_drafts"])
    loop.stop()
    return {"calls": calls}


def job_load(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.engine import weights

    dtype = getattr(torch, job["dtype"])
    if job["warm"]:
        params, _ = weights.load_warm_cache(
            job["path"], dtype=dtype, quantize=job["quantize"], mesh=mesh,
            device="cpu")
    else:
        params, _ = weights.load_checkpoint(
            job["path"], dtype=dtype, quantize=job["quantize"], mesh=mesh,
            device="cpu")
    return flat(params)


def job_qmm(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.ops.qmm import w8a16_apply_sharded
    from symmetry_tpu_torch.ops.quant import QuantizedTensor, pack_quantized
    from symmetry_tpu_torch.parallel.sharding import Sharding

    with np.load(job["data"]) as z:
        x, q, scale = z["x"], z["q"], z["scale"]
    k_axis, n_axis = job["k_axis"], job["n_axis"]

    def block(a, spec):
        return Sharding(mesh, spec)(torch.from_numpy(a)).clone()

    q_l = block(q, (k_axis, n_axis))
    s_l = block(scale, (n_axis,))
    x_l = block(x, (None,) * (x.ndim - 1) + (k_axis,))
    leaf = pack_quantized(QuantizedTensor(q_l, s_l), mesh=mesh,
                          k_axis=k_axis, n_axis=n_axis)
    if leaf.mesh is None:
        raise RuntimeError("the leaf did not pack on the mesh")
    return {"y": w8a16_apply_sharded(x_l, leaf).numpy()}


JOBS = {"forward": job_forward, "engine": job_engine, "direct": job_direct,
        "load": job_load, "qmm": job_qmm, "sp": job_sp,
        "ring_fwd": job_ring_fwd, "pipeline": job_pipeline, "moe": job_moe,
        "verify": job_verify, "quantize": job_quantize}


def main() -> None:
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    import torch

    torch.set_num_threads(1)
    from symmetry_tpu_torch.parallel.mesh import MeshSpec
    from symmetry_tpu_torch.parallel.multihost import (build_multihost_mesh,
                                                       init_distributed)

    init_distributed(f"127.0.0.1:{spec['port']}", spec["world"], rank,
                     device="cpu", timeout_s=120)
    meshes: dict = {}

    def mesh_for(shape: dict, dcn_data: int = 1):
        key = (tuple(sorted(shape.items())), dcn_data)
        if key not in meshes:  # every rank builds the same meshes in order
            meshes[key] = build_multihost_mesh(MeshSpec.from_dict(shape),
                                               dcn_data)
        return meshes[key]

    default = spec.get("mesh") or {"model": spec["world"]}
    mesh = mesh_for(default)
    for job in spec["jobs"]:
        out = JOBS[job["kind"]](job, mesh_for(job.get("mesh", default),
                                              job.get("dcn_data", 1)),
                                rank)
        path = os.path.join(spec["out"], f"{job['name']}.{rank}")
        arrays = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
        if arrays:
            np.savez(path + ".npz", **arrays)
        rest = {k: v for k, v in out.items() if k not in arrays}
        if rest:
            with open(path + ".json", "w", encoding="utf-8") as fh:
                json.dump(rest, fh)
    # Every rank leaves the job together: a process that exits while gloo
    # still serves another rank's pending traffic can abort in teardown.
    import torch.distributed as dist

    dist.barrier(group=mesh.control)
    dist.destroy_process_group()
    print(f"RANK {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
