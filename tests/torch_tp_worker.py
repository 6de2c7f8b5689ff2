"""One rank of the tensor-parallel tests (tests/test_torch_tp.py).

Runs as N real OS processes joined by torch.distributed over gloo on the
CPU; imports torch and the port only (the parent holds the JAX references).

    python tests/torch_tp_worker.py <spec.json> <rank>

The spec names the coordinator port, the world size, an output directory
and a list of jobs; each job writes `<out>/<job>.<rank>.npz` (and the
engine jobs a json of the tokens this rank recorded). Jobs:

  forward  the port's TP forward of a preset on numpy weights: prefill
           logits over every position, then one decode step's;
  engine   an engine on the mesh; rank 0 serves prompts greedily through
           the Scheduler and the command loop, every rank records the
           tokens its own engine produced (the lockstep check);
  direct   rank 0 makes one call of every dispatching kind through the
           command loop's facade (`direct_calls`, verify included);
  load     sharded load_checkpoint / load_warm_cache of a checkpoint dir;
  qmm      w8a16_apply_sharded on one leaf, row- and column-parallel.
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


def job_forward(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.models.llama import (forward, init_cache,
                                                 pack_params, preset)

    cfg = preset(job["preset"])
    dtype = getattr(torch, job.get("dtype", "float32"))
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg, dtype=dtype)
    if job.get("pack"):
        pack_params(params, config=cfg, mesh=mesh)
    tokens = torch.tensor(job["tokens"])
    B, S = tokens.shape
    cache = init_cache(cfg, B, S + 4, dtype, device="cpu",
                       quantized=bool(job.get("kv_quant")), mesh=mesh)
    logits, cache = forward(params, cfg, tokens, cache, mesh=mesh)
    step, _ = forward(params, cfg, tokens[:, -1:], cache, mesh=mesh)
    return {"prefill": logits.numpy(), "decode": step.numpy(),
            "cache_k": cache.k.float().numpy()}


def job_engine(job, mesh, rank):
    import torch

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                  SamplingParams)
    from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
    from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
    from symmetry_tpu_torch.models.llama import preset
    from symmetry_tpu_torch.parallel.multihost import (
        CMD_CHUNK_ADVANCE, CMD_DECODE, CMD_PREFILL, CMD_PREFILL_CACHED,
        CMD_PREFILL_MANY, CMD_VERIFY, CommandLoop, MultihostEngine)

    cfg = preset(job["preset"])
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg)
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
                sched.submit(GenRequest(
                    prompt_ids=list(prompt), sampling=SamplingParams(),
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
    result["weight_stream_bytes"] = engine.weight_stream_bytes()
    result["weight_stream_bytes_per_device"] = (
        engine.weight_stream_bytes_per_device())
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
    from symmetry_tpu_torch.models.llama import preset
    from symmetry_tpu_torch.parallel.multihost import (CommandLoop,
                                                       MultihostEngine)

    cfg = preset(job["preset"])
    params = params_from_numpy(tree_from_npz(job["weights"]), device="cpu",
                               mesh=mesh, config=cfg)
    engine = InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                             mesh=mesh, device="cpu",
                             cache_dtype=torch.float32,
                             speculative=SpecConfig(k_draft=2),
                             **job["engine"])
    loop = CommandLoop(engine, is_coordinator=rank == 0)
    if rank != 0:
        loop.follow_forever()
        return {"lengths": [engine.slot_length(s) for s in range(2)]}
    calls = direct_calls(MultihostEngine(loop))
    loop.stop()
    return {"calls": calls,
            "lengths": [engine.slot_length(s) for s in range(2)]}


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
        "load": job_load, "qmm": job_qmm}


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
    mesh = build_multihost_mesh(MeshSpec(model=spec["world"]))
    for job in spec["jobs"]:
        out = JOBS[job["kind"]](job, mesh, rank)
        path = os.path.join(spec["out"], f"{job['name']}.{rank}")
        arrays = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
        if arrays:
            np.savez(path + ".npz", **arrays)
        rest = {k: v for k, v in out.items() if k not in arrays}
        if rest:
            with open(path + ".json", "w", encoding="utf-8") as fh:
                json.dump(rest, fh)
    print(f"RANK {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
