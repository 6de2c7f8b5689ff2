#!/usr/bin/env python3
"""Drive the PyTorch port (symmetry_tpu_torch) on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device   require CUDA; print the card, its capability, name and power
              limit (nvidia-smi);
  2. build    compile the CUDA kernels from symmetry_tpu_torch/csrc/;
  3. kernels  each kernel against its plain PyTorch version at the serving
              path's widths (llama3-8b heads, bf16), max abs error <= 2e-2 on
              valid rows; kernel, plain and library (SDPA, a yardstick only)
              times from CUDA events, and each kernel's bound;
  4. tiny     the `tiny` preset in float32 through the port's engine and
              Scheduler on the card (kernels) and on the CPU (plain
              versions): greedy token ids must be identical;
  5. serve    llama3-8b in bf16 at full width and depth (random weights
              from torch.Generator seed 0) behind the port's Scheduler:
              8 greedy requests over the three prefill buckets, 64 new
              tokens each, through both kernels (launch counts checked);
  6. report   one JSON line listing the kernels, the nvidia-smi line, and
              last the {"ok": true, ...} line.

Needs the CUDA toolkit (nvcc) and the repository's sources; nothing else.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = 2e-2
ID_BASE = 0x4E00


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over `iters` back-to-back calls (CUDA
    events), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions


def flash_case(B, S, seq_lens, window, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, K, D = 32, 8, 128

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
    return q, k, v, torch.tensor(seq_lens, dtype=torch.int32, device="cuda")


def flash_work(q, k, seq_lens, window) -> tuple[float, float]:
    """(bytes, flops) the function needs for these inputs: valid rows of
    q/k/v read once, valid output rows written once; each valid query row
    does 4*D operations per visible key per head."""
    _, S, H, D = q.shape
    K = k.shape[2]
    nbytes = flops = 0.0
    for n in seq_lens.tolist():
        n = min(n, S)
        rows = np.arange(n)
        keys = rows + 1 if window is None else np.minimum(rows + 1, window)
        flops += 4.0 * H * D * float(keys.sum())
        nbytes += n * (2 * H + 2 * K) * D * 2
    return nbytes + 4 * len(seq_lens), flops


def check_flash() -> dict:
    import torch.nn.functional as F

    from symmetry_tpu_torch.ops.flash import (flash_prefill,
                                              flash_prefill_reference)

    worst = 0.0
    cases = [(1, 512, [512], None), (1, 2048, [2048], None),
             (4, 512, [512, 300, 129, 1], None),
             (4, 2048, [2048, 1900, 1025, 17], None),
             (4, 2048, [2048, 2000, 700, 64], 256)]
    for i, (B, S, lens, window) in enumerate(cases):
        q, k, v, seq_lens = flash_case(B, S, lens, window, seed=i)
        got = flash_prefill(q, k, v, seq_lens, window=window)
        torch.cuda.synchronize()
        want = flash_prefill_reference(q, k, v, seq_lens, window=window)
        err = max(float((got[b, :n].float() - want[b, :n].float())
                        .abs().max()) for b, n in enumerate(lens))
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash B={B} S={S}: non-finite output")
        log(f"  flash B={B} S={S} lens={lens} window={window}: "
            f"max_abs_err={err:.3e}")
        if err > TOL:
            raise AssertionError(f"flash error {err} > {TOL}")
        worst = max(worst, err)

    # Timing at the largest bucket's prefill shape (batch 1 at 2048 by the
    # engine's token budget), full length, so SDPA's causal mode computes
    # the same function.
    q, k, v, seq_lens = flash_case(1, 2048, [2048], None, seed=10)
    ms = cuda_ms(lambda: flash_prefill(q, k, v, seq_lens), 20)
    plain_ms = cuda_ms(lambda: flash_prefill_reference(q, k, v, seq_lens), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    bound_ms, bound_by = bound(*flash_work(q, k, seq_lens, None))
    log(f"  flash timing B=1 S=2048 H=32 K=8 D=128 bf16: kernel {ms:.4f} ms,"
        f" plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return dict(name="flash_prefill", route="cuda",
                source="symmetry_tpu_torch/csrc/flash_prefill.cu",
                replaces="symmetry_tpu/ops/flash.py:129",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def decode_work(q, k_cache, lengths, window) -> tuple[float, float]:
    """(bytes, flops) for these inputs: q read and out written once, and the
    live K/V rows of each slot (min(length, window) of them) read once."""
    T, K, D = k_cache.shape[2:]
    B, nq, _ = q.shape
    live = np.minimum(np.clip(lengths.cpu().numpy(), 0, T),
                      window if window else T).astype(np.float64)
    nbytes = 2 * B * nq * D * 2 + live.sum() * 2 * K * D * 2 + 4 * B
    return nbytes, 4.0 * nq * D * live.sum()


def check_decode() -> dict:
    import torch.nn.functional as F

    from symmetry_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    L, B, T, nq, K, D = 2, 8, 4096, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(20)
    k_cache = torch.randn((L, B, T, K, D), generator=g, device="cuda",
                          dtype=torch.bfloat16)
    v_cache = torch.randn((L, B, T, K, D), generator=g, device="cuda",
                          dtype=torch.bfloat16)
    q = torch.randn((B, nq, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    lengths = torch.tensor([0, 1, T, 1024, 777, 3000, 2048, 64],
                           dtype=torch.int32, device="cuda")
    worst = 0.0
    for layer, window in ((1, None), (0, None), (1, 1000)):
        got = decode_attention(q, k_cache, v_cache, layer, lengths,
                               window=window)
        torch.cuda.synchronize()
        want = decode_attention_reference(q, k_cache, v_cache, layer,
                                          lengths, window=window)
        if not torch.isfinite(got).all():
            raise AssertionError("decode: non-finite output")
        # slot 0 is empty: its output is garbage by contract
        err = float((got[1:].float() - want[1:].float()).abs().max())
        log(f"  decode B={B} T={T} layer={layer} window={window} lengths="
            f"{lengths.tolist()}: max_abs_err={err:.3e}")
        if err > TOL:
            raise AssertionError(f"decode error {err} > {TOL}")
        worst = max(worst, err)

    ms = cuda_ms(lambda: decode_attention(q, k_cache, v_cache, 1, lengths),
                 50)
    plain_ms = cuda_ms(lambda: decode_attention_reference(
        q, k_cache, v_cache, 1, lengths), 10)
    kl, vl = (c[1].transpose(1, 2) for c in (k_cache, v_cache))  # [B,K,T,D]
    pos = torch.arange(T, device="cuda")
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kl, vl, attn_mask=mask, enable_gqa=True), 50)
    bound_ms, bound_by = bound(*decode_work(q, k_cache, lengths, None))
    log(f"  decode timing B=8 T=4096 nq=32 K=8 D=128 bf16 (live "
        f"{int(lengths.clamp(max=T).sum())} rows): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by})")
    return dict(name="decode_attention", route="cuda",
                source="symmetry_tpu_torch/csrc/decode_attention.cu",
                replaces="symmetry_tpu/ops/decode_attention.py:231",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# Phases 4-5: the engine behind the Scheduler


def serve(preset_name: str, *, device: str, dtype: torch.dtype,
          prompt_lens: list[int], max_new: int, max_slots: int,
          max_seq_len: int, buckets: tuple[int, ...], decode_block: int,
          params=None, seed: int = 0, on_ready=None) -> dict:
    """Build the engine, warm it, and serve greedy requests through the
    Scheduler. Returns per-request token ids and finish reasons, timings,
    and the scheduler's metrics. `on_ready` runs after warmup, just before
    the requests are submitted."""
    from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
    from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
    from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
    from symmetry_tpu_torch.models.llama import init_params, preset

    class IdTokenizer(ByteTokenizer):
        """One character per token id, so the stream carries exact ids."""

        def decode(self, ids):
            return "".join(chr(ID_BASE + i) for i in ids
                           if i not in (self.BOS, self.EOS))

    cfg = preset(preset_name)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, gen, dtype)
    engine = InferenceEngine(cfg, params, IdTokenizer(cfg.vocab_size),
                             max_slots=max_slots, max_seq_len=max_seq_len,
                             prefill_buckets=buckets, cache_dtype=dtype,
                             decode_block=decode_block, device=device)
    engine.warmup()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, min(cfg.vocab_size, 50000), n).tolist()
               for n in prompt_lens]
    if on_ready is not None:
        on_ready()
    sched = Scheduler(engine)
    events = {i: [] for i in range(len(prompts))}
    done = {i: threading.Event() for i in range(len(prompts))}
    first_at: dict[int, float] = {}
    t0 = time.monotonic()
    for i, ids in enumerate(prompts):
        def emit(ev, i=i):
            if i not in first_at:
                first_at[i] = time.monotonic()
            events[i].append(ev)
            if ev.done:
                done[i].set()
        sched.submit(GenRequest(prompt_ids=ids, sampling=SamplingParams(),
                                max_new_tokens=max_new, emit=emit,
                                id=f"r{i}"))
    sched.start()
    try:
        for i, ev in done.items():
            if not ev.wait(600):
                raise AssertionError(f"request {i} did not complete")
    finally:
        sched.stop()
    t_end = time.monotonic()
    if device == "cuda":
        torch.cuda.synchronize()
    out = []
    for i in range(len(prompts)):
        last = events[i][-1]
        text = "".join(ev.text for ev in events[i])
        out.append(dict(ids=[ord(c) - ID_BASE for c in text],
                        reason=last.finish_reason,
                        generated=last.tokens_generated, ttft_s=last.ttft_s))
    decoded = sum(r["generated"] - 1 for r in out)
    return dict(requests=out, metrics=dict(sched.metrics), wall_s=t_end - t0,
                decode_tok_s=decoded / (t_end - min(first_at.values())),
                config=cfg, engine=engine)


def profile_dispatch(label: str, fn) -> None:
    """Where one dispatch's time goes: its host wall (synchronized, taken
    without the profiler), the device busy time summed over the CUDA
    kernels torch.profiler records for a second run, the device idle share
    that leaves, and the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue  # host ops; their kernels are counted below
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log(f"  profile {label}: wall {wall_ms:.3f} ms; the profiler saw no "
            f"device kernels")
        return
    log(f"  profile {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms over {sum(r[1] for r in rows)} kernels, idle "
        f"share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for ms, count, key in sorted(rows, reverse=True)[:6]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")


def check_tiny() -> None:
    from symmetry_tpu_torch.models.llama import init_params, preset

    params = init_params(preset("tiny"), torch.Generator().manual_seed(0),
                         torch.float32)
    kw = dict(dtype=torch.float32, prompt_lens=[5, 14, 27], max_new=12,
              max_slots=2, max_seq_len=64, buckets=(16, 32), decode_block=4)
    card = serve("tiny", device="cuda", params=params, **kw)["requests"]
    cpu = serve("tiny", device="cpu", params=params, **kw)["requests"]
    for r_card, r_cpu in zip(card, cpu):
        if (r_card["ids"], r_card["reason"]) != (r_cpu["ids"],
                                                 r_cpu["reason"]):
            raise AssertionError(f"tiny card {r_card} != cpu {r_cpu}")
    log(f"  tiny f32: {len(card)} requests, greedy ids identical card vs "
        f"CPU: {[r['ids'][:6] for r in card]}...")


def check_full_width(smi: str) -> dict[str, int]:
    from symmetry_tpu_torch.engine.engine import SamplingParams
    from symmetry_tpu_torch.ops.decode_attention import decode_attention
    from symmetry_tpu_torch.ops.flash import flash_prefill

    def reset():
        flash_prefill.launches = 0
        decode_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()

    max_new = 64
    res = serve("llama3-8b", device="cuda", dtype=torch.bfloat16,
                prompt_lens=[60, 100, 300, 420, 500, 900, 1500, 2000],
                max_new=max_new, max_slots=8, max_seq_len=4096,
                buckets=(128, 512, 2048), decode_block=8, on_ready=reset)
    launches = {"flash_prefill": flash_prefill.launches,
                "decode_attention": decode_attention.launches}
    cfg, m = res["config"], res["metrics"]
    L = cfg.num_layers
    log(f"  launches {launches}; scheduler admit_dispatches="
        f"{m['admit_dispatches']} steps={m['steps']} tokens={m['tokens']}")
    for i, r in enumerate(res["requests"]):
        if r["reason"] != "length" or r["generated"] != max_new:
            raise AssertionError(f"request {i}: {r['reason']} after "
                                 f"{r['generated']} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r["ids"]):
            raise AssertionError(f"request {i}: token id out of range")
    if launches["flash_prefill"] != L * m["admit_dispatches"]:
        raise AssertionError("flash launches != layers x prefill dispatches")
    if launches["decode_attention"] != L * m["steps"]:
        raise AssertionError("decode launches != layers x decode steps")
    engine = res["engine"]
    profile_dispatch("decode block (8 steps x 8 slots)", engine.decode_steps)
    prompt = list(range(1000, 3000))
    profile_dispatch("prefill 2000 tokens (bucket 2048, batch 1)",
                     lambda: engine.prefill_and_insert(0, prompt,
                                                       SamplingParams()))
    ttft = [r["ttft_s"] for r in res["requests"]]
    log(f"  llama3-8b bf16 on {smi}: 8 requests x {max_new} tokens; TTFT "
        f"p50 {statistics.median(ttft):.4f} s (max {max(ttft):.4f} s); "
        f"aggregate decode {res['decode_tok_s']:.2f} tok/s over 8 streams; "
        f"wall {res['wall_s']:.3f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    from symmetry_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: device")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"  {name}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__} (CUDA {torch.version.cuda}); {smi}")

    log("phase 2: build")
    log(f"  kernels built in {kernels.build_all():.3f} s")

    log("phase 3: kernels against their plain versions (bf16)")
    rows = [check_flash(), check_decode()]

    log("phase 4: tiny engine, card against CPU (float32)")
    check_tiny()

    log("phase 5: llama3-8b full width through the Scheduler")
    launches = check_full_width(smi)
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on the path")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
