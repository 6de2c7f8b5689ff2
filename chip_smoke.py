#!/usr/bin/env python3
"""Drive the PyTorch port (symmetry_tpu_torch) on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device   require CUDA; print the card, its capability, name and power
              limit (nvidia-smi);
  2. build    compile the CUDA kernels from symmetry_tpu_torch/csrc/ (five
              libraries, one nvcc each, started together);
  3. kernels  each kernel against its plain PyTorch version at the serving
              path's widths (llama3-8b heads and weights, bf16): flash
              (the tensor-core variant) and decode attention (bf16 and
              int8 caches, and a qwen2-7b group of 7) within 2e-2 on valid
              rows, the KV append bit for bit, W8A16 within one bf16 step
              of its largest output (wq, wk, wg, wd, lm_head at 8 rows, the
              GEMV kernel, and at 128, 512 and 2048 rows, the tensor-core
              kernel), W8A8 bit for bit (wq, wg, wd, lm_head at 32, 128
              and 2048 rows, K splits included; no serving path routes
              it); kernel, plain and library (a yardstick only) device
              times (kernel durations summed by torch.profiler, decode's
              split and combine kernels together; the eager call's
              CUDA-event time is logged beside), and each kernel's bound;
              flash also at the coalesced-prefill shape (B=4 S=512,
              ragged) and decode also at phase 5's lengths; then flash
              (both variants), decode (bf16, int8), W8A16 (both regimes)
              and W8A8 (whole and split over K) once more under
              torch.cuda.set_sync_debug_mode("error"): no wrapper may
              synchronize with the host;
  4. tiny     the `tiny` preset in float32 through the port's engine and
              Scheduler on the card (kernels) and on the CPU (plain
              versions), dense and then with int8 weights and an int8
              KV cache: greedy token ids must be identical;
  5. serve    llama3-8b in bf16 at full width and depth (random weights
              from torch.Generator seed 0) behind the port's Scheduler:
              8 greedy requests over the three prefill buckets, 64 new
              tokens each, through flash and decode attention (launch
              counts checked, and every flash launch on the tensor-core
              variant);
  6. int8     the same traffic on llama3-8b at full depth with int8
              weights (init_params(quantize=True), seed 0) packed for the
              W8A16 kernel and an int8 KV cache: flash, KV append, int8
              decode attention and W8A16 on the path (launch counts
              checked, W8A16's per regime: the tensor-core kernel at
              prefill, the GEMV kernel at decode; flash as in phase 5);
  7. host tiny  `python -m symmetry_tpu_torch.engine.host` on `tiny` in
              float32 with a small prefill_chunk and the prefix cache on,
              one host on the card and one with --device cpu, fed the same
              requests: dense, then int8 weights + int8 KV; streamed text
              identical, a prefix hit on both;
  8. host     the host serving llama3-8b in bf16 at full depth from the
              provider's default `tpu:` section (8 slots, capacity 2048,
              buckets 128/512/2048, prefill_chunk 256, decode_block 16,
              pipeline_depth 2) plus model_preset and a 1024 MiB prefix
              cache: 8 chats of 60-1880 tokens (two flash, six chunked),
              then 4 sharing the longest one's first 1536 tokens (prefix
              hits: two one-dispatch, two seeded chunked); stats, shutdown
              (exit 0), TTFT by path, tok/s, memory; then, in-process on the
              same config, a profile of one chunk step and one cached
              admission and the chunk attention's device time;
  9. report   one JSON line listing the seven kernel rows (W8A16 one per
              regime), the nvidia-smi
              line, and last the {"ok": true, ...} line.

Needs the CUDA toolkit (nvcc) and the repository's sources; nothing else.
"""

from __future__ import annotations

import gc
import json
import os
import queue
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and int8 tensor cores,
# HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
TOL = 2e-2
ID_BASE = 0x4E00
# Phases 5-6's prompt lengths (tokens), over the buckets 128, 512, 2048.
PHASE5_PROMPTS = [60, 100, 300, 420, 500, 900, 1500, 2000]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, iters: int, name: str = "") -> float:
    """Device time of one call of fn: the CUDA kernels' durations summed by
    torch.profiler over `iters` calls, after a warm-up. Idle gaps between
    launches (the host's share) are not counted, so a small kernel is not
    measured by its wrapper's Python overhead. With `name`, only the
    kernels whose name contains it (one kernel of a wrapper that launches
    several)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # A profiling session now and then records nothing at all (seen once
    # in a run of many sessions): take another before giving up.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0))
                      for ev in prof.key_averages()
                      if getattr(ev, "device_type", None) == DeviceType.CUDA
                      and name in ev.key)
        if busy_us > 0:
            return busy_us / 1e3 / iters
    raise AssertionError(f"the profiler recorded no device time {name}")


def cuda_ms(fn, iters: int) -> float:
    """Wall time of one call of fn over `iters` back-to-back calls (CUDA
    events), after a warm-up: the device time, or the host's launch rate
    where that is slower."""
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


def bound(nbytes: float, flops: float,
          peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
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
    ms = device_ms(lambda: flash_prefill(q, k, v, seq_lens), 20)
    call_ms = cuda_ms(lambda: flash_prefill(q, k, v, seq_lens), 20)
    plain_ms = device_ms(lambda: flash_prefill_reference(q, k, v, seq_lens),
                         5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    bound_ms, bound_by = bound(*flash_work(q, k, seq_lens, None))
    log(f"  flash timing B=1 S=2048 H=32 K=8 D=128 bf16 (device ms): kernel "
        f"{ms:.4f} ({call_ms:.4f} per eager call), plain {plain_ms:.4f}, SDPA "
        f"{library_ms:.4f}, bound {bound_ms:.4f} ({bound_by})")
    # The coalesced-prefill shape: four prompts of the 512 bucket in one
    # dispatch, ragged; SDPA gets the same causal-and-length mask.
    lens = [512, 420, 300, 129]
    q, k, v, seq_lens = flash_case(4, 512, lens, None, seed=11)
    r_ms = device_ms(lambda: flash_prefill(q, k, v, seq_lens), 20)
    r_plain = device_ms(lambda: flash_prefill_reference(q, k, v, seq_lens), 5)
    pos = torch.arange(512, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < seq_lens[:, None, None]))[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    r_lib = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
    r_bound, r_by = bound(*flash_work(q, k, seq_lens, None))
    log(f"  flash timing B=4 S=512 lens={lens} (device ms): kernel "
        f"{r_ms:.4f}, plain {r_plain:.4f}, SDPA (mask) {r_lib:.4f}, bound "
        f"{r_bound:.4f} ({r_by})")
    return dict(name="flash_prefill", route="cuda",
                source="symmetry_tpu_torch/csrc/flash_prefill.cu",
                replaces="symmetry_tpu/ops/flash.py:129",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def decode_work(q, k_cache, lengths, window) -> tuple[float, float]:
    """(bytes, flops) for these inputs: q read and out written once, and the
    live K/V rows of each slot (min(length, window) of them) read once, at
    the cache's element size, with one float32 scale per row and KV head
    for an int8 cache."""
    T, K, D = k_cache.shape[2:]
    B, nq, _ = q.shape
    live = np.minimum(np.clip(lengths.cpu().numpy(), 0, T),
                      window if window else T).astype(np.float64)
    per_row = 2 * K * D * k_cache.element_size()
    if k_cache.dtype == torch.int8:
        per_row += 2 * K * 4
    nbytes = 2 * B * nq * D * q.element_size() + live.sum() * per_row + 4 * B
    return nbytes, 4.0 * nq * D * live.sum()


def decode_case(L, B, T, nq, K, D, lengths, seed, int8):
    """q, caches and scales (None for bf16) on the card; int8 caches are
    quantize_kv of the same bf16 draws, scales position minor."""
    from symmetry_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    k, v, q = rnd(L, B, T, K, D), rnd(L, B, T, K, D), rnd(B, nq, D)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if not int8:
        return q, k, v, None, None, lengths
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    del k, v
    return (q, kq, vq, ks.transpose(-1, -2).contiguous(),
            vs.transpose(-1, -2).contiguous(), lengths)


def check_decode(int8: bool) -> dict:
    import torch.nn.functional as F

    from symmetry_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference, live_blocks)

    label = "int8" if int8 else "bf16"
    L, B, T, nq, K, D = 2, 8, 4096, 32, 8, 128
    q, k_cache, v_cache, ks, vs, lengths = decode_case(
        L, B, T, nq, K, D, [0, 1, T, 1024, 777, 3000, 2048, 64], 20, int8)
    worst = 0.0
    # llama3-8b heads (32 over 8), then qwen2-7b's group of 7 (28 over 4)
    for layer, window in ((1, None), (0, None), (1, 1000), (1, "qwen2")):
        args = (q, k_cache, v_cache, layer, lengths, ks, vs)
        if window == "qwen2":
            args = decode_case(2, 4, 512, 28, 4, 128, [512, 300, 1, 77], 21,
                               int8)
            args = args[:3] + (layer, args[5]) + args[3:5]
            window = None
        got = decode_attention(*args, window=window)
        torch.cuda.synchronize()
        want = decode_attention_reference(*args, window=window)
        if not torch.isfinite(got).all():
            raise AssertionError(f"decode {label}: non-finite output")
        # an empty slot's output is garbage by contract
        live = args[4] > 0
        err = float((got[live].float() - want[live].float()).abs().max())
        log(f"  decode {label} q {tuple(got.shape)} cache "
            f"{tuple(args[1].shape)} layer={layer} window={window} lengths="
            f"{args[4].tolist()}: max_abs_err={err:.3e}")
        if err > TOL:
            raise AssertionError(f"decode {label} error {err} > {TOL}")
        worst = max(worst, err)

    ms = device_ms(lambda: decode_attention(q, k_cache, v_cache, 1, lengths,
                                            ks, vs), 50)
    call_ms = cuda_ms(lambda: decode_attention(q, k_cache, v_cache, 1,
                                               lengths, ks, vs), 50)
    plain_ms = device_ms(lambda: decode_attention_reference(
        q, k_cache, v_cache, 1, lengths, ks, vs), 10)
    if int8:  # SDPA's yardstick reads a bf16 copy of the same cache
        kl, vl = ((c[1].float() * s[1].transpose(-1, -2)[..., None])
                  .to(torch.bfloat16).transpose(1, 2)
                  for c, s in ((k_cache, ks), (v_cache, vs)))
    else:
        kl, vl = (c[1].transpose(1, 2) for c in (k_cache, v_cache))
    pos = torch.arange(T, device="cuda")
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kl, vl, attn_mask=mask, enable_gqa=True), 50)
    bound_ms, bound_by = bound(*decode_work(q, k_cache, lengths, None))
    log(f"  decode timing {label} B=8 T=4096 nq=32 K=8 D=128 (live "
        f"{int(lengths.clamp(max=T).sum())} rows; device ms): kernel "
        f"{ms:.4f} ({call_ms:.4f} per eager call), plain {plain_ms:.4f}, SDPA "
        f"{library_ms:.4f}, bound {bound_ms:.4f} ({bound_by})")
    # Phase 5's slots halfway through their 64 new tokens.
    p5 = torch.tensor([n + 32 for n in PHASE5_PROMPTS], dtype=torch.int32,
                      device="cuda")
    p5_ms = device_ms(lambda: decode_attention(q, k_cache, v_cache, 1, p5,
                                               ks, vs), 50)
    p5_mask = (pos[None, :] < p5[:, None])[:, None, None, :]
    p5_lib = device_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kl, vl, attn_mask=p5_mask, enable_gqa=True), 50)
    p5_bound, p5_by = bound(*decode_work(q, k_cache, p5, None))
    log(f"  decode timing {label} at phase 5's lengths {p5.tolist()} (device "
        f"ms): kernel {p5_ms:.4f}, SDPA {p5_lib:.4f}, bound {p5_bound:.4f} "
        f"({p5_by}); {live_blocks(p5.tolist(), T, K, nq // K)} live split "
        f"blocks, {live_blocks(lengths.tolist(), T, K, nq // K)} at the "
        f"lengths above")
    return dict(name="decode_attention_int8" if int8 else "decode_attention",
                route="cuda",
                source="symmetry_tpu_torch/csrc/decode_attention.cu",
                replaces="symmetry_tpu/ops/decode_attention.py:231",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_no_host_sync() -> None:
    """No wrapper synchronizes with the host: flash (both variants), decode
    (bf16 and int8), W8A16 (GEMV, GEMV split over K, tensor-core) and W8A8
    (whole and split over K, its row quantization included) run under
    torch.cuda.set_sync_debug_mode("error"), which raises on any
    synchronizing call."""
    from symmetry_tpu_torch.ops.decode_attention import decode_attention
    from symmetry_tpu_torch.ops.flash import flash_prefill
    from symmetry_tpu_torch.ops.qmm import w8a8_matmul, w8a16_matmul
    from symmetry_tpu_torch.ops.quant import pack_quantized, quantize

    q, k, v, seq_lens = flash_case(2, 256, [256, 100], None, seed=12)
    qf, kf, vf = (x.float() for x in (q, k, v))
    bf16 = decode_case(2, 4, 512, 32, 8, 128, [512, 3, 0, 300], 22, False)
    int8 = decode_case(2, 4, 512, 32, 8, 128, [512, 3, 0, 300], 22, True)
    g = torch.Generator(device="cuda").manual_seed(23)
    qt = quantize(torch.randn((4096, 1024), generator=g, device="cuda",
                              dtype=torch.bfloat16).mul_(4096 ** -0.5))
    pt = pack_quantized(qt)
    xs = [torch.randn((m, 4096), generator=g, device="cuda",
                      dtype=torch.bfloat16) for m in (8, 128, 2048)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flash_prefill(q, k, v, seq_lens, window=64)
        flash_prefill(qf, kf, vf, seq_lens)
        for c in (bf16, int8):
            decode_attention(c[0], c[1], c[2], 1, c[5], c[3], c[4], window=200)
        for x in xs:
            w8a16_matmul(x, pt.q, pt.scale)
            w8a8_matmul(x, qt.q, qt.scale)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  sync debug mode \"error\": flash (tensor-core and FMA), decode "
        "(bf16, int8), W8A16 (GEMV, tensor-core) and W8A8 (split over K and "
        "whole) launched without a host synchronization")


def check_kv_append() -> dict:
    """Bit-equal payload and scales against the plain version at llama3-8b
    widths (8 slots, capacity 4096, 8 KV heads of 128); an out-of-range
    position writes row T - 1; rows and scales not written survive."""
    from symmetry_tpu_torch.ops.kv_append import (kv_append,
                                                  kv_append_reference)

    L, B, T, K, D = 2, 8, 4096, 8, 128
    g = torch.Generator(device="cuda").manual_seed(30)

    def state():
        g.manual_seed(30)
        return [torch.randint(-127, 128, (L, B, T, K, D), generator=g,
                              device="cuda", dtype=torch.int8)
                for _ in range(2)] + [
            torch.rand((L, B, K, T), generator=g, device="cuda")
            for _ in range(2)] + [
            torch.randn((B, K, D), generator=g, device="cuda",
                        dtype=torch.bfloat16) * 3 for _ in range(2)]

    pos = torch.tensor([0, 1, 127, 128, 2047, T - 1, T, T + 9],
                       dtype=torch.int32, device="cuda")
    got, want, pristine = state(), state(), state()
    kv_append(*got, 1, pos)
    torch.cuda.synchronize()
    kv_append_reference(*want, 1, pos)
    for a, b, name in zip(got[:4], want[:4], ("k", "v", "k_scale",
                                              "v_scale")):
        if not torch.equal(a, b):
            raise AssertionError(f"kv_append {name} differs from the plain "
                                 f"version")
    written = torch.zeros((B, T), dtype=torch.bool, device="cuda")
    written[torch.arange(B, device="cuda"), pos.clamp(max=T - 1).long()] = 1
    for a, b in ((got[0][1], pristine[0][1]), (got[1][1], pristine[1][1])):
        if not torch.equal(a[~written], b[~written]):
            raise AssertionError("kv_append touched a row it did not write")
    for a, b in ((got[2][1], pristine[2][1]), (got[3][1], pristine[3][1])):
        if not torch.equal(a.transpose(1, 2)[~written],
                           b.transpose(1, 2)[~written]):
            raise AssertionError("kv_append touched a scale it did not write")
    if not torch.equal(got[0][0], pristine[0][0]):
        raise AssertionError("kv_append touched another layer")
    log(f"  kv_append L={L} B={B} T={T} K={K} D={D} bf16 rows, positions "
        f"{pos.tolist()}: payload and scales bit-equal, untouched rows "
        f"intact")
    ms = device_ms(lambda: kv_append(*got, 1, pos), 200)
    call_ms = cuda_ms(lambda: kv_append(*got, 1, pos), 200)
    plain_ms = device_ms(lambda: kv_append_reference(*want, 1, pos), 20)
    nbytes = 2 * B * K * D * (2 + 1) + 2 * B * K * 4 + 4 * B
    bound_ms, bound_by = bound(nbytes, 2 * B * K * D * 4)
    log(f"  kv_append timing (device ms): kernel {ms:.6f} ({call_ms:.4f} per "
        f"eager call), plain {plain_ms:.4f}, bound {bound_ms:.6f} "
        f"({bound_by}); no library call")
    return dict(name="kv_append", route="cuda",
                source="symmetry_tpu_torch/csrc/kv_append.cu",
                replaces="symmetry_tpu/ops/kv_append.py:151",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_w8a16() -> list[dict]:
    """llama3-8b projection shapes at the decode (8 slots) and prefill
    (the 128 and 512 buckets, the 2048-row token budget) row counts: 8 rows
    take the GEMV kernel, the others the tensor-core kernel; one row of the
    `kernels` line for each regime, at the widest leaf (`wg`). Tolerance:
    one bf16 step at the largest output, 2**-7 * max|y| (the kernel and
    the plain version sum in float32 in different orders, then round to
    bf16)."""
    from symmetry_tpu_torch.ops.qmm import w8a16_matmul, w8a16_reference
    from symmetry_tpu_torch.ops.quant import pack_quantized, quantize

    shapes = {"wq": (4096, 4096), "wk": (4096, 1024), "wg": (4096, 14336),
              "wd": (14336, 4096), "lm_head": (4096, 128256)}
    regimes = {8: "gemv", 2048: "tc"}  # the rows reported, both on `wg`
    g = torch.Generator(device="cuda").manual_seed(40)
    worst = {"gemv": 0.0, "tc": 0.0}
    rows = {}
    for name, (K, N) in shapes.items():
        w = torch.randn((K, N), generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(K ** -0.5)
        qt = quantize(w)
        pt = pack_quantized(qt)
        w_lib = (qt.q.float() * qt.scale).to(torch.bfloat16)
        del w, qt
        for M in (8, 128, 512, 2048):
            regime = "gemv" if M == 8 else "tc"
            x = torch.randn((M, K), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            got = w8a16_matmul(x, pt.q, pt.scale)
            torch.cuda.synchronize()
            want = w8a16_reference(x, pt.q, pt.scale)
            err = float((got.float() - want.float()).abs().max())
            tol = 2.0 ** -7 * float(want.float().abs().max())
            if not torch.isfinite(got).all() or err > tol:
                raise AssertionError(f"w8a16 {name} M={M}: error {err} > "
                                     f"{tol}")
            worst[regime] = max(worst[regime], err)
            ms = device_ms(lambda: w8a16_matmul(x, pt.q, pt.scale), 20)
            call_ms = cuda_ms(lambda: w8a16_matmul(x, pt.q, pt.scale), 20)
            plain_ms = device_ms(
                lambda: w8a16_reference(x, pt.q, pt.scale), 3)
            library_ms = device_ms(lambda: torch.matmul(x, w_lib), 20)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            bound_ms, bound_by = bound(nbytes, 2.0 * M * K * N)
            log(f"  w8a16 {name} [{K}, {N}] M={M} ({regime}): "
                f"max_abs_err={err:.3e} (tol {tol:.3e}); device ms: kernel "
                f"{ms:.4f} ({call_ms:.4f} per eager call), plain "
                f"{plain_ms:.4f}, torch.matmul bf16 {library_ms:.4f}, bound "
                f"{bound_ms:.4f} ({bound_by})")
            if name == "wg" and M in regimes:
                rows[regime] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
            del x, got, want
        del pt, w_lib
        torch.cuda.empty_cache()
    return [dict(name=f"w8a16_matmul[{regime}]", route="cuda",
                 source="symmetry_tpu_torch/csrc/w8a16.cu",
                 replaces="symmetry_tpu/ops/qmm.py:251",
                 max_abs_err=worst[regime], **rows[regime])
            for regime in ("gemv", "tc")]


def check_w8a8() -> dict:
    """llama3-8b projection shapes at M = 32, 128 and 2048 rows: the kernel
    bit-equal to its plain version (exact int32 sums, the same two rounded
    multiplies). Timed: the wrapper (row quantization + kernel) against
    the plain version, torch._int_mm (the int8 product alone, weight in its
    column-major layout) as the library yardstick, and the bound at the
    int8 peak. No serving path routes W8A8: its launches are this phase's."""
    from symmetry_tpu_torch.ops.qmm import (quantize_rows, w8a8_matmul,
                                            w8a8_reference)
    from symmetry_tpu_torch.ops.quant import quantize

    shapes = {"wq": (4096, 4096), "wg": (4096, 14336), "wd": (14336, 4096),
              "lm_head": (4096, 128256)}
    g = torch.Generator(device="cuda").manual_seed(50)
    w8a8_matmul.launches = 0
    row = None
    for name, (K, N) in shapes.items():
        qt = quantize(torch.randn((K, N), generator=g, device="cuda",
                                  dtype=torch.bfloat16).mul_(K ** -0.5))
        w_col = qt.q.t().contiguous().t()  # _int_mm's fast layout
        for M in (32, 128, 2048):
            x = torch.randn((M, K), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            got = w8a8_matmul(x, qt.q, qt.scale)
            torch.cuda.synchronize()
            want = w8a8_reference(x, qt.q, qt.scale)
            if not torch.isfinite(got).all() or not torch.equal(got, want):
                err = float((got.float() - want.float()).abs().max())
                raise AssertionError(f"w8a8 {name} M={M}: not bit-equal to "
                                     f"the plain version (max err {err})")
            ms = device_ms(lambda: w8a8_matmul(x, qt.q, qt.scale), 10)
            kern_ms = device_ms(lambda: w8a8_matmul(x, qt.q, qt.scale), 10,
                                name="w8a8_")  # product (+ the K-split sum)
            plain_ms = device_ms(
                lambda: w8a8_reference(x, qt.q, qt.scale), 2)
            xq, _ = quantize_rows(x)
            library_ms = device_ms(lambda: torch._int_mm(xq, w_col), 10)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            bound_ms, bound_by = bound(nbytes, 2.0 * M * K * N, PEAK_INT8_OPS)
            log(f"  w8a8 {name} [{K}, {N}] M={M}: bit-equal; device ms: "
                f"wrapper {ms:.4f} (kernel alone {kern_ms:.4f}), plain "
                f"{plain_ms:.4f}, torch._int_mm {library_ms:.4f}, bound "
                f"{bound_ms:.4f} ({bound_by})")
            if (name, M) == ("wg", 2048):  # the prefill regime's widest leaf
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms)
            del x, got, want, xq
        del qt, w_col
        torch.cuda.empty_cache()
    return dict(name="w8a8_matmul", route="cuda",
                source="symmetry_tpu_torch/csrc/w8a8.cu",
                replaces="symmetry_tpu/ops/qmm.py:129", max_abs_err=0.0,
                launches=w8a8_matmul.launches,
                path="none: no serving path routes W8A8 in either package; "
                     "launches are phase 3's", **row)


# ---------------------------------------------------------------------------
# Phases 4-5: the engine behind the Scheduler


def serve(preset_name: str, *, device: str, dtype: torch.dtype,
          prompt_lens: list[int], max_new: int, max_slots: int,
          max_seq_len: int, buckets: tuple[int, ...], decode_block: int,
          params=None, seed: int = 0, on_ready=None, int8: bool = False) -> dict:
    """Build the engine, warm it, and serve greedy requests through the
    Scheduler. Returns per-request token ids and finish reasons, timings,
    and the scheduler's metrics. `on_ready` runs after warmup, just before
    the requests are submitted. int8=True serves int8 weights (drawn with
    init_params(quantize=True) unless given) packed for the W8A16 kernel
    (fused_dequant) and an int8 KV cache (kv_quant)."""
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
        params = init_params(cfg, gen, dtype, quantize=int8)
    engine = InferenceEngine(cfg, params, IdTokenizer(cfg.vocab_size),
                             max_slots=max_slots, max_seq_len=max_seq_len,
                             prefill_buckets=buckets, cache_dtype=dtype,
                             decode_block=decode_block, kv_quant=int8,
                             fused_dequant=int8, device=device)
    del params
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

    kw = dict(dtype=torch.float32, prompt_lens=[5, 14, 27], max_new=12,
              max_slots=2, max_seq_len=64, buckets=(16, 32), decode_block=4)
    for int8 in (False, True):
        params = init_params(preset("tiny"),
                             torch.Generator().manual_seed(0), torch.float32,
                             quantize=int8)
        card = serve("tiny", device="cuda", params=params, int8=int8,
                     **kw)["requests"]
        cpu = serve("tiny", device="cpu", params=params, int8=int8,
                    **kw)["requests"]
        for r_card, r_cpu in zip(card, cpu):
            if (r_card["ids"], r_card["reason"]) != (r_cpu["ids"],
                                                     r_cpu["reason"]):
                raise AssertionError(f"tiny int8={int8} card {r_card} != "
                                     f"cpu {r_cpu}")
        log(f"  tiny f32{' int8 weights + int8 KV' if int8 else ''}: "
            f"{len(card)} requests, greedy ids identical card vs CPU: "
            f"{[r['ids'][:6] for r in card]}...")


def check_full_width(smi: str, *, int8: bool) -> dict[str, int]:
    """Serve llama3-8b at full depth; returns the launch count of every
    kernel wrapper, all set to 0 just before the requests and read right
    after them (before the profile runs)."""
    from symmetry_tpu_torch.engine.engine import SamplingParams
    from symmetry_tpu_torch.ops.decode_attention import decode_attention
    from symmetry_tpu_torch.ops.flash import flash_prefill
    from symmetry_tpu_torch.ops.kv_append import kv_append
    from symmetry_tpu_torch.ops.qmm import w8a16_matmul

    wrappers = {"flash_prefill": flash_prefill,
                "decode_attention": decode_attention,
                "kv_append": kv_append, "w8a16_matmul": w8a16_matmul}

    def reset():
        for fn in wrappers.values():
            fn.launches = 0
        w8a16_matmul.launches_gemv = w8a16_matmul.launches_tc = 0
        for variant in flash_prefill.variant_launches:
            flash_prefill.variant_launches[variant] = 0
        torch.cuda.reset_peak_memory_stats()

    label = "int8 (W8A16 weights, int8 KV)" if int8 else "bf16"
    max_new = 64
    res = serve("llama3-8b", device="cuda", dtype=torch.bfloat16,
                prompt_lens=PHASE5_PROMPTS,
                max_new=max_new, max_slots=8, max_seq_len=4096,
                buckets=(128, 512, 2048), decode_block=8, on_ready=reset,
                int8=int8)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    variants = dict(flash_prefill.variant_launches)
    regimes = {"gemv": w8a16_matmul.launches_gemv,
               "tc": w8a16_matmul.launches_tc}
    cfg, m = res["config"], res["metrics"]
    L, steps, dispatches = cfg.num_layers, m["steps"], m["admit_dispatches"]
    log(f"  {label} launches {launches}, flash by variant {variants}, "
        f"W8A16 by regime {regimes}; scheduler admit_dispatches={dispatches} steps={steps} "
        f"tokens={m['tokens']}")
    for i, r in enumerate(res["requests"]):
        if r["reason"] != "length" or r["generated"] != max_new:
            raise AssertionError(f"request {i}: {r['reason']} after "
                                 f"{r['generated']} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r["ids"]):
            raise AssertionError(f"request {i}: token id out of range")
    want = {"flash_prefill": L * dispatches, "decode_attention": L * steps,
            "kv_append": L * steps if int8 else 0,
            # seven projections per layer and the LM head, per forward
            "w8a16_matmul": (7 * L + 1) * (steps + dispatches) if int8 else 0}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    # Prefill rows take the tensor-core kernel; decode steps (8 rows), and
    # a prefill's LM head on its last rows, the GEMV kernel.
    if sum(regimes.values()) != launches["w8a16_matmul"] or (
            int8 and min(regimes.values()) <= 0):
        raise AssertionError(f"W8A16 launches by regime {regimes}")
    # bf16 at head_dim 128: every flash launch takes the tensor-core kernel.
    if variants != {"tensor_core": L * dispatches, "fma": 0}:
        raise AssertionError(f"flash variants {variants}: not every launch "
                             f"went to the tensor-core kernel")
    engine = res["engine"]
    profile_dispatch(f"{label} decode block (8 steps x 8 slots)",
                     engine.decode_steps)
    prompt = list(range(1000, 3000))
    profile_dispatch(f"{label} prefill 2000 tokens (bucket 2048, batch 1)",
                     lambda: engine.prefill_and_insert(0, prompt,
                                                       SamplingParams()))
    ttft = [r["ttft_s"] for r in res["requests"]]
    log(f"  llama3-8b {label} on {smi}: 8 requests x {max_new} tokens; "
        f"TTFT p50 {statistics.median(ttft):.4f} s (max {max(ttft):.4f} s); "
        f"aggregate decode {res['decode_tok_s']:.2f} tok/s over 8 streams; "
        f"wall {res['wall_s']:.3f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; weights "
        f"streamed per decode step {engine.weight_stream_bytes() / 1e9:.3f} "
        f"GB")
    del launches["w8a16_matmul"]
    return {**launches, **{f"w8a16_matmul[{r}]": n
                           for r, n in regimes.items()}}


# ---------------------------------------------------------------------------
# Phases 7-8: the port's engine host (python -m symmetry_tpu_torch.engine.host)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
HOST_TIMEOUT = 300.0  # seconds for any one frame; a stall fails the phase

# The provider's default `tpu:` section (provider/config.py TpuConfig) is
# the base; each phase names only what it changes.
PROVIDER = {"name": "chip-smoke", "public": False, "serverKey": "00" * 32,
            "apiProvider": "tpu_native", "dataCollectionEnabled": False}


class HostProc:
    """One engine host subprocess: commands in on stdin, frames read back
    on a thread, each wait bounded; logs (stderr) to build/chip_smoke/."""

    def __init__(self, label: str, tpu: dict, *, device: str | None = None):
        import yaml

        os.makedirs(OUT_DIR, exist_ok=True)
        self.label = label
        cfg_path = os.path.join(OUT_DIR, f"host_{label}.yaml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump({**PROVIDER, "modelName": label, "tpu": tpu}, fh)
        self.log_path = os.path.join(OUT_DIR, f"host_{label}.log")
        self._log = open(self.log_path, "w")
        argv = [sys.executable, "-m", "symmetry_tpu_torch.engine.host",
                cfg_path] + (["--device", device] if device else [])
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        self.proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                                     stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self._log,
                                     text=True, bufsize=1)
        self.frames: list[dict] = []
        self._q: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            frame = json.loads(line)
            frame["_recv"] = time.monotonic()  # when this process read it
            self._q.put(frame)
        self._q.put(None)

    def send(self, obj: dict) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def wait_for(self, pred, timeout: float = HOST_TIMEOUT) -> dict:
        """Frames until one matches; raises if the host dies or stalls."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                frame = self._q.get(timeout=max(0.0, deadline -
                                                time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"host {self.label}: no frame in "
                                     f"{timeout:.0f} s (log {self.log_path})")
            if frame is None:
                raise AssertionError(f"host {self.label} exited rc="
                                     f"{self.proc.wait()} (log "
                                     f"{self.log_path})")
            self.frames.append(frame)
            if pred(frame):
                return frame

    def events(self, req_id: str) -> list[dict]:
        """The request's events, each stamped with its frame's `_recv`."""
        out = []
        for f in self.frames:
            if f.get("op") == "event" and f.get("id") == req_id:
                out.append(f)
            elif f.get("op") == "events":
                out += [{**e, "_recv": f["_recv"]} for e in f["events"]
                        if e["id"] == req_id]
        return out

    def wait_done(self, req_ids) -> None:
        for rid in req_ids:
            if not any(e.get("done") for e in self.events(rid)):
                self.wait_for(lambda f, rid=rid: any(
                    e.get("done") and e.get("id") == rid
                    for e in ([f] if f.get("op") == "event"
                              else f.get("events", []))))

    def stats(self) -> dict:
        self.send({"op": "stats"})
        return self.wait_for(lambda f: f.get("op") == "stats")

    def shutdown(self, timeout: float = 120.0) -> int:
        self.send({"op": "shutdown"})
        try:
            return self.proc.wait(timeout)
        finally:
            self.kill()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()

    def log_text(self) -> str:
        with open(self.log_path) as fh:
            return fh.read()


def submit(host: HostProc, req_id: str, content: str | list,
           max_new: int) -> None:
    messages = (content if isinstance(content, list)
                else [{"role": "user", "content": content}])
    host.send({"op": "submit", "id": req_id, "messages": messages,
               "max_new": max_new, "sampling": {"temperature": 0.0}})


def stream(host: HostProc, req_id: str) -> dict:
    evs = host.events(req_id)
    ttft = [e["ttft_s"] for e in evs if "ttft_s" in e]
    return dict(text="".join(e["text"] for e in evs),
                tokens=evs[-1]["tokens"], reason=evs[-1]["finish_reason"],
                reused=evs[0].get("reused"), ttft_s=ttft[0] if ttft else None,
                first_at=evs[0]["_recv"], done_at=evs[-1]["_recv"])


def check_host_tiny() -> None:
    """The host on `tiny` in float32, card against CPU, from one config with
    a small prefill_chunk (prompts chunk) and the prefix cache on: dense,
    then int8 weights (fused) and an int8 KV cache. Requests go one at a
    time; greedy streamed text must be identical."""
    long_msg = ("please summarize this rather long message so that its "
                "prompt spans several prefill chunks of the engine")
    conversation = [
        "hello",
        long_msg,
        long_msg,  # an exact repeat: a prefix-cache hit
        [{"role": "user", "content": long_msg},
         {"role": "assistant", "content": "ok"},
         {"role": "user", "content": "and now in one short line"}],
    ]
    base = {"model_preset": "tiny", "dtype": "float32", "max_batch_size": 2,
            "max_seq_len": 256, "prefill_buckets": [32, 64, 128, 256],
            "prefill_chunk": 32, "prefix_cache_mb": 1, "decode_block": 4}
    for int8 in (False, True):
        tpu = dict(base, **({"quantization": "int8",
                             "kv_quantization": "int8",
                             "fused_dequant": True} if int8 else {}))
        tag = "int8" if int8 else "f32"
        hosts = [HostProc(f"tiny_{tag}_cuda", tpu),
                 HostProc(f"tiny_{tag}_cpu", tpu, device="cpu")]
        try:
            for h in hosts:
                h.wait_for(lambda f: f.get("op") == "ready")
            for i, content in enumerate(conversation):
                for h in hosts:
                    submit(h, f"t{i}", content, 12)
                for h in hosts:
                    h.wait_done([f"t{i}"])
            card, cpu = ([stream(h, f"t{i}") for i in range(len(conversation))]
                         for h in hosts)
            stats = hosts[0].stats()
            for h in hosts:
                if h.shutdown() != 0:
                    raise AssertionError(f"host {h.label} exit code != 0")
        finally:
            for h in hosts:
                h.kill()
        for a, b in zip(card, cpu):
            if (a["text"], a["tokens"], a["reason"], a["reused"]) != (
                    b["text"], b["tokens"], b["reason"], b["reused"]):
                raise AssertionError(f"host tiny {tag}: card {a} != cpu {b}")
        if not (card[2]["reused"] or 0) > 0:
            raise AssertionError(f"host tiny {tag}: no prefix hit: {card}")
        k = stats["kernels"]
        if min(k["flash_prefill"], k["decode_attention"]) <= 0 or (
                int8 and min(k["kv_append"], k["w8a16_matmul"]) <= 0):
            raise AssertionError(f"host tiny {tag}: kernels {k}")
        log(f"  host tiny {tag}: {len(card)} requests, streamed text "
            f"identical card vs CPU (reused {[r['reused'] for r in card]}, "
            f"chunk dispatches {stats['chunk_dispatches']}, card launches "
            f"{k})")


def chat_content(rng: np.random.Generator, n: int) -> str:
    """n characters of lowercase words: n tokens under the byte tokenizer."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz    "))
    return "".join(rng.choice(letters, n))


def check_host_full(smi: str) -> dict:
    """llama3-8b in bf16 at full depth behind the port's host, from the
    provider's default `tpu:` section plus model_preset and a 1024 MiB
    prefix cache. Wave 1: 8 greedy chats, two <= 256 tokens (flash) and six
    chunked; wave 2: 4 chats sharing wave 1's longest prompt's first 1536
    tokens, two with short tails (the one-dispatch hit path) and two with
    ~300-token tails (the seeded chunked path)."""
    from symmetry_tpu_torch.engine.tokenizer import get_tokenizer
    from symmetry_tpu_torch.provider.config import TpuConfig

    tpu = {"model_preset": "llama3-8b", "prefix_cache_mb": 1024}
    defaults = TpuConfig.from_dict(tpu)
    tok = get_tokenizer(None, vocab_size=128256)
    head = len(tok.apply_chat_template([{"role": "user", "content": ""}]))
    rng = np.random.default_rng(0)
    max_new = 64
    lens1 = [60, 200, 300, 500, 800, 1100, 1500, 1880]
    wave1 = [chat_content(rng, n - head) for n in lens1]
    shared = wave1[-1][:1536 - 7]  # 7 template tokens precede the content
    wave2 = [shared + chat_content(rng, n) for n in (50, 60, 290, 300)]
    ids1 = [tok.apply_chat_template([{"role": "user", "content": c}])
            for c in wave1]
    ids2 = [tok.apply_chat_template([{"role": "user", "content": c}])
            for c in wave2]
    if [ids[:1536] for ids in ids2] != [ids1[-1][:1536]] * 4:
        raise AssertionError("wave 2 does not share 1536 tokens")
    log(f"  wave 1 prompt tokens {[len(i) for i in ids1]}, wave 2 "
        f"{[len(i) for i in ids2]} (prefill_chunk {defaults.prefill_chunk}, "
        f"buckets {defaults.prefill_buckets}, decode_block "
        f"{defaults.decode_block}, pipeline_depth {defaults.pipeline_depth})")
    host = HostProc("llama3_8b", tpu)
    try:
        ready = host.wait_for(lambda f: f.get("op") == "ready")
        before = host.stats()["kernels"]
        t0 = time.monotonic()
        for i, c in enumerate(wave1):
            submit(host, f"a{i}", c, max_new)
        host.wait_done([f"a{i}" for i in range(len(wave1))])
        t1 = time.monotonic()
        for i, c in enumerate(wave2):
            submit(host, f"b{i}", c, max_new)
        host.wait_done([f"b{i}" for i in range(len(wave2))])
        t2 = time.monotonic()
        stats = host.stats()
        rc = host.shutdown()
    finally:
        host.kill()
    if rc != 0:
        raise AssertionError(f"host exit code {rc}")
    r1 = [stream(host, f"a{i}") for i in range(len(wave1))]
    r2 = [stream(host, f"b{i}") for i in range(len(wave2))]
    for r in r1 + r2:
        if r["reason"] not in ("length", "stop") or not (
                0 < r["tokens"] <= max_new):
            raise AssertionError(f"host request ended {r['reason']} after "
                                 f"{r['tokens']} tokens")
    if not all((r["reused"] or 0) > 0 for r in r2):
        raise AssertionError(f"wave 2 without prefix reuse: "
                             f"{[r['reused'] for r in r2]}")
    if not stats["engine_alive"]:
        raise AssertionError("engine thread not alive at stats")
    blocks = stats["block_syncs"]
    writes = stats["emit"]["pipe_event_writes"]
    if writes > blocks + len(r1) + len(r2):
        raise AssertionError(f"{writes} event writes for {blocks} blocks")
    launches = {k: v - before[k] for k, v in stats["kernels"].items()}
    if min(launches["flash_prefill"], launches["decode_attention"]) <= 0:
        raise AssertionError(f"host path launches {launches}")
    text = host.log_text()
    mem = [m for m in re.findall(r"max_memory_allocated=([0-9.]+)GiB", text)]

    def ttft(rs):
        vals = [r["ttft_s"] for r in rs]
        return f"p50 {statistics.median(vals):.4f} s (max {max(vals):.4f} s)"

    # Phase 5's definition, per wave: tokens after each request's first,
    # over the wall from the wave's first first token to its last finish
    # (frames as this process read them).
    decoded = sum(r["tokens"] - 1 for r in r1 + r2)
    decode_wall = sum(max(r["done_at"] for r in rs)
                      - min(r["first_at"] for r in rs) for rs in (r1, r2))
    log(f"  llama3-8b bf16 host on {smi}: ready build_s {ready['build_s']} "
        f"warmup_s {ready['warmup_s']}; max_memory_allocated (host log, "
        f"ready / stopped) {' / '.join(mem)} GiB")
    log(f"  TTFT flash (<= 256 tokens, 2) {ttft(r1[:2])}; chunked (6) "
        f"{ttft(r1[2:])}; prefix hit, short tail (2) {ttft(r2[:2])}; prefix "
        f"hit, seeded chunked (2) {ttft(r2[2:])}; reused {[r['reused'] for r in r2]}")
    log(f"  aggregate decode {decoded / decode_wall:.2f} tok/s over both "
        f"waves ({decoded} tokens; wave 1 {t1 - t0:.3f} s, wave 2 "
        f"{t2 - t1:.3f} s from submit to last finish); "
        f"admit_dispatches {stats['admit_dispatches']} chunk_dispatches "
        f"{stats['chunk_dispatches']} steps {stats['steps']} block_syncs "
        f"{blocks} pipe_event_writes {writes}; prefix_cache hits "
        f"{stats['prefix_cache']['hits']} tokens_reused "
        f"{stats['prefix_cache']['tokens_reused']}; host path launches "
        f"{launches}")
    return tpu


def profile_host_path(tpu: dict) -> None:
    """In-process, on the same config: one chunk step at a mid-prompt
    position, one cached admission (short tail after a 1536-token hit), and
    the chunk's attention (the plain einsum, gqa_attention) alone."""
    from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                  SamplingParams)
    from symmetry_tpu_torch.ops.attention import gqa_attention
    from symmetry_tpu_torch.provider.config import TpuConfig

    engine = InferenceEngine.from_tpu_config(TpuConfig.from_dict(tpu))
    engine.warmup()
    C = engine.prefill_chunk
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 50000, 1800).tolist()
    job = engine.start_chunked_prefill(0, prompt, SamplingParams())
    for _ in range(4):  # 1024 tokens in
        engine.advance_chunked_prefill(job)
    cache = job.cache
    chunk = torch.from_numpy(job.ids[:, 4 * C:5 * C]).cuda()
    valid = torch.tensor([C], dtype=torch.int32, device="cuda")
    profile_dispatch(f"chunk step ({C} tokens at positions 1024.., bucket "
                     f"2048, batch 1)",
                     lambda: engine._chunk_step(chunk, cache, valid))
    while engine.advance_chunked_prefill(job) is None:
        pass

    def cached():  # a fresh tail each call, so each hits at 1536 tokens
        hit_prompt = prompt[:1536] + rng.integers(0, 50000, 60).tolist()
        hit = engine.prefix_lookup(hit_prompt)
        if hit is None or hit.length != 1536:
            raise AssertionError(f"no 1536-token hit: {hit}")
        engine.prefill_and_insert_cached([(1, hit_prompt, SamplingParams())],
                                         hit)

    profile_dispatch("cached admission (1536-token hit + 60-token suffix, "
                     "bucket 2048)", cached)
    c = engine.config
    g = torch.Generator(device="cuda").manual_seed(60)
    q = torch.randn((1, C, c.num_heads, c.dim_per_head), generator=g,
                    device="cuda", dtype=torch.bfloat16)
    kc = torch.randn((1, 2048, c.num_kv_heads, c.dim_per_head), generator=g,
                     device="cuda", dtype=torch.bfloat16)
    vc = torch.randn_like(kc)
    pos = (1024 + torch.arange(C, device="cuda", dtype=torch.int32))[None]
    kv_len = torch.tensor([1024 + C], dtype=torch.int32, device="cuda")
    attn_ms = device_ms(lambda: gqa_attention(q, kc, vc, pos, kv_len), 20)
    log(f"  chunk attention (gqa_attention, plain einsum; q {C} x "
        f"{c.num_heads} x {c.dim_per_head}, cache 2048 x {c.num_kv_heads}, "
        f"{1024 + C} live): {attn_ms:.4f} device ms per layer, "
        f"{attn_ms * c.num_layers:.3f} ms per chunk over {c.num_layers} "
        f"layers")


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
    rows = [check_flash(), check_decode(int8=False), check_decode(int8=True),
            check_kv_append(), *check_w8a16()]
    check_no_host_sync()
    w8a8_row = check_w8a8()
    torch.cuda.empty_cache()

    log("phase 4: tiny engine, card against CPU (float32)")
    check_tiny()

    log("phase 5: llama3-8b bf16 full width through the Scheduler")
    bf16 = check_full_width(smi, int8=False)
    gc.collect()  # frees the bf16 engine before the int8 one is built
    torch.cuda.empty_cache()

    log("phase 6: llama3-8b int8 full width through the Scheduler")
    int8 = check_full_width(smi, int8=True)
    # Each route's launches from the serving path it belongs to.
    launches = {"flash_prefill": bf16["flash_prefill"],
                "decode_attention": bf16["decode_attention"],
                "decode_attention_int8": int8["decode_attention"],
                "kv_append": int8["kv_append"],
                "w8a16_matmul[gemv]": int8["w8a16_matmul[gemv]"],
                "w8a16_matmul[tc]": int8["w8a16_matmul[tc]"]}
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on the path")
    rows.append(w8a8_row)
    gc.collect()  # frees the int8 engine before the host phases
    torch.cuda.empty_cache()

    log("phase 7: engine host, tiny, card against CPU")
    check_host_tiny()

    log("phase 8: engine host, llama3-8b bf16, the provider's default tpu: "
        "section")
    tpu = check_host_full(smi)
    profile_host_path(tpu)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in keys},
         **({"path": row["path"]} if "path" in row else {})}
        for row in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
