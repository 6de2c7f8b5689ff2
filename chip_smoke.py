#!/usr/bin/env python3
"""Drive the PyTorch port (symmetry_tpu_torch) on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(`python3 chip_smoke.py --tp` runs phases 14 to 17 alone, with the nccl
passes of 14, 15, 16 and 17 where the machine has two cards, and 16's
four-rank pass where it has four.)

Phases (any failure raises and exits non-zero):
  1. device   require CUDA; print the card, its capability, name and power
              limit (nvidia-smi);
  2. build    compile the CUDA kernels from symmetry_tpu_torch/csrc/ (six
              libraries, one nvcc per translation unit, all started
              together: decode_attention.cu is eleven, ops/kernels.py
              PARTS);
  3. kernels  each kernel against its plain PyTorch version at the serving
              path's widths (llama3-8b heads and weights, bf16): flash
              (the tensor-core variant) and decode attention (bf16 and
              int8 caches, and a qwen2-7b group of 7) within 2e-2 on valid
              rows, both also at head dims 96 and 192 (run at the next
              built size; flash in float32 too, within 1e-4); decode
              attention writing the step's K/V row itself (append mode,
              int8 and bf16, groups of 4, 7 and 16, head dim 96, positions
              at span edges, T - 1, past T and past the slot's length)
              bit-equal in caches and output to the unfused pair (the
              standalone KV append or index assignment, then decode) and
              within one bf16 step of the plain version; the standalone
              KV append bit for bit; W8A16 within one bf16 step of its
              largest output (wq, wk, wg, wd, lm_head and mixtral-8x7b's
              [4096, 32000] LM head at 1, 2, 8 and 16 bf16 rows, the swap-AB tensor-core GEMV, and at 128, 512 and
              2048 rows, the tensor-core kernel) and within 1e-5 of it in
              float32 (every leaf at 1, 8, 16, 32, 128 and 2048 rows, the
              float32 GEMV); one rank's blocks at TP=2 (phase 14): flash
              and decode at 16 query heads over 4 KV heads, W8A16 on the
              column-parallel N-slices of wq, wk, wg and lm_head and, in
              the mesh's own mode (apply_scale off, float32 out, within
              1e-5), the row-parallel K-slices of wo and wd, at GEMV and
              tensor-core rows; W8A8 bit for bit (wq, wg, wd, lm_head at 32,
              128 and 2048 rows, K splits included; no serving path routes
              it); the grouped int8 expert GEMV at mixtral-8x7b's decode
              shapes (`wg` and `wd`, eight experts, 1, 8 and 16 bf16 rows
              and 8 float32 rows, scaled and raw) within one bf16 step of
              its largest output, 3e-5 of it on a float32 output; kernel,
              plain and library (a yardstick only) device
              times (kernel durations summed by torch.profiler, decode's
              split and combine kernels together; CUDA events around
              each call, logged, where three profiler sessions drop the
              kernels' records; the eager call's
              CUDA-event time is logged beside; GEMV times cold, the L2
              flushed before each call), and each kernel's bound; flash
              also at the coalesced-prefill shape (B=4 S=512, ragged) and
              decode also at phase 5's lengths, fused and unfused; then
              flash (both variants), decode (bf16, int8, with and without
              the row write), W8A16 (all three kernels) and W8A8 (whole
              and split over K) once more under
              torch.cuda.set_sync_debug_mode("error"): no wrapper may
              synchronize with the host;
  4. tiny     the `tiny` preset in float32 through the port's engine and
              Scheduler on the card (kernels) and on the CPU (plain
              versions): greedy dense, greedy with int8 weights (the
              float32 GEMV) and an int8 KV cache, greedy at head dim 96,
              and seeded sampling (threefry key chains): token ids must be
              identical;
  5. serve    llama3-8b in bf16 at full width and depth (random weights
              from torch.Generator seed 0) behind the port's Scheduler:
              8 greedy requests over the three prefill buckets, 64 new
              tokens each, through flash and decode attention, every
              decode launch writing its row (launch counts checked: no
              standalone KV append; every flash launch on the tensor-core
              variant); the decode block profiled with the row write
              fused, unfused (the pair it replaced) and fused again:
              kernels and device busy time of each;
  6. int8     the same traffic on llama3-8b at full depth with int8
              weights (init_params(quantize=True), seed 0) packed for the
              W8A16 kernel and an int8 KV cache: flash, int8 decode
              attention writing the quantized row, and W8A16 on the path
              (launch counts checked, W8A16's per regime: the tensor-core
              kernel at prefill, the GEMV kernel at decode; flash as in
              phase 5); the decode block as in phase 5, whose kernels must
              drop by at least one a layer and step when fused, and its
              GEMV device ms and launches a step; both phases print a
              digest of their greedy streams, the same on every run;
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
  9. spec     speculative decoding on llama3-8b at full width and depth,
              8 slots, k_draft 8, bf16 and then int8: (a) a plain greedy
              run's continuation as every slot's draft is accepted whole,
              and a draft corrupted at j stops the slot at j + 1 tokens,
              the tokens the plain run's (the verify forward's logits on
              the plain context within LOGIT_TOL of the plain run's; a
              slot may part from it only at a near tie); int8 verifies
              all on the tensor-core W8A16 kernel; (b) through the
              Scheduler on cycling weights, greedy output identical with
              speculation on and off, with verify blocks; (c) a seeded
              sampled stream runs to its budget; the verify dispatch's
              wall, device busy and kernels, acceptance and tok/s on and
              off;
 10. ckpt     a bf16 HF-layout checkpoint at llama3-8b width and 2 layers
              written by the port's writer (2 shards and an index json)
              into build/chip_smoke/ckpt; the leaves loaded on the card
              bit-equal to those written; the engine host started on it
              at the provider's default `tpu:` section, cold (warm cache
              written) and warm (from it), in bf16 and with
              quantization: int8: streamed text identical to an
              in-process engine built from the same tensors through
              params_from_numpy, the warm cache's leaves bit-equal to that
              engine's; load seconds and each host's peak RSS; the
              directory, with its warm caches, kept for phases 11-15 and
              removed after them;
 11. disagg   phase 10's checkpoint (llama3-8b width, 2 layers: a depth
              cut from 32 that keeps the script inside its time limit),
              bf16 and then int8, the
              provider's default `tpu:` section plus a 1024 MiB prefix
              cache and 32-token prefix blocks: (a) a unified engine host
              serves 3 chats of 60-1880 tokens, a 21-token chat and a
              repeat, one at a time, 32 new tokens each, twice (from an
              empty prefix cache, then hitting it); (b) a prefill-role
              host and two decode-role hosts (probes off, and
              profile_sample 4), each `handoff` frame piped into both
              decode hosts' `adopt`: streamed text identical to (a)'s
              second serve, the short chat routing-only, the repeat's
              frame manifest only; (c) the probed host's devprof rider
              (device seconds per dispatch kind, gap_share,
              device_s_total) beside torch.profiler's reading of one
              decode block in-process; (d) the `profile` op while the
              probed host decodes: its trace names the decode-attention
              kernel; (e) frame
              bytes per prefix token, serialize and adopt seconds;
 12. provider the port's server (in this process), provider (`python -m
              symmetry_tpu_torch.provider -c <yaml>`, whose engine host is
              a third process) and client, over TCP on 127.0.0.1 with
              Noise handshakes, at phase 11's configurations: (a) bf16
              unified: phase 11's chats one at a time twice, text equal to
              phase 11's unified host, cold for cold and cached for
              cached; a burst of 8 sessions (60-1880 tokens x 64), client
              TTFT and tok/s beside the host's; flash and decode launches
              in the kernels rider read over the wire; the host SIGKILLed
              mid-stream: the client shed retryable, the supervisor's
              respawn built no kernel and serves the same text; (b) int8
              `tpu.role: disagg`: the provider's own broker pipes handoff
              -> adopt between a prefill and a decode host, text equal to
              phase 11's int8 decode tiers, W8A16 GEMV launches on the
              decode host and tensor-core ones on the prefill host;
 13. moe      the mixtral family (models/moe.py): (a) `tiny-moe` in
              float32, card against CPU: greedy dense, int8 weights +
              int8 KV, and two prompts of 96 and 70 tokens through the
              capacity-factor dispatch: token ids identical; (b)
              mixtral-8x7b at full width and all 32 layers with int8
              weights (init_params(quantize=True), seed 0; the pack_tree
              report lists exactly the three expert stacks, left flat for
              the grouped expert GEMV) and an int8 KV cache, phase 5's
              traffic with 32 new tokens: flash, decode attention writing
              its row, W8A16 (attention projections and the LM head) and
              grouped GEMV (three a layer and decode step) launch
              counts, every prefill layer through the dispatch; finish
              reasons, memory, weight_stream_bytes, a greedy digest and
              the same requests served again on the same engine with
              identical token ids, one decode block and one 2048-token
              prefill profiled; (c) bf16 at full width and 8 of 32
              layers, the same traffic, launch counts, a digest and the
              second serve; (d) one layer's dispatch at no-drop
              capacity against the dense mixture at 2048 tokens within
              2e-2 of the largest output, no token routed differently;
              and one layer with int8 experts against the plain mixed-dot
              mixture within 2e-2 of the largest output, at decode and
              through the dispatch, each path bit-equal when called again,
              and the decode step's grouped GEMV products one result in
              201 calls under a second stream's load; (e) a
              mixtral-8x7b-width bf16 checkpoint at 2 layers served
              through from_tpu_config with quantization: int8: quantized
              as it is read (peak memory within the int8 engine's bytes
              plus 2 GiB, under the dense tree's), leaves bit-equal to
              quantize_params of the tensors written;
 14. tp       tensor parallelism over the model axis (parallel/), two
              ranks (processes) laid out on the one card over gloo, each
              holding half of every sharded leaf: (a) `tiny` in float32,
              dense then int8 weights + int8 KV, text equal to one CPU
              rank's and first-step logits within 1e-4; (b) phase 10's
              checkpoint loaded sharded from its warm caches, bf16 then
              int8 + kv_quant + fused_dequant, phase 11's three distinct
              chats one at a time (8 new tokens, decode block 8) through
              rank 0's Scheduler and the command loop, twice:
              tokens equal on every rank, the repeat equal, first-step
              logits within LOGIT_TOL of one rank's on the same
              checkpoint, each rank's weights and streamed bytes half the
              model's, its peak memory under the whole model's weights,
              every on-path kernel launched on every rank; (c) the
              provider as rank 0 (`tpu.multihost`, its engine host joins
              the job) and `python -m symmetry_tpu_torch.provider
              --worker` as rank 1, the same chats over TCP, text equal
              to (b)'s; an nccl pass of (b) where the machine has two
              cards (logged when not run);
 15. dp       the data axis (parallel/, engine/engine.py): ranks on the
              one card over gloo, each owning a block of the slots (its
              decode cache holds only those, its decode computes only
              those rows, the tokens all-gathered): (a) `tiny` in float32
              at {data: 2} (dense, then int8 weights + int8 KV) and at
              {data: 2, model: 2} on four ranks, prompts submitted
              together over four slots: text equal to one CPU rank's,
              first-step logits within 1e-4; (b) phase 10's checkpoint at
              {data: 2}, bf16 then int8 + kv_quant + fused_dequant, four
              slots, phase 14's three chats and a repeat of the first
              submitted together (both ranks' blocks live; 8 new tokens,
              decode block 8, no prefix cache): text equal to one rank's
              serve of the same chats, tokens and launches equal on both
              ranks, each rank's KV cache half of one rank's and its
              weights whole; an nccl pass of (b) bf16 where the machine
              has two cards;
 16. pp, cp   the stage and context axes (parallel/pipeline.py,
              ring.py, ulysses.py): ranks on the one card over gloo, one
              spawn a mesh: (a) `tiny` in float32 at {stage: 2} (1 and 2
              microbatches, dense then int8 weights + int8 KV) and at
              {context: 2} (dense, int8), prompts submitted together over
              four slots: text equal to one CPU rank's, first-step logits
              within 1e-4; (b) phase 10's checkpoint (one layer a stage)
              at {stage: 2} with two microbatches, bf16 then int8 +
              kv_quant + fused_dequant (which degrades to the mixed dot:
              log and QMM_FALLBACK `stage_axis`), phase 15's four chats
              together: text equal to one rank's serve, tokens and
              launches equal on both ranks, each rank's KV cache half of
              one rank's, its weights its layer plus the embedding, head
              and final norm; (c) the checkpoint at {context: 2}:
              forward_hidden with ring_mesh, ring then Ulysses, at B = 2
              over a 4096-token bucket (seq_lens 4096, 3000) against one
              rank's flash forward in bf16 (max abs error within 0.25,
              ring and Ulysses within it of each other), and the engine,
              bf16 and int8, text equal to one rank's serve; then, on four
              ranks in one spawn beside (a)-(c)'s, the same bucket at
              {context: 2, model: 2} (each rank its `model` block; bf16,
              then int8 + kv_quant + fused_dequant) and at {data: 2,
              context: 2} (bf16): ring and Ulysses hidden states within
              0.25 of one rank's flash forward and of each other, one
              decode step from the cache each wrote with logits within
              LOGIT_TOL of one rank's, launches equal on every rank
              (W8A16 tensor-core and int8 decode non-zero), each rank's
              KV cache and weights half of one rank's at {context: 2,
              model: 2}, whole and the hidden states equal on both data
              replicas at {data: 2, context: 2}; an nccl pass of the
              {context: 2, model: 2} bf16 row where the machine has four
              cards;
 17. ep       the expert axis and MoE on every mesh axis (models/moe.py,
              engine/engine.py, engine/weights.py): ranks on the one card
              over gloo, one spawn of two ranks and one of four, each job
              on its own mesh: (a) `tiny-moe` in float32, prompts of 5, 14
              and 40 tokens together over four slots (the 40's prefill
              through the dispatch), at {expert: 2} (dense, then int8 +
              int8 KV), {model: 2}, {stage: 2} (two microbatches),
              {context: 2}, {expert: 2, model: 2} and {data: 2, expert:
              2}: text equal to one CPU rank's, first-step logits within
              1e-4; (b) phase 13(e)'s mixtral-8x7b-width checkpoint (kept
              until this phase ends) loaded sharded at {expert: 2} through
              from_tpu_config, bf16 then int8 + kv_quant + fused_dequant,
              phase 15's section and four chats together: text equal to
              one rank's serve, tokens and launches equal on both ranks,
              first-step logits within LOGIT_TOL of one rank's, each
              rank's expert bytes exactly half of one rank's and every
              other byte whole, its KV cache whole; (c) the checkpoint at
              {expert: 2, model: 2} on four ranks, bf16: text equal to
              (b)'s one-rank serve, experts a quarter a rank; under --tp
              with two cards, mixtral-8x7b bf16 at all 32 layers at
              {expert: 2} over nccl (logged when not run);
 report       one JSON line listing the ten kernel rows (W8A16 one per
              regime; the KV append fused into decode attention on the
              path, and standalone from phase 3; `launches_moe`: each
              row's launches in phase 13; `launches_tp`: rank 0's in
              phase 14, equal on both ranks; `launches_dp`: rank 0's in
              phase 15 (a)-(b) at {data: 2}, equal on both ranks;
              `launches_pp` and `launches_cp`: rank 0's in phase 16 at
              {stage: 2} and {context: 2}, the W8A16 rows 0 at {stage: 2}
              with the reason in `launches_pp_reason`; `launches_cp_tp`:
              rank 0's in phase 16(c) at {context: 2, model: 2}, bf16 and
              int8, equal on all four ranks, the rows its path does not
              reach (flash: the ring replaces it) 0 with the reason in
              `launches_cp_tp_reason`; `launches_ep`: rank
              0's in phase 17 (a)-(b) at {expert: 2}), the nvidia-smi
              line, and last the {"ok": true, ...} line. Each phase prints
              its seconds.

Needs the CUDA toolkit (nvcc) and the repository's sources; nothing else.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import gc
import hashlib
import json
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and int8 tensor cores,
# float32 on the CUDA cores (67 TFLOP/s: 132 SMs x 128 FMA lanes x 2
# operations at the 1.98 GHz boost clock), HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The card's L2 holds 50 MB; a GEMV leaf that fits would be timed warm
# back to back, where a decode step that streams 7.5 GB finds it cold.
# `flush_l2` writes this many bytes before each call (the write's kernel is
# left out of the time by name).
FLUSH_BYTES = 256 * 2**20
FLUSH_KERNEL = "FillFunctor"
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


def device_ms(fn, iters: int, name: str = "", per_call: int = 0,
              before=None) -> float:
    """Device time of one call of fn: the CUDA kernels' durations summed by
    torch.profiler over `iters` calls, after a warm-up. Idle gaps between
    launches (the host's share) are not counted, so a small kernel is not
    measured by its wrapper's Python overhead. With `name`, only the
    kernels whose name contains it (one kernel of a wrapper that launches
    several); with `per_call`, the profiler must see that many matching
    kernels a call; `before` runs ahead of each call and its kernels are
    left out (`cold_ms`'s L2 flush, by FLUSH_KERNEL's name).

    A profiling session now and then records nothing, or drops some of
    the kernels' records (seen on the card). Then another is taken; after
    three such sessions the time is taken with CUDA events around each
    call instead, and a log line says so. More matching kernels than
    `per_call` a call is a wrapper's fault and fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        if before is not None:
            before()
        fn()

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if getattr(ev, "device_type", None) == DeviceType.CUDA
                  and name in ev.key
                  and not (before is not None and FLUSH_KERNEL in ev.key)]
        busy_us = sum(getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0))
                      for ev in events)
        count = sum(ev.count for ev in events)
        if per_call and count > per_call * iters:
            raise AssertionError(
                f"{count} kernels {name!r} over {iters} calls, "
                f"{per_call} a call expected: "
                f"{sorted({ev.key for ev in events})}")
        if busy_us > 0 and (not per_call or count == per_call * iters):
            return busy_us / 1e3 / iters
        seen.append((count, round(busy_us, 3)))
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for start, end in zip(starts, ends):
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters
    log(f"  (the profiler saw (kernels, busy us) {seen} in three sessions "
        f"of {iters} calls {name!r}, {per_call or 'any'} kernels a call "
        f"expected: timed with CUDA events around each call instead, "
        f"{ms:.4f} ms)")
    return ms


_flush: list[torch.Tensor] = []


def flush_l2() -> None:
    """Write FLUSH_BYTES, so the next call finds its operands in device
    memory and not in L2."""
    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    _flush[0].zero_()


def cold_ms(fn, iters: int, name: str = "", per_call: int = 0) -> float:
    """device_ms of fn with L2 flushed before each call."""
    return device_ms(fn, iters, name=name, per_call=per_call,
                     before=flush_l2)


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


def flash_case(B, S, seq_lens, window, seed, D=128, dtype=torch.bfloat16,
               H=32, K=8):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

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
                                              flash_prefill_reference,
                                              flash_variant, padded_head_dim)

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
    # Head dims between the built sizes: 96 runs at 128, 192 at 256 (bf16
    # on the tensor cores, float32 on FMAs; float32 held at 1e-4).
    for D in (96, 192):
        for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, 1e-4)):
            lens = [512, 300]
            q, k, v, seq_lens = flash_case(2, 512, lens, None, seed=D,
                                           D=D, dtype=dtype)
            got = flash_prefill(q, k, v, seq_lens, window=256)
            torch.cuda.synchronize()
            want = flash_prefill_reference(q, k, v, seq_lens, window=256)
            err = max(float((got[b, :n].float() - want[b, :n].float())
                            .abs().max()) for b, n in enumerate(lens))
            log(f"  flash head_dim {D} {str(dtype)[6:]} B=2 S=512 "
                f"lens={lens} window=256 ({flash_variant(dtype, D)}, run "
                f"at {padded_head_dim(D)}): max_abs_err={err:.3e} (tol "
                f"{tol:.0e})")
            if not torch.isfinite(got).all() or err > tol:
                raise AssertionError(f"flash head_dim {D} {dtype}: error "
                                     f"{err} > {tol}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    # One rank's heads of llama3-8b at tensor-parallel degree 2 (phase 14):
    # 16 query heads over 4 KV heads.
    lens = [2048, 1900, 700, 64]
    q, k, v, seq_lens = flash_case(4, 2048, lens, None, seed=12, H=16, K=4)
    got = flash_prefill(q, k, v, seq_lens)
    torch.cuda.synchronize()
    want = flash_prefill_reference(q, k, v, seq_lens)
    err = max(float((got[b, :n].float() - want[b, :n].float()).abs().max())
              for b, n in enumerate(lens))
    log(f"  flash TP=2 shard H=16 K=4 B=4 S=2048 lens={lens}: "
        f"max_abs_err={err:.3e}")
    if not torch.isfinite(got).all() or err > TOL:
        raise AssertionError(f"flash H=16 K=4: error {err} > {TOL}")
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
        HEAD_DIMS, decode_attention, decode_attention_reference, live_blocks)

    label = "int8" if int8 else "bf16"
    L, B, T, nq, K, D = 2, 8, 4096, 32, 8, 128
    q, k_cache, v_cache, ks, vs, lengths = decode_case(
        L, B, T, nq, K, D, [0, 1, T, 1024, 777, 3000, 2048, 64], 20, int8)
    worst = 0.0
    # llama3-8b heads (32 over 8), then qwen2-7b's group of 7 (28 over 4),
    # then one rank's heads of llama3-8b at TP=2 (16 over 4, phase 14)
    for layer, window in ((1, None), (0, None), (1, 1000), (1, "qwen2"),
                          (1, "tp2")):
        args = (q, k_cache, v_cache, layer, lengths, ks, vs)
        if window in ("qwen2", "tp2"):
            args = (decode_case(2, 4, 512, 28, 4, 128, [512, 300, 1, 77], 21,
                                int8) if window == "qwen2" else
                    decode_case(2, 8, 2048, 16, 4, 128,
                                [0, 1, 2048, 1024, 777, 1500, 60, 64], 22,
                                int8))
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
    # Head dims between the built sizes: 96 runs at 128, 192 at 256.
    for D in (96, 192):
        args = decode_case(2, 4, 1024, 32, 8, D, [1024, 300, 1, 700], 24 + D,
                           int8)
        args = args[:3] + (1, args[5]) + args[3:5]
        got = decode_attention(*args, window=500)
        torch.cuda.synchronize()
        want = decode_attention_reference(*args, window=500)
        err = float((got.float() - want.float()).abs().max())
        log(f"  decode {label} head_dim {D} (run at "
            f"{next(d for d in HEAD_DIMS if d >= D)}) q {tuple(got.shape)} "
            f"window=500 lengths {args[4].tolist()}: max_abs_err={err:.3e}")
        if not torch.isfinite(got).all() or err > TOL:
            raise AssertionError(f"decode {label} head_dim {D}: error {err} "
                                 f"> {TOL}")
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


def check_fused_append() -> dict:
    """The decode launch's own write of the step's K/V row (append mode)
    against the unfused pair -- the standalone kv_append kernel (int8) or
    index assignment (bf16), then decode attention -- bit for bit in
    caches and outputs, and against the plain version (append, then the
    reference) within one bf16 step of the largest output on live slots:
    int8 and bf16 caches at llama3-8b widths (8 slots, capacity 4096, 8 KV
    heads of 128, groups of 4), and at capacity 1024 with groups of 7
    (qwen2-7b) and 16, and head dim 96 (run at 128); the step's positions
    at a span's first and last rows, at T - 1, past T (a stale slot: row
    T - 1), past the slot's length (written, not read), and in an empty
    slot. Timed at phase 5's lengths: the fused launch, decode alone, the
    pair, the plain version. Returns the `kernels` row of the int8 fused
    route (kv_append.py:151 on the serving path)."""
    from symmetry_tpu_torch.ops.decode_attention import (
        SPAN, decode_attention, decode_attention_reference)
    from symmetry_tpu_torch.ops.kv_append import kv_append

    def pair(q, caches, layer, lengths, rows, pos):
        k_cache, v_cache, ks, vs = caches
        if ks is not None:
            kv_append(k_cache, v_cache, ks, vs, *rows, layer, pos)
        else:
            T = k_cache.shape[2]
            b = torch.arange(k_cache.shape[1], device="cuda")
            p = pos.long().clamp(0, T - 1)
            k_cache[layer, b, p], v_cache[layer, b, p] = rows
        return decode_attention(q, k_cache, v_cache, layer, lengths, ks, vs)

    worst, row = 0.0, None
    for int8 in (True, False):
        label = "int8" if int8 else "bf16"
        for nq, K, D, T in ((32, 8, 128, 4096), (28, 4, 128, 1024),
                            (64, 4, 128, 1024), (32, 8, 96, 1024)):
            *state, lengths = decode_case(2, 8, T, nq, K, D,
                                          [SPAN + 1, SPAN, T, T, 300, 1,
                                           2 * SPAN + 6, 0], 70 + nq + D,
                                          int8)
            q, caches = state[0], state[1:3] + state[3:5]
            g = torch.Generator(device="cuda").manual_seed(nq * D)
            rows = tuple(torch.randn((8, K, D), generator=g, device="cuda",
                                     dtype=torch.bfloat16) for _ in range(2))
            pos = torch.tensor([SPAN, SPAN - 1, T - 1, T + 9, 700, 0,
                                2 * SPAN + 5, 100], dtype=torch.int32,
                               device="cuda")
            fused, unfused, plain = ([c.clone() if c is not None else None
                                      for c in caches] for _ in range(3))
            got = decode_attention(q, fused[0], fused[1], 1, lengths,
                                   fused[2], fused[3], append=(*rows, pos))
            want = pair(q, unfused, 1, lengths, rows, pos)
            ref = decode_attention_reference(q, plain[0], plain[1], 1,
                                             lengths, plain[2], plain[3],
                                             append=(*rows, pos))
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(fused, unfused)
                    if a is not None]
            same_plain = [torch.equal(a, b) for a, b in zip(fused, plain)
                          if a is not None]
            live = lengths > 0
            err = float((got[live].float() - ref[live].float()).abs().max())
            tol = 2.0 ** -7 * float(ref[live].float().abs().max())
            log(f"  fused append {label} q {tuple(q.shape)} cache "
                f"{tuple(caches[0].shape)} positions {pos.tolist()} lengths "
                f"{lengths.tolist()}: caches bit-equal to the pair {same} "
                f"and to the plain write {same_plain}, output bit-equal to "
                f"the pair {torch.equal(got, want)}; max_abs_err vs plain "
                f"{err:.3e} (tol {tol:.3e})")
            if not (all(same) and all(same_plain) and torch.equal(got, want)
                    and torch.isfinite(got).all() and err <= tol):
                raise AssertionError(f"fused append {label} nq={nq} K={K} "
                                     f"D={D}: differs from the unfused pair "
                                     f"or the plain version")
            if int8:
                worst = max(worst, err)
            del state, caches, fused, unfused, plain
        # Timing at llama3-8b widths and phase 5's lengths, the step
        # writing each slot's row at length - 1.
        q, *caches, _ = decode_case(2, 8, 4096, 32, 8, 128, [1] * 8, 80,
                                    int8)
        p5 = torch.tensor([n + 32 for n in PHASE5_PROMPTS],
                          dtype=torch.int32, device="cuda")
        rows = tuple(torch.randn((8, 8, 128), device="cuda",
                                 dtype=torch.bfloat16) for _ in range(2))
        append = (*rows, p5 - 1)
        ms = device_ms(lambda: decode_attention(
            q, caches[0], caches[1], 1, p5, caches[2], caches[3],
            append=append), 50)
        alone_ms = device_ms(lambda: decode_attention(
            q, caches[0], caches[1], 1, p5, caches[2], caches[3]), 50)
        pair_ms = device_ms(lambda: pair(q, caches, 1, p5, rows, append[2]),
                            50)
        plain_ms = device_ms(lambda: decode_attention_reference(
            q, caches[0], caches[1], 1, p5, caches[2], caches[3],
            append=append), 10)
        nbytes, flops = decode_work(q, caches[0], p5, None)
        # the rows read in q's dtype, written in the cache's, and a scale
        # each for an int8 cache
        nbytes += 2 * 8 * 8 * 128 * (2 + caches[0].element_size()) + (
            2 * 8 * 8 * 4 if int8 else 0) + 4 * 8
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"  fused append timing {label} B=8 T=4096 nq=32 K=8 D=128 at "
            f"phase 5's lengths (device ms): fused launch {ms:.4f}, decode "
            f"alone {alone_ms:.4f} (the write adds {ms - alone_ms:+.4f}), "
            f"unfused pair {pair_ms:.4f}, plain {plain_ms:.4f}, bound "
            f"{bound_ms:.4f} ({bound_by})")
        if int8:
            row = dict(name="kv_append_fused", route="cuda",
                       source="symmetry_tpu_torch/csrc/decode_attention.cu",
                       replaces="symmetry_tpu/ops/kv_append.py:151",
                       max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del q, caches
    return row


def check_no_host_sync() -> None:
    """No wrapper synchronizes with the host: flash (both variants), decode
    (bf16 and int8, with and without the fused row write), W8A16 (GEMV,
    GEMV split over K, float32 GEMV, tensor-core) and W8A8
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
    xf = torch.randn((8, 4096), generator=g, device="cuda")
    rows = torch.randn((2, 4, 8, 128), generator=g, device="cuda",
                       dtype=torch.bfloat16)
    append = (rows[0], rows[1], bf16[5] - 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flash_prefill(q, k, v, seq_lens, window=64)
        flash_prefill(qf, kf, vf, seq_lens)
        for c in (bf16, int8):
            decode_attention(c[0], c[1], c[2], 1, c[5], c[3], c[4], window=200)
            decode_attention(c[0], c[1], c[2], 1, c[5], c[3], c[4],
                             append=append)
        for x in xs + [xf]:
            w8a16_matmul(x, pt.q, pt.scale)
        for x in xs:
            w8a8_matmul(x, qt.q, qt.scale)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  sync debug mode \"error\": flash (tensor-core and FMA), decode "
        "(bf16, int8; with and without the fused row write), W8A16 (GEMV, "
        "float32 GEMV, tensor-core) and W8A8 (split over K and whole) "
        "launched without a host synchronization")


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
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                path="none: the serving path writes the decode row in the "
                     "decode-attention launch (kv_append_fused); launches "
                     "are phase 3's")


def w8a16_work(m: int, k: int, n: int, x_bytes: int) -> tuple[float, float]:
    """(bytes, operations) of y = x @ dequant(q): the int8 weight, x, its
    scales and y once each, and 2 m k n operations."""
    return m * k * x_bytes + k * n + n * 4 + m * n * x_bytes, 2.0 * m * k * n


def check_w8a16() -> list[dict]:
    """llama3-8b projection shapes and mixtral-8x7b's LM head (phase 13)
    at decode row counts (1, 2, 8 and 16
    bf16 rows: the GEMV regime, swap-AB on the tensor cores) and prefill
    row counts (the 128 and 512 buckets, the 2048-row token budget: the
    tensor-core regime), and float32 rows at every leaf at 1, 8, 16, 32,
    128 and 2048 (the float32 GEMV, FMAs, 16-row tiles past 16); one row
    of the `kernels` line for each regime, at the widest leaf (`wg`, 8
    rows for both GEMVs, 2048 for the tensor-core kernel). Tolerance: one
    bf16 step at the largest output, 2**-7 * max|y|, for bf16 rows (the
    kernel and the plain version sum in float32 in different orders, then
    round); 1e-5 * max|y| for float32 rows (float32 products, sums in
    another order). The library yardstick computes the same function:
    torch.matmul on bf16 rows and the dequantized bf16 weight, or on
    float32 rows and the dequantized float32 weight (TF32 off). GEMV
    times (bf16 up to 16 rows, every float32 row count) are cold, kernel
    and library alike: L2 flushed before each call (`cold_ms`)."""
    from symmetry_tpu_torch.ops.qmm import (gemv_capacity, gemv_plan,
                                            w8a16_matmul, w8a16_reference,
                                            w8a16_regime)
    from symmetry_tpu_torch.ops.quant import pack_quantized, quantize

    shapes = {"wq": (4096, 4096), "wk": (4096, 1024), "wg": (4096, 14336),
              "wd": (14336, 4096), "lm_head": (4096, 128256),
              # phase 13's one new shape: mixtral-8x7b's int8 LM head (its
              # attention projections are llama3-8b's)
              "mixtral lm_head": (4096, 32000)}
    # the rows reported, all on `wg`
    reported = {(8, torch.bfloat16): "gemv", (2048, torch.bfloat16): "tc",
                (8, torch.float32): "gemv_f32"}
    caps = {dt: gemv_capacity(torch.device("cuda"), dt)
            for dt in (torch.bfloat16, torch.float32)}
    log(f"  GEMV clusters the card holds at once, by cluster size: bf16 "
        f"{caps[torch.bfloat16]}, float32 {caps[torch.float32]}")
    g = torch.Generator(device="cuda").manual_seed(40)
    worst = {"gemv": 0.0, "tc": 0.0, "gemv_f32": 0.0}
    rows = {}
    for name, (K, N) in shapes.items():
        w = torch.randn((K, N), generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(K ** -0.5)
        qt = quantize(w)
        pt = pack_quantized(qt)
        w_lib = {torch.bfloat16: (qt.q.float() * qt.scale).to(torch.bfloat16),
                 torch.float32: qt.q.float() * qt.scale}
        del w, qt
        cases = [(M, torch.bfloat16) for M in (1, 2, 8, 16, 128, 512, 2048)]
        cases += [(M, torch.float32) for M in (1, 8, 16, 32, 128, 2048)]
        for M, dtype in cases:
            regime = w8a16_regime(M, dtype)
            x = torch.randn((M, K), generator=g, device="cuda", dtype=dtype)
            got = w8a16_matmul(x, pt.q, pt.scale)
            torch.cuda.synchronize()
            want = w8a16_reference(x, pt.q, pt.scale)
            err = float((got.float() - want.float()).abs().max())
            tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(
                want.float().abs().max())
            if not torch.isfinite(got).all() or err > tol:
                raise AssertionError(f"w8a16 {name} M={M} {dtype}: error "
                                     f"{err} > {tol}")
            worst[regime] = max(worst[regime], err)
            # few calls where one takes milliseconds (float32 prefill rows)
            iters = 20 if M * N <= 2048 * 14336 // 8 else 3
            if regime == "tc":
                timer, how = device_ms, "warm"
            else:
                timer, how = cold_ms, "cold"
            ms = timer(lambda: w8a16_matmul(x, pt.q, pt.scale), iters,
                       name="w8a16_", per_call=1)
            call_ms = cuda_ms(lambda: w8a16_matmul(x, pt.q, pt.scale), iters)
            plain_ms = device_ms(
                lambda: w8a16_reference(x, pt.q, pt.scale), 3 if M < 2048
                else 1)
            wl = w_lib[dtype]
            library_ms = timer(lambda: torch.matmul(x, wl), iters)
            nbytes, flops = w8a16_work(M, K, N, x.element_size())
            bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS
                                       if dtype == torch.bfloat16
                                       else PEAK_F32_FLOPS)
            plan = (f", {gemv_plan(M, K, N, caps[dtype])}" if regime != "tc"
                    else "")
            log(f"  w8a16 {name} [{K}, {N}] M={M} {str(dtype)[6:]} "
                f"({regime}{plan}): max_abs_err={err:.3e} (tol {tol:.3e}); "
                f"device ms ({how}): kernel {ms:.4f} ({call_ms:.4f} per "
                f"eager call), plain {plain_ms:.4f}, torch.matmul "
                f"{str(dtype)[6:]} {library_ms:.4f}, bound {bound_ms:.4f} "
                f"({bound_by}); {ms / bound_ms:.2f}x bound, "
                f"{ms / library_ms:.2f}x torch.matmul")
            if name == "wg" and reported.get((M, dtype)) == regime:
                rows[regime] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
            del x, got, want
        del pt, w_lib
        torch.cuda.empty_cache()
    # Down projections longer than any preset's (Qwen2/2.5-72B, Llama-3.1-
    # 405B): x streams through the GEMV's ring, so any K takes the kernel.
    for K, N in ((29568, 8192), (53248, 16384)):
        pt = pack_quantized(quantize(torch.randn(
            (K, N), generator=g, device="cuda",
            dtype=torch.bfloat16).mul_(K ** -0.5)))
        for M in (1, 16):
            x = torch.randn((M, K), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            got = w8a16_matmul(x, pt.q, pt.scale)
            want = w8a16_reference(x, pt.q, pt.scale)
            err = float((got.float() - want.float()).abs().max())
            tol = 2.0 ** -7 * float(want.float().abs().max())
            if not torch.isfinite(got).all() or err > tol:
                raise AssertionError(f"w8a16 [{K}, {N}] M={M}: error {err} "
                                     f"> {tol}")
            worst["gemv"] = max(worst["gemv"], err)
            ms = cold_ms(lambda: w8a16_matmul(x, pt.q, pt.scale), 10,
                         name="w8a16_", per_call=1)
            bound_ms, _ = bound(*w8a16_work(M, K, N, 2))
            log(f"  w8a16 long K [{K}, {N}] M={M} (gemv, "
                f"{gemv_plan(M, K, N, caps[torch.bfloat16])}): max_abs_err="
                f"{err:.3e} (tol {tol:.3e}); device ms (cold): kernel "
                f"{ms:.4f}, bound {bound_ms:.4f}; {ms / bound_ms:.2f}x bound")
        del pt, x, got, want
        torch.cuda.empty_cache()
    # One rank's blocks of llama3-8b's leaves at TP=2 (phase 14): column-
    # parallel N-slices, and the row-parallel K-slices of wo and wd in the
    # mode only a mesh uses, apply_scale=False into float32 (the partials
    # the all-reduce sums before the scale), at GEMV and tensor-core rows.
    tp_shapes = {"wq": (4096, 2048, True), "wk": (4096, 512, True),
                 "wg": (4096, 7168, True), "lm_head": (4096, 64128, True),
                 "wo": (2048, 4096, False), "wd": (7168, 4096, False)}
    for name, (K, N, scaled) in tp_shapes.items():
        pt = pack_quantized(quantize(torch.randn(
            (K, N), generator=g, device="cuda",
            dtype=torch.bfloat16).mul_(K ** -0.5)))
        out_dtype = None if scaled else torch.float32
        for M, dtype in ((1, torch.bfloat16), (8, torch.bfloat16),
                         (16, torch.bfloat16), (512, torch.bfloat16),
                         (8, torch.float32)):
            regime = w8a16_regime(M, dtype)
            x = torch.randn((M, K), generator=g, device="cuda", dtype=dtype)
            got = w8a16_matmul(x, pt.q, pt.scale, out_dtype=out_dtype,
                               apply_scale=scaled)
            torch.cuda.synchronize()
            want = w8a16_reference(x, pt.q, pt.scale, out_dtype=out_dtype,
                                   apply_scale=scaled)
            err = float((got.float() - want.float()).abs().max())
            # float32 output: the sums in another order (1e-5); bf16: one
            # step at the largest output
            tol = (2.0 ** -7 if scaled and dtype == torch.bfloat16
                   else 1e-5) * float(want.float().abs().max())
            if (got.dtype != (out_dtype or dtype)
                    or not torch.isfinite(got).all() or err > tol):
                raise AssertionError(
                    f"w8a16 TP=2 {name} [{K}, {N}] M={M} {dtype} "
                    f"apply_scale={scaled}: error {err} > {tol}")
            if scaled:
                worst[regime] = max(worst[regime], err)
            log(f"  w8a16 TP=2 {name} [{K}, {N}] M={M} {str(dtype)[6:]} "
                f"({regime}, {'scaled' if scaled else 'unscaled, float32 out'}"
                f"): max_abs_err={err:.3e} (tol {tol:.3e})")
            del x, got, want
        del pt
        torch.cuda.empty_cache()
    log(f"  w8a16 worst error by regime: {worst}")
    return [dict(name=f"w8a16_matmul[{regime}]", route="cuda",
                 source="symmetry_tpu_torch/csrc/w8a16.cu",
                 replaces="symmetry_tpu/ops/qmm.py:251",
                 max_abs_err=worst[regime], **rows[regime])
            for regime in ("gemv", "gemv_f32", "tc")]


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


def check_moe_gemv() -> dict:
    """The grouped int8 expert GEMV at mixtral-8x7b's decode shapes: `wg`
    (and `wu`), [4096, 14336] slabs, x of 1, 8 and 16 rows shared by the
    eight experts; `wd`, [14336, 4096], each expert's own rows; bf16 rows
    scaled to bf16 and raw float32 sums (the `model` axis's), float32 rows
    scaled and raw; against moe_gemv_reference (each expert's mixed dot) on
    the same card tensors. Tolerance: 2**-7 max|y| on a bf16 output (one
    rounding; float32 sums in another order), 3e-5 max|y| on a float32
    output (sums of up to 14,336 float32 terms in another order). Timed cold (L2 flushed
    before each call; a stack is 470 MB, far past L2 anyway) at 8 bf16
    rows, the `kernels` line's row at `wg`; the library yardstick is
    torch.matmul of the bf16 rows and the stack dequantized to bf16."""
    from symmetry_tpu_torch.ops.moe_gemv import (
        moe_gemv,
        moe_gemv_capacity,
        moe_gemv_plan,
        moe_gemv_reference,
        row_tile,
        tile_cols,
    )
    from symmetry_tpu_torch.ops.quant import quantize

    X = 8
    shapes = {"wg": (4096, 14336, True), "wd": (14336, 4096, False)}
    g = torch.Generator(device="cuda").manual_seed(60)
    moe_gemv.launches = 0
    worst, row = 0.0, None
    for name, (K, N, shared) in shapes.items():
        w = quantize(torch.randn((X, K, N), generator=g, device="cuda",
                                 dtype=torch.bfloat16).mul_(K ** -0.5))
        for M, dtype, scaled in ((1, torch.bfloat16, True),
                                 (8, torch.bfloat16, True),
                                 (16, torch.bfloat16, True),
                                 (8, torch.bfloat16, False),
                                 (8, torch.float32, True),
                                 (8, torch.float32, False)):
            x = torch.randn((1 if shared else X, M, K), generator=g,
                            device="cuda", dtype=dtype)
            kw = {} if scaled else {"out_dtype": torch.float32,
                                    "apply_scale": False}
            got = moe_gemv(x, w.q, w.scale, **kw)
            torch.cuda.synchronize()
            want = moe_gemv_reference(x, w.q, w.scale, **kw)
            err = float((got.float() - want.float()).abs().max())
            tol = (2.0 ** -7 if got.dtype == torch.bfloat16 else 3e-5) * (
                float(want.float().abs().max()))
            if (got.dtype != want.dtype or not torch.isfinite(got).all()
                    or err > tol):
                raise AssertionError(f"moe_gemv {name} M={M} {dtype} "
                                     f"scaled={scaled}: error {err} > {tol}")
            worst = max(worst, err)
            rows = row_tile(M, dtype)
            plan = moe_gemv_plan(X, M, K, N, rows, tile_cols(dtype),
                                 moe_gemv_capacity(x.device, dtype, rows))
            ms = cold_ms(lambda: moe_gemv(x, w.q, w.scale, **kw), 20,
                         name="moe_gemv", per_call=1)
            nbytes = (x.numel() * x.element_size() + X * K * N + X * N * 4
                      + got.numel() * got.element_size())
            bound_ms, bound_by = bound(nbytes, 2.0 * X * M * K * N,
                                       PEAK_BF16_FLOPS if dtype ==
                                       torch.bfloat16 else PEAK_F32_FLOPS)
            extra = ""
            if (name, M, dtype, scaled) == ("wg", 8, torch.bfloat16, True):
                plain_ms = device_ms(
                    lambda: moe_gemv_reference(x, w.q, w.scale), 3)
                wl = (w.q.float() * w.scale[:, None, :]).to(torch.bfloat16)
                library_ms = cold_ms(lambda: torch.matmul(x, wl), 20)
                del wl
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms)
                extra = (f", plain {plain_ms:.4f}, torch.matmul bf16 "
                         f"{library_ms:.4f}")
            log(f"  moe_gemv {name} {X} x [{K}, {N}] M={M} "
                f"{str(dtype)[6:]} {'scaled' if scaled else 'raw float32'} "
                f"({plan}): max_abs_err={err:.3e} (tol {tol:.3e}); device "
                f"ms (cold): kernel {ms:.4f}{extra}, bound {bound_ms:.4f} "
                f"({bound_by}); {ms / bound_ms:.2f}x bound")
            del x, got, want
        del w
        torch.cuda.empty_cache()
    return dict(name="moe_gemv", route="cuda",
                source="symmetry_tpu_torch/csrc/moe_gemv.cu",
                replaces="none: the JAX mixture's int8 expert products are "
                         "XLA's mixed dot (symmetry_tpu/models/moe.py)",
                max_abs_err=worst, **row)


# ---------------------------------------------------------------------------
# Phases 4-5: the engine behind the Scheduler


def id_tokenizer(vocab_size: int):
    """A byte tokenizer whose stream carries exact ids: one character per
    token id."""
    from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        def decode(self, ids):
            return "".join(chr(ID_BASE + i) for i in ids
                           if i not in (self.BOS, self.EOS))

    return IdTokenizer(vocab_size)


def serve(preset_name: str, *, device: str, dtype: torch.dtype,
          prompt_lens: list[int], max_new: int, max_slots: int,
          max_seq_len: int, buckets: tuple[int, ...], decode_block: int,
          params=None, seed: int = 0, on_ready=None, int8: bool = False,
          cfg=None, sampling: dict | None = None) -> dict:
    """Build the engine, warm it, and serve greedy requests through the
    Scheduler. Returns per-request token ids and finish reasons, timings,
    and the scheduler's metrics. `on_ready` runs after warmup, just before
    the requests are submitted. int8=True serves int8 weights (drawn with
    init_params(quantize=True) unless given) packed for the W8A16 kernel
    (fused_dequant) and an int8 KV cache (kv_quant). `cfg` replaces the
    preset's config; `sampling` (SamplingParams fields) replaces greedy for
    every request."""
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.models.llama import init_params, preset

    cfg = cfg or preset(preset_name)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, gen, dtype, quantize=int8)
    engine = InferenceEngine(cfg, params, id_tokenizer(cfg.vocab_size),
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
    return {**schedule(engine, prompts, max_new, sampling),
            "prompts": prompts}


def schedule(engine, prompts: list[list[int]], max_new: int,
             sampling: dict | None = None,
             speculative: bool | None = None,
             pipeline_depth: int = 2, admit_seconds: float = 0.65) -> dict:
    """Serve `prompts` through a Scheduler on `engine`, all submitted at
    once; `speculative` is every request's per-request switch (False opts
    out of speculation); `admit_seconds` is the Scheduler's admission
    time per decode block (infinite: its dispatches depend on the
    requests only, not on the host's speed)."""
    from symmetry_tpu_torch.engine.engine import SamplingParams
    from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler

    sched = Scheduler(engine, pipeline_depth=pipeline_depth,
                      admit_seconds_per_block=admit_seconds)
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
        sched.submit(GenRequest(prompt_ids=ids,
                                sampling=SamplingParams(**(sampling or {})),
                                max_new_tokens=max_new, emit=emit,
                                id=f"r{i}", speculative=speculative))
    sched.start()
    try:
        for i, ev in done.items():
            if not ev.wait(600):
                raise AssertionError(f"request {i} did not complete")
    finally:
        sched.stop()
    t_end = time.monotonic()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    out = []
    for i in range(len(prompts)):
        last = events[i][-1]
        text = "".join(ev.text for ev in events[i])
        out.append(dict(ids=[ord(c) - ID_BASE for c in text], text=text,
                        reason=last.finish_reason,
                        generated=last.tokens_generated, ttft_s=last.ttft_s))
    decoded = sum(r["generated"] - 1 for r in out)
    return dict(requests=out, metrics=dict(sched.metrics),
                stats=sched.stats(), wall_s=t_end - t0,
                decode_tok_s=decoded / (t_end - min(first_at.values())),
                config=engine.config, engine=engine)


def profile_dispatch(label: str, fn) -> list[tuple[float, int, str]]:
    """Where one dispatch's time goes: its host wall (synchronized, taken
    without the profiler), the device busy time summed over the CUDA
    kernels torch.profiler records for a second run, the device idle share
    that leaves, and the heaviest kernels. Returns (device ms, launches,
    kernel name) for every kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # The host's operators are recorded too: without them a session on an
    # H100 dropped 784 of a decode block's kernel records. The device's
    # records are read raw; key_averages, which builds every host
    # operator's event first, took ~8 s of a 21,000-kernel block's ~14 s.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict[str, list] = {}
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for ev in results.events():
            if ev.device_type() == DeviceType.CUDA:
                g = groups.setdefault(ev.name(), [0.0, 0])
                g[0] += (ev.end_ns() - ev.start_ns()) / 1e3
                g[1] += 1
    else:
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) == DeviceType.CUDA:
                groups[ev.key] = [getattr(
                    ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0)), ev.count]
    rows = [(us / 1e3, count, key) for key, (us, count) in groups.items()
            if us > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log(f"  profile {label}: wall {wall_ms:.3f} ms; the profiler saw no "
            f"device kernels")
        return rows
    log(f"  profile {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms over {sum(r[1] for r in rows)} kernels, idle "
        f"share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for ms, count, key in sorted(rows, reverse=True)[:6]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    return rows


def check_tiny() -> int:
    """`tiny` in float32, card against CPU: greedy dense, greedy with int8
    weights + int8 KV, greedy at head dim 96 (no built size: flash and
    decode run it at 128), and seeded sampling (the threefry chains give
    the same tokens on both). Returns the float32 GEMV's launches in these
    runs (the int8 run's packed leaves: float32 serving's W8A16 path)."""
    import dataclasses

    from symmetry_tpu_torch.models.llama import init_params, preset
    from symmetry_tpu_torch.ops.qmm import w8a16_matmul

    w8a16_matmul.launches_gemv_f32 = 0

    kw = dict(dtype=torch.float32, prompt_lens=[5, 14, 27], max_new=12,
              max_slots=2, max_seq_len=64, buckets=(16, 32), decode_block=4)
    tiny = preset("tiny")
    seeded = dict(temperature=0.8, top_k=40, seed=11)
    for label, cfg, int8, sampling in (
            ("greedy", tiny, False, None),
            ("greedy, int8 weights + int8 KV", tiny, True, None),
            ("greedy, head_dim 96", dataclasses.replace(tiny, head_dim=96),
             False, None),
            (f"seeded {seeded}", tiny, False, seeded)):
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, quantize=int8)
        card = serve("tiny", device="cuda", params=params, int8=int8,
                     cfg=cfg, sampling=sampling, **kw)["requests"]
        cpu = serve("tiny", device="cpu", params=params, int8=int8, cfg=cfg,
                    sampling=sampling, **kw)["requests"]
        for r_card, r_cpu in zip(card, cpu):
            if (r_card["ids"], r_card["reason"]) != (r_cpu["ids"],
                                                     r_cpu["reason"]):
                raise AssertionError(f"tiny {label}: card {r_card} != "
                                     f"cpu {r_cpu}")
        log(f"  tiny f32 {label}: {len(card)} requests, token ids identical "
            f"card vs CPU: {[r['ids'][:6] for r in card]}...")
    launches = w8a16_matmul.launches_gemv_f32
    log(f"  float32 GEMV launches in these runs: {launches}")
    if launches <= 0:
        raise AssertionError("the int8 tiny run never launched the float32 "
                             "GEMV")
    return launches


def reset_launches() -> None:
    """Every kernel wrapper's launch counts (per variant and regime too) to
    0, and the card's peak memory statistics."""
    from symmetry_tpu_torch.ops.decode_attention import decode_attention
    from symmetry_tpu_torch.ops.flash import flash_prefill
    from symmetry_tpu_torch.ops.kv_append import kv_append
    from symmetry_tpu_torch.ops.moe_gemv import moe_gemv
    from symmetry_tpu_torch.ops.qmm import w8a16_matmul

    for fn in (flash_prefill, decode_attention, kv_append, w8a16_matmul,
               moe_gemv):
        fn.launches = 0
    decode_attention.launches_append = 0
    w8a16_matmul.launches_gemv = w8a16_matmul.launches_tc = 0
    w8a16_matmul.launches_gemv_f32 = 0
    for variant in flash_prefill.variant_launches:
        flash_prefill.variant_launches[variant] = 0
    torch.cuda.reset_peak_memory_stats()


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
    reset = reset_launches

    label = "int8 (W8A16 weights, int8 KV)" if int8 else "bf16"
    max_new = 64
    res = serve("llama3-8b", device="cuda", dtype=torch.bfloat16,
                prompt_lens=PHASE5_PROMPTS,
                max_new=max_new, max_slots=8, max_seq_len=4096,
                buckets=(128, 512, 2048), decode_block=8, on_ready=reset,
                int8=int8)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    launches["decode_attention_append"] = decode_attention.launches_append
    variants = dict(flash_prefill.variant_launches)
    regimes = {"gemv": w8a16_matmul.launches_gemv,
               "gemv_f32": w8a16_matmul.launches_gemv_f32,
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
    # Every decode launch writes the step's row itself: no standalone
    # kv_append on the path, either cache dtype.
    want = {"flash_prefill": L * dispatches, "decode_attention": L * steps,
            "kv_append": 0, "decode_attention_append": L * steps,
            # seven projections per layer and the LM head, per forward
            "w8a16_matmul": (7 * L + 1) * (steps + dispatches) if int8 else 0}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    # Prefill rows take the tensor-core kernel; decode steps (8 rows), and
    # a prefill's LM head on its last rows, the GEMV kernel; no float32.
    if sum(regimes.values()) != launches["w8a16_matmul"] or regimes[
            "gemv_f32"] or (int8 and min(regimes["gemv"], regimes["tc"]) <= 0):
        raise AssertionError(f"W8A16 launches by regime {regimes}")
    # bf16 at head_dim 128: every flash launch takes the tensor-core kernel.
    if variants != {"tensor_core": L * dispatches, "fma": 0}:
        raise AssertionError(f"flash variants {variants}: not every launch "
                             f"went to the tensor-core kernel")
    digest = hashlib.sha256(json.dumps(
        [r["ids"] for r in res["requests"]]).encode()).hexdigest()[:16]
    log(f"  {label} greedy streams sha256 {digest} (the same on every run "
        f"of this phase: fixed weights, prompts and reduction orders)")
    engine = res["engine"]
    # The decode block with the row written inside the decode launch, and
    # (same call, same engine) with the pair it replaces: the row written
    # first as before -- the standalone kv_append kernel (int8) or
    # arange/clamp/long/index assignment (bf16) -- then decode attention.
    blocks = {}
    for tag in ("fused", "unfused", "fused", "unfused"):
        with unfused_decode_write(tag == "unfused"):
            blocks.setdefault(tag, []).append(profile_dispatch(
                f"{label} decode block (8 steps x 8 slots), row write "
                f"{tag}", engine.decode_steps))
    block = blocks["fused"][0]
    per_block = {tag: [sum(r[1] for r in b) for b in bs]
                 for tag, bs in blocks.items()}
    busy = {tag: [round(sum(r[0] for r in b), 3) for b in bs]
            for tag, bs in blocks.items()}
    # Kernels the fused block no longer launches, kind by kind (a block's
    # total moves by a kernel or two from run to run on its own); the
    # decode kernel with and without the write is one kind.
    counts = {}
    for tag, bs in blocks.items():
        for b in bs:
            kinds: dict[str, int] = {}
            for _, n, key in b:
                kind = re.sub(r", (true|false)>", ">", key)
                kinds[kind] = kinds.get(kind, 0) + n
            counts.setdefault(tag, []).append(kinds)
    pairs = list(zip(counts["fused"], counts["unfused"]))
    gone = {key: min(u.get(key, 0) - f.get(key, 0) for f, u in pairs)
            for key in pairs[0][1]}
    gone = {key: n for key, n in gone.items() if n > 0}
    shed = sum(gone.values())
    log(f"  {label} kernels per decode block: fused {per_block['fused']}, "
        f"unfused {per_block['unfused']}; kernels the fused block no longer "
        f"launches {shed} ({L} layers x {engine.decode_block} steps = "
        f"{L * engine.decode_block}): "
        f"{[(key[:60], n) for key, n in gone.items()]}; device busy ms fused "
        f"{busy['fused']}, unfused {busy['unfused']}")
    if int8 and shed < L * engine.decode_block:
        raise AssertionError(f"int8 decode block sheds {shed} kernels, "
                             f"fewer than one a layer and step")
    gemv = [r for r in block if "w8a16_gemv" in r[2]]
    if int8:
        log(f"  {label} decode block: the W8A16 GEMV kernel "
            f"{sum(r[0] for r in gemv):.3f} device ms over "
            f"{sum(r[1] for r in gemv)} launches "
            f"({sum(r[1] for r in gemv) / engine.decode_block:.0f} a step), "
            f"{sum(r[0] for r in gemv) / engine.decode_block:.4f} ms a step")
        if not gemv:
            raise AssertionError("decode block: no GEMV kernel")
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


class unfused_decode_write:
    """Within the block (when `on`), the model's decode step writes its
    K/V row as the serving path did before the write moved into the decode
    launch: kv_append for an int8 cache, arange, clamp, long and index
    assignment otherwise, then decode attention without append. A
    measurement harness for one comparison in one call; the port has no
    such switch."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        from symmetry_tpu_torch.models import llama
        from symmetry_tpu_torch.ops.decode_attention import decode_attention
        from symmetry_tpu_torch.ops.kv_append import kv_append

        self.saved = llama.decode_attention
        if not self.on:
            return self

        def pair(q, k_cache, v_cache, layer, kv_length, k_scale=None,
                 v_scale=None, *, window=None, append=None):
            k_new, v_new, positions = append
            if k_cache.dtype == torch.int8:
                kv_append(k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                          layer, positions)
            else:
                T = k_cache.shape[2]
                b_idx = torch.arange(k_cache.shape[1],
                                     device=q.device)[:, None]
                pos_w = torch.clamp(positions[:, None], max=T - 1).long()
                k_cache[layer][b_idx, pos_w] = k_new[:, None].to(
                    k_cache.dtype)
                v_cache[layer][b_idx, pos_w] = v_new[:, None].to(
                    v_cache.dtype)
            return decode_attention(q, k_cache, v_cache, layer, kv_length,
                                    k_scale, v_scale, window=window)

        llama.decode_attention = pair
        return self

    def __exit__(self, *exc):
        from symmetry_tpu_torch.models import llama

        llama.decode_attention = self.saved
        return False


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
    texted = [e["_recv"] for e in evs if e["text"]]
    return dict(text="".join(e["text"] for e in evs),
                tokens=evs[-1]["tokens"], reason=evs[-1]["finish_reason"],
                reused=evs[0].get("reused"), ttft_s=ttft[0] if ttft else None,
                first_at=evs[0]["_recv"], done_at=evs[-1]["_recv"],
                first_text_at=texted[0] if texted else None)


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
    # All four hosts (dense and int8, card and CPU) start together: each
    # spends most of its start importing and warming up on its own.
    hosts = {}
    for int8 in (False, True):
        tpu = dict(base, **({"quantization": "int8",
                             "kv_quantization": "int8",
                             "fused_dequant": True} if int8 else {}))
        tag = "int8" if int8 else "f32"
        hosts[tag] = [HostProc(f"tiny_{tag}_cuda", tpu),
                      HostProc(f"tiny_{tag}_cpu", tpu, device="cpu")]
    try:
        for tag, pair in hosts.items():
            for h in pair:
                h.wait_for(lambda f: f.get("op") == "ready")
            for i, content in enumerate(conversation):
                for h in pair:
                    submit(h, f"t{i}", content, 12)
                for h in pair:
                    h.wait_done([f"t{i}"])
            card, cpu = ([stream(h, f"t{i}") for i in range(len(conversation))]
                         for h in pair)
            stats = pair[0].stats()
            for h in pair:
                if h.shutdown() != 0:
                    raise AssertionError(f"host {h.label} exit code != 0")
            for a, b in zip(card, cpu):
                if (a["text"], a["tokens"], a["reason"], a["reused"]) != (
                        b["text"], b["tokens"], b["reason"], b["reused"]):
                    raise AssertionError(f"host tiny {tag}: card {a} != cpu "
                                         f"{b}")
            if not (card[2]["reused"] or 0) > 0:
                raise AssertionError(f"host tiny {tag}: no prefix hit: {card}")
            k = stats["kernels"]
            if min(k["flash_prefill"], k["decode_attention"],
                   k["decode_attention_append"]) <= 0 or k["kv_append"] or (
                    tag == "int8" and k["w8a16_matmul"] <= 0):
                raise AssertionError(f"host tiny {tag}: kernels {k}")
            log(f"  host tiny {tag}: {len(card)} requests, streamed text "
                f"identical card vs CPU (reused "
                f"{[r['reused'] for r in card]}, chunk dispatches "
                f"{stats['chunk_dispatches']}, card launches {k})")
    finally:
        for pair in hosts.values():
            for h in pair:
                h.kill()


def chat_content(rng: np.random.Generator, n: int) -> str:
    """n characters of lowercase words: n tokens under the byte tokenizer."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz    "))
    return "".join(rng.choice(letters, n))


HOST_FULL_TPU = {"model_preset": "llama3-8b", "prefix_cache_mb": 1024}


def check_host_full(smi: str, host: HostProc) -> dict:
    """llama3-8b in bf16 at full depth behind the port's host (`host`, on
    HOST_FULL_TPU, started by main beside phase 7), from the provider's
    default `tpu:` section plus model_preset and a 1024 MiB prefix cache.
    Wave 1: 8 greedy chats, two <= 256 tokens (flash) and six chunked; wave
    2: 4 chats sharing wave 1's longest prompt's first 1536 tokens, two
    with short tails (the one-dispatch hit path) and two with ~300-token
    tails (the seeded chunked path)."""
    from symmetry_tpu_torch.engine.tokenizer import get_tokenizer
    from symmetry_tpu_torch.provider.config import TpuConfig

    tpu = HOST_FULL_TPU
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
    if min(launches["flash_prefill"], launches["decode_attention"]) <= 0 or (
            launches["decode_attention_append"]
            != launches["decode_attention"]) or launches["kv_append"]:
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


# ---------------------------------------------------------------------------
# Phase 9: speculative decoding at full width and depth

SPEC_K = 8
CYCLE_TOKEN = 120
# The verify forward ([B, 1 + k] through the continuation path) and a
# decode step compute the same logits in another order, and the LM head
# rounds them to bf16 (steps of 1/32 at magnitudes 4-8): on an H100 they
# differ by a few bf16 steps (about 0.12, bf16 and int8 alike; the phase
# prints its "max |diff|"). Lanes whose context is the plain run's must
# agree within this; a slot may then part from the plain run only where
# the plain run's two best logits are within twice it (exact ties are
# common).
LOGIT_TOL = 0.25


class recorded_logits:
    """Within the block, the engine's sampling and verify ops also keep
    the float32 logits they were given (a harness for comparing the
    verify forward with the plain run; the port has no such switch)."""

    def __enter__(self):
        from symmetry_tpu_torch.engine import engine as eng

        self.saved = (eng.sample_tokens, eng.verify_tokens)
        self.decode: list[torch.Tensor] = []
        self.verify: list[torch.Tensor] = []

        def sample(logits, *a, **kw):
            self.decode.append(logits.float())
            return self.saved[0](logits, *a, **kw)

        def verify(logits, *a, **kw):
            self.verify.append(logits.float())
            return self.saved[1](logits, *a, **kw)

        eng.sample_tokens, eng.verify_tokens = sample, verify
        return self

    def __exit__(self, *exc):
        from symmetry_tpu_torch.engine import engine as eng

        eng.sample_tokens, eng.verify_tokens = self.saved
        return False


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def cycling(engine, token: int) -> dict:
    """tests/test_spec.py cycling_params made dominant at llama3-8b width:
    every embedding's coordinate 0 is set to 256, which every position's
    final hidden state then carries (about 45 of its ~64 norm), and the LM
    head's column `token` to 10 at coordinate 0 and 0 elsewhere (an int8
    head: payload 127 there, scale 10 / 127), so `token` leads every
    other logit by hundreds at every position: greedy output cycles on it
    and the drafter matches. Returns the leaves it replaced."""
    from symmetry_tpu_torch.ops.quant import (PackedQuantizedTensor,
                                              QuantizedTensor,
                                              pack_quantized,
                                              unpack_quantized)

    saved = {k: engine.params[k] for k in ("embed", "lm_head")}
    embed = saved["embed"].clone()
    embed[:, 0] = 256.0
    head = saved["lm_head"]
    if isinstance(head, PackedQuantizedTensor):
        flat = unpack_quantized(head)
        q, scale = flat.q.clone(), flat.scale.clone()
        q[:, token] = 0
        q[0, token] = 127
        scale[token] = 10.0 / 127
        head = pack_quantized(QuantizedTensor(q, scale))
    else:
        head = head.clone()
        head[:, token] = 0.0
        head[0, token] = 10.0
    engine.params.update(embed=embed, lm_head=head)
    return saved


def check_oracle(engine, assign, label: str) -> tuple[list, np.ndarray]:
    """(a): a plain greedy run (first tokens, two decode blocks), then
    its continuation as every slot's draft, whole and corrupted at j =
    slot mod k, each verify after re-admitting the same prompts. Returns
    the oracle drafts."""
    B, K = engine.max_slots, engine.spec.k_draft
    vocab = engine.config.vocab_size
    first = engine.prefill_and_insert_many(assign)
    with recorded_logits() as rec:
        plain = np.concatenate([engine.decode_steps() for _ in range(2)])
    chain = [[first[b]] + plain[:, b].tolist() for b in range(B)]
    # step i of the plain run scored chain[b][i + 1]
    plain_logits = torch.stack(rec.decode, 1)       # [B, steps, V]
    gaps = top2_gap(plain_logits).cpu().numpy()
    oracle = np.array([c[1:K + 1] for c in chain], np.int64)
    corrupt = oracle.copy()
    for b in range(B):
        corrupt[b, b % K] = (corrupt[b, b % K] + 1) % vocab
    for name, draft, want in (
            ("oracle", oracle, [K + 1] * B),
            ("corrupted at j = slot mod k", corrupt,
             [b % K + 1 for b in range(B)])):
        if engine.prefill_and_insert_many(assign) != first:
            raise AssertionError("re-admission changed the first tokens")
        with recorded_logits() as rec:
            toks, n_emit = engine.verify_step(draft, np.full(B, K, np.int32))
        vlog = rec.verify[0]                         # [B, 1 + K, V]
        parted, worst = [], 0.0
        for b in range(B):
            got = toks[:n_emit[b], b].tolist()
            ref = chain[b][1:want[b] + 1]
            if engine.slot_length(b) != len(assign[b][1]) + int(n_emit[b]):
                raise AssertionError(f"slot {b}: length "
                                     f"{engine.slot_length(b)} after "
                                     f"emitting {n_emit[b]}")
            part = next((i for i, t in enumerate(got)
                         if i >= len(ref) or t != ref[i]), None)
            # lanes whose context (prompt + drafts before them) is the
            # plain run's: up to the corruption and up to a parting
            last = min(want[b] - 1, part if part is not None else K)
            worst = max(worst, float((vlog[b, :last + 1]
                                      - plain_logits[b, :last + 1])
                                     .abs().max()))
            if part is None and len(got) == want[b]:
                continue
            if part is None or gaps[b, part] > 2 * LOGIT_TOL:
                raise AssertionError(
                    f"{label} {name}: slot {b} emitted {got}, the plain "
                    f"run {ref}, away from a near tie (plain top-2 gaps "
                    f"{gaps[b, :want[b]].tolist()})")
            parted.append((b, int(n_emit[b]), part, float(gaps[b, part])))
        log(f"  {label} verify, {name}: n_emit {n_emit.tolist()} (want "
            f"{want}); verify vs plain-run logits on lanes of the plain "
            f"context max |diff| {worst:.4f}; slots parting from the plain "
            f"run at a near tie (slot, n_emit, position, plain top-2 gap) "
            f"{parted}, all other slots equal to it")
        if worst > LOGIT_TOL:
            raise AssertionError(f"{label} {name}: verify logits differ "
                                 f"from the plain run's by {worst}")
    return chain, oracle


def check_speculative(smi: str, *, int8: bool) -> None:
    """llama3-8b at full depth, 8 slots, k_draft 8, with the verify step:
    (a) oracle drafts -- a plain greedy run's continuation -- are accepted
    whole and a draft corrupted at j stops the slot at j + 1 tokens, the
    tokens those of the plain run (a slot may part from it only at a near
    tie, LOGIT_TOL); (b) through the Scheduler with cycling weights,
    greedy output with speculation on equals every request opted out,
    with verify blocks; (c) a seeded sampled stream runs to its budget
    with speculation on."""
    from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                  SamplingParams)
    from symmetry_tpu_torch.engine.spec import SpecConfig
    from symmetry_tpu_torch.models.llama import init_params, preset
    from symmetry_tpu_torch.ops.qmm import w8a16_matmul

    label = "int8 (W8A16 weights, int8 KV)" if int8 else "bf16"
    cfg, B, K = preset("llama3-8b"), 8, SPEC_K
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.bfloat16, quantize=int8)
    engine = InferenceEngine(cfg, params, id_tokenizer(cfg.vocab_size),
                             max_slots=B, max_seq_len=1024,
                             prefill_buckets=(128, 512), decode_block=8,
                             kv_quant=int8, fused_dequant=int8,
                             speculative=SpecConfig(k_draft=K),
                             device="cuda")
    del params
    engine.warmup()
    rng = np.random.default_rng(9)
    top = min(cfg.vocab_size, 50000)
    assign = [(b, rng.integers(0, top, n).tolist(), SamplingParams())
              for b, n in enumerate((40, 60, 80, 100, 110, 120, 90, 70))]

    regimes = (w8a16_matmul.launches_gemv, w8a16_matmul.launches_tc)
    _, oracle = check_oracle(engine, assign, label)
    w8a16_matmul.launches_gemv = w8a16_matmul.launches_tc = 0
    engine.verify_step(oracle, np.full(B, K, np.int32))
    gemv, tc = w8a16_matmul.launches_gemv, w8a16_matmul.launches_tc
    w8a16_matmul.launches_gemv += regimes[0]
    w8a16_matmul.launches_tc += regimes[1]
    if int8:
        log(f"  int8 W8A16 launches by regime in one verify ({B} x "
            f"{1 + K} = {B * (1 + K)} rows): gemv {gemv} tc {tc}")
        if tc != 7 * cfg.num_layers + 1 or gemv:
            raise AssertionError(f"int8 verify W8A16 launches gemv {gemv} "
                                 f"tc {tc}: not all on the tensor-core "
                                 f"kernel")
    rows = profile_dispatch(
        f"{label} verify dispatch ([{B}, {1 + K}], oracle drafts)",
        lambda: engine.verify_step(oracle, np.full(B, K, np.int32)))
    log(f"  {label} verify dispatch on {smi}: {sum(r[1] for r in rows)} "
        f"kernels")

    # (b) Through the Scheduler with cycling weights, speculation on and
    # off (every request opted out), in turns.
    saved = cycling(engine, CYCLE_TOKEN)
    prompts = [rng.integers(0, top, n).tolist()
               for n in (30, 50, 70, 90, 100, 110, 60, 40)]
    runs: dict[str, list] = {}
    for tag, spec in (("off", False), ("on", None), ("on", None),
                      ("off", False)):
        runs.setdefault(tag, []).append(
            schedule(engine, prompts, 64, speculative=spec))
    ids = {tag: [[r["ids"] for r in run["requests"]] for run in rs]
           for tag, rs in runs.items()}
    spec_stats = runs["on"][0]["stats"]["speculative"]
    per_verify = spec_stats["spec_tokens"] / max(1, spec_stats[
        "verify_blocks"])
    log(f"  {label} Scheduler, 8 requests x 64 tokens, cycling on token "
        f"{CYCLE_TOKEN}: identical on/off {ids['on'][0] == ids['off'][0]}; "
        f"verify_blocks {spec_stats['verify_blocks']}, drafted "
        f"{spec_stats['drafted']}, accepted {spec_stats['accepted']} (rate "
        f"{spec_stats['acceptance_rate']}), tokens emitted per verify "
        f"dispatch over the 8 slots {per_verify:.2f}, per slot "
        f"{spec_stats['tokens_per_dispatch']}; steps on "
        f"{runs['on'][0]['metrics']['steps']} off "
        f"{runs['off'][0]['metrics']['steps']}; aggregate decode tok/s on "
        f"{[round(r['decode_tok_s'], 2) for r in runs['on']]} off "
        f"{[round(r['decode_tok_s'], 2) for r in runs['off']]} ({smi})")
    if not ids["on"][0] == ids["on"][1] == ids["off"][0] == ids["off"][1]:
        raise AssertionError(f"{label}: greedy output differs with "
                             f"speculation on and off")
    if spec_stats["verify_blocks"] <= 0:
        raise AssertionError(f"{label}: no verify block with speculation on")

    # (c) A seeded sampled stream with speculation on.
    res = schedule(engine, prompts[:1], 64,
                   sampling=dict(temperature=0.9, seed=4))
    r = res["requests"][0]
    log(f"  {label} seeded stream (temperature 0.9, seed 4): "
        f"{r['generated']} tokens, {r['reason']}, verify_blocks "
        f"{res['stats']['speculative']['verify_blocks']}")
    if r["reason"] != "length" or r["generated"] != 64:
        raise AssertionError(f"{label} seeded stream ended {r['reason']} "
                             f"after {r['generated']} tokens")
    engine.params.update(saved)


# ---------------------------------------------------------------------------
# Phase 10: checkpoint loading

# 2 of llama3-8b's 32 layers: phases 10-12, 14 and 15 serve this
# checkpoint, and their seconds grow with its depth (at 8 a run with phase
# 14 read 1,230.6 s of the script's 1,200; at 4 a slow host read 1,271.9 s
# with phase 15).
CKPT_LAYERS = 2
CKPT_DIR = os.path.join(OUT_DIR, "ckpt")
CKPT_CHATS = ["hello there, how are you today?",
              "please write one short sentence about a harbour at night",
              "list three colours"]


def checkpoint_params():
    """llama3-8b's widths at CKPT_LAYERS layers, bf16, drawn on the card
    from torch.Generator seed 0."""
    import dataclasses

    from symmetry_tpu_torch.models.llama import init_params, preset

    cfg = dataclasses.replace(preset("llama3-8b"), num_layers=CKPT_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.bfloat16)
    # ones are no test of the norm leaves' bytes
    g = torch.Generator(device="cuda").manual_seed(1)
    for name in ("attn_norm", "mlp_norm"):
        params["layers"][name] = torch.rand(
            params["layers"][name].shape, generator=g, device="cuda").to(
            torch.bfloat16) + 0.5
    return cfg, params


def tree_leaves(tree):
    """Every tensor of a params tree, int8 payloads and scales included, in
    key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    elif isinstance(tree, tuple):  # (Packed)QuantizedTensor
        yield from tree
    else:
        yield tree


def assert_bit_equal(got: dict, want: dict, what: str) -> int:
    """Every leaf (int8 leaves: payload and scales) equal bit for bit;
    returns the number of tensors compared."""
    a, b = list(tree_leaves(got)), list(tree_leaves(want))
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} leaves, want {len(b)}")
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: a leaf differs ({x.dtype} "
                                 f"{tuple(x.shape)} vs {y.dtype} "
                                 f"{tuple(y.shape)})")
    return len(a)


def reap(proc: subprocess.Popen, timeout: float = 120.0
         ) -> tuple[int, float]:
    """Wait for `proc` with os.wait4: (exit code, its peak resident set in
    GiB, getrusage's ru_maxrss of that one child)."""
    deadline = time.monotonic() + timeout
    while True:
        pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
        if pid:
            proc.returncode = os.waitstatus_to_exitcode(status)
            return proc.returncode, usage.ru_maxrss / 2**20
        if time.monotonic() > deadline:
            proc.kill()
            raise AssertionError(f"pid {proc.pid} did not exit in "
                                 f"{timeout:.0f} s")
        time.sleep(0.1)


def serve_in_turn(engine, prompts: list[list[int]], max_new: int,
                  pipeline_depth: int) -> list[str]:
    """Greedy requests through one Scheduler, each submitted when the one
    before has finished (as phase 10 feeds the host); their streamed
    text."""
    from symmetry_tpu_torch.engine.engine import SamplingParams
    from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler

    sched = Scheduler(engine, pipeline_depth=pipeline_depth)
    sched.start()
    texts = []
    try:
        for i, ids in enumerate(prompts):
            events, done = [], threading.Event()

            def emit(ev, events=events, done=done):
                events.append(ev)
                if ev.done:
                    done.set()
            sched.submit(GenRequest(prompt_ids=ids, sampling=SamplingParams(),
                                    max_new_tokens=max_new, emit=emit,
                                    id=f"c{i}"))
            if not done.wait(600):
                raise AssertionError(f"request c{i} did not complete")
            texts.append("".join(ev.text for ev in events))
    finally:
        sched.stop()
    return texts


def serve_together(engine, prompts: list[list[int]], max_new: int,
                   pipeline_depth: int, admit_seconds: float = 0.65
                   ) -> list[str]:
    """Greedy requests through one Scheduler, all submitted before it
    starts (`schedule`), so that they hold slots 0, 1, ... at once; their
    streamed text."""
    return [r["text"] for r in schedule(
        engine, prompts, max_new, pipeline_depth=pipeline_depth,
        admit_seconds=admit_seconds)["requests"]]


def check_checkpoint(smi: str) -> None:
    """Write a bf16 HF-layout checkpoint with the port's writer (2 shards
    and an index json), serve it through the engine host at the
    provider's default `tpu:` section twice (cold: load, warm cache
    written; warm: from the cache), in bf16 and with quantization: int8;
    hold the loaded leaves against the tensors written and the streamed
    text against an in-process engine built from the same tensors. The
    checkpoint, with its bf16 and int8 warm caches, stays for phases 11
    and 12 (TIERS_MODEL); main removes it after them."""
    import shutil

    from symmetry_tpu_torch.convert import params_from_numpy
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.engine.tokenizer import get_tokenizer
    from symmetry_tpu_torch.engine import weights
    from symmetry_tpu_torch.models.llama import quantize_params
    from symmetry_tpu_torch.provider.config import TpuConfig

    ckpt = CKPT_DIR
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        cfg, params = checkpoint_params()
        t0 = time.perf_counter()
        weights.save_checkpoint(ckpt, params, cfg, dtype=torch.bfloat16,
                                shards=2)
        size = sum(os.path.getsize(os.path.join(ckpt, f))
                   for f in os.listdir(ckpt))
        log(f"  wrote {ckpt}: {sorted(os.listdir(ckpt))}, "
            f"{size / 1e9:.3f} GB in {time.perf_counter() - t0:.3f} s")
        # The leaves on the card, loaded cold, bit-equal to those written.
        loaded, lcfg = weights.load_checkpoint(ckpt, dtype=torch.bfloat16)
        if lcfg != cfg:
            raise AssertionError(f"config read back {lcfg} != {cfg}")
        n = assert_bit_equal(loaded, params,
                             "cold load")
        del loaded
        log(f"  load_checkpoint: {n} leaves on the card bit-equal to the "
            f"tensors written")
        # The resident set, for scale: processes that start CUDA, hold the
        # checkpoint's bytes on the card, or load the checkpoint.
        rss_of = {
            "CUDA only": "torch.zeros(1, device='cuda')",
            f"CUDA + {size / 1e9:.3f} GB on the card":
                f"torch.ones({size}, dtype=torch.uint8, device='cuda')",
            "CUDA + load_checkpoint": (
                "from symmetry_tpu_torch.engine.weights import "
                f"load_checkpoint; load_checkpoint({ckpt!r})")}
        env = {**os.environ, "PYTHONPATH": ROOT}
        procs = {what: subprocess.Popen(
            [sys.executable, "-c", f"import torch; {code}; "
             f"torch.cuda.synchronize()"], cwd=ROOT, env=env)
            for what, code in rss_of.items()}  # all three at once
        for what, proc in procs.items():
            rc, rss_of[what] = reap(proc, 300)
            if rc != 0:
                raise AssertionError(f"the {what} process exited {rc}")
        log(f"  peak RSS of one process (getrusage ru_maxrss, wait4): "
            f"{', '.join(f'{k} {v:.3f} GiB' for k, v in rss_of.items())}")
        # The same tensors through params_from_numpy, for the in-process
        # reference engines.
        host_tree = {k: (v.float().cpu().numpy() if not isinstance(v, dict)
                         else {kk: vv.float().cpu().numpy()
                               for kk, vv in v.items()})
                     for k, v in params.items()}
        del params
        tok = get_tokenizer(None, vocab_size=cfg.vocab_size)
        chats = [tok.apply_chat_template([{"role": "user", "content": c}])
                 for c in CKPT_CHATS]
        tags = {False: "bf16", True: "int8"}
        tpus = {quant: {"checkpoint_path": ckpt,
                        **({"quantization": "int8"} if quant else {})}
                for quant in tags}
        for quant in tags:
            if weights.load_warm_cache(ckpt, dtype=torch.bfloat16,
                                       quantize=quant) is not None:
                raise AssertionError("a warm cache before the first start")
        # The bf16 and int8 hosts start together, cold and then warm; the
        # in-process references are served while the cold ones start.
        texts, ready, rss = ({quant: {} for quant in tags} for _ in range(3))
        hosts = {quant: HostProc(f"ckpt_{tags[quant]}_cold", tpus[quant])
                 for quant in tags}
        try:
            want_text, ref_params = {}, {}
            for quant in tags:
                ref_params[quant] = params_from_numpy(
                    host_tree, device="cuda", dtype=torch.bfloat16)
                if quant:
                    ref_params[quant] = quantize_params(ref_params[quant])
                defaults = TpuConfig.from_dict(tpus[quant])
                engine = InferenceEngine(
                    cfg, ref_params[quant], tok,
                    max_slots=defaults.max_batch_size,
                    max_seq_len=defaults.max_seq_len,
                    prefill_buckets=defaults.prefill_buckets,
                    cache_dtype=torch.bfloat16,
                    decode_block=defaults.decode_block,
                    prefill_chunk=defaults.prefill_chunk)
                engine.warmup()
                want_text[quant] = serve_in_turn(engine, chats, 24,
                                                 defaults.pipeline_depth)
                del engine
            for start in ("cold", "warm"):
                if start == "warm":
                    hosts = {quant: HostProc(f"ckpt_{tags[quant]}_warm",
                                             tpus[quant]) for quant in tags}
                for quant, host in hosts.items():
                    ready[quant][start] = host.wait_for(
                        lambda f: f.get("op") == "ready")
                    for i, content in enumerate(CKPT_CHATS):
                        submit(host, f"c{i}", content, 24)
                        host.wait_done([f"c{i}"])
                    texts[quant][start] = [stream(host, f"c{i}")["text"]
                                           for i in range(len(CKPT_CHATS))]
                    host.send({"op": "shutdown"})
                    rc, rss[quant][start] = reap(host.proc)
                    if rc != 0:
                        raise AssertionError(f"host {host.label} exit code "
                                             f"{rc}")
                    text = host.log_text()
                    path = ("warm" if "weights loaded from warm cache" in text
                            else "cold" if "weights loaded cold" in text
                            else None)
                    if path != start:
                        raise AssertionError(
                            f"host {host.label} took the {path} path (log "
                            f"{host.log_path})")
                    if start == "cold" and (
                            "warm weight cache written" not in text):
                        raise AssertionError(
                            f"host {host.label}: no warm cache written (log "
                            f"{host.log_path})")
        finally:
            for host in hosts.values():
                host.kill()
        for quant, tag in tags.items():
            if not (texts[quant]["cold"] == texts[quant]["warm"]
                    == want_text[quant]):
                raise AssertionError(
                    f"{tag}: streamed text cold {texts[quant]['cold']} / "
                    f"warm {texts[quant]['warm']} != in-process "
                    f"{want_text[quant]}")
            # The warm cache's leaves on the card, bit-equal to the
            # reference tree (int8: quantized on the card from the same
            # tensors).
            warm_params, _ = weights.load_warm_cache(
                ckpt, dtype=torch.bfloat16, quantize=quant)
            n = assert_bit_equal(warm_params, ref_params[quant],
                                 f"{tag} warm cache")
            del warm_params
            r = ready[quant]
            log(f"  host {tag} on the checkpoint: build_s cold "
                f"{r['cold']['build_s']} s, warm {r['warm']['build_s']} s "
                f"(the load inside from_tpu_config; warmup_s "
                f"{r['cold']['warmup_s']} / {r['warm']['warmup_s']}; the bf16 "
                f"and int8 hosts start together); peak RSS of the host "
                f"process (getrusage ru_maxrss, wait4) cold "
                f"{rss[quant]['cold']:.3f} GiB, warm "
                f"{rss[quant]['warm']:.3f} GiB; warm-cache leaves bit-equal "
                f"to the in-process tree ({n} tensors); streamed text "
                f"identical cold, warm and in-process for {len(CKPT_CHATS)} "
                f"chats: {[t[:24] for t in want_text[quant]]} ({smi})")
        del ref_params
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise


# ---------------------------------------------------------------------------
# Phase 11: the prefill and decode tiers, device-time probes

# Phases 11-12 serve phase 10's checkpoint (llama3-8b widths, CKPT_LAYERS
# layers, its warm caches): a depth cut from 32 layers that keeps the
# script inside its time limit on a slow host. Their hosts are host-bound
# (idle 0.7-0.8 of a decode block), and the host's launches, and so these
# phases' seconds, grow with the depth.
TIERS_MODEL = {"checkpoint_path": CKPT_DIR}
DISAGG_LENS = [60, 700, 1880]
DISAGG_NEW = 32
PROFILE_NEW = 160  # ten decode blocks: the capture lands inside decode
TRACE_KERNEL = "decode_split_kernel"  # csrc/decode_attention.cu


def tier_config(base: dict, role: str) -> dict:
    """The `tpu:` section the JAX provider's broker gives each tier's host
    (symmetry_tpu/engine/disagg/broker.py derive_role_config): the role
    pinned, a prefix cache on both tiers (the base sets one), and a prefill
    tier's pipeline_depth 1 (it never decodes)."""
    out = {**base, "role": role}
    if role == "prefill":
        out.setdefault("pipeline_depth", 1)
    return out


def serve_one_by_one(host: HostProc, prefix: str, contents: list,
                     max_new: int) -> list[dict]:
    out = []
    for i, content in enumerate(contents):
        sent = time.monotonic()
        submit(host, f"{prefix}{i}", content, max_new)
        host.wait_done([f"{prefix}{i}"])
        out.append({**stream(host, f"{prefix}{i}"), "sent": sent})
    return out


def check_disagg(smi: str, *, int8: bool) -> dict:
    """Phase 10's checkpoint (llama3-8b widths, CKPT_LAYERS layers; its warm
    caches), the provider's default `tpu:` section plus a 1024 MiB prefix
    cache and 32-token prefix blocks (so that a short
    chat has no whole block and routes without a prefill), bf16 or int8
    (kv_quant + fused_dequant). (a) a unified host serves 3 chats of
    60-1880 tokens, a 21-token chat and a repeat of the 700-token one, one
    at a time, 32 new tokens each, twice: the first serve from an empty
    prefix cache, the second hitting it, which runs the prompt's last
    partial block through the cached admission as a decode tier does after
    adoption; (b) a prefill host and two decode hosts (probes off, and
    profile_sample 4), each `handoff` frame piped into both decode hosts'
    `adopt`, as the broker does: the streamed text of both equals (a)'s
    second serve, the 21-token chat's frame is routing-only and the
    repeat's ships its manifest only; (c) the probed host's devprof rider
    beside an in-process torch.profiler reading of one decode block; (d)
    the `profile` op on the probed host while it decodes a 160-token
    request returns a trace that names the decode-attention kernel; (e)
    frame bytes per prefix token, serialize and adopt seconds. The four
    hosts start together; (b) serves before (a)."""
    from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                  SamplingParams)
    from symmetry_tpu_torch.engine import weights
    from symmetry_tpu_torch.engine.tokenizer import get_tokenizer
    from symmetry_tpu_torch.provider.config import TpuConfig

    tag = "int8" if int8 else "bf16"
    base = {**TIERS_MODEL, "prefix_cache_mb": 1024,
            "prefix_block_tokens": 32,
            **({"quantization": "int8", "kv_quantization": "int8",
                "fused_dequant": True} if int8 else {})}
    tok = get_tokenizer(None, vocab_size=128256)
    head = len(tok.apply_chat_template([{"role": "user", "content": ""}]))
    rng = np.random.default_rng(11)
    chats = [chat_content(rng, n - head) for n in DISAGG_LENS]
    contents = chats + ["hi", chats[1]]
    lens = [len(tok.apply_chat_template([{"role": "user", "content": c}]))
            for c in contents]
    log(f"  {tag}: prompt tokens {lens}, {DISAGG_NEW} new tokens each, "
        f"prefix blocks of {base['prefix_block_tokens']}")

    # The unified host and the tiers' three start together. The tiers
    # serve (b) first, as soon as all four are ready, so that the probed
    # host's first gap is no longer than it was when they started alone;
    # then (a) runs on the unified host, which waited idle.
    t0 = time.monotonic()
    unified = HostProc(f"disagg_{tag}_unified", base)
    decode_tpu = tier_config(base, "decode")
    pre = HostProc(f"disagg_{tag}_prefill", tier_config(base, "prefill"))
    decs = [HostProc(f"disagg_{tag}_decode", decode_tpu),
            HostProc(f"disagg_{tag}_decode_probed",
                     {**decode_tpu, "profile_sample": 4})]
    hosts = [pre, *decs]
    prof_dir = os.path.join(OUT_DIR, f"profiles_{tag}")
    try:
        for h in [unified, *hosts]:
            ready = h.wait_for(lambda f: f.get("op") == "ready")
            if h is not unified and ready["role"] != h.label.split("_")[2]:
                raise AssertionError(f"{h.label} ready as {ready['role']}")
        t1 = time.monotonic()
        log(f"  unified, prefill and two decode hosts started together, all "
            f"ready in {t1 - t0:.1f} s")
        handoffs = []
        for i, content in enumerate(contents):
            rid = f"d{i}"
            submit(pre, rid, content, DISAGG_NEW)
            frame = pre.wait_for(lambda f, rid=rid: f.get("op") == "handoff"
                                 and f.get("id") == rid)
            b64 = frame.pop("frame")
            handoffs.append(frame)
            for dec in decs:
                dec.send({"op": "adopt", "id": rid, "frame": b64,
                          "max_new": DISAGG_NEW,
                          "sampling": {"temperature": 0.0}})
            del b64
            for dec in decs:
                dec.wait_done([rid])
        got = [[stream(dec, f"d{i}") for i in range(len(contents))]
               for dec in decs]
        # (d) a capture while the probed decode host decodes a request of
        # PROFILE_NEW tokens (a submit: every host role takes those)
        submit(decs[1], "p0", "hi", PROFILE_NEW)
        decs[1].wait_for(lambda f: any(e.get("id") == "p0" for e in (
            [f] if f.get("op") == "event" else f.get("events", []))))
        decs[1].send({"op": "profile", "duration_s": 0.5, "dir": prof_dir})
        reply = decs[1].wait_for(lambda f: f.get("op") == "profile")
        if "path" not in reply:
            raise AssertionError(f"profile op: {reply}")
        trace_path = os.path.join(reply["path"], "trace.json")
        decs[1].wait_done(["p0"])
        pstats = pre.stats()
        dstats = [dec.stats() for dec in decs]
        for h in hosts:
            if h.shutdown() != 0:
                raise AssertionError(f"host {h.label} exit code != 0")
        t2 = time.monotonic()
        cold = serve_one_by_one(unified, "c", contents, DISAGG_NEW)
        warm = serve_one_by_one(unified, "w", contents, DISAGG_NEW)
        if unified.shutdown() != 0:
            raise AssertionError("unified host exit code != 0")
        t3 = time.monotonic()
    finally:
        for h in [unified, *hosts]:
            h.kill()
    log(f"  (a) unified host served both passes in {t3 - t2:.1f} s")
    same = [a["text"] == b["text"] for a, b in zip(cold, warm)]
    log(f"  (a) unified host: first serve == second (cached) serve "
        f"{sum(same)}/{len(same)} {same}; second serve reused "
        f"{[r['reused'] for r in warm]}")
    if not all((r["reused"] or 0) > 0 for i, r in enumerate(warm)
               if i != len(chats)):
        raise AssertionError(f"unified second serve missed the cache: "
                             f"{[r['reused'] for r in warm]}")
    for label, rs in zip(("probes off", "probes on"), got):
        for i, (a, b) in enumerate(zip(rs, warm)):
            if (a["text"], a["tokens"], a["reason"]) != (
                    b["text"], b["tokens"], b["reason"]):
                raise AssertionError(
                    f"disagg {tag} ({label}) request {i}: decode tier "
                    f"{a} != unified {b}")
    cold_same = [a["text"] == b["text"] for a, b in zip(got[0], cold)]
    log(f"  (b) prefill -> decode tiers: streamed text identical to the "
        f"unified host's second serve, probes off and on, "
        f"{len(contents)} requests; equal to its first serve "
        f"{sum(cold_same)}/{len(cold_same)} ({t2 - t1:.1f} s)")
    short, repeat = len(chats), len(chats) + 1
    if handoffs[short]["p"] != 0 or handoffs[short]["blocks"] != 0:
        raise AssertionError(f"short chat not routing-only: "
                             f"{handoffs[short]}")
    if handoffs[repeat]["shipped"] != 0 or handoffs[repeat]["blocks"] != (
            handoffs[1]["blocks"]) or handoffs[1]["shipped"] != handoffs[1][
                "blocks"]:
        raise AssertionError(f"repeat not manifest-only: {handoffs[1]} "
                             f"{handoffs[repeat]}")
    k = pstats["kernels"]
    if k["decode_attention"] or k["flash_prefill"] <= 0:
        raise AssertionError(f"prefill host kernels {k}")
    for st in dstats:
        k = st["kernels"]
        if min(k["decode_attention"], k["decode_attention_append"]) <= 0 or (
                int8 and k["w8a16_matmul"] <= 0):
            raise AssertionError(f"decode host kernels {k}")
        # every frame but the routing-only one adopts (the repeat's by
        # reference)
        if st["adopt"]["errors"] or st["adopt"]["adopted"] != len(
                contents) - 1:
            raise AssertionError(f"decode host adopt {st['adopt']}")

    # (c) the probes' rider, and one decode block under torch.profiler
    dp = dstats[1]["devprof"]
    log(f"  (c) devprof (profile_sample 4) on {smi}: probes "
        f"{dp['probes']}, dispatches {dp['dispatches']}, device_s_total "
        f"{dp['device_s_total']}, dispatch_gap_s_total "
        f"{dp['dispatch_gap_s_total']}, gap_share {dp['gap_share']} "
        f"(pipeline_depth {dp['pipeline_depth']})")
    for kind, h in sorted(dp["device_s"].items()):
        log(f"    {kind:12s} n={h['count']} p50 {h['p50']} p90 {h['p90']} "
            f"max {h['max']} s")
    log(f"    dispatch gap n={dp['dispatch_gap_s']['count']} p50 "
        f"{dp['dispatch_gap_s']['p50']} p90 {dp['dispatch_gap_s']['p90']} s")
    engine = InferenceEngine.from_tpu_config(TpuConfig.from_dict(
        {**decode_tpu, "profile_sample": 1}))
    engine.warmup()
    ids = tok.apply_chat_template([{"role": "user", "content": chats[-1]}])
    engine.prefill_and_insert_many(
        [(s, ids[:lens[0] + 40 * s], SamplingParams()) for s in range(4)])
    rows = profile_dispatch(
        f"decode block ({engine.decode_block} steps, 4 live slots, {tag})",
        lambda: np.asarray(engine.decode_steps_dispatch()))
    probed = [sp["duration_s"] for sp in engine.devprof.component()["spans"]
              if sp["name"] == "decode_block"][-2:]
    log(f"    the same engine's probe of those blocks: "
        f"{[round(d * 1e3, 3) for d in probed]} ms (devprof device "
        f"duration: dispatch start to completion); its gap_share over "
        f"back-to-back blocks {engine.devprof.stats()['gap_share']}")
    if not rows:
        raise AssertionError("profiler saw no decode kernels")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the profile op's trace
    with open(trace_path) as fh:
        trace = fh.read()
    if TRACE_KERNEL not in trace:
        raise AssertionError(f"{trace_path} names no {TRACE_KERNEL}")
    log(f"  (d) profile op: {trace_path} ({len(trace) / 1e6:.1f} MB) names "
        f"{TRACE_KERNEL} {trace.count(TRACE_KERNEL)} times")

    # (e) frames
    h = pstats["handoff"]
    sized = [f for f in handoffs if f["p"] and f["shipped"]]
    per_tok = [f["nbytes"] / f["p"] for f in sized]
    a = dstats[0]["adopt"]
    c = weights.read_hf_config(CKPT_DIR)
    kv_token = 2 * c.num_layers * c.num_kv_heads * (
        c.dim_per_head + 4 if int8 else 2 * c.dim_per_head)
    log(f"  (e) handoff frames: {h['frames']} ({h['routing_only']} "
        f"routing-only), {h['bytes'] / 1e6:.3f} MB, prefix tokens "
        f"{h['prefix_tokens']}, blocks {h['blocks']} shipped "
        f"{h['blocks_shipped']}; bytes per prefix token "
        f"{min(per_tok):.1f}-{max(per_tok):.1f} (KV {kv_token} a token); "
        f"serialize_s "
        f"{h['serialize_s']} over {h['frames']} frames; decode host adopt "
        f"{a}; adopt dispatches {dstats[0]['adopt_dispatches']} in "
        f"{dstats[0]['adopt_s']:.4f} s (p50 "
        f"{dstats[0]['adopt_dispatch_s']['p50']} s)")
    return {"contents": contents, "cold": cold, "warm": warm,
            "tiers": got[0]}


# ---------------------------------------------------------------------------
# Phase 12: the port's own server, provider and client over TCP

PROVIDER_TIMEOUT = 600.0  # a provider's start: its host builds llama3-8b
BURST_LENS = [60, 100, 300, 420, 500, 900, 1500, 1880]
BURST_NEW = 64
KILL_NEW = 512  # long enough that the kill lands mid-stream


def child_pids(pid: int) -> list[int]:
    """The processes whose parent is `pid` (from /proc/*/stat)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return out


def gpu_memory_used() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def kernel_files() -> dict[str, float]:
    """The kernel build directory's files and their modification times."""
    from symmetry_tpu_torch.ops import kernels

    root = kernels.DEFAULT_BUILD_DIR
    return {p.name: p.stat().st_mtime for p in root.iterdir()}


class ProviderProc:
    """`python -m symmetry_tpu_torch.provider -c <yaml>` as a subprocess
    registering with the script's server over TCP; its log, with its
    engine hosts' stderr, in build/chip_smoke/provider_<label>.log."""

    def __init__(self, label: str, tpu: dict, server_address: str,
                 server_key_hex: str, device: str | None = None):
        import yaml

        os.makedirs(OUT_DIR, exist_ok=True)
        self.label = label
        cfg = {**PROVIDER, "name": f"chip-smoke-{label}", "public": True,
               "serverKey": server_key_hex, "serverAddress": server_address,
               "listenHost": "127.0.0.1", "modelName": label,
               "path": os.path.join(OUT_DIR, f"provider_{label}_state"),
               "tpu": tpu}
        cfg_path = os.path.join(OUT_DIR, f"provider_{label}.yaml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(cfg, fh)
        self.log_path = os.path.join(OUT_DIR, f"provider_{label}.log")
        self._log = open(self.log_path, "w")
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "symmetry_tpu_torch.provider", "-c",
             cfg_path] + (["--device", device] if device else []),
            cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
            stdout=self._log, stderr=subprocess.STDOUT)
        self.hosts_seen: set[int] = set()

    def host_pids(self) -> list[int]:
        pids = child_pids(self.proc.pid)
        self.hosts_seen.update(pids)
        return pids

    def log_text(self) -> str:
        with open(self.log_path) as fh:
            return fh.read()

    def stop(self, timeout: float = 180.0) -> int:
        """SIGTERM (the provider drains and shuts its hosts down), then
        make sure that it and every host it ran are gone. Once: a second
        call returns the first one's exit code."""
        if self._log.closed:
            return self.proc.returncode
        self.host_pids()
        rc = self.proc.poll()
        if rc is None:
            self.proc.terminate()
            try:
                rc = self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                rc = self.proc.wait()
        for pid in self.hosts_seen:
            try:
                os.kill(pid, 9)
            except ProcessLookupError:
                pass
        self._log.close()
        return rc


async def wait_registered(server, prov: ProviderProc) -> float:
    t0 = time.monotonic()
    while not any(row.model_name == prov.label
                  for row in server.registry.list_providers()):
        if prov.proc.poll() is not None:
            raise AssertionError(f"provider {prov.label} exited rc="
                                 f"{prov.proc.returncode} (log "
                                 f"{prov.log_path})")
        if time.monotonic() - t0 > PROVIDER_TIMEOUT:
            raise AssertionError(f"provider {prov.label} not registered in "
                                 f"{PROVIDER_TIMEOUT:.0f} s")
        await asyncio.sleep(0.5)
    return time.monotonic() - t0


async def wire_chat(session, content: str, max_new: int) -> dict:
    """One greedy chat over the wire: its text, and when the request was
    sent, its first text arrived and its stream ended (this process's
    monotonic clock)."""
    t_send = time.monotonic()
    t_first = None
    parts = []
    async for delta in session.chat([{"role": "user", "content": content}],
                                    max_tokens=max_new, temperature=0.0):
        if delta and t_first is None:
            t_first = time.monotonic()
        parts.append(delta)
    return dict(text="".join(parts), sent=t_send, first=t_first,
                done=time.monotonic())


async def provider_unified(server, client, smi: str, contents: list,
                           ref: dict) -> None:
    """(a): phase 11's bf16 configuration behind the port's provider."""
    from symmetry_tpu_torch.client.client import ProviderRestartingError
    from symmetry_tpu_torch.engine.tokenizer import get_tokenizer

    base = {**TIERS_MODEL, "prefix_cache_mb": 1024,
            "prefix_block_tokens": 32}
    label = "llama3-8b-bf16"
    prov = ProviderProc(label, base, server.address,
                        server.identity.public_hex)
    try:
        t_reg = await wait_registered(server, prov)
        log(f"  (a) provider up and registered in {t_reg:.1f} s "
            f"(host pids {prov.host_pids()}); GPU memory used "
            f"{gpu_memory_used()}")
        details = await client.request_provider(
            server.address, server.identity.public_key, label)
        session = await client.connect(details)
        # (a)1 phase 11's chats one at a time, twice: cold, then cached
        got = {}
        for serve in ("cold", "warm"):
            got[serve] = [await wire_chat(session, c, DISAGG_NEW)
                          for c in contents]
            for i, (a, b) in enumerate(zip(got[serve], ref[serve])):
                if a["text"] != b["text"]:
                    raise AssertionError(
                        f"provider {serve} serve, chat {i}: over the wire "
                        f"{a['text']!r} != phase 11's unified host "
                        f"{b['text']!r}")
        log(f"  (a)1 {len(contents)} chats x {DISAGG_NEW} tokens, twice: "
            f"text over the wire == phase 11's unified host, cold and "
            f"cached")
        # Random weights stream bytes that are often not whole UTF-8
        # characters, which the host holds back, so the first text can
        # come a decode block or more after the first token: both sides
        # are read to their first text, and to the stream's end.
        for serve in ("cold", "warm"):
            wire = [(r["first"] - r["sent"], r["done"] - r["sent"])
                    for r in got[serve]]
            pipe = [(r["first_text_at"] - r["sent"], r["done_at"] - r["sent"])
                    for r in ref[serve]]
            log(f"    {serve}: to first text / to the end, s: over the wire "
                f"{[(round(a, 4), round(b, 4)) for a, b in wire]}; phase "
                f"11's host pipe {[(round(a, 4), round(b, 4)) for a, b in pipe]}"
                f"; the host's ttft_s (first token) "
                f"{[round(r['ttft_s'], 4) for r in ref[serve]]}; wire minus "
                f"pipe to first text p50 "
                f"{statistics.median(w[0] - p[0] for w, p in zip(wire, pipe)):.4f}"
                f" s, to the end p50 "
                f"{statistics.median(w[1] - p[1] for w, p in zip(wire, pipe)):.4f}"
                f" s")
        st = await session.stats()
        eng1 = st["engine"]
        await session.close()

        # (a)2 a burst of 8 sessions at once
        tok = get_tokenizer(None, vocab_size=128256)
        head = len(tok.apply_chat_template([{"role": "user", "content": ""}]))
        rng = np.random.default_rng(12)
        burst = [chat_content(rng, n - head) for n in BURST_LENS]
        sessions = [await client.connect(await client.request_provider(
            server.address, server.identity.public_key, label))
            for _ in burst]
        t0 = time.monotonic()
        res = await asyncio.gather(*[wire_chat(s, c, BURST_NEW)
                                     for s, c in zip(sessions, burst)])
        wall = time.monotonic() - t0
        for s in sessions:
            await s.close()
        session = await client.connect(await client.request_provider(
            server.address, server.identity.public_key, label))
        st = await session.stats()
        eng = st["engine"]
        if any(not r["text"] or r["first"] is None for r in res):
            raise AssertionError("a burst stream came back empty")
        ttfts = sorted(r["first"] - r["sent"] for r in res)
        n_tok = eng["tokens"] - eng1["tokens"]
        window = max(r["done"] for r in res) - min(r["first"] for r in res)
        h1, h2 = eng1["engine_ttft_s"], eng["engine_ttft_s"]
        host_mean = ((h2["mean"] * h2["count"] - h1["mean"] * h1["count"])
                     / (h2["count"] - h1["count"]))
        log(f"  (a)2 burst of {len(burst)} sessions ({BURST_LENS} prompt "
            f"tokens x {BURST_NEW}) on {smi}: all complete in {wall:.3f} s; "
            f"client TTFT p50 {statistics.median(ttfts):.4f} s, max "
            f"{ttfts[-1]:.4f} s; aggregate decode {n_tok - len(res)} tokens "
            f"over {window:.3f} s = {(n_tok - len(res)) / window:.2f} tok/s "
            f"(tokens from the host's counter); the host's own TTFT over "
            f"the burst: mean {host_mean:.4f} s (all {h2['count']} requests "
            f"so far: p50 {h2['p50']} max {h2['max']} s), decode step "
            f"{eng.get('decode_step_ms')} ms")
        # (a)3 the kernels rider, read over the wire
        k = eng["kernels"]
        if k["flash_prefill"] <= 0 or k["decode_attention_append"] <= 0:
            raise AssertionError(f"provider host kernels {k}")
        log(f"  (a)3 kernels rider over the wire: {k}")

        # (a)4 SIGKILL the host mid-stream
        (host_pid,) = prov.host_pids()
        files = kernel_files()
        mem_before = gpu_memory_used()
        stream = session.chat([{"role": "user", "content": contents[0]}],
                              max_tokens=KILL_NEW, temperature=0.0)
        n_parts = 0
        try:
            async for _ in stream:
                n_parts += 1
                if n_parts == 2:
                    os.kill(host_pid, 9)
                    t_kill = time.monotonic()
            raise AssertionError("the stream outlived its host")
        except ProviderRestartingError as exc:
            log(f"  (a)4 host {host_pid} SIGKILLed mid-stream; the client "
                f"got ProviderRestartingError ({exc}) after "
                f"{len(exc.emitted_text)} characters")
        while True:
            sup = (await session.stats()).get("engine", {}) or {}
            s = sup.get("supervisor") or {}
            if s.get("restarts", 0) >= 1 and not s.get("restarting") and (
                    "tokens" in sup):
                break
            if time.monotonic() - t_kill > PROVIDER_TIMEOUT:
                raise AssertionError(f"host not respawned: {sup}")
            await asyncio.sleep(0.25)
        respawn_s = time.monotonic() - t_kill
        new_pids = prov.host_pids()
        if new_pids == [host_pid] or len(new_pids) != 1:
            raise AssertionError(f"host pids after respawn {new_pids}")
        again = await wire_chat(session, contents[0], DISAGG_NEW)
        if again["text"] != got["cold"][0]["text"]:
            raise AssertionError(f"after the respawn: {again['text']!r} != "
                                 f"{got['cold'][0]['text']!r}")
        if kernel_files() != files:
            raise AssertionError("the respawned host built kernels")
        ready = [ln for ln in prov.log_text().splitlines()
                 if "engine host ready" in ln]
        log(f"  (a)4 respawned (pid {new_pids[0]}) and serving in "
            f"{respawn_s:.3f} s; the kernel build directory unchanged; "
            f"host start lines: {[ln.split('] ')[-1] for ln in ready]}; "
            f"the same chat's text equals its cold serve; GPU memory used "
            f"{mem_before} before the kill, {gpu_memory_used()} after the "
            f"respawn")
        await session.close()
    finally:
        rc = prov.stop()
    log(f"  (a) provider stopped (rc {rc})")


DISAGG_PROVIDER = {**TIERS_MODEL, "prefix_cache_mb": 1024,
                   "prefix_block_tokens": 32, "quantization": "int8",
                   "kv_quantization": "int8", "fused_dequant": True,
                   "role": "disagg"}


async def provider_disagg(server, client, prov: ProviderProc,
                          contents: list, ref: list) -> None:
    """(b): phase 11's int8 configuration as a local disagg pair behind
    the port's provider (`prov`, DISAGG_PROVIDER, started beside (a)): its
    own broker pipes handoff -> adopt."""
    label = prov.label
    try:
        t_reg = await wait_registered(server, prov)
        log(f"  (b) disagg provider (started beside (a)) registered, "
            f"{t_reg:.1f} s after (a) ended (host pids {prov.host_pids()})")
        session = await client.connect(await client.request_provider(
            server.address, server.identity.public_key, label))
        got = [await wire_chat(session, c, DISAGG_NEW) for c in contents]
        for i, (a, b) in enumerate(zip(got, ref)):
            if a["text"] != b["text"]:
                raise AssertionError(
                    f"disagg provider chat {i}: over the wire {a['text']!r}"
                    f" != phase 11's int8 decode tier {b['text']!r}")
        eng = (await session.stats())["engine"]
        dk = eng["kernels"]
        pre = eng["disagg"]["prefill_host"]
        pk = pre["kernels"]
        if (dk["w8a16_matmul_gemv"] <= 0 or dk["decode_attention"] <= 0
                or pk["w8a16_matmul_tc"] <= 0 or pk["flash_prefill"] <= 0):
            raise AssertionError(f"disagg kernels: decode {dk}, prefill "
                                 f"{pk}")
        if pre["role"] != "prefill" or eng["role"] != "decode":
            raise AssertionError(f"roles {pre['role']} {eng['role']}")
        broker = {k: eng["disagg"][k] for k in (
            "submitted", "handoff_frames", "routing_only", "warm_frames",
            "wire_bytes", "dropped")}
        log(f"  (b) {len(contents)} chats through the provider's broker: "
            f"text == phase 11's int8 decode tiers; client TTFT "
            f"{[round(r['first'] - r['sent'], 4) for r in got]} s; decode "
            f"host kernels {dk}; prefill host kernels {pk}; broker {broker}")
        await session.close()
    finally:
        rc = prov.stop()
    log(f"  (b) provider stopped (rc {rc})")


def check_provider(smi: str, ref_bf16: dict, ref_int8: dict) -> None:
    """The port's server (in this process), provider (a subprocess running
    `python -m symmetry_tpu_torch.provider`, whose engine host is a third
    process) and client (in this process), over TCP on 127.0.0.1 with
    Noise handshakes: (a) phase 11's bf16 configuration, its chats one at
    a time twice, text equal to phase 11's unified host cold for cold and
    cached for cached; a burst of 8 sessions; the kernels rider over the
    wire; the host SIGKILLed mid-stream, the client shed retryable, the
    host respawned without a kernel build and serving the same text;
    (b) phase 11's int8 configuration as `tpu.role: disagg` (the
    provider's own broker between a prefill and a decode host), text
    equal to phase 11's int8 decode tiers."""
    from symmetry_tpu_torch.client.client import SymmetryClient
    from symmetry_tpu_torch.identity import Identity
    from symmetry_tpu_torch.server.broker import SymmetryServer
    from symmetry_tpu_torch.transport.tcp import TcpTransport

    async def run() -> None:
        server = SymmetryServer(Identity.from_name("chip-smoke-server"),
                                TcpTransport())
        await server.start("tcp://127.0.0.1:0")
        client = SymmetryClient(Identity.from_name("chip-smoke-client"),
                                TcpTransport())
        # (b)'s provider starts beside (a)'s and waits, registered.
        disagg = ProviderProc("llama3-8b-int8-disagg", DISAGG_PROVIDER,
                              server.address, server.identity.public_hex)
        try:
            await provider_unified(server, client, smi, ref_bf16["contents"],
                                   ref_bf16)
            await provider_disagg(server, client, disagg,
                                  ref_int8["contents"], ref_int8["tiers"])
        finally:
            disagg.stop()
            await server.stop()

    asyncio.run(run())


# ---------------------------------------------------------------------------
# Phase 13: the mixtral family (models/moe.py)

MOE_NEW = 32
# The bf16 run's depth: 8 of mixtral-8x7b's 32 layers (~23.7 GB of bf16
# weights; all 32 are ~93.4 GB, more than the card holds). The int8 run
# keeps all 32.
MOE_BF16_LAYERS = 8
MOE_EXPERT_LEAVES = [("layers/wd", "expert_stack"),
                     ("layers/wg", "expert_stack"),
                     ("layers/wu", "expert_stack")]


def read_launches() -> dict[str, int]:
    """Every kernel wrapper's launch counts since reset_launches."""
    from symmetry_tpu_torch.ops.decode_attention import decode_attention
    from symmetry_tpu_torch.ops.flash import flash_prefill
    from symmetry_tpu_torch.ops.kv_append import kv_append
    from symmetry_tpu_torch.ops.moe_gemv import moe_gemv
    from symmetry_tpu_torch.ops.qmm import w8a16_matmul

    return {"flash_prefill": flash_prefill.launches,
            "flash_tensor_core": flash_prefill.variant_launches[
                "tensor_core"],
            "flash_fma": flash_prefill.variant_launches["fma"],
            "decode_attention": decode_attention.launches,
            "decode_attention_append": decode_attention.launches_append,
            "kv_append": kv_append.launches,
            "w8a16_matmul": w8a16_matmul.launches,
            "w8a16_gemv": w8a16_matmul.launches_gemv,
            "w8a16_gemv_f32": w8a16_matmul.launches_gemv_f32,
            "w8a16_tc": w8a16_matmul.launches_tc,
            "moe_gemv": moe_gemv.launches}


class counting_dispatch:
    """Within the block, count the calls of models/moe.py's capacity-factor
    dispatch (each is one layer of one prefill, chunk or verify of 64 or
    more tokens), and the grouped expert GEMV's launches inside them (a
    dispatch whose capacity is at most 64 rows an expert). A measurement
    harness; the port has no such counter."""

    def __enter__(self):
        from symmetry_tpu_torch.models import moe
        from symmetry_tpu_torch.ops.moe_gemv import moe_gemv

        self.saved = moe.moe_mlp_dispatch
        self.calls = self.gemv_launches = 0

        def counted(x, lp, config, mesh=None):
            self.calls += 1
            before = moe_gemv.launches
            out = self.saved(x, lp, config, mesh)
            self.gemv_launches += moe_gemv.launches - before
            return out

        moe.moe_mlp_dispatch = counted
        return self

    def reset(self) -> None:
        self.calls = self.gemv_launches = 0

    def __exit__(self, *exc):
        from symmetry_tpu_torch.models import moe

        moe.moe_mlp_dispatch = self.saved
        return False


class recording_decisions:
    """Within the block, record every discrete decision this process's
    engine makes, in order: each MoE router call (models/moe.py top_k:
    each token's top-k experts as a set, and its k-th router logit minus
    its (k+1)-th) and each sampling (engine sample_tokens: each row's
    token, and its best logit minus its second). A measurement harness;
    the port keeps no such record."""

    def __enter__(self):
        from symmetry_tpu_torch.engine import engine as engine_mod
        from symmetry_tpu_torch.models import moe

        self.saved = (moe.top_k, engine_mod.sample_tokens)
        self.kinds: list[str] = []
        self.choices: list[np.ndarray] = []
        self.margins: list[np.ndarray] = []

        def note(kind, choice, top, k):
            self.kinds.append(kind)
            self.choices.append(choice.cpu().numpy())
            self.margins.append((top[..., k - 1] - top[..., k]).reshape(-1)
                                .float().cpu().numpy())

        def routed(logits, k):
            vals, idx = self.saved[0](logits, k)
            note("route", torch.sort(idx.reshape(-1, k), dim=-1).values,
                 torch.sort(logits, dim=-1, descending=True).values, k)
            return vals, idx

        def sampled(logits, *args):
            toks = self.saved[1](logits, *args)
            note("sample", toks.reshape(-1, 1),
                 torch.topk(logits, 2, dim=-1).values, 1)
            return toks

        moe.top_k, engine_mod.sample_tokens = routed, sampled
        return self

    def __exit__(self, *exc):
        from symmetry_tpu_torch.engine import engine as engine_mod
        from symmetry_tpu_torch.models import moe

        moe.top_k, engine_mod.sample_tokens = self.saved
        return False

    def save(self, path: str) -> None:
        np.savez(path, kinds=np.array(self.kinds),
                 **{f"choice{i}": c for i, c in enumerate(self.choices)})

    @staticmethod
    def load(path: str) -> tuple[list[str], list[np.ndarray]]:
        with np.load(path) as z:
            kinds = z["kinds"].tolist()
            return kinds, [z[f"choice{i}"] for i in range(len(kinds))]


def decisions_apart(kinds: list[str], choices: list[np.ndarray], want,
                    layers: int) -> list[tuple]:
    """Every decision, in order, that a run's (kinds, choices) makes
    otherwise than `want` (a recording_decisions of one rank's run of the
    same requests, on a model of `layers` MoE layers, so each forward
    records one router call a layer, in layer order) while the two runs
    still feed the model the same tokens: (index, kind, layer of a router
    call, row, one rank's margin there) for each differing row, up to and
    including the first sampling that differs; a "dispatch" entry where
    the runs stop making the same calls before that."""
    apart, run = [], 0
    for i, (kind, got) in enumerate(zip(kinds, choices)):
        if kind != want.kinds[i] or got.shape != want.choices[i].shape:
            return apart + [(i, "dispatch", None, None, None)]
        layer = run % layers if kind == "route" else None
        run = run + 1 if kind == "route" else 0
        rows = np.nonzero((got != want.choices[i]).any(-1))[0]
        apart += [(i, kind, layer, int(r), float(want.margins[i][r]))
                  for r in rows]
        if kind == "sample" and len(rows):
            break
    return apart


def near_ties(apart: list[tuple]) -> bool:
    """Whether decisions_apart's list is what rounding alone can do. The
    first layer's router input is the embedding and one attention, which
    no router decision feeds, so while the tokens agree every first-layer
    decision apart must be one rank's near tie (ROUTE_TIE); so must a
    later layer's until a first-layer one came apart (after it, a token's
    other expert moves the later layers' inputs); a sampled token apart
    must be a near tie of the logits (2 * LOGIT_TOL, phase 9's) unless a
    router decision came apart before it."""
    cascade = False
    for _, kind, layer, _, margin in apart:
        if kind == "dispatch":
            return False
        if kind == "route":
            if (layer == 0 or not cascade) and margin > ROUTE_TIE:
                return False
            cascade = cascade or layer == 0
        elif margin > 2 * LOGIT_TOL and not any(
                a[1] == "route" for a in apart):
            return False
    return True


def check_moe_tiny() -> dict[str, int]:
    """(a) `tiny-moe` in float32, card against CPU: greedy dense, greedy with
    int8 weights (attention and head on the float32 GEMV, the expert stacks
    on the grouped GEMV's float32 kernel, the CPU on its plain version, the
    mixed dot) and an int8 KV cache, and two prompts of 96 and 70 tokens
    prefilled together (256 tokens: the dispatch). Token ids must be
    identical. Returns the card's launch counts over the three runs'
    requests (each counted from 0 after its warmup)."""
    from symmetry_tpu_torch.models.llama import init_params, preset

    cfg = preset("tiny-moe")
    short = dict(prompt_lens=[5, 14, 27], buckets=(16, 32), max_seq_len=64)
    long = dict(prompt_lens=[96, 70], buckets=(128,), max_seq_len=192)
    counts: dict[str, int] = {}

    def ready():
        reset_launches()
        disp.reset()

    for label, int8, kw in (
            ("greedy", False, short),
            ("greedy, int8 weights + int8 KV", True, short),
            ("96- and 70-token prompts through the dispatch", False, long)):
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, quantize=int8)
        out, calls = [], []
        for device in ("cuda", "cpu"):
            with counting_dispatch() as disp:
                out.append(serve("tiny-moe", device=device,
                                 dtype=torch.float32, params=params,
                                 int8=int8, cfg=cfg, max_new=12, max_slots=2,
                                 decode_block=4, on_ready=ready,
                                 **kw)["requests"])
            calls.append(disp.calls)
            if device == "cuda":
                for key, n in read_launches().items():
                    counts[key] = counts.get(key, 0) + n
        card, cpu = out
        for r_card, r_cpu in zip(card, cpu):
            if (r_card["ids"], r_card["reason"]) != (r_cpu["ids"],
                                                     r_cpu["reason"]):
                raise AssertionError(f"tiny-moe {label}: card {r_card} != "
                                     f"cpu {r_cpu}")
        if kw is long and not calls[0] == calls[1] > 0:
            raise AssertionError(f"tiny-moe {label}: dispatch calls card/cpu "
                                 f"{calls}")
        log(f"  tiny-moe f32 {label}: {len(card)} requests, token ids "
            f"identical card vs CPU: {[r['ids'][:6] for r in card]}...; "
            f"dispatch calls card/cpu {calls}")
    log(f"  tiny-moe card launches {counts}")
    if min(counts["flash_prefill"], counts["decode_attention_append"],
           counts["w8a16_gemv_f32"], counts["moe_gemv"]) <= 0 or counts[
               "kv_append"]:
        raise AssertionError(f"tiny-moe launches {counts}")
    return counts


def check_moe_serve(smi: str, *, int8: bool) -> dict[str, int]:
    """(b) int8: mixtral-8x7b at full width and all 32 layers, int8 weights
    from init_params(quantize=True) with seed 0 packed for the W8A16 kernel
    (the expert stacks reported flat: the grouped expert GEMV at decode and
    in a dispatch of at most 64 rows an expert, the float32 copy and matmul
    in a larger one) and an int8 KV cache; (c) bf16 at full width, depth cut
    to MOE_BF16_LAYERS. Phase 5's traffic (8 slots, capacity 4096, buckets
    128/512/2048) with MOE_NEW new tokens, through serve() and the
    Scheduler; launch counts checked per kernel and regime, every prefill
    through the dispatch; the same requests again on the same engine give
    the same tokens. int8 also profiles one decode block and one 2048-token
    prefill. Returns the launch counts of the serving run."""
    import dataclasses

    from symmetry_tpu_torch.engine.engine import SamplingParams
    from symmetry_tpu_torch.models.llama import (
        init_params,
        pack_params,
        preset,
    )

    cfg = preset("mixtral-8x7b")
    if not int8:
        cfg = dataclasses.replace(cfg, num_layers=MOE_BF16_LAYERS)
    label = (f"mixtral-8x7b int8 (W8A16 attention + head, int8 KV), "
             f"{cfg.num_layers} layers" if int8 else
             f"mixtral-8x7b bf16, {cfg.num_layers} of 32 layers")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.bfloat16, quantize=int8)
    torch.cuda.synchronize()
    log(f"  {label}: weights drawn in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card")
    if int8:
        report: list = []
        pack_params(params, report=report)
        if sorted(report) != MOE_EXPERT_LEAVES:
            raise AssertionError(f"pack_tree report {report}: not exactly "
                                 f"the three expert stacks")
        log(f"  pack_tree report (leaves left flat: the expert stacks, for "
            f"the grouped expert GEMV): {report}")

    def ready():
        reset_launches()
        disp.reset()

    with counting_dispatch() as disp:
        res = serve("mixtral-8x7b", device="cuda", dtype=torch.bfloat16,
                    prompt_lens=PHASE5_PROMPTS, max_new=MOE_NEW, max_slots=8,
                    max_seq_len=4096, buckets=(128, 512, 2048),
                    decode_block=8, params=params, int8=int8, cfg=cfg,
                    on_ready=ready)
    del params
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    m = res["metrics"]
    L, steps, dispatches = cfg.num_layers, m["steps"], m["admit_dispatches"]
    log(f"  {label}: launches {counts}; admit_dispatches={dispatches} "
        f"steps={steps} tokens={m['tokens']}; dispatch calls {disp.calls} "
        f"(grouped GEMV launches inside them {disp.gemv_launches})")
    reasons = [(r["reason"], r["generated"]) for r in res["requests"]]
    log(f"  {label}: finish reasons {reasons}")
    for i, r in enumerate(res["requests"]):
        if r["reason"] != "length" or r["generated"] != MOE_NEW:
            raise AssertionError(f"request {i}: {r['reason']} after "
                                 f"{r['generated']} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r["ids"]):
            raise AssertionError(f"request {i}: token id out of range")
    want = {"flash_prefill": L * dispatches,
            "flash_tensor_core": L * dispatches, "flash_fma": 0,
            "decode_attention": L * steps,
            "decode_attention_append": L * steps, "kv_append": 0,
            # wq, wk, wv, wo per layer and the LM head, per forward
            "w8a16_matmul": (4 * L + 1) * (steps + dispatches) if int8 else 0,
            "w8a16_gemv_f32": 0,
            # wg, wu, wd per layer and decode step, and those of the
            # dispatches whose capacity is at most 64 rows an expert
            "moe_gemv": (3 * L * steps + disp.gemv_launches) if int8 else 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"launches {got} != {want}")
    if int8 and min(counts["w8a16_gemv"], counts["w8a16_tc"]) <= 0:
        raise AssertionError(f"W8A16 regimes {counts}: the GEMV at decode "
                             f"and the tensor-core kernel at prefill")
    # every prompt is >= 60 tokens in a bucket >= 128: each prefill layer
    # dispatches; decode takes the dense mixture
    if disp.gemv_launches % 3 or disp.calls != L * dispatches:
        raise AssertionError(f"dispatch calls {disp.calls} != "
                             f"{L * dispatches}, or grouped GEMV launches "
                             f"inside them {disp.gemv_launches} not 3 a "
                             f"call")
    ids = [r["ids"] for r in res["requests"]]
    digest = hashlib.sha256(json.dumps(ids).encode()).hexdigest()[:16]
    engine = res["engine"]
    # The same requests again on the same engine: a padded prefill batch
    # (3 prompts in the 512 bucket's batch of 4) replays its last request
    # into that slot, and under capacity dispatch the pad row differs from
    # it; the engine installs the last row, never a racing mix.
    again = [r["ids"] for r in schedule(engine, res["prompts"],
                                        MOE_NEW)["requests"]]
    log(f"  {label} greedy streams sha256 {digest}; served again on the "
        f"same engine: {'identical' if again == ids else 'DIFFERENT'}")
    if again != ids:
        raise AssertionError(f"{label}: a second serve of the same requests "
                             f"gave other tokens")
    ttft = [r["ttft_s"] for r in res["requests"]]
    log(f"  {label} on {smi}: {len(ttft)} requests x {MOE_NEW} tokens; "
        f"TTFT p50 "
        f"{statistics.median(ttft):.4f} s (max {max(ttft):.4f} s); "
        f"aggregate decode {res['decode_tok_s']:.2f} tok/s; wall "
        f"{res['wall_s']:.3f} s; max_memory_allocated {peak / 2**30:.3f} "
        f"GiB ({peak / 1e9:.3f} GB); weight_stream_bytes "
        f"{engine.weight_stream_bytes()} ({engine.weight_stream_bytes() / 1e9:.3f} GB)")
    if int8:
        rows = profile_dispatch(f"{label} decode block ({engine.decode_block} "
                                f"steps x 8 slots)", engine.decode_steps)
        busy = sum(r[0] for r in rows)
        log(f"  {label} decode step: device busy "
            f"{busy / engine.decode_block:.3f} ms a step (the block's wall "
            f"above over {engine.decode_block})")
        prompt = list(range(1000, 3048))
        profile_dispatch(f"{label} prefill 2048 tokens (bucket 2048, "
                         f"batch 1)",
                         lambda: engine.prefill_and_insert(
                             0, prompt, SamplingParams()))
        log(f"  {label}: max_memory_allocated with the profiles "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return counts


def check_moe_layer() -> None:
    """(d) One mixtral-8x7b layer's weights in bf16 on the card, a
    2048-token input: the dispatch at no-drop capacity (capacity factor
    X / k: every pair kept) against the dense mixture (the same tokens as
    2048 single-position rows), within TOL of the largest output; the
    tokens whose top-2 differs between the two paths' router products
    (expected 0: one product); each path's device time."""
    import dataclasses

    from symmetry_tpu_torch.models import moe
    from symmetry_tpu_torch.models.llama import init_params, preset

    base = preset("mixtral-8x7b")
    cfg = dataclasses.replace(
        base, num_layers=1,
        moe_capacity_factor=base.num_experts / base.num_experts_per_tok)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, torch.bfloat16)
    lp = {k: v[0] for k, v in params["layers"].items()}
    del params
    T, E = 2048, cfg.hidden_size
    x = torch.randn((1, T, E), generator=gen, device="cuda",
                    dtype=torch.bfloat16)

    def dispatch():
        return moe.moe_mlp_dispatch(x, lp, cfg)

    def dense():
        return moe.moe_mlp(x.reshape(T, 1, E), lp, cfg).reshape(1, T, E)

    got, want = dispatch().float(), dense().float()
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    sel_dispatch = moe.top_k(moe.router_logits(x.reshape(T, E),
                                                lp["router"]), 2)[1]
    sel_dense = moe.top_k(moe.router_logits(x.reshape(T, 1, E),
                                             lp["router"]), 2)[1]
    differ = int((sel_dispatch != sel_dense.reshape(T, 2)).any(-1).sum())
    ms_dispatch, ms_dense = device_ms(dispatch, 3), device_ms(dense, 3)
    log(f"  one mixtral layer, {T} tokens bf16: dispatch (no-drop) vs dense "
        f"mixture max abs err {err:.4g} (largest output {top:.4g}, bound "
        f"{TOL * top:.4g}); tokens whose top-2 differs {differ}; device ms "
        f"dispatch {ms_dispatch:.3f}, dense mixture {ms_dense:.3f}")
    if not (np.isfinite(err) and err <= TOL * top):
        raise AssertionError(f"dispatch vs dense mixture: {err} > "
                             f"{TOL * top}")
    if differ:
        raise AssertionError(f"{differ} tokens route differently between "
                             f"the two paths")


# Calls of the decode step's expert products under load in (d).
MOE_LOAD_REPEATS = 200


def plain_moe_int8(x: torch.Tensor, lp: dict, cfg) -> torch.Tensor:
    """The mixture written plainly for int8 expert stacks: every expert on
    every token through ops/quant.py's mixed_dot (the whole float32 copy of
    the payload, the scale on the float32 product, the cast), the top-k
    gates from a stable descending sort, the combine summed in float32."""
    from symmetry_tpu_torch.ops.quant import mixed_dot

    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    k = cfg.num_experts_per_tok
    logits = (xf @ lp["router"]).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(vals[:, :k], dim=-1)
    gates = torch.zeros_like(logits).scatter_(1, idx[:, :k], probs).to(
        x.dtype)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        def proj(a, name):
            w = lp[name]
            return mixed_dot(a, w.q[e], w.scale[e])
        h = torch.nn.functional.silu(proj(xf, "wg")) * proj(xf, "wu")
        out += proj(h, "wd").float() * gates[:, e:e + 1].float()
    return out.to(x.dtype).reshape(shape)


def check_moe_layer_int8() -> None:
    """(d) int8: one mixtral-8x7b layer at full width with int8 expert
    stacks (init_params(quantize=True), seed 2), against plain_moe_int8 on
    the same inputs within TOL of the largest output: the dense mixture at
    decode (8 tokens) and the dispatch at no-drop capacity (2048 tokens);
    each path called again on the same inputs, bit-equal; the decode
    step's expert products (the grouped GEMV, `wg` and `wd` of all eight
    experts) give one result in MOE_LOAD_REPEATS + 1 calls under a second
    stream's load."""
    import dataclasses

    from symmetry_tpu_torch.models import moe
    from symmetry_tpu_torch.models.llama import init_params, preset

    base = preset("mixtral-8x7b")
    cfg = dataclasses.replace(
        base, num_layers=1,
        moe_capacity_factor=base.num_experts / base.num_experts_per_tok)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = init_params(cfg, gen, torch.bfloat16, quantize=True)
    lp = {k: type(v)(*(t[0] for t in v)) if isinstance(v, tuple) else v[0]
          for k, v in params["layers"].items()}
    del params
    E = cfg.hidden_size
    for label, shape in (("decode, dense mixture", (8, 1, E)),
                         ("2048-token dispatch, no drops", (1, 2048, E))):
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        got = moe.moe_mlp(x, lp, cfg)
        again = moe.moe_mlp(x, lp, cfg)
        want = plain_moe_int8(x, lp, cfg).float()
        err = (got.float() - want).abs().max().item()
        top = want.abs().max().item()
        log(f"  one mixtral layer, int8 experts, {label}: max abs err "
            f"{err:.4g} against the plain mixed-dot mixture (largest "
            f"output {top:.4g}, bound {TOL * top:.4g}); called again: "
            f"{'bit-equal' if torch.equal(got, again) else 'DIFFERS'}")
        if not (np.isfinite(err) and err <= TOL * top):
            raise AssertionError(f"int8 layer {label}: {err} > {TOL * top}")
        if not torch.equal(got, again):
            raise AssertionError(f"int8 layer {label}: two calls on the "
                                 f"same inputs differ")
    # The decode step's expert products run again and again while a second
    # stream keeps the card busy with matmuls of varied sizes, which
    # changes when each of the kernel's blocks runs. Its K splits are summed
    # in rank order and a stage of its ring always goes to one warpgroup,
    # so every call gives the idle call's bits.
    from symmetry_tpu_torch.ops.moe_gemv import moe_gemv

    side = torch.cuda.Stream()
    load = torch.randn((4096, 4096), generator=gen, device="cuda")
    for name, a in (("wg", torch.randn((1, 8, E), generator=gen,
                                       device="cuda", dtype=torch.bfloat16)),
                    ("wd", torch.randn((cfg.num_experts, 8,
                                        cfg.intermediate_size),
                                       generator=gen, device="cuda",
                                       dtype=torch.bfloat16))):
        w = lp[name]
        def bits() -> bytes:
            return moe_gemv(a, w.q, w.scale).view(torch.int16).cpu().numpy(
            ).tobytes()

        seen = {bits()}  # idle
        for i in range(MOE_LOAD_REPEATS):
            with torch.cuda.stream(side):
                for _ in range(1 + i % 3):
                    torch.matmul(load[:256 * (1 + i % 16)], load)
            seen.add(bits())
        torch.cuda.synchronize()
        log(f"  grouped expert GEMV {list(a.shape)} @ {list(w.q.shape)} "
            f"(`{name}`, bf16 rows) under a second stream's load: "
            f"{len(seen)} distinct results in {MOE_LOAD_REPEATS + 1} calls")
        if len(seen) != 1:
            raise AssertionError(f"grouped GEMV `{name}` under load: "
                                 f"{len(seen)} distinct results")


# The depth of (e)'s mixtral checkpoint: 2 of 32 layers (6.3 GB in bf16).
# It stays for phase 17, which removes it.
MOE_CKPT_LAYERS = 2
MOE_CKPT_DIR = os.path.join(OUT_DIR, "ckpt_mixtral")
# (e)'s allowance above the int8 engine's own bytes for the load's
# transients: one tensor read in bf16, its float32 copy and the quantizer's
# float32 temporaries (the largest is the [32000, 4096] LM head).
MOE_CKPT_SLACK = 2 * 2**30


def write_moe_checkpoint() -> tuple:
    """A mixtral-8x7b-width checkpoint (MOE_CKPT_LAYERS layers, bf16,
    random weights, seed 0) written to MOE_CKPT_DIR by the port's writer
    (2 shards); returns (config, the params written, their bytes)."""
    import dataclasses

    from symmetry_tpu_torch.engine import weights
    from symmetry_tpu_torch.models.llama import init_params, preset

    shutil.rmtree(MOE_CKPT_DIR, ignore_errors=True)
    cfg = dataclasses.replace(preset("mixtral-8x7b"),
                              num_layers=MOE_CKPT_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.bfloat16)
    dense = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    t0 = time.perf_counter()
    weights.save_checkpoint(MOE_CKPT_DIR, params, cfg, dtype=torch.bfloat16,
                            shards=2)
    log(f"  wrote a mixtral-8x7b-width checkpoint at {MOE_CKPT_LAYERS} "
        f"layers, {dense / 1e9:.3f} GB in bf16, in "
        f"{time.perf_counter() - t0:.3f} s")
    return cfg, params, dense


def check_moe_checkpoint(smi: str) -> None:
    """(e) The mixtral-8x7b-width checkpoint (write_moe_checkpoint) served
    through InferenceEngine.from_tpu_config with quantization: int8 and no
    warm cache: the cold load quantizes each tensor as it is read, so the
    card never holds the dense tree (mixtral-8x7b's is ~93.4 GB). The peak
    above what was allocated before must stay within the engine's own
    bytes plus MOE_CKPT_SLACK, and under the dense tree's size; the int8
    leaves must equal quantize_params of the tensors written, bit for
    bit. The checkpoint stays for phase 17."""
    from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                  SamplingParams)
    from symmetry_tpu_torch.models.llama import quantize_params
    from symmetry_tpu_torch.provider.config import TpuConfig

    ckpt = MOE_CKPT_DIR
    try:
        cfg, params, dense = write_moe_checkpoint()
        want = quantize_params(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = InferenceEngine.from_tpu_config(TpuConfig.from_dict({
            "checkpoint_path": ckpt, "quantization": "int8",
            "warm_cache": False, "max_batch_size": 1, "max_seq_len": 256,
            "prefill_buckets": [128]}), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        tree = sum(t.numel() * t.element_size()
                   for t in tree_leaves(engine.params))
        log(f"  (e) from_tpu_config (quantization: int8, cold, no warm "
            f"cache) in {load_s:.3f} s on {smi}: peak above the start "
            f"{peak / 1e9:.3f} GB; the engine holds {held / 1e9:.3f} GB "
            f"(int8 tree {tree / 1e9:.3f} GB); the dense tree would be "
            f"{dense / 1e9:.3f} GB")
        if peak > held + MOE_CKPT_SLACK or peak >= dense:
            raise AssertionError(f"quantize-on-load peak {peak} > the "
                                 f"engine's {held} + {MOE_CKPT_SLACK}, or "
                                 f">= the dense tree's {dense}")
        n = assert_bit_equal(engine.params, want, "int8 load")
        first = engine.prefill_and_insert(0, list(range(100, 200)),
                                          SamplingParams())
        if not 0 <= first < cfg.vocab_size:
            raise AssertionError(f"first token {first}")
        log(f"  (e) {n} tensors bit-equal to quantize_params of the "
            f"tensors written; a 100-token prefill gives token {first}")
        del engine, want
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise
    finally:
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 14: tensor parallelism (parallel/), two ranks on the one card

TP = 2
# Both ranks on the one card, named exactly: init_distributed lays ranks
# out on a shared card only when each names it, and then chooses gloo (NCCL
# refuses two ranks on one device). Gloo's collectives on CUDA tensors go
# through host memory, so phase 14's times are not times of TP on NVLink.
TP_DEVICES = ["cuda:0", "cuda:0"]
TP_TIMEOUT = 900.0
TP_F32_TOL = 1e-4    # float32 logits, TP=2 on the card against one CPU rank
# New tokens a chat in (b)-(c), one decode block of 8 steps, and the chats:
# phase 11's three distinct ones. Two ranks time-slice one card and every
# decode step pays its collectives through host memory (~175 ms a step at
# 8 layers), so phase 11's 32 tokens over five chats would not fit the
# phase's time budget.
TP_NEW = 8
TP_DECODE_BLOCK = 8
# (a): tiny in float32, phase 4's geometry and prompts.
TP_TINY = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16, 32),
               decode_block=4, cache_dtype=torch.float32)
TP_TINY_LENS = [5, 14, 27]


def tp_section(int8: bool) -> dict:
    """Phase 14's `tpu:` section: the provider's defaults, phase 10's
    checkpoint, the model axis at 2, and no prefix cache, so that a repeat
    serve runs the same path as the first (a cached serve takes another
    path, where bf16 logits tie differently: phase 11)."""
    return {**TIERS_MODEL, "mesh": {"model": TP},
            "decode_block": TP_DECODE_BLOCK,
            **({"quantization": "int8", "kv_quantization": "int8",
                "fused_dequant": True} if int8 else {})}


def tp_contents() -> list[str]:
    """Phase 11's three distinct chats (60, 700 and 1880 tokens), its seed
    and lengths."""
    from symmetry_tpu_torch.engine.tokenizer import get_tokenizer

    tok = get_tokenizer(None, vocab_size=128256)
    head = len(tok.apply_chat_template([{"role": "user", "content": ""}]))
    rng = np.random.default_rng(11)
    return [chat_content(rng, n - head) for n in DISAGG_LENS]


def tp_counts() -> dict[str, int]:
    from symmetry_tpu_torch.ops.decode_attention import decode_attention
    from symmetry_tpu_torch.ops.flash import flash_prefill
    from symmetry_tpu_torch.ops.kv_append import kv_append
    from symmetry_tpu_torch.ops.moe_gemv import moe_gemv
    from symmetry_tpu_torch.ops.qmm import w8a16_matmul

    return {"flash_prefill": flash_prefill.launches,
            "decode_attention": decode_attention.launches,
            "decode_attention_append": decode_attention.launches_append,
            "kv_append": kv_append.launches,
            "w8a16_gemv": w8a16_matmul.launches_gemv,
            "w8a16_gemv_f32": w8a16_matmul.launches_gemv_f32,
            "w8a16_tc": w8a16_matmul.launches_tc,
            "moe_gemv": moe_gemv.launches}


def tp_job(mesh, rank: int, job: dict) -> dict:
    """One engine on this rank: the first step's logits (a prefill of the
    first prompt, run directly by every rank), then warmup and two serves
    of the prompts one at a time, led by rank 0's Scheduler through the
    command loop. Every rank records what its own engine produced at each
    command; the launch counts are set to 0 after warmup and read after
    the serves, on every rank."""
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.models.llama import (init_cache, init_params,
                                                 logits_from_hidden, preset)
    from symmetry_tpu_torch.parallel.multihost import (
        CMD_CHUNK_ADVANCE, CMD_DECODE, CMD_PREFILL, CMD_PREFILL_MANY,
        CMD_WARMUP, CommandLoop, MultihostEngine)
    from symmetry_tpu_torch.provider.config import TpuConfig

    t0 = time.monotonic()
    fallbacks0 = stage_fallbacks()
    if job["model"] in ("tiny", "tiny-moe"):
        cfg = preset(job["model"])
        params = init_params(cfg, torch.Generator(
            device=mesh.device).manual_seed(0), torch.float32,
            quantize=job["int8"], mesh=mesh)
        engine = InferenceEngine(cfg, params, id_tokenizer(cfg.vocab_size),
                                 mesh=mesh, device=mesh.device,
                                 kv_quant=job["int8"],
                                 fused_dequant=job["int8"],
                                 **{**TP_TINY, **job.get("geometry", {})})
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in job.get("lens", TP_TINY_LENS)]
        depth = 2
    else:
        tpu = TpuConfig.from_dict(job["tpu"])
        engine = InferenceEngine.from_tpu_config(tpu, device=mesh.device)
        cfg = engine.config
        prompts = [engine.tokenizer.apply_chat_template(
            [{"role": "user", "content": c}]) for c in job["contents"]]
        if job.get("id_text"):
            # the stream's text carries the token ids, one character each
            engine.tokenizer = id_tokenizer(cfg.vocab_size)
        depth = tpu.pipeline_depth
    t_build = time.monotonic() - t0
    ids = torch.tensor([prompts[0]], device=mesh.device)
    cache = init_cache(cfg, 1, ids.shape[1], engine.cache_dtype,
                       quantized=engine.kv_quant, device=mesh.device,
                       mesh=mesh)
    # the engine's trunk: the pipeline schedule under a stage axis
    h, _ = engine.trunk(ids, cache, prefill_flash=True)
    logits = logits_from_hidden(engine.params, cfg, h[:, -1:], mesh)[0, 0]
    del h, cache
    if rank == 0:
        np.save(os.path.join(OUT_DIR, f"tp_{job['name']}_logits.npy"),
                logits.float().cpu().numpy())

    loop = CommandLoop(engine, is_coordinator=rank == 0)
    recorded: list = []
    run = loop._execute

    def execute(cmd):
        out = run(cmd)
        if cmd.kind == CMD_WARMUP:
            torch.cuda.synchronize()
            reset_launches()
        elif cmd.kind in (CMD_PREFILL, CMD_PREFILL_MANY) or (
                cmd.kind == CMD_CHUNK_ADVANCE and out is not None):
            recorded.append(np.atleast_1d(out).tolist())
        elif cmd.kind == CMD_DECODE:
            recorded.append(np.asarray(out).ravel().tolist())
        return out

    loop._execute = execute
    out = {"build_s": t_build, "backend": mesh.backend,
           "device": str(mesh.device)}
    if rank == 0:
        facade = MultihostEngine(loop)
        t1 = time.monotonic()
        facade.warmup()
        out["warmup_s"] = time.monotonic() - t1
        out["texts"], out["serve_s"] = [], []
        serve = serve_together if job.get("together") else serve_in_turn
        with (recording_decisions() if job.get("decisions")
              else contextlib.nullcontext()) as decisions:
            for _ in range(job.get("serves", 2)):
                t1 = time.monotonic()
                out["texts"].append(serve(facade, prompts, job["new"], depth,
                                          **job.get("serve", {})))
                out["serve_s"].append(time.monotonic() - t1)
        if job.get("decisions"):
            decisions.save(os.path.join(OUT_DIR,
                                        f"tp_{job['name']}_decisions.npz"))
        torch.cuda.synchronize()
        out["counts"] = tp_counts()
        loop.stop()
    else:
        loop.follow_forever()
        torch.cuda.synchronize()
        out["counts"] = tp_counts()
    out["recorded"] = recorded
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(engine.params))
    out["layer_bytes"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(engine.params["layers"]))
    out["expert_bytes"] = expert_bytes(engine.params)
    out["stage_axis_fallbacks"] = stage_fallbacks() - fallbacks0
    out["stream_bytes"] = engine.weight_stream_bytes()
    out["stream_bytes_per_device"] = engine.weight_stream_bytes_per_device()
    out["kv_cache_bytes"] = engine.kv_cache_bytes()
    out["slot_block"] = list(engine.slot_block)
    out["prompt_lens"] = [len(p) for p in prompts]
    return out


def expert_bytes(params: dict) -> int:
    """Bytes of an MoE tree's expert stacks (wg, wu, wd; int8 payloads and
    scales), 0 for a dense tree."""
    layers = params["layers"]
    if "router" not in layers:
        return 0
    return sum(t.numel() * t.element_size()
               for k in ("wg", "wu", "wd") for t in tree_leaves(layers[k]))


def stage_fallbacks() -> float:
    """QMM_FALLBACK{reason="stage_axis"} in this process so far: the int8
    leaves fused_dequant kept on the mixed dot under a stage axis."""
    from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

    return METRICS.counter(MetricName.QMM_FALLBACK, "",
                           labels=("reason",)).value(reason="stage_axis")


def tp_rank_main(spec_path: str, rank: int) -> int:
    """`python chip_smoke.py --tp-rank RANK SPEC`: one rank of phase 14,
    15, 16 or 17, on the spec's mesh (the model axis over every rank by
    default) or a job's own `mesh` (every rank builds the same meshes in
    job order)."""
    from symmetry_tpu_torch.parallel.mesh import MeshSpec
    from symmetry_tpu_torch.parallel.multihost import (build_multihost_mesh,
                                                       init_distributed)

    with open(spec_path) as fh:
        spec = json.load(fh)
    torch.backends.cuda.matmul.allow_tf32 = False
    world = len(spec["devices"])
    init_distributed(f"127.0.0.1:{spec['port']}", world, rank,
                     device=spec["devices"][rank])
    meshes: dict = {}

    def mesh_for(shape: dict):
        key = tuple(sorted(shape.items()))
        if key not in meshes:
            meshes[key] = build_multihost_mesh(MeshSpec.from_dict(shape))
            log(f"rank {rank}: mesh {meshes[key].describe()}")
        return meshes[key]

    default = spec.get("mesh") or {"model": world}
    mesh_for(default)
    results = {}
    for job in spec["jobs"]:
        run = {"ring": cp_ring_job, "ring_mesh": cp_mesh_job}.get(
            job["model"], tp_job)
        results[job["name"]] = run(mesh_for(job.get("mesh", default)), rank,
                                   job)
        # the job's engine (the loop and its recorder hold a cycle) goes
        # before the next one is built
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(OUT_DIR, f"{spec['tag']}.{rank}.json"),
              "w") as fh:
        json.dump(results, fh)
    return 0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def tp_spawn(tag: str, devices: list[str], jobs: list[dict],
             mesh: dict | None = None) -> list[dict]:
    """Run `jobs` on len(devices) rank processes, on `mesh` (the model
    axis over all of them by default); every rank's results. A rank that
    fails fails the phase, its log named."""
    os.makedirs(OUT_DIR, exist_ok=True)
    port = free_port()
    spec_path = os.path.join(OUT_DIR, f"{tag}.json")
    with open(spec_path, "w") as fh:
        json.dump({"tag": tag, "port": port, "devices": devices,
                   "jobs": jobs, "mesh": mesh}, fh)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    procs, logs = [], []
    for rank in range(len(devices)):
        logs.append(open(os.path.join(OUT_DIR, f"{tag}.{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-rank",
             str(rank), spec_path], cwd=ROOT, env=env,
            stdin=subprocess.DEVNULL, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TP_TIMEOUT
    try:
        for rank, proc in enumerate(procs):
            rc = proc.wait(max(1.0, deadline - time.monotonic()))
            if rc != 0:
                raise AssertionError(f"{tag} rank {rank} exited rc={rc} "
                                     f"(log {logs[rank].name})")
    finally:
        for proc, fh in zip(procs, logs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
    out = []
    for rank in range(len(devices)):
        with open(os.path.join(OUT_DIR, f"{tag}.{rank}.json")) as fh:
            out.append(json.load(fh))
    return out


def tp_check_ranks(tag: str, name: str, ranks: list[dict]) -> None:
    """Every rank produced the same tokens at every command, a repeat
    serve streamed the first's text, and each rank launched every kernel
    the same number of times."""
    rec = [r[name]["recorded"] for r in ranks]
    if not rec[0] or any(r != rec[0] for r in rec):
        raise AssertionError(f"{tag} {name}: ranks recorded different "
                             f"tokens")
    texts = ranks[0][name]["texts"]
    if len(texts) > 1 and texts[0] != texts[1]:
        raise AssertionError(f"{tag} {name}: the repeat serve's text "
                             f"differs from the first's")
    counts = [r[name]["counts"] for r in ranks]
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"{tag} {name}: launch counts differ by rank "
                             f"{counts}")
    log(f"  {tag} {name}: {len(rec[0])} commands, tokens equal on "
        f"{len(ranks)} ranks; {len(texts)} serve(s) equal; launches per "
        f"rank {counts[0]}")


def tp_reference_logits(int8: bool, prompt: list[int]) -> torch.Tensor:
    """One rank's (the whole model's) first-step logits on phase 10's
    checkpoint, as the serving engine holds it: the warm cache, int8
    leaves packed for fused_dequant."""
    from symmetry_tpu_torch.engine import weights
    from symmetry_tpu_torch.models.llama import (forward_hidden, init_cache,
                                                 logits_from_hidden,
                                                 pack_params)

    params, cfg = weights.load_warm_cache(CKPT_DIR, dtype=torch.bfloat16,
                                          quantize=int8, device="cuda")
    if int8:
        pack_params(params)
    ids = torch.tensor([prompt], device="cuda")
    cache = init_cache(cfg, 1, ids.shape[1], torch.bfloat16, quantized=int8,
                       device="cuda")
    h, _ = forward_hidden(params, cfg, ids, cache, prefill_flash=True)
    out = logits_from_hidden(params, cfg, h[:, -1:])[0, 0].float().cpu()
    ref_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    del params, h, cache
    torch.cuda.empty_cache()
    return out, ref_bytes


_TINY_REFS: dict = {}


def tp_tiny_reference(int8: bool, slots: int | None = None,
                      together: bool = False, fused: bool = True,
                      model: str = "tiny", geometry: dict | None = None,
                      lens: list[int] | None = None
                      ) -> tuple[list[str], torch.Tensor]:
    """`tiny` (or `model`) on one CPU rank from the same draws: the texts
    of a serve of the TP prompts (or `lens`) one at a time (or submitted
    together, over `slots` slots), and the first step's logits. int8
    weights are packed (fused_dequant) unless `fused` is off. Kept for the
    phases after."""
    geometry = {**(geometry or {}), **({"max_slots": slots} if slots
                                       else {})}
    lens = lens or TP_TINY_LENS
    key = (int8, together, fused, model, repr(sorted(geometry.items())),
           tuple(lens))
    if key not in _TINY_REFS:
        _TINY_REFS[key] = _tiny_reference(int8, together, fused, model,
                                          geometry, lens)
    return _TINY_REFS[key]


def _tiny_reference(int8, together, fused, model, geometry, lens):
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.models.llama import (forward_hidden, init_cache,
                                                 init_params,
                                                 logits_from_hidden, preset)

    cfg = preset(model)
    # drawn on the card, as the ranks draw them; the engine moves them
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32, quantize=int8)
    engine = InferenceEngine(cfg, params, id_tokenizer(cfg.vocab_size),
                             device="cpu", kv_quant=int8,
                             fused_dequant=int8 and fused,
                             **{**TP_TINY, **geometry})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    ids = torch.tensor([prompts[0]])
    cache = init_cache(cfg, 1, ids.shape[1], torch.float32, quantized=int8,
                       device="cpu")
    h, _ = forward_hidden(engine.params, cfg, ids, cache, prefill_flash=True)
    logits = logits_from_hidden(engine.params, cfg, h[:, -1:])[0, 0]
    engine.warmup()
    serve = serve_together if together else serve_in_turn
    return serve(engine, prompts, 12, 2), logits


async def tp_provider(contents: list[str]) -> dict:
    """(c): the port's provider as rank 0 (its engine host joins a
    `tpu.multihost` job of 2 processes) and `python -m
    symmetry_tpu_torch.provider --worker` as rank 1, both on the one card,
    serving (b)'s chats one at a time over TCP to the port's client; the
    text of each (check_tp holds it to (b)'s bf16 serve)."""
    import yaml

    from symmetry_tpu_torch.client.client import SymmetryClient
    from symmetry_tpu_torch.identity import Identity
    from symmetry_tpu_torch.server.broker import SymmetryServer
    from symmetry_tpu_torch.transport.tcp import TcpTransport

    mh = {"coordinator": f"127.0.0.1:{free_port()}", "num_processes": TP}
    section = tp_section(int8=False)
    label = "llama3-8b-tp2"
    wpath = os.path.join(OUT_DIR, "tp_worker.yaml")
    with open(wpath, "w") as fh:
        yaml.safe_dump({**PROVIDER, "modelName": label, "tpu": {
            **section, "multihost": {**mh, "process_id": 1}}}, fh)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    wlog = open(os.path.join(OUT_DIR, "tp_worker.log"), "w")
    worker = subprocess.Popen(
        [sys.executable, "-m", "symmetry_tpu_torch.provider", "-c", wpath,
         "--worker", "--device", TP_DEVICES[1]], cwd=ROOT, env=env,
        stdin=subprocess.DEVNULL, stdout=wlog, stderr=subprocess.STDOUT)
    server = SymmetryServer(Identity.from_name("chip-smoke-tp-server"),
                            TcpTransport())
    await server.start("tcp://127.0.0.1:0")
    client = SymmetryClient(Identity.from_name("chip-smoke-tp-client"),
                            TcpTransport())
    prov = ProviderProc(label, {**section, "multihost": {
        **mh, "process_id": 0}}, server.address,
        server.identity.public_hex, device=TP_DEVICES[0])
    try:
        t_reg = await wait_registered(server, prov)
        details = await client.request_provider(
            server.address, server.identity.public_key, label)
        session = await client.connect(details)
        got = [await wire_chat(session, c, TP_NEW) for c in contents]
        stats = await session.stats()
        await session.close()
    finally:
        rc = prov.stop()
        await server.stop()
        try:
            wrc = worker.wait(120)
        finally:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
            wlog.close()
    if rc != 0 or wrc != 0:
        raise AssertionError(f"(c) provider rc={rc}, worker rc={wrc} (logs "
                             f"{prov.log_path}, {wlog.name})")
    mesh = (stats.get("engine") or {}).get("mesh")
    if not mesh or mesh.get("shape") != {"model": TP}:
        raise AssertionError(f"(c) the engine's stats show no mesh: {mesh}")
    return {"registered_s": t_reg, "mesh": mesh,
            "texts": [g["text"] for g in got],
            "first_text_s": [round(g["first"] - g["sent"], 4) for g in got]}


def check_tp(smi: str) -> dict[str, int]:
    """Phase 14. (a) `tiny` in float32 at TP=2, two ranks on the card,
    dense then int8 weights + int8 KV (the float32 GEMV row- and column-
    parallel): text equal to one CPU rank's, first-step logits within
    TP_F32_TOL. (b) llama3-8b's widths at CKPT_LAYERS layers from phase
    10's checkpoint, loaded sharded (warm caches), bf16 then int8 +
    kv_quant + fused_dequant, phase 11's three distinct chats one at a
    time through rank 0's Scheduler, twice: every rank's tokens equal, the
    repeat's text equal, the first step's logits within LOGIT_TOL of one
    rank's, each rank holding about half the weights, its peak memory
    under the whole model's weights. (c) the provider as rank 0 and `--worker` as rank 1,
    text equal to (b). Returns each kernel row's launches on rank 0 in
    (a)-(b), equal on every rank."""
    contents = tp_contents()
    jobs = [dict(name=f"tiny_{'int8' if i8 else 'f32'}", model="tiny",
                 int8=i8, new=12) for i8 in (False, True)]
    jobs += [dict(name=f"ckpt_{'int8' if i8 else 'bf16'}", model="ckpt",
                  tpu=tp_section(i8), contents=contents, new=TP_NEW)
             for i8 in (False, True)]
    # (c)'s two processes run beside (a)-(b)'s two ranks.
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        prov_run = pool.submit(asyncio.run, tp_provider(contents))
        ranks = tp_spawn("tp_gloo", TP_DEVICES, jobs)
        t_spawn = time.monotonic() - t0
        prov = prov_run.result()
    log(f"  two ranks on {TP_DEVICES} ran (a)-(b) in {t_spawn:.1f} s "
        f"(backend {ranks[0]['ckpt_bf16']['backend']}), (c)'s provider and "
        f"worker beside them, done in {time.monotonic() - t0:.1f} s")
    if any(r[j["name"]]["backend"] != "gloo" for r in ranks for j in jobs):
        raise AssertionError("two ranks on one card must run over gloo")
    for job in jobs:
        tp_check_ranks("gloo", job["name"], ranks)
    # (a) against one CPU rank
    for i8 in (False, True):
        name = f"tiny_{'int8' if i8 else 'f32'}"
        texts, logits = tp_tiny_reference(i8)
        got = ranks[0][name]
        if got["texts"][0] != texts:
            raise AssertionError(f"(a) {name}: TP=2 on the card "
                                 f"{got['texts'][0]} != one CPU rank "
                                 f"{texts}")
        tp_logits = torch.from_numpy(np.load(os.path.join(
            OUT_DIR, f"tp_{name}_logits.npy")))
        err = float((tp_logits - logits).abs().max())
        log(f"  (a) {name}: text equal to one CPU rank's; first-step "
            f"logits max_abs_err {err:.3e} (tol {TP_F32_TOL:.0e})")
        if err > TP_F32_TOL:
            raise AssertionError(f"(a) {name}: logits error {err}")
    if ranks[0]["tiny_int8"]["counts"]["w8a16_gemv_f32"] <= 0:
        raise AssertionError("(a) the float32 GEMV never launched at TP=2")
    # (b) against one rank on the same checkpoint
    from symmetry_tpu_torch.engine.tokenizer import get_tokenizer

    prompt = get_tokenizer(None, vocab_size=128256).apply_chat_template(
        [{"role": "user", "content": contents[0]}])
    for i8 in (False, True):
        name = f"ckpt_{'int8' if i8 else 'bf16'}"
        got = [r[name] for r in ranks]
        ref, ref_bytes = tp_reference_logits(i8, prompt)
        tp_logits = torch.from_numpy(np.load(os.path.join(
            OUT_DIR, f"tp_{name}_logits.npy")))
        err = float((tp_logits - ref).abs().max())
        half = [g["param_bytes"] / ref_bytes for g in got]
        stream = [g["stream_bytes_per_device"] / g["stream_bytes"]
                  for g in got]
        mem = [g["max_memory_allocated"] for g in got]
        g0 = got[0]
        log(f"  (b) {name}: prompt tokens {g0['prompt_lens']}; first-step "
            f"logits max_abs_err {err:.4f} (tol {LOGIT_TOL}); weights per "
            f"rank {[g['param_bytes'] / 1e9 for g in got]} GB of "
            f"{ref_bytes / 1e9:.3f} (shares {[round(h, 4) for h in half]}); "
            f"streamed per step per rank {g0['stream_bytes_per_device'] / 1e9:.3f} "
            f"GB of {g0['stream_bytes'] / 1e9:.3f}; max_memory_allocated per "
            f"rank {[round(m / 2**30, 3) for m in mem]} GiB; build "
            f"{g0['build_s']:.1f} s, warmup {g0['warmup_s']:.1f} s, serves "
            f"{[round(t, 1) for t in g0['serve_s']]} s (gloo through host "
            f"memory: not a speed of TP)")
        if err > LOGIT_TOL:
            raise AssertionError(f"(b) {name}: logits error {err}")
        if not all(0.49 < h < 0.51 for h in half + stream):
            raise AssertionError(f"(b) {name}: a rank holds {half} / "
                                 f"streams {stream} of the weights")
        if max(mem) >= ref_bytes:
            raise AssertionError(f"(b) {name}: a rank's peak {mem} is not "
                                 f"under the whole model's weights "
                                 f"{ref_bytes}")
    if torch.cuda.device_count() >= 2:
        nccl = tp_spawn("tp_nccl", ["cuda:0", "cuda:1"], [jobs[2]])
        if nccl[0]["ckpt_bf16"]["backend"] != "nccl":
            raise AssertionError("two cards must run over nccl")
        tp_check_ranks("nccl", "ckpt_bf16", nccl)
        log(f"  nccl pass on cuda:0, cuda:1: tokens equal on both ranks; "
            f"serves {[round(t, 1) for t in nccl[0]['ckpt_bf16']['serve_s']]}"
            f" s (gloo on one card: "
            f"{[round(t, 1) for t in ranks[0]['ckpt_bf16']['serve_s']]} s); "
            f"text equal to gloo's: "
            f"{nccl[0]['ckpt_bf16']['texts'] == ranks[0]['ckpt_bf16']['texts']}")
    else:
        log(f"  nccl pass not run: {torch.cuda.device_count()} card(s) on "
            f"this machine")
    # (c)
    for i, (g, w) in enumerate(zip(prov["texts"],
                                   ranks[0]["ckpt_bf16"]["texts"][0])):
        if g != w:
            raise AssertionError(f"(c) chat {i}: over the wire {g!r} != (b) "
                                 f"{w!r}")
    log(f"  (c) provider (rank 0) + --worker (rank 1): {len(contents)} chats "
        f"over TCP, text equal to (b); registered in "
        f"{prov['registered_s']:.1f} s; seconds to first text "
        f"{prov['first_text_s']}; engine stats mesh {prov['mesh']}")
    c = {name: ranks[0][name]["counts"] for name in
         ("tiny_int8", "ckpt_bf16", "ckpt_int8")}
    return {"flash_prefill": c["ckpt_bf16"]["flash_prefill"]
            + c["ckpt_int8"]["flash_prefill"],
            "decode_attention": c["ckpt_bf16"]["decode_attention"],
            "decode_attention_int8": c["ckpt_int8"]["decode_attention"],
            "kv_append_fused": c["ckpt_int8"]["decode_attention_append"],
            "w8a16_matmul[gemv]": c["ckpt_int8"]["w8a16_gemv"],
            "w8a16_matmul[gemv_f32]": c["tiny_int8"]["w8a16_gemv_f32"],
            "w8a16_matmul[tc]": c["ckpt_int8"]["w8a16_tc"],
            "kv_append": sum(r["kv_append"] for r in c.values()),
            "w8a8_matmul": 0,
            "moe_gemv": sum(r["moe_gemv"] for r in c.values())}


# ---------------------------------------------------------------------------
# Phase 15: the data axis (engine/engine.py), ranks on the one card

DP = 2
# Ranks share the one card over gloo, as in phase 14: the phase checks
# correctness and each rank's share of the memory, not the speed of data
# parallelism (two processes time-slice one card).
DP_DEVICES = ["cuda:0"] * DP
DP_TP_DEVICES = ["cuda:0"] * 4   # {data: 2, model: 2}
# Four slots in (a) and (b): over data=2 each rank owns two, and the four
# requests of (b), submitted together, hold both blocks.
DP_SLOTS = 4
DP_NEW = 8


def dp_section(int8: bool, mesh: bool = True) -> dict:
    """Phase 15(b)'s `tpu:` section: phase 14's (the provider's defaults,
    phase 10's checkpoint, decode block 8, no prefix cache) at four slots,
    the data axis at 2 (or one rank)."""
    section = {**tp_section(int8), "max_batch_size": DP_SLOTS}
    section.pop("mesh")
    return {**section, "mesh": {"data": DP}} if mesh else section


_DP_REFS: dict = {}


def dp_reference(int8: bool, contents: list[str], fused: bool = True
                 ) -> tuple:
    """One rank's serve of the chats, submitted together, on the same
    section without the mesh (int8 weights packed for fused_dequant unless
    `fused` is off): (texts, KV cache bytes, weight bytes, bytes of the
    stacked layers). Kept for the phases after."""
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.provider.config import TpuConfig

    key = (int8, fused, tuple(contents))
    if key in _DP_REFS:
        return _DP_REFS[key]
    section = dp_section(int8, mesh=False)
    if int8 and not fused:
        section["fused_dequant"] = False
    tpu = TpuConfig.from_dict(section)
    engine = InferenceEngine.from_tpu_config(tpu, device="cuda")
    engine.warmup()
    prompts = [engine.tokenizer.apply_chat_template(
        [{"role": "user", "content": c}]) for c in contents]
    texts = serve_together(engine, prompts, DP_NEW, tpu.pipeline_depth)
    out = (texts, engine.kv_cache_bytes(),
           sum(t.numel() * t.element_size()
               for t in tree_leaves(engine.params)),
           sum(t.numel() * t.element_size()
               for t in tree_leaves(engine.params["layers"])))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _DP_REFS[key] = out
    return out


def check_dp(smi: str) -> dict[str, int]:
    """Phase 15. (a) `tiny` in float32 at {data: 2}, dense then int8 +
    int8 KV, and dense at {data: 2, model: 2} on four ranks, the prompts
    submitted together over DP_SLOTS slots: text equal to one CPU rank's,
    first-step logits within TP_F32_TOL. (b) phase 10's checkpoint at
    {data: 2} (whole weights on each rank), bf16 then int8 + kv_quant +
    fused_dequant, phase 14's chats and a repeat of the first submitted
    together: text equal to one rank's serve, tokens and launches equal
    on both ranks, each rank's KV cache half of one rank's. Returns each
    kernel row's launches on rank 0 in (a)-(b) at {data: 2}."""
    contents = tp_contents()
    contents = contents + contents[:1]
    tiny = [dict(name=f"dp_tiny_{'int8' if i8 else 'f32'}", model="tiny",
                 int8=i8, new=12, geometry={"max_slots": DP_SLOTS},
                 together=True, serves=1) for i8 in (False, True)]
    jobs = tiny + [dict(name=f"dp_ckpt_{'int8' if i8 else 'bf16'}",
                        model="ckpt", tpu=dp_section(i8), contents=contents,
                        new=DP_NEW, together=True, serves=1)
                   for i8 in (False, True)]
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawns = [pool.submit(tp_spawn, "dp_gloo", DP_DEVICES, jobs,
                              mesh={"data": DP}),
                  pool.submit(tp_spawn, "dp_tp_gloo", DP_TP_DEVICES,
                              [dict(tiny[0], name="dp_tp_tiny_f32")],
                              mesh={"data": DP, "model": 2})]
        ranks, four = (f.result() for f in spawns)
    log(f"  two data ranks on {DP_DEVICES} ((a)-(b), backend "
        f"{ranks[0]['dp_ckpt_bf16']['backend']}) and four ranks {{data: 2, "
        f"model: 2}} on {DP_TP_DEVICES} ((a)), the two spawns together, in "
        f"{time.monotonic() - t0:.1f} s")
    for job in jobs:
        tp_check_ranks("dp", job["name"], ranks)
    tp_check_ranks("dp x tp", "dp_tp_tiny_f32", four)
    # (a) against one CPU rank
    for name, group, i8 in (("dp_tiny_f32", ranks, False),
                            ("dp_tiny_int8", ranks, True),
                            ("dp_tp_tiny_f32", four, False)):
        texts, logits = tp_tiny_reference(i8, slots=DP_SLOTS, together=True)
        if group[0][name]["texts"][0] != texts:
            raise AssertionError(f"(a) {name}: the mesh on the card "
                                 f"{group[0][name]['texts'][0]} != one CPU "
                                 f"rank {texts}")
        mesh_logits = torch.from_numpy(np.load(os.path.join(
            OUT_DIR, f"tp_{name}_logits.npy")))
        err = float((mesh_logits - logits).abs().max())
        log(f"  (a) {name}: text equal to one CPU rank's; first-step "
            f"logits max_abs_err {err:.3e} (tol {TP_F32_TOL:.0e}); slot "
            f"blocks {[r[name]['slot_block'] for r in group]}")
        if err > TP_F32_TOL:
            raise AssertionError(f"(a) {name}: logits error {err}")
    # (b) against one rank serving the same chats together
    for i8 in (False, True):
        name = f"dp_ckpt_{'int8' if i8 else 'bf16'}"
        got = [r[name] for r in ranks]
        t0 = time.monotonic()
        texts, ref_kv, ref_bytes, _ = dp_reference(i8, contents)
        t_ref = time.monotonic() - t0
        kv = [g["kv_cache_bytes"] / ref_kv for g in got]
        whole = [g["param_bytes"] / ref_bytes for g in got]
        mem = [g["max_memory_allocated"] for g in got]
        g0 = got[0]
        log(f"  (b) {name}: prompt tokens {g0['prompt_lens']}; slot blocks "
            f"{[g['slot_block'] for g in got]}; KV cache per rank "
            f"{[g['kv_cache_bytes'] / 1e9 for g in got]} GB of one rank's "
            f"{ref_kv / 1e9:.4f} (shares {kv}); weights per rank "
            f"{[g['param_bytes'] / 1e9 for g in got]} GB of "
            f"{ref_bytes / 1e9:.3f} (shares {[round(w, 4) for w in whole]});"
            f" streamed per step per rank "
            f"{g0['stream_bytes_per_device'] / 1e9:.3f} GB of "
            f"{g0['stream_bytes'] / 1e9:.3f}; max_memory_allocated per rank "
            f"{[round(m / 2**30, 3) for m in mem]} GiB; build "
            f"{g0['build_s']:.1f} s, warmup {g0['warmup_s']:.1f} s, serve "
            f"{[round(t, 1) for t in g0['serve_s']]} s (gloo on one card: "
            f"not a speed of data parallelism); one rank's serve and build "
            f"{t_ref:.1f} s")
        if g0["texts"][0] != texts:
            raise AssertionError(f"(b) {name}: data=2 {g0['texts'][0]!r} "
                                 f"!= one rank {texts!r}")
        if kv != [0.5] * DP:
            raise AssertionError(f"(b) {name}: KV cache shares {kv}, not "
                                 f"half of one rank's")
        if whole != [1.0] * DP or any(
                g["stream_bytes_per_device"] != g["stream_bytes"]
                for g in got):
            raise AssertionError(f"(b) {name}: a data rank holds {whole} "
                                 f"of the weights, not all of them")
        log(f"  (b) {name}: text equal to one rank's for "
            f"{len(contents)} chats")
    if torch.cuda.device_count() >= 2:
        nccl = tp_spawn("dp_nccl", ["cuda:0", "cuda:1"], [jobs[2]],
                        mesh={"data": DP})
        if nccl[0]["dp_ckpt_bf16"]["backend"] != "nccl":
            raise AssertionError("two cards must run over nccl")
        tp_check_ranks("dp nccl", "dp_ckpt_bf16", nccl)
        got, gloo = nccl[0]["dp_ckpt_bf16"], ranks[0]["dp_ckpt_bf16"]
        same = got["texts"] == gloo["texts"]
        log(f"  nccl pass on cuda:0, cuda:1: tokens equal on both ranks; "
            f"serve {[round(t, 1) for t in got['serve_s']]} s (gloo on one "
            f"card: {[round(t, 1) for t in gloo['serve_s']]} s); text equal "
            f"to gloo's: {same}")
        if not same:
            raise AssertionError("the nccl pass's text differs from gloo's")
    else:
        log(f"  nccl pass not run: {torch.cuda.device_count()} card(s) on "
            f"this machine")
    c = {name: ranks[0][name]["counts"] for name in
         ("dp_tiny_int8", "dp_ckpt_bf16", "dp_ckpt_int8")}
    return {"flash_prefill": c["dp_ckpt_bf16"]["flash_prefill"]
            + c["dp_ckpt_int8"]["flash_prefill"],
            "decode_attention": c["dp_ckpt_bf16"]["decode_attention"],
            "decode_attention_int8": c["dp_ckpt_int8"]["decode_attention"],
            "kv_append_fused": c["dp_ckpt_int8"]["decode_attention_append"],
            "w8a16_matmul[gemv]": c["dp_ckpt_int8"]["w8a16_gemv"],
            "w8a16_matmul[gemv_f32]": c["dp_tiny_int8"]["w8a16_gemv_f32"],
            "w8a16_matmul[tc]": c["dp_ckpt_int8"]["w8a16_tc"],
            "kv_append": sum(r["kv_append"] for r in c.values()),
            "w8a8_matmul": 0,
            "moe_gemv": sum(r["moe_gemv"] for r in c.values())}


# ---------------------------------------------------------------------------
# Phase 16: the stage and context axes (parallel/pipeline.py, ring.py,
# ulysses.py), ranks on the one card

PP = 2
CP = 2
# Ranks share the one card over gloo, as in phases 14-15: the phase checks
# correctness and each rank's share of the memory, not the speed of either
# axis (two processes time-slice one card; the stage-to-stage activations
# and the ring's K/V blocks go through host memory).
PP_DEVICES = ["cuda:0"] * PP
CP_DEVICES = ["cuda:0"] * CP
PP_MICRO = 2
# (c): forward_hidden with ring_mesh over a 4096-token bucket, two rows,
# against one rank's flash forward, bf16. Two implementations of one
# attention in bf16 (the flash kernel rounds P to bf16 on its tensor
# cores; the ring and Ulysses softmax in float32 and round P before the
# value product) differ by a few bf16 steps of the hidden states, which the
# final norm leaves at magnitude ~1-8: the bound is LOGIT_TOL's 0.25.
CP_SEQ = 4096
CP_LENS = [4096, 3000]
CP_TOL = 0.25
# (c) beside the model and data axes: the same bucket on four ranks, one
# spawn, each job on its own mesh. The decode step after the prefill
# writes row 0's position CP_SEQ, so those caches hold one more span of
# the decode kernel's 256 positions.
CP4_DEVICES = ["cuda:0"] * 4
CP_TP_MESH = {"context": CP, "model": 2}
CP_DP_MESH = {"data": 2, "context": CP}
CP_CAP = CP_SEQ + 256
CP_REF = os.path.join(OUT_DIR, "cp_mesh_reference.pt")
CP_REF_TIMEOUT = 300.0
# Rows no launch of (c)'s four-rank path reaches, and why.
CP_TP_REASON = {
    "flash_prefill": "0 by design: the ring and Ulysses replace the flash "
                     "kernel in a ring_mesh prefill, as in the JAX forward",
    "w8a16_matmul[gemv_f32]": "0: (c) serves bf16 activations only",
    "kv_append": "0: the decode launch writes the row (append mode)",
    "w8a8_matmul": "0: no serving path routes W8A8",
    "moe_gemv": "0: llama3-8b width, a dense model"}
# W8A16 launches at {stage: 2} are 0 by design, as in the JAX engine.
PP_W8A16_REASON = ("0 under the stage axis: fused_dequant keeps every int8 "
                   "leaf on the mixed dot (QMM_FALLBACK reason stage_axis), "
                   "as the JAX engine does")


def pp_section(int8: bool) -> dict:
    """Phase 16(b)'s `tpu:` section: phase 15's (the provider's defaults,
    phase 10's checkpoint, decode block 8, no prefix cache, 4 slots) at
    {stage: 2} with two microbatches."""
    return {**dp_section(int8, mesh=False), "mesh": {"stage": PP},
            "pipeline_microbatches": PP_MICRO}


def cp_section(int8: bool) -> dict:
    """Phase 16(c)'s engine section: phase 15's at {context: 2}."""
    return {**dp_section(int8, mesh=False), "mesh": {"context": CP}}


def cp_tokens(vocab_size: int, device) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """(c)'s inputs: B = 2 rows of a CP_SEQ bucket, their seq_lens
    CP_LENS, and one token a row for the decode step after them."""
    rng = np.random.default_rng(16)
    tokens = torch.from_numpy(rng.integers(0, vocab_size,
                                           (2, CP_SEQ))).to(device)
    step = torch.from_numpy(rng.integers(0, vocab_size, (2, 1))).to(device)
    lens = torch.tensor(CP_LENS, dtype=torch.int32, device=device)
    return tokens, lens, step


def cp_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The max abs difference of two [2, CP_SEQ, E] hidden states over the
    valid positions of each row."""
    return max(float((a[i, :n] - b[i, :n]).abs().max())
               for i, n in enumerate(CP_LENS))


def cp_ring_job(mesh, rank: int, job: dict) -> dict:
    """(c) on this rank of {context: 2}: phase 10's checkpoint whole (the
    context ranks are replicas), forward_hidden over B = 2 rows of a
    CP_SEQ bucket (seq_lens CP_LENS) by one rank's flash route, then with
    ring_mesh by the ring and by Ulysses; the max abs errors over the valid
    positions, and the seconds each took (two ranks on one card)."""
    from symmetry_tpu_torch.engine import weights
    from symmetry_tpu_torch.models.llama import forward_hidden, init_cache

    params, cfg = weights.load_warm_cache(CKPT_DIR, dtype=torch.bfloat16,
                                          quantize=False, device=mesh.device)
    tokens, lens, _ = cp_tokens(cfg.vocab_size, mesh.device)
    torch.cuda.reset_peak_memory_stats()

    def run(**kw):
        cache = init_cache(cfg, 2, CP_SEQ, torch.bfloat16,
                           device=mesh.device)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        h, _ = forward_hidden(params, cfg, tokens, cache, lens,
                              prefill_flash=True, **kw)
        torch.cuda.synchronize()
        return h.float(), time.monotonic() - t0

    ref, out = run()
    out = {"flash_s": out}
    hs = {}
    for mode in ("ring", "ulysses"):
        hs[mode], out[f"{mode}_s"] = run(ring_mesh=mesh, sp_mode=mode)
        out[f"{mode}_err"] = cp_err(hs[mode], ref)
        if not torch.isfinite(hs[mode]).all():
            raise AssertionError(f"(c) {mode}: non-finite hidden states")
    out["ring_ulysses_err"] = cp_err(hs["ring"], hs["ulysses"])
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def cp_prefill_decode(params, cfg, int8: bool, device, mesh=None, **ring
                      ) -> dict:
    """(c)'s path on one rank or a mesh rank: forward_hidden over the
    bucket (the flash route, or with ring_mesh and sp_mode in `ring`), then
    one decode step from the cache it wrote. Returns the hidden states
    [2, CP_SEQ, E] (bf16), the step's logits [2, V] (float32, whole on a
    mesh), the cache's bytes and the prefill's seconds."""
    from symmetry_tpu_torch.models.llama import (forward_hidden, init_cache,
                                                 logits_from_hidden)

    tokens, lens, step = cp_tokens(cfg.vocab_size, device)
    cache = init_cache(cfg, 2, CP_CAP, torch.bfloat16, quantized=int8,
                       device=device, mesh=mesh)
    kv_bytes = sum(t.numel() * t.element_size() for t in cache
                   if t is not None and t.dim() > 1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    h, cache = forward_hidden(params, cfg, tokens, cache, lens,
                              prefill_flash=True, mesh=mesh, **ring)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    hs, cache = forward_hidden(params, cfg, step, cache, mesh=mesh)
    logits = logits_from_hidden(params, cfg, hs, mesh)[:, 0]
    if cache.lengths.tolist() != [n + 1 for n in CP_LENS]:
        raise AssertionError(f"(c) lengths {cache.lengths.tolist()} after "
                             f"the decode step")
    return {"h": h, "logits": logits, "kv_bytes": kv_bytes, "s": secs}


def cp_load(int8: bool, mesh=None, device="cuda") -> tuple[dict, object]:
    """Phase 10's checkpoint from its warm cache as the engine serves it
    (int8: packed for fused_dequant), whole or this rank's blocks of
    `mesh`."""
    from symmetry_tpu_torch.engine import weights
    from symmetry_tpu_torch.models.llama import pack_params

    params, cfg = weights.load_warm_cache(CKPT_DIR, dtype=torch.bfloat16,
                                          quantize=int8, mesh=mesh,
                                          device=device)
    if int8:
        pack_params(params, config=cfg, mesh=mesh)
    return params, cfg


def cp_mesh_reference() -> dict:
    """One rank's (the whole model's) run of (c)'s path by the flash
    route, bf16 and int8 (+ kv_quant, fused_dequant): written to CP_REF
    for the four ranks (hidden states and the step's logits); returns the
    weight and KV bytes of each and the seconds it took."""
    t0 = time.monotonic()
    refs, sizes = {}, {}
    for int8 in (False, True):
        params, cfg = cp_load(int8)
        got = cp_prefill_decode(params, cfg, int8, "cuda")
        key = "int8" if int8 else "bf16"
        refs[key] = {"h": got["h"].cpu(), "logits": got["logits"].cpu()}
        sizes[key] = {"kv_bytes": got["kv_bytes"], "param_bytes": sum(
            t.numel() * t.element_size() for t in tree_leaves(params))}
        del params, got
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(refs, CP_REF + ".part")
    os.replace(CP_REF + ".part", CP_REF)
    return {**sizes, "s": time.monotonic() - t0}


def cp_mesh_job(mesh, rank: int, job: dict) -> dict:
    """(c) on this rank of a four-rank mesh ({context: 2, model: 2} or
    {data: 2, context: 2}): phase 10's checkpoint loaded as this rank's
    blocks, then the path of cp_prefill_decode with ring_mesh, by the ring
    and by Ulysses, against one rank's flash run (CP_REF, which the parent
    writes while the ranks start): the hidden states' max abs errors over
    the valid positions, ring against Ulysses, the decode step's logits',
    a digest of the hidden states (replicas compare them), the launches
    (set to 0 after the load), the bytes and the seconds."""
    t0 = time.monotonic()
    params, cfg = cp_load(job["int8"], mesh, mesh.device)
    t_load = time.monotonic() - t0
    deadline = time.monotonic() + CP_REF_TIMEOUT
    while not os.path.exists(CP_REF):
        if time.monotonic() > deadline:
            raise AssertionError(f"no reference at {CP_REF}")
        time.sleep(0.5)
    ref = torch.load(CP_REF)["int8" if job["int8"] else "bf16"]
    ref_h = ref["h"].to(mesh.device).float()
    torch.cuda.synchronize()
    reset_launches()
    out = {"load_s": t_load, "backend": mesh.backend}
    hs = {}
    for mode in ("ring", "ulysses"):
        got = cp_prefill_decode(params, cfg, job["int8"], mesh.device,
                                mesh=mesh, ring_mesh=mesh, sp_mode=mode)
        hs[mode] = got["h"].float()
        if not torch.isfinite(hs[mode]).all():
            raise AssertionError(f"(c) {mode}: non-finite hidden states")
        out[f"{mode}_err"] = cp_err(hs[mode], ref_h)
        out[f"{mode}_logit_err"] = float(
            (got["logits"].cpu() - ref["logits"]).abs().max())
        out[f"{mode}_digest"] = hashlib.sha256(
            got["h"].contiguous().view(torch.uint8).cpu().numpy()
        ).hexdigest()
        out[f"{mode}_s"] = got["s"]
        out["kv_bytes"] = got["kv_bytes"]
    out["ring_ulysses_err"] = cp_err(hs["ring"], hs["ulysses"])
    torch.cuda.synchronize()
    out["counts"] = tp_counts()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(params))
    out["seconds"] = time.monotonic() - t0
    return out


def cp_mesh_check(ranks: list[dict], refs: dict, shapes: dict) -> None:
    """(c)'s four-rank rows against one rank's: hidden states within CP_TOL
    by the ring and by Ulysses and of each other, the decode step's
    logits within LOGIT_TOL, launches equal on every rank and the ones
    the path makes non-zero; at {context: 2, model: 2} each rank's KV
    cache and weights half of one rank's, at {data: 2, context: 2} whole
    and the hidden states equal on both data replicas."""
    from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec

    for name, shape in shapes.items():
        got = [r[name] for r in ranks]
        key = "int8" if name.endswith("int8") else "bf16"
        kv = [g["kv_bytes"] / refs[key]["kv_bytes"] for g in got]
        weights_share = [g["param_bytes"] / refs[key]["param_bytes"]
                         for g in got]
        for rank, g in enumerate(got):
            log(f"  (c) {name} rank {rank}: B=2 x {CP_SEQ} (seq_lens "
                f"{CP_LENS}) hidden states against one rank's flash "
                f"forward: ring max_abs_err {g['ring_err']:.4f}, ulysses "
                f"{g['ulysses_err']:.4f}, ring vs ulysses "
                f"{g['ring_ulysses_err']:.4f} (bound {CP_TOL}); the decode "
                f"step's logits after the ring {g['ring_logit_err']:.4f}, "
                f"after Ulysses {g['ulysses_logit_err']:.4f} (bound "
                f"{LOGIT_TOL}); KV cache {g['kv_bytes']} B of one rank's "
                f"{refs[key]['kv_bytes']} (share {kv[rank]:.4f}); weights "
                f"{g['param_bytes']} B of {refs[key]['param_bytes']} "
                f"(share {weights_share[rank]:.4f}); max_memory_allocated "
                f"{g['max_memory_allocated'] / 2**30:.3f} GiB; seconds: "
                f"load {g['load_s']:.1f}, ring prefill {g['ring_s']:.3f}, "
                f"ulysses {g['ulysses_s']:.3f}, job {g['seconds']:.1f} "
                f"({g['backend']}; four ranks on one card: not a speed of "
                f"either scheme); launches {g['counts']}")
            if max(g["ring_err"], g["ulysses_err"],
                   g["ring_ulysses_err"]) > CP_TOL:
                raise AssertionError(f"(c) {name} rank {rank}: hidden "
                                     f"states beyond {CP_TOL}")
            if max(g["ring_logit_err"], g["ulysses_logit_err"]) > LOGIT_TOL:
                raise AssertionError(f"(c) {name} rank {rank}: decode "
                                     f"logits beyond {LOGIT_TOL}")
        if any(g["counts"] != got[0]["counts"] for g in got):
            raise AssertionError(f"(c) {name}: launches differ by rank "
                                 f"{[g['counts'] for g in got]}")
        c = got[0]["counts"]
        want = (("w8a16_tc", "w8a16_gemv", "decode_attention_append")
                if key == "int8" else ()) + ("decode_attention",)
        if any(c[k] <= 0 for k in want) or c["flash_prefill"]:
            raise AssertionError(f"(c) {name}: launches {c}")
        model = shape.get("model", 1)
        # a model rank also holds the norms and the row-parallel leaves'
        # int8 scales whole: within 0.01 of half, as phase 14 holds it
        if kv != [1 / model] * 4 or not all(
                abs(w - 1 / model) < 0.01 if model > 1 else w == 1
                for w in weights_share):
            raise AssertionError(f"(c) {name}: KV shares {kv}, weight "
                                 f"shares {weights_share}")
        if shape.get("data", 1) > 1:
            for mode in ("ring", "ulysses"):
                by_data: dict = {}
                for rank, g in enumerate(got):
                    coords = Mesh(MeshSpec(**shape), rank=rank).coords
                    by_data.setdefault(coords["context"], set()).add(
                        g[f"{mode}_digest"])
                if any(len(d) != 1 for d in by_data.values()):
                    raise AssertionError(f"(c) {name} {mode}: the data "
                                         f"replicas' hidden states differ")
            log(f"  (c) {name}: hidden states equal on both data replicas "
                f"(equal on all four ranks: "
                f"{len({g['ring_digest'] for g in got}) == 1})")


def check_pp_cp(smi: str) -> tuple[dict[str, int], dict[str, int],
                                   dict[str, int]]:
    """Phase 16. (a) `tiny` in float32 at {stage: 2} (pipeline
    microbatches 1 and 2, dense and int8 + int8 KV) and at {context: 2}
    (dense and int8 + int8 KV), the prompts submitted together over 4
    slots: text equal to one CPU rank's, first-step logits within
    TP_F32_TOL. (b) phase 10's checkpoint at {stage: 2} with two
    microbatches, bf16 then int8 + kv_quant + fused_dequant (which keeps
    every int8 leaf on the mixed dot: the log and QMM_FALLBACK say
    stage_axis), phase 15's four chats together: text equal to one rank's
    serve (int8: with fused_dequant off, the stage ranks' own path), tokens
    and launches equal on both ranks, each rank's KV cache half of one
    rank's, its weights its layer plus the embedding, head and final norm.
    (c) the checkpoint at {context: 2}: forward_hidden with ring_mesh,
    ring then Ulysses, within CP_TOL of one rank's flash forward and of
    each other; the engine, bf16 and int8, text equal to one rank's. Then
    on four ranks, one spawn that runs beside (a)-(c)'s while this process
    makes one rank's references: at {context: 2, model: 2}, each rank
    loading its `model` block, bf16 and int8 (+ kv_quant, fused_dequant),
    and at {data: 2, context: 2}, bf16: ring and Ulysses hidden states
    within CP_TOL of one rank's flash forward and of each other, one
    decode step from the cache each wrote within LOGIT_TOL of one rank's
    (cp_mesh_check). The three spawns run together. Returns each kernel
    row's launches on rank 0 at {stage: 2}, at {context: 2} and at
    {context: 2, model: 2}."""
    if os.path.exists(CP_REF):
        os.remove(CP_REF)
    cp4 = [dict(name="cp_tp_bf16", model="ring_mesh", int8=False,
                mesh=CP_TP_MESH),
           dict(name="cp_tp_int8", model="ring_mesh", int8=True,
                mesh=CP_TP_MESH),
           dict(name="cp_dp_bf16", model="ring_mesh", int8=False,
                mesh=CP_DP_MESH)]
    t4 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        cp4_spawn = pool.submit(tp_spawn, "cp4_gloo", CP4_DEVICES, cp4,
                                mesh=CP_TP_MESH)
        contents = tp_contents()
        contents = contents + contents[:1]
        pp_tiny = [dict(name=f"pp_tiny_{'int8' if i8 else 'f32'}_m{m}",
                        model="tiny", int8=i8, new=12, together=True, serves=1,
                        geometry={"max_slots": DP_SLOTS,
                                  "pipeline_microbatches": m})
                   for i8 in (False, True) for m in (1, PP_MICRO)]
        pp_ckpt = [dict(name=f"pp_ckpt_{'int8' if i8 else 'bf16'}",
                        model="ckpt", tpu=pp_section(i8), contents=contents,
                        new=DP_NEW, together=True, serves=1)
                   for i8 in (False, True)]
        pp_spawn = pool.submit(tp_spawn, "pp_gloo", PP_DEVICES,
                               pp_tiny + pp_ckpt, mesh={"stage": PP})
        cp_tiny = [dict(name=f"cp_tiny_{'int8' if i8 else 'f32'}",
                        model="tiny", int8=i8, new=12, together=True, serves=1,
                        geometry={"max_slots": DP_SLOTS})
                   for i8 in (False, True)]
        cp_ckpt = [dict(name=f"cp_ckpt_{'int8' if i8 else 'bf16'}",
                        model="ckpt", tpu=cp_section(i8), contents=contents,
                        new=DP_NEW, together=True, serves=1)
                   for i8 in (False, True)]
        cp_spawn = pool.submit(
            tp_spawn, "cp_gloo", CP_DEVICES,
            cp_tiny + cp_ckpt + [dict(name="cp_ring", model="ring")],
            mesh={"context": CP})
        cp_refs = cp_mesh_reference()
        log(f"  (c) one rank's references for four ranks' rows in "
            f"{cp_refs['s']:.1f} s")
        pp, cp, cp4_ranks = (f.result() for f in (pp_spawn, cp_spawn,
                                                  cp4_spawn))
    log(f"  two stage ranks on {PP_DEVICES} ((a)-(b)), two context ranks on "
        f"{CP_DEVICES} ((a), (c)) and four ranks on {CP4_DEVICES} ((c) at "
        f"{CP_TP_MESH} and {CP_DP_MESH}), all three spawns together, in "
        f"{time.monotonic() - t4:.1f} s")
    for group, jobs, tag in ((pp, pp_tiny + pp_ckpt, "pp"),
                             (cp, cp_tiny + cp_ckpt, "cp")):
        for job in jobs:
            tp_check_ranks(tag, job["name"], group)
            if group[0][job["name"]]["backend"] != "gloo":
                raise AssertionError("two ranks on one card must run over "
                                     "gloo")
    # (a) against one CPU rank
    for name, group, i8 in (
            *((f"pp_tiny_{'int8' if i8 else 'f32'}_m{m}", pp, i8)
              for i8 in (False, True) for m in (1, PP_MICRO)),
            ("cp_tiny_f32", cp, False), ("cp_tiny_int8", cp, True)):
        # under the stage axis int8 leaves stay on the mixed dot
        texts, logits = tp_tiny_reference(
            i8, slots=DP_SLOTS, together=True,
            fused=not name.startswith("pp_"))
        if group[0][name]["texts"][0] != texts:
            raise AssertionError(f"(a) {name}: the mesh on the card "
                                 f"{group[0][name]['texts'][0]} != one CPU "
                                 f"rank {texts}")
        mesh_logits = torch.from_numpy(np.load(os.path.join(
            OUT_DIR, f"tp_{name}_logits.npy")))
        err = float((mesh_logits - logits).abs().max())
        log(f"  (a) {name}: text equal to one CPU rank's; first-step "
            f"logits max_abs_err {err:.3e} (tol {TP_F32_TOL:.0e})")
        if err > TP_F32_TOL:
            raise AssertionError(f"(a) {name}: logits error {err}")
    # (b) against one rank serving the same chats together
    for i8 in (False, True):
        name = f"pp_ckpt_{'int8' if i8 else 'bf16'}"
        got = [r[name] for r in pp]
        t0 = time.monotonic()
        texts, ref_kv, ref_bytes, ref_layers = dp_reference(
            i8, contents, fused=False)
        t_ref = time.monotonic() - t0
        kv = [g["kv_cache_bytes"] / ref_kv for g in got]
        g0 = got[0]
        log(f"  (b) {name}: prompt tokens {g0['prompt_lens']}; KV cache per "
            f"rank {[g['kv_cache_bytes'] for g in got]} B of one rank's "
            f"{ref_kv} (shares {kv}); weights per rank "
            f"{[g['param_bytes'] for g in got]} B (layers "
            f"{[g['layer_bytes'] for g in got]}) of one rank's {ref_bytes} "
            f"(layers {ref_layers}); streamed per step per rank "
            f"{g0['stream_bytes_per_device']} B of {g0['stream_bytes']}; "
            f"max_memory_allocated per rank "
            f"{[round(g['max_memory_allocated'] / 2**30, 3) for g in got]} "
            f"GiB; stage_axis fallbacks per rank "
            f"{[g['stage_axis_fallbacks'] for g in got]}; build "
            f"{g0['build_s']:.1f} s, warmup {g0['warmup_s']:.1f} s, serve "
            f"{[round(t, 1) for t in g0['serve_s']]} s (gloo on one card: "
            f"not a speed of pipeline parallelism); one rank's serve and "
            f"build {t_ref:.1f} s")
        if g0["texts"][0] != texts:
            raise AssertionError(f"(b) {name}: stage=2 {g0['texts'][0]!r} "
                                 f"!= one rank {texts!r}")
        if kv != [0.5] * PP:
            raise AssertionError(f"(b) {name}: KV cache shares {kv}, not "
                                 f"half of one rank's")
        for g in got:
            if (2 * g["layer_bytes"] != ref_layers
                    or g["param_bytes"] - g["layer_bytes"]
                    != ref_bytes - ref_layers):
                raise AssertionError(
                    f"(b) {name}: a rank holds {g['layer_bytes']} B of "
                    f"layers and {g['param_bytes'] - g['layer_bytes']} B "
                    f"else; one rank's {ref_layers} and "
                    f"{ref_bytes - ref_layers}")
        if i8:
            if any(g["stage_axis_fallbacks"] != 1 for g in got):
                raise AssertionError(f"(b) {name}: QMM_FALLBACK stage_axis "
                                     f"{[g['stage_axis_fallbacks'] for g in got]}")
            for rank in range(PP):
                with open(os.path.join(OUT_DIR, f"pp_gloo.{rank}.log")) as fh:
                    if "reason: stage_axis" not in fh.read():
                        raise AssertionError(f"(b) rank {rank}'s log does not "
                                             f"say stage_axis")
        log(f"  (b) {name}: text equal to one rank's for {len(contents)} "
            f"chats")
    # (c) the ring forward, and the engine against one rank's serve
    for rank, r in enumerate(cp):
        ring = r["cp_ring"]
        log(f"  (c) rank {rank}: B=2 x {CP_SEQ} (seq_lens {CP_LENS}) bf16 "
            f"hidden states against one rank's flash forward: ring "
            f"max_abs_err {ring['ring_err']:.4f}, ulysses "
            f"{ring['ulysses_err']:.4f}, ring vs ulysses "
            f"{ring['ring_ulysses_err']:.4f} (bound {CP_TOL}); seconds flash "
            f"{ring['flash_s']:.3f}, ring {ring['ring_s']:.3f}, ulysses "
            f"{ring['ulysses_s']:.3f} (two ranks on one card, gloo: not a "
            f"speed of either scheme); max_memory_allocated "
            f"{ring['max_memory_allocated'] / 2**30:.3f} GiB")
        if max(ring["ring_err"], ring["ulysses_err"],
               ring["ring_ulysses_err"]) > CP_TOL:
            raise AssertionError(f"(c) rank {rank}: sequence-parallel "
                                 f"hidden states beyond {CP_TOL}: {ring}")
    for i8 in (False, True):
        name = f"cp_ckpt_{'int8' if i8 else 'bf16'}"
        texts, ref_kv, _, _ = dp_reference(i8, contents)
        g0 = cp[0][name]
        if g0["texts"][0] != texts:
            raise AssertionError(f"(c) {name}: context=2 {g0['texts'][0]!r} "
                                 f"!= one rank {texts!r}")
        if any(r[name]["kv_cache_bytes"] != ref_kv for r in cp):
            raise AssertionError(f"(c) {name}: a context rank's KV cache is "
                                 f"not one rank's (replicas)")
        log(f"  (c) {name}: text equal to one rank's for {len(contents)} "
            f"chats; serve {[round(t, 1) for t in g0['serve_s']]} s")
    cp_mesh_check(cp4_ranks, cp_refs, {j["name"]: j["mesh"] for j in cp4})
    if cp4_ranks[0]["cp_tp_bf16"]["backend"] != "gloo":
        raise AssertionError("four ranks on one card must run over gloo")
    if torch.cuda.device_count() >= 4:
        # the parent's reference file is still in place
        nccl = tp_spawn("cp4_nccl", [f"cuda:{i}" for i in range(4)],
                        cp4[:1], mesh=CP_TP_MESH)
        if nccl[0]["cp_tp_bf16"]["backend"] != "nccl":
            raise AssertionError("four cards must run over nccl")
        cp_mesh_check(nccl, cp_refs, {"cp_tp_bf16": CP_TP_MESH})
        log(f"  nccl pass of (c) at {CP_TP_MESH} bf16 on four cards: ring "
            f"prefill {[round(r['cp_tp_bf16']['ring_s'], 3) for r in nccl]}"
            f" s, ulysses "
            f"{[round(r['cp_tp_bf16']['ulysses_s'], 3) for r in nccl]} s "
            f"(gloo on one card: "
            f"{[round(r['cp_tp_bf16']['ring_s'], 3) for r in cp4_ranks]}, "
            f"{[round(r['cp_tp_bf16']['ulysses_s'], 3) for r in cp4_ranks]})")
    else:
        log(f"  nccl pass of (c) at {CP_TP_MESH} not run: "
            f"{torch.cuda.device_count()} card(s) on this machine")
    if torch.cuda.device_count() >= 2:
        nccl = tp_spawn("pp_nccl", ["cuda:0", "cuda:1"], [pp_ckpt[0]],
                        mesh={"stage": PP})
        if nccl[0]["pp_ckpt_bf16"]["backend"] != "nccl":
            raise AssertionError("two cards must run over nccl")
        tp_check_ranks("pp nccl", "pp_ckpt_bf16", nccl)
        got, gloo = nccl[0]["pp_ckpt_bf16"], pp[0]["pp_ckpt_bf16"]
        log(f"  nccl pass of (b) bf16 on cuda:0, cuda:1: tokens equal on "
            f"both ranks; serve {[round(t, 1) for t in got['serve_s']]} s "
            f"(gloo on one card: {[round(t, 1) for t in gloo['serve_s']]} "
            f"s); text equal to gloo's: {got['texts'] == gloo['texts']}")
        if got["texts"] != gloo["texts"]:
            raise AssertionError("the nccl pass's text differs from gloo's")
    else:
        log(f"  nccl pass not run: {torch.cuda.device_count()} card(s) on "
            f"this machine")

    def launches(c: dict, tiny: str) -> dict[str, int]:
        return {"flash_prefill": c["bf16"]["flash_prefill"]
                + c["int8"]["flash_prefill"],
                "decode_attention": c["bf16"]["decode_attention"],
                "decode_attention_int8": c["int8"]["decode_attention"],
                "kv_append_fused": c["int8"]["decode_attention_append"],
                "w8a16_matmul[gemv]": c["int8"]["w8a16_gemv"],
                "w8a16_matmul[gemv_f32]": c[tiny]["w8a16_gemv_f32"],
                "w8a16_matmul[tc]": c["int8"]["w8a16_tc"],
                "kv_append": sum(r["kv_append"] for r in c.values()),
                "w8a8_matmul": 0,
                "moe_gemv": sum(r["moe_gemv"] for r in c.values())}

    pc = {"bf16": pp[0]["pp_ckpt_bf16"]["counts"],
          "int8": pp[0]["pp_ckpt_int8"]["counts"],
          "tiny": pp[0][f"pp_tiny_int8_m{PP_MICRO}"]["counts"]}
    cc = {"bf16": cp[0]["cp_ckpt_bf16"]["counts"],
          "int8": cp[0]["cp_ckpt_int8"]["counts"],
          "tiny": cp[0]["cp_tiny_int8"]["counts"]}
    tc = {"bf16": cp4_ranks[0]["cp_tp_bf16"]["counts"],
          "int8": cp4_ranks[0]["cp_tp_int8"]["counts"]}
    return (launches(pc, "tiny"), launches(cc, "tiny"),
            launches(tc, "int8"))


# ---------------------------------------------------------------------------
# Phase 17: the expert axis and MoE on every mesh axis (models/moe.py),
# ranks on the one card

EP = 2
# Ranks share the one card over gloo, as in phases 14-16: the phase checks
# correctness and each rank's share of the memory, not the speed of expert
# parallelism.
EP_DEVICES = ["cuda:0"] * EP
EP4_DEVICES = ["cuda:0"] * 4
# (a): tiny-moe in float32 over four slots; the 40-token prompt prefills
# alone at the 64 bucket, so its layers take the capacity dispatch.
EP_TINY = dict(max_slots=DP_SLOTS, max_seq_len=128,
               prefill_buckets=(16, 32, 64))
EP_TINY_LENS = [5, 14, 40]
# (a)'s meshes: two ranks, then four.
EP_TINY_MESHES = {"ep": {"expert": EP}, "tp": {"model": 2},
                  "pp": {"stage": PP}, "cp": {"context": CP}}
EP_TINY4_MESHES = {"eptp": {"expert": EP, "model": 2},
                   "dpep": {"data": 2, "expert": EP}}
# (c): a router logit is a bf16 value (the product is rounded before the
# cast to float32), one step 1/32 at magnitudes 4-8. A rank whose inputs
# differ from one rank's by a bf16 step can swap two experts whose logits
# are within about two steps: a router near tie.
ROUTE_TIE = 0.0625


def tiny_reference(job: dict) -> tuple[list[str], torch.Tensor]:
    """(a)'s one CPU rank for a `tiny-moe` job (its geometry without the
    pipeline's microbatches)."""
    geometry = {k: v for k, v in job["geometry"].items()
                if k != "pipeline_microbatches"}
    return tp_tiny_reference(job["int8"], together=True, model="tiny-moe",
                             geometry=geometry, lens=EP_TINY_LENS)


def ep_section(int8: bool, mesh: dict | None) -> dict:
    """Phase 17(b)-(c)'s `tpu:` section: phase 15's (4 slots, capacity
    2048, decode block 8, no prefix cache) on phase 13(e)'s mixtral
    checkpoint, read cold (no warm cache is written: a sharded load writes
    none, and a one-rank bf16 cache would be 6.3 GB), on `mesh`."""
    section = {**dp_section(int8, mesh=False),
               "checkpoint_path": MOE_CKPT_DIR, "warm_cache": False}
    return {**section, "mesh": mesh} if mesh else section


_EP_REFS: dict = {}


# (b)-(c) serve with no admission time budget, so a mesh and one rank make
# the same dispatches in the same order whatever the host's speed, and
# (c) can hold their decisions one for one.
EP_SERVE = {"admit_seconds": float("inf")}


def ep_reference(int8: bool, contents: list[str]) -> dict:
    """One rank's engine on the mixtral checkpoint (ep_section without a
    mesh): the first step's logits on the first chat, as tp_job computes
    them, the chats' text served together (EP_SERVE) with the decisions
    it made (recording_decisions), and its bytes. Kept for (c)."""
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.models.llama import init_cache, logits_from_hidden
    from symmetry_tpu_torch.provider.config import TpuConfig

    if int8 in _EP_REFS:
        return _EP_REFS[int8]
    tpu = TpuConfig.from_dict(ep_section(int8, None))
    engine = InferenceEngine.from_tpu_config(tpu, device="cuda")
    cfg = engine.config
    prompts = [engine.tokenizer.apply_chat_template(
        [{"role": "user", "content": c}]) for c in contents]
    engine.tokenizer = id_tokenizer(cfg.vocab_size)
    ids = torch.tensor([prompts[0]], device="cuda")
    cache = init_cache(cfg, 1, ids.shape[1], engine.cache_dtype,
                       quantized=engine.kv_quant, device="cuda")
    h, _ = engine.trunk(ids, cache, prefill_flash=True)
    logits = logits_from_hidden(engine.params, cfg, h[:, -1:])[0, 0]
    del h, cache
    engine.warmup()
    with recording_decisions() as decisions:
        texts = serve_together(engine, prompts, DP_NEW, tpu.pipeline_depth,
                               **EP_SERVE)
    out = {"texts": texts, "decisions": decisions,
           "logits": logits.float().cpu(),
           "kv_cache_bytes": engine.kv_cache_bytes(),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(engine.params)),
           "expert_bytes": expert_bytes(engine.params)}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _EP_REFS[int8] = out
    return out


def check_ep(smi: str) -> dict[str, int]:
    """Phase 17. (a) `tiny-moe` in float32, the prompts submitted together
    over four slots (one prefill through the dispatch): {expert: 2} dense
    then int8 + int8 KV, {model: 2}, {stage: 2} with two microbatches and
    {context: 2} on two ranks, {expert: 2, model: 2} and {data: 2, expert:
    2} on four: text equal to one CPU rank's, first-step logits within
    TP_F32_TOL. (b) phase 13(e)'s mixtral-8x7b-width checkpoint (2
    layers) loaded sharded at {expert: 2}, bf16 then int8 + kv_quant +
    fused_dequant, phase 14's three chats and a repeat of the first
    together (every prefill layer through the dispatch): text equal to one
    rank's serve 4/4, tokens and launches equal on both ranks, first-step
    logits within LOGIT_TOL of one rank's, each rank's expert bytes half of
    one rank's and every other byte whole, KV per rank whole. (c) the
    checkpoint at {expert: 2, model: 2}, bf16, four ranks: text equal to
    (b)'s one-rank serve, a chat parting from it only when the first
    discrete decision of the serve made otherwise (recording_decisions: a
    router choice, a sampled token) is one rank's near tie (the model
    axis's float32 sums round apart), experts per rank a quarter. Texts
    are compared token for token (id_tokenizer). The two spawns run
    together while this process makes the one-rank references.
    Returns each kernel row's launches on rank 0 in (a)-(b) at {expert:
    2}."""
    contents = tp_contents()
    contents = contents + contents[:1]

    def tiny(name, mesh, int8=False, geometry=None):
        return dict(name=f"ep_tiny_{name}", model="tiny-moe", int8=int8,
                    new=12, together=True, serves=1, lens=EP_TINY_LENS,
                    mesh=mesh, geometry={**EP_TINY, **(geometry or {})})

    two = [tiny("ep_f32", EP_TINY_MESHES["ep"]),
           tiny("ep_int8", EP_TINY_MESHES["ep"], int8=True),
           tiny("tp_f32", EP_TINY_MESHES["tp"]),
           tiny("pp_f32", EP_TINY_MESHES["pp"],
                geometry={"pipeline_microbatches": PP_MICRO}),
           tiny("cp_f32", EP_TINY_MESHES["cp"])]
    def ckpt(name, int8, mesh, **kw):
        return dict(name=name, model="ckpt", tpu=ep_section(int8, mesh),
                    mesh=mesh, contents=contents, new=DP_NEW, together=True,
                    serves=1, id_text=True, serve=EP_SERVE, **kw)

    two += [ckpt(f"ep_ckpt_{'int8' if i8 else 'bf16'}", i8, {"expert": EP})
            for i8 in (False, True)]
    four = [tiny(f"{k}_f32", m) for k, m in EP_TINY4_MESHES.items()]
    four.append(ckpt("ep_ckpt_bf16_eptp", False,
                     {"expert": EP, "model": 2}, decisions=True))
    # Both spawns run together, and this process makes the one-rank
    # references meanwhile: the ranks' time is mostly process start-up.
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawns = [pool.submit(tp_spawn, "ep_gloo", EP_DEVICES, two,
                              mesh={"expert": EP}),
                  pool.submit(tp_spawn, "ep4_gloo", EP4_DEVICES, four,
                              mesh={"expert": EP, "model": 2})]
        for job in two + four:
            if job["model"] != "ckpt":
                tiny_reference(job)
        for i8 in (False, True):
            ep_reference(i8, contents)
        t_ref = time.monotonic() - t0
        ranks, ranks4 = (f.result() for f in spawns)
    log(f"  two ranks on {EP_DEVICES} ran (a)-(b) and four on "
        f"{EP4_DEVICES} (a), (c), together, in {time.monotonic() - t0:.1f} "
        f"s; the one-rank references meanwhile took {t_ref:.1f} s")
    for group, jobs, tag in ((ranks, two, "ep"), (ranks4, four, "ep4")):
        for job in jobs:
            tp_check_ranks(tag, job["name"], group)
            if group[0][job["name"]]["backend"] != "gloo":
                raise AssertionError("ranks on one card must run over gloo")
    # (a) against one CPU rank
    for job, group in [(j, ranks) for j in two if j["model"] != "ckpt"] + [
            (j, ranks4) for j in four if j["model"] != "ckpt"]:
        name = job["name"]
        texts, logits = tiny_reference(job)
        if group[0][name]["texts"][0] != texts:
            raise AssertionError(f"(a) {name}: the mesh on the card "
                                 f"{group[0][name]['texts'][0]} != one CPU "
                                 f"rank {texts}")
        mesh_logits = torch.from_numpy(np.load(os.path.join(
            OUT_DIR, f"tp_{name}_logits.npy")))
        err = float((mesh_logits - logits).abs().max())
        log(f"  (a) {name} at {job['mesh']}: text equal to one CPU rank's; "
            f"first-step logits max_abs_err {err:.3e} (tol "
            f"{TP_F32_TOL:.0e}); expert bytes per rank "
            f"{[r[name]['expert_bytes'] for r in group]}")
        if err > TP_F32_TOL:
            raise AssertionError(f"(a) {name}: logits error {err}")
    # (b) and (c) against one rank on the same checkpoint
    for name, group, parts in (("ep_ckpt_bf16", ranks, EP),
                               ("ep_ckpt_int8", ranks, EP),
                               ("ep_ckpt_bf16_eptp", ranks4, 2 * EP)):
        i8 = "int8" in name
        got = [r[name] for r in group]
        ref = ep_reference(i8, contents)
        mesh_logits = torch.from_numpy(np.load(os.path.join(
            OUT_DIR, f"tp_{name}_logits.npy")))
        err = float((mesh_logits - ref["logits"]).abs().max())
        g0 = got[0]
        log(f"  ({'c' if parts > EP else 'b'}) {name}: prompt tokens "
            f"{g0['prompt_lens']}; first-step logits max_abs_err {err:.4f} "
            f"(tol {LOGIT_TOL}); expert bytes per rank "
            f"{[g['expert_bytes'] for g in got]} of one rank's "
            f"{ref['expert_bytes']}; weights per rank "
            f"{[g['param_bytes'] for g in got]} B of {ref['param_bytes']}; "
            f"KV per rank {[g['kv_cache_bytes'] for g in got]} B of "
            f"{ref['kv_cache_bytes']}; streamed per step per rank "
            f"{g0['stream_bytes_per_device']} B of {g0['stream_bytes']}; "
            f"max_memory_allocated per rank "
            f"{[round(g['max_memory_allocated'] / 2**30, 3) for g in got]} "
            f"GiB; launches per rank {g0['counts']}; build "
            f"{g0['build_s']:.1f} s, warmup {g0['warmup_s']:.1f} s, serve "
            f"{[round(t, 1) for t in g0['serve_s']]} s (gloo on one card: "
            f"not a speed of expert parallelism)")
        if err > LOGIT_TOL:
            raise AssertionError(f"{name}: logits error {err}")
        parted = [i for i, (want, text) in enumerate(
            zip(ref["texts"], g0["texts"][0])) if text != want]
        if parted and parts == EP:
            # At {expert: 2} each expert's output and the combine round as
            # one rank's: the text must be one rank's.
            raise AssertionError(f"{name}: chats {parted} differ from one "
                                 f"rank's: {g0['texts'][0]!r} != "
                                 f"{ref['texts']!r}")
        if parts > EP:
            # Over a model axis the F halves' float32 sums round apart
            # (about one bf16 step of the logits), so the mesh may make a
            # decision the other way where one rank made it at a near tie,
            # and its text may part from there (near_ties).
            apart = decisions_apart(*recording_decisions.load(
                os.path.join(OUT_DIR, f"tp_{name}_decisions.npz")),
                ref["decisions"], MOE_CKPT_LAYERS)
            log(f"  (c) {name}: {len(ref['decisions'].kinds)} decisions of "
                f"one rank's serve; those the mesh makes otherwise while "
                f"the tokens agree (index, kind, layer, row, one rank's "
                f"margin): {apart}")
            if not near_ties(apart) or (parted and not apart):
                raise AssertionError(
                    f"{name}: chats {parted} part from one rank's and the "
                    f"decisions apart {apart} are not near ties")
        log(f"  {name}: text equal to one rank's for "
            f"{len(contents) - len(parted)} of {len(contents)} chats"
            + (f"; chats {parted} part after a near tie" if parted else ""))
    _EP_REFS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    c = {"tiny": ranks[0]["ep_tiny_ep_int8"]["counts"],
         "bf16": ranks[0]["ep_ckpt_bf16"]["counts"],
         "int8": ranks[0]["ep_ckpt_int8"]["counts"]}
    # A rank's expert block runs the grouped GEMV: wg, wu and wd at every
    # layer of every int8 decode step (one decode-attention launch a layer
    # and step), three more in each dispatch of at most 64 rows an expert;
    # bf16 stacks keep their matmul.
    extra = c["int8"]["moe_gemv"] - 3 * c["int8"]["decode_attention"]
    if (extra < 0 or extra % 3 or c["bf16"]["moe_gemv"]
            or c["tiny"]["moe_gemv"] <= 0):
        raise AssertionError(f"grouped GEMV launches at {{expert: 2}}: tiny "
                             f"{c['tiny']['moe_gemv']}, int8 "
                             f"{c['int8']['moe_gemv']} against decode "
                             f"attention's {c['int8']['decode_attention']}, "
                             f"bf16 {c['bf16']['moe_gemv']}")
    return {"flash_prefill": c["bf16"]["flash_prefill"]
            + c["int8"]["flash_prefill"],
            "decode_attention": c["bf16"]["decode_attention"],
            "decode_attention_int8": c["int8"]["decode_attention"],
            "kv_append_fused": c["int8"]["decode_attention_append"],
            "w8a16_matmul[gemv]": c["int8"]["w8a16_gemv"],
            "w8a16_matmul[gemv_f32]": c["tiny"]["w8a16_gemv_f32"],
            "w8a16_matmul[tc]": c["int8"]["w8a16_tc"],
            "kv_append": sum(r["kv_append"] for r in c.values()),
            "w8a8_matmul": 0,
            "moe_gemv": c["tiny"]["moe_gemv"] + c["int8"]["moe_gemv"]}


def check_ep_nccl() -> None:
    """`--tp` with two cards: mixtral-8x7b in bf16 at all 32 layers, the
    model one card cannot hold (~93.4 GB), at {expert: 2}, one card a rank
    over nccl: init_params(mesh=) keeps a rank's experts only (~48.3 GB a
    rank), phase 14's chats one at a time; tokens equal on both ranks.
    Logged as not run on a machine with fewer cards."""
    if torch.cuda.device_count() < 2:
        log(f"  nccl pass of mixtral-8x7b at {{expert: 2}} not run: "
            f"{torch.cuda.device_count()} card(s) on this machine")
        return
    section = {"model_preset": "mixtral-8x7b", "mesh": {"expert": EP},
               "max_batch_size": DP_SLOTS, "decode_block": TP_DECODE_BLOCK}
    got = tp_spawn("ep_nccl", ["cuda:0", "cuda:1"], [dict(
        name="ep_mixtral", model="ckpt", tpu=section,
        contents=tp_contents(), new=TP_NEW, serves=1)],
        mesh={"expert": EP})
    if got[0]["ep_mixtral"]["backend"] != "nccl":
        raise AssertionError("two cards must run over nccl")
    tp_check_ranks("ep nccl", "ep_mixtral", got)
    g = [r["ep_mixtral"] for r in got]
    log(f"  nccl pass, mixtral-8x7b bf16 32 layers at {{expert: 2}} on "
        f"cuda:0, cuda:1: tokens equal on both ranks; weights per rank "
        f"{[r['param_bytes'] for r in g]} B (experts "
        f"{[r['expert_bytes'] for r in g]}); max_memory_allocated per rank "
        f"{[round(r['max_memory_allocated'] / 2**30, 3) for r in g]} GiB; "
        f"serve {[round(t, 1) for t in g[0]['serve_s']]} s")


def tp_main() -> int:
    """`python3 chip_smoke.py --tp`: phases 14 to 17 alone, where the
    machine has the cards for their nccl passes too: the device, the
    build, phase 10's checkpoint and warm caches written in process
    (without its hosts), then phases 14, 15 and 16; phase 13(e)'s mixtral
    checkpoint, then phase 17 and its nccl pass."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    from symmetry_tpu_torch.engine import weights
    from symmetry_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"{torch.cuda.device_count()} x {smi}; kernels built in "
        f"{kernels.build_all():.3f} s")
    cfg, params = checkpoint_params()
    weights.save_checkpoint(CKPT_DIR, params, cfg, dtype=torch.bfloat16,
                            shards=2)
    del params
    for quantize in (False, True):
        tree, got = weights.load_checkpoint(CKPT_DIR, dtype=torch.bfloat16,
                                            quantize=quantize, device="cuda")
        weights.save_warm_cache(CKPT_DIR, tree, got, dtype=torch.bfloat16,
                                quantize=quantize)
        del tree
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    log(f"checkpoint and warm caches written in {t1 - t0:.1f} s")
    launches = check_tp(smi)
    t2 = time.perf_counter()
    log(f"phase 14 took {t2 - t1:.1f} s; launches_tp {launches}")
    launches = check_dp(smi)
    t3 = time.perf_counter()
    log(f"phase 15 took {t3 - t2:.1f} s; launches_dp {launches}")
    launches = check_pp_cp(smi)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t4 = time.perf_counter()
    log(f"phase 16 took {t4 - t3:.1f} s; launches_pp, launches_cp, "
        f"launches_cp_tp {launches}")
    write_moe_checkpoint()
    gc.collect()
    torch.cuda.empty_cache()
    launches = check_ep(smi)
    shutil.rmtree(MOE_CKPT_DIR, ignore_errors=True)
    log(f"phase 17 took {time.perf_counter() - t4:.1f} s (the mixtral "
        f"checkpoint's write included); launches_ep {launches}")
    check_ep_nccl()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    from symmetry_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    marks = [t_start]

    def phase_done(n: int) -> None:
        marks.append(time.perf_counter())
        log(f"  phase {n} took {marks[-1] - marks[-2]:.1f} s")

    log("phase 1: device")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"  {name}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__} (CUDA {torch.version.cuda}); {smi}")
    phase_done(1)

    log("phase 2: build")
    log(f"  kernels built in {kernels.build_all():.3f} s; nvcc seconds per "
        f"source {kernels.BUILD_SECONDS}")
    phase_done(2)

    log("phase 3: kernels against their plain versions (bf16)")
    from symmetry_tpu_torch.ops.kv_append import kv_append
    kv_append.launches = 0
    rows = [check_flash(), check_decode(int8=False), check_decode(int8=True),
            check_fused_append(), *check_w8a16()]
    kv_row = check_kv_append()
    check_no_host_sync()
    w8a8_row = check_w8a8()
    moe_row = check_moe_gemv()
    kv_row["launches"] = kv_append.launches  # the pair's and its own
    torch.cuda.empty_cache()
    phase_done(3)

    log("phase 4: tiny engine, card against CPU (float32)")
    f32_launches = check_tiny()
    phase_done(4)

    log("phase 5: llama3-8b bf16 full width through the Scheduler")
    bf16 = check_full_width(smi, int8=False)
    gc.collect()  # frees the bf16 engine before the int8 one is built
    torch.cuda.empty_cache()
    phase_done(5)

    log("phase 6: llama3-8b int8 full width through the Scheduler")
    int8 = check_full_width(smi, int8=True)
    # Each route's launches from the serving path it belongs to; float32
    # rows serve in phase 4 (llama3-8b serves bf16).
    launches = {"flash_prefill": bf16["flash_prefill"],
                "decode_attention": bf16["decode_attention"],
                "decode_attention_int8": int8["decode_attention"],
                "kv_append_fused": int8["decode_attention_append"],
                "w8a16_matmul[gemv]": int8["w8a16_matmul[gemv]"],
                "w8a16_matmul[gemv_f32]": f32_launches,
                "w8a16_matmul[tc]": int8["w8a16_matmul[tc]"]}
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on the path")
        if row["name"] == "w8a16_matmul[gemv_f32]":
            row["path"] = ("phase 4: float32 tiny with int8 weights, the "
                           "float32 serving path")
    moe_row.update(launches=0, path=(
        "phases 5-6 serve llama3-8b, a dense model: the grouped expert GEMV "
        "serves MoE stacks only (launches_moe, launches_ep)"))
    rows += [kv_row, w8a8_row, moe_row]
    gc.collect()  # frees the int8 engine before the host phases
    torch.cuda.empty_cache()
    phase_done(6)

    log("phase 7: engine host, tiny, card against CPU (phase 8's host "
        "starting beside it)")
    full_host = HostProc("llama3_8b", HOST_FULL_TPU)
    try:
        check_host_tiny()
    except BaseException:
        full_host.kill()
        raise
    phase_done(7)

    log("phase 8: engine host, llama3-8b bf16, the provider's default tpu: "
        "section")
    tpu = check_host_full(smi, full_host)
    profile_host_path(tpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done(8)

    log(f"phase 9: speculative decoding, llama3-8b full width and depth, "
        f"8 slots, k_draft {SPEC_K}")
    for int8_spec in (False, True):
        check_speculative(smi, int8=int8_spec)
        gc.collect()
        torch.cuda.empty_cache()
    phase_done(9)

    log(f"phase 10: checkpoint loading, llama3-8b width at {CKPT_LAYERS} "
        f"layers, through the engine host")
    check_checkpoint(smi)
    phase_done(10)

    log(f"phase 11: prefill and decode tiers, llama3-8b width at "
        f"{CKPT_LAYERS} layers (phase 10's checkpoint), and the device-time "
        f"probes")
    refs = {}
    for int8_tiers in (False, True):
        refs[int8_tiers] = check_disagg(smi, int8=int8_tiers)
        gc.collect()
        torch.cuda.empty_cache()
    phase_done(11)

    log("phase 12: the port's server, provider and client over TCP, "
        f"llama3-8b width at {CKPT_LAYERS} layers (bf16 unified, int8 disagg "
        f"pair)")
    check_provider(smi, refs[False], refs[True])
    phase_done(12)

    log("phase 13: the mixtral family: tiny-moe card against CPU, "
        "mixtral-8x7b int8 at full width and depth, bf16 at "
        f"{MOE_BF16_LAYERS} layers, one layer's dispatch, a checkpoint "
        "quantized on load")
    moe_tiny = check_moe_tiny()
    moe_int8 = check_moe_serve(smi, int8=True)
    gc.collect()  # frees the int8 engine before the bf16 one is built
    torch.cuda.empty_cache()
    moe_bf16 = check_moe_serve(smi, int8=False)
    gc.collect()
    torch.cuda.empty_cache()
    check_moe_layer()
    check_moe_layer_int8()
    check_moe_checkpoint(smi)
    # Each row's launches on the MoE path: (b) and (c) serving, float32
    # rows from (a).
    moe_launches = {
        "flash_prefill": moe_int8["flash_prefill"] + moe_bf16[
            "flash_prefill"],
        "decode_attention": moe_bf16["decode_attention"],
        "decode_attention_int8": moe_int8["decode_attention"],
        "kv_append_fused": moe_int8["decode_attention_append"],
        "w8a16_matmul[gemv]": moe_int8["w8a16_gemv"],
        "w8a16_matmul[gemv_f32]": moe_tiny["w8a16_gemv_f32"],
        "w8a16_matmul[tc]": moe_int8["w8a16_tc"],
        "kv_append": sum(c["kv_append"] for c in (moe_tiny, moe_int8,
                                                  moe_bf16)),
        "w8a8_matmul": 0,
        "moe_gemv": moe_int8["moe_gemv"] + moe_tiny["moe_gemv"]}
    for row in rows:
        row["launches_moe"] = moe_launches[row["name"]]
        on_path = row["name"] not in ("kv_append", "w8a8_matmul")
        if on_path and row["launches_moe"] <= 0:
            raise AssertionError(f"{row['name']} never launched on the MoE "
                                 f"path")
        if not on_path and row["launches_moe"]:
            raise AssertionError(f"{row['name']} launched on the MoE path")
    gc.collect()
    torch.cuda.empty_cache()
    phase_done(13)

    log(f"phase 14: tensor parallelism, two ranks on one card: tiny "
        f"float32, llama3-8b width at {CKPT_LAYERS} layers (phase 10's "
        f"checkpoint) bf16 and int8, the provider with a --worker rank")
    tp_launches = check_tp(smi)
    for row in rows:
        row["launches_tp"] = tp_launches[row["name"]]
        on_path = row["name"] not in ("kv_append", "w8a8_matmul", "moe_gemv")
        if on_path and row["launches_tp"] <= 0:
            raise AssertionError(f"{row['name']} never launched at TP=2")
        if not on_path and row["launches_tp"]:
            raise AssertionError(f"{row['name']} launched at TP=2")
    phase_done(14)

    log(f"phase 15: the data axis, ranks on one card: tiny float32 at "
        f"{{data: 2}} and {{data: 2, model: 2}}, llama3-8b width at "
        f"{CKPT_LAYERS} layers (phase 10's checkpoint) bf16 and int8 at "
        f"{{data: 2}}")
    dp_launches = check_dp(smi)
    for row in rows:
        row["launches_dp"] = dp_launches[row["name"]]
        on_path = row["name"] not in ("kv_append", "w8a8_matmul", "moe_gemv")
        if on_path and row["launches_dp"] <= 0:
            raise AssertionError(f"{row['name']} never launched at data=2")
        if not on_path and row["launches_dp"]:
            raise AssertionError(f"{row['name']} launched at data=2")
    phase_done(15)

    log(f"phase 16: the stage and context axes, ranks on one card: tiny "
        f"float32 at {{stage: 2}} (1 and {PP_MICRO} microbatches) and "
        f"{{context: 2}}, llama3-8b width at {CKPT_LAYERS} layers (phase "
        f"10's checkpoint) bf16 and int8 at both, ring and Ulysses prefill "
        f"over {CP_SEQ} tokens at {{context: 2}}, {CP_TP_MESH} (bf16, int8) "
        f"and {CP_DP_MESH}")
    pp_launches, cp_launches, cp_tp_launches = check_pp_cp(smi)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    for row in rows:
        row["launches_pp"] = pp_launches[row["name"]]
        row["launches_cp"] = cp_launches[row["name"]]
        row["launches_cp_tp"] = cp_tp_launches[row["name"]]
        if row["name"] in CP_TP_REASON:
            row["launches_cp_tp_reason"] = CP_TP_REASON[row["name"]]
            if row["launches_cp_tp"]:
                raise AssertionError(f"{row['name']} launched at context=2 "
                                     f"x model=2")
        elif row["launches_cp_tp"] <= 0:
            raise AssertionError(f"{row['name']} never launched at "
                                 f"context=2 x model=2")
        off_pp = row["name"] in ("kv_append", "w8a8_matmul",
                                 "moe_gemv") or row["name"].startswith(
                                     "w8a16_matmul")
        if row["name"].startswith("w8a16_matmul"):
            row["launches_pp_reason"] = PP_W8A16_REASON
        if not off_pp and row["launches_pp"] <= 0:
            raise AssertionError(f"{row['name']} never launched at stage=2")
        if off_pp and row["launches_pp"]:
            raise AssertionError(f"{row['name']} launched at stage=2")
        on_cp = row["name"] not in ("kv_append", "w8a8_matmul", "moe_gemv")
        if on_cp and row["launches_cp"] <= 0:
            raise AssertionError(f"{row['name']} never launched at "
                                 f"context=2")
        if not on_cp and row["launches_cp"]:
            raise AssertionError(f"{row['name']} launched at context=2")
    phase_done(16)

    log(f"phase 17: the expert axis and MoE on every mesh axis, ranks on "
        f"one card: tiny-moe float32 at {{expert: 2}} (dense, int8), "
        f"{{model: 2}}, {{stage: 2}}, {{context: 2}}, {{expert: 2, model: "
        f"2}} and {{data: 2, expert: 2}}; mixtral-8x7b width at "
        f"{MOE_CKPT_LAYERS} layers (phase 13(e)'s checkpoint) bf16 and int8 "
        f"at {{expert: 2}}, bf16 at {{expert: 2, model: 2}}")
    ep_launches = check_ep(smi)
    shutil.rmtree(MOE_CKPT_DIR, ignore_errors=True)
    for row in rows:
        row["launches_ep"] = ep_launches[row["name"]]
        on_path = row["name"] not in ("kv_append", "w8a8_matmul")
        if on_path and row["launches_ep"] <= 0:
            raise AssertionError(f"{row['name']} never launched at "
                                 f"expert=2")
        if not on_path and row["launches_ep"]:
            raise AssertionError(f"{row['name']} launched at expert=2")
    phase_done(17)
    log(f"  all phases {time.perf_counter() - t_start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_moe", "launches_tp", "launches_dp", "launches_pp",
            "launches_cp", "launches_cp_tp", "launches_ep")
    extra = ("path", "launches_pp_reason", "launches_cp_tp_reason")
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in keys},
         **{k: row[k] for k in extra if k in row}}
        for row in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--tp-rank":
        sys.exit(tp_rank_main(sys.argv[3], int(sys.argv[2])))
    if sys.argv[1:] == ["--tp"]:
        sys.exit(tp_main())
    sys.exit(main())
