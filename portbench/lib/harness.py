"""One run of one cell: set up, ramp, measure, check, report.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration file by the configuration's `file`, its traffic mix as
`traffic/<name>.json` and each metric's reader as `metrics/<name>.py`
beside this package. A reader is a module with `read(ctx)`, which returns
the metric's value, or None where the run holds nothing for it to read
(the metric is then left out of the line).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path

import torch

from portbench.lib import check, traffic

BENCH_DIR = Path(__file__).resolve().parent.parent
# Top-level modules that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "symmetry_tpu")
# Seconds the load runs on after the window's close, with no request sent:
# a request sent in the window may wait so long for its first token before
# it counts as failed, and requests in flight may finish so long for the
# check to have `check_requests` finished requests to sample.
DRAIN_S = 120.0


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclass
class Spec:
    cell: dict
    cfg_file: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_spec(root: Path, cell_name: str, bench_dir: Path = BENCH_DIR
              ) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[cell_name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_file = json.loads((root / config["file"]).read_text())
    mix = traffic.validate(json.loads(
        (bench_dir / "traffic" / f"{cell['traffic']}.json").read_text()))
    return Spec(cell, cfg_file, mix,
                _for_cell(bench["end_to_end"], cell_name),
                _for_cell(bench["per_layer"], cell_name))


def reader(name: str, bench_dir: Path = BENCH_DIR):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Context:
    """What a metric reader may read."""

    spec: Spec
    seed: int
    seconds: float
    dims: object
    deployment: dict
    records: list
    calls: list
    t_open: float
    t_close: float
    setup_s: float
    counters: tuple[dict, dict]
    pool: tuple[dict | None, dict | None]
    trace: object = None
    trace_host: tuple[float, float] | None = None
    lengths: dict = field(default_factory=dict)

    @cached_property
    def calls_by_index(self) -> dict:
        return {c.index: c for c in self.calls}

    def window_requests(self) -> list:
        return [r for r in self.records
                if self.t_open <= r.sent < self.t_close]

    def window_calls(self, kind: str) -> list:
        return [c for c in self.calls if c.kind == kind
                and self.t_open <= c.start and c.end <= self.t_close]


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def _free_program() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@dataclass
class Judged:
    """What decides `correct`: the numbers compared, each beside its limit
    (check.checks), the failed requests, and the finished requests checked
    with the reference's logits at their served tokens."""

    checks: dict
    failed: list
    picked: list
    ref: list | None


def judge(cfg_file: dict, mix: dict, records: list, seed: int,
          dev: torch.device, log) -> Judged:
    """The served tokens of a sample of the finished requests against the
    reference, and the requests that failed or ended short."""
    failed = [r for r in records if r.error is not None
              or r.reason not in (None, "length", "cancelled")]
    done = [r for r in records if r.reason == "length"]
    short = [r for r in done if len(r.tokens) != r.max_new]
    picked = check.sample(done, seed, int(mix["check_requests"]))
    n_checked = sum(len(r.tokens) for r in picked)
    t_ref = time.perf_counter()
    gaps, ref = None, None
    if picked:
        ref = check.logits(cfg_file, seed, picked, dev)
        gaps = check.gap_stats(ref, [torch.tensor(r.tokens, device=dev)
                                     for r in picked],
                               check.thresholds(cfg_file["check"]))
    log(f"reference over {len(picked)} requests, {n_checked} served "
        f"tokens, in {time.perf_counter() - t_ref:.3f} s")
    return Judged(check.checks(cfg_file["check"], gaps, len(failed),
                               len(short), n_checked), failed, picked, ref)


@dataclass
class Served:
    """A cell's load served and measured, the program freed."""

    ctx: Context
    chips: int
    device: str
    peak: int
    smi: str | None
    forbidden: list[str]


def measure(root: Path, cell_name: str, seed: int, seconds: float,
            trace: bool, *, t_start: float, device: str = "cuda",
            bench_dir: Path = BENCH_DIR, log=print) -> Served:
    """Set up the cell's engine, ramp the load, measure for `seconds`, and
    free the program. Raises NoChip where the cards the cell asks for are
    not there."""
    spec = load_spec(root, cell_name, bench_dir)
    chips = int(spec.cell["chips"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise NoChip(f"cell {cell_name} needs {chips} CUDA device(s); "
                     f"torch sees {torch.cuda.device_count()}")
    from portbench.lib import serve, weights

    smi = power_limit() if device == "cuda" else None
    if smi:
        log(f"card: {smi}")
    cfg_file, mix = spec.cfg_file, spec.mix
    dims = weights.Dims.from_hf(cfg_file["model"])

    engine = serve.build_engine(cfg_file, seed, device)
    calls = serve.CallLog(engine)
    t0 = time.perf_counter()
    engine.warmup()
    calls.calls.clear()
    log(f"weights and engine {t0 - t_start:.3f} s, warm-up "
        f"{time.perf_counter() - t0:.3f} s")

    if trace:
        # The profiler's first start in a process takes seconds (CUPTI and
        # kineto start up): paid here, in set-up, not in the window.
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum()

    loop = serve.ClosedLoop(None, traffic.plan(mix, seed, dims.vocab))
    sched = serve.build_scheduler(engine, cfg_file, loop.sink)
    loop.sched = sched
    sched.start()
    t_load = time.perf_counter()
    loop.start()
    n_clients = mix["clients"]

    def ramped() -> bool:
        firsts = [r for r in loop.records if r.index == 0]
        return len(firsts) == n_clients and all(
            r.first is not None or r.done_at is not None for r in firsts)

    if not loop.wait(ramped, timeout=600):
        raise RuntimeError("the load's ramp did not end within 600 s")
    t_open = time.perf_counter()
    ramp_s = t_open - t_load
    setup_s = t_load - t_start
    log(f"ramp {ramp_s:.3f} s (not set-up); set-up {setup_s:.3f} s")
    c_open = dict(sched.metrics)
    pool_open = engine.prefix_cache_stats()
    t_close = t_open + seconds

    if trace:
        span = min(float(mix["trace_seconds"]), seconds)
        lead = (seconds - span) / 2
        calls.trace_span = (t_open + lead, t_open + lead + span)
    time.sleep(max(0.0, t_close - time.perf_counter()))
    loop.close()
    c_close = dict(sched.metrics)
    pool_close = engine.prefix_cache_stats()

    firsts = any(m["name"].startswith("ttft") for m in spec.end_to_end)

    def drained() -> bool:
        finished = sum(1 for r in loop.records if r.reason == "length")
        return finished >= mix["check_requests"] and (not firsts or all(
            r.first is not None or r.done_at is not None
            for r in loop.records if t_open <= r.sent < t_close))

    t_drain = time.perf_counter()
    loop.wait(drained, timeout=DRAIN_S)
    log(f"drain {time.perf_counter() - t_drain:.3f} s after the close")
    loop.cancel_all()
    sched.stop(timeout=300)
    if sched._thread is not None and sched._thread.is_alive():
        raise RuntimeError("the scheduler did not stop within 300 s")
    peak = (torch.cuda.max_memory_allocated()
            if device == "cuda" else 0)
    prof_trace, trace_host = None, None
    if trace:
        from portbench.lib import trace as tr

        calls.stop_trace()
        if calls.prof is None:
            raise RuntimeError("no engine call came inside the traced span")
        t_read = time.perf_counter()
        prof_trace, trace_host = tr.read(calls.prof), calls.traced
        calls.prof = None
        owned = sum(1 for o in prof_trace.ops if o.call is not None)
        log(f"trace read in {time.perf_counter() - t_read:.3f} s: "
            f"{len(prof_trace.ops)} device operations, {owned} of them "
            f"launched in {len(prof_trace.ranges)} engine calls, window "
            f"{prof_trace.window_s:.3f} s")
    lengths = {i: t.cpu().tolist() for i, t in calls.lengths.items()}
    records, call_list = list(loop.records), list(calls.calls)
    bad = forbidden_modules()
    # The program is freed before the reference runs: the reference's
    # memory must not set the peak, and needs the room.
    calls.engine = calls.lengths = None
    del engine, sched, loop, calls
    _free_program()

    ctx = Context(spec=spec, seed=seed, seconds=seconds, dims=dims,
                  deployment=cfg_file["deployment"], records=records,
                  calls=call_list, t_open=t_open, t_close=t_close,
                  setup_s=setup_s, counters=(c_open, c_close),
                  pool=(pool_open, pool_close), trace=prof_trace,
                  trace_host=trace_host, lengths=lengths)
    return Served(ctx, chips, device, int(peak), smi, bad)


def report(served: Served, judged: Judged, bench_dir: Path = BENCH_DIR
           ) -> dict:
    """The result line's object: with a traced run the per-layer metrics,
    else the end-to-end ones; the numbers compared come last."""
    ctx = served.ctx
    result = {"correct": check.correct(judged.checks),
              "attempted": len(ctx.records), "failed": len(judged.failed)}
    wanted = (ctx.spec.per_layer if ctx.trace is not None
              else ctx.spec.end_to_end)
    metrics = {}
    for m in wanted:
        value = reader(m["name"], bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    cuda = served.device == "cuda"
    card = {"platform": "gpu" if cuda else served.device,
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": served.chips, "memory_peak_bytes": served.peak}
    if served.smi:
        card["power_limit"] = served.smi
    if ctx.trace is not None:
        card["busy_s"] = ctx.trace.busy_s()
        card["window_s"] = ctx.trace.window_s
        result["breakdown"] = {
            "device_ops": ctx.trace.top_ops(10),
            "idle_gaps": [[what, s] for s, what in ctx.trace.gaps]}
    result["device"] = card
    result["forbidden_modules"] = served.forbidden
    result["checks"] = judged.checks
    return result


def run(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
        *, t_start: float, device: str = "cuda", bench_dir: Path = BENCH_DIR,
        log=print) -> dict:
    """One run; returns the result line's object."""
    served = measure(root, cell_name, seed, seconds, trace,
                     t_start=t_start, device=device, bench_dir=bench_dir,
                     log=log)
    ctx = served.ctx
    judged = judge(ctx.spec.cfg_file, ctx.spec.mix, ctx.records, seed,
                   torch.device(device), log)
    judged.ref = None
    return report(served, judged, bench_dir)
