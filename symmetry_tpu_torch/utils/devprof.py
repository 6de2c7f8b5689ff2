"""symprof: on-device time attribution via sampling completion probes.

Port of symmetry_tpu/utils/devprof.py. `DeviceProfiler` is a sampling-mode
completion probe around every engine dispatch kind (prefill / chunk /
decode_block / verify / adopt / seed_gather / scatter):

  - On a 1-in-N cadence per kind (`tpu.profile_sample: N`; 0 = off), the
    probe records a CUDA event on the current stream after the dispatch's
    last launch and waits for it (the counterpart of the JAX package's
    `jax.block_until_ready`), then timestamps both ends: `t_ready - t_begin`
    is that dispatch's DEVICE DURATION (queue + compute, from the moment
    the host started dispatching). On the CPU the work has finished when
    the dispatch returns, so there is nothing to wait for.
  - The probe drains the stream, so the host time until the NEXT dispatch
    begins is genuine device idle: one DISPATCH GAP sample.
  - Off-mode cost is one attribute load + branch per dispatch (the engine
    guards every hook with `if devprof.enabled:`): no event, no sync.

Results flow as in the JAX package: `stats()` rides the scheduler's stats
(host stats op -> provider `engine` block; `device_s_total` is what the
provider's heartbeat prices device time from), the metrics registry gains
the `sym_device_*` / `sym_dispatch_gap_*` families, and a Tracer ring
records each probed dispatch as a span plus `dispatch_gap` spans, exported
by the host's `trace` op as its `device` component.

`capture_device_profile` is the on-demand heavyweight complement: a bounded
torch.profiler window (utils/trace.py device_trace) whose Chrome/Perfetto
trace names every CUDA kernel the card ran in it, triggered by the host's
`profile` op.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

import torch

from symmetry_tpu_torch.utils.metrics import METRICS, MetricName
from symmetry_tpu_torch.utils.trace import (
    Histogram,
    Tracer,
    device_trace,
    device_trace_activities,
)

# The dispatch kinds the engine wraps. A probe with an unknown kind
# still records (the set is documentation + the smoke's assertion
# vocabulary, not a gate).
DISPATCH_KINDS = ("prefill", "chunk", "decode_block", "verify", "adopt",
                  "seed_gather", "scatter")


def _wait_for_device(value: Any) -> None:
    """Block until the work queued on `value`'s CUDA stream so far has run:
    an event recorded on the current stream after the dispatch's last
    launch, then waited for. A value that is not on a CUDA device (a CPU
    tensor, a host number) has nothing pending. A CUDA value with no usable
    device raises, and the probe books nothing: no host-clock guess stands
    in for a device time."""
    device = getattr(value, "device", None)
    if device is None or torch.device(device).type != "cuda":
        return
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    event.synchronize()


class DeviceProfiler:
    """Sampling completion probe over engine dispatches.

    Thread model: `begin`/`probe` run on the ENGINE thread only (the
    engine's single-threaded contract); `stats()` may be called from
    the host's pipe-reader thread, so the shared tallies mutate and
    snapshot under one lock — probes fire 1-in-N, so the critical
    section is nowhere near the hot path's per-dispatch cost.
    """

    def __init__(self, sample_every: int = 0,
                 tracer: Tracer | None = None) -> None:
        self.sample_every = max(0, int(sample_every))
        self.enabled = self.sample_every > 0
        # Bounded span ring: probed dispatches + gaps, exported as the
        # per-host "device" Perfetto component.
        self.tracer = tracer if tracer is not None else Tracer(capacity=2048)
        self.tracer.enabled = self.enabled
        self._lock = threading.Lock()
        # PER-KIND dispatch counters (every dispatch, probed or not): the
        # cadence is 1-in-N of EACH kind, so frequent decode blocks cannot
        # absorb every probe slot and leave rare kinds unprobed.
        self._dispatches: dict[str, int] = {}
        self._probes: dict[str, int] = {}
        self._kind_hists: dict[str, Histogram] = {}
        self._gap_hist = Histogram()
        self._device_s = 0.0
        self._gap_s = 0.0
        # Completion stamp of the last probed dispatch; the NEXT
        # begin() closes it into one gap sample. Engine-thread-only.
        self._gap_from: float | None = None
        self._m_dispatch = METRICS.histogram(
            MetricName.DEVICE_DISPATCH,
            "probed device duration per dispatch kind", labels=("kind",))
        self._m_probes = METRICS.counter(
            MetricName.DEVICE_PROBES,
            "completion probes fired per dispatch kind", labels=("kind",))
        self._m_gap = METRICS.histogram(
            MetricName.DISPATCH_GAP,
            "host idle between a probed device completion and the next "
            "dispatch")
        self._m_gap_share = METRICS.gauge(
            MetricName.DISPATCH_GAP_SHARE,
            "dispatch-gap share of probed engine wall "
            "(gap / (gap + device))")

    # ------------------------------------------------------------ hot path

    def begin(self) -> float:
        """Stamp a dispatch's start. Closes the pending gap when the
        PREVIOUS dispatch was probed: the probe drained the stream, so
        start - last_ready is genuine device idle. Call on every dispatch
        while enabled (the caller's `if devprof.enabled:` guard is the
        whole off-mode cost)."""
        t = time.monotonic()
        gap_from = self._gap_from
        if gap_from is not None:
            self._gap_from = None
            gap = max(t - gap_from, 0.0)
            self._gap_hist.observe(gap)
            self._m_gap.observe(gap)
            with self._lock:
                self._gap_s += gap
                share = (self._gap_s / (self._gap_s + self._device_s)
                         if (self._gap_s + self._device_s) > 0 else 0.0)
            self._m_gap_share.set(round(share, 4))
            self.tracer.record("dispatch_gap", gap_from, gap)
        return t

    def probe(self, kind: str, value: Any, t0: float) -> None:
        """Maybe-probe a dispatch that began at `t0` (a begin() stamp):
        on the 1-in-N cadence, wait until the work queued on `value`'s
        stream (a tensor the dispatch produced) has run and book
        t_ready - t0 as the dispatch's device duration. Never raises — a
        probe failure must not fail the dispatch it rode."""
        if not self.enabled:
            return  # direct calls with the knob off are no-ops too
        n = self._dispatches.get(kind, 0) + 1
        self._dispatches[kind] = n
        if n % self.sample_every:
            return
        try:
            _wait_for_device(value)
        except Exception:  # noqa: BLE001 — diagnostics must never fail work
            return
        t1 = time.monotonic()
        dur = max(t1 - t0, 0.0)
        with self._lock:
            self._probes[kind] = self._probes.get(kind, 0) + 1
            hist = self._kind_hists.get(kind)
            if hist is None:
                hist = self._kind_hists[kind] = Histogram()
            self._device_s += dur
        hist.observe(dur)
        self._m_dispatch.observe(dur, kind=kind)
        self._m_probes.inc(kind=kind)
        self.tracer.record(kind, t0, dur)
        self._gap_from = t1

    # ----------------------------------------------------------- snapshots

    def gap_share(self) -> float | None:
        """Gap fraction of probed engine wall, None before any gap
        sample — the steady-state device-idle share headline."""
        with self._lock:
            total = self._gap_s + self._device_s
            if self._gap_hist.count == 0 or total <= 0:
                return None
            return self._gap_s / total

    def stats(self) -> dict[str, Any]:
        """The bench/stats-op block: per-kind device-duration
        percentiles, the dispatch-gap distribution, and the share."""
        with self._lock:
            hists = dict(self._kind_hists)
            probes = dict(self._probes)
            dispatches = dict(self._dispatches)
            device_s, gap_s = self._device_s, self._gap_s
        out: dict[str, Any] = {
            "sample_every": self.sample_every,
            "dispatches": dispatches,
            "probes": probes,
            "device_s": {kind: h.to_dict() for kind, h in hists.items()},
            "device_s_total": round(device_s, 4),
            "dispatch_gap_s": self._gap_hist.to_dict(),
            "dispatch_gap_s_total": round(gap_s, 4),
        }
        share = self.gap_share()
        out["gap_share"] = round(share, 4) if share is not None else None
        return out

    def component(self, name: str = "device") -> dict[str, Any]:
        """The probe span ring as one export_perfetto component — the
        per-host device track beside the request spans."""
        return self.tracer.component(name)


# ------------------------------------------------------ on-demand capture


def init_capture() -> None:
    """Start and stop one empty torch.profiler session on the calling
    thread. The profiler's CUDA tracing (Kineto over CUPTI) initializes in
    the thread that first starts a session, and only there if that is the
    thread that registered it: a first session started on another thread
    (the host's `profile` op runs on its own) records no kernels. The host
    calls this on its main thread at its first `profile` op, with a CUDA
    engine (the engine held meanwhile)."""
    from torch.profiler import profile

    with profile(activities=device_trace_activities()):
        pass

# One capture at a time per process: a second torch.profiler session would
# fail mid-serve, so a concurrent request is refused up front. The busy flag
# is guarded by the lock (never held across the capture window — the
# window is seconds long on purpose).
_capture_lock = threading.Lock()
_capture_busy = False


def capture_device_profile(out_dir: str, duration_s: float = 2.0,
                           gate: Any = None) -> str:
    """Run one bounded torch.profiler capture and return its directory,
    which holds `trace.json` (Chrome trace events, loadable in Perfetto:
    the CUDA kernels the card ran in the window, launched from any thread,
    such as the engine's). Raises RuntimeError when a capture is already
    in progress — callers surface that, never queue behind it. `gate`
    (device_trace) is held around the profiler's start and stop."""
    global _capture_busy

    with _capture_lock:
        if _capture_busy:
            raise RuntimeError(
                "a device profile capture is already running")
        _capture_busy = True
    try:
        import uuid

        # Timestamp for the operator's eye + a uuid tail for uniqueness:
        # two captures inside the same second must not intermix their
        # artifacts in one directory.
        path = os.path.join(
            os.path.expanduser(out_dir),
            f"profile_{int(time.time())}_{uuid.uuid4().hex[:8]}")
        with device_trace(path, gate):
            time.sleep(max(0.0, float(duration_s)))
        return path
    finally:
        with _capture_lock:
            _capture_busy = False
