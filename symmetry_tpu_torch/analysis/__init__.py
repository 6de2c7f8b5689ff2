"""symlint: project-invariant static analysis (see __main__.py).

Eight checkers over the repo, each making one runtime invariant
statically checkable. Six are flat AST passes:

  wire-contract     host-pipe op / MessageKey producer↔consumer sets
  concurrency       cross-thread mutation locks; blocking-in-async
  recompile-hazard  value syncs / data branches inside jit traces
  fault-seam        SYMMETRY_FAULTS arming ↔ FAULTS.point guards
  metric-names      MetricName registry ↔ METRICS emission sites
  knobs             tpu.* knobs: TpuConfig ↔ README ↔ read sites

and two are path-sensitive, built on the CFG + abstract-state walker
in dataflow.py (one node per statement, exception/finally/early-return
edges, per-path states — the PR-12 class of bug lives only on paths):

  lifecycle         paired resources (radix pins, insert plans, pool
                    blocks, bare locks) released on EVERY path out,
                    exception edges included; double-release;
                    use-after-release
  donation          jax.jit donate_argnums buffers never read after
                    the jitted call without rebinding

Run via `python -m symmetry_tpu_torch.analysis` (text, --json, or --sarif
output, --baseline suppression file, exit 1 on non-baselined findings).
The suite is also importable — `run(root)` — which is how
tests/test_torch_analysis.py asserts the port itself stays clean.
"""

from __future__ import annotations

from symmetry_tpu_torch.analysis import (
    concurrency,
    donation,
    fault_seams,
    knobs,
    lifecycle,
    metric_names,
    recompile,
    wire_contract,
)
from symmetry_tpu_torch.analysis.core import (
    Baseline,
    CheckerSpec,
    Finding,
    Project,
    iter_py_files,
    run_suite,
)

ALL_CHECKERS: tuple[CheckerSpec, ...] = (
    wire_contract.SPEC,
    concurrency.SPEC,
    recompile.SPEC,
    fault_seams.SPEC,
    metric_names.SPEC,
    lifecycle.SPEC,
    donation.SPEC,
    knobs.SPEC,
)


def scanned_files(root: str) -> list[str]:
    """Every .py file under `root` except the JAX package's. The lookups
    that take the first file defining a class (`TpuConfig`, the wire and
    metric registries) then read the port's own."""
    return [r for r in iter_py_files(root)
            if not r.startswith("symmetry_tpu/")]


def run(root: str, checkers: tuple[CheckerSpec, ...] = ALL_CHECKERS,
        baseline: Baseline | None = None,
        rels: list[str] | None = None) -> list[Finding]:
    """Scan `root` (or just `rels` under it) with the given checkers."""
    project = Project.scan(root, rels if rels is not None
                           else scanned_files(root))
    return run_suite(project, checkers, baseline)


__all__ = ["ALL_CHECKERS", "Baseline", "CheckerSpec", "Finding",
           "Project", "run", "run_suite", "scanned_files"]
