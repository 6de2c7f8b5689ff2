"""Readings that set a configuration's limits on the served tokens' gaps.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed, in one process, one run of the cell as run.py makes it (a
window of `--seconds`), judged as run.py judges it; then the control put in
the program's place over the same requests (check.control_checks: the
reference one precision below the configuration's), judged by the same
numbers and limits. One JSON line a seed: the program's checks and
`correct`, the control's `correct`, and both sides' gap distributions
(check.gap_stats). The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve()
                       .parent.parent))
from portbench import run as entry  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    entry._caches()
    import torch

    from portbench.lib import check, harness
    from symmetry_tpu_torch.ops import kernels

    kernels.set_build_dir(entry.CACHE / "kernels")

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    t = T_START
    dev = torch.device("cuda")
    for seed in args.seeds:
        served = harness.measure(entry.ROOT, args.workload, seed,
                                 args.seconds, False, t_start=t, log=log)
        ctx = served.ctx
        judged = harness.judge(ctx.spec.cfg_file, ctx.spec.mix, ctx.records,
                               seed, dev, log)
        program_gaps = control_gaps = control = None
        if judged.picked:
            program_gaps = check.gap_stats(
                judged.ref, [torch.tensor(r.tokens, device=dev)
                             for r in judged.picked],
                check.thresholds(ctx.spec.cfg_file["check"]))
            control_gaps, control = check.control_checks(
                ctx.spec.cfg_file, seed, judged.picked, judged.ref, dev)
        judged.ref = None
        r = harness.report(served, judged)
        print(json.dumps({
            "seed": seed, "correct": r["correct"],
            "checks": {k: v["value"] for k, v in r["checks"].items()},
            "control_correct": (check.correct(control)
                                if control is not None else None),
            "gaps": {"program": program_gaps, "control": control_gaps},
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "memory_peak_bytes": r["device"]["memory_peak_bytes"]}),
            flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
