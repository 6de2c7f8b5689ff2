"""symlint for the port — the project-invariant static-analysis gate over
symmetry_tpu_torch/ (a port of tools/symlint.py).

Runs the eight checkers in symmetry_tpu_torch/analysis/ over the repo,
the JAX package left out of the scan — six flat AST passes plus the two
path-sensitive dataflow checkers (lifecycle, donation) — and exits
non-zero when any finding is not covered by the baseline file, so CI
fails on protocol/concurrency/fault-seam/lifecycle drift in the port
before the test suite starts (a few seconds of `ast.parse` and checker
passes, no torch import, no device). `recompile-hazard` and `donation`
check `jax.jit` regions, which the port does not have: they run and find
nothing to check over its tree.

Usage:
    python -m symmetry_tpu_torch.analysis             # text output
    python -m symmetry_tpu_torch.analysis --json      # machine-readable
    python -m symmetry_tpu_torch.analysis --sarif out.sarif
    python -m symmetry_tpu_torch.analysis --checker wire-contract
    python -m symmetry_tpu_torch.analysis --baseline FILE
    python -m symmetry_tpu_torch.analysis --no-baseline   # show everything
    python -m symmetry_tpu_torch.analysis path/a.py   # report these files

Positional paths FILTER the report, they do not shrink the scan: the
checkers are cross-file by design (a producer's consumer usually lives
in another file), so the whole repo is always analyzed and findings
are then restricted to the named files. Unused-baseline reporting is
suppressed in filtered mode — entries for unlisted files are not
stale.

Baseline workflow: a finding that is intentional (e.g. a per-request
dict key owned by one thread at a time) gets a justified entry in
symmetry_tpu_torch/analysis/baseline.json keyed by its line-number-free
fingerprint (printed with --json, or with --fingerprints in text mode).
Unused baseline entries are reported so stale suppressions cannot
silently shadow a future regression; --strict-baseline turns them into a
failure.

Exit codes: 0 clean (or baseline-only), 1 new findings (or unused
baseline entries under --strict-baseline), 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from symmetry_tpu_torch.analysis import (
    ALL_CHECKERS,
    Baseline,
    run,
    scanned_files,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join("symmetry_tpu_torch", "analysis",
                                "baseline.json")
SCHEMA_VERSION = 1
SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"
SARIF_VERSION = "2.1.0"


def sarif_report(findings, checkers, baseline) -> dict:
    """SARIF 2.1.0 document for `findings`. One rule per finding code
    (its checker's doc as the description); baselined findings carry a
    `suppressions` entry quoting the baseline justification, which
    GitHub code scanning honors (they upload but do not alert), so the
    inline PR annotations show exactly the NEW findings."""
    rules = [{
        "id": code,
        "name": f"{spec.name}/{code}",
        "shortDescription": {"text": f"[{spec.name}] {spec.doc}"},
    } for spec in checkers for code in spec.codes]
    reasons = {}
    if baseline is not None:
        reasons = {e["fingerprint"]: e.get("reason", "")
                   for e in baseline.entries if isinstance(e, dict)}
    results = []
    for f in findings:
        r = {
            "ruleId": f.code,
            "level": "note" if f.baselined else "error",
            "message": {"text": f"[{f.checker}] {f.message}"},
            "partialFingerprints": {
                "symlintFingerprint/v1": f.fingerprint},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "%SRCROOT%"},
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        }
        if f.baselined:
            r["suppressions"] = [{
                "kind": "external",
                "justification": reasons.get(f.fingerprint, ""),
            }]
        results.append(r)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "symlint",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m symmetry_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="repo-relative .py files to REPORT on (the "
                         "scan always covers the whole repo — the "
                         "checkers are cross-file)")
    ap.add_argument("--root", default=_REPO_ROOT,
                    help="repo root to scan (default: this checkout)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--sarif", default=None, metavar="PATH",
                    help="also write a SARIF 2.1.0 report to PATH "
                         "(github/codeql-action/upload-sarif annotates "
                         "PR diffs with it; baselined findings upload "
                         "as suppressed notes)")
    ap.add_argument("--checker", action="append", default=None,
                    metavar="NAME",
                    help="run only this checker (repeatable); "
                         "see --list-checkers")
    ap.add_argument("--list-checkers", action="store_true",
                    help="list checker names and exit")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"suppression file (default: {DEFAULT_BASELINE} "
                         f"under --root when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="fail when baseline entries matched nothing")
    ap.add_argument("--fingerprints", action="store_true",
                    help="append each finding's fingerprint in text mode "
                         "(what a baseline entry must quote)")
    args = ap.parse_args(argv)

    if args.list_checkers:
        for spec in ALL_CHECKERS:
            print(f"{spec.name:18s} {', '.join(spec.codes):38s} {spec.doc}")
        return 0

    checkers = ALL_CHECKERS
    if args.checker:
        by_name = {s.name: s for s in ALL_CHECKERS}
        unknown = [c for c in args.checker if c not in by_name]
        if unknown:
            print(f"symlint: unknown checker(s): {', '.join(unknown)} "
                  f"(have: {', '.join(by_name)})", file=sys.stderr)
            return 2
        checkers = tuple(by_name[c] for c in args.checker)

    baseline = None
    baseline_path = None
    if not args.no_baseline:
        baseline_path = args.baseline or os.path.join(args.root,
                                                      DEFAULT_BASELINE)
        if os.path.exists(baseline_path):
            try:
                baseline = Baseline.load(baseline_path)
            except (ValueError, OSError, json.JSONDecodeError) as exc:
                print(f"symlint: bad baseline {baseline_path}: {exc}",
                      file=sys.stderr)
                return 2
        elif args.baseline:
            print(f"symlint: baseline not found: {baseline_path}",
                  file=sys.stderr)
            return 2

    # Filter paths are root-relative; absolute paths are re-anchored.
    only = {(os.path.relpath(p, args.root) if os.path.isabs(p) else p)
            .replace(os.sep, "/") for p in args.paths}
    try:
        findings = run(args.root, checkers, baseline)
    except (OSError, ValueError) as exc:
        print(f"symlint: {exc}", file=sys.stderr)
        return 2
    if only:
        # A filter entry that matches nothing scanned is a broken
        # invocation (typo, moved file), not a clean result — a hook
        # that silently checks nothing is worse than no hook.
        scanned = set(scanned_files(args.root))
        ghosts = sorted(p for p in only if p not in scanned)
        if ghosts:
            print(f"symlint: path filter matched no scanned file: "
                  f"{', '.join(ghosts)}", file=sys.stderr)
            return 2
        findings = [f for f in findings if f.path in only]

    new = [f for f in findings if not f.baselined]
    old = [f for f in findings if f.baselined]
    # Staleness is only judgeable for what actually ran: in path-
    # filtered mode skip the unused report entirely, and under a
    # --checker filter only consider entries whose code belongs to a
    # selected checker — a C202 suppression is not stale just because
    # this run was wire-contract-only.
    unused: list[str] = []
    if baseline is not None and not only:
        selected_codes = {c for s in checkers for c in s.codes}
        unused = [fp for fp in baseline.unused()
                  if fp.split(":", 1)[0] in selected_codes]

    if args.sarif:
        # Written BEFORE the exit-code decision: a failing run is
        # exactly when CI needs the file to annotate the diff.
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(sarif_report(findings, checkers, baseline), fh,
                      indent=2)
            fh.write("\n")

    if args.as_json:
        report = {
            "version": SCHEMA_VERSION,
            "root": args.root,
            "checkers": [s.name for s in checkers],
            "baseline": baseline_path if baseline is not None else None,
            "findings": [f.to_dict() for f in findings],
            "baseline_unused": unused,
            "counts": {"total": len(findings), "new": len(new),
                       "baselined": len(old)},
        }
        print(json.dumps(report, indent=2))
    else:
        for f in findings:
            print(f.render())
            if args.fingerprints:
                print(f"    fingerprint: {f.fingerprint}")
        for fp in unused:
            print(f"symlint: baseline entry matched nothing "
                  f"(stale? prune it): {fp}", file=sys.stderr)
        summary = (f"symlint: {len(new)} new finding(s), "
                   f"{len(old)} baselined, "
                   f"{len(checkers)} checker(s)")
        print(summary, file=sys.stderr)

    if new:
        return 1
    if unused and args.strict_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
