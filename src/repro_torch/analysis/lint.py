"""CLI of the port's checker: ``python -m repro_torch.analysis.lint [paths...]``.

Exit status: 0 when no active findings (suppressed/baselined findings do
not fail), 1 on findings, parse errors, or a failed ``--self-test``, 2 on
usage errors.
"""

from __future__ import annotations

import argparse
import json
import sys

from .engine import (all_rules, baseline_payload, load_baseline,
                     rule_by_code, run_lint)

DEFAULT_BASELINE = "repro-torch-lint-baseline.json"
DEFAULT_PATHS = ["src/repro_torch", "chip_smoke.py"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's AST checker: twin boundary (RPT1xx), wire "
                    "trio (RPT2xx), graph-capture and recompute safety "
                    "(RPT3xx), the CUDA kernels' C interface (RPT4xx), "
                    "determinism (RPT5xx).")
    p.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                   help="files/directories to lint (default: "
                        f"{' '.join(DEFAULT_PATHS)})")
    p.add_argument("--json", metavar="FILE", default=None,
                   help="also write machine-readable findings to FILE "
                        "('-' for stdout)")
    p.add_argument("--baseline", metavar="FILE", default=DEFAULT_BASELINE,
                   help=f"baseline of grandfathered finding fingerprints "
                        f"(default: {DEFAULT_BASELINE}; absent = empty)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from the currently active "
                        "findings (stale entries are dropped) and exit 0")
    p.add_argument("--select", metavar="CODES", default=None,
                   help="comma-separated rule codes to run (default: all)")
    p.add_argument("--explain", metavar="CODE", default=None,
                   help="print the invariant behind a rule code and exit")
    p.add_argument("--list-rules", action="store_true",
                   help="list all rule codes and exit")
    p.add_argument("--self-test", action="store_true",
                   help="inject one violation per rule into fixture trees "
                        "and verify every rule fires (and stays quiet on "
                        "clean twins)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the summary line")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.code}  {rule.name}")
        return 0

    if args.explain is not None:
        rule = rule_by_code(args.explain.strip().upper())
        if rule is None:
            print(f"unknown rule code {args.explain!r}; known codes:",
                  ", ".join(r.code for r in all_rules()), file=sys.stderr)
            return 2
        print(f"{rule.code} — {rule.name}\n")
        print(rule.explain)
        return 0

    if args.self_test:
        from .selftest import run_self_test
        return 0 if run_self_test() else 1

    codes = None
    if args.select is not None:
        codes = [c.strip().upper() for c in args.select.split(",")
                 if c.strip()]
        known = {r.code for r in all_rules()}
        bad = sorted(set(codes) - known)
        if bad:
            print(f"unknown rule code(s): {', '.join(bad)}",
                  file=sys.stderr)
            return 2

    baseline = load_baseline(args.baseline)
    result = run_lint(args.paths, baseline=baseline, codes=codes)

    if args.update_baseline:
        grandfathered = result.findings + result.baseline_suppressed
        payload = baseline_payload(grandfathered)
        with open(args.baseline, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"{args.baseline}: {len(payload['findings'])} finding(s) "
              f"baselined ({len(result.stale_baseline)} stale entries "
              f"dropped)")
        return 0

    if args.json is not None:
        text = json.dumps(result.as_dict(), indent=2)
        if args.json == "-":
            print(text)
        else:
            with open(args.json, "w", encoding="utf-8") as fh:
                fh.write(text + "\n")

    for path, msg in result.errors:
        print(f"{path}: parse error: {msg}", file=sys.stderr)
    for f in result.findings:
        print(f.format())
    for fp in result.stale_baseline:
        print(f"warning: stale baseline entry {fp} matched nothing "
              f"(run --update-baseline to drop it)", file=sys.stderr)

    if not args.quiet:
        n = len(result.findings)
        parts = [f"{n} finding(s)"]
        if result.noqa_suppressed:
            parts.append(f"{len(result.noqa_suppressed)} noqa-suppressed")
        if result.baseline_suppressed:
            parts.append(f"{len(result.baseline_suppressed)} baselined")
        if result.errors:
            parts.append(f"{len(result.errors)} parse error(s)")
        status = "clean" if result.ok else "FAILED"
        print(f"repro-torch-lint: {status} — " + ", ".join(parts))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
