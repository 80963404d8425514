"""Corpus walking, rule execution, ``noqa`` and baseline filtering.

Pure stdlib.  The engine parses every ``.py`` file under the requested
paths once into :class:`~repro_torch.analysis.astutil.SourceFile`
objects and hands the whole corpus to each rule: cross-file rules (the
RPT2xx wire checks, the RPT4xx kernel interface) need the full set, and
single-file rules just iterate it.  The RPT4xx rules read the CUDA
sources themselves, from the ``csrc`` directory beside the linted
``kernels`` package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable

from .astutil import SourceFile
from .findings import Finding, Rule, fingerprint, noqa_codes
from . import (rules_capture, rules_determinism, rules_kernels, rules_twin,
               rules_wire)

__all__ = ["LintResult", "all_rules", "rule_by_code", "run_lint",
           "load_corpus", "load_baseline", "baseline_payload"]

_RULE_MODULES = (rules_twin, rules_wire, rules_capture, rules_kernels,
                 rules_determinism)

_SKIP_DIRS = frozenset(["__pycache__", ".git", ".venv", "node_modules",
                        "build", "dist", ".mypy_cache", ".ruff_cache"])


def all_rules() -> list[Rule]:
    rules: list[Rule] = []
    for mod in _RULE_MODULES:
        rules.extend(mod.RULES)
    return sorted(rules, key=lambda r: r.code)


def rule_by_code(code: str) -> Rule | None:
    for rule in all_rules():
        if rule.code == code:
            return rule
    return None


def _rel(path: str, root: str) -> str:
    """Invocation-relative display path.  Prefer cwd-relative (so repo-
    root runs produce the stable ``src/repro_torch/...`` paths a
    baseline fingerprints); fall back to root-relative for corpora
    outside the cwd (fixture trees in tests)."""
    rel = os.path.relpath(path)
    if not rel.startswith(".."):
        return rel
    root = os.path.abspath(root)
    base = os.path.dirname(root)
    return os.path.relpath(path, base)


def load_corpus(paths: Iterable[str]):
    """Parse every .py under ``paths`` (files or directories).

    Returns ``(corpus, errors)`` where errors are ``(path, message)``
    for unparseable files — reported, never silently skipped.
    """
    corpus: list[SourceFile] = []
    errors: list[tuple[str, str]] = []
    seen: set[str] = set()
    for root in paths:
        files: list[tuple[str, str]] = []
        if os.path.isfile(root):
            files.append((root, _rel(root, root)))
        else:
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS
                                     and not d.startswith("."))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        full = os.path.join(dirpath, fn)
                        files.append((full, _rel(full, root)))
        for full, rel in files:
            key = os.path.abspath(full)
            if key in seen:
                continue
            seen.add(key)
            try:
                with open(full, encoding="utf-8") as fh:
                    text = fh.read()
                corpus.append(SourceFile(full, rel, text))
            except (SyntaxError, UnicodeDecodeError, OSError) as exc:
                errors.append((rel, f"{type(exc).__name__}: {exc}"))
    return corpus, errors


@dataclasses.dataclass
class LintResult:
    """Outcome of one lint run, after suppression filtering."""

    findings: list          # active Finding objects, sorted
    noqa_suppressed: list   # silenced by `# repro_torch: noqa`
    baseline_suppressed: list   # Finding objects matched by the baseline
    stale_baseline: list    # baseline fingerprints that matched nothing
    errors: list            # (path, message) parse failures

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def as_dict(self) -> dict:
        return {
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": {
                "noqa": [f.as_dict() for f in self.noqa_suppressed],
                "baseline": [f.as_dict() for f in self.baseline_suppressed],
            },
            "stale_baseline": list(self.stale_baseline),
            "errors": [{"path": p, "message": m} for p, m in self.errors],
            "ok": self.ok,
        }


def _sort_key(f: Finding):
    return (f.path, f.line, f.col, f.code)


def run_lint(paths: Iterable[str],
             baseline: Iterable[str] = (),
             codes: Iterable[str] | None = None) -> LintResult:
    """Lint ``paths`` with every rule (or just ``codes``), applying
    per-line ``# repro_torch: noqa[...]`` suppressions and the grandfathered
    ``baseline`` fingerprints."""
    corpus, errors = load_corpus(paths)
    by_rel = {sf.rel: sf for sf in corpus}
    wanted = set(codes) if codes is not None else None

    raw: dict[tuple, Finding] = {}
    for rule in all_rules():
        if wanted is not None and rule.code not in wanted:
            continue
        for f in rule.check(corpus):
            raw.setdefault((f.code, f.path, f.line, f.col, f.message), f)

    baseline_fps = set(baseline)
    active: list[Finding] = []
    noqa_hits: list[Finding] = []
    baseline_hits: list[Finding] = []
    matched_fps: set[str] = set()
    for f in sorted(raw.values(), key=_sort_key):
        sf = by_rel.get(f.path)
        line = sf.line_text(f.line) if sf is not None else f.snippet
        codes_off = noqa_codes(line)
        if codes_off is not None and (not codes_off or f.code in codes_off):
            noqa_hits.append(f)
            continue
        fp = fingerprint(f)
        if fp in baseline_fps:
            matched_fps.add(fp)
            baseline_hits.append(f)
            continue
        active.append(f)
    return LintResult(active, noqa_hits, baseline_hits,
                      sorted(baseline_fps - matched_fps), errors)


def load_baseline(path: str) -> set[str]:
    """Fingerprints from a baseline file; empty set if absent."""
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {e["fingerprint"] for e in data.get("findings", [])}


def baseline_payload(findings: Iterable[Finding]) -> dict:
    """Serializable baseline for the currently-active findings.  Stale
    entries are dropped by construction: only findings observed in this
    run are written."""
    entries = [{
        "fingerprint": fingerprint(f),
        "code": f.code,
        "path": f.path,
        "snippet": f.snippet.strip(),
        "message": f.message,
    } for f in sorted(set(findings), key=_sort_key)]
    return {"version": 1, "findings": entries}
