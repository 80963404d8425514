"""RPT1xx — twin-boundary analyzers (the port's RPL1xx).

The paper's premise (§3.2) is that on-chip learning sees only the
*observable* chip state: the end-to-end UΣV* response, the commanded
(not realized) settings, and metered probe results.  The digital twin's
ground truth (realized unitaries, drift state, exact mapping distances)
exists in the port only for diagnostics, quarantined behind
``driver.unsafe_twin()``.  Code that reaches around that hatch silently
turns the in-situ protocol into the idealized-model training the paper
exists to avoid, and would break outright on a real instrument driver
(where the twin modules do not exist).

The rules are the reference's, over the port's module map: the internals
are ``repro_torch.hw``'s ``twin`` / ``device`` / ``drift`` / ``jobs`` /
``server``, and each allowlist entry is the port counterpart of one of
the reference's.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .astutil import SourceFile, line_at
from .findings import Finding, Rule

__all__ = ["RULES", "INTERNAL_MODULES", "INTERNAL_SYMBOLS",
           "UNSAFE_TWIN_ALLOWLIST"]

# modules of repro_torch.hw that are device-side internals: the twin
# physics, the realization sampler, the OU drift walk, the in-situ search
# jobs, and the wire server that hosts them.  Only repro_torch.hw itself
# may import these; everything else routes through the `repro_torch.hw`
# package surface (re-exported configs/factories) or `driver.unsafe_twin()`
INTERNAL_MODULES = frozenset(["twin", "device", "drift", "jobs", "server"])

# symbols that only exist device-side; control-plane code naming them
# (outside an unsafe_twin() chain) has crossed the boundary
INTERNAL_SYMBOLS = frozenset([
    "DeviceRealization", "sample_device", "realized_unitaries",
    "realized_blocks", "DriftState", "init_drift", "TwinHandle",
    "chip_forward",
])
# legal only through the hatch: `driver.unsafe_twin().<attr>`
HATCH_ONLY_ATTRS = frozenset(["true_mapping_distance", "bias_deviation"])

# where twin internals may be imported and named: the reference's
# (repro.hw, repro.analysis, tests, benchmarks, examples) mapped onto the
# port, whose benchmarks live inside the package and whose script-level
# check is chip_smoke.py; plus repro_torch.convert, which carries a
# reference twin's realization and drift state into a port twin for the
# lockstep parity tests (its callers are tests)
DIAGNOSTIC = ("repro_torch.hw", "repro_torch.analysis",
              "repro_torch.benchmarks", "repro_torch.convert", "tests",
              "chip_smoke")

# where unsafe_twin() may be *called*: the above, and the fleet
# registry's true_*distances diagnostics (the reference's
# repro.runtime.fleet).  None of the port's example modules
# (quickstart, train_lm, onchip_transfer) calls it, so none is listed
UNSAFE_TWIN_ALLOWLIST = DIAGNOSTIC + ("repro_torch.runtime.fleet",)


def _is_exempt(sf: SourceFile, prefixes) -> bool:
    return any(sf.in_package(p) for p in prefixes)


def _import_targets(node: ast.AST) -> Iterator[tuple[str, ast.AST]]:
    """(dotted module, node) for every module an import statement touches."""
    if isinstance(node, ast.Import):
        for alias in node.names:
            yield alias.name, node
    elif isinstance(node, ast.ImportFrom):
        mod = "." * node.level + (node.module or "")
        yield mod, node
        for alias in node.names:
            # `from ..hw import twin` / `from repro_torch.hw import jobs`
            yield f"{mod}.{alias.name}", node


def _targets_internal(mod: str) -> str | None:
    """The internal hw module a dotted import path reaches, if any.

    Matches absolute (``repro_torch.hw.twin``), relative (``..hw.drift``)
    and bare (``hw.device``) spellings.
    """
    parts = [p for p in mod.lstrip(".").split(".") if p]
    for i, p in enumerate(parts):
        if p == "hw" and i + 1 < len(parts) and parts[i + 1] in INTERNAL_MODULES:
            return parts[i + 1]
    return None


def check_twin_imports(corpus) -> Iterator[Finding]:
    for sf in corpus:
        if _is_exempt(sf, DIAGNOSTIC):
            continue
        seen = set()
        for node in ast.walk(sf.tree):
            for mod, at in _import_targets(node):
                hit = _targets_internal(mod)
                if hit is not None and (at, hit) not in seen:
                    seen.add((at, hit))
                    yield Finding(
                        "RPT101", sf.rel, at.lineno, at.col_offset,
                        f"import of twin-internal module 'hw.{hit}' outside "
                        f"repro_torch.hw: route through the repro_torch.hw "
                        f"package surface or driver.unsafe_twin()",
                        line_at(sf, at))


def check_unsafe_twin_callsites(corpus) -> Iterator[Finding]:
    for sf in corpus:
        if _is_exempt(sf, UNSAFE_TWIN_ALLOWLIST):
            continue
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "unsafe_twin"):
                yield Finding(
                    "RPT102", sf.rel, node.lineno, node.col_offset,
                    "unsafe_twin() call outside the diagnostic allowlist "
                    "(tests, chip_smoke, repro_torch.hw, .benchmarks, "
                    ".convert, .runtime.fleet): control-plane code must "
                    "stay on the observable surface",
                    line_at(sf, node))


def _via_hatch(node: ast.Attribute) -> bool:
    """True when the attribute hangs off an ``unsafe_twin()`` chain."""
    for sub in ast.walk(node.value):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "unsafe_twin"):
            return True
        if isinstance(sub, ast.Name) and "unsafe" in sub.id:
            # a handle variable like `h = driver.unsafe_twin()`: covered
            # by the RPT102 allowlist at the call site
            return True
    return False


def check_twin_symbols(corpus) -> Iterator[Finding]:
    for sf in corpus:
        if _is_exempt(sf, DIAGNOSTIC):
            continue
        for node in ast.walk(sf.tree):
            name = None
            if isinstance(node, ast.Name) and node.id in INTERNAL_SYMBOLS:
                name = node.id
            elif isinstance(node, ast.Attribute):
                if node.attr in INTERNAL_SYMBOLS:
                    name = node.attr
                elif node.attr in HATCH_ONLY_ATTRS and not _via_hatch(node):
                    name = node.attr
            if name is not None:
                yield Finding(
                    "RPT103", sf.rel, node.lineno, node.col_offset,
                    f"twin-internal symbol {name!r} referenced in "
                    f"control-plane code: only reachable through "
                    f"driver.unsafe_twin() in allowlisted diagnostics",
                    line_at(sf, node))


RULES = [
    Rule(
        "RPT101", "twin-internal import boundary", check_twin_imports,
        "Only modules inside `repro_torch.hw` (and the diagnostic "
        "contexts: tests, chip_smoke.py, `repro_torch.benchmarks`, "
        "`repro_torch.convert`, `repro_torch.analysis`) may import the "
        "device-side internals `hw.twin`, `hw.device`, `hw.drift`, "
        "`hw.jobs`, or `hw.server` (any spelling: absolute, relative, "
        "bare, or `from ..hw import twin`).\n\n"
        "Why: those modules hold the simulated ground truth (realized "
        "unitaries, OU drift state) that does not exist on real "
        "hardware.  Control-plane code that imports them trains on "
        "information the chip cannot give it (the idealized-model "
        "failure mode L2ight §3.2 exists to avoid) and crashes on a real "
        "instrument driver.\n\n"
        "Fix: import the re-exported configuration/factory surface from "
        "`repro_torch.hw` (e.g. `from ..hw import DriftConfig, "
        "make_twin`), or route twin readouts through "
        "`driver.unsafe_twin()` from an allowlisted diagnostic.\n\n"
        "Counterpart of the reference's RPL101."),
    Rule(
        "RPT102", "unsafe_twin() call-site allowlist",
        check_unsafe_twin_callsites,
        "`driver.unsafe_twin()` is the single audited escape hatch to "
        "twin ground truth, and its call sites are restricted to: tests, "
        "chip_smoke.py, `repro_torch.hw` itself, "
        "`repro_torch.benchmarks`, `repro_torch.convert` (the parity "
        "tests' carrier of reference state) and "
        "`repro_torch.runtime.fleet`'s true_*distances diagnostics.\n\n"
        "Why: every call site is a place the stack depends on "
        "information a real chip cannot provide.  Keeping the list "
        "explicit (and small) keeps the hardware-in-the-loop claim "
        "auditable: on real hardware the hatch raises TwinUnavailable, "
        "so anything outside diagnostics would break.\n\n"
        "Fix: compute the quantity from observable probes "
        "(driver.forward / readback_bases), or move the diagnostic into "
        "tests/benchmarks.  Extending the allowlist is an explicit, "
        "reviewed edit to repro_torch/analysis/rules_twin.py.\n\n"
        "Counterpart of the reference's RPL102."),
    Rule(
        "RPT103", "twin-internal symbol quarantine", check_twin_symbols,
        "Control-plane code (src/repro_torch outside repro_torch.hw and "
        "the diagnostic contexts) may not reference device-side symbols "
        "(DeviceRealization, sample_device, realized_unitaries, "
        "DriftState, init_drift, TwinHandle, chip_forward, ...), and may "
        "reach `true_mapping_distance` / `bias_deviation` only through an "
        "`unsafe_twin()` chain.\n\n"
        "Why: naming these symbols at all means the code's logic depends "
        "on unobservable state.\n\n"
        "Fix: as RPT101/RPT102: use the observable driver surface, or "
        "move the code into a diagnostic context.\n\n"
        "Counterpart of the reference's RPL103."),
]
