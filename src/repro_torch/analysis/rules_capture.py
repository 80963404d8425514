"""RPT3xx — graph-capture and recompute safety (the port's RPL3xx).

The reference's tracer rules guard bodies that jax traces once and
replays.  The port's counterparts are the bodies that PyTorch records or
re-runs:

* **CUDA-graph captures.**  A body handed to ``hw/jobs.py::_capture``,
  run inside ``with torch.cuda.graph(...)``, or run between a graph's
  ``capture_begin()`` and ``capture_end()`` is recorded once and replayed
  on the card.  A host sync in it (``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``) breaks the capture; a host-side value in
  it (``time.*``, ``np.random.*``, ``torch.manual_seed``, ``print``) is
  run once, at capture, and frozen into every replay.  The launch
  counters are the exception by design: ``build.count_launch`` counts
  into the capture's tally (``build.tally_launches``), which each replay
  adds.
* **Activation recompute.**  A function passed to
  ``torch.utils.checkpoint.checkpoint`` runs again in the backward.  The
  same host effects there sync the card twice or draw twice, and a
  ``ptc_execution`` install there runs the hardware hook a second time
  during the backward, metering and perturbing the chip for a pass the
  user never asked for.

The rules are lexical: a captured or recomputed body is the function (or
lambda) handed to one of the above, and every function of the same
module it calls by name, followed transitively.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .astutil import SourceFile, call_name, line_at
from .findings import Finding, Rule

__all__ = ["RULES", "captured_bodies"]

# callee leaf -> (reason, index of the body argument)
BODY_CALLS = {
    "_capture": ("captured as a CUDA graph by _capture", 0),
    "checkpoint": ("re-run in the backward by torch.utils.checkpoint", 0),
}

# method calls that copy a device value to the host
HOST_SYNCS = frozenset(["item", "cpu", "tolist", "numpy"])

# callees whose value is host state: run once at capture, then frozen
HOST_EFFECTS = ("time.", "np.random.", "numpy.random.", "random.")
HOST_EFFECT_NAMES = frozenset(["print", "torch.manual_seed",
                               "torch.cuda.manual_seed",
                               "torch.cuda.manual_seed_all",
                               "torch.cuda.synchronize"])


def _defs_by_name(sf: SourceFile) -> dict:
    out: dict[str, list] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def _callable_roots(arg: ast.AST, defs: dict) -> list:
    """The bodies an argument names: a lambda (and every def its body
    calls by name, the thunk's target), or a def by name."""
    if isinstance(arg, ast.Lambda):
        return [arg]
    if isinstance(arg, ast.Name):
        return list(defs.get(arg.id, []))
    return []


def _closure(roots: list, defs: dict) -> list:
    """The roots and every def of the module they call by name."""
    seen: dict[int, ast.AST] = {}
    todo = list(roots)
    while todo:
        fn = todo.pop()
        if id(fn) in seen:
            continue
        seen[id(fn)] = fn
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name):
                    todo.extend(defs.get(node.func.id, []))
    return list(seen.values())


def _capture_span(block: list) -> list:
    """The statements of ``block`` after a ``*.capture_begin(...)`` up to
    the matching ``*.capture_end()`` (or the block's end: the end often
    sits in a ``finally``), nested statement lists searched too."""
    out = []
    inside = False
    for stmt in block:
        name = None
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            name = call_name(stmt.value)
        if name and name.endswith(".capture_begin"):
            inside = True
        elif name and name.endswith(".capture_end"):
            inside = False
        elif inside:
            out.append(stmt)
        else:
            for sub in _stmt_lists(stmt):
                out.extend(_capture_span(sub))
    return out


def _stmt_lists(stmt: ast.AST) -> list:
    """The statement lists nested in a compound statement (not in a
    nested def or class: those are scopes of their own)."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    lists = [getattr(stmt, f) for f in ("body", "orelse", "finalbody")
             if isinstance(getattr(stmt, f, None), list)]
    lists += [h.body for h in getattr(stmt, "handlers", None) or []]
    return lists


def captured_bodies(sf: SourceFile) -> list:
    """(nodes, reason) for every captured or recomputed body in ``sf``:
    ``nodes`` is a list of function/lambda nodes or of statements.  Kept
    on ``sf``: both rules read it."""
    if not hasattr(sf, "_captured"):
        sf._captured = _find_captured(sf)
    return sf._captured


def _find_captured(sf: SourceFile) -> list:
    defs = _defs_by_name(sf)
    found = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            name = call_name(node)
            leaf = name.rsplit(".", 1)[-1] if name else None
            if leaf in BODY_CALLS:
                reason, i = BODY_CALLS[leaf]
                if i < len(node.args):
                    roots = _callable_roots(node.args[i], defs)
                    if roots:
                        found.append((_closure(roots, defs), reason))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call) and (
                        call_name(item.context_expr) or "").endswith(
                            "cuda.graph"):
                    found.append((_with_calls(node.body, defs),
                                  "captured inside torch.cuda.graph(...)"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Module)):
            span = _capture_span(node.body)
            if span:
                found.append((_with_calls(span, defs),
                              "captured between capture_begin() and "
                              "capture_end()"))
    return found


def _with_calls(stmts: list, defs: dict) -> list:
    """Statements plus the module defs they call by name (transitively)."""
    called = []
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                called.extend(defs.get(node.func.id, []))
            elif isinstance(node, ast.Lambda):
                called.append(node)
    return list(stmts) + _closure(called, defs)


def _walk_bodies(nodes: list):
    """Every node under the given functions' bodies / statements, each
    once."""
    seen = set()
    for fn in nodes:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda)):
            body = fn.body if isinstance(fn.body, list) else [fn.body]
        else:
            body = [fn]
        for stmt in body:
            for node in ast.walk(stmt):
                if id(node) not in seen:
                    seen.add(id(node))
                    yield node


def _host_effect(name: str) -> bool:
    return name in HOST_EFFECT_NAMES or name.startswith(HOST_EFFECTS)


def check_host_effects(corpus) -> Iterator[Finding]:
    for sf in corpus:
        reported = set()
        for nodes, reason in captured_bodies(sf):
            for node in _walk_bodies(nodes):
                if not isinstance(node, ast.Call) or id(node) in reported:
                    continue
                name = call_name(node)
                what = None
                if name is not None and _host_effect(name):
                    what = f"host-side call {name}()"
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in HOST_SYNCS and not node.args):
                    what = f"host sync .{node.func.attr}()"
                if what is None:
                    continue
                reported.add(id(node))
                yield Finding(
                    "RPT301", sf.rel, node.lineno, node.col_offset,
                    f"{what} in a body {reason}: a capture breaks on it or "
                    f"freezes its value into every replay; a recompute runs "
                    f"it twice",
                    line_at(sf, node))


def check_hook_install(corpus) -> Iterator[Finding]:
    for sf in corpus:
        reported = set()
        for nodes, reason in captured_bodies(sf):
            for node in _walk_bodies(nodes):
                if (isinstance(node, ast.Call) and id(node) not in reported
                        and (name := call_name(node)) is not None
                        and name.rsplit(".", 1)[-1] == "ptc_execution"):
                    reported.add(id(node))
                    yield Finding(
                        "RPT302", sf.rel, node.lineno, node.col_offset,
                        f"ptc_execution(...) hook installed in a body "
                        f"{reason}: a recompute runs the hardware hook a "
                        f"second time in the backward, a capture records "
                        f"one chip call as if it were the device's",
                        line_at(sf, node))


RULES = [
    Rule(
        "RPT301", "no host effects in captured or recomputed bodies",
        check_host_effects,
        "Bodies handed to `hw/jobs.py::_capture`, run inside `with "
        "torch.cuda.graph(...)`, run between `capture_begin()` and "
        "`capture_end()`, or passed to `torch.utils.checkpoint."
        "checkpoint` (and the module's functions they call by name) must "
        "not sync the host (`.item()`, `.cpu()`, `.tolist()`, "
        "`.numpy()`) or take host state (`time.*`, `np.random.*`, "
        "`random.*`, `torch.manual_seed`, `torch.cuda.synchronize`, "
        "`print`).\n\n"
        "Why: a CUDA graph records the card's work once and replays it; "
        "a host sync inside the capture raises (or, under a relaxed "
        "capture mode, reads a value that is stale on every replay), and "
        "a host value is taken once, at capture, and frozen into every "
        "replay.  A checkpointed function runs again in the backward, so "
        "its syncs and draws happen twice.  `build.count_launch` is "
        "allowed by design: a capture counts into its tally "
        "(`build.tally_launches`), which each replay adds.\n\n"
        "Fix: keep the step's state in device tensors updated in place "
        "(as `jobs.py::_alternate_zcd` does), and read values back after "
        "the replay or outside the recomputed region.\n\n"
        "Counterpart of the reference's RPL301 (jit/scan bodies)."),
    Rule(
        "RPT302", "no ptc_execution install in captured or recomputed "
        "bodies", check_hook_install,
        "`ptc_execution(...)` (models/layers.py) must never be installed "
        "inside a captured graph body or a function that "
        "`torch.utils.checkpoint` re-runs.\n\n"
        "Why: the hook routes every PTC linear through the chip.  Under "
        "recompute it runs a second time during the backward: the chip is "
        "called (metered, drifted, and for a stream driver reached over "
        "the wire) for a pass the user never asked for, and the backward "
        "sees the second call's noise, not the forward's.  Under a graph "
        "capture the host-side driver call is not recorded at all.\n\n"
        "Fix: install the hook around the outer decode or training step "
        "(launch/serve.py and runtime/hw_serve.py do), never inside the "
        "checkpointed period or a captured step.\n\n"
        "Counterpart of the reference's RPL302."),
]
