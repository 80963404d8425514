"""RPT5xx — determinism analyzers (the port's RPL5xx).

The port's strongest invariant is the reference's: *bit identity across
transports and reruns*.  The driver conformance tests, the gateway's
token-identity gates and the benchmarks' regression gate all compare
seeded reruns, and every runtime draw in the port comes from a
``torch.Generator`` seeded from configuration.  Two things statically
destroy that:

* **wall-clock seeds**: a generator seeded from ``time.time()`` /
  ``os.urandom`` / ``torch.seed()`` makes every run its own baseline, so
  the bit-identity gates stop gating anything;
* **set iteration feeding wire frames**: set order depends on insertion
  history and hash randomization; a batch frame built by iterating a set
  ships ops in a different order per process, which executes different
  physics (ops are stateful) on one transport.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .astutil import call_name, line_at
from .findings import Finding, Rule

__all__ = ["RULES"]

# callees that consume a seed / construct a generator: torch's
# (`torch.manual_seed`, `torch.cuda.manual_seed(_all)`,
# `torch.Generator(...).manual_seed`), numpy's, and the reference's jax
# spellings (a port module never calls them, but a copied line would)
_SEEDERS = frozenset(["manual_seed", "manual_seed_all", "default_rng",
                      "seed", "RandomState", "Generator", "PRNGKey", "key"])
# entropy sources that must never feed a seed
_ENTROPY = ("time.time", "time.time_ns", "perf_counter", "perf_counter_ns",
            "monotonic", "monotonic_ns", "datetime.now", "datetime.utcnow",
            "os.urandom", "os.getpid", "uuid.uuid4", "torch.seed",
            "torch.initial_seed", "secrets.randbits", "secrets.token_bytes")

# packages whose functions assemble wire frames / op lists
_WIRE_PACKAGES = ("repro_torch.hw", "repro_torch.serving")


def _entropy_inside(node: ast.AST) -> str | None:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = call_name(sub)
            if name is not None and any(
                    name == e or name.endswith("." + e) for e in _ENTROPY):
                return name
    return None


def check_wallclock_seeds(corpus) -> Iterator[Finding]:
    for sf in corpus:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            leaf = func.attr if isinstance(func, ast.Attribute) else \
                func.id if isinstance(func, ast.Name) else None
            if leaf not in _SEEDERS:
                continue
            for arg in (*node.args, *(kw.value for kw in node.keywords)):
                src = _entropy_inside(arg)
                if src is not None:
                    yield Finding(
                        "RPT501", sf.rel, node.lineno, node.col_offset,
                        f"seed derived from {src}(): wall-clock/entropy "
                        f"seeds defeat every bit-identity gate; derive "
                        f"seeds from configuration (a --seed, or a "
                        f"generator seeded from one)",
                        line_at(sf, node))


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name is not None and name.rsplit(".", 1)[-1] in ("set",
                                                            "frozenset"):
            return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd,
                                                            ast.BitOr,
                                                            ast.Sub,
                                                            ast.BitXor)):
        # set algebra, flagged when one side is syntactically a set
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def check_set_iteration(corpus) -> Iterator[Finding]:
    for sf in corpus:
        if not any(sf.in_package(p) for p in _WIRE_PACKAGES):
            continue
        iters = []
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.For):
                iters.append((node.iter, node))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    iters.append((gen.iter, node))
        for it, at in iters:
            if _is_set_expr(it):
                yield Finding(
                    "RPT502", sf.rel, at.lineno, at.col_offset,
                    "iteration over a set in wire-frame-constructing code "
                    "(repro_torch.hw / repro_torch.serving): set order is "
                    "per-process, so the op stream (and the device physics "
                    "it executes) would differ between runs; iterate a "
                    "list/tuple or wrap in sorted()",
                    line_at(sf, at))


RULES = [
    Rule(
        "RPT501", "seeds derive from configuration", check_wallclock_seeds,
        "Seeders and generator constructors (`torch.manual_seed`, "
        "`torch.cuda.manual_seed(_all)`, `torch.Generator(...)."
        "manual_seed`, `np.random.default_rng/seed/RandomState`, and the "
        "reference's jax spellings) must not be fed from wall-clock or "
        "entropy sources (`time.*`, `datetime.now`, `os.urandom`, "
        "`os.getpid`, `uuid4`, `torch.seed()`, `torch.initial_seed()`, "
        "`secrets.*`).\n\n"
        "Why: every correctness gate of the port compares seeded reruns "
        "(transport bit identity, the gateway's token identity, the "
        "benchmarks' regression gate).  One wall-clock seed upstream and "
        "those gates compare noise to noise.\n\n"
        "Fix: accept a seed in the config/CLI and draw from a "
        "`torch.Generator` seeded from it.\n\n"
        "Counterpart of the reference's RPL501."),
    Rule(
        "RPT502", "no set iteration into wire frames", check_set_iteration,
        "Inside repro_torch.hw and repro_torch.serving (the packages that "
        "build wire frames and op lists), iterating a set / frozenset / "
        "set algebra expression is forbidden: wrap it in sorted() or use "
        "an ordered container.\n\n"
        "Why: driver ops are stateful (writes, drift advances, metered "
        "probes), so an op list whose order comes from a set executes "
        "different physics per process, breaking batched = sequential "
        "bit identity on exactly the transport that batched it.\n\n"
        "Fix: `for op in sorted(ops):`; membership tests on sets remain "
        "fine.\n\n"
        "Counterpart of the reference's RPL502."),
]
