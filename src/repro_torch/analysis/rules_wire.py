"""RPT2xx — wire-protocol consistency of the port's trio (the port's RPL2xx).

The port speaks the reference's driver wire protocol (v3 JSON lines, v4
binary frames; ``docs/wire-protocol.md``), defined in three files that
must agree:

* ``repro_torch/hw/driver.py``: ``BATCHABLE_OPS``, the op whitelist
  every transport enforces, and ``WIRE_INTERNAL_OPS``;
* ``repro_torch/hw/server.py:_dispatch``: the server's ``op == "..."``
  branches and the payload keys each reads (``kw["x"]`` / ``kw.get("x")``
  in the branch, or in a module helper the branch hands ``kw`` to, one
  call deep: ``_rng(kw)``, ``_draws(driver, kw, ...)``);
* ``repro_torch/hw/stream_driver.py``: the client emitters
  (``self._exec(op, ...)`` / ``self._queue(op, ...)``) and the payload
  keys they encode, as ``self._wire_kw(op, dict(...))`` leaves them:
  the model runs ``_wire_kw``'s body for each op, so a key it pops (a
  job's ``gen``) is not sent and a key it writes (``draws``) is.

A new op wired into one side but not the others ships half-wired: it
round-trips to an "unknown op" error, drops payload keys the server
never reads, or dies inside a batch frame on exactly one transport.
The reference's RPL2xx rules look only for ``repro.hw.*`` and read the
client's keys before ``_wire_kw`` rewrites them, so they miss the port's
trio and would misread it.

The trio is located *within the linted corpus* by module name, so the
rules run unchanged against the real tree, a fixture tree or a broken
copy, and stay silent when the corpus lacks one of the three.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .astutil import SourceFile, call_name, const_str, line_at
from .findings import Finding, Rule

__all__ = ["RULES", "WireModel", "extract_wire_model"]

DRIVER = "repro_torch.hw.driver"
SERVER = "repro_torch.hw.server"
CLIENT = "repro_torch.hw.stream_driver"

# ops that are session control, not data plane: dispatched outside the
# whitelist on purpose
CONTROL_OPS = frozenset(["init", "shutdown", "batch", "meta"])


class WireModel:
    """Everything the three protocol files statically declare."""

    def __init__(self):
        self.batchable: set[str] = set()
        self.batchable_node = None          # (sf, node) anchor
        self.pipelined: set[str] = set()
        self.wire_internal: set[str] = set()
        self.server_ops: dict[str, tuple] = {}       # op -> (sf, node)
        self.server_reads: dict[str, dict] = {}      # op -> {key: "hard"|"soft"}
        self.client_ops: dict[str, tuple] = {}       # op -> (sf, node)
        self.client_keys: dict[str, dict] = {}       # op -> {key: (sf, node)}
        self.found = set()                  # which of the three files exist


def _collect_str_elts(node: ast.AST) -> list[str]:
    """String constants inside frozenset([...]) / {...} / [...] / (...)."""
    if isinstance(node, ast.Call) and node.args:
        return _collect_str_elts(node.args[0])
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        return [s for e in node.elts if (s := const_str(e)) is not None]
    return []


def _module_set(sf: SourceFile, name: str):
    """(set of strings, node) of a module-level ``name = frozenset(...)``."""
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    return set(_collect_str_elts(node.value)), node
    return None, None


def _scan_driver(model: WireModel, sf: SourceFile) -> None:
    model.found.add("driver")
    ops, node = _module_set(sf, "BATCHABLE_OPS")
    if ops is not None:
        model.batchable, model.batchable_node = ops, (sf, node)
    internal, _ = _module_set(sf, "WIRE_INTERNAL_OPS")
    model.wire_internal = internal or set()


# -- server: the reads of each branch ----------------------------------------

def _is_kw_get(node: ast.Call, var: str) -> str | None:
    f = node.func
    if (isinstance(f, ast.Attribute) and f.attr == "get"
            and isinstance(f.value, ast.Name) and f.value.id == var
            and node.args):
        return const_str(node.args[0])
    return None


def _direct_reads(nodes, var: str, reads: dict, kind: str) -> None:
    """``var["k"]`` reads (as ``kind``, but soft under a conditional
    expression) and ``var.get("k")`` reads (soft) anywhere under
    ``nodes``."""
    for stmt in nodes:
        guarded = {id(n) for g in ast.walk(stmt)
                   if isinstance(g, (ast.IfExp, ast.BoolOp))
                   for n in ast.walk(g)}
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == var
                    and (k := const_str(node.slice)) is not None):
                this = "soft" if id(node) in guarded else kind
                if this == "hard" or reads.get(k) != "hard":
                    reads[k] = this
            elif isinstance(node, ast.Call) \
                    and (k := _is_kw_get(node, var)) is not None:
                reads.setdefault(k, "soft")


def _returns(stmt: ast.AST) -> bool:
    return any(isinstance(n, ast.Return) for n in ast.walk(stmt))


def _helper_reads(fn: ast.FunctionDef, param: str, reads: dict) -> None:
    """The reads of ``param`` in a helper: hard only in the statements
    every call runs (top level, before any statement that may return
    early); soft wherever a branch guards them."""
    unconditional = True
    for stmt in fn.body:
        compound = isinstance(stmt, (ast.If, ast.For, ast.While, ast.Try,
                                     ast.With))
        _direct_reads([stmt], param, reads,
                      "hard" if unconditional and not compound else "soft")
        if compound and _returns(stmt):
            unconditional = False


def _branch_reads(body, helpers: dict, var: str) -> dict:
    """The reads of one dispatch branch: its own ``kw[...]`` /
    ``kw.get(...)``, and those of each module helper it hands ``kw`` to."""
    reads: dict = {}
    _direct_reads(body, var, reads, "hard")
    for stmt in body:
        for node in ast.walk(stmt):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in helpers):
                continue
            fn = helpers[node.func.id]
            params = [a.arg for a in (*fn.args.posonlyargs, *fn.args.args)]
            for i, arg in enumerate(node.args):
                if isinstance(arg, ast.Name) and arg.id == var \
                        and i < len(params):
                    _helper_reads(fn, params[i], reads)
            for kw in node.keywords:
                if isinstance(kw.value, ast.Name) and kw.value.id == var \
                        and kw.arg is not None:
                    _helper_reads(fn, kw.arg, reads)
    return reads


def _scan_server(model: WireModel, sf: SourceFile) -> None:
    model.found.add("server")
    helpers = {n.name: n for n in sf.tree.body
               if isinstance(n, ast.FunctionDef)}
    dispatch = helpers.get("_dispatch")
    build = helpers.get("_build_driver")
    if dispatch is not None:
        args = [a.arg for a in dispatch.args.args]
        var = args[2] if len(args) > 2 else "kw"
        for node in ast.walk(dispatch):
            if not isinstance(node, ast.If):
                continue
            t = node.test
            if (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
                    and t.left.id == "op" and len(t.ops) == 1
                    and isinstance(t.ops[0], ast.Eq)
                    and (op := const_str(t.comparators[0])) is not None):
                model.server_ops[op] = (sf, node)
                # batch bodies read entry dicts, not kw
                model.server_reads[op] = {} if op == "batch" else \
                    _branch_reads(node.body, helpers, var)
    # `init` is handled in serve() by handing kw to _build_driver
    if build is not None:
        reads: dict = {}
        _helper_reads(build, build.args.args[0].arg, reads)
        model.server_ops.setdefault("init", (sf, build))
        model.server_reads["init"] = reads


# -- client: the keys each emitter sends ----------------------------------------

def _payload_keys(node: ast.AST, env: dict | None = None) -> dict | None:
    """Keys of a ``dict(...)`` call or ``{...}`` literal payload; ``env``
    maps local names to payloads already resolved (the handshake's
    ``base = dict(...)`` then ``_exec("init", dict(base, v=want))``)."""
    if isinstance(node, ast.Call) and call_name(node) == "dict":
        if any(kw.arg is None for kw in node.keywords):
            return None                       # **expansion: unknown
        out: dict = {}
        for arg in node.args:                 # dict(base, ...) merge form
            inner = _payload_keys(arg, env)
            if inner is None and isinstance(arg, ast.Name):
                inner = (env or {}).get(arg.id)
            if inner is None:
                return None                   # opaque positional: unknown
            out.update(inner)
        for kw in node.keywords:
            out[kw.arg] = kw.value
        return out
    if isinstance(node, ast.Dict):
        out = {}
        for k, v in zip(node.keys, node.values):
            ks = const_str(k) if k is not None else None
            if ks is None:
                return None
            out[ks] = v
        return out
    return None


def _local_payloads(sf: SourceFile) -> dict:
    """name → payload keys for every simple ``name = dict(...)`` /
    ``name = {...}`` assignment in the file (first binding wins)."""
    env: dict = {}
    for node in ast.walk(sf.tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            keys = _payload_keys(node.value, env)
            if keys is not None:
                env.setdefault(node.targets[0].id, keys)
    return env


class _Encoder:
    """``_wire_kw(op, kw)``'s body, run abstractly for one op: the keys
    that reach the wire.  Conditions on ``op`` and on ``"k" in kw`` are
    decided; any other condition runs both ways and keeps every key
    either way may send."""

    def __init__(self, fn: ast.FunctionDef):
        params = [a.arg for a in fn.args.args if a.arg != "self"]
        self.fn = fn
        self.opvar, self.kwvar = (params + ["op", "kw"])[:2]

    def keys(self, op: str, keys: set) -> set:
        out = self._run(self.fn.body, op, set(keys))
        return keys if out is None else out

    def _test(self, t, op, keys):
        if isinstance(t, ast.BoolOp):
            vals = [self._test(v, op, keys) for v in t.values]
            if isinstance(t.op, ast.And):
                return False if False in vals else \
                    (True if all(v is True for v in vals) else None)
            return True if True in vals else \
                (False if all(v is False for v in vals) else None)
        if isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
            v = self._test(t.operand, op, keys)
            return None if v is None else not v
        if isinstance(t, ast.Compare) and len(t.ops) == 1:
            left, cmp, right = t.left, t.ops[0], t.comparators[0]
            if isinstance(left, ast.Name) and left.id == self.opvar:
                if isinstance(cmp, (ast.Eq, ast.NotEq)) \
                        and (c := const_str(right)) is not None:
                    return (op == c) == isinstance(cmp, ast.Eq)
                if isinstance(cmp, (ast.In, ast.NotIn)) \
                        and isinstance(right, (ast.Tuple, ast.List, ast.Set)):
                    members = {const_str(e) for e in right.elts}
                    return (op in members) == isinstance(cmp, ast.In)
            if (k := const_str(left)) is not None \
                    and isinstance(right, ast.Name) \
                    and right.id == self.kwvar \
                    and isinstance(cmp, (ast.In, ast.NotIn)):
                return (k in keys) == isinstance(cmp, ast.In)
        return None

    def _effects(self, stmt, keys: set) -> None:
        """One simple statement's pops (evaluated first) and writes."""
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == self.kwvar and node.args
                    and (k := const_str(node.args[0])) is not None):
                if node.func.attr == "pop":
                    keys.discard(k)
                elif node.func.attr == "setdefault":
                    keys.add(k)
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == self.kwvar
                        and (k := const_str(t.slice)) is not None):
                    keys.discard(k)
        for tgt in targets:
            for t in ast.walk(tgt):
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == self.kwvar
                        and (k := const_str(t.slice)) is not None):
                    keys.add(k)

    def _run(self, stmts, op, keys):
        """The keys after ``stmts``, or None where every path raised or
        returned before the end (a return hands back the keys it has)."""
        for stmt in stmts:
            if isinstance(stmt, ast.Raise):
                return None
            if isinstance(stmt, ast.Return):
                return keys
            if isinstance(stmt, ast.If):
                v = self._test(stmt.test, op, keys)
                if v is True:
                    keys = self._run(stmt.body, op, keys)
                elif v is False:
                    keys = self._run(stmt.orelse, op, keys)
                else:
                    a = self._run(stmt.body, op, set(keys))
                    b = self._run(stmt.orelse, op, set(keys))
                    keys = None if a is None and b is None else \
                        (a or set()) | (b or set())
                if keys is None:
                    return None
            elif isinstance(stmt, (ast.For, ast.While, ast.With, ast.Try)):
                inner = list(getattr(stmt, "body", []))
                ran = self._run(inner, op, set(keys))
                keys = keys | (ran or set())
            else:
                self._effects(stmt, keys)
        return keys


def _scan_client(model: WireModel, sf: SourceFile) -> None:
    model.found.add("client")
    env = _local_payloads(sf)
    encoder = None
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_wire_kw":
            encoder = _Encoder(node)

    def sent(op, keys, node):
        model.client_ops.setdefault(op, (sf, node))
        dst = model.client_keys.setdefault(op, {})
        for k in keys:
            dst.setdefault(k, (sf, node))

    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = call_name(node)
        if fn is None:
            continue
        leaf = fn.rsplit(".", 1)[-1]
        if not node.args or (op := const_str(node.args[0])) is None:
            continue
        if leaf in ("_exec", "_queue"):
            keys = _payload_keys(node.args[1], env) \
                if len(node.args) > 1 else None
            sent(op, set(keys or ()), node)
        elif leaf == "_wire_kw" and len(node.args) >= 2:
            keys = _payload_keys(node.args[1], env)
            keys = set(keys or ())
            if encoder is not None:
                keys = encoder.keys(op, keys)
            sent(op, keys, node)
    # PIPELINED_OPS must stay a subset of BATCHABLE_OPS (they flush
    # inside batch frames)
    pipelined, _ = _module_set(sf, "PIPELINED_OPS")
    model.pipelined = pipelined or set()


def extract_wire_model(corpus) -> WireModel:
    model = WireModel()
    for sf in corpus:
        if sf.module == DRIVER:
            _scan_driver(model, sf)
        elif sf.module == SERVER:
            _scan_server(model, sf)
        elif sf.module == CLIENT:
            _scan_client(model, sf)
    return model


def _complete(model: WireModel) -> bool:
    """Cross-file checks only fire when the whole trio was linted:
    linting a subtree must not report the protocol as half-wired
    because two of its files are out of scope."""
    return model.found >= {"driver", "server", "client"} \
        and model.batchable_node is not None


def check_server_coverage(corpus) -> Iterator[Finding]:
    model = extract_wire_model(corpus)
    if not _complete(model):
        return
    sf, node = model.batchable_node
    for op in sorted(model.batchable - set(model.server_ops)):
        yield Finding(
            "RPT201", sf.rel, node.lineno, node.col_offset,
            f"op {op!r} is in BATCHABLE_OPS but hw/server.py:_dispatch "
            f"has no `op == {op!r}` branch: a wire peer batching it gets "
            f"'unknown op' after the whitelist admitted it",
            line_at(sf, node))


def check_client_coverage(corpus) -> Iterator[Finding]:
    model = extract_wire_model(corpus)
    if not _complete(model):
        return
    sf, node = model.batchable_node
    for op in sorted(model.batchable - set(model.client_ops)):
        yield Finding(
            "RPT202", sf.rel, node.lineno, node.col_offset,
            f"op {op!r} is in BATCHABLE_OPS but the StreamDriver client "
            f"never emits it (no _exec/_queue/_wire_kw site): the op is "
            f"unreachable over the wire and its server branch is dead",
            line_at(sf, node))


def _outside(model: WireModel, op: str) -> bool:
    return (op not in model.batchable and op not in CONTROL_OPS
            and op not in model.wire_internal
            and not op.startswith("unsafe/"))


def check_whitelist_membership(corpus) -> Iterator[Finding]:
    model = extract_wire_model(corpus)
    if not _complete(model):
        return
    for side, ops in (("server dispatches", model.server_ops),
                      ("client emits", model.client_ops)):
        for op, (sf, node) in sorted(ops.items()):
            if _outside(model, op):
                yield Finding(
                    "RPT203", sf.rel, node.lineno, node.col_offset,
                    f"{side} op {op!r}, which is neither in BATCHABLE_OPS, "
                    f"WIRE_INTERNAL_OPS, nor a control/unsafe op: the wire "
                    f"and in-process run_batch would disagree on it",
                    line_at(sf, node))
    # a wire-internal op is a client-rewrite + server-branch PAIR
    bsf, bnode = model.batchable_node
    for op in sorted(model.wire_internal):
        missing = [side for side, where in
                   (("server branch", model.server_ops),
                    ("client emitter", model.client_ops))
                   if op not in where]
        if missing:
            yield Finding(
                "RPT203", bsf.rel, bnode.lineno, bnode.col_offset,
                f"WIRE_INTERNAL_OPS contains {op!r} but it has no "
                f"{' or '.join(missing)}: the wire-internal rewrite must be "
                f"wired on both ends in the same commit",
                line_at(bsf, bnode))
    for op in sorted(model.pipelined - model.batchable):
        yield Finding(
            "RPT203", bsf.rel, bnode.lineno, bnode.col_offset,
            f"PIPELINED_OPS contains {op!r} which is not in BATCHABLE_OPS: "
            f"queued writes flush inside batch frames, so every pipelined "
            f"op must be batchable",
            line_at(bsf, bnode))


def check_payload_keywords(corpus) -> Iterator[Finding]:
    model = extract_wire_model(corpus)
    if not _complete(model):
        return
    for op in sorted(set(model.server_reads) & set(model.client_ops)):
        if op in ("batch", "meta"):
            continue
        reads = model.server_reads.get(op, {})
        sent = model.client_keys.get(op, {})
        hard = {k for k, kind in reads.items() if kind == "hard"}
        for k in sorted(hard - set(sent)):
            sf, node = model.server_ops[op]
            yield Finding(
                "RPT204", sf.rel, node.lineno, node.col_offset,
                f"server op {op!r} reads kw[{k!r}] unconditionally but the "
                f"client never sends {k!r}: every wire call of this op "
                f"raises KeyError server-side",
                line_at(sf, node))
        for k in sorted(set(sent) - set(reads)):
            sf, node = sent[k]
            yield Finding(
                "RPT204", sf.rel, node.lineno, node.col_offset,
                f"client sends payload key {k!r} for op {op!r} but the "
                f"server branch never reads it: the value is silently "
                f"dropped on the wire",
                line_at(sf, node))


RULES = [
    Rule(
        "RPT201", "batchable op has a server branch", check_server_coverage,
        "Every op in BATCHABLE_OPS (repro_torch/hw/driver.py) must have a "
        "matching `op == \"...\"` branch in hw/server.py:_dispatch.\n\n"
        "Why: the whitelist admitting an op the server cannot dispatch "
        "means a client-validated batch frame dies mid-list server-side, "
        "after earlier ops already applied.\n\n"
        "Fix: add the dispatch branch (and its payload decode) in the "
        "same commit that extends BATCHABLE_OPS.\n\n"
        "Counterpart of the reference's RPL201."),
    Rule(
        "RPT202", "batchable op has a client emitter", check_client_coverage,
        "Every op in BATCHABLE_OPS must be emitted somewhere by the "
        "StreamDriver client (`self._exec(op, ...)`, `self._queue(op, "
        "...)`, or a `self._wire_kw(op, dict(...))` encode site).\n\n"
        "Why: an op only the server knows is dead protocol surface.\n\n"
        "Fix: implement the client method, or remove the op from "
        "BATCHABLE_OPS and the server.\n\n"
        "Counterpart of the reference's RPL202."),
    Rule(
        "RPT203", "wire op whitelist symmetry", check_whitelist_membership,
        "Ops dispatched by the server or emitted by the client must be in "
        "BATCHABLE_OPS, a control op (init/shutdown/batch/meta), a "
        "declared WIRE_INTERNAL_OPS rewrite (the client-coalesced "
        "`forward_many`, which must then be wired on BOTH ends), or an "
        "`unsafe/*` twin-debug op; and PIPELINED_OPS must be a subset of "
        "BATCHABLE_OPS.\n\n"
        "Why: an op accepted over the wire but rejected by in-process "
        "run_batch (or the reverse) makes batched = sequential bit "
        "identity transport-dependent.  Pipelined writes flush inside "
        "batch frames, so a pipelined op outside the whitelist would "
        "poison every later frame.\n\n"
        "Fix: add the op to BATCHABLE_OPS, or mark it control/unsafe by "
        "design.\n\n"
        "Counterpart of the reference's RPL203."),
    Rule(
        "RPT204", "payload keyword agreement", check_payload_keywords,
        "For every op the client emits and the server dispatches, the "
        "payload keywords must agree: a key the server reads as "
        "`kw[\"k\"]` unconditionally must be sent by the client, and "
        "every key the client sends must be read by the server branch.\n\n"
        "The client's keys are those `_wire_kw(op, kw)` leaves: its body "
        "is run for the op, so keys it pops (a job's `gen`, the Python "
        "`draws`) and keys it writes (the encoded `draws`, `restarts`) "
        "count as the wire sees them.  The server's reads include those "
        "of a module helper the branch hands `kw` to, one call deep "
        "(`_rng(kw)` reads `block_range`; `_draws(driver, kw, ...)` reads "
        "`draws`, else `key`); a helper's read is unconditional only in "
        "the statements every call runs.\n\n"
        "Why: a missing hard key is a server-side KeyError on every "
        "call; an unread client key is silent payload loss (a "
        "`block_range` the server ignores would make a scoped write land "
        "on the whole chip, corrupting co-resident tenants).\n\n"
        "Fix: wire the keyword through both sides.\n\n"
        "Counterpart of the reference's RPL204."),
]
