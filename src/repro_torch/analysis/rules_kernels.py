"""RPT4xx — the CUDA kernels' C interface (the port's RPL4xx).

Each ``csrc/*.cu`` file is built into its own shared library with a
plain C interface (``kernels/build.py``: ``SOURCES`` maps a library to
its source, ``KERNELS`` a launch counter to its library), and each
wrapper in ``kernels/*.py`` loads it with ``ctypes`` and declares every
entry point's ``argtypes`` and ``restype`` by hand.  Nothing checks those
declarations on a host without a card: a list one ``c_int`` short, or a
``c_int`` where the C takes ``long long``, passes every CPU test (the
wrappers run their plain versions there) and shows only as wrong memory
on the card.  These rules hold the two sides together statically:

* **RPT401**: every ``argtypes`` list has the count and the kinds of the
  ``extern "C"`` signature of that name in the source of the library the
  wrapper loads, every ``restype`` is the C return's, and every call of a
  bound entry point passes as many arguments as its list has;
* **RPT402**: every ``extern "C"`` entry point is bound by a wrapper, and
  every symbol a wrapper binds exists in its library's source;
* **RPT403**: every key of ``build.KERNELS`` is counted by a
  ``build.count_launch(...)`` in ``kernels/``, and every counted name is
  a key;
* **RPT404**: no hidden fallback: a ``try`` around a kernel never falls
  back to a plain version or swallows the error.

The wrappers are read by a small abstract interpreter over the kernels
package: it folds list literals, ``* <int>``, ``+`` and constant slices,
names bound in the function, module constants (also those imported from
a sibling module), a helper's parameters from each call site's
constants, and the libraries that helpers such as ``tc_lib()`` return.
A binding it cannot fold is a finding in its own right, so no wrapper
escapes the check.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator, NamedTuple

from .astutil import SourceFile, call_name, const_str, dotted, line_at
from .findings import Finding, Rule

__all__ = ["RULES", "KernelModel", "extract_kernel_model", "parse_extern_c",
           "CEntry"]

PACKAGE = "repro_torch.kernels"
BUILD = PACKAGE + ".build"
REF = PACKAGE + ".ref"

# the ctypes kinds the wrappers use -> the C type each passes (c_void_p
# passes any pointer, POINTER(c_int) an int*); any other kind leaves its
# list unfolded, which is a finding
C_OF = {"c_int": "int", "c_longlong": "long long", "c_float": "float",
        "c_char_p": "char*"}
CTYPES = frozenset(C_OF) | {"c_void_p"}
_QUALIFIERS = re.compile(r"\b(const|volatile|restrict|__restrict__|"
                         r"__restrict)\b")
_TYPE_WORDS = frozenset(["int", "long", "short", "char", "float", "double",
                         "void", "unsigned", "signed", "size_t", "bool"])
_EXTERN = re.compile(r'extern\s+"C"\s+(?!\{)([\w\s\*]+?)\s*\b(\w+)\s*'
                     r'\(([^)]*)\)\s*\{')
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


# -- the C side ---------------------------------------------------------------

class CEntry(NamedTuple):
    """One ``extern "C"`` entry point: its name, C return kind, parameter
    kinds (``int``, ``long long``, ``float*``, ...), and where it is."""
    name: str
    ret: str
    params: tuple
    path: str
    line: int
    snippet: str


def _c_kind(decl: str, named: bool) -> str:
    """``const float* x`` -> ``float*``; ``long long n`` -> ``long long``."""
    decl = _QUALIFIERS.sub(" ", decl)
    stars = decl.count("*")
    words = re.findall(r"\w+", decl)
    if named and len(words) > 1 and words[-1] not in _TYPE_WORDS:
        words = words[:-1]
    return " ".join(words) + "*" * stars


def parse_extern_c(text: str, path: str) -> list[CEntry]:
    """Every ``extern "C"`` function definition of a CUDA/C++ source."""
    lines = text.splitlines()
    clean = _COMMENT.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), text)
    out = []
    for m in _EXTERN.finditer(clean):
        params = m.group(3).strip()
        kinds = () if params in ("", "void") else tuple(
            _c_kind(p, True) for p in params.split(","))
        line = clean.count("\n", 0, m.start(2)) + 1
        out.append(CEntry(m.group(2), _c_kind(m.group(1), False), kinds,
                          path, line, lines[line - 1].strip()
                          if line <= len(lines) else ""))
    return out


def _matches(ct: str, c: str) -> bool:
    """Whether a ctypes kind passes (or returns) the C kind ``c``."""
    if ct == "c_void_p":
        return c.endswith("*")
    if ct.startswith("POINTER(") and ct.endswith(")"):
        return C_OF.get(ct[8:-1], "?") + "*" == c
    return C_OF.get(ct) == c


# -- the Python side: values of the abstract interpreter ------------------------

class Lib(NamedTuple):
    name: str | None          # a key of build.SOURCES, "*" (every one), None


class Sym(NamedTuple):
    lib: str | None
    name: str | None


class CType(NamedTuple):
    kind: str


class Kinds(NamedTuple):
    items: tuple              # ctypes kinds


class Func(NamedTuple):
    mod: str
    node: ast.AST


class Mod(NamedTuple):
    name: str


class Binding(NamedTuple):
    """One evaluation of an ``X.argtypes = ...`` / ``X.restype = ...``."""
    sf: SourceFile
    node: ast.AST
    sym: Sym | None
    attr: str                 # "argtypes" or "restype"
    value: object             # Kinds, CType, or None when unfolded


class SymCall(NamedTuple):
    sf: SourceFile
    node: ast.Call
    sym: Sym | None


class _Module:
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.consts: dict = {}
        self.dicts: dict = {}
        self.funcs: dict = {}
        self.imports: dict = {}
        for node in sf.tree.body:
            if isinstance(node, ast.FunctionDef):
                self.funcs[node.name] = node
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name, value = node.targets[0].id, node.value
                if isinstance(value, ast.Constant) \
                        and isinstance(value.value, (str, int)):
                    self.consts[name] = value.value
                elif isinstance(value, ast.Dict):
                    self.dicts[name] = value
            elif isinstance(node, ast.ImportFrom):
                base = _import_base(sf, node)
                for alias in node.names:
                    local = alias.asname or alias.name
                    self.imports[local] = (base, alias.name)


def _import_base(sf: SourceFile, node: ast.ImportFrom) -> str:
    """The absolute module an ``ImportFrom`` names."""
    if node.level == 0:
        return node.module or ""
    parts = sf.module.split(".")
    if not sf.rel.endswith("__init__.py"):
        parts = parts[:-1]                  # a module's package
    parts = parts[:len(parts) - (node.level - 1)]
    base = ".".join(parts)
    return f"{base}.{node.module}" if node.module else base


class KernelModel:
    """What the kernels package declares: ``SOURCES`` / ``KERNELS``, every
    binding and bound call, the counted launches, and the C entry points
    of ``csrc/``."""

    def __init__(self):
        self.build: SourceFile | None = None
        self.mods: dict[str, _Module] = {}
        self.sources: dict[str, str] = {}
        self.sources_node = None
        self.kernels: dict[str, ast.AST] = {}
        self.kernels_node = None
        self.bindings: list[Binding] = []
        self.calls: list[SymCall] = []
        self.entries: dict[str, list[CEntry]] = {}   # source file -> entries
        self.csrc_rel = ""
        self.reaching: set = set()          # functions that launch a kernel
        self.lib_helpers: set = set()       # functions returning a library
        self._memo: dict = {}

    # -- name resolution ----------------------------------------------------

    def _module_member(self, mod: str, name: str):
        m = self.mods.get(mod)
        if m is None:
            sub = f"{mod}.{name}"
            return Mod(sub) if sub in self.mods else None
        if name in m.consts:
            return m.consts[name]
        if name in m.funcs:
            return Func(mod, m.funcs[name])
        if name in m.imports:
            return self._module_member(*m.imports[name])
        sub = f"{mod}.{name}"
        return Mod(sub) if sub in self.mods else None

    def _name(self, mod: str, name: str, env: dict):
        if name in env:
            return env[name]
        if name in CTYPES:
            return CType(name)
        return self._module_member(mod, name)

    # -- expressions --------------------------------------------------------

    def eval(self, node, mod: str, env: dict, ctx: dict):
        if isinstance(node, ast.Constant):
            return node.value if isinstance(node.value, (str, int)) else None
        if isinstance(node, ast.Name):
            return self._name(mod, node.id, env)
        if isinstance(node, ast.Tuple):
            return tuple(self.eval(e, mod, env, ctx) for e in node.elts)
        if isinstance(node, ast.List):
            vals = [self.eval(e, mod, env, ctx) for e in node.elts]
            if all(isinstance(v, CType) for v in vals):
                return Kinds(tuple(v.kind for v in vals))
            return None
        if isinstance(node, ast.Attribute):
            if node.attr in CTYPES and dotted(node.value) == "ctypes":
                return CType(node.attr)
            base = self.eval(node.value, mod, env, ctx)
            if isinstance(base, Lib):
                return Sym(base.name, node.attr)
            if isinstance(base, Mod):
                return self._module_member(base.name, node.attr)
            return None
        if isinstance(node, ast.BinOp):
            a = self.eval(node.left, mod, env, ctx)
            b = self.eval(node.right, mod, env, ctx)
            if isinstance(node.op, ast.Add) and isinstance(a, Kinds) \
                    and isinstance(b, Kinds):
                return Kinds(a.items + b.items)
            if isinstance(node.op, ast.Mult):
                if isinstance(a, Kinds) and isinstance(b, int):
                    return Kinds(a.items * b)
                if isinstance(a, int) and isinstance(b, Kinds):
                    return Kinds(b.items * a)
            return None
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value, mod, env, ctx)
            sl = node.slice
            if isinstance(base, Kinds) and isinstance(sl, ast.Slice) \
                    and sl.step is None:
                lo = 0 if sl.lower is None else self.eval(sl.lower, mod,
                                                          env, ctx)
                hi = len(base.items) if sl.upper is None else \
                    self.eval(sl.upper, mod, env, ctx)
                if isinstance(lo, int) and isinstance(hi, int):
                    return Kinds(base.items[lo:hi])
            return None
        if isinstance(node, ast.Call):
            return self._call(node, mod, env, ctx)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self.eval(child, mod, env, ctx)
        return None

    def _call(self, node: ast.Call, mod: str, env: dict, ctx: dict):
        name = call_name(node) or ""
        args = [self.eval(a, mod, env, ctx) for a in node.args]
        for kw in node.keywords:
            self.eval(kw.value, mod, env, ctx)
        if name == "getattr" and len(args) == 2 \
                and isinstance(args[0], Lib):
            return Sym(args[0].name, args[1] if isinstance(args[1], str)
                       else None)
        if name == "ctypes.CDLL" or name == "CDLL":
            return Lib("*")
        if name.rsplit(".", 1)[-1] == "POINTER" and len(args) == 1 \
                and isinstance(args[0], CType):
            return CType(f"POINTER({args[0].kind})")
        fn = self.eval(node.func, mod, env, ctx)
        if isinstance(fn, Sym):
            self.calls.append(SymCall(self.mods[mod].sf, node, fn))
            ctx["reaches"] = True
            return None
        if isinstance(fn, Func):
            if fn.mod == BUILD and fn.node.name == "library":
                arg = args[0] if args else None
                return Lib(arg if isinstance(arg, str) else None)
            ret, reaches = self.run(fn, tuple(
                a if isinstance(a, (str, int, Lib, Sym, Kinds, CType))
                else None for a in args))
            if reaches:
                ctx["reaches"] = True
            return ret
        return None

    # -- statements ---------------------------------------------------------

    def _assign(self, tgt, value, mod, env, ctx, node):
        if isinstance(tgt, ast.Name):
            env[tgt.id] = value
        elif isinstance(tgt, ast.Tuple):
            vals = value if isinstance(value, tuple) \
                and len(value) == len(tgt.elts) else (None,) * len(tgt.elts)
            for t, v in zip(tgt.elts, vals):
                self._assign(t, v, mod, env, ctx, node)
        elif isinstance(tgt, ast.Attribute) \
                and tgt.attr in ("argtypes", "restype"):
            sym = self.eval(tgt.value, mod, env, ctx)
            self.bindings.append(Binding(
                self.mods[mod].sf, node, sym if isinstance(sym, Sym) else None,
                tgt.attr, value if isinstance(value, (Kinds, CType))
                else None))

    def _exec(self, stmts, mod: str, env: dict, ctx: dict) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.Assign):
                value = self.eval(stmt.value, mod, env, ctx)
                for tgt in stmt.targets:
                    self._assign(tgt, value, mod, env, ctx, stmt)
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                if stmt.value is not None:
                    value = self.eval(stmt.value, mod, env, ctx)
                    if isinstance(stmt, ast.AnnAssign):
                        self._assign(stmt.target, value, mod, env, ctx, stmt)
            elif isinstance(stmt, ast.For):
                it = self.eval(stmt.iter, mod, env, ctx)
                for v in (it if isinstance(it, tuple) else (None,)):
                    self._assign(stmt.target, v, mod, env, ctx, stmt)
                    self._exec(stmt.body, mod, env, ctx)
                self._exec(stmt.orelse, mod, env, ctx)
            elif isinstance(stmt, (ast.If, ast.While)):
                self.eval(stmt.test, mod, env, ctx)
                self._exec(stmt.body, mod, env, ctx)
                self._exec(stmt.orelse, mod, env, ctx)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    self.eval(item.context_expr, mod, env, ctx)
                    if item.optional_vars is not None:
                        self._assign(item.optional_vars, None, mod, env,
                                     ctx, stmt)
                self._exec(stmt.body, mod, env, ctx)
            elif isinstance(stmt, ast.Try):
                for part in (stmt.body, *(h.body for h in stmt.handlers),
                             stmt.orelse, stmt.finalbody):
                    self._exec(part, mod, env, ctx)
            elif isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    value = self.eval(stmt.value, mod, env, ctx)
                    if ctx.get("ret") is None:
                        ctx["ret"] = value
            elif isinstance(stmt, (ast.Expr, ast.Raise, ast.Assert)):
                for child in ast.iter_child_nodes(stmt):
                    if isinstance(child, ast.expr):
                        self.eval(child, mod, env, ctx)

    def run(self, fn: Func, args: tuple | None = None):
        """Evaluate ``fn`` with its positional parameters bound to ``args``
        (unknown where None); returns (its return value, whether it
        launches a kernel).  Memoized on the arguments."""
        node = fn.node
        params = [a.arg for a in (*node.args.posonlyargs, *node.args.args)]
        args = tuple(args or ()) + (None,) * max(0, len(params)
                                                 - len(args or ()))
        key = (id(node), args[:len(params)])
        if key in self._memo:
            return self._memo[key]
        self._memo[key] = (None, False)         # recursion guard
        env = dict(zip(params, args))
        ctx: dict = {"ret": None, "reaches": False}
        self._exec(node.body, fn.mod, env, ctx)
        self._memo[key] = (ctx["ret"], ctx["reaches"])
        if ctx["reaches"]:
            self.reaching.add((fn.mod, node.name))
        if isinstance(ctx["ret"], (Lib, Sym)):
            self.lib_helpers.add(node.name)
        return self._memo[key]


def _dict_strs(node: ast.Dict) -> dict:
    return {k: v for k, v in ((const_str(k), v) for k, v in
                              zip(node.keys, node.values)) if k is not None}


def _find_build(corpus) -> SourceFile | None:
    for sf in corpus:
        if sf.module == BUILD:
            return sf
    return None


def extract_kernel_model(corpus) -> KernelModel | None:
    """The kernels package's model, or None where ``kernels/build.py`` is
    not in the corpus (the rules then stay silent)."""
    model = KernelModel()
    build = _find_build(corpus)
    if build is None:
        return None
    model.build = build
    for sf in corpus:
        if sf.in_package(PACKAGE):
            model.mods[sf.module] = _Module(sf)
    bmod = model.mods[BUILD]
    for name, attr in (("SOURCES", "sources"), ("KERNELS", "kernels")):
        node = bmod.dicts.get(name)
        if node is not None:
            d = _dict_strs(node)
            setattr(model, f"{attr}_node", node)
            setattr(model, attr, {k: const_str(v) for k, v in d.items()}
                    if attr == "sources" else d)
    # the C side: csrc/ beside the kernels package
    csrc = os.path.join(os.path.dirname(os.path.dirname(build.path)), "csrc")
    model.csrc_rel = os.path.dirname(os.path.dirname(build.rel)) + "/csrc"
    if os.path.isdir(csrc):
        for fn in sorted(os.listdir(csrc)):
            if fn.endswith(".cu"):
                with open(os.path.join(csrc, fn), encoding="utf-8") as fh:
                    model.entries[fn] = parse_extern_c(
                        fh.read(), f"{model.csrc_rel}/{fn}")
    # every function of the package, once with unknown arguments; calls
    # with constant arguments evaluate their callee again with them bound
    for mname, m in sorted(model.mods.items()):
        for fnode in m.funcs.values():
            model.run(Func(mname, fnode))
    return model


def _folded(items, key):
    """Per AST node, the evaluations that folded (``key`` says which); a
    node none of whose evaluations folded keeps one unfolded entry."""
    by_node: dict = {}
    for it in items:
        by_node.setdefault(id(it.node), []).append(it)
    out = []
    for group in by_node.values():
        good = [it for it in group if key(it)]
        out.extend(dict.fromkeys(good) if good else group[:1])
    return out


def _binding_known(b: Binding) -> bool:
    return b.sym is not None and b.sym.lib is not None \
        and b.sym.name is not None and b.value is not None


def _libs_of(model: KernelModel, lib: str) -> list:
    return sorted(model.sources) if lib == "*" else [lib]


def _entry(model: KernelModel, lib: str, name: str) -> CEntry | None:
    src = model.sources.get(lib)
    for e in model.entries.get(src, ()):
        if e.name == name:
            return e
    return None


def _sym_desc(sym: Sym) -> str:
    return f"{sym.name} (library {'every one' if sym.lib == '*' else sym.lib})"


def check_abi(corpus) -> Iterator[Finding]:
    model = extract_kernel_model(corpus)
    if model is None:
        return
    bindings = _folded(model.bindings, _binding_known)
    # (library, symbol) -> the length of its argtypes, as declared
    argtypes = {(b.sym.lib, b.sym.name): len(b.value.items)
                for b in bindings
                if _binding_known(b) and b.attr == "argtypes"}
    restypes: set = set()
    for b in bindings:
        if not _binding_known(b):
            yield Finding(
                "RPT401", b.sf.rel, b.node.lineno, b.node.col_offset,
                f"cannot fold this {b.attr} binding (which library, which "
                f"symbol, or the list itself): write it as a list of ctypes "
                f"kinds built from literals, `* <int>`, `+` and constants",
                line_at(b.sf, b.node))
            continue
        for lib in _libs_of(model, b.sym.lib):
            e = _entry(model, lib, b.sym.name)
            if e is None:
                continue                        # RPT402 reports it
            if b.attr == "restype":
                restypes.add((b.sym.lib, b.sym.name))
                if not _matches(b.value.kind, e.ret):
                    yield Finding(
                        "RPT401", b.sf.rel, b.node.lineno, b.node.col_offset,
                        f"restype of {_sym_desc(b.sym)} is {b.value.kind} "
                        f"but {e.path}:{e.line} returns {e.ret}",
                        line_at(b.sf, b.node))
                continue
            if len(b.value.items) != len(e.params):
                yield Finding(
                    "RPT401", b.sf.rel, b.node.lineno, b.node.col_offset,
                    f"argtypes of {_sym_desc(b.sym)} has "
                    f"{len(b.value.items)} entries but {e.path}:{e.line} "
                    f"takes {len(e.params)} parameters "
                    f"({', '.join(e.params)})",
                    line_at(b.sf, b.node))
                continue
            for i, (ct, c) in enumerate(zip(b.value.items, e.params)):
                if not _matches(ct, c):
                    yield Finding(
                        "RPT401", b.sf.rel, b.node.lineno, b.node.col_offset,
                        f"argtypes of {_sym_desc(b.sym)}: entry {i} is {ct} "
                        f"but parameter {i} of {e.path}:{e.line} is {c}",
                        line_at(b.sf, b.node))
    for b in bindings:
        if _binding_known(b) and b.attr == "argtypes" \
                and (b.sym.lib, b.sym.name) not in restypes \
                and any(_entry(model, lib, b.sym.name) is not None
                        for lib in _libs_of(model, b.sym.lib)):
            yield Finding(
                "RPT401", b.sf.rel, b.node.lineno, b.node.col_offset,
                f"{_sym_desc(b.sym)} gets argtypes but no restype: declare "
                f"the C return explicitly",
                line_at(b.sf, b.node))
    for c in _folded(model.calls, lambda c: c.sym is not None
                     and c.sym.name is not None):
        if c.sym is None or c.sym.name is None:
            continue
        n = argtypes.get((c.sym.lib, c.sym.name),
                         argtypes.get(("*", c.sym.name)))
        if n is None and c.sym.lib is None:
            n = next((v for (lib, s), v in argtypes.items()
                      if s == c.sym.name), None)
        if n is None:
            yield Finding(
                "RPT401", c.sf.rel, c.node.lineno, c.node.col_offset,
                f"{c.sym.name} is called without argtypes: ctypes would "
                f"pass every argument as a C int",
                line_at(c.sf, c.node))
        elif any(isinstance(a, ast.Starred) for a in c.node.args) \
                or c.node.keywords:
            yield Finding(
                "RPT401", c.sf.rel, c.node.lineno, c.node.col_offset,
                f"{c.sym.name} is called with starred or keyword arguments: "
                f"pass its {n} arguments positionally",
                line_at(c.sf, c.node))
        elif len(c.node.args) != n:
            yield Finding(
                "RPT401", c.sf.rel, c.node.lineno, c.node.col_offset,
                f"{c.sym.name} is called with {len(c.node.args)} arguments "
                f"but its argtypes has {n}",
                line_at(c.sf, c.node))


def check_coverage(corpus) -> Iterator[Finding]:
    model = extract_kernel_model(corpus)
    if model is None:
        return
    bsf, snode = model.build, model.sources_node
    bound = set()
    for b in _folded(model.bindings, _binding_known):
        if not _binding_known(b) or b.attr != "argtypes":
            continue
        for lib in _libs_of(model, b.sym.lib):
            bound.add((lib, b.sym.name))
            if lib not in model.sources:
                yield Finding(
                    "RPT402", b.sf.rel, b.node.lineno, b.node.col_offset,
                    f"binds {b.sym.name} in library {lib!r}, which is not a "
                    f"key of build.SOURCES",
                    line_at(b.sf, b.node))
            elif _entry(model, lib, b.sym.name) is None:
                yield Finding(
                    "RPT402", b.sf.rel, b.node.lineno, b.node.col_offset,
                    f"binds {b.sym.name}, which {model.csrc_rel}/"
                    f"{model.sources[lib]} does not define as an "
                    f"extern \"C\" entry point",
                    line_at(b.sf, b.node))
    for lib, src in sorted(model.sources.items()):
        if src not in model.entries and snode is not None:
            yield Finding(
                "RPT402", bsf.rel, snode.lineno, snode.col_offset,
                f"build.SOURCES maps {lib!r} to {src}, which is not in "
                f"{model.csrc_rel}",
                line_at(bsf, snode))
    libs_of_src: dict = {}
    for lib, src in model.sources.items():
        libs_of_src.setdefault(src, []).append(lib)
    for src, entries in sorted(model.entries.items()):
        for e in entries:
            libs = libs_of_src.get(src, [])
            if not any((lib, e.name) in bound for lib in libs):
                why = "no wrapper binds it" if libs else \
                    f"{src} is not in build.SOURCES, so it is never built"
                yield Finding(
                    "RPT402", e.path, e.line, 0,
                    f"extern \"C\" entry point {e.name}: {why} (set its "
                    f"argtypes and restype in the wrapper that loads the "
                    f"library)", e.snippet)


def _fold_names(node, mod: _Module, model: KernelModel):
    """The names a ``count_launch`` argument can take, or None."""
    if (s := const_str(node)) is not None:
        return {s}
    if isinstance(node, ast.Name):
        v = model._module_member(mod.sf.module, node.id)
        return {v} if isinstance(v, str) else None
    if isinstance(node, ast.IfExp):
        a = _fold_names(node.body, mod, model)
        b = _fold_names(node.orelse, mod, model)
        return None if a is None or b is None else a | b
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
            and node.value.id in mod.dicts:
        out = set()
        for v in mod.dicts[node.value.id].values:
            names = _fold_names(v, mod, model)
            if names is None:
                return None
            out |= names
        return out
    return None


def check_counters(corpus) -> Iterator[Finding]:
    model = extract_kernel_model(corpus)
    if model is None or model.kernels_node is None:
        return
    counted: set = set()
    for mname, m in sorted(model.mods.items()):
        for node in ast.walk(m.sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            if name.rsplit(".", 1)[-1] != "count_launch" or not node.args:
                continue
            names = _fold_names(node.args[0], m, model)
            if names is None:
                yield Finding(
                    "RPT403", m.sf.rel, node.lineno, node.col_offset,
                    "cannot fold this count_launch name: use a string, a "
                    "module constant, both arms of a conditional, or a "
                    "module-level dict of them",
                    line_at(m.sf, node))
                continue
            counted |= names
            for n in sorted(names - set(model.kernels)):
                yield Finding(
                    "RPT403", m.sf.rel, node.lineno, node.col_offset,
                    f"count_launch({n!r}): not a key of build.KERNELS, so "
                    f"the launch lands in no counter (KeyError at the first "
                    f"launch on the card)",
                    line_at(m.sf, node))
    for name, value in model.kernels.items():
        if name not in counted:
            yield Finding(
                "RPT403", model.build.rel, value.lineno, value.col_offset,
                f"build.KERNELS has {name!r} but no wrapper in kernels/ "
                f"counts it: a main path through it would read 0 launches",
                line_at(model.build, value))


def check_fallbacks(corpus) -> Iterator[Finding]:
    model = extract_kernel_model(corpus)
    if model is None:
        return
    entry = {name for _, name in model.reaching if not name.startswith("_")}
    ref = model.mods.get(REF)
    plain = set(ref.funcs) if ref is not None else set()
    reach = entry | model.lib_helpers | {"library", "check_status"}
    for sf in corpus:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Try) or not node.handlers:
                continue
            hit = None
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        name = call_name(sub)
                        leaf = name.rsplit(".", 1)[-1] if name else None
                        if leaf in reach:
                            hit = leaf
            if hit is None:
                continue
            for h in node.handlers:
                falls = None
                for sub in ast.walk(h):
                    if isinstance(sub, ast.Call):
                        name = call_name(sub) or ""
                        leaf = name.rsplit(".", 1)[-1]
                        if leaf in plain or name.startswith("ref.") \
                                or leaf.endswith(("_ref", "_plain")):
                            falls = f"falls back to {name}()"
                if falls is None and not any(isinstance(s, ast.Raise)
                                             for s in ast.walk(h)):
                    falls = "swallows the error"
                if falls is not None:
                    yield Finding(
                        "RPT404", sf.rel, h.lineno, h.col_offset,
                        f"a handler of a try around {hit}() {falls}: a "
                        f"kernel that fails must fail the call, never hand "
                        f"back the plain version's result as the kernel's",
                        line_at(sf, h))


RULES = [
    Rule(
        "RPT401", "ctypes declarations match the C signatures", check_abi,
        "Every `argtypes` list in `kernels/*.py` must have the count and "
        "the kinds of the `extern \"C\"` signature of that name in the "
        "source of the library the wrapper loads (`build.library(LIB)` -> "
        "`build.SOURCES[LIB]` in `csrc/`): `c_void_p` for any pointer, "
        "`c_int` for `int`, `c_longlong` for `long long`, `c_float` for "
        "`float`, `POINTER(c_int)` for `int*`.  Every bound symbol must "
        "declare its `restype` (`c_int` where the C returns `int`), and "
        "every call of a bound entry point must pass exactly as many "
        "positional arguments as its list has.  A binding the checker "
        "cannot fold (which library, which symbol, or the list) is a "
        "finding itself.\n\n"
        "Why: ctypes trusts the declaration.  One `c_int` short shifts "
        "every later argument into the wrong register; a `c_int` where "
        "the C takes `long long` passes garbage in the high word.  Both "
        "pass every CPU test (the wrappers run their plain versions on a "
        "CPU tensor) and show only as wrong memory on the card.\n\n"
        "Fix: make the list match the signature, literally or from "
        "constants the checker folds (`[ctypes.c_void_p] * 6 + "
        "[ctypes.c_int] * 5`, a local `head` list, a helper's constant "
        "arguments).\n\n"
        "Counterpart of the reference's RPL401 (kernel arity vs the "
        "Pallas call's specs)."),
    Rule(
        "RPT402", "every C entry point bound, every binding defined",
        check_coverage,
        "Every `extern \"C\"` entry point in `csrc/*.cu` must be bound "
        "(its `argtypes` set) by a wrapper in `kernels/`, every symbol a "
        "wrapper binds must exist in its library's source, and every "
        "`build.SOURCES` entry must name a file in `csrc/`.\n\n"
        "Why: an entry point no wrapper binds is either dead C or called "
        "somewhere without a declaration (ctypes then passes every "
        "argument as an int); a bound symbol missing from its source is "
        "an AttributeError on the card only.\n\n"
        "Fix: bind the entry point where its library is loaded, or remove "
        "it from the source.\n\n"
        "Counterpart of the reference's RPL402 (index maps vs the "
        "grid)."),
    Rule(
        "RPT403", "launch counters match build.KERNELS", check_counters,
        "Every key of `build.KERNELS` must be counted by some "
        "`build.count_launch(...)` in `kernels/`, and every name counted "
        "there must be a key.  Names fold from string constants, module "
        "constants, both arms of a conditional, and the values of a "
        "module-level dict (`ROUTES[which]`).\n\n"
        "Why: the counters are how a run shows its main path went "
        "through the kernels.  A counted name that is not a key raises "
        "KeyError at the first launch on the card; a key nothing counts "
        "reads 0 launches however often its kernel runs.\n\n"
        "Fix: count the launch under the kernel's `KERNELS` key, once, "
        "where the wrapper launches it.\n\n"
        "Counterpart of the reference's RPL403 (aliases vs operands)."),
    Rule(
        "RPT404", "no hidden fallback around a kernel", check_fallbacks,
        "A `try` whose body calls a kernel (a bound entry point, a "
        "wrapper that launches one, a helper returning a loaded library, "
        "`build.library` or `build.check_status`) must not have a "
        "handler that calls a plain version (a function of "
        "`kernels/ref.py`, `ref.*`, `*_ref`, `*_plain`) or that swallows "
        "the error (no `raise` in the handler).\n\n"
        "Why: a wrapper runs its plain version only because its tensor "
        "lies on the CPU; on a CUDA tensor it launches its kernel or "
        "raises.  A fallback hides a kernel that does not build, launch "
        "or agree behind the plain version's right answer, and the launch "
        "counters would still read as if the kernel ran.\n\n"
        "Fix: let the error propagate; pick a route only from the "
        "arguments (each wrapper's `route()`), never from a failure."),
]
