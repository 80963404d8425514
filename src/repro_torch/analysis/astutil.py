"""Shared AST helpers for the port's analyzers (stdlib only)."""

from __future__ import annotations

import ast

__all__ = ["SourceFile", "dotted", "const_str", "line_at", "call_name",
           "ANCHORS"]

# directory names a module path is anchored on, in order of precedence
ANCHORS = ("repro_torch", "tests", "benchmarks", "examples")


class SourceFile:
    """One parsed python file plus its classification inside the repo.

    ``module`` is the best-effort dotted module path: files under a
    ``repro_torch`` package directory become ``repro_torch.x.y``; files
    under a top-level ``tests`` / ``benchmarks`` / ``examples`` directory
    keep that prefix (``tests.test_x``); ``chip_smoke.py`` outside all of
    them is ``chip_smoke``.  Classification is purely path-based, so the
    analyzers work alike on the real tree and on fixture trees in tests.
    """

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace("\\", "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.module = self._module_name()

    def _module_name(self) -> str:
        parts = self.rel.split("/")
        stem = [p[:-3] if p.endswith(".py") else p for p in parts]
        for anchor in ANCHORS:
            if anchor in stem:
                mod = stem[stem.index(anchor):]
                if mod[-1] == "__init__":
                    mod = mod[:-1]
                return ".".join(mod)
        if stem[-1] == "chip_smoke":
            return "chip_smoke"
        return ".".join(stem)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def in_package(self, prefix: str) -> bool:
        return self.module == prefix or self.module.startswith(prefix + ".")


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call's callee, else None."""
    return dotted(node.func)


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def line_at(sf: SourceFile, node: ast.AST) -> str:
    return sf.line_text(getattr(node, "lineno", 0)).strip()
