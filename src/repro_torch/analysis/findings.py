"""Finding/Rule data model, fingerprints, and ``noqa`` suppression."""

from __future__ import annotations

import dataclasses
import hashlib
import re

__all__ = ["Finding", "Rule", "fingerprint", "noqa_codes"]

# `# repro_torch: noqa` (suppress everything on the line) or
# `# repro_torch: noqa[RPT101]` / `# repro_torch: noqa[RPT101, RPT203]`;
# in a CUDA source the comment starts with `//`.  The reference checker's
# `# repro: noqa` tag does not match, and hides nothing from this one.
_NOQA = re.compile(r"(?:#|//)\s*repro_torch:\s*noqa(?:\[([A-Z0-9,\s]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line."""

    code: str          # e.g. "RPT101"
    path: str          # repo-relative (or invocation-relative) posix path
    line: int          # 1-based
    col: int           # 0-based
    message: str
    snippet: str = ""  # the offending source line, stripped

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.code} {self.message}"

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = fingerprint(self)
        return d


def fingerprint(f: Finding) -> str:
    """Stable identity for baselining: survives line-number drift (the
    line content, not the line number, is hashed) but changes when the
    offending code itself changes, so a baselined finding resurfaces the
    moment the grandfathered line is edited."""
    h = hashlib.sha1()
    h.update(f.path.encode())
    h.update(b"\0")
    h.update(f.code.encode())
    h.update(b"\0")
    h.update(f.snippet.strip().encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One analyzer: a code, a human name, a checker over the parsed
    corpus (``check(corpus) -> Iterator[Finding]``), and the long
    explanation ``--explain CODE`` prints."""

    code: str
    name: str
    check: object
    explain: str


def noqa_codes(line: str) -> frozenset | None:
    """Codes suppressed on ``line``: None = no noqa, empty set = all."""
    m = _NOQA.search(line)
    if m is None:
        return None
    if m.group(1) is None:
        return frozenset()
    return frozenset(c.strip() for c in m.group(1).split(",") if c.strip())
