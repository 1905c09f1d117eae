"""Finding/rule plumbing shared by the staticcheck passes (a copy of the JAX
package's ``analysis/staticcheck/findings.py``).

A `Finding` names the rule that fired, where, and why; rules are registered
in a flat table so the CLI can list them and the fixture suite can assert
each one both fires on a planted violation and stays silent on the clean
tree. Suppression: an AST rule skips any source line carrying a
``# staticcheck: ignore[rule-id]`` comment.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Iterable

_IGNORE_RE = re.compile(r"#\s*staticcheck:\s*ignore\[([a-z0-9-]+(?:,\s*[a-z0-9-]+)*)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # file (or backend/op pseudo-path) the finding is in
    line: int          # 1-based; 0 when not line-addressable (traced passes)
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    layer: str         # which architectural layer the rule protects
    description: str


RULES: dict[str, Rule] = {}


def rule(id: str, layer: str, description: str) -> Rule:
    r = Rule(id, layer, description)
    RULES[id] = r
    return r


def suppressed_lines(source: str) -> dict[int, set[str]]:
    """Map of 1-based line number → rule ids suppressed on that line."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",")}
    return out


def is_suppressed(sup: dict[int, set[str]], line: int, rule_id: str) -> bool:
    return rule_id in sup.get(line, ())


def report_json(findings: Iterable[Finding], extras: dict | None = None) -> str:
    """`extras` merges additional report sections (e.g. the collective
    sequences and cost report) into the JSON document; reserved keys
    cannot be overridden."""
    fs = list(findings)
    doc = dict(extras or {})
    doc.update(
        {
            "n_findings": len(fs),
            "rules": {
                rid: dataclasses.asdict(r) for rid, r in sorted(RULES.items())
            },
            "findings": [f.to_dict() for f in fs],
        }
    )
    return json.dumps(doc, indent=2)
