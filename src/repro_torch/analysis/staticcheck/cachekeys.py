"""Cache-key coverage (staticcheck static companion to the retrace rule).

For every ``<...>.cache.get(key, builder)`` call site in ``src/repro_torch/``
(today ``core/engine.py``'s match and join steps), the
builder closure's free variables that are locals of the enclosing function
(parameters, assignments — anything that can vary between calls) must each
appear in the key expression. A closed-over local missing from the key is
exactly how a cached step goes stale: two calls with different static
state hash to the same logical key and the second is served the first's
step. The port's steps are eager functions, which cannot re-trace, so this
pass is where the invariant is held (the JAX package's
``ExecutableCache.retraced_executables`` catches its runtime symptom).

Names that are not enclosing-function locals — module globals, ``self`` —
are exempt: they do not vary call-to-call at one site.
"""
from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis.staticcheck.findings import (
    Finding,
    is_suppressed,
    rule,
    suppressed_lines,
)

rule("cache-key-coverage", "engine",
     "an executable-cache builder closes over a local that is missing from "
     "its cache key")

RULE = "cache-key-coverage"


def _is_cache_get(call: ast.Call) -> bool:
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "get"):
        return False
    v = f.value
    return (isinstance(v, ast.Attribute) and v.attr == "cache") or (
        isinstance(v, ast.Name) and v.id == "cache"
    )


def _names_loaded(node: ast.AST) -> set[str]:
    return {
        n.id for n in ast.walk(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }


def _names_stored(node: ast.AST) -> set[str]:
    return {
        n.id for n in ast.walk(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del))
    }


def _arg_names(fn: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda) -> set[str]:
    a = fn.args
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def _free_names(builder: ast.AST, enclosing) -> set[str]:
    """Free variables of the builder: loads minus its own params/locals.
    For a ``Name`` builder, resolve the local ``def`` of that name inside
    the enclosing function."""
    if isinstance(builder, ast.Lambda):
        return _names_loaded(builder.body) - _arg_names(builder)
    if isinstance(builder, ast.Name) and enclosing is not None:
        for n in ast.walk(enclosing):
            if (
                isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name == builder.id
            ):
                bound = _arg_names(n) | _names_stored(n)
                return _names_loaded(n) - bound - {builder.id}
    # builder shapes we cannot resolve statically (an attribute, a call
    # result): nothing to check
    return set()


def check_file(path: pathlib.Path, rel: str) -> list[Finding]:
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding(RULE, rel, e.lineno or 0, f"unparseable: {e.msg}")]
    sup = suppressed_lines(source)

    # parent links so each call site can find its enclosing function
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    findings: list[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_cache_get(node)):
            continue
        if len(node.args) < 2:
            continue
        key_expr, builder = node.args[0], node.args[1]
        enclosing = node
        while enclosing is not None and not isinstance(
            enclosing, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            enclosing = parents.get(enclosing)
        if enclosing is None:
            continue
        local_names = (
            _arg_names(enclosing) | _names_stored(enclosing)
        ) - {"self", "cls"}
        key_names = _names_loaded(key_expr)
        if isinstance(key_expr, ast.Name):
            # `key = (...)` assigned above the call: the assignment's value
            # is the key expression
            for n in ast.walk(enclosing):
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and n.targets[0].id == key_expr.id
                ):
                    key_names |= _names_loaded(n.value)
        missing = sorted(
            (_free_names(builder, enclosing) & local_names) - key_names
        )
        if missing and not is_suppressed(sup, node.lineno, RULE):
            findings.append(Finding(
                RULE, rel, node.lineno,
                f"builder closes over local(s) {missing} not present in the "
                "cache key — vary them and one key serves a stale step",
            ))
    return findings


def check_cache_keys(repo_root: pathlib.Path) -> list[Finding]:
    findings: list[Finding] = []
    src = repo_root / "src" / "repro_torch"
    for path in sorted(src.rglob("*.py")):
        findings.extend(check_file(path, str(path.relative_to(repo_root))))
    return findings
