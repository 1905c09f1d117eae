"""Architecture lint (staticcheck pass c): the port's layering rules as
named, suppressible AST rules — the JAX package's seven
(``src/repro/analysis/staticcheck/archlint.py``), pointed at the port's
layout: it walks ``src/repro_torch/``, and its roots are ``tests/``,
``benchmarks/``, ``examples/``, ``scripts/`` and ``chip_smoke.py``.

  * ``bitset-twiddling``        — packed-word bit arithmetic lives ONLY in
                                  ``kernels/bitset/`` (DESIGN.md §2);
  * ``module-jit-state``        — no module-level ``lru_cache`` state and
                                  no ``torch.jit``/``torch.compile`` built
                                  at import (sessions own caches);
  * ``direct-engine-construction`` — engines are built by
                                  ``api/session.py`` only;
  * ``stream-host-sync``        — no device syncs (``.item()``,
                                  ``.cpu()``, ``torch.cuda.synchronize``)
                                  inside a loop consuming ``stream()`` /
                                  ``stream_blocks()`` pages;
  * ``missing-slow-marker``     — subprocess/e2e test modules carry the
                                  ``slow`` pytest marker;
  * ``orphan-module``           — every ``src`` module is reachable from a
                                  test/benchmark/example/script or a declared
                                  CLI entry point (``extras/`` is the
                                  quarantine boundary and is exempt);
  * ``unused-import``           — no dead imports in ``src``.

Suppress a specific line with ``# staticcheck: ignore[rule-id]``.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator

from repro_torch.analysis.staticcheck.findings import (
    Finding,
    is_suppressed,
    rule,
    suppressed_lines,
)

rule("bitset-twiddling", "kernels/bitset",
     "packed-bitset word arithmetic (>>5, &31, %32, //32, popcount masks) "
     "outside kernels/bitset/")
rule("module-jit-state", "api/session",
     "module-level lru_cache or import-time torch.jit/torch.compile state")
rule("direct-engine-construction", "api/session",
     "SubgraphMatcher/DistributedMatcher constructed outside api/session.py")
rule("stream-host-sync", "core/stream",
     ".item()/.cpu()/torch.cuda.synchronize() inside a stream-consuming loop")
rule("missing-slow-marker", "ci",
     "subprocess/e2e test module without the `slow` pytest marker")
rule("orphan-module", "repo layout",
     "src module unreachable from tests/benchmarks/examples/scripts or a "
     "declared entry point (quarantine dead scaffolding under repro_torch/extras/)")
rule("unused-import", "hygiene", "import never referenced in the module")

# Paths (relative, substring match) where each rule does not apply.
BITSET_ALLOWED = ("kernels/bitset/",)
ENGINE_CTOR_ALLOWED = ("api/session.py",)
# CLI entry points reached via `python -m`, not imports. repro_torch/extras/
# is the one sanctioned home for not-yet-wired scaffolding and is exempt
# wholesale.
ENTRY_POINT_MODULES = {
    "repro_torch.launch.serve",
    "repro_torch.analysis.staticcheck.__main__",  # the staticcheck CLI itself
}
ORPHAN_EXEMPT_DIRS = ("repro_torch/extras/",)
# the port's package, its roots, and the files of the roots the engine
# rules read (the port's own scripts; the JAX package's are its lint's)
PACKAGE = "src/repro_torch"
ROOT_DIRS = ("tests", "benchmarks", "examples", "scripts")
ROOT_FILES = ("chip_smoke.py",)
SYNC_CALLS = ("item", "cpu", "synchronize", "block_until_ready", "device_get")
JIT_BUILDERS = ("jit", "script", "trace", "compile")

_POPCOUNT_MASKS = {0x55555555, 0x33333333, 0x0F0F0F0F, 0x01010101}
_WORD_NAMES = {"WORD_BITS"}
_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _py_files(root: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _const_of(node: ast.AST):
    """Unwrap `31`, `np.uint32(31)`, `jnp.uint32(31)` → 31."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if (
        isinstance(node, ast.Call)
        and len(node.args) == 1
        and not node.keywords
        and isinstance(node.args[0], ast.Constant)
        and isinstance(node.args[0].value, int)
    ):
        return node.args[0].value
    return None


def _is_word_name(node: ast.AST) -> bool:
    return (isinstance(node, ast.Name) and node.id in _WORD_NAMES) or (
        isinstance(node, ast.Attribute) and node.attr in _WORD_NAMES
    )


def _rel(path: str, repo_root: str) -> str:
    return os.path.relpath(path, repo_root)


# ------------------------------------------------------------- per-file rules
def _check_bitset_twiddling(tree, relpath, sup):
    if any(a in relpath for a in BITSET_ALLOWED):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.BinOp):
            continue
        c = _const_of(node.right)
        word_name = _is_word_name(node.right)
        bad = None
        if isinstance(node.op, (ast.RShift, ast.LShift)) and c == 5:
            bad = "word-index shift by 5"
        elif isinstance(node.op, ast.BitAnd) and (
            c == 31 or c in _POPCOUNT_MASKS
        ):
            bad = f"bit-extract mask {c if c == 31 else hex(c)}"
        elif isinstance(node.op, (ast.Mod, ast.FloorDiv)) and (
            c == 32 or word_name
        ):
            bad = "word-size divide/modulo"
        if bad and not is_suppressed(sup, node.lineno, "bitset-twiddling"):
            yield Finding(
                "bitset-twiddling", relpath, node.lineno,
                f"{bad}: packed-bitset arithmetic belongs in "
                "kernels/bitset/ (DESIGN.md §2)",
            )


def _check_module_jit_state(tree, relpath, sup):
    def deco_is_cache(d: ast.AST) -> bool:
        target = d.func if isinstance(d, ast.Call) else d
        name = target.attr if isinstance(target, ast.Attribute) else (
            target.id if isinstance(target, ast.Name) else ""
        )
        return name in ("lru_cache", "cache")

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.decorator_list:
                if deco_is_cache(d) and not is_suppressed(
                    sup, node.lineno, "module-jit-state"
                ):
                    yield Finding(
                        "module-jit-state", relpath, node.lineno,
                        f"`{node.name}` holds process-global lru_cache state "
                        "— key executables in a session-owned "
                        "ExecutableCache instead",
                    )
    for node in tree.body:  # import-time jit: module scope only
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            if (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and isinstance(value.func.value, (ast.Name, ast.Attribute))
                and value.func.attr in JIT_BUILDERS
                and (
                    value.func.value.attr
                    if isinstance(value.func.value, ast.Attribute)
                    else value.func.value.id
                ) in ("torch", "jit")
                and not is_suppressed(sup, node.lineno, "module-jit-state")
            ):
                yield Finding(
                    "module-jit-state", relpath, node.lineno,
                    f"module-level torch.{value.func.attr} state built at import time",
                )


def _check_engine_construction(tree, relpath, sup):
    if any(a in relpath for a in ENGINE_CTOR_ALLOWED):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else ""
        )
        if name in ("SubgraphMatcher", "DistributedMatcher") and not (
            is_suppressed(sup, node.lineno, "direct-engine-construction")
        ):
            yield Finding(
                "direct-engine-construction", relpath, node.lineno,
                f"direct {name} construction — open a GraphSession instead "
                "(engines are deprecated construction targets)",
            )


def _iter_stream_loops(tree) -> Iterator[ast.For]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.For):
            continue
        for sub in ast.walk(node.iter):
            if isinstance(sub, ast.Call):
                f = sub.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else ""
                )
                if name in ("stream", "match_stream", "stream_blocks"):
                    yield node
                    break
        else:
            continue


def _check_stream_host_sync(tree, relpath, sup):
    for loop in _iter_stream_loops(tree):
        for node in ast.walk(loop):
            if node is loop.iter or not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else ""
            )
            if name in SYNC_CALLS and not (
                is_suppressed(sup, node.lineno, "stream-host-sync")
            ):
                yield Finding(
                    "stream-host-sync", relpath, node.lineno,
                    f"{name}() inside a stream-consuming loop defeats "
                    "pipelined first-K delivery (pages are already host "
                    "numpy; sync before or after the loop)",
                )


def _check_slow_marker(tree, relpath, sup, source):
    if "/tests/" not in "/" + relpath and not relpath.startswith("tests/"):
        return
    uses = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.Import, ast.ImportFrom))
        and any(
            (a.name if isinstance(n, ast.Import) else (n.module or ""))
            .split(".")[0] == "subprocess"
            for a in n.names
        )
    ]
    if not uses:
        return
    if re.search(r"^pytestmark\s*=.*\bslow\b", source, re.M):
        return
    # per-function markers: every function whose body reaches subprocess
    # must be marked slow
    for fn in [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
        touches = any(
            isinstance(n, (ast.Import, ast.ImportFrom, ast.Name, ast.Attribute))
            and "subprocess" in ast.dump(n)
            for n in ast.walk(fn)
        )
        if not touches:
            continue
        marked = any("slow" in ast.dump(d) for d in fn.decorator_list)
        if not marked and not is_suppressed(sup, fn.lineno, "missing-slow-marker"):
            yield Finding(
                "missing-slow-marker", relpath, fn.lineno,
                f"`{fn.name}` spawns subprocesses without a `slow` marker — "
                "mark it (or the module) so the fast CI job skips it",
            )


def _check_unused_imports(tree, relpath, sup, source):
    if not relpath.startswith("src/") or relpath.endswith("__init__.py"):
        return
    # names used anywhere: identifiers + identifiers inside string constants
    # (string annotations under `from __future__ import annotations`)
    used: set[str] = set()
    tc_linenos: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.update(_IDENT_RE.findall(node.value))
        elif isinstance(node, ast.If):
            t = node.test
            is_tc = (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or (
                isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING"
            )
            if is_tc:
                for sub in ast.walk(node):
                    tc_linenos.add(getattr(sub, "lineno", 0))
    lines = source.splitlines()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if node.lineno in tc_linenos:
            continue
        for a in node.names:
            if a.name == "*":
                continue
            bound = (a.asname or a.name).split(".")[0]
            if bound in used:
                continue
            text = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            if "noqa" in text:
                continue
            if is_suppressed(sup, node.lineno, "unused-import"):
                continue
            yield Finding(
                "unused-import", relpath, node.lineno,
                f"`{bound}` is imported but never used",
            )


# -------------------------------------------------------------- orphan pass
def _module_name(relpath: str) -> str | None:
    if not relpath.startswith(PACKAGE + "/"):
        return None
    mod = relpath[len("src/"):-len(".py")].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _imports_of(tree) -> set[str]:
    out: set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out.update(a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module:
            out.add(n.module)
            out.update(f"{n.module}.{a.name}" for a in n.names)
    return out


def _check_orphans(parsed: dict[str, ast.Module]):
    """Reachability over the import graph: roots are every non-src file plus
    the declared CLI entry points; anything in src not reached is dead
    scaffolding (exempt: repro/extras/, the explicit quarantine)."""
    mods = {}
    for relpath in parsed:
        m = _module_name(relpath)
        if m is not None:
            mods[m] = relpath
    reached: set[str] = set()
    frontier: list[str] = list(ENTRY_POINT_MODULES)
    for relpath, tree in parsed.items():
        if not relpath.startswith(PACKAGE + "/"):
            frontier.extend(m for m in _imports_of(tree) if m in mods)
    while frontier:
        m = frontier.pop()
        if m in reached or m not in mods:
            continue
        reached.add(m)
        parts = m.split(".")
        frontier.extend(
            ".".join(parts[:i]) for i in range(1, len(parts))
        )  # parent packages (their __init__ runs on import)
        frontier.extend(
            im for im in _imports_of(parsed[mods[m]]) if im in mods
        )
    for m, relpath in sorted(mods.items()):
        if m in reached or any(d in relpath for d in ORPHAN_EXEMPT_DIRS):
            continue
        yield Finding(
            "orphan-module", relpath, 1,
            f"`{m}` is unreachable from every test/benchmark/example/script "
            "and is not a declared entry point — delete it or quarantine it "
            "under src/repro_torch/extras/",
        )


# ----------------------------------------------------------------- entry
def _in_scope(relpath: str) -> bool:
    """Files the engine rules read: the package, the root files, and the
    port's own scripts (``*torch*`` under benchmarks/examples/scripts)."""
    top = relpath.split("/")[0]
    return (
        relpath.startswith(PACKAGE + "/")
        or relpath in ROOT_FILES
        or (top in ("benchmarks", "examples", "scripts") and "torch" in relpath)
    )


def run(repo_root: str) -> list[Finding]:
    parsed: dict[str, ast.Module] = {}
    sources: dict[str, str] = {}
    findings: list[Finding] = []
    paths = []
    for r in (PACKAGE,) + ROOT_DIRS:
        absroot = os.path.join(repo_root, r)
        if os.path.isdir(absroot):
            paths.extend(_py_files(absroot))
    paths.extend(
        os.path.join(repo_root, f) for f in ROOT_FILES
        if os.path.isfile(os.path.join(repo_root, f))
    )
    for path in paths:
        relpath = _rel(path, repo_root)
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            parsed[relpath] = ast.parse(src)
            sources[relpath] = src
        except SyntaxError as e:
            findings.append(
                Finding("orphan-module", relpath, e.lineno or 1,
                        f"unparseable: {e.msg}")
            )
    for relpath, tree in parsed.items():
        sup = suppressed_lines(sources[relpath])
        src = sources[relpath]
        if relpath.startswith(PACKAGE + "/"):
            findings.extend(_check_bitset_twiddling(tree, relpath, sup))
            findings.extend(_check_module_jit_state(tree, relpath, sup))
            findings.extend(_check_unused_imports(tree, relpath, sup, src))
        if _in_scope(relpath):
            findings.extend(_check_engine_construction(tree, relpath, sup))
            findings.extend(_check_stream_host_sync(tree, relpath, sup))
        if relpath.startswith("tests/"):
            findings.extend(_check_slow_marker(tree, relpath, sup, src))
    findings.extend(_check_orphans(parsed))
    return findings
