"""Static cost model (staticcheck pass e), over op logs.

The JAX package's cost model walks a jaxpr; here each entry point is run
once under the op recorder (`oplog`) and its log priced:

  * ``peak_bytes``        — peak live storage bytes: a storage is live from
    the first op that touches it to the last (the call's own arguments and
    results for the whole call: the caller holds them), and the peak is
    the largest sum over the ops;
  * ``flops``             — matmul-family ops counted exactly (2·out·K),
    elementwise ops and dtype conversions one per output element,
    reductions one per input element, sorts n·log₂n, an indexed read three
    an index and a binary search three a step; a ``kernels.<op>`` pseudo-op
    of a hand-written kernel carries its plain version's count;
  * ``hbm_bytes``         — bytes the ops read and write (`log_bytes`):
    every tensor an op takes or gives, once, at its own size; a view moves
    nothing, and a ``kernels.<op>`` pseudo-op counts its inputs and outputs
    only (the ops inside it are the kernel's, which keeps its temporaries
    on chip). Ops are not fused, so it bounds an unfused step's traffic;
  * ``collective_bytes``  — bytes the sharded engine's collectives move, a
    shard: the per-shard result bytes × the ring multiplier of the JAX
    package's ``roofline.parse_collectives`` (all-reduce 2(n−1)/n,
    all-gather (n−1)/n, permute 1×), with n = S, the stacked shards; on a
    mesh (`log_collectives`) the functional collectives of DTensor's
    redistributions, priced the same way with n their group's size.

The per-entry-point report is enforced against ``analysis/budgets.json``
(the port's own copy): ``cost-budget-exceeded``, ``cost-budget-missing``
(fail closed) and ``cost-superlinear-memory`` (two probe scales).
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib

import torch

from repro_torch.analysis.staticcheck.findings import Finding, rule

rule("cost-budget-exceeded", "costmodel",
     "entry-point cost estimate exceeds its budgets.json ceiling for the "
     "probe workload")
rule("cost-budget-missing", "costmodel",
     "entry point has no budgets.json row (the cost pass fails closed: "
     "new entry points must declare budgets)")
rule("cost-superlinear-memory", "costmodel",
     "peak live bytes grow superlinearly in graph size across the two "
     "probe generator sizes (the paper's linear-space constraint)")

BUDGETS_PATH = pathlib.Path(__file__).resolve().parents[1] / "budgets.json"

_MATMUL = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot"})
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "maximum", "minimum",
    "pow", "exp", "log", "log1p", "expm1", "tanh", "sigmoid", "sqrt", "rsqrt", "abs",
    "neg", "sign", "floor", "ceil", "round", "trunc", "erf", "reciprocal",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "__and__", "__or__",
    "__xor__", "__lshift__", "__rshift__", "bitwise_left_shift", "bitwise_right_shift",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "clamp", "clamp_min", "clamp_max",
    "_to_copy", "cumsum", "cumprod", "cummax", "cummin", "relu", "gelu", "silu",
    "sin", "cos", "lerp", "addcmul", "addcdiv",
})
_REDUCTIONS = frozenset({
    "sum", "prod", "amax", "amin", "max", "min", "any", "all", "argmax", "argmin",
    "mean", "logsumexp", "norm", "linalg_vector_norm",
})
_SORTS = frozenset({"sort", "topk", "msort"})
# indexed reads: three operations an index (the negative-index wrap each
# index pays: a compare, an add, a select — what the JAX package's gathers
# spell out in their jaxprs and its cost model prices)
_GATHERS = frozenset({"index", "index_select", "gather", "take", "take_along_dim"})

# ops that move no bytes: views of an input, and allocations
_NO_TRAFFIC = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "t", "transpose",
    "permute", "select", "slice", "unsqueeze", "squeeze", "as_strided", "alias",
    "detach", "split", "split_with_sizes", "unbind", "narrow", "diagonal", "unfold",
    "view_as", "view_as_real", "view_as_complex", "lift_fresh", "chunk", "movedim",
    "_reshape_alias", "numpy_T", "mT", "flatten", "unflatten", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided",
})

# the collectives of `repro_torch.core.collectives` → the JAX collective
# kind each one stands for
COLLECTIVE_KIND = {
    "or_allreduce": "all-reduce",
    "pmax": "all-reduce",
    "bool_allreduce_any": "all-reduce",
    "gather_load_set": "all-gather",
    "gather_load_set_ring": "collective-permute",
}


def base_name(op: str) -> str:
    """``aten.add_.Tensor`` → ``add``; ``kernels.cin_layer`` → ``cin_layer``."""
    parts = op.split(".")
    name = parts[1] if len(parts) > 1 else parts[0]
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


# ------------------------------------------------------------------- flops
def op_flops(op) -> float:
    """Operations of one logged op."""
    if op.flops is not None:
        return float(op.flops)
    if op.name.startswith("kernels."):
        return 0.0  # the plain version's own aten ops carry the count
    name = base_name(op.name)
    if not op.outputs:
        return 0.0
    out = op.outputs[0].numel
    if name in _MATMUL:
        mats = [t for t in op.inputs if len(t.shape) >= 2]
        if not mats:
            return 0.0
        k = int(mats[0].shape[-1])
        return 2.0 * out * k + (out if name.startswith("add") or name == "baddbmm" else 0)
    if name in _ELEMENTWISE:
        return float(out)
    if name in _REDUCTIONS:
        return float(op.inputs[0].numel if op.inputs else 0)
    if name in _SORTS:
        n = op.inputs[0].numel if op.inputs else 0
        return float(n) * max(math.log2(max(n, 2)), 1.0)
    if name in _GATHERS:
        return 3.0 * float(sum(t.numel for t in op.inputs[1:] if t.dtype != "bool"))
    if name == "searchsorted":
        # a binary search: a compare, a select and an add a step. The
        # reference's join has no binary search (it compacts with a scatter,
        # which its model prices at 0); its ``jnp.searchsorted`` (method
        # "scan") is priced at 10 a step
        n = op.inputs[0].numel if op.inputs else 0
        return 3.0 * out * max(math.ceil(math.log2(n + 1)), 1)
    return 0.0


def log_flops(log) -> float:
    return float(sum(op_flops(o) for o in log.ops))


def _tensor_bytes(t) -> float:
    return float(t.numel * getattr(torch, t.dtype).itemsize)


def op_bytes(op) -> float:
    """Bytes one logged op reads and writes (see the module docstring)."""
    if op.within or base_name(op.name) in _NO_TRAFFIC:
        return 0.0
    return float(sum(_tensor_bytes(t) for t in op.inputs + op.outputs))


def log_bytes(log) -> float:
    return float(sum(op_bytes(o) for o in log.ops))


def plain_flops(op: str, args, kwargs) -> float | None:
    """The operations of a `Kernels` op call on a hand-written kernel: its
    plain version's, run on the same inputs under a fresh recorder. None
    when no input lies on the card: the plain version ran, and its own aten
    ops are in the log."""
    from repro_torch.analysis.staticcheck import oplog
    from repro_torch.core.backend import get_kernels

    if not any(t.is_cuda for t in oplog.tensors_in((args, kwargs))):
        return None
    _, log = oplog.record(getattr(get_kernels("torch"), op), *args, **kwargs)
    return log_flops(log)


# --------------------------------------------------------------- liveness
def peak_bytes(log) -> float:
    """Peak live storage bytes over the log (see the module docstring)."""
    n = max(len(log.ops), 1)
    span: dict[int, list] = {}  # storage → [first op, last op, bytes]

    def touch(t, i):
        s = span.setdefault(t.storage, [i, i, t.nbytes])
        s[0], s[1], s[2] = min(s[0], i), max(s[1], i), max(s[2], t.nbytes)

    for t in log.args:
        touch(t, 0)
    for t in log.results:
        touch(t, n - 1)
    for i, op in enumerate(log.ops):
        for t in op.inputs + op.outputs:
            touch(t, i)
    for t in log.args + log.results:  # the caller holds them throughout
        span[t.storage][0], span[t.storage][1] = 0, n - 1
    delta = [0] * (n + 1)
    for lo, hi, b in span.values():
        delta[lo] += b
        delta[hi + 1] -= b
    peak = live = 0
    for d in delta[:n]:
        live += d
        peak = max(peak, live)
    return float(peak)


# ------------------------------------------------------------- collectives
def collective_bytes(calls) -> dict:
    """Bytes moved a shard by kind, from `CollectiveCall`s (the ring
    conventions of the module docstring, n = the call's shard count)."""
    out: dict[str, float] = {}
    for c in calls:
        kind = COLLECTIVE_KIND.get(c.name)
        if kind is None:
            continue
        n = max(int(c.n_shards), 1)
        ring = (n - 1) / n
        mult = {"all-reduce": 2.0 * ring, "all-gather": ring, "collective-permute": 1.0}[kind]
        out[kind] = out.get(kind, 0.0) + c.result_bytes_per_shard * mult
    return out


# the functional collectives of DTensor's redistributions (a model on a mesh)
FUNCTIONAL_KIND = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_RING = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0, "all-to-all": 1.0}


def log_collectives(log) -> tuple[dict, dict]:
    """``(bytes by kind, calls by kind)`` a rank's functional collectives
    in ``log`` move: each result's bytes × the ring multiplier of the JAX
    package's ``roofline.parse_collectives`` (all-reduce 2(n−1)/n, the
    others (n−1)/n), n the collective's group size."""
    nbytes: dict[str, float] = {}
    count: dict[str, int] = {}
    for o in log.ops:
        kind = FUNCTIONAL_KIND.get(base_name(o.name)) if o.name.startswith("_c10d") else None
        if kind is None:
            continue
        n = max(o.group_size, 1)
        b = sum(_tensor_bytes(t) for t in o.outputs) * _RING[kind] * (n - 1) / n
        nbytes[kind] = nbytes.get(kind, 0.0) + b
        count[kind] = count.get(kind, 0) + 1
    return nbytes, count


# ---------------------------------------------------------------- estimate
@dataclasses.dataclass
class CostEstimate:
    target: str          # engine:<backend>:<kernels>:<key head>
    peak_bytes: float
    flops: float
    collective_bytes: float
    collective_by_kind: dict

    def to_dict(self) -> dict:
        return {
            "target": self.target,
            "peak_bytes": self.peak_bytes,
            "flops": self.flops,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": dict(self.collective_by_kind),
        }


def estimate(log, target: str = "", collectives=()) -> CostEstimate:
    by_kind = collective_bytes(collectives)
    return CostEstimate(
        target=target,
        peak_bytes=peak_bytes(log),
        flops=log_flops(log),
        collective_bytes=float(sum(by_kind.values())),
        collective_by_kind=by_kind,
    )


# ----------------------------------------------------------------- budgets
def load_budgets(path: "pathlib.Path | str | None" = None) -> dict:
    p = pathlib.Path(path) if path is not None else BUDGETS_PATH
    return json.loads(p.read_text())


def _budget_rel(path: "pathlib.Path | str | None") -> str:
    p = pathlib.Path(path) if path is not None else BUDGETS_PATH
    return f"src/repro_torch/analysis/{p.name}"


def aggregate(estimates: "list[CostEstimate]") -> dict:
    """target → per-metric max across that target's entry points."""
    worst: dict[str, dict] = {}
    for e in estimates:
        m = worst.setdefault(e.target, {
            "peak_bytes": 0.0, "flops": 0.0, "collective_bytes": 0.0,
        })
        m["peak_bytes"] = max(m["peak_bytes"], e.peak_bytes)
        m["flops"] = max(m["flops"], e.flops)
        m["collective_bytes"] = max(m["collective_bytes"], e.collective_bytes)
    return worst


def check_budgets(
    estimates: "list[CostEstimate]",
    budgets: dict | None = None,
    *,
    budgets_path: "pathlib.Path | str | None" = None,
) -> list[Finding]:
    """Enforce per-entry-point ceilings (a per-metric max over the entry
    points sharing one target)."""
    if budgets is None:
        budgets = load_budgets(budgets_path)
    rel = _budget_rel(budgets_path)
    entries = budgets.get("entries", {})
    findings: list[Finding] = []
    for target, metrics in sorted(aggregate(estimates).items()):
        row = entries.get(target)
        if row is None:
            findings.append(Finding(
                "cost-budget-missing", target, 0,
                f"no budget row for this entry point in {rel} — the cost "
                "pass fails closed; add a ceiling for the probe workload",
            ))
            continue
        for metric, value in sorted(metrics.items()):
            ceiling = row.get(metric)
            if ceiling is not None and value > ceiling:
                findings.append(Finding(
                    "cost-budget-exceeded", target, 0,
                    f"{metric} {value:.3g} exceeds the checked-in ceiling "
                    f"{ceiling:.3g} ({rel}) — a cost regression on the "
                    "probe workload",
                ))
    return findings


def check_linear_memory(
    small: "list[CostEstimate]",
    big: "list[CostEstimate]",
    *,
    size_ratio: float,
    slack: float = 2.0,
) -> list[Finding]:
    """The paper's linear-space constraint across two generator sizes: per
    entry point, peak bytes at the bigger graph stay within ``slack ×
    size_ratio ×`` the smaller graph's (``slack`` absorbs power-of-two
    capacity rounding; a quadratic structure grows ≈ size_ratio²)."""
    findings: list[Finding] = []
    small_by = aggregate(small)
    bound = slack * size_ratio
    for target, metrics in sorted(aggregate(big).items()):
        base = small_by.get(target, {}).get("peak_bytes", 0.0)
        if base <= 0:
            continue
        ratio = metrics["peak_bytes"] / base
        if ratio > bound:
            findings.append(Finding(
                "cost-superlinear-memory", target, 0,
                f"peak bytes grew {ratio:.2f}x for a {size_ratio:.0f}x "
                f"graph (bound {bound:.1f}x) — resident memory must stay "
                "linear in graph size (PAPER.md core constraint)",
            ))
    return findings
