"""repro_torch.analysis.staticcheck — the port's own static analyzer.

Five passes over the port, each the torch counterpart of the JAX
package's (``src/repro/analysis/staticcheck/``). The JAX passes walk
jaxprs; PyTorch has none, so the port checks the invariant each pass
checks, over op logs (`oplog`): each entry point runs once under a
``TorchDispatchMode`` that records the aten ops it dispatches.

  a. op contracts (`contracts`, `engines`): every registered `Kernels` op
     run on its example and every engine step run again under the
     recorder — output dtypes as declared, no float64 and no int64
     outputs, no device-to-host sync inside an op;
  b. retrace detector (`engines`, plus `cachekeys` statically): one
     logical `ExecutableCache` key is built exactly once across
     run/stream/re-stream;
  c. architecture lint (`archlint`): AST rules keeping bit-twiddling,
     import-time compiled state, engine construction, and stream
     consumers where the layout says they live;
  d. collective safety (`collective_safety`): every collective the
     sharded engine called takes all S shards, each ring shift is a
     permutation, the shard dim is the session's, and the head-STwig
     table is never fetched (Theorem 5);
  e. cost model (`costmodel`): per-entry-point peak live bytes, FLOPs and
     collective bytes against the ceilings in
     ``src/repro_torch/analysis/budgets.json`` — fail-closed on missing
     rows, linear-in-graph-size memory asserted across two probe scales.

Run as ``python -m repro_torch.analysis.staticcheck [--json] [--device D]``
(exit 1 on any finding) or through the pytest suite
(`tests/test_torch_analysis.py`).
"""
from __future__ import annotations

import pathlib

from repro_torch.analysis.staticcheck.findings import (  # noqa: F401
    Finding,
    Rule,
    RULES,
    report_json,
)

# the bigger of the two probe scales for the linear-memory assertion; the
# cost of the probe grows with it, the discrimination (linear vs quadratic
# ≈ scale vs scale²) too
MEMORY_SCALE = 4


def run_all(
    repo_root: "pathlib.Path | str | None" = None,
    *,
    device=None,
    engines: bool = True,
    kernel_backends=None,
    collectives: bool = True,
    costs: bool = True,
    reports: "dict | None" = None,
) -> "list[Finding]":
    """All passes on ``device`` (``None``: the card; it raises without
    one), over ``kernel_backends`` (default: every registered backend).

    The collective-safety and cost-model passes read what the engine probe
    records, so ``engines=False`` skips them too. Pass a dict as
    ``reports`` to receive the side reports: ``collectives`` (each probe's
    collective sequence), ``steps`` (each entry point's ops and host
    syncs), ``launches`` (CUDA kernel launches of each pass) and
    ``cost_report`` (per-entry-point estimates and per-target aggregates).
    """
    from repro_torch.analysis.staticcheck import archlint, cachekeys, contracts
    from repro_torch.analysis.staticcheck import engines as engines_mod
    from repro_torch.core.backend import available_backends, resolve_device

    dev = resolve_device(device)
    if repo_root is None:
        repo_root = pathlib.Path(__file__).resolve().parents[4]
    repo_root = pathlib.Path(repo_root)
    reports = {} if reports is None else reports
    backends = tuple(kernel_backends or available_backends())

    before = engines_mod.kernel_launches()
    findings = list(contracts.check_kernel_contracts(backends, dev))
    after = engines_mod.kernel_launches()
    reports.setdefault("launches", {})["contracts"] = {
        k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)
    }
    if engines:
        engine_findings, traces = engines_mod.check_engines_traces(
            kernels=backends, device=dev, collectives=collectives, reports=reports,
        )
        findings.extend(engine_findings)
        if costs:
            from repro_torch.analysis.staticcheck import costmodel

            estimates = [costmodel.estimate(t.log, t.target, t.collectives) for t in traces]
            findings.extend(costmodel.check_budgets(estimates))
            # linear-memory bound: probe a MEMORY_SCALE× graph on the plain
            # versions (the kernels run the same programs)
            _, big_traces = engines_mod.check_engines_traces(
                kernels=("torch",), device=dev, scale=MEMORY_SCALE,
            )
            big = [costmodel.estimate(t.log, t.target, t.collectives) for t in big_traces]
            budgets = costmodel.load_budgets()
            findings.extend(costmodel.check_linear_memory(
                [e for e in estimates if ":torch:" in e.target], big,
                size_ratio=float(MEMORY_SCALE),
                slack=float(budgets.get("linear_slack", 2.0)),
            ))
            reports["cost_report"] = {
                "executables": [e.to_dict() for e in estimates],
                "aggregates": costmodel.aggregate(estimates),
                "memory_scale": MEMORY_SCALE,
                "aggregates_scaled": costmodel.aggregate(big),
            }
            reports["traces"] = traces
    findings.extend(cachekeys.check_cache_keys(repo_root))
    findings.extend(archlint.run(str(repo_root)))
    return findings
