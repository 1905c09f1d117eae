"""Engine entry-point probe (staticcheck passes a+b on the live engines).

Opens a tiny `GraphSession` per (engine backend × kernel backend) on the
given device (the JAX package's probe graph and query, at small plan
capacities, `PROBE_CAPS`), installs the `ExecutableCache` recorder and the collectives
hook (`collective_safety.Recording`), and drives the real entry points —
``compile``, ``run(adaptive=False)``, ``stream`` and a re-stream — with the
kernel backend wrapped in `oplog.RecordingKernels` (same name, so the cache
keys are the backend's). Every step the cache built, and every collective
the sharded engine called, is then run again with its recorded arguments
under the op recorder: its `EntryTrace` holds the op log that stands where
the JAX package's jaxpr stands, checked by the contract pass's
``dtype-width`` rule and priced by the cost model.

Retrace rule: after run + stream + re-stream, no logical cache key may
have been built twice (`duplicate_traces`), and no cached callable may hold
more than one trace (`retraced_executables`; the static companion is
`cachekeys`).

The engines' steps are host-driven (a round reads its root count, a join
its overflow flag), so the host syncs inside a step are counted in the
side report, not reported as findings.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.staticcheck import collective_safety, contracts, costmodel, oplog
from repro_torch.analysis.staticcheck.findings import Finding, rule
from repro_torch.core import collectives

rule("retrace", "engine",
     "a logical executable-cache key built more than once across "
     "run/stream/re-stream (or a cached callable re-traced under one key)")

ENGINE_BACKENDS = ("local", "sharded")
PROBE_SHARDS = 4  # the sharded probe's S: every shard stacked on the device
# the probe's plan capacities: the defaults size a 65,536-row join, which
# the plain versions take seconds a shard to run on the CPU; these keep
# every step (and the join's probe pairs) small
PROBE_CAPS = dict(emission_budget=1 << 11, join_rows_cap=1 << 13, join_dup_cap=32)


@dataclasses.dataclass
class EntryTrace:
    """One entry point, run again under the op recorder: the raw material
    of the collective-safety and cost-model passes."""

    key: tuple          # the ExecutableCache key (collectives: (name,))
    target: str         # engine:<backend>:<kernels>:<key head>
    backend: str        # engine backend ("local" | "sharded")
    kernels: str        # kernel backend name
    log: oplog.OpLog
    collectives: list = dataclasses.field(default_factory=list)
    # the entry point and its recorded arguments, to run it once more (the
    # smoke run measures each step's device memory this way)
    call: tuple = ()

    @property
    def n_syncs(self) -> int:
        return self.log.n_syncs


def _tiny_graph(scale: int = 1):
    from repro_torch.graphstore import generators

    # scale multiplies nodes AND edges so density (and the caps plans
    # derive from it) grows linearly — the cost pass compares peak bytes
    # across two scales to assert the paper's linear-space bound
    return generators.rmat(120 * scale, 420 * scale, 4, seed=3, symmetrize=True)


def _probe_query():
    from repro_torch.core.query import QueryGraph

    # a labeled 4-path decomposes into ≥2 STwigs, so the probe exercises
    # match, join and the sharded fetch
    return QueryGraph.build([0, 1, 2, 3], [(0, 1), (1, 2), (2, 3)])


def _key_head(key) -> str:
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return type(key).__name__


def kernel_launches() -> dict:
    """The CUDA kernels' launch counts so far (reading them builds nothing)."""
    from repro_torch.kernels import cuda

    return cuda.launch_counts()


def _rerun_collective(call, n_shards: int):
    """Run one recorded collective again under a fresh recorder: its op
    log, the collective calls it made, and ``(fn, args, kwargs)``."""
    operands, info = call.args
    fn = getattr(collectives, call.name)
    kw = dict(operands)
    if call.name == "gather_load_set_ring":
        kw["max_dist"] = max(abs(s) for s in info["shifts"])
    elif call.name == "fetch_load_set":
        kw["ring_radius"] = info.get("ring_radius")
    sub = collective_safety.Recording(n_shards)
    with sub:
        _, log = oplog.record(fn, **kw)
    return log, sub.calls, (fn, (), kw)


def probe_traces(
    backend: str, kernels: str, *, device=None, scale: int = 1,
    collectives: bool = True, reports: dict | None = None,
) -> "tuple[list[Finding], list[EntryTrace]]":
    """Drive one engine/kernels combination end to end on ``device``
    (``None``: the card; it raises without one), check every step it
    built (retrace, ``dtype-width``) and, unless ``collectives`` is false,
    every collective it called (`collective_safety`), and return the entry
    traces (the collectives' among them, for the cost model)."""
    from repro_torch.api.session import GraphSession
    from repro_torch.core.backend import get_kernels, resolve_device

    dev = resolve_device(device)
    findings: list[Finding] = []
    traces: list[EntryTrace] = []
    target = f"engine:{backend}:{kernels}"
    recorded: dict = {}
    n_shards = PROBE_SHARDS if backend == "sharded" else 1
    recording = collective_safety.Recording(n_shards)
    head: list = []  # the head STwig's spec, once compiled

    def taint_table(out) -> None:
        table = out[0]
        recording.taint(table.cols)
        recording.taint(table.valid)

    def recorder(key, fn, args, kwargs):
        recorded.setdefault(key, (fn, args, kwargs))
        if head and key[0] == "match" and key[1] == head[0]:
            return taint_table
        return None

    kern = oplog.RecordingKernels(get_kernels(kernels), costmodel.plain_flops)
    before = kernel_launches()
    session = GraphSession.open(
        _tiny_graph(scale), backend=backend, kernels=kern, device=dev,
        n_shards=n_shards if backend == "sharded" else None,
    )
    try:
        session.cache.recorder = recorder
        with recording:
            compiled = session.compile(_probe_query(), max_matches=0, **PROBE_CAPS)
            head.append(compiled.plan.specs[compiled.plan.head])
            compiled.run(adaptive=False)
            for _ in compiled.stream(page_size=16):
                pass
            for _ in compiled.stream(page_size=16):  # re-stream: all cache hits
                pass
        session.cache.recorder = None

        for key in session.cache.duplicate_traces():
            findings.append(Finding(
                "retrace", f"{target}:{_key_head(key)}", 0,
                f"logical key built more than once: {key!r}",
            ))
        for key, n in session.cache.retraced_executables():
            findings.append(Finding(
                "retrace", f"{target}:{_key_head(key)}", 0,
                f"step re-traced {n}x under one cache key (a static argument "
                f"is missing from the key): {key!r}",
            ))
        if collectives:
            findings.extend(collective_safety.check(recording, target))

        for key, (fn, args, kwargs) in recorded.items():
            ktarget = f"{target}:{_key_head(key)}"
            try:
                _, log = oplog.record(fn, *args, **kwargs)
            except Exception as e:
                findings.append(Finding(
                    "out-dtype", ktarget, 0,
                    f"entry point failed to run again with its recorded "
                    f"arguments: {type(e).__name__}: {e}",
                ))
                continue
            # host syncs in a step are the engine's design: counted, not found
            findings.extend(contracts.check_log(log, ktarget, host_ok=True))
            traces.append(EntryTrace(key, ktarget, backend, kernels, log,
                                     call=(fn, args, kwargs)))
        first: dict = {}
        for call in recording.calls:
            first.setdefault(call.name, call)
        for name, call in first.items():
            log, calls, rerun = _rerun_collective(call, n_shards)
            ktarget = f"{target}:{name}"
            findings.extend(contracts.check_log(log, ktarget))
            traces.append(EntryTrace((name,), ktarget, backend, kernels, log, calls, rerun))
    finally:
        session.close()
    if reports is not None:
        after = kernel_launches()
        reports.setdefault("launches", {})[target] = {
            k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)
        }
        reports.setdefault("collectives", []).append({
            "target": target, "n_shards": n_shards,
            "collectives": [c.name for c in recording.calls]})
        reports.setdefault("steps", []).extend(
            {"target": t.target, "ops": len(t.log.ops), "host_syncs": t.n_syncs,
             # int64 values inside the step: not a finding (the rule holds a
             # step's outputs), counted for the record
             "int64_values": sum(x.dtype == "int64" for o in t.log.ops for x in o.outputs)}
            for t in traces
        )
    return findings, traces


def rank_probe(rank: int, kernels: str = "torch", device=None, mesh=None) -> dict:
    """The engine probe on one rank of ``mesh`` (``None``: a mesh of the
    world's ranks; run it in every rank of the mesh, by
    `repro_torch.launch.mesh.spawn_ranks`): the probe graph in one shard a
    rank, the rank engine's run, stream and re-stream recorded, the head
    STwig's tables tainted, and the collective-safety pass over this rank's
    calls. Returns this rank's findings, its call sequence (for
    `collective_safety.check_rank_sequences`) and its kernel launches."""
    from repro_torch.api.session import GraphSession
    from repro_torch.core.backend import get_kernels, resolve_device
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.launch.mesh import make_host_mesh

    dev = resolve_device(device)
    mesh = make_host_mesh() if mesh is None else mesh
    S = mesh.size()
    target = f"engine:rank:{kernels}"
    recording = collective_safety.Recording(S)
    head: list = []

    def recorder(key, fn, args, kwargs):
        if head and key[0] == "match" and key[1] == head[0]:
            return lambda out: (recording.taint(out[0].cols), recording.taint(out[0].valid))
        return None

    before = kernel_launches()
    session = GraphSession.open(
        PartitionedGraph.build(_tiny_graph(), S), mesh=mesh,
        kernels=get_kernels(kernels), device=None if device is None else dev)
    try:
        session.cache.recorder = recorder
        with recording:
            compiled = session.compile(_probe_query(), max_matches=0, **PROBE_CAPS)
            head.append(compiled.plan.specs[compiled.plan.head])
            compiled.run(adaptive=False)
            for _ in range(2):  # stream and re-stream
                for _ in compiled.stream(page_size=16):
                    pass
        session.cache.recorder = None
    finally:
        session.close()
    after = kernel_launches()
    return {
        "rank": rank,
        "findings": collective_safety.check(recording, f"{target}:rank{rank}"),
        "sequence": collective_safety.rank_sequence(recording.calls),
        "launches": {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)},
    }


def check_rank_probes(results, target: str = "engine:rank") -> list[Finding]:
    """Every rank's findings of `rank_probe`, and the ranks' call sequences
    held to one another."""
    findings = [f for r in results for f in r["findings"]]
    return findings + collective_safety.check_rank_sequences(
        [r["sequence"] for r in results], target)


def check_engines_traces(
    backends=ENGINE_BACKENDS, kernels=("torch",), *, device=None, scale: int = 1,
    collectives: bool = True, reports: dict | None = None,
) -> "tuple[list[Finding], list[EntryTrace]]":
    findings: list[Finding] = []
    traces: list[EntryTrace] = []
    for b in backends:
        for k in kernels:
            fs, ts = probe_traces(b, k, device=device, scale=scale,
                                  collectives=collectives, reports=reports)
            findings.extend(fs)
            traces.extend(ts)
    return findings, traces
