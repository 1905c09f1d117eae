"""Collective-safety analysis (staticcheck pass d), over recorded calls.

The JAX package walks each ``shard_map`` body for its collectives. Here the
S shards are stacked on one device and each collective of
`repro_torch.core.collectives` (`or_allreduce`, `pmax`, `bool_allreduce_any`,
`gather_load_set`, `gather_load_set_ring`, `fetch_load_set`) is an op over the stacked dim 0,
so the pass reads the calls themselves: `Recording` installs the module's
``recorder`` hook and an op recorder (`oplog`) around a run, and `check`
holds every recorded call to the JAX package's four invariants, in their
stacked form. The rank collectives (`repro_torch.core.rank_collectives`,
one shard a process) report to the same hook with their ``group_size``;
their calls are held to the same invariants in their per-rank form (noted
under each), and `check_rank_sequences` holds the ranks' call sequences to
one another:

  * ``coll-divergent-control`` — every shard enters the collective: its
    shard-stacked operands agree on dim 0 (a collective some shards skip
    is the SPMD deadlock the JAX rule guards against); per rank, every
    rank made the same sequence of collectives on groups of one size;
  * ``coll-ppermute-bijection`` — each shift of the ring fetch hands every
    shard exactly one source: its source map is a permutation of
    ``0..S-1`` (a missing source silently drops a neighbour's table);
  * ``coll-axis-name`` — the shard dim resolves against the session: the
    stacked dim 0 (and the load set's both dims) is the engine's
    ``n_shards``; per rank, the group has ``n_shards`` ranks and the load
    row ``n_shards`` entries;
  * ``coll-head-gather`` — Theorem 5: no fetch operand derives from the
    head-STwig table. The head table's storages are the results of the
    head STwig's match steps (found from the step keys, as the JAX
    package's ``head_taints_for_key`` finds them); taint runs forward
    through the op log, every op with a tainted input tainting its outputs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.staticcheck import oplog
from repro_torch.analysis.staticcheck.findings import Finding, rule
from repro_torch.core import collectives

rule("coll-divergent-control", "collectives",
     "a collective's shard-stacked operands disagree on dim 0 (some shards "
     "did not enter the collective)")
rule("coll-ppermute-bijection", "collectives",
     "a ring-fetch shift's source map is not a permutation of the shards")
rule("coll-axis-name", "collectives",
     "a collective's shard dim does not match the engine's n_shards")
rule("coll-head-gather", "collectives",
     "head-STwig table flows into a fetch collective (Theorem 5: the head is "
     "never fetched — that is what keeps per-shard pages disjoint)")

FETCH_COLLECTIVES = ("gather_load_set", "gather_load_set_ring", "fetch_load_set")


@dataclasses.dataclass
class CollectiveCall:
    """One recorded collective call."""

    name: str
    dims: dict                   # operand name → shape
    storages: dict               # operand name → storage identity
    n_shards: int                # the session's S
    result_bytes_per_shard: float
    sources: tuple = ()          # ring: one source map a shift
    group_size: int = 0          # a rank collective's group (0: stacked)
    position: int = 0            # ops in the run's log before the call
    args: tuple = ()             # (operands, info): to run the call again


def _per_shard_bytes(name: str, result, info: dict, S: int) -> float:
    """Bytes each shard receives: the replicated result of a reduction;
    the gathered rows and the shard's validity row of an all-gather; the
    ring's fetched blocks (its own block excluded)."""
    if name in ("or_allreduce", "pmax", "psum", "bool_allreduce_any"):
        return float(result.nbytes)
    if info.get("group_size"):
        # a rank's own receipts: the others' blocks of a gather or ring
        if name == "gather_rows":
            return float(sum(r.nbytes for r in result))
        if name in ("gather_load_set", "gather_load_set_ring"):
            n_blocks = (len(info.get("sources", ())) + 1 if name == "gather_load_set_ring"
                        else info["group_size"])
            return (float(result[0].nbytes) + float(result[1].nbytes)) * (n_blocks - 1) / n_blocks
        return 0.0
    if name == "gather_load_set":
        cols, mask = result
        return float(cols.nbytes) + float(mask.nbytes) / max(S, 1)
    if name == "gather_load_set_ring":
        cols, valid = result
        n_blocks = len(info.get("shifts", ())) or 1
        return (float(cols.nbytes) + float(valid.nbytes)) / max(S, 1) * (n_blocks - 1) / n_blocks
    return 0.0


class Recording:
    """Installs the collectives hook and an op recorder for one run.
    ``taint(t)`` marks a tensor's storage as the head table's from this
    point of the run on."""

    def __init__(self, n_shards: int):
        self.n_shards = int(n_shards)
        self.calls: list[CollectiveCall] = []
        self.sources: list[tuple[int, int]] = []  # (position, storage)
        self.rec = oplog.OpRecorder()
        self._prev = None

    @property
    def log(self) -> oplog.OpLog:
        return self.rec.log

    def taint(self, t: torch.Tensor) -> None:
        self.sources.append((len(self.log.ops), self.rec.rec(t).storage))

    def hook(self, name, operands, result, info) -> None:
        self.rec.paused += 1  # reading the source maps is not the run's
        try:
            sources = tuple(tuple(int(x) for x in s.tolist()) for s in info.get("sources", ()))
            self.calls.append(CollectiveCall(
                name=name,
                dims={k: tuple(v.shape) for k, v in operands.items()},
                storages={k: self.rec.rec(v).storage for k, v in operands.items()},
                n_shards=self.n_shards,
                result_bytes_per_shard=_per_shard_bytes(name, result, info, self.n_shards),
                sources=sources,
                group_size=int(info.get("group_size", 0)),
                position=len(self.log.ops),
                args=(dict(operands), dict(info)),
            ))
        finally:
            self.rec.paused -= 1

    def __enter__(self) -> "Recording":
        self._prev = collectives.recorder
        collectives.recorder = self.hook
        self.rec.__enter__()
        return self

    def __exit__(self, *exc):
        self.rec.__exit__(*exc)
        collectives.recorder = self._prev
        return False


def tainted_at(log: oplog.OpLog, sources, positions) -> list[set]:
    """The tainted storages at each of ``positions`` (sorted), taint
    entering at each source's position and running forward through
    ``log``."""
    srcs = sorted(sources)
    out, tainted, si, i = [], set(), 0, 0
    for pos in positions:
        while i < pos and i < len(log.ops):
            while si < len(srcs) and srcs[si][0] <= i:
                tainted.add(srcs[si][1])
                si += 1
            op = log.ops[i]
            if any(t.storage in tainted for t in op.inputs):
                tainted.update(t.storage for t in op.outputs)
            i += 1
        while si < len(srcs) and srcs[si][0] <= pos:
            tainted.add(srcs[si][1])
            si += 1
        out.append(set(tainted))
    return out


def check_calls(calls, target: str, *, log=None, sources=()) -> list[Finding]:
    """The four invariants over one run's calls (see the module docstring)."""
    findings: list[Finding] = []
    seen: set = set()

    def emit(rule_id: str, name: str, message: str) -> None:
        if (rule_id, name, message) not in seen:
            seen.add((rule_id, name, message))
            findings.append(Finding(rule_id, f"{target}:{name}", 0, message))

    taints = (tainted_at(log, sources, [c.position for c in calls])
              if log is not None else [set()] * len(calls))
    for c, tainted in zip(calls, taints):
        S = c.n_shards
        lead = {k: v[0] for k, v in c.dims.items() if len(v)}
        if c.group_size:
            load = c.dims.get("load")
            if c.group_size != S or (load is not None and tuple(load) != (S,)):
                emit("coll-axis-name", c.name,
                     f"`{c.name}` on a group of {c.group_size} ranks with load row "
                     f"{load}, not the session's {S} shards")
        elif len(set(lead.values())) > 1:
            emit("coll-divergent-control", c.name,
                 f"`{c.name}` operands stack {lead} shards on dim 0 — every "
                 "shard must enter the collective")
        else:
            bad = {k: v for k, v in c.dims.items()
                   if not v or v[0] != S or (k == "load" and tuple(v) != (S, S))}
            if bad:
                emit("coll-axis-name", c.name,
                     f"`{c.name}` over shard dims {bad}, not the session's "
                     f"{S} shards")
        for shift, src in enumerate(c.sources):
            if sorted(src) != list(range(S)):
                emit("coll-ppermute-bijection", c.name,
                     f"ring shift {shift}'s sources {list(src)} are not a "
                     f"permutation of the {S} shards — a shard without a "
                     "source loses a neighbour's table")
        if c.name in FETCH_COLLECTIVES and any(s in tainted for s in c.storages.values()):
            emit("coll-head-gather", c.name,
                 f"head-STwig table reaches `{c.name}` — Theorem 5 requires "
                 "the head to stay on its shard (fetched head rows break "
                 "per-shard page disjointness)")
    return findings


def rank_sequence(calls) -> list[tuple[str, int]]:
    """A rank's collective calls as (name, group size), in order."""
    return [(c.name, c.group_size) for c in calls]


def check_rank_sequences(sequences, target: str) -> list[Finding]:
    """``coll-divergent-control`` across ranks: every rank's `rank_sequence`
    must be rank 0's (a rank that makes another call, or one fewer, leaves
    the others waiting in a collective)."""
    findings = []
    for r, seq in enumerate(sequences[1:], start=1):
        if seq != sequences[0]:
            i = next((k for k, (a, b) in enumerate(zip(seq, sequences[0])) if a != b),
                     min(len(seq), len(sequences[0])))
            findings.append(Finding(
                "coll-divergent-control", f"{target}:rank{r}", 0,
                f"rank {r}'s collective {i} is {seq[i:i + 1]}, rank 0's "
                f"{sequences[0][i:i + 1]} ({len(seq)} against {len(sequences[0])} calls)"))
    return findings


def check(recording: Recording, target: str) -> list[Finding]:
    return check_calls(recording.calls, target, log=recording.log,
                       sources=recording.sources)
