"""The op log: what the port's passes read where the JAX passes read a jaxpr.

PyTorch has no jaxpr: a function is only known by running it. `record`
runs one under `OpRecorder`, a ``TorchDispatchMode`` that logs every aten
op it dispatches — the op, the shapes, dtypes and devices of its tensors,
and the storage each tensor lives in — and `RecordingKernels` adds one
pseudo-op ``kernels.<op>`` for every `Kernels` op call, reading its tensor
arguments and writing its results. A hand-written CUDA kernel is launched
through ``ctypes`` with raw pointers, out of the dispatcher's sight, so the
pseudo-op is what tells the log which storages it read and wrote; its
operations are counted from the plain version (`costmodel`).

On a mesh the recorder sees what each rank runs: an op on `DTensor`s is
let through (``NotImplemented``) to DTensor's dispatch, whose local ops —
at the rank's local shapes — and the functional collectives of its
redistributions come back to the recorder; a collective's record carries
the size of its group (``group_size``). The ops DTensor's sharding
propagation runs on fake tensors of the global shapes (under a
``FakeTensorMode``) are not logged: no rank runs them.

Storage identity: the recorder keeps every tensor it saw alive until the
log is dropped, so no storage is freed and reused under another tensor
while the log is read. A storage's lifetime in the log runs from the first
op that touches it to the last.
"""
from __future__ import annotations

import dataclasses
import threading
import traceback
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.backend import Kernels

# the ops that wait for the device's values on the host: a read of one
# scalar (``.item()``, ``bool(t)``, ``.tolist()``), and an output whose size
# depends on the data (a boolean index goes through ``nonzero``); a copy to
# the CPU is the third kind (`OpRecorder.note`). On the CPU they cost
# nothing, but each is a sync on the card
SYNC_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.item.default",
    "aten.nonzero.default", "aten.masked_select.default",
})

_ACTIVE = threading.local()


@dataclasses.dataclass(frozen=True)
class TensorRec:
    """One tensor as an op saw it."""

    storage: int        # identity of its storage (alive for the log's life)
    nbytes: int         # bytes of that storage
    shape: tuple
    dtype: str          # "float32", "int32", "bool", ...
    device: str         # "cpu", "cuda", "meta"

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


@dataclasses.dataclass
class OpRecord:
    name: str                   # "aten.mm.default", "kernels.cin_layer"
    inputs: tuple               # TensorRec of every tensor argument
    outputs: tuple              # TensorRec of every tensor result
    source: str = ""            # file:line of the port's code that called it
    sync: bool = False          # a device → host transfer
    flops: float | None = None  # set for a pseudo-op (its plain version's)
    within: str = ""            # the `Kernels` op it ran inside, if any
    group_size: int = 0         # a functional collective's group size


@dataclasses.dataclass
class OpLog:
    """The ops one call dispatched, with the call's own tensor inputs and
    outputs (``args`` and ``results``)."""

    ops: list = dataclasses.field(default_factory=list)
    args: tuple = ()
    results: tuple = ()
    keep: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def n_syncs(self) -> int:
        return sum(1 for o in self.ops if o.sync)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def tensors_in(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor reachable from ``obj`` through tuples (named tuples
    too: the engines' tables, graphs and bindings), lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from tensors_in(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from tensors_in(x)


def _caller() -> str:
    """file:line of the innermost frame of the port outside this package."""
    for fr in reversed(traceback.extract_stack()):
        f = fr.filename.replace("\\", "/")
        if "/repro_torch/" in f and "/analysis/" not in f:
            return f"{f[f.rindex('/repro_torch/') + 1:]}:{fr.lineno}"
    return ""


class OpRecorder(TorchDispatchMode):
    """Logs every aten op dispatched while it is active (see the module
    docstring); a sync also notes the line of the port's code that made it.
    While ``paused`` is above 0 nothing is logged."""

    def __init__(self):
        super().__init__()
        self.log = OpLog()
        self.paused = 0
        self.within: list[str] = []

    def rec(self, t: torch.Tensor) -> TensorRec:
        self.log.keep.append(t)
        st = t.untyped_storage()
        return TensorRec(
            storage=st._cdata, nbytes=int(st.nbytes()), shape=tuple(t.shape),
            dtype=_dtype_name(t.dtype), device=t.device.type,
        )

    def note(self, name: str, inputs, outputs, *, flops=None, group_size: int = 0) -> None:
        ins = tuple(self.rec(t) for t in tensors_in(inputs))
        outs = tuple(self.rec(t) for t in tensors_in(outputs))
        sync = name in SYNC_OPS or (
            name.startswith("aten._to_copy") or name.startswith("aten.copy_")
        ) and any(i.device == "cuda" for i in ins) and any(o.device == "cpu" for o in outs)
        self.log.ops.append(OpRecord(
            name, ins, outs, _caller() if sync else "", sync, flops,
            self.within[-1] if self.within else "", group_size,
        ))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor's local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs each new op once on fake
        # tensors of the global shapes: no rank runs those
        fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
        if not self.paused and not fake:
            flat_in, _ = tree_flatten((args, kwargs))
            flat_out, _ = tree_flatten(out)
            group = 0
            if func.namespace == "_c10d_functional":
                names = [a for a in flat_in if isinstance(a, str)]
                if names:
                    group = dist.distributed_c10d._resolve_process_group(names[-1]).size()
            self.note(str(func), [t for t in flat_in if isinstance(t, torch.Tensor)],
                      [t for t in flat_out if isinstance(t, torch.Tensor)], group_size=group)
        return out

    def __enter__(self):
        stack = getattr(_ACTIVE, "stack", None)
        if stack is None:
            stack = _ACTIVE.stack = []
        stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.stack.pop()
        return super().__exit__(*exc)


def active() -> OpRecorder | None:
    """The innermost active recorder of this thread, if any."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def record(fn: Callable, *args, **kwargs) -> tuple[Any, OpLog]:
    """Run ``fn(*args, **kwargs)`` under a fresh `OpRecorder`: its result
    and its op log."""
    rec = OpRecorder()
    rec.log.args = tuple(rec.rec(t) for t in tensors_in((args, kwargs)))
    with rec:
        out = fn(*args, **kwargs)
    rec.log.results = tuple(rec.rec(t) for t in tensors_in(out))
    return out, rec.log


class RecordingKernels(Kernels):
    """A `Kernels` backend's ops, each call logged as one ``kernels.<op>``
    pseudo-op in the active recorder (see the module docstring); the ops it
    dispatches itself are marked as within it. It keeps the wrapped
    backend's ``name``, so the engine's cache keys are the ones the backend
    gives. ``flops_of(op, args, kwargs)`` prices a call (None: its own aten
    ops carry the count)."""

    def __init__(self, inner: Kernels, flops_of: Callable | None = None):
        self._inner = inner
        self.name = inner.name
        self._flops_of = flops_of
        for op in dir(inner):
            if not op.startswith("_") and callable(getattr(inner, op)):
                setattr(self, op, self._logged(op, getattr(inner, op)))

    def _logged(self, op: str, fn: Callable) -> Callable:
        def call(*args, **kwargs):
            rec = active()
            if rec is None:
                return fn(*args, **kwargs)
            flops = None
            if self._flops_of is not None:
                rec.paused += 1
                try:
                    flops = self._flops_of(op, args, kwargs)
                finally:
                    rec.paused -= 1
            rec.within.append(op)
            try:
                out = fn(*args, **kwargs)
            finally:
                rec.within.pop()
            rec.note(f"kernels.{op}", (args, kwargs), out, flops=flops)
            return out

        return call
