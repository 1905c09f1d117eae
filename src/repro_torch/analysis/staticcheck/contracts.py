"""Op contract checker (staticcheck pass a), over op logs.

Runs every `Kernels` op of every registered backend on the example inputs
of its `OpContract` (``repro_torch.core.backend``), on the given device,
under the op recorder (`oplog`), and holds the call to:

  * ``out-dtype``        — its outputs have the declared dtypes; an op that
                           raises is a finding too;
  * ``dtype-width``      — no float64 or complex128 tensor anywhere in its
                           log, and no 64-bit integer among its outputs;
                           where torch itself makes an op's output int64
                           (`INT64_BY_TORCH`), the exemption names that
                           aten op;
  * ``banned-primitive`` — no device-to-host sync or copy inside the op
                           (`oplog.SYNC_OPS`, copies to the CPU); on the
                           card, ``torch.cuda.set_sync_debug_mode("error")``
                           turns any sync the log cannot see into an error.
                           `mask_to_host` is exempt by name: the transfer
                           is its contract (`HOST_OPS`).

The JAX package traces abstractly; here each op runs once at its example's
size, so the pass costs milliseconds an op. New ops are checked once their
backend's contract tuple names them (`register_backend`).
"""
from __future__ import annotations

import contextlib
from typing import Iterable

import numpy as np
import torch

from repro_torch.analysis.staticcheck import oplog
from repro_torch.analysis.staticcheck.costmodel import base_name
from repro_torch.analysis.staticcheck.findings import Finding, rule
from repro_torch.core import backend as backend_lib

rule("out-dtype", "kernels",
     "op output dtype differs from its declared OpContract (or the op raises)")
rule("dtype-width", "kernels",
     "float64/complex128 in a hot-path op log, or a 64-bit integer among its "
     "outputs")
rule("banned-primitive", "kernels",
     "device-to-host sync or copy inside a hot-path op")

WIDE_DTYPES = ("float64", "complex128")
# aten ops whose int64 output torch itself demands: an index it returns
INT64_BY_TORCH = {
    "searchsorted": "torch.searchsorted returns int64 unless out_int32=True",
    "sort": "torch.sort's indices are int64",
    "topk": "torch.topk's indices are int64",
    "argmax": "torch.argmax returns int64",
    "argmin": "torch.argmin returns int64",
    "nonzero": "torch.nonzero returns int64",
}
# `Kernels` ops whose contract is a transfer to the host
HOST_OPS = {"mask_to_host": "the transfer to the host is its contract"}
_HOST_EXAMPLES = {
    "mask_to_host": lambda dev: ((torch.zeros(100, dtype=torch.bool, device=dev),), {}),
}


def _producers(log) -> dict:
    """storage → the name of the last op that wrote it."""
    out = {}
    for op in log.ops:
        for t in op.outputs:
            out[t.storage] = op.name
    return out


def check_log(log, target: str, *, host_ok: bool = False) -> list[Finding]:
    """The ``dtype-width`` and ``banned-primitive`` rules over one log."""
    findings: list[Finding] = []
    seen: set = set()
    for op in log.ops:
        for t in op.inputs + op.outputs:
            if t.dtype in WIDE_DTYPES and (t.dtype, op.name) not in seen:
                seen.add((t.dtype, op.name))
                findings.append(Finding(
                    "dtype-width", target, 0,
                    f"{t.dtype} value at `{op.name}` — ids stay int32 and "
                    "values float32 or narrower; make the narrow dtype "
                    "explicit at the producer",
                ))
        if op.sync and not (host_ok or op.within in HOST_OPS) and op.name not in seen:
            seen.add(op.name)
            where = f" ({op.source})" if op.source else ""
            findings.append(Finding(
                "banned-primitive", target, 0,
                f"`{op.name}`{where} waits for the device inside a hot-path "
                "op — host syncs and transfers stall the device pipeline",
            ))
    made_by = _producers(log)
    for t in log.results:
        if t.dtype != "int64":
            continue
        producer = made_by.get(t.storage, "")
        if base_name(producer) in INT64_BY_TORCH:
            continue
        findings.append(Finding(
            "dtype-width", target, 0,
            f"int64 output of shape {list(t.shape)}"
            + (f" from `{producer}`" if producer else "")
            + " — ids stay int32 (linear-space discipline)",
        ))
    return findings


@contextlib.contextmanager
def no_sync(device: torch.device):
    """On the card, any sync inside raises (``set_sync_debug_mode``)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _dtypes(out) -> tuple:
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(getattr(o, "dtype", type(o)) for o in outs)


def check_op(kern, contract, device, target: str) -> list[Finding]:
    """One contract on one backend: run it, then the three rules."""
    args, kw = contract.make_args(device)
    try:
        with no_sync(device):
            out, log = oplog.record(getattr(kern, contract.op), *args, **kw)
    except Exception as e:  # an op that raises IS a contract violation
        rule_id = "banned-primitive" if "synchroniz" in str(e) else "out-dtype"
        return [Finding(rule_id, target, 0,
                        f"op raised on its example: {type(e).__name__}: {e}")]
    findings = []
    if _dtypes(out) != tuple(contract.out_dtypes):
        findings.append(Finding(
            "out-dtype", target, 0,
            f"output dtypes {_dtypes(out)} != declared {tuple(contract.out_dtypes)}",
        ))
    return findings + check_log(log, target)


def check_host_op(kern, op: str, device, target: str) -> list[Finding]:
    """A `HOST_OPS` op: a host array of its input's length and dtype, and
    no rule but the one its contract waives."""
    args, kw = _HOST_EXAMPLES[op](device)
    try:
        out, log = oplog.record(getattr(kern, op), *args, **kw)
    except Exception as e:
        return [Finding("out-dtype", target, 0,
                        f"op raised on its example: {type(e).__name__}: {e}")]
    findings = []
    want = (args[0].shape[0],)
    if not isinstance(out, np.ndarray) or out.dtype != np.bool_ or out.shape != want:
        findings.append(Finding(
            "out-dtype", target, 0,
            f"expected a host bool array of shape {want}, got {type(out).__name__} "
            f"{getattr(out, 'dtype', '')} {getattr(out, 'shape', '')}",
        ))
    return findings + check_log(log, target, host_ok=True)


def check_kernel_contracts(
    backends: Iterable[str] | None = None, device=None,
) -> list[Finding]:
    """Run every contract-declared op (and every host op) on every named
    backend (default: all registered) on ``device`` (``None``: the card;
    it raises without one)."""
    dev = backend_lib.resolve_device(device)
    findings: list[Finding] = []
    names = tuple(backends) if backends else backend_lib.available_backends()
    for name in names:
        kern = backend_lib.get_kernels(name)
        for contract in backend_lib.op_contracts(name):
            findings.extend(check_op(kern, contract, dev, f"kernels:{name}:{contract.op}"))
        for op in HOST_OPS:
            findings.extend(check_host_op(kern, op, dev, f"kernels:{name}:{op}"))
    return findings
