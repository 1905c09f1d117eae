"""Checkpointing with async save, restart and elastic resharding: the
port of ``src/repro/checkpoint/checkpointer.py``.

Layout, as there: ``<dir>/step_<n:08d>/{manifest.json, <leaf-path>.npy
...}``, written under ``.tmp_step_<n:08d>/`` and renamed, so a partial
checkpoint is never visible; ``keep`` newest steps are kept. A tree is any
nesting of dicts, tuples, lists and named tuples (an
`repro_torch.optim.AdamWState` and its ``QTensor``s included) over
tensors; a leaf's path names its file (``/`` → ``__``). numpy has no
bfloat16: a bf16 leaf is stored as its 16-bit patterns (int16) with
``"bfloat16"`` in the manifest, so a restore is bit-exact.

`save` copies every leaf to the host before it returns (the caller may
then write the tensors in place, as `optim.update` does); with
``async_save`` a writer thread writes the files, and `wait` joins it
before the next save or any read (staleness of at most one checkpoint).

A tree of `DTensor` leaves (a model on a mesh) is saved whole: each leaf
is gathered to the host in full on every rank, rank 0 writes the step
(synchronously), and every rank waits for it at a barrier. So a checkpoint
written on a mesh of N ranks restores onto M: `restore` with
``shardings`` (a tree of ``(mesh, placements)`` like ``like``'s leaves)
places each leaf as the reference's ``device_put`` onto new shardings
does, every rank keeping its own chunk; without it each leaf lands whole
on one ``device``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    kids = _children(tree)
    if not kids and not isinstance(tree, (dict, tuple, list)):
        raise TypeError(f"{prefix or 'the tree'}: {type(tree).__name__} is not a tensor")
    out = []
    for name, child in kids:
        out += flatten_with_paths(child, f"{prefix}/{name}" if prefix else name)
    return out


def _rebuild(like, leaves):
    """``like``'s structure with its tensors taken from the iterator
    ``leaves`` in order."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, dict):
        return type(like)((k, _rebuild(v, leaves)) for k, v in like.items())
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    return type(like)(_rebuild(v, leaves) for v in like)


def _placements_of(shardings) -> list:
    """The ``(mesh, placements)`` pairs of a shardings tree, in the order
    `flatten_with_paths` visits a tree of the same structure."""
    if isinstance(shardings, tuple) and len(shardings) == 2 and hasattr(shardings[0], "mesh"):
        return [shardings]
    out = []
    for _, child in _children(shardings):
        out += _placements_of(child)
    return out


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


@dataclasses.dataclass
class Checkpointer:
    directory: "str | pathlib.Path"
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        self.directory = pathlib.Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> None:
        """Write ``tree`` as step ``step``; its tensors are copied to the
        host before this returns. A tree with `DTensor` leaves is gathered
        on every rank and written by rank 0 before any rank returns."""
        self.wait()
        leaves = flatten_with_paths(tree)
        sharded = any(isinstance(x, DTensor) for _, x in leaves)
        host = [(n, *_to_host(x.full_tensor() if isinstance(x, DTensor) else x))
                for n, x in leaves]

        def write():
            d = self.directory / f"step_{step:08d}"
            tmp = self.directory / f".tmp_step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": []}
            for name, arr, dtype in host:
                fn = name.replace("/", "__") + ".npy"
                np.save(tmp / fn, arr)
                manifest["leaves"].append(
                    {"name": name, "file": fn, "shape": list(arr.shape), "dtype": dtype})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if d.exists():
                shutil.rmtree(d)
            tmp.rename(d)  # atomic publish: partial checkpoints never visible
            self._gc()

        if sharded:
            if dist.get_rank() == 0:
                write()
            dist.barrier()
        elif self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.directory.glob("step_*"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        self.wait()  # join any in-flight async save first
        steps = sorted(self.directory.glob("step_*"))
        return int(steps[-1].name.split("_")[1]) if steps else None

    def restore(self, step: int, like, device=None, *, shardings=None):
        """Step ``step`` in the structure of ``like`` (a tree of tensors),
        bit for bit as saved: each leaf on ``device`` (``None``: where
        ``like``'s leaf lies), or, with ``shardings`` (a tree like
        ``like`` of ``(mesh, placements)`` pairs), a `DTensor` on that mesh
        of which this rank keeps its own chunk, on ``device`` or the mesh's
        device type."""
        self.wait()
        d = self.directory / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_name = {m["name"]: m for m in manifest["leaves"]}
        places = None if shardings is None else iter(_placements_of(shardings))
        leaves = []
        for name, t in flatten_with_paths(like):
            m = by_name[name]
            x = _from_host(np.load(d / m["file"]), m["dtype"])
            if tuple(x.shape) != tuple(t.shape):
                raise ValueError(f"{name}: the checkpoint holds {tuple(x.shape)}, "
                                 f"expected {tuple(t.shape)}")
            if places is None:
                leaves.append(x.to(t.device if device is None else device))
                continue
            mesh, pl = next(places)
            x = x.to(device if device is not None else mesh.device_type)
            leaves.append(distribute_tensor(x, mesh, pl, src_data_rank=None))
        return _rebuild(like, iter(leaves))
