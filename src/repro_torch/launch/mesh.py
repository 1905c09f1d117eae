"""Meshes of processes: the port of ``src/repro/launch/mesh.py``.

The JAX package builds its meshes from the devices of one program (on the
CPU, host devices forced by ``XLA_FLAGS``). Here a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of a process
group, one process a shard:

  * `spawn_ranks` starts ``n`` processes with the ``spawn`` start method,
    joins them in a gloo group on ``127.0.0.1`` and runs one function in
    each — PyTorch's counterpart of the forced host devices, used by the
    tests and by the smoke run;
  * `make_host_mesh` is the 1-D mesh over that world (device type
    ``"cpu"``: its groups are gloo, whatever device the ranks' tensors are
    on);
  * `make_production_mesh` is the reference's (16, 16) / (2, 16, 16) mesh,
    when the world has that many ranks;
  * `make_mesh` is any named mesh over the world, for model sharding (its
    device type the card's, see there).

Functions only, never module-level meshes: importing this module touches
no process group.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from collections.abc import Mapping

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_host_mesh", "make_mesh", "make_production_mesh", "mesh_axis_names",
           "mesh_axis_size", "spawn_ranks"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` with ``multi_pod``, over a world of that
    many ranks. Raises, naming the shape, in any other world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != _prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {_prod(shape)} ranks; "
            f"this world has {n}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh(shape: Mapping, device_type: str = "cuda") -> DeviceMesh:
    """A mesh ``{axis name: size}`` over the initialized world (its size
    the product of ``shape``'s), for model sharding. On the one-card
    machine every rank shares ``cuda:0`` in a gloo world: the mesh's device
    type is ``"cuda"``, so DTensors keep their shards on the card (a
    ``"cpu"`` mesh moves them to the host), and the functional all-gather
    that gloo refuses on CUDA tensors is staged through pinned host memory
    (`core.rank_collectives.stage_functional_collectives`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (spawn_ranks)")
    if device_type == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.core.rank_collectives import stage_functional_collectives

        stage_functional_collectives()
    return init_device_mesh(device_type, tuple(shape.values()), mesh_dim_names=tuple(shape))


def make_host_mesh(n: int | None = None, axis: str = "data") -> DeviceMesh:
    """The 1-D mesh, dim named ``axis``, over the ``n`` ranks of the
    initialized world (``None``: all of them). Its device type is
    ``"cpu"``, so its group is gloo: on the one-card machine every rank's
    tensors share ``cuda:0``, and NCCL takes no two ranks on one device."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process group (spawn_ranks)")
    world = dist.get_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a host mesh of {n} ranks in a world of {world}: make the world {n}")
    return init_device_mesh("cpu", (n,), mesh_dim_names=(axis,))


def mesh_axis_names(mesh) -> tuple:
    """The axis names of ``mesh``: a `DeviceMesh`'s dim names, or the keys
    of a ``{name: size}`` mapping (the reference's ``mesh.shape``)."""
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_size(mesh, names) -> int:
    """The product of the sizes of ``names`` (one name or several) among
    the mesh's dims; a name the mesh lacks counts 1. ``mesh`` is a
    `DeviceMesh` or a ``{name: size}`` mapping."""
    if isinstance(names, str):
        names = (names,)
    sizes = (dict(mesh) if isinstance(mesh, Mapping)
             else dict(zip(mesh_axis_names(mesh), mesh.mesh.shape)))
    out = 1
    for name in names:
        out *= sizes.get(name, 1)
    return out


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, port: int, results, args) -> None:
    try:
        # a rank on the CPU must not spread its ops over every core: n ranks
        # share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n, rank=rank
        )
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:
        # the parent raises it, naming the rank; this process exits with it
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n: int, *args, timeout: float | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``n`` new processes (start method
    ``spawn``), joined in a gloo group on ``127.0.0.1`` at a free port, and
    return each rank's result in rank order. ``fn`` and ``args`` must be
    picklable, and so must the results.

    A rank whose ``fn`` raises makes the call raise `RuntimeError` naming
    that rank, with its traceback; the other ranks are then terminated (they
    may be waiting in a collective for it), as they are when a rank's
    process dies without a result or ``timeout`` seconds pass."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, port, results, args), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    error = None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(out) < n and error is None:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None and results.empty()]
                if dead:
                    error = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                             "without a result")
                elif deadline is not None and time.monotonic() > deadline:
                    error = f"ranks {sorted(set(range(n)) - set(out))} gave no result in {timeout} s"
                continue
            if ok:
                out[rank] = payload
            else:
                error = f"rank {rank} raised:\n{payload}"
    finally:
        if error is None:
            for p in procs:
                p.join()
        else:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        results.close()
    if error is not None:
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, {n}): {error}")
    return [out[r] for r in range(n)]
