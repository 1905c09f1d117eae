"""Launchers of the port (``python -m repro_torch.launch.serve``), and the
meshes of processes and the pipeline schedule over them (``mesh``,
``pipeline``)."""
from repro_torch.launch.mesh import (
    make_host_mesh,
    make_production_mesh,
    mesh_axis_size,
    spawn_ranks,
)
from repro_torch.launch.pipeline import bubble_fraction, gpipe

__all__ = [
    "bubble_fraction",
    "gpipe",
    "make_host_mesh",
    "make_production_mesh",
    "mesh_axis_size",
    "spawn_ranks",
]
