"""Launchers of the port (``python -m repro_torch.launch.serve``), the
meshes of processes and the pipeline schedule over them (``mesh``,
``pipeline``), and the logical-axis rules that place a model on a mesh
(``sharding``, ``rules``)."""
from repro_torch.launch.mesh import (
    make_host_mesh,
    make_mesh,
    make_production_mesh,
    mesh_axis_names,
    mesh_axis_size,
    spawn_ranks,
)
from repro_torch.launch.pipeline import bubble_fraction, gpipe
from repro_torch.launch.rules import make_rules
from repro_torch.launch.sharding import axis_rules, logical, spec_for

__all__ = [
    "axis_rules",
    "bubble_fraction",
    "gpipe",
    "logical",
    "make_host_mesh",
    "make_mesh",
    "make_production_mesh",
    "make_rules",
    "mesh_axis_names",
    "mesh_axis_size",
    "spawn_ranks",
    "spec_for",
]
