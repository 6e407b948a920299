"""BMF-PP placement builders (port of ``repro.launch.mesh``).

The port has no device mesh: a PP placement is a ``core.topology.Topology``
of ``block`` device groups × ``data`` shard slots, and both builders
return one. The reference's LLM meshes (('data', 'model') and
('pod', 'data', 'model')) belong to the LLM modules that are not ported
yet.
"""
from __future__ import annotations


def make_pp_topology(block: int, data: int = 1, devices=None):
    """The placement ``run_pp(topology=...)`` takes: ``block`` groups of
    ``data`` slots each."""
    from repro_torch.core.topology import Topology
    return Topology(block=block, data=data, devices=devices)


def make_pp_mesh(block: int, data: int = 1, devices=None):
    """The reference's 2-D ('block', 'data') mesh builder; in the port the
    same ``Topology`` (its groups and slots stand in for the mesh)."""
    return make_pp_topology(block, data, devices)
