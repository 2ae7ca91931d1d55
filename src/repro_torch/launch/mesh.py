"""Device meshes, ported from ``repro.launch.mesh`` onto
``torch.distributed``'s ``DeviceMesh``.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"); the
"pod" axis carries only batch (data) parallelism, so no tensor
collective crosses it.

A mesh spans the current process group, which the caller starts
(``torch.distributed.init_process_group``): NCCL ranks on cards, gloo
ranks on CPUs, or the fake group of ``launch.dryrun``, which stands in
for 256 or 512 ranks in one process.  Nothing here runs at import.

``batch_axes``, ``model_axis_size`` and ``batch_axis_size`` read a
mesh's axis names and sizes through ``axis_sizes``, which takes a
``DeviceMesh`` or a shape-only stub with ``.shape`` (a dict of axis
sizes) and ``.axis_names``, the reference's ``FakeMesh``: specs can be
worked out without a process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.runtime import resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over the current process group: on the cards
    unless the caller passes ``"cpu"`` (the dry run's fake group of 256
    or 512 ranks does); raises when the group is smaller than the mesh,
    as the reference does, and without a card, as every entry point of
    the port."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, have {have} — launch via "
            f"launch/dryrun.py, which starts a fake group of {need} ranks")
    resolve_device(device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(*, data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the current process group: on the card
    unless the caller passes ``"cpu"`` (the gloo tests do); raises
    without a card, as every entry point of the port."""
    resolve_device(device_type)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a stub with
    ``.shape`` (a dict) and ``.axis_names``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def batch_axis_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))
