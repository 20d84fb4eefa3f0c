"""Production mesh factory: the counterpart of ``repro.launch.mesh``.

A mesh here is one process per card: a
``torch.distributed.device_mesh.DeviceMesh`` over the default process group,
whose world size must be the mesh's product.  A function (not a module-level
constant), so importing this module touches no process group.

Single pod : (16, 16)    ("data", "model")
Multi-pod  : (2, 16, 16) ("pod", "data", "model"); the "pod" axis is an
outer data-parallel dimension (the gradient mean crosses it once a step).

A mesh on ``cuda`` needs the NCCL backend and one on the CPU gloo: nothing
falls back from the card, and a ``cuda`` mesh with no GPU raises.  The
dry-run (``launch.dryrun``) stands one process for one rank of a whole
mesh of cards: a ``cpu`` mesh also takes a ``fake`` process group, whose
collectives send nothing.
"""

from __future__ import annotations

import math
import os

__all__ = ["make_production_mesh", "make_mesh", "production_mesh_shape"]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
# the dry-run's stand-in for a mesh of cards, on a cpu mesh only
_DRY_RUN = ("cpu", "fake")


def production_mesh_shape(multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axes) of the production mesh, or of ``REPRO_MESH_OVERRIDE``
    where it has the right rank."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    # test hook: REPRO_MESH_OVERRIDE="4x2" (single pod) / "2x2x2" (multi-pod)
    # runs the same code path on the few processes of a test or one card
    ov = os.environ.get("REPRO_MESH_OVERRIDE")
    if ov:
        dims = tuple(int(d) for d in ov.split("x"))
        if len(dims) == len(axes):
            return dims, axes
    return ((2, 16, 16) if multi_pod else (16, 16)), axes


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    return make_mesh(*production_mesh_shape(multi_pod), device=device)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device="cuda"):
    """A mesh of ``shape`` named ``axes`` over the default process group
    (which the caller initialises: NCCL for ``cuda``, gloo for ``cpu``, or
    the dry-run's ``fake`` group for ``cpu``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..convert import resolve_device

    dev = resolve_device(device)
    if dev.type not in _BACKEND:
        raise ValueError(f"no mesh on device type {dev.type!r}")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs the default process group: call "
            "torch.distributed.init_process_group first (one process per "
            "card; python -m torch.distributed.run sets RANK, WORLD_SIZE, "
            "MASTER_ADDR and MASTER_PORT)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"mesh {tuple(shape)} {tuple(axes)} needs {math.prod(shape)} "
            f"processes, the process group has {world} (REPRO_MESH_OVERRIDE "
            "sets the shape)")
    backend = dist.get_backend()
    if backend != _BACKEND[dev.type] and (dev.type, backend) != _DRY_RUN:
        raise ValueError(
            f"a {dev.type} mesh runs over {_BACKEND[dev.type]}, the process "
            f"group's backend is {backend}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))
