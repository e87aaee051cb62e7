"""Mesh construction (port of `repro.launch.mesh`).

Functions, not module constants: importing this module touches no device
and no process group.  A mesh spans the ranks of the default process group,
which the caller makes first (``torch.distributed.init_process_group`` with
its address, world size and rank): NCCL on the card, gloo on the CPU.
:func:`abstract_production_mesh` needs neither: it names the production
axes and sizes (`models.sharding.AbstractMesh`), which the sharding rules
and the dry-run's memory count read; the dry-run's collective count
builds the device mesh itself, on a fake process group of its size.
Meshes are on ``cuda`` unless the caller passes ``device="cpu"``; asking for
``cuda`` with no GPU raises (`repro_torch.resolve_device`).
"""

from __future__ import annotations

import math

from repro_torch import resolve_device
from repro_torch.models.sharding import AbstractMesh


def _device_mesh(shape, axes, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group: call torch.distributed.init_process_group "
            f"({'nccl' if dev.type == 'cuda' else 'gloo'}) with {math.prod(shape)} ranks first"
        )
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process group "
                         f"has {world}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def _production_axes(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, device=None):
    return _device_mesh(*_production_axes(multi_pod), device)


def abstract_production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axes and sizes with no devices and no process
    group (JAX's ``make_production_mesh`` as an ``AbstractMesh``)."""
    return AbstractMesh(*_production_axes(multi_pod))


def make_mesh(dp: int, tp: int, pods: int = 1, *, device=None):
    """Arbitrary mesh for experiments / elastic remesh."""
    if pods > 1:
        return _device_mesh((pods, dp, tp), ("pod", "data", "model"), device)
    return _device_mesh((dp, tp), ("data", "model"), device)


def mesh_num_devices(mesh) -> int:
    return mesh.size()
