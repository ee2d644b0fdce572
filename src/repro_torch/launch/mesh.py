"""The port's meshes, as ``repro.launch.mesh``.

- ``make_host_mesh``: the devices this process sees, as the train and
  serve drivers bind their steps to them. Under an initialised
  ``torch.distributed`` process group of N ranks it is a torch
  ``DeviceMesh`` of shape ``(N, 1)`` over ``("data", "model")``, whose
  steps run the SPMD layer (``distributed/spmd.py``: sharded leaves,
  collectives). Without a process group it is one device's
  ``AbstractMesh`` ``(1, 1)``: the steps run the model on plain tensors,
  with no collective.
- ``make_production_mesh``: the 256-device pod ``(16, 16)`` or the
  two-pod cluster ``(2, 16, 16)`` over ``("pod", "data", "model")``, as
  an ``AbstractMesh`` with no devices and no process group: what
  ``ShardingPolicy.for_mesh`` reads to size the specs.

Left out: ``compat_make_mesh`` and ``compat_set_mesh``, shims over JAX
versions' mesh constructors; a torch ``DeviceMesh`` needs none. The
hardware constants are the H100 SXM's (NVIDIA's data sheet, dense rates,
at the card's full 700 W power limit; a card set below it runs slower).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import device as D


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names with no process group behind it
    (attribute names as ``torch.distributed.device_mesh.DeviceMesh``'s).
    ``device``: the one device of a host mesh; None for a production
    mesh, which has no devices."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    device: Optional[torch.device] = None


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(device=None):
    """The devices this process sees: a ``DeviceMesh`` ``(N, 1)`` over the
    N ranks of the initialised process group (on ``device``'s type), else
    ``device``'s ``AbstractMesh`` ``(1, 1)``. ``device=None`` is the card
    (raises when there is none), as every entry point resolves it."""
    dev = D.resolve(device)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(dev.type, (dist.get_world_size(), 1),
                                mesh_dim_names=("data", "model"))
    return AbstractMesh((1, 1), ("data", "model"), dev)


# NVIDIA H100 SXM (80 GB HBM3) constants, per card: the roofline
# denominators.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12              # B/s
ICI_BW = 450e9                # B/s one way over NVLink 4 (the data sheet's
                              # 900 GB/s counts both directions)
