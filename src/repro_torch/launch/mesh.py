"""Production mesh construction over a DeviceMesh.

A port of the JAX package's ``launch/mesh.py``.  ``make_production_mesh``
is a FUNCTION (not a module-level constant), so importing this module
starts no process group.  Where no group is running it starts PyTorch's
``"fake"`` backend at the mesh's world size (256 or 512) with this
process as rank 0: the placeholder devices of the reference's dry run,
whose collectives return without moving data.  Tensors on such a mesh are
fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``).

Mesh shapes (the reference's TPU v5e pods):
  single-pod:  (data=16, model=16)              = 256 devices
  multi-pod:   (pod=2, data=16, model=16)       = 512 devices
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def start_fake_group(world_size: int) -> None:
    """Start the ``fake`` process group at ``world_size``, rank 0, unless a
    group of that size is running (one of another size raises)."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"running; the mesh needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def release() -> None:
    """Destroy the running process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, data: int = 16,
                         model: int = 16, device: str = "cuda"
                         ) -> DeviceMesh:
    """256 devices a pod; (data, model) split configurable for the
    mesh-shape variants (data*model must be 256).  ``device`` is the
    mesh's device type: ``cuda`` (the card's fake tensors) by default."""
    assert data * model == 256, (data, model)
    shape = (2, data, model) if multi_pod else (data, model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    start_fake_group(n)
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda"
                   ) -> DeviceMesh:
    """A (data, model) mesh over the process group that is running (fake,
    gloo or NCCL), whose world size must be data * model."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a running process group")
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> tuple:
    """Axes the batch dimension shards over."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)
