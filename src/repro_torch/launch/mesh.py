"""Peak rates of the card the port runs on (one NVIDIA H100 SXM), and the
meshes the sharded dry run counts over.

Twin of ``repro/launch/mesh.py``, whose constants are a TPU v5e's (per
chip) for its XLA roofline. The port's roofline (``launch/roofline.py``),
its dry run (``launch/dryrun.py``) and ``chip_smoke.py``'s kernel bounds
read these, so one module holds the peaks. Each is NVIDIA's data sheet
figure for the SXM part, dense (no sparsity), at the full 700 W power
limit; a card set below it runs slower (``nvidia-smi``'s ``power.limit``).

The meshes are the reference's: ``make_production_mesh`` (16×16 on
("data", "model"), or 2×16×16 on ("pod", "data", "model")) and
``make_test_mesh``. A mesh here is a COUNTING mesh: a ``DeviceMesh`` over a
process group of torch's ``fake`` backend, whose world size is the mesh's
size and whose collectives send nothing. The tensors placed on it live on
the ``meta`` device, so nothing is allocated either, and this process
plays rank 0: ``launch/op_cost.count_cost`` counts what that one device
holds, computes and receives. A process group is process-global and its
world size is fixed when it is made, so each function returns a context
manager that makes the group on entry and destroys it on exit
(``torch.distributed.is_initialized()`` is False again after):

    with make_production_mesh() as mesh:          # a DeviceMesh
        ...

``CountingMesh((1, 1), ..., device_type="cuda")`` is a mesh over the card
instead, its group a real one of world size 1 over an in-process store
(no network), for running the kernels on DTensors (``chip_smoke.py``'s
``[mesh]`` phase). The vocab-sharded heads keep their ``n_shards`` / ``devices``
(``heads/sharded.py::shard_devices``): one process drives every shard.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

# bf16 and fp16 on the tensor cores, dense
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
# float32 outside the tensor cores: the port's float32 products through
# PyTorch run here, TF32 being off for cuBLAS and cuDNN
# (``repro_torch.device.resolve_device``)
PEAK_FLOPS_F32 = 67e12            # FLOP/s
# TF32 on the tensor cores, dense. Only the SSD backward kernel
# (``csrc/ssd_bwd.cu``) runs here, in split TF32: three TF32 products for
# each float32 one, so its float32 work is bounded by 3 x flops / this
PEAK_FLOPS_TF32 = 495e12          # FLOP/s
# HBM3, 80 GB
HBM_BW = 3.35e12                  # bytes/s
HBM_BYTES = 80e9                  # bytes of device memory
# NVLink 4: 900 GB/s to the other cards of the host, 450 GB/s each way
NVLINK_BW = 450e9                 # bytes/s, one direction


# -- meshes ---------------------------------------------------------------------


class CountingMesh:
    """A context manager over a ``DeviceMesh`` of ``shape`` named
    ``axis_names``: entering makes the process group ("fake", world size
    the mesh's size, this process rank 0; for ``device_type`` "cuda" a
    world-size-1 "nccl" group over an in-process store) and the mesh, and
    returns the mesh; leaving destroys the group."""

    def __init__(self, shape, axis_names, device_type: str = "cpu"):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device_type = device_type
        self.mesh = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if dist.is_initialized():
            raise RuntimeError("a process group exists already: a counting "
                               "mesh makes its own and cannot share one")
        if self.device_type == "cpu":
            # registers the "fake" backend
            from torch.testing._internal.distributed.fake_pg import FakeStore
            backend, store = "fake", FakeStore()
        elif self.size == 1:
            backend, store = "nccl", dist.HashStore()
        else:
            raise ValueError(f"a {self.device_type} mesh holds one device "
                             f"here, not {self.size}")
        dist.init_process_group(backend, store=store, rank=0,
                                world_size=self.size)
        try:
            self.mesh = DeviceMesh(
                self.device_type, torch.arange(self.size).reshape(self.shape),
                mesh_dim_names=self.axis_names)
        except BaseException:
            dist.destroy_process_group()
            raise
        return self.mesh

    def __exit__(self, *exc):
        import torch.distributed as dist
        self.mesh = None
        if dist.is_initialized():
            dist.destroy_process_group()
        return False


def make_production_mesh(*, multi_pod: bool = False) -> CountingMesh:
    """The reference's production mesh: 16×16 on ("data", "model"), or
    2×16×16 on ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return CountingMesh(shape, axes)


def make_test_mesh(model: Optional[int] = None, *,
                   data: int = 1) -> CountingMesh:
    """A small ("data", "model") mesh of ``data * model`` devices, as the
    reference's over its local devices. ``model=None`` takes every local
    device not claimed by ``data``: the visible CUDA devices, or one where
    there are none."""
    if model is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        model = max(n // data, 1)
    return CountingMesh((data, model), ("data", "model"))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``CountingMesh``."""
    if isinstance(mesh, CountingMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes used for batch/data parallelism (pod folds into data)."""
    return tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))


def mesh_name(mesh) -> str:
    """"16x16", "2x16x16": the reference's ``mesh`` field of a record."""
    return "x".join(str(s) for s in mesh_axis_sizes(mesh).values())
