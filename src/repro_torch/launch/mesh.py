"""Device meshes over a ``torch.distributed`` process group.

Port of ``repro/launch/mesh.py``.  A mesh is a ``DeviceMesh`` with named
dimensions (``("data", "model")``, or ``("pod", "data", "model")``) over
the ranks of the default process group, which the caller initialises
(``torchrun`` sets the environment; a test passes ``init_method=``).
Nothing here touches the process group at import.

The reference's TPU v5e constants and pod shapes have no meaning on this
hardware; :data:`H100` holds the datasheet numbers of the card the port
targets, for the roofline bounds beside a measurement.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# NVIDIA H100 80GB HBM3 (SXM), 700 W: NVIDIA's data sheet, dense rates.
# Float32 products are bounded as 3 x TF32 on the tensor cores (the port's
# kernels run them so), one third of the TF32 rate.
H100 = {
    "hbm_bytes": 80e9,                 # device memory
    "hbm_bw": 3.35e12,                 # bytes/s
    "peak_flops_f32_3xtf32": 495e12 / 3,
    "peak_flops_bf16": 989e12,
    "nvlink_bw": 450e9,                # bytes/s each way, to the other cards
}


def make_host_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"),
                   device_type: str = "cpu"):
    """A mesh of ``shape`` named ``axes`` over every rank of the default
    process group (gloo for ``cpu``, NCCL for ``cuda``).  Raises unless
    the mesh covers the world exactly."""
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, model: Optional[int] = None,
                         device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over the whole process group: the
    ``model`` axis spans the cards of one host (NVLink, all to all; the
    host's card count unless ``model`` is given), ``data`` the hosts.
    Raises when the world does not factor so."""
    world = dist.get_world_size()
    if model is None:
        model = torch.cuda.device_count() if device_type == "cuda" else 1
    if model < 1 or world % model:
        raise ValueError(f"{world} ranks do not factor into data x "
                         f"{model} (model)")
    return make_host_mesh((world // model, model), ("data", "model"),
                          device_type)


def chips(mesh) -> int:
    """The number of devices ``mesh`` spans."""
    return math.prod(mesh.shape)
