"""Production and test meshes over ``torch.distributed``'s ``DeviceMesh``.

The reference's ``repro/launch/mesh.py`` on torch. ``make_production_mesh``
is a function, not a module-level constant, so importing this module
touches no process group; every rank calls it after
``torch.distributed.init_process_group`` (nothing on the machine tells a
program of a cluster: the launcher gives the group its address, world
size and rank).

The reference also ships ``TPU_PERF_FLAGS``, XLA flags for the TPU's
latency-hiding scheduler and async collective fusion. They have no
meaning for PyTorch on a GPU and have no counterpart here.
"""
from __future__ import annotations

# NVIDIA H100 SXM roofline constants, per card (NVIDIA H100 Tensor Core
# GPU data sheet, SXM part, dense rates without sparsity, at the 700 W
# power limit), in place of the reference's TPU v5e figures
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12               # B/s, HBM3
NVLINK_BW = 450e9              # B/s each way (900 GB/s NVLink 4, all to all)
HBM_PER_CHIP_GB = 80.0
# The port's sizers do not default to this constant: SizeyJobSizer and
# KVCacheSizer cap an allocation at the device's own memory
# (launch.sizing.device_cap_gb, 80 GB on an H100). The reference caps at
# its v5e's 16 GB (repro/launch/mesh.py:30); with cap_gb=16.0 the port
# makes every decision the reference makes.

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod", over
    a world of 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *, pod: int = 0,
                   device_type: str = "cuda"):
    """A small ("data", "model") mesh, or ("pod", "data", "model") with
    ``pod`` > 0, over a world of that many ranks (gloo processes on a CPU:
    ``device_type="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if pod:
        return init_device_mesh(device_type, (pod, n_data, n_model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
