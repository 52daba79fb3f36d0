"""Hand-written CUDA kernels of the port, each beside its plain version.

Every kernel package keeps the triple of the reference's Pallas kernels:
``kernel.cu`` (the CUDA C++ source, compiled with nvcc for sm_90a at first
use, see :mod:`repro_torch.kernels._build`), ``ops.py`` (the wrapper that
checks its inputs, allocates the output and launches) and ``ref.py`` (the
plain PyTorch version). A wrapper runs the plain version for tensors on
the CPU and the kernel for tensors on a CUDA device; there is no fallback
from one to the other.

``KERNEL_LAUNCHES`` counts kernel launches by name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path really went through the kernels.
"""
import collections

KERNEL_LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()
