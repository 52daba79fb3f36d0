"""Sizey on PyTorch and CUDA: the port of the JAX package ``repro``.

The package mirrors ``repro``'s layout and imports neither JAX nor
``repro``. Entry points (``SizeyPredictor``, ``SizeyMethod``,
``ProvenanceDB``) run on a CUDA device unless the caller passes
``device="cpu"``; tensors on the CPU take the plain PyTorch version of
each kernel, tensors on the GPU the hand-written CUDA kernel.

Numerics are fp32 throughout, with TF32 off for matrix products and
convolutions (set here, once, on import).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
