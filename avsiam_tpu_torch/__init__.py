"""AVSiam on PyTorch and CUDA: the port of ``avsiam_tpu`` to an NVIDIA H100.

The JAX package ``avsiam_tpu`` is the reference; this package mirrors its
module layout and names so that each counterpart is easy to find. Plain
tensor code is PyTorch; the Pallas TPU kernels on the pretrain path are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` on first
use (``kernels/``). Nothing here imports JAX or the JAX package.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version.
"""
