"""PyTorch/CUDA port of ``sky_embeddings_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports neither
JAX nor ``sky_embeddings_tpu``: framework-free modules are copied here.
Every Pallas kernel on a ported path has a hand-written Hopper kernel under
``ops/kernels/`` with a plain PyTorch version beside it; the plain version
runs only for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; when
CUDA is missing they raise (``utils.device.resolve_device``).
"""
