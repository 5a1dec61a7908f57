"""PyTorch and CUDA port of :mod:`repro` for one NVIDIA H100.

The module tree mirrors ``src/repro`` (same module and function names);
the JAX package is the reference this port is checked against, and this
package imports nothing of it (nor JAX).  Entry points run on CUDA unless
the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
