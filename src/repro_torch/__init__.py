"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s module names so each counterpart is easy to
find, and it imports neither ``jax`` nor anything of ``repro``.  Its entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine without CUDA the default raises instead of falling back.  Every
Pallas kernel on the serving path has a hand-written CUDA C++ counterpart
under ``csrc/`` (built with ``nvcc`` at first use, ``kernels/_build.py``)
and a plain PyTorch version beside it, which the wrappers use only for
tensors that lie on the CPU.
"""
