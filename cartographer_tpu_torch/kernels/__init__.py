"""Hand-written CUDA kernels for Hopper and their ctypes bindings.

Each kernel module holds the launch wrapper, a module-level launch count
`LAUNCHES`, and the plain PyTorch version of the same function. Sources
live in `cartographer_tpu_torch/csrc/` and are built by `_build.py` at
first use; nothing is compiled when a module is imported.
"""
