"""Hand-written Hopper kernels of the port, one module per kernel.

Each module holds the kernel, its plain PyTorch version and its wrapper.
The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  Each wrapper counts its
launches in a plain integer attribute, ``<wrapper>.launches``.
"""
