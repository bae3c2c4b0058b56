"""PyTorch/CUDA port of the GLASS serving stack (``repro``'s counterpart).

Modules mirror ``repro``'s names.  Plain tensor code is PyTorch; the TPU
kernels on the serving path are CUDA C++ for Hopper under ``csrc/``,
built at first use (``kernels/build.py``).
"""
