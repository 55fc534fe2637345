"""Kernels of the port and their plain versions. Importing this package
builds nothing: CUDA sources compile at a kernel's first launch
(``kernel_build``)."""
