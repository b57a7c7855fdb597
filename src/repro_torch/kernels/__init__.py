"""Hand-written CUDA kernels for Hopper, their builds and plain versions.

`semiring` holds the wrappers; `build` compiles ``csrc/`` with ``nvcc`` at
first use. Nothing is compiled or loaded when the package is imported.
"""
