"""Hand-written CUDA kernels for Hopper, their builds and plain versions.

`ops` is the library surface (the eleven ops of the JAX package's
``kernels.ops``, each casting its operands and dispatching on their
device); `semiring` and `seghist` hold the kernels' wrappers with their
plain versions beside them, and `ref` gathers those plain versions under
the JAX package's names; `build` compiles ``csrc/`` with ``nvcc`` at first
use. Nothing is compiled or loaded when the package is imported.
"""
