"""Hand-written CUDA kernels for Hopper, their builds and plain versions.

`ops` is the library surface (the eleven ops of the JAX package's
``kernels.ops``, each casting its operands and dispatching on their
device); `semiring` and `seghist` hold the kernels' wrappers with their
plain versions beside them, and `ref` gathers those plain versions under
the JAX package's names; `build` compiles ``csrc/`` with ``nvcc`` at first
use. The extension point, :class:`Semiring` with
:func:`semiring_matmul` / :func:`semiring_matmul_batched`, is exported
here: a spec with device code runs on the card through a kernel generated
from it. Nothing is compiled or loaded when the package is imported.
"""
from .semiring import (BOOLEAN, COUNTING, TROPICAL, TROPICAL_COUNT, Semiring,
                       semiring_matmul, semiring_matmul_batched)

__all__ = ["Semiring", "TROPICAL", "BOOLEAN", "COUNTING", "TROPICAL_COUNT",
           "semiring_matmul", "semiring_matmul_batched"]
