"""repro_torch: the EvalNet equal-cost sweep on PyTorch and hand-written
CUDA kernels for Hopper.

Module paths mirror the JAX package ``repro`` so each module's counterpart
is easy to find. Entry points run on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
