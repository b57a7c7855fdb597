"""Model zoo of the port: the dense decoder-only LM for serving, with its
attention, flash forward, MLP, norms and RoPE; parameter specs of every
layer kind."""
from . import (attention, common, convert, encdec, flash, mlp, moe,  # noqa: F401
               ssm, steps, transformer)
