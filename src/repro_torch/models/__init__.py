"""Model zoo of the port: the dense decoder-only LM for serving and
training, with its attention, flash forward and backward, chunked loss,
MLP, norms and RoPE; parameter specs of every layer kind."""
from . import (attention, common, convert, encdec, flash, mlp, moe,  # noqa: F401
               ssm, steps, transformer)
