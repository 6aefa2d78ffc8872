"""Plain PyTorch version of the gradient-norm kernel: the JAX trainer's
global norm (`src/repro/launch/train.py`), ``sqrt(sum over buffers of
sum(g.float()**2))`` in float32. The CPU path runs it, and the card's
kernel is held against it and against a float64 norm."""
from __future__ import annotations

import torch


def grad_norm_ref(bufs) -> torch.Tensor:
    """The float32 global L2 norm of the gradient buffers ``bufs``, a
    0-dimensional tensor: each buffer's sum of squares in float32, added
    in buffer order."""
    return torch.sqrt(sum(torch.sum(torch.square(b.to(torch.float32))) for b in bufs))
