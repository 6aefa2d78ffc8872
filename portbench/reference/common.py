"""Plain pieces the references share: the precision every product is
computed in, the norms, the tanh GELU and the weight table format.

A reference computes in float32 with TF32 off. Its control computes the
same function with every matrix product's operands rounded to float8
e4m3 (one scale per tensor, its largest magnitude to 448), the step
below the bfloat16 that the configurations state: the benchmark's
comparison has to tell the two apart.
"""
from __future__ import annotations

import contextlib
import math

import torch

F32 = torch.float32
FP8_MAX = 448.0  # largest finite float8_e4m3fn


class Precision:
    """``cast`` rounds a float32 operand of a product to the precision
    named: ``float32`` leaves it, ``fp8`` rounds it to float8 e4m3 under
    one scale for the tensor and back."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(F32)
        if self.name == "float32":
            return x
        amax = x.abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cast(a) @ self.cast(b)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_norm(x, w, eps: float = 1e-5):
    """LayerNorm without bias, its scale stored as an offset: (1 + w)."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + w.to(F32))


def rms_norm(x, w, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.to(F32))


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def leaf(shape, std: float, mean: float = 0.0) -> dict:
    """One entry of a weight table: drawn as ``mean + std * N(0, 1)``."""
    return {"shape": tuple(int(s) for s in shape), "std": float(std), "mean": float(mean)}


def fan_in(shape, contraction: int) -> dict:
    """A matrix drawn at N(0, 1 / contraction): the inputs it sums over."""
    return leaf(shape, 1.0 / math.sqrt(contraction))


def stacked(table: dict, n: int) -> dict:
    """Every leaf of ``table`` with a leading axis of ``n`` layers."""
    return {k: stacked(v, n) if "shape" not in v else dict(v, shape=(n, *v["shape"]))
            for k, v in table.items()}
