"""MobileNetV2-style separable-conv segmentation student (PyTorch).

The same network as the JAX package's student: inverted residual blocks,
a lite ASPP head and a bilinear upsample, scaled by ``width``. Width 1.0
has 24,661 parameters with 5 classes, width 4.0 has 334,405.

Parameters stay a plain dict in the JAX package's HWIO layout and key
names, so flatten order, and with it the wire order of a delta, is the
same in both packages. The forward pass converts to NCHW/OIHW inside.
Numerics that differ from PyTorch's habits, kept as the JAX package has
them:

* ``padding="SAME"`` pads the TF way: a total of
  ``max((ceil(H/s)-1)*s + k - H, 0)``, the smaller half first. At stride
  2 an even size pads (0, 1), an odd size (1, 1), so the padding is
  computed from the input size, never ``padding=1``.
* the folded norm uses the population variance over (batch, H, W) of one
  session's batch; the ASPP context branch normalises a (batch, C, 1, 1)
  tensor over the batch only.
* ReLU6's gradient at x = 0 and x = 6 is 0.5, as ``jnp.clip``'s
  (``torch.clamp``'s is 1, ``F.relu6``'s 0). At batch 1 the context
  branch normalises to exactly 0, so its output is its bias, zero at
  init: it sits on the kink.
* the bilinear upsample of the logits is two products with fixed
  interpolation-weight matrices, one per spatial axis (`linear_resize`),
  the weights ``jax.image.resize`` builds for a linear resize. Forward
  and backward are then matrix products in a fixed order, so the
  student's gradients are the same bits every run on the card, where
  ``F.interpolate``'s CUDA backward accumulates with atomics.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import (  # noqa: F401  (params_from_numpy)
    ParamMeta,
    init_params,
    param_count,
    params_from_numpy,
)


@dataclass(frozen=True)
class SegConfig:
    name: str = "seg-student"
    in_channels: int = 3
    n_classes: int = 5
    width: float = 1.0
    # (expansion, out_ch, stride) per inverted-residual block
    blocks: tuple = ((3, 24, 2), (3, 24, 1), (3, 32, 2), (3, 32, 1))
    stem: int = 16
    head: int = 64

    def ch(self, c: int) -> int:
        return max(8, int(round(c * self.width)))


def _conv_meta(kh, kw, cin, cout):
    return ParamMeta((kh, kw, cin, cout), ("unsharded", "unsharded", "embed", "ff"))


def _dw_meta(kh, kw, c):
    return ParamMeta((kh, kw, 1, c), ("unsharded", "unsharded", "unsharded", "ff"))


def _bn_meta(c):  # folded scale/offset pair
    return {"scale": ParamMeta((c,), ("unsharded",), init="zeros"),
            "bias": ParamMeta((c,), ("unsharded",), init="zeros")}


def seg_metas(cfg: SegConfig) -> dict:
    m: dict = {}
    c_in = cfg.in_channels
    stem = cfg.ch(cfg.stem)
    m["stem"] = {"w": _conv_meta(3, 3, c_in, stem), "bn": _bn_meta(stem)}
    c_prev = stem
    blocks = {}
    for i, (exp, out, stride) in enumerate(cfg.blocks):
        hidden, c_out = c_prev * exp, cfg.ch(out)
        blocks[f"b{i}"] = {
            "expand": {"w": _conv_meta(1, 1, c_prev, hidden), "bn": _bn_meta(hidden)},
            "dw": {"w": _dw_meta(3, 3, hidden), "bn": _bn_meta(hidden)},
            "project": {"w": _conv_meta(1, 1, hidden, c_out), "bn": _bn_meta(c_out)},
        }
        c_prev = c_out
    m["blocks"] = blocks
    head = cfg.ch(cfg.head)
    m["aspp"] = {
        "local": {"w": _conv_meta(1, 1, c_prev, head), "bn": _bn_meta(head)},
        "ctx": {"w": _conv_meta(1, 1, c_prev, head), "bn": _bn_meta(head)},
    }
    m["classifier"] = {"w": _conv_meta(1, 1, head, cfg.n_classes),
                       "b": ParamMeta((cfg.n_classes,), ("unsharded",), init="zeros")}
    return m


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w_hwio, stride=1, groups=1):
    """NCHW conv with an HWIO weight and TF ``SAME`` padding."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    top, bottom = _same_pad(x.shape[-2], kh, stride)
    left, right = _same_pad(x.shape[-1], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride,
                    groups=groups)


class _ReLU6(torch.autograd.Function):
    """``clamp(x, 0, 6)`` with gradient 0.5 at x = 0 and x = 6: the mean
    of the strict (open interval) and the inclusive (closed interval)
    masks, each one fused ``hardtanh_backward``. The closed interval's
    bounds are the dtype's neighbours of 0 and 6 below and above."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.clamp(x, 0.0, 6.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        fi = torch.finfo(x.dtype)
        below0, above6 = -fi.tiny * fi.eps, 6.0 + 4.0 * fi.eps  # next values
        strict = torch.ops.aten.hardtanh_backward(g, x, 0.0, 6.0)
        closed = torch.ops.aten.hardtanh_backward(g, x, below0, above6)
        return torch.lerp(strict, closed, 0.5)


def _resize_weights_f64(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` float64 weights of a linear resize along one
    axis, as ``jax.image.resize(..., "linear")`` computes them: half-pixel
    centres, the triangle kernel (widened by the scale when shrinking, its
    antialias), each output's weights normalised to sum 1, and outputs
    whose centre falls outside the input zeroed."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(n_in)[:, None])
                   / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T.copy()


_RESIZE_WEIGHTS: dict = {}


def _resize_weights(n_in: int, n_out: int, dtype, device):
    """`_resize_weights_f64` in ``dtype`` on ``device``, made once per
    key: a phase's CUDA graph captures its first use after the eager
    warm-up has made it, so no capture copies from the host."""
    key = (n_in, n_out, dtype, device)
    w = _RESIZE_WEIGHTS.get(key)
    if w is None:
        w = _RESIZE_WEIGHTS[key] = torch.from_numpy(
            _resize_weights_f64(n_in, n_out)).to(device=device, dtype=dtype)
    return w


def linear_resize(x, size: tuple[int, int]):
    """Bilinear resize of the last two axes of ``x`` (..., h, w) to
    ``size``: ``W_h @ x @ W_w^T`` with the weight matrices of
    `_resize_weights_f64`, the counterpart of ``jax.image.resize(...,
    "bilinear")``. Deterministic on the card, forward and backward."""
    (h, w), (H, W) = x.shape[-2:], size
    wh = _resize_weights(h, H, x.dtype, x.device)
    ww = _resize_weights(w, W, x.dtype, x.device)
    return torch.matmul(torch.matmul(wh, x), ww.T)


def _bn_act(x, bn, act=True):
    # folded-norm affine (no running stats: online setting, tiny batches)
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + 1e-5)
    x = x * (1.0 + bn["scale"].view(1, -1, 1, 1)) + bn["bias"].view(1, -1, 1, 1)
    return _ReLU6.apply(x) if act else x


def seg_forward(cfg: SegConfig, params: dict, img):
    """img: (B,H,W,3) float -> logits (B,H,W,n_classes)."""
    x = img.permute(0, 3, 1, 2)
    H, W = x.shape[-2:]
    x = _bn_act(_conv(x, params["stem"]["w"], stride=2), params["stem"]["bn"])
    for i, (exp, out, stride) in enumerate(cfg.blocks):
        p = params["blocks"][f"b{i}"]
        h = _bn_act(_conv(x, p["expand"]["w"]), p["expand"]["bn"])
        h = _bn_act(_conv(h, p["dw"]["w"], stride=stride, groups=h.shape[1]), p["dw"]["bn"])
        h = _bn_act(_conv(h, p["project"]["w"]), p["project"]["bn"], act=False)
        x = x + h if (stride == 1 and h.shape == x.shape) else h
    # lite-ASPP head: local 1x1 + global context
    loc = _bn_act(_conv(x, params["aspp"]["local"]["w"]), params["aspp"]["local"]["bn"])
    ctx = x.mean(dim=(2, 3), keepdim=True)
    ctx = _bn_act(_conv(ctx, params["aspp"]["ctx"]["w"]), params["aspp"]["ctx"]["bn"])
    h = loc + ctx
    logits = _conv(h, params["classifier"]["w"]) + params["classifier"]["b"].view(1, -1, 1, 1)
    return linear_resize(logits, (H, W)).permute(0, 2, 3, 1)


def seg_loss(cfg: SegConfig, params: dict, img, labels):
    """Pixel cross-entropy distillation loss against teacher hard labels."""
    logits = seg_forward(cfg, params, img).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (lse - lab).mean()


def seg_predict(cfg: SegConfig, params: dict, img):
    return torch.argmax(seg_forward(cfg, params, img), dim=-1)


def make_student(cfg: SegConfig, seed: int = 0, device="cuda") -> dict:
    """Fan-in-normal init drawn from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return init_params(seg_metas(cfg), gen, torch.float32, dev)


def seg_param_count(cfg: SegConfig) -> int:
    return param_count(seg_metas(cfg))
