"""Quickstart: the AMS core in 60 lines, on the PyTorch/CUDA port.

A toy regression "student" adapts online to a drifting target function via
Algorithm 2 (gradient-guided masked Adam) while streaming only 5% of its
parameters per phase. Runs on the card by default:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import selection
from repro_torch.core.delta import apply_delta, encode_delta, full_model_bytes
from repro_torch.core.masked_adam import init_state, masked_adam_update
from repro_torch.device import resolve_device


def model(params, x):  # tiny MLP
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def target(x, t):  # drifting ground truth (the "video")
    return torch.sin(3 * x + 0.8 * t) + 0.3 * torch.cos(7 * x - t)


def loss_and_grad(p, x, y):
    grads, loss = torch.func.grad_and_value(
        lambda q: torch.mean((model(q, x) - y) ** 2))(p)
    return loss, grads


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    params = {
        "w1": put(rng.normal(size=(1, 64)) * 0.5), "b1": put(np.zeros(64)),
        "w2": put(rng.normal(size=(64, 1)) * 0.5), "b2": put(np.zeros(1)),
    }
    edge_params = tree.tree_map(lambda x: x, params)  # client copy
    opt = init_state(params)
    gamma, k_iters = 0.05, 20

    u_prev, total_bytes = None, 0
    for phase in range(30):
        t = phase * 0.5
        # select I_n from the previous phase's Adam updates (Alg. 2 line 1)
        if u_prev is None:
            mask = selection.random_mask(torch.Generator().manual_seed(phase),
                                         params, gamma)
        else:
            mask = selection.gradient_guided_mask(u_prev, gamma)
        for _ in range(k_iters):  # K masked-Adam iterations on the recent horizon
            x = put(rng.uniform(-1, 1, size=(64, 1)))
            y = target(x, t)
            loss, g = loss_and_grad(params, x, y)
            params, opt, u_prev = masked_adam_update(params, g, opt, mask, lr=3e-3)
        # stream the sparse delta to the edge
        delta = encode_delta(params, mask)
        edge_params = apply_delta(edge_params, delta)
        total_bytes += delta.total_bytes
        if phase % 5 == 0:
            xs = torch.linspace(-1, 1, 256, device=dev)[:, None]
            edge_err = float(torch.mean((model(edge_params, xs) - target(xs, t)) ** 2))
            print(f"phase {phase:2d}  t={t:4.1f}  loss={float(loss):.4f} "
                  f"edge_mse={edge_err:.4f}  delta={delta.total_bytes}B")

    full = full_model_bytes(params)
    print(f"\nstreamed {total_bytes} bytes over 30 phases; "
          f"full-model streaming would be {30 * full} bytes "
          f"({30 * full / total_bytes:.1f}x more)")


if __name__ == "__main__":
    main()
