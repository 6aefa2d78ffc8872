"""AMS beyond the paper, on the PyTorch port: continual distillation of a
transformer student (the counterpart of examples/llm_distill.py).

A drifting token stream stands in for the live video; the student (any
model-zoo architecture, reduced size) is adapted with gradient-guided masked
Adam and its sparse deltas are streamed.

Run:  PYTHONPATH=src python examples/llm_distill_torch.py --arch rwkv6-3b --device cpu

Without ``--device`` it trains on the card.
"""
import argparse

from repro_torch.launch import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train.main(["--arch", args.arch, "--steps", str(args.steps),
                "--phase-len", "10", "--log-every", "20", "--device", args.device])


if __name__ == "__main__":
    main()
