"""chip_smoke.py's sharded phase alone, on every card of the host.

    python3 scripts/sharded_cards.py

Builds the kernels, then runs `chip_smoke.sharded_phase` from the
checkout's ``chip_smoke.py``: three fleets of 4 pool slots x 2 width-4.0
sessions through 3 rounds, per-group fused, sharded over no device and
sharded over ``GPUPool(n_gpus=4, device_backend="torch")``'s cards, held
equal bit for bit, with the serial and sharded dispatch windows printed.
On a host with four cards the four slots are four distinct cards and the
sharded window must beat the serial one; on one card all four are
``cuda:0``. Prints every card's name and power limit first. Needs at least
one card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("sharded_cards: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    print(smi.strip())
    print(f"{torch.cuda.device_count()} cards; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"build: {build.build_all():.2f} s")
    chip_smoke.sharded_phase(torch.device("cuda", 0))
    print(f"sharded_cards: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
