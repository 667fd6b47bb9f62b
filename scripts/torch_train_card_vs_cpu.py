#!/usr/bin/env python3
"""The training step's card-against-CPU comparison (chip_smoke.py::train_card_vs_cpu) under
three cuDNN settings, each of which takes the card along a trajectory of its own:

    python3 scripts/torch_train_card_vs_cpu.py

For cuDNN on (the default), cuDNN off and cuDNN with benchmark on, it runs the fp32 B=4
R1 iteration (32) and the PL iteration (36, pl 2) on the card and on the CPU, and prints
whether the comparison passed, the raydrop decisions each fake took the other way, and
the error of D's output on each fake. Needs one CUDA card; about two minutes.
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py
    for enabled, benchmark in ((True, False), (False, False), (True, True)):
        torch.backends.cudnn.enabled, torch.backends.cudnn.benchmark = enabled, benchmark
        for kw in ({}, {"it": 36, "pl": 2, "label": "cli-pl"}):
            try:
                r = chip_smoke.train_card_vs_cpu(dev, **kw)
                print("PASS", enabled, benchmark, kw, r["raydrop_flips"], r["y_fake_err_per_sample"], flush=True)
            except AssertionError as e:
                print("FAIL", enabled, benchmark, kw, repr(e)[:600], flush=True)


if __name__ == "__main__":
    main()
