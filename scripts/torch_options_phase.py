"""Run chip_smoke.py's phase 16 (the options) alone on a CUDA card: the device and build
phases, phase 12's dusty_v1 bare steps for the bare rate phase 16 compares the CLI with,
then phase 16. Writes chiprun_out/torch_options_phase.json.

    python3 scripts/torch_options_phase.py        # from the repository root, on the card (~3 min)
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    t0 = time.perf_counter()
    smi = cs.run_phase("device", cs.phase_device)
    dev = torch.device("cuda:0")
    cs.run_phase("build", cs.phase_build)
    tr, st, bare = cs.run_phase("12 other archs: bare steps", cs.other_bare_steps, "dusty_v1", dev)
    del tr, st
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rec = cs.run_phase("16 options", cs.phase_options, dev, smi, bare["rates"]["imgs_per_s"])
    out = ROOT / "chiprun_out" / "torch_options_phase.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rec, indent=1, default=str))
    print(f"torch_options_phase: set-up {t1 - t0:.1f} s, phase 16 {time.perf_counter() - t1:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
