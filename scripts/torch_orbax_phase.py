"""Run chip_smoke.py's phase 17 (orbax checkpoint directories) alone on a CUDA card: the
device and build phases, then phase 17. Writes chiprun_out/torch_orbax_phase.json.

    python3 scripts/torch_orbax_phase.py        # from the repository root, on the card (~2 min)
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
    t1 = time.perf_counter()
    rec = cs.run_phase("17 orbax", cs.phase_orbax, dev, smi)
    out = ROOT / "chiprun_out" / "torch_orbax_phase.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rec, indent=1, default=str))
    print(f"torch_orbax_phase: set-up {t1 - t0:.1f} s, phase 17 {time.perf_counter() - t1:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
