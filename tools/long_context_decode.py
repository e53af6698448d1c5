#!/usr/bin/env python3
"""smollm-135m's decode over long bf16 and int8 KV caches, on one GPU, for
the port in a given source tree.

    python3 tools/long_context_decode.py [--src DIR] [--label NAME] [--out DIR]

Runs ``chip_smoke.long_context_phase`` (batch 8; caches of 8192 prefilled
and 32 768 seeded positions; decode ms per step, peak memory above the
resident state, bytes allocated per step; decode == forward) against the
``repro_torch`` package under ``--src`` (default: this checkout's
``src``). Pointing ``--src`` at the ``src`` of an unpacked earlier commit
measures that commit's cache contraction with the same script; run the
trees in turns (A, B, B, A), one process each, to see the spread. The
phase runs with ``hold_storage=False``: decode == forward is held, the
allocation bound and the hold of ``attention._contract_cache`` (which an
earlier tree may lack) are not.

Prints one JSON line: the label, the tree, the card's name and power limit
(nvidia-smi) and the phase's report; with ``--out DIR`` also writes it to
``DIR/long_context_<label>.json``. Runs from the repository root.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch package to measure")
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("long_context_decode: needs a CUDA device")
    import chip_smoke
    import repro_torch

    out = {}
    chip_smoke.long_context_phase(torch.device("cuda"), out, hold_storage=False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    line = {"label": args.label, "package": str(Path(repro_torch.__file__).parent),
            "device": smi, "j3": out}
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"long_context_{args.label}.json").write_text(json.dumps(line, indent=1))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
