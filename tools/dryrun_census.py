#!/usr/bin/env python3
"""The port's dry run over the (arch x shape) grid, one process a cell,
several at once: which cells run on the production mesh of fake ranks,
which raise, and which do not finish in the time given.

    python3 tools/dryrun_census.py [--cells ARCH/SHAPE ...] [--mesh single]
        [--jobs N] [--timeout S] [--out DIR]

Each cell (default: every cell of ``configs.arch_shape_cells()``) runs as
``python -m repro_torch.launch.dryrun --arch A --shape S --mesh M
--no-roofline --out DIR/cells/A__S__M.json`` (the full-depth step and its
microbatch escalation, no roofline points), at most ``--jobs`` at once, each
stopped with its process group after ``--timeout`` seconds. Fake tensors
lie on the card's device type, as the dry run's default: run it on the
card's machine (this CPU-only torch cannot run a fake CUDA step).

Writes ``DIR/census.json``: per cell ``ok`` / ``error`` / ``timeout``, its
wall seconds, and for a cell that ran its microbatches, peak, argument and
output bytes per rank and traced-step seconds; for one that raised, the
error's last line. Prints one JSON line a cell and a summary line. Runs
from the repository root.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cells(args):
    if args.cells:
        return [tuple(c.split("/")) for c in args.cells]
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import arch_shape_cells

    return arch_shape_cells()


def _summary(arch, shape, mesh, path, rc, wall, timed_out, log):
    rec = {"cell": f"{arch}/{shape}/{mesh}", "wall_s": round(wall, 1)}
    if timed_out:
        return dict(rec, status="timeout")
    key = f"{arch}/{shape}/{mesh}"
    got = json.loads(path.read_text()).get(key) if path.exists() else None
    if got is None or "error" in got:
        err = (got or {}).get("error") or (log.strip().splitlines() or ["no output"])[-1]
        return dict(rec, status="error", rc=rc, error=err[-400:])
    mem = got["memory"]
    return dict(rec, status="ok", plan=got["plan"], microbatches=got["microbatches"],
                microbatch_trail=got["microbatch_trail"],
                peak_per_device=mem["approx_peak_per_device"],
                argument_bytes_per_device=mem["argument_bytes_per_device"],
                output_bytes_per_device=mem["output_bytes_per_device"],
                fits_hbm=mem["fits_hbm"], lower_s=got["lower_s"], compile_s=got["compile_s"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="*", default=None, help="ARCH/SHAPE entries")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", type=Path, default=Path("build/census"))
    args = ap.parse_args()
    (args.out / "cells").mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    todo = list(_cells(args))
    running, results = [], []
    t_all = time.time()
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, shape = todo.pop(0)
            path = args.out / "cells" / f"{arch}__{shape}__{args.mesh}.json"
            path.unlink(missing_ok=True)
            log = open(path.with_suffix(".log"), "w+")
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", args.mesh, "--no-roofline", "--out", str(path)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
            running.append((arch, shape, path, proc, log, time.time()))
        time.sleep(1.0)
        for item in list(running):
            arch, shape, path, proc, log, t0 = item
            wall = time.time() - t0
            timed_out = proc.poll() is None and wall > args.timeout
            if timed_out:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            if proc.poll() is None:
                continue
            running.remove(item)
            log.seek(0)
            rec = _summary(arch, shape, args.mesh, path, proc.returncode, wall, timed_out,
                           log.read())
            log.close()
            results.append(rec)
            print(json.dumps({"census_cell": rec}), flush=True)
    counts = {s: sum(r["status"] == s for r in results) for s in ("ok", "error", "timeout")}
    summary = {"cells": len(results), **counts, "jobs": args.jobs, "timeout_s": args.timeout,
               "wall_s": round(time.time() - t_all, 1)}
    (args.out / "census.json").write_text(json.dumps({"summary": summary, "cells": results},
                                                      indent=1))
    print(json.dumps({"census": summary}))


if __name__ == "__main__":
    main()
