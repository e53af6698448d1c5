#!/usr/bin/env python3
"""The port's dry run over the (arch x shape) grid, one process a cell,
several at once: which cells run on the production mesh of fake ranks,
which raise, and which do not finish in the time given.

    python3 tools/dryrun_census.py [--cells ARCH/SHAPE ...] [--mesh single]
        [--roofline] [--jobs N] [--timeout S] [--deadline S] [--out DIR]

Each cell (default: every cell of ``configs.arch_shape_cells()``) runs as
``python -m repro_torch.launch.dryrun --arch A --shape S --mesh M
--no-roofline --out DIR/cells/A__S__M.json`` (the full-depth step and its
microbatch escalation, no roofline points); with ``--roofline``, without
``--no-roofline``, so the cell also runs its 1x / 2x pattern points and
the record holds its roofline terms (``bottleneck``, ``t_compute_s``,
``t_memory_s``, ``t_collective_s`` at ``launch/mesh.py``'s H100 rates,
``PEAK_FLOPS_BF16``), its ``useful_flops_ratio`` and the points' seconds;
a cell stopped in its points keeps its full-depth numbers. At most
``--jobs`` at once, each
stopped with its process group after ``--timeout`` seconds, or when
the whole census has run ``--deadline`` seconds (so that it ends, and
writes its record, inside a time limit of its own; the cells not started
by then are listed as ``not_started``). Fake tensors
lie on the card's device type, as the dry run's default: run it on the
card's machine (this CPU-only torch cannot run a fake CUDA step).

Writes ``DIR/census.json``: per cell ``ok`` / ``error`` / ``timeout``, its
wall seconds, and for a cell that ran its microbatches, peak, argument and
output bytes per rank (on the single mesh also the reference's
one-microbatch peak a device, ``launch.dryrun.REFERENCE_PEAK_GIB``, and the
port's one-microbatch peak over it, ``peak_over_reference``), the times ``local_shards`` fell back to running
whole on ``DTensor``s (``local_fallbacks``, 0 where every rank computes
its share) and traced-step seconds; for one that raised, the
error's last line; for one stopped at ``--timeout``, the phase it was in:
the innermost lines of the port on its stack (``faulthandler``'s dump,
asked for with SIGUSR1 just before the kill, in the cell's log). Prints
one JSON line a cell and a summary line. Runs from the repository root.
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the dry run's command line, with faulthandler dumping the stack on SIGUSR1
_LAUNCH = ("import faulthandler, runpy, signal; faulthandler.register(signal.SIGUSR1); "
           "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')")
_FRAME = re.compile(r'File "[^"]*/src/repro_torch/([^"]+)", line (\d+) in (\S+)')


def _phase(log: str, depth: int = 4) -> str:
    """The innermost ``depth`` frames of the port in the last stack dump of
    ``log`` (faulthandler lists the innermost first), the recorder's own
    (``roofline/trace.py``) left out; or "no stack"."""
    dump = log.rsplit("most recent call first", 1)
    if len(dump) < 2:
        return "no stack"
    frames = [f"{f}:{n} {fn}" for f, n, fn in _FRAME.findall(dump[1])
              if f != "roofline/trace.py"]
    return " < ".join(frames[:depth]) or "no frame of the port"


def _cells(args):
    if args.cells:
        return [tuple(c.split("/")) for c in args.cells]
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import arch_shape_cells

    return arch_shape_cells()


ROOFLINE_KEYS = ("bottleneck", "t_compute_s", "t_memory_s", "t_collective_s",
                 "useful_flops_ratio", "flops_per_chip", "bytes_per_chip",
                 "coll_bytes_per_chip", "points_s")


def _gate(got):
    """The full-depth step's numbers of a cell's record."""
    mem = got["memory"]
    return dict(plan=got["plan"], microbatches=got["microbatches"],
                microbatch_trail=got["microbatch_trail"],
                peak_per_device=mem["approx_peak_per_device"],
                argument_bytes_per_device=mem["argument_bytes_per_device"],
                output_bytes_per_device=mem["output_bytes_per_device"],
                output_leaves=mem.get("output_leaves"),
                fits_hbm=mem["fits_hbm"], local_fallbacks=mem.get("local_fallbacks"),
                lower_s=got["lower_s"], compile_s=got["compile_s"])


def _against_reference(arch, shape, trail):
    """The reference's one-microbatch peak of a single-mesh cell (the
    port's table, ``launch.dryrun.REFERENCE_PEAK_GIB``) and the port's
    one-microbatch peak over it."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import reference_peak_bytes

    ref = reference_peak_bytes(arch, shape)
    one = trail[0]["peak_per_device"] if trail else None
    return {"reference_peak_per_device": ref,
            "peak_over_reference": None if ref is None or one is None else one / ref}


def _summary(arch, shape, mesh, path, rc, wall, timed_out, log, stopped_by="timeout"):
    rec = {"cell": f"{arch}/{shape}/{mesh}", "wall_s": round(wall, 1)}
    key = f"{arch}/{shape}/{mesh}"
    try:
        got = json.loads(path.read_text()).get(key) if path.exists() else None
    except json.JSONDecodeError:        # killed while it wrote
        got = None
    if timed_out:
        rec = dict(rec, status="timeout", stopped_by=stopped_by, phase=_phase(log))
        if got is not None and got.get("stage") == "gate":
            rec.update(_gate(got), stopped_in="roofline points", gate_wall_s=got["wall_s"])
        return rec
    if got is None or "error" in got:
        err = (got or {}).get("error") or (log.strip().splitlines() or ["no output"])[-1]
        return dict(rec, status="error", rc=rc, error=err[-400:])
    rec = dict(rec, status="ok", **_gate(got))
    if mesh == "single":
        rec.update(_against_reference(arch, shape, rec["microbatch_trail"]))
    if "roofline" in got:
        rec["roofline"] = {k: got["roofline"].get(k) for k in ROOFLINE_KEYS}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="*", default=None, help="ARCH/SHAPE entries")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--roofline", action="store_true",
                    help="run each cell's 1x / 2x roofline points too")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds for the whole census (default: none)")
    ap.add_argument("--out", type=Path, default=Path("build/census"))
    args = ap.parse_args()
    (args.out / "cells").mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    todo = list(_cells(args))
    running, results = [], []
    t_all = time.time()

    def write(final):
        counts = {s: sum(r["status"] == s for r in results)
                  for s in ("ok", "error", "timeout", "not_started")}
        summary = {"cells": len(results), **counts, "jobs": args.jobs,
                   "roofline": args.roofline,
                   "timeout_s": args.timeout, "deadline_s": args.deadline,
                   "wall_s": round(time.time() - t_all, 1), "finished": final}
        (args.out / "census.json").write_text(json.dumps({"summary": summary,
                                                          "cells": results}, indent=1))
        return summary

    while todo or running:
        late = args.deadline is not None and time.time() - t_all > args.deadline
        if late:
            results.extend({"cell": f"{a}/{s}/{args.mesh}", "status": "not_started"}
                           for a, s in todo)
            todo = []
        while todo and len(running) < args.jobs:
            arch, shape = todo.pop(0)
            path = args.out / "cells" / f"{arch}__{shape}__{args.mesh}.json"
            path.unlink(missing_ok=True)
            log = open(path.with_suffix(".log"), "w+")
            proc = subprocess.Popen(
                [sys.executable, "-c", _LAUNCH, "--arch", arch, "--shape", shape,
                 "--mesh", args.mesh, *([] if args.roofline else ["--no-roofline"]),
                 "--out", str(path)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
            running.append((arch, shape, path, proc, log, time.time()))
        time.sleep(1.0)
        for item in list(running):
            arch, shape, path, proc, log, t0 = item
            wall = time.time() - t0
            timed_out = proc.poll() is None and (wall > args.timeout or late)
            if timed_out:
                os.kill(proc.pid, signal.SIGUSR1)
                time.sleep(5.0)         # time for faulthandler to dump every thread
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            if proc.poll() is None:
                continue
            running.remove(item)
            log.seek(0)
            rec = _summary(arch, shape, args.mesh, path, proc.returncode, wall, timed_out,
                           log.read(), "timeout" if wall > args.timeout else "deadline")
            log.close()
            results.append(rec)
            write(False)
            print(json.dumps({"census_cell": rec}), flush=True)
    print(json.dumps({"census": write(True)}))


if __name__ == "__main__":
    main()
