#!/usr/bin/env python3
"""What a torch.profiler window keeps of the device's work, on one GPU.

    python3 tools/profiler_windows.py [--reps 6] [--out DIR]

Times ``torch.matmul`` at two shapes of the port (the dense projection,
4096 x 1024 x 192, and the stride-4 conv windows of four 1080p frames,
515 404 x 64 x 16) three ways, ``reps`` times each, in one process:

- a bare window (warm-up, then the profiler around 30 calls): the GEMM
  events it kept of 30, and the device ms per call summed over all its
  device events;
- a host range (a pre-roll of one-element fills, then a
  ``record_function`` range around the 30 calls): the GEMM events whose
  device start falls inside the host range, and the skew between the
  device-side copy of that range (where the profiler puts the first
  kernel launched inside it) and its host start: a negative skew is a
  kernel that started before its launch on the profiler's clocks;
- ``chip_smoke._device_ms``, the marked window (pre-roll, then a mark on
  the device's clock), with and without the GEMM's name.

Prints one JSON line per window and a summary line. Runs from the
repository root; needs one CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"dense": (4096, 1024, 192), "conv_s4": (515404, 64, 16)}
N = 30


def _windows(fn, name):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(N):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    bare = {"gemm_events": sum(1 for e in dev if "gemm" in e.name),
            "ms_all_events": sum(e.time_range.elapsed_us() for e in dev) / 1e3 / N}

    pad = torch.empty(1, device="cuda")
    mark = "profiler_windows.range"
    with profile(activities=acts) as prof:
        for _ in range(32):
            pad.zero_()
        torch.cuda.synchronize()
        time.sleep(1e-3)
        with record_function(mark):
            for _ in range(N):
                fn()
            torch.cuda.synchronize()
    evs = prof.events()
    host = [e.time_range for e in evs if e.name == mark and e.device_type != DeviceType.CUDA][0]
    on_dev = [e.time_range for e in evs if e.name == mark and e.device_type == DeviceType.CUDA]
    inside = [e for e in evs if e.device_type == DeviceType.CUDA and e.name != mark
              and host.start <= e.time_range.start <= host.end]
    ranged = {"gemm_events": sum(1 for e in inside if "gemm" in e.name),
              "ms_all_events": sum(e.time_range.elapsed_us() for e in inside) / 1e3 / N,
              "skew_us": on_dev[0].start - host.start if on_dev else None}

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    marked = {"ms_all_events": chip_smoke._device_ms(fn),
              "ms_gemm": chip_smoke._device_ms(fn, kernel="gemm"),
              "fills_lost": chip_smoke.PREROLL_LOST[-2:]}
    return {"shape": name, "bare": bare, "host_range": ranged, "marked": marked}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--out", type=Path, default=None, help="directory for the JSON lines")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profiler_windows: no CUDA device")
    g = torch.Generator().manual_seed(0)
    ops = {name: (torch.rand(r, k, generator=g).cuda(), torch.rand(k, m, generator=g).cuda())
           for name, (r, k, m) in SHAPES.items()}
    rows = []
    for rep in range(args.reps):
        for name, (a, b) in ops.items():
            row = {"rep": rep, **_windows(lambda a=a, b=b: torch.matmul(a, b), name)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for name in SHAPES:
        rs = [r for r in rows if r["shape"] == name]
        skews = [r["host_range"]["skew_us"] for r in rs if r["host_range"]["skew_us"] is not None]
        summary[name] = {
            "windows": len(rs),
            "bare_short": sum(r["bare"]["gemm_events"] < N for r in rs),
            "host_range_short": sum(r["host_range"]["gemm_events"] < N for r in rs),
            "min_skew_us": min(skews, default=None),
            "host_range_ms": [min(r["host_range"]["ms_all_events"] for r in rs),
                              max(r["host_range"]["ms_all_events"] for r in rs)],
            "marked_ms": [min(r["marked"]["ms_all_events"] for r in rs),
                          max(r["marked"]["ms_all_events"] for r in rs)]}
    summary["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"summary": summary}))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "profiler_windows.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows + [{"summary": summary}]))


if __name__ == "__main__":
    main()
