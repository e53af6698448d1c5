#!/usr/bin/env python3
"""The largest storages live at a dry-run cell's peak, and where the port
made them.

    python3 tools/peak_holders.py --arch xlstm-1.3b --shape train_4k
        [--mesh single|multi] [--microbatches 1] [--top 10] [--smoke]
        [--device-type cuda|cpu] [--out FILE]

Traces one step of the cell (``launch.dryrun.lower_cell``) on the
production mesh of fake ranks, as the dry run does, with the recorder
keeping each storage's provenance (``roofline.trace.StepRecorder``,
``holders=True``), and prints rank 0's peak, its argument bytes, and the
``--top`` storages live at the peak: bytes, shape, dtype and the port's
innermost frames that made each (``argument`` for a step argument; for a
storage made in the backward, ``[backward <node>]`` and the frames of the
forward op that node differentiates). A
dimension at its global size where the reference's layout shards it is a
rank computing more than its share. ``--smoke`` takes the arch's smoke
config and a (2, 4) mesh, to try the tool on the CPU in seconds
(``--device-type cpu``: this CPU-only torch cannot run a fake CUDA step).
``--out`` also writes the record as JSON. Runs from the repository root.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def holders_record(arch, shape, mesh_kind="single", microbatches=1, top=10, smoke=False,
                   device_type="cuda"):
    """The cell's peak, arguments and ``top`` holders at the peak, a dict."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SHAPES, get_config, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, production_ranks
    from repro_torch.launch.shardings import plan_for
    from repro_torch.roofline.trace import fake_world

    multi = mesh_kind == "multi"
    cfg = smoke_config(arch) if smoke else get_config(arch)
    shp = SHAPES[shape]
    if smoke:
        shp = ShapeConfig(shp.name, 64, 8, shp.kind)
    with fake_world(8 if smoke else production_ranks(multi_pod=multi)):
        mesh = (make_host_mesh(2, 4, device_type=device_type) if smoke
                else make_production_mesh(multi_pod=multi, device_type=device_type))
        plan = plan_for(cfg, mesh)
        tr = dryrun.lower_cell(cfg, shp, mesh, plan, microbatches=microbatches, holders=True)
    return {"cell": f"{arch}/{shape}/{mesh_kind}", "smoke": smoke,
            "microbatches": microbatches, "peak_bytes": tr.peak_bytes,
            "argument_bytes": tr.argument_bytes, "local_fallbacks": tr.local_fallbacks,
            "step_s": tr.step_s,
            "holders": [dataclasses.asdict(h) for h in tr.peak_holders[:top]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device-type", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    rec = holders_record(args.arch, args.shape, args.mesh, args.microbatches, args.top,
                         args.smoke, args.device_type)
    mib = 2 ** 20
    print(f"{rec['cell']} microbatches {rec['microbatches']}: peak "
          f"{rec['peak_bytes'] / mib:.1f} MiB a rank, arguments "
          f"{rec['argument_bytes'] / mib:.1f} MiB, local_shards fallbacks "
          f"{rec['local_fallbacks']}, traced in {rec['step_s']:.1f} s")
    for h in rec["holders"]:
        made = " < ".join(h["frames"][:4])
        if h["backward"]:
            made = f"[backward {h['backward']}] {made}"
        print(f"{h['nbytes'] / mib:10.1f} MiB  {str(tuple(h['shape'])):28s} {h['dtype']:9s} "
              + made)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"peak_holders": {k: v for k, v in rec.items() if k != "holders"}}))


if __name__ == "__main__":
    main()
