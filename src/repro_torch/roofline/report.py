"""Render the dry run's tables from ``results/dryrun_torch.json``
(the reference's ``repro.roofline.report`` on the port's records).

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch.json

The port's records keep the reference's keys but for the capacity: the
fit is against one H100's 80 GiB (``memory["fits_hbm"]``), not 16 GiB, and
the roofline's times are the H100's (``roofline.analysis``).
"""

from __future__ import annotations

import json
import sys

from repro_torch.launch.mesh import HBM_BYTES

_CAP = f"{HBM_BYTES // 2**30}GiB"


def fmt_table(results: dict, mesh: str = "single") -> str:
    rows = []
    hdr = ("| cell | mb | peak/dev GiB | fits | t_compute s | t_memory s | "
           "t_collective s | bottleneck | MODEL/HLO flops | t_mem floor s |")
    sep = "|" + "---|" * 10
    rows.append(hdr)
    rows.append(sep)
    for k in sorted(results):
        if not k.endswith("/" + mesh):
            continue
        v = results[k]
        if "error" in v:
            rows.append(f"| {k[: -len(mesh) - 1]} | ERROR | | | | | | | | |")
            continue
        m = v["memory"]
        rl = v.get("roofline", {})
        rows.append(
            f"| {k[: -len(mesh) - 1]} | {v.get('microbatches', '-')} "
            f"| {m['approx_peak_per_device'] / 2**30:.2f} "
            f"| {'Y' if m['fits_hbm'] else 'N'} "
            f"| {rl.get('t_compute_s', float('nan')):.4f} "
            f"| {rl.get('t_memory_s', float('nan')):.3f} "
            f"| {rl.get('t_collective_s', float('nan')):.4f} "
            f"| {rl.get('bottleneck', '-')} "
            f"| {rl.get('useful_flops_ratio', float('nan')):.3f} "
            f"| {v.get('t_memory_floor_s', float('nan')):.4f} |"
        )
    return "\n".join(rows)


def fmt_dryrun_table(results: dict) -> str:
    rows = [f"| cell | mesh | compile s | peak/dev GiB | fits {_CAP} | collectives (counts) |",
            "|---|---|---|---|---|---|"]
    for k in sorted(results):
        v = results[k]
        if "error" in v:
            rows.append(f"| {k} | ERROR | | | | |")
            continue
        m = v["memory"]
        coll = ", ".join(f"{kk}:{vv}" for kk, vv in sorted(v["full_collectives"].items()))
        arch_shape, mesh = k.rsplit("/", 1)
        rows.append(
            f"| {arch_shape} | {mesh} | {v['compile_s']} "
            f"| {m['approx_peak_per_device'] / 2**30:.2f} "
            f"| {'Y' if m['fits_hbm'] else 'N'} | {coll} |"
        )
    return "\n".join(rows)


def roofline_fraction(cell: dict, use_floor: bool = False) -> float | None:
    """MODEL_FLOPS time / binding-term time: the share of the card's bf16
    peak the step's useful math reaches if the step runs at its roofline
    bound. ``use_floor`` takes the argument-traffic floor for the memory
    term in place of the fusion-blind byte count."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16

    rl = cell.get("roofline")
    if not rl:
        return None
    t_model = rl["model_flops_per_chip"] / PEAK_FLOPS_BF16
    t_mem = cell.get("t_memory_floor_s", 0.0) if use_floor else rl["t_memory_s"]
    t_bound = max(rl["t_compute_s"], t_mem, rl["t_collective_s"])
    return t_model / t_bound if t_bound else None


def fmt_fraction_table(base: dict, opt: dict) -> str:
    rows = ["| cell | frac (op-bytes) base→opt | frac (traffic-floor) base→opt |",
            "|---|---|---|"]
    for k in sorted(opt):
        if not k.endswith("/single"):
            continue
        fb = roofline_fraction(base.get(k, {}))
        fo = roofline_fraction(opt[k])
        gb = roofline_fraction(base.get(k, {}), use_floor=True)
        go = roofline_fraction(opt[k], use_floor=True)
        if fo is None:
            continue
        rows.append(
            f"| {k[:-7]} | {fb or 0:.4f} → {fo:.4f} | {gb or 0:.3f} → {go or 0:.3f} |"
        )
    return "\n".join(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "results/dryrun_torch.json"
    with open(path) as f:
        results = json.load(f)
    print("## Roofline (single pod, 16x16)\n")
    print(fmt_table(results, "single"))
    print("\n## Dry-run gate (both meshes)\n")
    print(fmt_dryrun_table(results))
    if len(argv) > 1:
        with open(argv[1]) as f:
            opt = json.load(f)
        print("\n## Roofline fractions (baseline -> optimized)\n")
        print(fmt_fraction_table(results, opt))


if __name__ == "__main__":
    main()
