"""Quickstart: one frame through the IP2 in-pixel analog frontend, on the card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Shows: scene -> anti-alias optics -> Bayer -> salient patch selection ->
analog PWM / switched-cap projection (6-bit) -> edge ADC -> compact feature
stream; the same projection through the projection kernel (on the card;
its plain version with ``--device cpu``) against the plain analog model;
then the sensor's power, area and throughput report (paper Table 1,
§2.1.3, Fig. 3). The milliwatts, hertz and square microns are the paper's
sensor model, not measurements of the device this runs on.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.convert import tree_to
from repro_torch.core.bayer import mosaic, strike_columns
from repro_torch.core.frontend import (FrontendConfig, apply_frontend, compact_features,
                                       init_frontend_params)
from repro_torch.core.power import AreaBudget, SensorConfig, power_report
from repro_torch.core.projection import PatchSpec, analog_project_patches, extract_patches
from repro_torch.core.throughput import rate_point
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    # the paper's 32x32 / 400-vector design scaled to a 128 px demo frame
    # with 16x16 patches
    fcfg = FrontendConfig(image_h=128, image_w=128,
                          patch=PatchSpec(patch_h=16, patch_w=16, n_vectors=48),
                          active_fraction=0.25, aa_cutoff=0.5)
    params = tree_to(init_frontend_params(fcfg, torch.Generator().manual_seed(0)), dev)
    rgb, _ = SceneStream(image=128).batch(0, 2)
    rgb = torch.from_numpy(rgb).to(dev)

    feats, mask = apply_frontend(params, rgb, fcfg)
    compact, _ = compact_features(feats, mask, fcfg)
    print(f"device {dev}: frame {tuple(rgb.shape)} -> {fcfg.n_patches} patches, "
          f"{int(mask[0].sum())} active ({fcfg.active_fraction:.0%})")
    print(f"features: {tuple(feats.shape)} -> compact ADC stream {tuple(compact.shape)}")
    reduction = rgb[0].numel() / compact[0].numel()
    print(f"data reduction this frame: {reduction:.1f}x vs RGB")

    # the same projection through the projection kernel (its plain version
    # on the CPU) against the plain analog model
    patches = extract_patches(mosaic(rgb), 16, 16)
    w = strike_columns(params["a_rgb"], 16, 16)
    k_out = ops.ip2_project(patches, w, fcfg.patch)
    diff = float((k_out - analog_project_patches(patches, w, fcfg.patch)).abs().max())
    route = "kernel" if dev.type == "cuda" else "plain kernel version"
    print(f"{route} vs analog reference max |diff|: {diff:.2e}")

    # sensor-level model (paper Table 1, §2.1.3, Fig. 3)
    rep = power_report(SensorConfig())
    print(f"\nsensor model, 2Mpix@30Hz front-end power: {rep.total_w * 1e3:.1f} mW "
          f"({rep.mw_per_mpix:.1f} mW/Mpix, ADC share {rep.share()['adc']:.0%})")
    p = rate_point("1080p", 2, 32, 400)
    print(f"sensor model, 1080p, C=2 weight lines, 400 vec/32x32 patch: "
          f"{p.frame_hz:.0f} Hz")
    area = AreaBudget().totals()
    print(f"in-pixel circuit: {area['Total']['total_um2']:.0f} um^2 -> "
          f"{area['Total']['pitch_um']:.1f} um pitch (65nm)")
    return {"n_active": int(mask[0].sum()), "compact_shape": tuple(compact.shape),
            "data_reduction": reduction, "kernel_max_abs_diff": diff,
            "power_mw": rep.total_w * 1e3, "mw_per_mpix": rep.mw_per_mpix,
            "adc_share": rep.share()["adc"], "frame_hz": p.frame_hz,
            "area_um2": area["Total"]["total_um2"], "pitch_um": area["Total"]["pitch_um"]}


if __name__ == "__main__":
    main()
