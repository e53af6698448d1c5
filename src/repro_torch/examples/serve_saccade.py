"""Saccadic serving on the multi-stream engine, on the card.

    PYTHONPATH=src python -m repro_torch.examples.serve_saccade [--device cpu]

Four scenarios on the compact path (frame t's patch selection comes from
the backend's attention on frame t-1; only those ~25 % of patches are
gathered, projected and ADC-converted, and the backend attends over the k
compact tokens), all through ``SaccadeEngine`` on the staged kernel route
(the projection kernel's codes, then the w8a8 embed kernel):

1. Single camera through a capacity-1 engine.
2. A camera fleet: four slots, cameras joining and leaving mid-serve;
   churn rewrites slot rows and never changes a tensor shape.
3. Temporal reuse: a mostly static camera on the temporal gate. Held charge
   serves unchanged patches, so after the bootstrap frame little is
   re-projected until the scene changes.
4. Device rollout: T recorded ticks served by one ``step_rollout``, bitwise
   T ``step()`` calls, and the same with ``block=False``.

Every scenario reports the engine's live energy meter (the frontend events
each stream executed, priced in mW). The card is used by default (it needs
a CUDA GPU with ``nvcc`` to build the kernels); ``--device cpu`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.frontend import FrontendConfig
from repro_torch.core.projection import PatchSpec
from repro_torch.core.temporal import TemporalSpec
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops
from repro_torch.models.vit import ViTConfig, init_vit, prepare_quant_embed
from repro_torch.serve.engine import SaccadeEngine


def make_cfg() -> ViTConfig:
    fcfg = FrontendConfig(image_h=64, image_w=64,
                          patch=PatchSpec(patch_h=16, patch_w=16, n_vectors=32),
                          active_fraction=0.25)
    return ViTConfig(frontend=fcfg, n_layers=2, d_model=64, n_heads=4, d_ff=128,
                     quant_embed=True)


def engine(cfg, params, device, capacity, **kw) -> SaccadeEngine:
    fcfg = cfg.frontend
    return SaccadeEngine(cfg, params, capacity=capacity, device=device,
                         project_fn=ops.ip2_codes_fn(fcfg.patch, fcfg.adc), **kw)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def single_camera(cfg, params, device):
    print("=== scenario 1: single camera, closed saccade loop ===")
    fcfg = cfg.frontend
    stream = SceneStream(image=64)
    eng = engine(cfg, params, device, 1)
    eng.admit("cam0")
    k = fcfg.n_active
    hits = 0
    t0 = time.perf_counter()
    for t in range(10):
        rgb, labels = stream.batch(t, 1)
        logits = eng.step({"cam0": rgb[0]})["cam0"]
        hits += int(np.argmax(logits) == labels[0])
        print(f"frame {t}: {k}/{fcfg.n_patches} patches ADC-converted, "
              f"gaze -> {sorted(map(int, eng.gaze('cam0')))}")
    dt = (time.perf_counter() - t0) / 10
    feats = k * fcfg.patch.n_vectors
    pixels = fcfg.image_h * fcfg.image_w * 3
    print(f"{dt * 1e3:.1f} ms/frame on {device}; stream: {feats} codes vs {pixels} "
          f"RGB values = {pixels / feats:.1f}x reduction; acc(untrained) = {hits / 10:.2f}")
    print(f"live power meter: {eng.power_mw('cam0', 'mean'):.3f} mW from "
          f"{eng.events('cam0', 'total').adc_conversions:.0f} ADC conversions "
          f"and the fixed frame costs\n")


def multi_camera(cfg, params, device):
    print("=== scenario 2: camera fleet with join and leave ===")
    stream = SceneStream(seed=11, image=64)
    eng = engine(cfg, params, device, 4, ema_decay=0.5)
    schedule = {0: [("admit", "lobby"), ("admit", "dock")],
                3: [("admit", "gate")],
                6: [("evict", "dock"), ("admit", "roof")]}
    served = 0
    t0 = time.perf_counter()
    for t in range(10):
        for op, cam in schedule.get(t, []):
            getattr(eng, op)(cam)
            print(f"frame {t}: {op} {cam!r:8} "
                  f"({eng.capacity - eng.free_slots}/{eng.capacity} slots)")
        rgb, _ = stream.batch(t, eng.capacity)
        served += len(eng.step({cam: rgb[eng.slot_of(cam)] for cam in eng.stream_ids}))
    dt = time.perf_counter() - t0
    ages = {cam: int(eng.state.frame_age[eng.slot_of(cam)]) for cam in eng.stream_ids}
    print(f"served {served} stream-frames in {dt * 1e3:.0f} ms on {device}; "
          f"frame ages {ages}")
    mw = {cam: round(eng.power_mw(cam), 3) for cam in eng.stream_ids}
    print(f"live per-camera power: {mw} mW (fleet {eng.fleet_power_mw():.3f} mW)\n")


def temporal_reuse(cfg, device):
    print("=== scenario 3: static camera, temporal gate ===")
    fcfg = dataclasses.replace(cfg.frontend, temporal=TemporalSpec(delta_threshold=1e-4))
    tcfg = dataclasses.replace(cfg, frontend=fcfg)
    params = prepare_quant_embed(init_vit(tcfg, torch.Generator().manual_seed(0),
                                          device=device))
    eng = engine(tcfg, params, device, 1, temporal=True)
    eng.admit("lobby")
    stream = SceneStream(seed=3, image=64)
    still, _ = stream.batch(0, 1)          # the empty lobby
    intruder, _ = stream.batch(1, 1)       # someone walks in at frame 6
    k = fcfg.n_active
    converted = 0
    for t in range(10):
        eng.step({"lobby": still[0] if t < 6 else intruder[0]})
        frac = eng.recompute_fraction("lobby")
        converted += int(round(frac * k))
        tag = " <- scene change" if t == 6 else ""
        print(f"frame {t}: {int(round(frac * k))}/{k} selected patches re-converted, "
              f"{eng.power_mw('lobby'):.3f} mW{tag}")
    report = eng.energy_report("lobby")
    print(f"ADC conversions over 10 frames: {converted} vs {10 * k} always-recompute; "
          f"energy since admit: {sum(report.values()) * 1e6:.3f} uJ "
          f"({report['adc'] * 1e6:.3f} uJ in the ADC)\n")


def device_rollout(cfg, params, device):
    print("=== scenario 4: device rollout, T ticks without a host round-trip ===")
    stream = SceneStream(seed=7, image=64)
    cams = ["lobby", "dock", "gate"]
    eng_loop, eng_roll = engine(cfg, params, device, 3), engine(cfg, params, device, 3)
    for eng in (eng_loop, eng_roll):
        for cam in cams:
            eng.admit(cam)
    # a T = 8 clip with frame-rate skew: lobby every tick, dock every 2nd,
    # gate every 4th (un-fed streams hold)
    T = 8
    rgb, _ = stream.batch(0, T * len(cams))
    sched = []
    for t in range(T):
        fr = {"lobby": rgb[3 * t]}
        if t % 2 == 0:
            fr["dock"] = rgb[3 * t + 1]
        if t % 4 == 0:
            fr["gate"] = rgb[3 * t + 2]
        sched.append(fr)
    # one warm pass each (staging allocated, kernels built); the engines
    # stay in the same state, bitwise
    for fr in sched:
        eng_loop.step(fr)
    eng_roll.step_rollout(sched)
    _sync(device)
    t0 = time.perf_counter()
    seq = [eng_loop.step(fr) for fr in sched]
    dt_loop = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    handle = eng_roll.step_rollout(sched, block=False)    # returns once issued
    dt_issue = time.perf_counter() - t0
    roll = handle.result()                                # one (T, S, C) fetch
    dt_roll = time.perf_counter() - t0
    exact = all(np.array_equal(seq[t][cam], roll[t][cam]) for t in range(T) for cam in seq[t])
    served = sum(len(d) for d in roll)
    launches = {n: c for n, c in ops.LAUNCHES.items() if c}
    print(f"replayed {served} stream-frames over T={T} ticks on {device}: step() "
          f"{dt_loop / T * 1e3:.1f} ms/tick, rollout {dt_roll / T * 1e3:.1f} ms/tick "
          f"(issued in {dt_issue * 1e3:.1f} ms); kernel launches {launches or 'none (CPU)'}")
    print(f"rollout logits bitwise equal to {T} step() calls: {exact}")
    assert exact


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = make_cfg()
    params = prepare_quant_embed(init_vit(cfg, torch.Generator().manual_seed(0),
                                          device=args.device))
    single_camera(cfg, params, args.device)
    multi_camera(cfg, params, args.device)
    temporal_reuse(cfg, args.device)
    device_rollout(cfg, params, args.device)


if __name__ == "__main__":
    main()
