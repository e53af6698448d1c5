"""Co-design training of the IP2 analog frontend with a patch-token
transformer backend (the paper's classification study, §1), on the card.

    PYTHONPATH=src python -m repro_torch.examples.train_ip2_classifier --preset cpu-small
    PYTHONPATH=src python -m repro_torch.examples.train_ip2_classifier --preset 100m --steps 300
    (add --device cpu to run on the CPU)

Trains the in-pixel weight matrix A jointly with the backend through the
STE-quantised analog path (``vit_loss`` under ``torch.autograd``, then
AdamW at a constant learning rate), with fault-tolerant checkpoints (kill
and rerun: it resumes from the last commit), then reports held-out
accuracy.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch._device import resolve_device
from repro_torch.convert import tree_flatten_with_paths
from repro_torch.core.frontend import FrontendConfig
from repro_torch.core.projection import PatchSpec
from repro_torch.data.pipeline import SceneStream
from repro_torch.models.vit import ViTConfig, init_vit, vit_loss
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.trainer import (Trainer, TrainerConfig, make_train_step,
                                      stream_batches)

PRESETS = {
    # ~0.1M-parameter backend
    "cpu-small": dict(image=64, patch=16, n_vectors=32, n_layers=2,
                      d_model=64, n_heads=4, d_ff=128, batch=32),
    # ~86M-parameter backend at the paper's 32x32 / 400-vector design point
    "100m": dict(image=256, patch=32, n_vectors=400, n_layers=12,
                 d_model=768, n_heads=12, d_ff=3072, batch=64),
}


def preset_config(preset: str, active: float = 0.25) -> ViTConfig:
    p = PRESETS[preset]
    return ViTConfig(
        frontend=FrontendConfig(
            image_h=p["image"], image_w=p["image"],
            patch=PatchSpec(patch_h=p["patch"], patch_w=p["patch"],
                            n_vectors=p["n_vectors"]),
            active_fraction=active,
        ),
        n_classes=4, n_layers=p["n_layers"], d_model=p["d_model"],
        n_heads=p["n_heads"], d_ff=p["d_ff"],
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="cpu-small", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--active", type=float, default=0.25)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "ip2_classifier_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    p = PRESETS[args.preset]
    cfg = preset_config(args.preset, args.active)

    params = init_vit(cfg, torch.Generator().manual_seed(0), device=dev)
    n_params = sum(x.numel() for _, x in tree_flatten_with_paths(params))
    print(f"preset={args.preset}: {n_params / 1e6:.1f}M params, "
          f"{cfg.frontend.n_patches} patches, {args.active:.0%} active, device {dev}")

    opt = AdamWConfig(lr=2e-3, weight_decay=0.01)
    opt_state = init_opt_state(params, opt)
    stream = SceneStream(image=p["image"])
    trainer = Trainer(
        make_train_step(lambda q, rgb, labels: vit_loss(q, rgb, labels, cfg), opt),
        stream_batches(stream, p["batch"], dev),
        TrainerConfig(total_steps=args.steps, ckpt_every=50,
                      ckpt_dir=args.ckpt_dir, log_every=20),
    )
    params, opt_state, history = trainer.run(params, opt_state)
    for h in history:
        print(f"step {h['step']:4d}  loss {h['loss']:.3f}  {h['dt'] * 1e3:.0f} ms")

    # held-out eval
    accs = []
    with torch.no_grad():
        for j in range(8):
            rgb, labels = stream.batch(10_000 + j, p["batch"])
            _, acc = vit_loss(params, torch.from_numpy(rgb).to(dev),
                              torch.from_numpy(labels).to(dev), cfg)
            accs.append(float(acc))
    acc = sum(accs) / len(accs)
    print(f"held-out accuracy: {acc:.3f} "
          f"(stragglers observed: {trainer.n_stragglers})")
    return {"n_params": n_params, "history": history, "held_out_acc": acc,
            "n_stragglers": trainer.n_stragglers, "params": params,
            "opt_state": opt_state}


if __name__ == "__main__":
    main()
