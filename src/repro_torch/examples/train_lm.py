"""LM training for the assigned architectures, on the card.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch smollm-135m --smoke --steps 30
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch smollm-135m   # full width
    (add --device cpu to run on the CPU)

Any of the 10 assigned archs is selectable; ``--smoke`` swaps in the
reduced config of the same family and trains in float32, the full config
trains in bf16 compute on float32 master weights. Seeded weights train on
``TokenStream`` batches through the fault-tolerant ``Trainer`` with
checkpoints (kill and rerun: it resumes from the last commit).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import models as M
from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import tree_flatten_with_paths
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def token_batches(cfg, stream: TokenStream, batch: int, device):
    """``step -> batch`` on ``device``: ``TokenStream`` tokens, plus zero
    image embeddings (VLM) or encoder frames (enc-dec) as the reference's
    example feeds them. A pure function of the step."""
    def data_fn(step):
        b = {"tokens": torch.from_numpy(stream.batch(step)["tokens"]).to(device)}
        if cfg.is_vlm:
            b["image_embeds"] = torch.zeros((batch, cfg.n_image_tokens, 1024), device=device)
        if cfg.is_encoder_decoder:
            b["frames"] = torch.zeros((batch, cfg.n_encoder_frames, cfg.d_model),
                                      device=device)
        return b
    return data_fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    n = sum(x.numel() for _, x in tree_flatten_with_paths(params))
    print(f"{args.arch}{' (smoke)' if args.smoke else ''}: {n / 1e6:.1f}M params, device {dev}")

    opt = AdamWConfig(lr=1e-3)
    opt_state = init_opt_state(params, opt)
    step = make_train_step(cfg, M.DEFAULT_PLAN, opt,
                           compute_dtype=torch.float32 if args.smoke else torch.bfloat16)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    trainer = Trainer(step, token_batches(cfg, stream, args.batch, dev), TrainerConfig(
        total_steps=args.steps, ckpt_every=10, ckpt_dir=args.ckpt_dir, log_every=5))
    params, opt_state, history = trainer.run(params, opt_state)
    for h in history:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  {h['dt'] * 1e3:.0f} ms")
    print("first->last logged loss: "
          f"{history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}")
    return {"n_params": n, "history": history, "params": params, "opt_state": opt_state}


if __name__ == "__main__":
    main()
