"""Batched LM serving: prefill a prompt batch, then greedy / temperature
decode with the KV cache (bf16, int8 or float32).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch smollm-135m \\
        --smoke --prompt-len 32 --gen 32 --cache int8 [--device cpu]

The flags are the reference example's (``--smoke`` stays on, as there);
``--device`` picks where it runs (default: the GPU). Weights and prompts
are random, made from fixed seeds.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import models as M
from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache", default="bfloat16", choices=["bfloat16", "int8", "float32"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    max_len = args.prompt_len + args.gen
    cache_dtype = {"bfloat16": torch.bfloat16, "int8": torch.int8,
                   "float32": torch.float32}[args.cache]

    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1))
    batch = {"tokens": prompts.to(dev)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((args.batch, cfg.n_encoder_frames, cfg.d_model),
                                      device=dev)
    if cfg.is_vlm:
        batch["image_embeds"] = torch.zeros((args.batch, cfg.n_image_tokens, 1024),
                                            device=dev)

    state = M.init_decode_state(cfg, M.DEFAULT_PLAN, args.batch, max_len,
                                cache_dtype=cache_dtype, device=dev)
    prefill = make_prefill_step(cfg, M.DEFAULT_PLAN)
    decode = make_decode_step(cfg, M.DEFAULT_PLAN, args.temperature)

    t0 = time.perf_counter()
    logits, state = prefill(params, batch, state)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = [nxt]
    rng = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        pos = torch.full((), args.prompt_len + i, dtype=torch.int32, device=dev)
        nxt, logits, state = decode(params, state, nxt, pos, rng)
        out_tokens.append(nxt)
    _sync(dev)
    t_dec = time.perf_counter() - t0

    gen = torch.stack(out_tokens, dim=1)
    print(f"{args.arch} ({'smoke' if args.smoke else 'full'}), cache={args.cache}, "
          f"device={dev}")
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill * 1e3:.0f} ms")
    print(f"decode  {args.gen - 1} steps: {t_dec * 1e3:.0f} ms "
          f"({args.batch * (args.gen - 1) / max(t_dec, 1e-9):.0f} tok/s, {dev.type})")
    print("sample:", gen[0, :16].tolist())
    return gen


if __name__ == "__main__":
    main()
