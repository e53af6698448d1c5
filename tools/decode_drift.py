#!/usr/bin/env python3
"""xlstm-1.3b's float32 decode against its own parallel forward, as phase
m of ``chip_smoke.py`` measures it, on the CPU or the card.

    python3 tools/decode_drift.py [--device cpu|cuda] [--smoke]

Draws the model's weights from seed 0 on a CPU generator (the same
weights on either device; phase m draws on the card's), prefills phase
m's prompt (batch, prompt and ``gen`` from ``chip_smoke.FAMILY_SPECS``:
1 x 4096, 48 layers), decodes ``gen`` greedy steps with a float32 cache
and holds the logits against the forward's at the same positions: prints
the largest difference, absolute and as a share of the forward's largest
|logit|, and the largest difference after each step. On the CPU this is
the drift float32 rounding alone makes at the model's widths and depth
(the recurrent decode and the parallel forward sum in different orders),
the yardstick for phase m's bound on the card. ``--smoke`` takes the
smoke config (8 layers at d_model 128; minutes on a CPU, for rehearsal).
Prints one JSON line. Runs from the repository root.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, SEED = "xlstm-1.3b", 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import models as M
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    spec = next(s for s in cs.FAMILY_SPECS if s["arch"] == ARCH)
    cfg = (smoke_config if args.smoke else get_config)(ARCH)
    dev = torch.device(args.device)
    plan = M.DEFAULT_PLAN
    bsz, n_prompt, n_gen = spec["batch"], spec["prompt"], spec["gen"]
    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = M.init_params(torch.Generator().manual_seed(SEED), cfg, device=dev)
        prompt = cs._family_inputs(cfg, spec, rng, dev, bsz, n_prompt)
        state = M.init_decode_state(cfg, plan, bsz, n_prompt + n_gen,
                                    cache_dtype=torch.float32, device=dev)
        lg, st = make_prefill_step(cfg, plan)(params, prompt, state)
        del state
        decode = make_decode_step(cfg, plan)
        nxt = torch.argmax(lg, -1).to(torch.int32)
        logits, toks = [lg], [nxt]
        for i in range(n_gen):
            pos = torch.full((), n_prompt + i, dtype=torch.int32, device=dev)
            nxt, lg, st = decode(params, st, nxt, pos)
            logits.append(lg)
            toks.append(nxt)
        seq = torch.cat([prompt["tokens"], torch.stack(toks[:n_gen], 1)], 1)
        want = cs._tail_logits(params, dict(prompt, tokens=seq), cfg, n_gen + 1)
        diff = (torch.stack(logits, 1) - want).abs()
    err, scale = float(diff.max()), float(want.abs().max())
    print(json.dumps({"decode_drift": {
        "arch": ARCH, "smoke": args.smoke, "device": str(dev),
        "device_name": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "threads": torch.get_num_threads(), "torch": torch.__version__,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model, "batch": bsz, "prompt": n_prompt,
        "gen": n_gen, "seed": SEED, "max_err_vs_forward": err, "logit_scale": scale,
        "rel_err_vs_forward": err / scale,
        "err_by_step": [float(x) for x in diff.amax(dim=(0, 2))],
        "s": time.perf_counter() - t0}}))


if __name__ == "__main__":
    main()
