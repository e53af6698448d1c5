"""Multi-pod dry run and roofline points, on fake ranks (the reference's
``repro.launch.dryrun``).

The reference compiles each (arch x shape x mesh) cell with XLA for 256 or
512 host devices and reads the compiled program. The port has no
compiler: it runs the step itself, once, as ``DTensor``s on a ``fake``
process group of 256 ranks (512 for ``--mesh multi``) in this one process,
on ``FakeTensor``s (no storage, no card), and records what rank 0 does
(``roofline.trace``: its local flops and bytes, its collectives, its
peak of live bytes). This is the route of torchtitan's memory estimator.

For every cell:

  1. The full-depth step (the dry-run gate): bytes per device (arguments,
     outputs, the peak of live storage), the collective schedule, and the
     wall time of building the fake state (``lower_s``) and of the traced
     step (``compile_s``, the port's stand-in for the compile). Training
     cells raise the gradient-accumulation microbatches until the step's
     peak fits one H100's ``HBM_BYTES`` (80 GiB).
  2. Roofline points: the step at 1x and 2x the block pattern, whose
     difference extrapolates linearly to full depth (``extrapolate``),
     the reference's pattern. The port's layer loop is Python, so each
     point is already the unrolled program.

Results are merged into ``--out`` (JSON) keyed "arch/shape/mesh", so a
rerun skips the cells that are done. The default is
``results/dryrun_torch.json``: ``results/dryrun.json`` is the reference's.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, applicable_shapes, arch_shape_cells, get_config
from repro_torch.configs.base import SLSTM, ModelConfig, ShapeConfig
from repro_torch.convert import tree_map
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     make_production_mesh, production_ranks)
from repro_torch.launch.shardings import (Sharding, constrainer_ctx, plan_for, shardings_for,
                                          train_plan_for)
from repro_torch.launch.specs import batch_spec_shardings, batch_specs, decode_input_specs
from repro_torch.models import lm
from repro_torch.models.layers import ParallelPlan
from repro_torch.models.sharding_ctx import P
from repro_torch.optim import AdamWConfig, init_opt_state, opt_state_specs
from repro_torch.roofline.trace import Trace, fake_world, trace_step
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[name]


# ---------------------------------------------------------------------------
# cell construction: one traced step
# ---------------------------------------------------------------------------

def _placed(tree, shardings, device):
    """Fake tensors of ``tree``'s shapes and dtypes on ``device``, laid out
    as ``shardings`` say (each rank's shard; nothing is sent)."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, sh: Sharding):
        t = torch.empty(tuple(x.shape), dtype=x.dtype, device=device)
        return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)

    return tree_map(one, tree, shardings)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: ParallelPlan,
               microbatches: int = 1, cache_dtype: torch.dtype = torch.bfloat16,
               moe_a2a: bool = False, holders: bool = False) -> Trace:
    """Run one train, prefill or decode step of ``cfg`` at ``shape`` on
    ``mesh`` (a ``DeviceMesh`` of a fake process group) as ``DTensor``s
    of fake tensors on the mesh's device type, and return rank 0's
    :class:`~repro_torch.roofline.trace.Trace` (with ``holders``, each
    storage's provenance and those live at the peak)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        # autograd sets up a CUDA device guard even for fake CUDA tensors
        raise RuntimeError("this torch build has no CUDA, so fake CUDA tensors cannot run "
                           "a step; build the mesh with device_type='cpu'")
    tplan = train_plan_for(cfg)
    opt = AdamWConfig(moment_dtype=_dtype(tplan.moment_dtype))
    pspecs = lm.param_specs(cfg, plan)
    # the trees' shapes come from the init functions run on fake CPU tensors
    # (the generator's device; nothing is drawn), and _placed makes each
    # rank's shard on the mesh's device
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        if shape.is_train:
            params = lm.init_params(gen, cfg, plan, dtype=_dtype(tplan.param_dtype),
                                    device=cpu)
            ostate = init_opt_state(params, opt)
            bspecs = batch_specs(cfg, shape)
            args = (_placed(params, shardings_for(pspecs, params, mesh), dev),
                    _placed(ostate, shardings_for(opt_state_specs(pspecs), ostate, mesh), dev),
                    _placed(bspecs, shardings_for(batch_spec_shardings(cfg, shape, plan),
                                                  bspecs, mesh), dev))
            step = make_train_step(cfg, plan, opt, microbatches=microbatches)
        else:
            params = lm.init_params(gen, cfg, plan, dtype=torch.bfloat16, device=cpu)
            state = lm.init_decode_state(cfg, plan, shape.global_batch, shape.seq_len,
                                         cache_dtype=cache_dtype, device=cpu)
            p_in = _placed(params, shardings_for(pspecs, params, mesh), dev)
            s_in = _placed(state, shardings_for(
                lm.decode_state_specs(cfg, plan, cache_dtype=cache_dtype), state, mesh), dev)
            if shape.kind == "prefill":
                bspecs = batch_specs(cfg, shape)
                b_in = _placed(bspecs, shardings_for(batch_spec_shardings(cfg, shape, plan),
                                                     bspecs, mesh), dev)
                args = (p_in, b_in, s_in)
                step = make_prefill_step(cfg, plan)
            else:
                # one token against a seq_len cache; greedy, so no generator
                din = decode_input_specs(cfg, shape)
                tok = _placed({"t": din["tokens"]}, shardings_for(
                    {"t": P(plan.dp_axes)}, {"t": din["tokens"]}, mesh), dev)["t"]
                pos = _placed({"p": din["pos"]}, shardings_for(
                    {"p": P()}, {"p": din["pos"]}, mesh), dev)["p"]
                args = (p_in, s_in, tok, pos)
                step = make_decode_step(cfg, plan)
    setup_s = time.time() - t0
    # outside the fake mode: DTensor's layout bookkeeping runs on real index
    # tensors, and the recorder makes the step's own new tensors fake. A
    # plain tensor the step makes (a position table, an accumulator) is a
    # replicated operand, as in the sharded train step
    from torch.distributed.tensor.experimental import implicit_replication

    with constrainer_ctx(mesh, plan, moe_a2a=moe_a2a), implicit_replication():
        tr = trace_step(step, *args, fake_mode=fake, mesh=mesh, holders=holders)
    tr.setup_s = setup_s
    return tr


# ---------------------------------------------------------------------------
# the reference's compiled peak
# ---------------------------------------------------------------------------

# The reference's one-microbatch peak a device of each single-mesh cell, in
# GiB: its ``repro.launch.dryrun.lower_cell`` at one microbatch compiled for
# 256 forced CPU devices (``--xla_cpu_max_isa=AVX``, jax 0.9.0) on a
# (16, 16) ("data", "model") mesh of ``Auto`` axes, argument plus temp
# bytes of ``.compile().memory_analysis()``. A reference value (what XLA's
# buffer assignment needs), not a card's; constants, as its bytes are
REFERENCE_PEAK_GIB = {
    ("llama3-8b", "train_4k"): 21.42, ("llama3-8b", "prefill_32k"): 5.69,
    ("llama3-8b", "decode_32k"): 16.63,
    ("qwen2.5-32b", "train_4k"): 21.53, ("qwen2.5-32b", "prefill_32k"): 5.48,
    ("qwen2.5-32b", "decode_32k"): 29.14,
    ("mistral-nemo-12b", "train_4k"): 13.36, ("mistral-nemo-12b", "prefill_32k"): 4.12,
    ("mistral-nemo-12b", "decode_32k"): 18.10,
    ("smollm-135m", "train_4k"): 4.07, ("smollm-135m", "prefill_32k"): 0.66,
    ("smollm-135m", "decode_32k"): 6.75,
    ("pixtral-12b", "train_4k"): 13.46, ("pixtral-12b", "prefill_32k"): 4.12,
    ("pixtral-12b", "decode_32k"): 18.10,
    ("qwen3-moe-235b-a22b", "train_4k"): 404.29, ("qwen3-moe-235b-a22b", "prefill_32k"): 288.22,
    ("qwen3-moe-235b-a22b", "decode_32k"): 46.24,
    ("kimi-k2-1t-a32b", "train_4k"): 738.11, ("kimi-k2-1t-a32b", "prefill_32k"): 523.36,
    ("kimi-k2-1t-a32b", "decode_32k"): 50.61,
    ("whisper-tiny", "train_4k"): 56.75, ("whisper-tiny", "prefill_32k"): 1.40,
    ("whisper-tiny", "decode_32k"): 0.99,
    ("recurrentgemma-2b", "train_4k"): 26.29, ("recurrentgemma-2b", "prefill_32k"): 6.00,
    ("recurrentgemma-2b", "decode_32k"): 1.63, ("recurrentgemma-2b", "long_500k"): 1.03,
    ("xlstm-1.3b", "train_4k"): 40.00, ("xlstm-1.3b", "prefill_32k"): 19.36,
    ("xlstm-1.3b", "decode_32k"): 1.38, ("xlstm-1.3b", "long_500k"): 0.74,
}


def reference_peak_bytes(arch: str, shape_name: str) -> int | None:
    """The reference's one-microbatch peak a device of a single-mesh cell
    (:data:`REFERENCE_PEAK_GIB`), in bytes; ``None`` for a cell it lacks."""
    gib = REFERENCE_PEAK_GIB.get((arch, shape_name))
    return None if gib is None else int(gib * 2 ** 30)


# ---------------------------------------------------------------------------
# analytic corrections for time-scans a compiler's cost analysis cannot see
# ---------------------------------------------------------------------------

def slstm_flops_correction(cfg: ModelConfig, shape: ShapeConfig, n_layers: int,
                           n_chips: int) -> float:
    """sLSTM scans over time; its per-token gate / recurrence FLOPs, which
    XLA's cost analysis counts once per scan. Kept for parity: the port's
    scan is one op (``repro_torch::slstm_scan`` and its backward), whose
    registered flop formula counts the recurrent product of every
    position, so :func:`run_cell` adds nothing."""
    kinds = cfg.layer_kinds[:n_layers]
    n_sl = sum(1 for k in kinds if k == SLSTM)
    if n_sl == 0:
        return 0.0
    d = cfg.d_model
    dh = d // cfg.n_heads
    per_tok_fwd = 2 * (4 * d * d + 4 * d * dh + 8 * d)
    mult = 3.0 if shape.is_train else 1.0
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return n_sl * tokens * per_tok_fwd * mult / n_chips


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _memory(tr: Trace) -> dict:
    return {
        "argument_bytes_per_device": tr.argument_bytes,
        "output_bytes_per_device": tr.output_bytes,
        "output_leaves": tr.n_outputs,
        "temp_bytes_per_device": tr.peak_bytes - tr.argument_bytes,
        "alias_bytes_per_device": tr.alias_bytes,
        "approx_peak_per_device": tr.peak_bytes,
        "local_fallbacks": tr.local_fallbacks,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, do_roofline: bool = True,
             cache_dtype_name: str = "bfloat16", moe_a2a: bool = False,
             xlstm_chunk: int = 0, hbm_bytes: int = HBM_BYTES,
             device_type: str = "cuda", on_gate=None) -> dict:
    """One cell's record (the reference's keys; ``memory["fits_hbm"]``
    against ``hbm_bytes``, one H100's 80 GiB unless given). The fake
    tensors lie on ``device_type``'s device: the card's unless the caller
    asks for the CPU. ``on_gate``, if given, is called with the record of
    the full-depth step before the roofline points run (``main`` writes
    it, so that a cell stopped in its points keeps its gate)."""
    from repro_torch.roofline.analysis import collective_bytes, collectives_by_axis, \
        cost_point, extrapolate, model_flops

    cache_dtype = _dtype(cache_dtype_name)
    cfg = get_config(arch)
    if xlstm_chunk:
        cfg = dataclasses.replace(cfg, xlstm_chunk=xlstm_chunk)
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        # the reference's note: all-to-all dispatch regresses single-token
        # decode (fixed-minimum per-expert buffers >> 1 token a chip)
        moe_a2a = False
    multi = mesh_kind == "multi"
    with fake_world(production_ranks(multi_pod=multi)):
        mesh = make_production_mesh(multi_pod=multi, device_type=device_type)
        n_chips = mesh.size()
        plan = plan_for(cfg, mesh)
        rec: dict = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "chips": n_chips, "plan": {"tp": plan.tp, "fsdp": plan.fsdp},
        }

        # -- 1. the full-depth step (the dry-run gate) -----------------------
        mb_trail = []
        if shape.is_train:
            dp_total = n_chips // plan.tp
            mb_cap = max(1, shape.global_batch // dp_total)
            mb_options = [m for m in (1, 4, 8, 16, 32) if m <= mb_cap] or [1]
        else:
            mb_options = [1]
        for mb in mb_options:
            tr = lower_cell(cfg, shape, mesh, plan, microbatches=mb, cache_dtype=cache_dtype,
                            moe_a2a=moe_a2a)
            mb_trail.append({"microbatches": mb, "peak_per_device": tr.peak_bytes})
            if tr.peak_bytes <= hbm_bytes or mb == mb_options[-1]:
                break

        rec["lower_s"], rec["compile_s"] = round(tr.setup_s, 1), round(tr.step_s, 1)
        rec["microbatches"] = mb
        rec["microbatch_trail"] = mb_trail
        rec["memory"] = {**_memory(tr), "fits_hbm": bool(tr.peak_bytes <= hbm_bytes)}
        rec["full_collectives"] = collective_bytes(tr)["counts"]
        rec["full_collectives_by_axis"] = collectives_by_axis(tr)
        # the HBM traffic floor: every argument byte read once; training also
        # writes the params and optimiser state back
        k = 3.0 if shape.is_train else 1.0
        rec["t_memory_floor_s"] = k * tr.argument_bytes / HBM_BW
        if not do_roofline:
            return rec
        if on_gate is not None:
            on_gate(rec)

        # -- 2. roofline points: the 1x / 2x pattern -------------------------
        pat = len(cfg.block_pattern)
        pts = []
        t_points = time.time()
        for mult in (1, 2):
            rcfg = dataclasses.replace(cfg, n_layers=pat * mult, unroll_layers=True)
            pts.append(cost_point(lower_cell(rcfg, shape, mesh, plan, cache_dtype=cache_dtype,
                                             moe_a2a=moe_a2a)))
        points_s = time.time() - t_points
    n_rep_full = cfg.n_layers / pat
    terms = dataclasses.replace(extrapolate(pts[0], pts[1], 1, 2, n_rep_full),
                                peak=PEAK_FLOPS_BF16)
    # no slstm_flops_correction: the sLSTM's scan op is counted by its flop
    # formula, every position's recurrent product (XLA counts a scan's body
    # once)

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = model_flops(cfg.active_param_count(), tokens, shape.is_train)
    rec["roofline"] = terms.as_dict()
    rec["roofline"]["model_flops_per_chip"] = mf / n_chips
    rec["roofline"]["useful_flops_ratio"] = (
        (mf / n_chips) / terms.flops_per_chip if terms.flops_per_chip else 0.0
    )
    rec["roofline"]["points"] = pts
    rec["roofline"]["points_s"] = round(points_s, 1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--cache-dtype", default="bfloat16", choices=["bfloat16", "int8"])
    ap.add_argument("--moe-dispatch", default="gspmd", choices=["gspmd", "a2a"])
    ap.add_argument("--xlstm-chunk", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = arch_shape_cells()
    else:
        cfg = get_config(args.arch)
        shapes = [args.shape] if args.shape else applicable_shapes(cfg)
        cells = [(args.arch, s) for s in shapes]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch, shape_name in cells:
        for mesh_kind in meshes:
            key = f"{arch}/{shape_name}/{mesh_kind}"
            if key in results and "error" not in results[key] and \
                    results[key].get("stage") != "gate":
                print(f"[skip] {key}")
                continue
            print(f"[run ] {key}", flush=True)
            t0 = time.time()

            def gate(rec, key=key, t0=t0):
                # the full-depth step's record while the roofline points run
                results[key] = {**rec, "stage": "gate", "wall_s": round(time.time() - t0, 1)}
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

            try:
                rec = run_cell(arch, shape_name, mesh_kind,
                               do_roofline=not args.no_roofline,
                               cache_dtype_name=args.cache_dtype,
                               moe_a2a=(args.moe_dispatch == "a2a"),
                               xlstm_chunk=args.xlstm_chunk, on_gate=gate)
                rec["wall_s"] = round(time.time() - t0, 1)
                results[key] = rec
                rl = rec.get("roofline", {})
                print(
                    f"  ok {rec['wall_s']}s step={rec['compile_s']}s "
                    f"peak/dev={rec['memory']['approx_peak_per_device']/2**30:.2f}GiB "
                    f"bottleneck={rl.get('bottleneck', '-')}",
                    flush=True,
                )
            except Exception as e:
                results[key] = {"error": f"{type(e).__name__}: {e}",
                                "traceback": traceback.format_exc()[-2000:]}
                print(f"  FAIL {type(e).__name__}: {e}", flush=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(1 for v in results.values() if "error" not in v)
    print(f"done: {n_ok}/{len(results)} cells ok")


if __name__ == "__main__":
    main()
