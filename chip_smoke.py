#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py [--out DIR]

Runs from the repository root (it finds the port under ``src/``) and needs
one CUDA device. Phases, any failure exits non-zero:

  build  compile the three CUDA kernels from ``src/repro_torch/kernels/csrc``
         into ``build/`` (one nvcc per source, in parallel).
  (a)    each kernel against its plain PyTorch version on the card, at the
         serving path's shapes, through the public ops wrappers:
         quant_matmul bitwise; ip2_project's ADC codes and other readouts
         within 1 step on at most 1% of rows, and its 10- and 20-bit codes
         (int16, int32) bitwise equal to the ADC on its own analog output;
         ip2_fused_embed bitwise equal to ip2_project -> quant_matmul.
  (b)    the main path: two SaccadeEngines at ip2-vit width (256x256 frames,
         32x32 patches, M=192, 6 layers, d_model 256) and capacity 64, one
         on the staged kernel route, one on the fused kernel, same seeded
         parameters and SceneStream frames, 12 ticks of admit / evict /
         partial-fed churn. Logits and gaze of the two must be bitwise
         equal, logits finite, held slots frozen, and every kernel's launch
         count (reset just before, read just after) above 0.
  (ref)  a small input through the kernel route on the card and the plain
         route on the CPU: same indices, logits and saliency within 1e-4
         on every slot whose codes agree.
  (c)    times with CUDA events after warm-up: per-tick engine ms and
         stream-frames/s, each kernel's ms beside its plain version's, a
         PyTorch yardstick call's (never used by the port) and its bound.

Prints the kernel table as one JSON line, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. With ``--out DIR``
the full report (phases, compiler register reports, profile) is also
written to ``DIR/chip_smoke.json``.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM bytes/s, fp32 CUDA-core FLOP/s,
# int8 tensor-core OP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
CAPACITY = 64


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, n=30, warm=5):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _bound(n_bytes, t_ops):
    t_bytes = n_bytes / HBM_BPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the full JSON report")
    args = ap.parse_args()
    if not __debug__:
        _fail("run without -O: the checks below are assert statements")
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device: the port's kernels run on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.convert import tree_to
        from repro_torch.core import frontend as fe
        from repro_torch.core.adc import ADCSpec, encode
        from repro_torch.core import saliency as sal
        from repro_torch.core.frontend import FrontendConfig
        from repro_torch.core.projection import PatchSpec
        from repro_torch.data.pipeline import SceneStream
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.models.vit import ViTConfig, init_vit, prepare_quant_embed, \
            vit_forward_compact
        from repro_torch.serve.engine import SaccadeEngine
    except ImportError as e:
        _fail(f"the port is not beside this script ({e})")

    dev = torch.device("cuda")
    report = {"device": torch.cuda.get_device_name(0), "phases": {}}
    failures = []

    def phase(name):
        def wrap(fn):
            t0 = time.perf_counter()
            try:
                out = fn()
                report["phases"][name] = {"ok": True, "s": time.perf_counter() - t0}
                return out
            except Exception as e:  # record and go on: one call shows every fault
                failures.append(f"{name}: {e!r}")
                report["phases"][name] = {"ok": False, "error": traceback.format_exc()}
                traceback.print_exc()
                return None
        return wrap

    # ---- build -----------------------------------------------------------
    @phase("build")
    def built():
        libs = _build.build()
        for name in _build.SOURCES:
            _build.load(name)
        report["ptxas"] = {n: [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln]
                           for n, log in _build.build_logs().items()}
        return libs

    if built is None:
        _fail("kernel build failed: " + "; ".join(failures))

    fcfg = FrontendConfig(image_h=256, image_w=256,
                          patch=PatchSpec(32, 32, n_vectors=192), active_fraction=0.25)
    cfg_s = ViTConfig(frontend=fcfg, n_layers=6, d_model=256, n_heads=4, d_ff=1024,
                      quant_embed=True)
    cfg_f = dataclasses.replace(cfg_s, fused_embed=True)
    params = prepare_quant_embed(init_vit(cfg_s, torch.Generator().manual_seed(0)))
    adc = fcfg.adc
    stream = SceneStream(seed=7, image=256)

    # path-shaped operands: 64 slots of the first frames, energy bootstrap
    rgb0, _ = stream.batch(1000, CAPACITY)
    patches, weights = fe.sensor_patches(params["ip2"], torch.from_numpy(rgb0).to(dev), fcfg)
    idx = sal.topk_patch_indices(sal.patch_energy(patches), fcfg.n_active)
    gathered = sal.gather_patches(patches, idx).reshape(-1, patches.shape[-1]).contiguous()
    w_t = ops._dac_weights(weights, fcfg.patch).T.contiguous()
    zero_bias = torch.zeros(w_t.shape[1], device=dev)
    p_codes = ops.kernel_params_from_spec(fcfg.patch, adc, codes=True)
    w8, s_w = params["embed_q"]
    r_rows, k_in, m = gathered.shape[0], gathered.shape[1], w_t.shape[1]
    d = w8.shape[1]
    s_a = torch.full((r_rows,), adc.lsb, dtype=torch.float32, device=dev)
    # the fused kernel's own operands: dense row table, per-slot counts
    table = (idx.int() + torch.arange(CAPACITY, device=dev, dtype=torch.int32)[:, None]
             * patches.shape[1]).reshape(-1).contiguous()
    counts = torch.full((CAPACITY,), fcfg.n_active, dtype=torch.int32, device=dev)
    flat_p = patches.reshape(-1, k_in).contiguous()

    def fused_plain():
        return ref.ip2_fused_embed_ref(table, counts, flat_p, w_t, w8, s_w, p_codes,
                                       fcfg.n_active)

    kernels = {}

    # ---- (a) each kernel against its plain version ----------------------
    @phase("a_kernels_vs_plain")
    def _a():
        codes = ops.ip2_project(gathered, weights, fcfg.patch, adc=adc, codes=True)
        plain = ref.ip2_project_ref(gathered, w_t, zero_bias, p_codes)
        torch.cuda.synchronize()
        dc = (codes.int() - plain.int()).abs()
        flip_rows = int((dc.amax(-1) > 0).sum())
        kernels["ip2_project"] = {"max_abs_err": int(dc.max()), "flip_rows": flip_rows,
                                  "rows": r_rows}
        assert int(dc.max()) <= 1, f"ip2_project codes differ by {int(dc.max())} LSB"
        assert flip_rows <= r_rows // 100, f"{flip_rows} rows moved by 1 LSB"
        for mode, kw in (("dequant", {"adc": adc}), ("noadc", {}),
                         ("sign", {"readout": "sign"})):
            p = ops.kernel_params_from_spec(fcfg.patch, kw.get("adc"),
                                            readout=kw.get("readout", "adc"))
            got = ops.ip2_project(gathered, weights, fcfg.patch, **kw)
            want = ref.ip2_project_ref(gathered, w_t, zero_bias, p)
            assert got.dtype == (torch.bool if mode == "sign" else want.dtype), \
                f"{mode}: {got.dtype} != {want.dtype}"
            err = (got.double() - want.double()).abs()
            if mode == "noadc":
                assert float(err.max()) <= 1e-5, f"noadc readout off by {float(err.max())}"
            else:
                steps = err / (adc.lsb if mode == "dequant" else 1.0)
                assert float(steps.max()) <= 1 + 1e-4, f"{mode} readout off by > 1 step"
                assert int((steps.amax(-1) > 0.5).sum()) <= r_rows // 100
            kernels["ip2_project"][f"{mode}_max_abs_err"] = float(err.max())
        # wider ADCs store int16 / int32 codes: with V_R = 0 and no bias the
        # kernel's no-ADC readout is its analog output, and the plain ADC on
        # it must give the kernel's codes bit for bit
        assert fcfg.patch.summer.v_ref == 0.0
        v_out = ops.ip2_project(gathered, weights, fcfg.patch)
        for bits in (10, 20):
            wide = ADCSpec(bits=bits)
            got = ops.ip2_project(gathered, weights, fcfg.patch, adc=wide, codes=True)
            want = encode(v_out, wide)
            assert got.dtype == wide.code_dtype and torch.equal(got, want), \
                f"{bits}-bit codes differ from the ADC on the kernel's own readout"

        y = ops.quant_matmul_pre(codes, adc.lsb, w8, s_w)
        y_plain = ref.quant_matmul_ref(codes, s_a, w8, s_w)
        torch.cuda.synchronize()
        kernels["quant_matmul"] = {"max_abs_err": float((y - y_plain).abs().max())}
        assert torch.equal(y, y_plain), "quant_matmul differs from its plain version"

        fused = ops.ip2_fused_embed(patches, weights, idx, fcfg.patch, adc, w8, s_w)
        torch.cuda.synchronize()
        fused = fused.reshape(r_rows, d)
        kernels["ip2_fused_embed"] = {"max_abs_err": float((fused - y).abs().max())}
        assert torch.equal(fused, y), "ip2_fused_embed differs from ip2_project -> quant_matmul"
        same = dc.amax(-1) == 0
        assert torch.equal(fused[same], fused_plain()[same]), \
            "ip2_fused_embed differs from its plain version on rows whose codes agree"

    # ---- (b) the main path: staged and fused engines ---------------------
    engines = {
        "staged": SaccadeEngine(cfg_s, params, capacity=CAPACITY,
                                project_fn=ops.ip2_codes_fn(fcfg.patch, adc)),
        "fused": SaccadeEngine(cfg_f, params, capacity=CAPACITY),
    }
    ids = [f"cam{i}" for i in range(CAPACITY + 24)]
    # (evict, admit, fed) per tick; fed=None feeds every admitted stream
    schedule = [
        ([], ids[:48], None),
        ([], ids[48:64], None),
        ([], [], ids[0:64:2]),                     # odd streams hold
        (ids[0:8], ids[64:72], None),              # churn: 8 out, 8 in
        ([], [], ids[8:48]),                       # the last 24 hold
        (ids[8:12] + ids[64:66], ids[72:78], None),
        ([], [], None),
        ([], [], ids[12:40]),
        (ids[40:44], ids[78:82], None),
        ([], [], None),
        ([], [], ids[44:64]),
        ([], [], None),
    ]

    @phase("b_main_path")
    def _b():
        ops.reset_launches()
        for t, (evicts, admits, fed) in enumerate(schedule):
            for eng in engines.values():
                for sid in evicts:
                    eng.evict(sid)
                for sid in admits:
                    eng.admit(sid)
            live = engines["staged"].stream_ids
            assert live == engines["fused"].stream_ids
            feed = live if fed is None else [s for s in fed if s in live]
            rgb, _ = stream.batch(t, len(feed))
            frames = {sid: rgb[i] for i, sid in enumerate(feed)}
            held = [engines["staged"].slot_of(s) for s in live if s not in frames]
            before = engines["staged"].state.indices.clone()
            outs = {name: eng.step(frames) for name, eng in engines.items()}
            for sid in feed:
                a, b = outs["staged"][sid], outs["fused"][sid]
                assert a.shape == (cfg_s.n_classes,)
                assert torch.isfinite(torch.from_numpy(a)).all(), f"tick {t}: non-finite"
                assert (a == b).all(), f"tick {t} {sid}: staged and fused logits differ"
                ga, gb = engines["staged"].gaze(sid), engines["fused"].gaze(sid)
                assert (ga == gb).all(), f"tick {t} {sid}: gaze differs"
            after = engines["staged"].state.indices
            assert torch.equal(after[held], before[held]), f"tick {t}: a held slot moved"
        launches = dict(ops.LAUNCHES)
        for name, n in launches.items():
            kernels.setdefault(name, {})["launches"] = n
        report["main_path"] = {"ticks": len(schedule), "launches": launches}
        assert all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}"

    # ---- (ref) small input: kernel route on the card vs plain on the CPU --
    @phase("ref_small_input")
    def _ref():
        small_fe = FrontendConfig(image_h=64, image_w=64,
                                  patch=PatchSpec(16, 16, n_vectors=32), active_fraction=0.25)
        small = ViTConfig(frontend=small_fe, n_layers=2, d_model=64, n_heads=4,
                          d_ff=128, quant_embed=True)
        p_cpu = prepare_quant_embed(init_vit(small, torch.Generator().manual_seed(1),
                                             device="cpu"))
        p_gpu = tree_to(p_cpu, dev)
        rgb, _ = SceneStream(seed=3, image=64).batch(0, 8)
        x_cpu = torch.from_numpy(rgb)
        pf = ops.ip2_codes_fn(small_fe.patch, small_fe.adc)
        cf_cpu = fe.apply_frontend(p_cpu["ip2"], x_cpu, small_fe, project_fn=pf)
        cf_gpu = fe.apply_frontend(p_gpu["ip2"], x_cpu.to(dev), small_fe, project_fn=pf)
        assert torch.equal(cf_gpu.indices.cpu(), cf_cpu.indices), "selection differs"
        agree = (cf_gpu.features.cpu() == cf_cpu.features).all(-1).all(-1)
        assert int((~agree).sum()) <= 1, f"{int((~agree).sum())} slots with a moved code"
        l_cpu, a_cpu = vit_forward_compact(p_cpu, x_cpu, small, project_fn=pf)
        outs = {route: vit_forward_compact(p_gpu, x_cpu.to(dev), c, **kw) for route, c, kw in
                (("staged", small, {"project_fn": pf}),
                 ("fused", dataclasses.replace(small, fused_embed=True), {}))}
        report["ref_small_input"] = {"slots_with_moved_codes": int((~agree).sum())}
        for route, (l_gpu, a_gpu) in outs.items():
            assert l_gpu.shape == l_cpu.shape and torch.isfinite(l_gpu).all()
            err_l = (l_gpu.cpu() - l_cpu).abs()[agree].max()
            err_s = (a_gpu["saliency"].cpu() - a_cpu["saliency"]).abs()[agree].max()
            report["ref_small_input"][route] = {"max_logit_err": float(err_l),
                                                "max_saliency_err": float(err_s)}
            assert float(err_l) <= 1e-4 and float(err_s) <= 1e-4, report["ref_small_input"]
        assert torch.equal(outs["staged"][0], outs["fused"][0]), \
            "fused and staged differ on the card"

    # ---- (c) times -------------------------------------------------------
    @phase("c_times")
    def _c():
        rgb, _ = stream.batch(5000, CAPACITY)
        timing = {}
        for name, eng in engines.items():
            for sid in list(eng.stream_ids):
                eng.evict(sid)
            for i in range(CAPACITY):
                eng.admit(f"t{i}")
            frames = {f"t{i}": rgb[i] for i in range(CAPACITY)}
            for _ in range(3):
                eng.step(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 10
            for _ in range(n):
                eng.step(frames)
            ms = (time.perf_counter() - t0) * 1e3 / n
            timing[name] = {"tick_ms": ms, "stream_frames_per_s": CAPACITY / ms * 1e3}
        report["engine"] = timing
        print(json.dumps({"engine": timing}))

        codes = ops._ip2_project_cuda(gathered, w_t, zero_bias, p_codes)
        fp32_ops = 2.0 * r_rows * k_in * m
        int8_ops = 2.0 * r_rows * m * d
        rows = {
            "ip2_project": dict(
                replaces="src/repro/kernels/ip2_project.py:138",
                source="src/repro_torch/kernels/csrc/ip2_project.cu",
                kernel=lambda: ops._ip2_project_cuda(gathered, w_t, zero_bias, p_codes),
                plain=lambda: ref.ip2_project_ref(gathered, w_t, zero_bias, p_codes),
                library=lambda: torch.matmul(gathered, w_t),
                bytes=r_rows * k_in * 4 + k_in * m * 4 + r_rows * m,
                t_ops=fp32_ops / FP32_FLOPS),
            "quant_matmul": dict(
                replaces="src/repro/kernels/quant_matmul.py:55",
                source="src/repro_torch/kernels/csrc/quant_matmul.cu",
                kernel=lambda: ops._quant_matmul_cuda(codes, s_a, w8, s_w),
                plain=lambda: ref.quant_matmul_ref(codes, s_a, w8, s_w),
                library=lambda: torch._int_mm(codes, w8),
                bytes=r_rows * m + r_rows * 4 + m * d + d * 4 + r_rows * d * 4,
                t_ops=int8_ops / INT8_OPS),
            "ip2_fused_embed": dict(
                replaces="src/repro/kernels/ip2_megakernel.py:251",
                source="src/repro_torch/kernels/csrc/ip2_fused_embed.cu",
                kernel=lambda: ops._fused_embed_cuda(
                    table, counts, flat_p, w_t, w8, s_w, adc.lsb, p_codes, fcfg.n_active),
                plain=fused_plain,
                library=None,
                # the gathered rows this run's selection needs, read once
                bytes=(r_rows * k_in * 4 + r_rows * 4 + CAPACITY * 4 + k_in * m * 4
                       + m * d + d * 4 + r_rows * d * 4),
                t_ops=fp32_ops / FP32_FLOPS + int8_ops / INT8_OPS),
        }
        for name, row in rows.items():
            n_launch = kernels.get(name, {}).get("launches", 0)
            ms = _time_ms(row["kernel"])
            plain_ms = _time_ms(row["plain"])
            lib_ms = _time_ms(row["library"]) if row["library"] else None
            bound_ms, bound_by = _bound(row["bytes"], row["t_ops"])
            kernels.setdefault(name, {}).update(
                name=name, route="cuda", source=row["source"], replaces=row["replaces"],
                launches=n_launch, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)

    # ---- where the device time goes in the engine's tick ------------------
    @phase("profile")
    def _prof():
        from torch.profiler import ProfilerActivity, profile

        def dev_us(e):
            return getattr(e, "self_device_time_total", 0) or getattr(
                e, "self_cuda_time_total", 0)

        rgb, _ = stream.batch(6000, CAPACITY)
        frames = {f"t{i}": rgb[i] for i in range(CAPACITY)}
        with profile(activities=[ProfilerActivity.CUDA]):   # start-up cost, not timed
            engines["staged"].step(frames)
        out = {}
        n = 3
        for name, eng in engines.items():
            eng.step(frames)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    eng.step(frames)
                torch.cuda.synchronize()
            # device activities only: an aten:: op's self device time is its
            # kernels' time again, and the buffer request is the profiler's own
            evs = [e for e in prof.key_averages()
                   if dev_us(e) > 0 and not e.key.startswith("aten::")
                   and e.key != "Activity Buffer Request"]
            dev_ms = sum(dev_us(e) for e in evs) / 1e3 / n
            tick_ms = report.get("engine", {}).get(name, {}).get("tick_ms")
            out[name] = {
                "device_ms_per_tick": dev_ms if evs else None,
                # against the un-profiled tick time of phase (c)
                "device_busy_share": dev_ms / tick_ms if evs and tick_ms else None,
                "top_ms_per_tick": {e.key[:90]: dev_us(e) / 1e3 / n for e in
                                    sorted(evs, key=dev_us, reverse=True)[:10]},
            }
        report["profile"] = out

    report["kernels"] = [kernels[n] for n in ("ip2_project", "quant_matmul", "ip2_fused_embed")]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row.get(k) for k in keys} for row in report["kernels"]]}))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e!r}"
    report["nvidia_smi"] = smi
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(smi)
    if failures:
        _fail("FAILED phases: " + "; ".join(failures))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
