#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py [--out DIR]

Runs from the repository root (it finds the port under ``src/``) and needs
one CUDA device. Phases, any failure exits non-zero:

  build  compile the five CUDA sources from ``src/repro_torch/kernels/csrc``
         into ``build/`` (one nvcc per source, in parallel).
  (a)    each kernel against its plain PyTorch version on the card, at the
         serving path's shapes, through the public ops wrappers:
         quant_matmul bitwise; ip2_project's ADC codes and other readouts
         within 1 step on at most 1% of rows, and its 10- and 20-bit codes
         (int16, int32) bitwise equal to the ADC on its own analog output;
         ip2_fused_embed bitwise equal to ip2_project -> quant_matmul; the
         sparse projection bitwise ip2_project on the gathered rows; the
         ragged one with counts 0, partial and full per slot bitwise the
         same below the count and 0 past it, and within 1 LSB on at most
         1% of rows of its plain version; delta_attention within 1e-5 of
         its plain version, 0 past the counts, also with counts below 0
         and above S, a slot with no valid key, and S 40. Then the int16
         codes of a 10- and a 16-bit ADC and the int32 codes of a 24-bit
         one: the fused and the staged route bitwise equal to each other,
         quant_matmul bitwise its plain version, the fused kernel bitwise
         its plain version on rows whose codes agree; and at 10 and 16 bits
         the codes of kernels 6 and 4 (the latter through its embed of the
         identity) at most 1 LSB from the plain projection's, on at most
         0.1 % (10 bits) or 1 % (16 bits) of the codes.
  (b)    the main paths, each with the launch counts reset just before and
         read just after, on 12 ticks of admit / evict / partial-fed churn
         at ip2-vit width (256x256 frames, 32x32 patches, M=192, 6 layers,
         d_model 256) and capacity 64, seeded parameters and SceneStream
         frames:
         - plain mode: a SaccadeEngine on the staged kernel route and one
           on the fused kernel; logits and gaze bitwise equal, logits
           finite, held slots frozen, each of their kernels launched;
         - the gated engine (temporal gate j=8 of k=16, power governor at
           half the fleet mW the ungoverned engine meters, delta-gated
           backend with the ragged attention kernel): ip2_ragged once per
           tick, delta_attention 5 times per computed tick, some slot
           ragged (0 < count < rows) for both, held slots frozen; and in
           the exact backend regime (eps 0) the engine with the kernel and
           the same engine with dense attention (delta_kernel=False) agree:
           logits within 1e-5 every tick, integer state equal.
  (a')   after (b), the projection tiles at awkward shapes (R off the row
         tiles, M = 100 off the column tile, K = 1000 off the K step; and
         K = 250, M = 30, which take the 4-byte copies): ip2_project's
         codes through quant_matmul and the sparse kernel's codes equal
         ip2_fused_embed bit for bit; the ragged kernel's codes through
         the same embed equal ip2_fused_embed with the same counts (all
         zero, all full, one slot full, the gated path's counts, and
         counts below 0 and above k handed to the kernel unclipped),
         zeros past the counts. Fused and staged share one projection
         tile, so the oracle independent of it is a sha256 of
         ip2_fused_embed's output at the serving shape and at each (a')
         shape and count pattern, printed as one JSON line: a run of this
         script over another version of the kernels must print the same.
  (ref)  small inputs through the kernel route on the card and the plain
         route on the CPU: same indices, logits and saliency within 1e-4
         on every slot whose codes agree; the same for the gated engine.
  (c)    times after warm-up: per-tick engine ms and stream-frames/s (plain
         routes and the gated engine); for each kernel, ms by CUDA events
         around 30 back-to-back wrapper calls (host-paced when the kernel
         is shorter than the wrapper's host work) and device_ms from the
         profiler's kernel events over 30 calls, beside its plain
         version's ms, a PyTorch yardstick call's ms and device_ms (never
         used by the port) and its bound; for ip2_fused_embed, which has
         no PyTorch yardstick, staged_device_ms, the device time of the
         staged pair (ip2_project and quant_matmul) on the same operands,
         and how its clusters sit on the card.
  (d)    device rollouts: the staged, fused, gated and sign-tier-governed
         engines at the same width and 64 slots, each a twin pair: 8 ticks
         of the reference's partial-fed pattern (a third of the streams fed
         every tick, a third every other tick, a third once, one tick with
         none) as one step_rollout against 8 step() calls, logits and every
         state leaf bitwise; then 8 more on warm state after churn, both
         block=False paths run under torch.cuda.set_sync_debug_mode("error")
         from the call until the handle returns (the one exemption: the
         host wait on a staging buffer whose previous upload is in flight,
         run with the check off and counted). The sign-tier budget puts
         half the slots below the finest tier's floor, and some slot must
         read out signs on some tick. Launch counts are reset before each
         rollout and read after it. Two engines issued before either result
         is fetched must equal two served one after the other.
  (e)    on the staged and gated engines at 64 fed streams: ticks/s of
         step(), of step_rollout at T 1, 4, 16 and 64, the host return time
         of step(block=False) beside its tick time, the device busy share of
         a T = 16 rollout (union of the profiler's device intervals over
         wall time), and the 50 MB frame upload alone, pageable against
         page-locked.
  (f)    dense mode, the float and sign wires and the float simulation at
         the same width on 64 frames (``wires_dense_phase``), launch counts
         reset before the kernel routes and read after them: dense
         ``apply_frontend`` through kernel 6 with no ADC (4096 rows), the
         compact sign wire (kernel 6's comparator) and float wire, and 12
         gated ticks of ``vit_forward_compact`` on each of the two wires
         with a per-slot recompute cap (kernel 2's no-ADC and sign readouts
         at the n_stale counts). Each
         against its plain route: bits, codes and float readouts within 1
         LSB on at most 1 % of rows; the float wire dequantised bitwise the
         code wire on the plain route; ``quant_embed`` on and off bitwise
         equal on the sign wire; ``ops.quant_matmul`` bitwise its plain
         version; ``vit_forward`` against ``vit_forward_compact`` for the
         same selection within 1e-4, saliency zero off the mask; the float
         simulation (``analog=False``) finite, and card against CPU on a
         small input within 1e-4. Then host and device ms of the dense and
         the two compact forwards. (Phase c times kernel 6's no-ADC readout
         at the dense shape, 4096 x 1024 x 192, beside its bound and
         ``torch.matmul``.)
  (g)    conv-in-pixel mode, QTH attention and the paper's figures
         (``conv_phase``, then the engines): ``ops.ip2_conv`` on 4 seeded
         1080 x 1920 frames (the 2 Mpix sensor at 1080p) at K 8, C 16 and
         strides 8 and 4, float, 8-bit code and sign readouts through kernel
         6, each against its plain route (float within 1e-5; codes and bits
         within 1 LSB on at most 1 % of rows), a 64 x 64 crop against the
         Python-loop oracle, ``conv_frame_events`` per frame, and kernel 6's
         times at both conv shapes beside the gather's, the bound and
         ``torch.matmul``. Then ``ViTConfig(qth=True)`` at the width of (b)
         in the staged engine (kernels 6 and 5 every tick) and the gated one
         (kernel 2 every tick, kernel 5 on computed ticks, delta_attention
         never: qth excludes it), 12 ticks of churn each with the counts
         reset before and read after, logits finite, held slots frozen; card
         against CPU on a small input (1e-4 on slots whose codes agree); the
         QTH weights' factor-2 flips card against CPU; tick times beside
         the softmax engines of (c). Last the paper's figures from the port
         (sensor-model outputs, no device work) and the quickstart example
         on the card.
  (h)    co-design training on the card (``train_phase``): the 100m preset
         of ``repro_torch.examples.train_ip2_classifier`` at full width
         (256x256 frames, 32x32 patches, M 400, 12 layers, d_model 768)
         through ``Trainer`` for 12 steps at batch 64 with checkpoints
         every 4 steps, then again failing at step 6 and resumed: final
         parameters and AdamW state bitwise the uninterrupted run's, every
         loss finite, no kernel launched by training; median step ms,
         tokens/s, 6*N*D over step time as a share of the fp32 peak, peak
         device memory. One cpu-small step on the card against the CPU
         (gradients within 1e-4 of each leaf's largest |g|, updated
         weights within 1e-5 plus what each element's gradient difference
         moves AdamW's first step by; the card's AdamW on the CPU's
         gradients within 1e-5). bench_accuracy's
         arm B: its config trained 220 steps at batch 32, then on 6
         held-out batches the dense oracle (> 0.5), the code wire on the
         plain route, the staged kernel route (kernels 6 and 5: codes
         within 1 LSB on at most 1 % of rows, accuracy within 0.05 of the
         oracle) and the delta-gated serve at eps 0 over 4 drift frames
         (kernels 2, 3 and 5: accuracy at least the code wire's - 0.08),
         launch counts reset before each served route and read after it,
         and every kernel result of each served route held against the
         kernel's plain version on its inputs (codes within 1 LSB on at
         most 1 % of live rows, attention within 1e-5, embed bitwise).
         The 12-step 100m weights served on the staged kernel route
         against the plain route on the CPU (codes within 1 LSB on at most
         1 % of rows, logits within 1e-4 on slots whose codes agree), and
         kernels 6 and 5 timed at that width (1024 x 1024 x 400; K 400).
         The CNN baseline on the same batches: its held-out accuracy
         beside the ViT's (printed, not gated). A 100m step is also broken
         down: device time by kernel name, busy share, and the host clock
         of autograd and of the AdamW update.
  (i)    the fleet, then LM serving (``fleet_phase``, ``lm_phase``). A
         ``SaccadeFleet`` of 4 hosts x 16 slots of (b)'s engine on the one
         card, once on the staged route (kernels 6 + 5) and once gated
         (the gate and delta backend of (b), a fleet governor at half the
         mW an ungoverned fleet meters: kernels 2 + 3 + 5): 72 streams
         submitted in the four priority classes for 64 slots, churn
         between ticks, frame periods of 1, 2 and 4 ticks, 12 ticks by
         ``step`` and 12 by ``step_rollout``, the launch counts reset
         before each fleet call and read after it. Each host's logits
         bitwise a standalone 16-slot engine's given the same admits,
         frames and budget share (the rollout against the engines' step
         loops); fleet -> host -> slot budgets summing to rel 1e-5; a
         slack fleet budget bitwise an ungoverned fleet; logits within
         1e-5 of one 64-slot engine on the streams whose codes agree (at
         least 80 %); every kernel result of both routes against its plain
         version (``_recording``, ``_hold_served``). Then, all 64 streams
         fed, the fleet's and the 64-slot engine's tick split into
         dispatch and fetch, and their device busy share. The LM part:
         smollm-135m at full width and depth (30 layers, d_model 576, 9 Q
         / 3 KV heads, vocab 49 152, tied embeddings) with seeded weights,
         batch 8, a 128-token prompt from ``TokenStream``, 64 greedy
         decode steps with each cache dtype: decode == forward within
         2e-4 (float32 cache) and within ``LM_CACHE_REL_BOUND`` of the
         logit scale (bf16, int8); prefill ms, decode ms per step,
         tokens/s, peak memory, a decode step's busy share. The card
         against the CPU at 2 of the 30 layers (1e-4). recurrentgemma (a
         6-token window, wrapped), xlstm, the qwen3 MoE (dropless; at a
         binding capacity the card drops the CPU's (token, expert)
         pairs), whisper and pixtral with the IP2 frontend at their smoke
         configs: decode == forward within 2e-4. No kernel launches in
         the LM part: the LM stack reaches no Pallas kernel in the
         reference either.
  (j)    the gated step forms, LM training and the caches at long context
         (``gated_steps_phase``, ``lm_train_phase``, ``long_context_phase``).
         j1: ``make_saccade_step``'s ``step_temporal_backend`` and
         ``step_temporal`` at the width of (b), 64 streams, 12 frames of
         scenes that change every 4 frames, the staged kernel route (gate
         j = 8 of 16, delta backend with kernel 3, no governor), launch
         counts reset before each form and read after: kernels 2 / 3 / 5
         launched 1 / 5 / 1 times a frame (1 / 0 / 1 for step_temporal).
         Each form against a ``SaccadeEngine`` of its mode with every slot
         fed every tick: logits within 1e-5, next indices, n_stale and the
         caches' integer leaves equal; every kernel result held against its
         plain version (``_hold_served``); a small input card vs CPU within
         1e-4 on slots whose codes agree; ms per frame. j2: smollm-135m
         training at full width and depth from seeded weights, batch 8 x
         seq 512 ``TokenStream`` tokens, bf16 compute, AdamW, 8 steps of
         ``Trainer`` with remat off, "nothing" and "dots": losses finite
         and falling, step ms, tokens/s, peak memory, one step's device
         time, busy share and launches; interrupted at step 6 and resumed
         bitwise; a float32 gradient card vs CPU at 2 layers (1e-4 of each
         leaf's largest |g|); microbatches 4 vs 1 (loss rel 1e-5, gradients
         1e-5 of each leaf's largest); no kernel launched. j3: smollm
         decode at batch 8 with bf16 and int8 caches of 8192 prefilled
         positions (decode == forward within ``LM_CACHE_REL_BOUND``) and of
         32 768 seeded positions: decode ms per step, peak memory above the
         resident state and bytes allocated per step (at most
         ``CACHE_ALLOC_BOUND`` times the caches' elements at bf16 width);
         the cache contraction on one layer against float32 (within the
         worst case of a float32 sum of its terms);
         ``_write_slot`` alone.
  (k)    the distributed layer (``distributed_phase``) in a NCCL process
         group of world size 1 (it prints the world size, the NCCL version,
         the device count and nvidia-smi's name and power limit; NCCL not
         starting fails the phase). k1: smollm-135m at full width, batch 8
         x 512, bf16 compute, 3 steps as ``DTensor``s on a (1, 1) ("data",
         "model") ``DeviceMesh`` (``plan_for``, ``shardings_for``,
         ``constrainer_ctx``) against the plain step: losses within 2e-4,
         parameters within 5e-5; step ms and device launches a step for
         both. k2: ``pipeline_forward`` over the 30 layers as one stage with
         8 microbatches against the layers in turn (1e-6), ``apply_moe_a2a``
         against ``apply_moe`` (qwen3-moe smoke config; 1e-5, aux 1e-6), a
         compressed all-reduce of the full gradient tree against
         ``quantize_ef``'s codes (bitwise). k3: the slot-sharded staged
         (kernels 6 + 5) and gated (2 + 3 + 5) engines at the width of (b),
         64 slots, 12 ticks, on a ``LocalMesh`` of the card 4 times and
         once, against the unsharded engine (logits within 1e-5, gaze and
         n_stale equal), each kernel result of every shard held against its
         plain version, launches a tick (the kernel table's
         ``sharded_launches``: counts reset before each 4-shard run, read
         after) and tick ms; capacity 62 unsharded; a fleet of 2 hosts over
         ``make_fleet_meshes(2, devices=[card] * 4)``. k4: k1's ``DTensor``
         state saved, restored onto ``Replicate`` and ``Shard(0)``, and a
         CPU-saved checkpoint restored onto the mesh, bytes equal.
  (l)    kernel 4 past its one-chunk code tile, then the dry run on fake
         ranks (``fused_past_tile_phase``, ``dryrun_l2_phase``,
         ``estimate_phase``). l1: ``ip2_fused_embed`` at M 2560 (int8 codes),
         1280 (int16) and 640 (int32), just past each width's one-chunk code
         tile, and M 5000 (int8, 3 chunks), on 64 slots x 16 of 64 patches of
         32 x 32 pixels with ragged counts: bitwise the staged kernels
         (``ip2_project`` -> ``quant_matmul``) and bitwise its plain version
         on the rows whose codes agree, with its device time beside the staged
         pair's; and phase a''s ``fused_sha256`` equal to ``FUSED_SHA256``,
         the hashes the one-chunk kernel printed. l2: ``run_cell("llama3-8b",
         "train_4k", "single")`` on 256 fake ranks with its roofline points
         (its memory, microbatches, bottleneck and seconds printed). l3: the
         dry run of smollm-135m at mesh (1, 1) (batch 8 x 512, bf16 compute,
         remat "nothing", phase j2's setup) against one real step on the card:
         its peak above the arguments within 10 % of ``max_memory_allocated``
         above the bytes resident before the step, its flops equal to a
         ``FlopCounterMode`` count of the real step. The launch counts are
         reset before l2 and l3 and read after: the dry run reaches no kernel.

Prints the kernel table as one JSON line, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. With ``--out DIR``
the full report (phases, compiler register reports, profile) is also
written to ``DIR/chip_smoke.json``.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import io
import json
import shutil
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

CAPACITY = 64
# the kernel table's rows, numbered as in ROADMAP.md's kernel queue
KERNELS = ("ip2_project_sparse", "ip2_ragged", "delta_attention", "ip2_fused_embed",
           "quant_matmul", "ip2_project")
# bound on the share of codes a 1-LSB move may touch between a projection
# kernel and the plain projection (fp32 sums on an ADC rounding boundary)
LSB_MOVES = {10: 0.001, 16: 0.01}
# ip2_fused_embed's output at the fixed inputs of phases a and a' (sha256),
# as the one-chunk kernel printed them: a run must print the same
FUSED_SHA256 = {
    "serving": "3d1940558e359a7c8820cd6db9d074193914ea807d4dcae0a749c9244d009096",
    "K1000_M100": "347a101e3b178b53da00e942efe59b251b74178a7ed66559aafaccc4af528349",
    "K1000_M100_zero": "9b54dfbc92b4baf804aa3b0360cbc32e4d9ebe32c974c5131c52e3f375d3e25e",
    "K1000_M100_full": "347a101e3b178b53da00e942efe59b251b74178a7ed66559aafaccc4af528349",
    "K1000_M100_one_full": "6ba068f7c2d733291f8ddf7c8f11e82ac661f8a246e05dcbdc7f0b29d499ce77",
    "K1000_M100_gated": "ef25fe4afd949f5e4b071c625f6995bd312b982a4b35612a70b1409ac64e3185",
    "K1000_M100_clipped": "b9e13ab3948d80414452f6c8720150969cac894af7a8bdc7b09b03b395daaeb5",
    "K250_M30": "23fefc9539ede8d5bcc9735cfbd2c8d7d35c95bba8edb2b9b74d84f5f6068c6e",
    "K250_M30_zero": "9b54dfbc92b4baf804aa3b0360cbc32e4d9ebe32c974c5131c52e3f375d3e25e",
    "K250_M30_full": "23fefc9539ede8d5bcc9735cfbd2c8d7d35c95bba8edb2b9b74d84f5f6068c6e",
    "K250_M30_one_full": "52c358962e6b764662ec2315ef1c74cd0ef0f1b496823aea0472d351c2eee52e",
    "K250_M30_gated": "d370b7c5e1daf4e1f4f99628461fcceb0d3e20eb9f469d1d63dc102969ef2707",
    "K250_M30_clipped": "e7ba63f08fd6752d2637b179048befb89c98d768081566ffc01777e57feb2cfd",
}
# the dry run's peak above its arguments against the card's, phase l3
ESTIMATE_PEAK_REL = 0.10
# decode with a bf16 or int8 KV cache against the float32 forward, as a
# share of the largest |logit|: the reference's own bound for its int8 cache
LM_CACHE_REL_BOUND = 0.015


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


PREROLL_LOST = []   # per _device_ms window: pre-roll fills lost (None: the mark too)


def _device_ms(fn, kernel=None, n=30, warm=5, tries=4):
    """Device time per call from the profiler's CUDA events over ``n``
    calls: for a ``kernel`` (one launch per call), the mean duration of the
    events whose name holds it; else every device event's duration, summed
    and divided by ``n``. Host work between the calls does not count, as it
    does in ``_time_ms``.

    Three faults of the profiler on the H100 shape the window. It loses the
    first device events of a window, most often none to 6 but now and then
    dozens; its device timestamps can sit hundreds of microseconds off its
    host ones, so a host-side range does not select device events; and now
    and then it drops more of a window. So each window opens with at least
    32 one-element fills over at least 2 ms, then ATen's ``spin_kernel``
    (``torch.cuda._sleep``) and a synchronise as a mark on the device's own
    clock, and only the device events that start after the mark count
    (``PREROLL_LOST`` gets the fills each window lost, None where it lost
    the mark too). A window that lost its mark is profiled again. A kernel
    window must hold exactly ``n`` of the kernel's events; a window of all
    events counts once the window before it held as many. Else it is
    profiled again, up to ``tries`` windows."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        evs = _marked_events(fn, n)
        if evs is None:
            seen.append(None)
            continue
        evs = [e for e in evs if kernel is None or kernel in e.name]
        seen.append(len(evs))
        us = sum(e.time_range.elapsed_us() for e in evs)
        if kernel is not None and len(evs) == n:
            return us / 1e3 / n
        if kernel is None and evs and seen[-2:] == [len(evs)] * 2:
            return us / 1e3 / n
    raise AssertionError(f"{kernel or 'device'} events per window of {n} calls "
                         f"(None: the window lost its mark): {seen}")


def _marked_events(fn, n):
    """One profiler window of ``n`` calls of ``fn`` after the pre-roll and
    the device-clock mark of ``_device_ms``: the CUDA events that start
    after the mark, or None where the window lost its mark."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pad = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fills, t_end = 0, time.perf_counter() + 2e-3
        while fills < 32 or time.perf_counter() < t_end:
            pad.zero_()
            fills += 1
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mark = [e.time_range for e in evs if "spin_kernel" in e.name]
    if len(mark) != 1:
        PREROLL_LOST.append(None)
        return None
    PREROLL_LOST.append(fills - sum(1 for e in evs if e.time_range.start < mark[0].start))
    return [e for e in evs if e.time_range.start >= mark[0].end]


def _device_by_name(fn, tries=4):
    """Device time of one call of ``fn`` by kernel name, from a marked
    profiler window: ``[(kernel name, ms, launches), ...]``, largest first."""
    for _ in range(tries):
        evs = _marked_events(fn, 1)
        if evs:
            by = {}
            for e in evs:
                ms, k = by.get(e.name, (0.0, 0))
                by[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
            return sorted(((n, ms, k) for n, (ms, k) in by.items()), key=lambda t: -t[1])
    raise AssertionError("every profiler window of the step lost its mark")


def _sha(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _bound(n_bytes, fp32_flops=0.0, int8_ops=0.0):
    """(bound ms, "bytes" or "operations") from the port's H100 roofline."""
    from repro_torch.roofline.analysis import kernel_bound
    t, by = kernel_bound(n_bytes, fp32_flops, int8_ops)
    return t * 1e3, by


def _flip_rows(a, b, rows_per_call):
    """Rows whose integer codes differ, asserting at most 1 LSB on at most
    1 % of the rows."""
    d = (a.reshape(-1, a.shape[-1]).int() - b.reshape(-1, b.shape[-1]).int()).abs()
    flips = int((d.amax(-1) > 0).sum())
    assert int(d.max()) <= 1, f"codes differ by {int(d.max())} LSB"
    assert flips <= rows_per_call // 100, f"{flips} rows moved by 1 LSB"
    return int(d.max()), flips


def _host_ms(fn, n=10, warm=3):
    """Host clock per call over ``n`` back-to-back calls ending in a
    synchronise (what a caller waits for, host work included)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _moved_rows(a, b, lsb):
    """Rows of two payloads that differ: codes by at most 1 LSB, sign bits
    in any bit, float readouts by at most 1 LSB (a code that moved).
    Returns (rows moved, largest difference)."""
    import torch
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    if a.dtype == torch.bool:
        return int((a != b).any(-1).sum()), int((a != b).any())
    d = (a.double() - b.double()).abs().amax(-1)
    bound = 1 if not a.is_floating_point() else lsb + 1e-6
    assert float(d.max()) <= bound, f"a row moved by {float(d.max())} (> 1 LSB)"
    return int((d > 0).sum()), float(d.max())


def wires_dense_phase(dev, params, cfg, cfg_g, small, rgb, pool, out, ticks=12):
    """Phase f_wires_dense: dense mode, the compact float and sign wires,
    the gated float and sign wires, and the float simulation, at the width
    of ``cfg`` on the frames ``rgb`` (gated: ``pool``, each stream's scene
    changing every 4 ticks). The kernel routes run with the launch counts
    reset just before and read just after; each is then held against its
    plain route: codes, bits and float readouts within 1 LSB on at most 1 %
    of rows, and bitwise where the arithmetic is the same. Fills the
    phase's report into ``out`` as it goes."""
    import numpy as np
    import torch
    from repro_torch.convert import tree_to
    from repro_torch.core import frontend as fe
    from repro_torch.core import saliency as sal
    from repro_torch.core.temporal import init_feature_cache
    from repro_torch.kernels import ops, ref
    from repro_torch.models.vit import init_vit, vit_forward, vit_forward_compact

    fcfg, fcfg_g = cfg.frontend, cfg_g.frontend
    lsb, k, n = fcfg.adc.lsb, fcfg.n_active, rgb.shape[0]
    j = fcfg_g.temporal.budget(k)
    x = torch.from_numpy(rgb).to(dev)
    pf = {"float": ops.ip2_project_fn(fcfg.patch), "sign": ops.ip2_sign_fn(fcfg.patch),
          "codes": ops.ip2_codes_fn(fcfg.patch, fcfg.adc)}
    pf_g = {"float": ops.ip2_project_fn(fcfg_g.patch), "sign": ops.ip2_sign_fn(fcfg_g.patch)}
    cache_dt = {"float": torch.float32, "sign": torch.bool}
    cfg_fp = dataclasses.replace(cfg, quant_embed=False)
    patches, _ = fe.sensor_patches(params["ip2"], x, fcfg)
    idx = sal.topk_patch_indices(sal.patch_energy(patches), k)
    mask = sal.mask_from_indices(idx, fcfg.n_patches)
    # the gated clip: frames and the (route-independent) selection per tick
    clip = []
    for t in range(ticks):
        xt = torch.from_numpy(np.stack([pool[(i + t // 4) % len(pool)]
                                        for i in range(n)])).to(dev)
        pt, _ = fe.sensor_patches(params["ip2"], xt, fcfg_g)
        clip.append((xt, sal.topk_patch_indices(sal.patch_energy(pt), k)))

    # a governor-like recompute allocation per slot, so the counts are ragged
    stale_cap = torch.tensor([(j, j // 2, 3, 1)[i % 4] for i in range(n)],
                             dtype=torch.int32, device=dev)

    def gated(wire, fn):
        cache = init_feature_cache(fcfg_g, (n,), dtype=cache_dt[wire], device=dev)
        hist = []
        for xt, it in clip:
            logits, aux = vit_forward_compact(params, xt, cfg_g, indices=it, wire=wire,
                                              project_fn=fn, cache=cache,
                                              stale_cap=stale_cap)
            cache = aux["cache"]
            hist.append((logits, cache.features, aux["n_stale"]))
        return hist

    def compact(wire, fn):
        return fe.apply_frontend(params["ip2"], x, fcfg, mode="compact", wire=wire,
                                 indices=idx, project_fn=fn)

    # ---- the path through the kernels, counted
    ops.reset_launches()
    dense_k, mask_k = fe.apply_frontend(params["ip2"], x, fcfg, mode="dense", indices=idx,
                                        project_fn=pf["float"])
    cf_k = {w: compact(w, pf[w]) for w in ("float", "sign", "codes")}
    logits_k = {w: vit_forward_compact(params, x, cfg, indices=idx, wire=w,
                                       project_fn=pf[w])[0] for w in ("float", "sign")}
    gated_k = {w: gated(w, pf_g[w]) for w in ("float", "sign")}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    out.update(frames=n, ticks=ticks, launches=launches)
    assert launches["ip2_project"] == 6, launches    # dense, 3 compact, 2 forwards
    assert launches["ip2_ragged"] == 2 * ticks, launches
    assert all(launches[m] == 0 for m in ("ip2_fused_embed", "ip2_project_sparse",
                                           "quant_matmul", "delta_attention")), launches

    # 1. dense: kernel 6 with no ADC against the plain projection
    dense_p, mask_p = fe.apply_frontend(params["ip2"], x, fcfg, mode="dense", indices=idx)
    assert torch.equal(mask_k, mask_p) and torch.equal(mask_k, mask)
    assert dense_k.shape == (n, fcfg.n_patches, fcfg.patch.n_vectors)
    assert not dense_k[~mask_k].any(), "a deselected patch carries features"
    rows = dense_k.numel() // dense_k.shape[-1]
    moved, worst = _moved_rows(dense_k, dense_p, lsb)
    out["dense"] = {"rows": rows, "rows_moved": moved, "max_abs_diff": worst}
    assert moved <= rows // 100, out["dense"]

    # 2. the compact sign wire: bits of kernel 6's comparator against the plain one
    cf_p = {w: compact(w, None) for w in ("float", "sign", "codes")}
    rows_c = n * k
    moved, _ = _moved_rows(cf_k["sign"].features, cf_p["sign"].features, lsb)
    out["sign"] = {"rows": rows_c, "rows_moved": moved}
    assert cf_k["sign"].features.dtype == torch.bool and moved <= rows_c // 100, out["sign"]
    lq = vit_forward_compact(params, x, cfg_fp, indices=idx, wire="sign",
                             project_fn=pf["sign"])[0]
    assert torch.equal(lq, logits_k["sign"]), "quant_embed moved the sign wire's logits"
    assert torch.isfinite(logits_k["sign"]).all()

    # 3. the float wire: kernel route against the code route, dequantised;
    # on the plain route bitwise the dequantised codes
    deq = {w: fe.dequantize_features(cf_k[w]) for w in ("float", "codes")}
    moved, worst = _moved_rows(deq["float"], deq["codes"], lsb)
    out["float"] = {"rows": rows_c, "rows_moved": moved, "max_abs_diff": worst}
    assert moved <= rows_c // 100, out["float"]
    assert torch.equal(fe.dequantize_features(cf_p["float"]),
                       fe.dequantize_features(cf_p["codes"])), "float wire != codes (plain)"
    assert torch.isfinite(logits_k["float"]).all()
    # ops.quant_matmul (host-quantised activations, then kernel 5) on the
    # float readouts: bitwise its plain version
    a = deq["float"].reshape(-1, deq["float"].shape[-1])
    w8, s_w = params["embed_q"]
    ops.reset_launches()
    y = ops.quant_matmul(a, w8, s_w)
    assert ops.LAUNCHES["quant_matmul"] == 1
    assert torch.equal(y, ref.quant_matmul_ref(*ref.quantize_activations_ref(a), w8, s_w)), \
        "ops.quant_matmul differs from its plain version"

    # 4. the gated wires: kernel 2's no-ADC and sign readouts at the n_stale
    # counts against the plain projector, tick by tick
    out["gated"] = {}
    for w in ("float", "sign"):
        plain = gated(w, None)
        worst_rows, worst_logit = 0, 0.0
        for t, ((lk, fk, sk), (lp, fp, sp)) in enumerate(zip(gated_k[w], plain)):
            assert torch.equal(sk, sp), f"{w} tick {t}: n_stale differs between routes"
            moved, _ = _moved_rows(fk, fp, lsb)
            worst_rows = max(worst_rows, moved)
            worst_logit = max(worst_logit, float((lk - lp).abs().max()))
            assert moved <= fk.numel() // fk.shape[-1] // 100, f"{w} tick {t}: {moved} rows"
            assert torch.isfinite(lk).all()
        n_stale = torch.stack([h[2] for h in plain]).float()
        out["gated"][w] = {"cache_rows": n * fcfg_g.n_patches, "max_rows_moved": worst_rows,
                           "max_logit_diff": worst_logit,
                           "mean_n_stale": float(n_stale.mean()),
                           "ragged_slot_ticks": int(((n_stale > 0) & (n_stale < j)).sum())}
    assert any(g["ragged_slot_ticks"] > 0 for g in out["gated"].values()), out["gated"]

    # 5. dense against compact for the same selection (code wire). The two
    # project different row sets (4096 rows, or the 1024 selected), so an
    # fp32 sum on an ADC boundary may move a code between them: logits are
    # held on the slots whose served features agree
    ld, ad = vit_forward(params, x, cfg_fp, mask=mask, return_aux=True)
    lc, ac = vit_forward_compact(params, x, cfg_fp, mask=mask)
    dense_p, _ = fe.apply_frontend(params["ip2"], x, fcfg, mode="dense", mask=mask)
    cf_m = fe.apply_frontend(params["ip2"], x, fcfg, mode="compact", mask=mask)
    served = fe.dequantize_features(cf_m)
    moved, _ = _moved_rows(sal.gather_patches(dense_p, cf_m.indices), served, lsb)
    agree = (sal.gather_patches(dense_p, cf_m.indices) == served).all(-1).all(-1)
    err = float((ld - lc).abs()[agree].max())
    out["dense_vs_compact"] = {"rows_moved": moved, "slots_agreeing": int(agree.sum()),
                               "max_logit_err": err, "max_abs_logit": float(ld.abs().max()),
                               "max_logit_err_all_slots": float((ld - lc).abs().max())}
    assert moved <= rows_c // 100 and int(agree.sum()) >= n - rows_c // 100, \
        out["dense_vs_compact"]
    assert err <= 1e-4, f"dense and compact logits differ by {err}"
    for s_ in (ad["saliency"], ac["saliency"]):
        assert (s_[~mask] == 0).all() and (s_[mask] > 0).all(), "saliency off the mask"

    # 6. the float simulation: finite at full width; card against CPU small
    cfg_sim = dataclasses.replace(cfg_fp, frontend=dataclasses.replace(fcfg, analog=False))
    for name, l_ in (("dense", vit_forward(params, x, cfg_sim)),
                     ("compact", vit_forward_compact(params, x, cfg_sim)[0])):
        assert l_.shape == (n, cfg.n_classes) and torch.isfinite(l_).all(), name
    small_sim = dataclasses.replace(small, quant_embed=False, frontend=dataclasses.replace(
        small.frontend, analog=False))
    p_cpu = init_vit(small_sim, torch.Generator().manual_seed(1), device="cpu")
    p_dev = tree_to(p_cpu, dev)
    step = rgb.shape[1] // small.frontend.image_h
    xs = torch.from_numpy(np.ascontiguousarray(rgb[:8, ::step, ::step]))
    out["float_sim_small"] = {}
    for name, f_ in (("dense", lambda p, xx: vit_forward(p, xx, small_sim)),
                     ("compact", lambda p, xx: vit_forward_compact(p, xx, small_sim)[0])):
        e = float((f_(p_dev, xs.to(dev)).cpu() - f_(p_cpu, xs)).abs().max())
        out["float_sim_small"][name] = e
        assert e <= 1e-4, f"float simulation, {name}: card and CPU differ by {e}"

    # 7. times of the forwards at this width (kernel 6's no-ADC readout at
    # the dense shape is timed in phase c, beside the other kernels)
    fwd = {
        "dense_vit_forward": lambda: vit_forward(params, x, cfg_fp),
        "compact_sign_kernel": lambda: vit_forward_compact(params, x, cfg, wire="sign",
                                                           project_fn=pf["sign"]),
        "compact_float_kernel": lambda: vit_forward_compact(params, x, cfg, wire="float",
                                                            project_fn=pf["float"]),
    }
    out["times"] = {name: {"host_ms": _host_ms(f_), "device_ms": _device_ms(f_, n=10)}
                    for name, f_ in fwd.items()}


def conv_phase(dev, out, n_frames=4, h=1080, w=1920, crop=64, seed=18):
    """Phase g's conv half: ``ops.ip2_conv`` (the plain im2col gather, then
    kernel 6) on ``n_frames`` seeded h x w frames of pixel voltages at
    ``ConvSpec(8, stride, 16)`` for strides 8 and 4, with the float (no
    ADC), 8-bit code (with a bias) and sign readouts, the launch counts
    reset just before and read just after. Each against the plain route on
    the card (``extract_windows`` + ``ref.ip2_project_ref``): float within
    1e-5, codes and bits within 1 LSB on at most 1 % of rows; on a crop x
    crop corner also against ``ref.ip2_conv_ref``; ``extract_windows(f, 8,
    8)`` bitwise ``extract_patches(f, 8, 8)``. Then ``conv_frame_events``
    per frame beside the windows it prices, and the times: kernel 6 at each
    conv shape (``ms``, ``device_ms``), the gather's device ms, the whole
    wrapper, the plain route, the bound and the ``torch.matmul`` yardstick.
    Fills ``out`` as it goes."""
    import numpy as np
    import torch
    from repro_torch.core import projection as proj
    from repro_torch.core.adc import ADCSpec
    from repro_torch.core.power import EnergyMeter, conv_frame_events
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.uniform(size=(n_frames, h, w)).astype(np.float32)).to(dev)
    wts = torch.from_numpy((rng.normal(size=(16, 64)) * 3.0).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.normal(size=(16,)) * 0.1).astype(np.float32)).to(dev)
    zero = torch.zeros(16, device=dev)
    adc = ADCSpec(bits=8)
    kws = {"float": {}, "codes": {"adc": adc, "codes": True, "bias": bias},
           "sign": {"readout": "sign"}}
    out.update(frames=[n_frames, h, w], seed=seed)
    assert torch.equal(proj.extract_windows(frames, 8, 8), proj.extract_patches(frames, 8, 8)), \
        "extract_windows(f, 8, 8) != extract_patches(f, 8, 8)"
    meter = EnergyMeter()
    for stride in (8, 4):
        conv = proj.ConvSpec(kernel=8, stride=stride, n_channels=16)
        spec = conv.patch_spec()
        gh, gw = conv.out_grid(h, w)
        rows = n_frames * gh * gw
        w_t = ops._dac_weights(wts, spec).T.contiguous()
        params = {r: ops.kernel_params_from_spec(spec, kw.get("adc"), kw.get("codes", False),
                                                 kw.get("readout", "adc"))
                  for r, kw in kws.items()}
        # the path through the kernel, counted
        ops.reset_launches()
        got = {r: ops.ip2_conv(frames, wts, conv, **kw) for r, kw in kws.items()}
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        res = out[f"stride{stride}"] = {"grid": [gh, gw], "rows": rows, "launches": launches}
        assert launches["ip2_project"] == 3 and sum(launches.values()) == 3, launches
        windows = proj.extract_windows(frames, 8, stride).reshape(-1, 64)
        for r, kw in kws.items():
            g = got[r]
            assert g.shape == (n_frames, gh * gw, 16), (r, tuple(g.shape))
            g = g.reshape(rows, 16)
            want = ref.ip2_project_ref(windows, w_t, bias if r == "codes" else zero, params[r])
            if r == "float":
                err = float((g - want).abs().max())
                res[r] = {"max_abs_err": err}
                assert err <= 1e-5, f"stride {stride} float readout off by {err}"
                continue
            d = (g.int() - want.int()).abs()
            moved = int((d.amax(-1) > 0).sum())
            res[r] = {"dtype": str(g.dtype), "rows_moved": moved, "max_lsb": int(d.max())}
            assert g.dtype == (torch.bool if r == "sign" else torch.int8), (r, g.dtype)
            assert int(d.max()) <= 1 and moved <= rows // 100, (stride, r, res[r])
            # the Python-loop oracle on a crop of the first frame
            c = frames[0, :crop, :crop]
            o = ref.ip2_conv_ref(c, w_t, bias if r == "codes" else zero, conv, params[r])
            kc = ops.ip2_conv(c, wts, conv, **kw)
            dc = (kc.int() - o.int()).abs()
            assert int(dc.max()) <= 1 and int((dc.amax(-1) > 0).sum()) <= max(
                1, kc.shape[0] // 100), f"stride {stride} {r}: crop vs ip2_conv_ref"
        c = frames[0, :crop, :crop]
        e = float((ops.ip2_conv(c, wts, conv) - ref.ip2_conv_ref(
            c, w_t, zero, conv, params["float"])).abs().max())
        assert e <= 1e-5, f"stride {stride} float: crop vs ip2_conv_ref off by {e}"
        # what the sensor would spend on one such frame (the paper's model)
        ev = {name: conv_frame_events(float(h * w), 64, 16, float(gh * gw), **kw)
              for name, kw in (("adc", {}), ("sign", {"readout": "sign"}),
                               ("adc_reprogram", {"reprogram": True}))}
        res["events_per_frame"] = {"windows": gh * gw, **{
            n: {"adc_conversions": e.adc_conversions, "sign_comparisons": e.sign_comparisons,
                "cap_charges": e.cap_charges, "dac_reprograms": e.dac_reprograms,
                "model_mw_at_30hz": meter.power_mw(e, 30.0)} for n, e in ev.items()}}
        # times: kernel 6 alone on the gathered windows, the gather, the
        # wrapper, the plain route and the yardstick
        p = params["codes"]
        kern = lambda: ops._ip2_project_cuda(windows, w_t, bias, p)     # noqa: E731
        lib = lambda: torch.matmul(windows, w_t)                        # noqa: E731
        bound_ms, bound_by = _bound(rows * 64 * 4 + 64 * 16 * 4 + 16 * 4 + rows * 16,
                                    fp32_flops=2.0 * rows * 64 * 16)
        res["times"] = {
            "kernel_ms": _time_ms(kern),
            "kernel_device_ms": _device_ms(kern, kernel="ip2_project_kernel"),
            "im2col_device_ms": _device_ms(lambda: proj.extract_windows(frames, 8, stride)),
            "ip2_conv_ms": _time_ms(lambda: ops.ip2_conv(frames, wts, conv, **kws["codes"])),
            "plain_ms": _time_ms(lambda: ref.ip2_project_ref(windows, w_t, bias, p)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _time_ms(lib), "library_device_ms": _device_ms(lib)}
        del windows


def _worst_grad_share(got, want, floor=1e-2, rounding=1e-6):
    """The largest |got - want| of each leaf as a share of the leaf's
    largest |want|, worst over the tree, and the leaves floored. A leaf
    whose gradient is 0 in exact arithmetic (the attention key bias:
    softmax is shift-invariant along the keys) holds only rounding noise:
    a leaf whose largest |want| is below ``rounding`` of the tree's largest
    is held against ``floor`` of the tree's largest instead."""
    from repro_torch.convert import tree_flatten_with_paths
    w = dict(tree_flatten_with_paths(want))
    top = max(float(v.abs().max()) for v in w.values())
    worst, floored = (0.0, None), {}
    for path, g in tree_flatten_with_paths(got):
        scale = float(w[path].abs().max())
        if scale < rounding * top:
            floored[path] = scale
            scale = floor * top
        worst = max(worst, (float((g.cpu() - w[path]).abs().max()) / scale, path),
                    key=lambda t: t[0])
    return worst, floored


SERVED = ("_ip2_project_cuda", "_ip2_sparse_cuda", "_delta_attention_cuda",
          "_quant_matmul_cuda")


@contextlib.contextmanager
def _recording(ops):
    """While open, every call of the kernel wrappers in ``SERVED`` keeps a
    copy of its arguments and of its result in ``calls[name]``, so what a
    served route used can be held against the plain versions afterwards.
    The wrappers and their launch counts are unchanged."""
    import torch
    calls = {n: [] for n in SERVED}
    saved = {n: getattr(ops, n) for n in SERVED}

    def copy(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def recorder(name, fn):
        def wrapped(*args):
            out = fn(*args)
            calls[name].append((tuple(copy(a) for a in args), out.clone()))
            return out
        return wrapped

    for n, fn in saved.items():
        setattr(ops, n, recorder(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def _hold_served(calls):
    """Every result a served route took from a kernel against the kernel's
    plain version on the same inputs: codes (kernels 6 and 2) within 1 LSB
    on at most 1 % of the live rows, kernel 2's rows past the counts zero,
    attention (kernel 3) within 1e-5 with rows past the counts zero, the
    w8a8 embed (kernel 5) bitwise. Returns what was held, by kernel."""
    import torch
    from repro_torch.kernels import ref
    held = {}

    def codes(name, pairs, live_rows, shapes):
        pairs = [(g, w) for g, w in pairs if g.numel()]   # a call with no live row
        d = max((int((g.int() - w.int()).abs().max()) for g, w in pairs), default=0)
        flips = sum(int(((g.int() - w.int()).abs().amax(-1) > 0).sum()) for g, w in pairs)
        held[name] = {"calls": len(pairs), "live_rows": live_rows, "max_abs_err": d,
                      "flip_rows": flips, "shapes": sorted(shapes)}
        assert d <= 1, f"{name} codes off their plain version by {d} LSB"
        assert flips <= live_rows // 100, f"{name}: {flips} of {live_rows} rows moved"

    pairs = [(got, ref.ip2_project_ref(*a)) for a, got in calls["_ip2_project_cuda"]]
    codes("ip2_project", pairs, sum(g.shape[0] for g, _ in pairs),
          {tuple(a[0].shape) + (a[1].shape[1],) for a, _ in calls["_ip2_project_cuda"]})
    pairs, live_rows, shapes = [], 0, set()
    for a, got in calls["_ip2_sparse_cuda"]:
        table, counts, k = a[0], a[1], a[6]
        shapes.add((table.shape[0], a[2].shape[1], a[3].shape[1]))
        want = ref.ip2_project_sparse_ref(*a)
        if counts is not None:
            live = (torch.arange(k, device=got.device)[None, :]
                    < counts[:, None]).reshape(-1)
            assert not got[~live].any(), "ip2_ragged rows past the counts are not zero"
            got, want = got[live], want[live]
        pairs.append((got, want))
        live_rows += got.shape[0]
    codes("ip2_ragged", pairs, live_rows, shapes)
    errs, shapes = [], set()
    for a, got in calls["_delta_attention_cuda"]:
        q, counts = a[0], a[4]
        errs.append(float((got - ref.delta_attention_ref(*a)).abs().max()))
        live = torch.arange(q.shape[1], device=q.device)[None, :] < counts.clamp(
            0, q.shape[1])[:, None]
        assert not got[~live].any(), "delta_attention rows past the counts are not zero"
        shapes.add(tuple(q.shape))
    held["delta_attention"] = {"calls": len(errs), "max_abs_err": max(errs, default=0.0),
                               "shapes": sorted(shapes)}
    assert held["delta_attention"]["max_abs_err"] <= 1e-5, held["delta_attention"]
    same = [torch.equal(got, ref.quant_matmul_ref(*a)) for a, got in calls["_quant_matmul_cuda"]]
    held["quant_matmul"] = {"calls": len(same), "bitwise": all(same), "shapes": sorted(
        {tuple(a[0].shape) + (a[2].shape[1],) for a, _ in calls["_quant_matmul_cuda"]})}
    assert all(same), "quant_matmul differs from its plain version"
    return held


def card_vs_cpu_step(dev, opt, seed=1):
    """One step of the cpu-small preset on ``dev`` and on the CPU from the
    same parameters and batch; returns what was held (phase h_train, 2)."""
    import torch
    from repro_torch.convert import tree_flatten_with_paths, tree_to
    from repro_torch.data.pipeline import SceneStream
    from repro_torch.examples.train_ip2_classifier import preset_config
    from repro_torch.models.vit import init_vit, vit_loss
    from repro_torch.optim import adamw_update, init_opt_state
    from repro_torch.train.trainer import loss_and_grads

    def leaves(tree):
        return [x for _, x in tree_flatten_with_paths(tree)]

    cfg_s = preset_config("cpu-small")
    p_cpu = init_vit(cfg_s, torch.Generator().manual_seed(seed), device="cpu")
    rgb, labels = SceneStream(image=cfg_s.frontend.image_h).batch(0, 32)
    loss_s = lambda p, r, y: vit_loss(p, r, y, cfg_s)  # noqa: E731
    got = []
    for d in (torch.device("cpu"), dev):
        params = tree_to(p_cpu, d)
        loss, _, g = loss_and_grads(loss_s, params, torch.from_numpy(rgb).to(d),
                                    torch.from_numpy(labels).to(d))
        new, _, m = adamw_update(g, init_opt_state(params, opt), params, opt, opt.lr)
        clip = min(1.0, opt.grad_clip / max(float(m["grad_norm"]), 1e-9))
        got.append((float(loss), tree_to(g, "cpu"), tree_to(new, "cpu"), clip))
    (l_c, g_c, n_c, c_c), (l_g, g_g, n_g, c_g) = got
    (share, at), floored = _worst_grad_share(g_g, g_c)
    # AdamW's first step moves a weight by lr * f(g), f(g) = g / (|g| + eps)
    # (m / c1 = g, sqrt(v / c2) = |g|, g clipped by its global norm), plus
    # the same decay on both sides. Where the two clipped gradients differ
    # by dg, f differs by at most eps * dg / (a + eps)^2, a the smaller |g|
    # of the two (0 where their signs differ): each weight is held at 1e-5
    # plus lr times that, which is ~0 unless |g| is near eps
    errs, slack, near = [], [], {}
    for path, a, b, ga, gb in zip((p for p, _ in tree_flatten_with_paths(n_c)),
                                  leaves(n_g), leaves(n_c), leaves(g_g), leaves(g_c)):
        ga, gb = ga.double() * c_g, gb.double() * c_c
        lo = torch.where(ga * gb > 0, torch.minimum(ga.abs(), gb.abs()), 0.0)
        prop = opt.lr * opt.eps * (ga - gb).abs() / (lo + opt.eps) ** 2
        e = (a.double() - b.double()).abs()
        errs.append(float((e - prop).max()))
        slack.append(float(prop.max()))
        if bool((prop > 1e-5).any()):
            near[path] = {"elements": int((prop > 1e-5).sum()),
                          "max_abs_g_there": float(gb[prop > 1e-5].abs().max()),
                          "max_param_err_there": float(e[prop > 1e-5].max())}
    # the card's AdamW on the CPU's gradients: the same inputs, no slack
    p_dev = tree_to(p_cpu, dev)
    n_same = tree_to(adamw_update(tree_to(g_c, dev), init_opt_state(p_dev, opt), p_dev,
                                  opt, opt.lr)[0], "cpu")
    vs = {
        "loss_card": l_g, "loss_cpu": l_c, "worst_grad_share": share, "at": at,
        "grad_leaves_floored": floored,
        "max_param_err_over_propagated": max(errs), "max_propagated": max(slack),
        "elements": sum(x.numel() for x in leaves(n_c)), "near_eps": near,
        "adamw_same_grads_max_err": max(float((a - b).abs().max()) for a, b in
                                        zip(leaves(n_same), leaves(n_c)))}
    print(json.dumps({"h_card_vs_cpu": vs}))
    assert abs(l_g - l_c) <= 1e-5, vs
    assert share <= 1e-4, vs
    assert vs["max_param_err_over_propagated"] <= 1e-5, vs
    assert vs["adamw_same_grads_max_err"] <= 1e-5, vs
    return vs


def train_phase(dev, out, ckpt_dir, big="100m", big_batch=64, big_steps=12, fail_at=6,
                steps=220, batch=32, eval_batches=6, drift_frames=4, serve_frames=64):
    """Phase h_train: co-design training on the card, then the trained
    models served through the kernels. Fills ``out`` as it goes.

    1. ``big`` (the 100m preset at full width) for ``big_steps`` steps of
       ``Trainer`` at ``big_batch``, checkpoints every 4 steps under
       ``ckpt_dir``; then the same run failing at ``fail_at`` and resumed:
       final parameters and optimiser state bitwise the uninterrupted
       run's. Training reaches no kernel (the reference's training reaches
       no Pallas kernel either).
    2. One step of the cpu-small preset on the card and on the CPU from the
       same parameters and batch: gradients within 1e-4 of each leaf's
       largest |g| (a leaf at rounding level floored, and named); updated
       parameters within 1e-5 plus what each element's own gradient
       difference moves AdamW's first step by (~0 unless |g| is near eps:
       those are named); the card's AdamW on the CPU's gradients within
       1e-5 everywhere.
    3. bench_accuracy's arm B: its config trained ``steps`` steps at
       ``batch``, then on held-out batches the dense oracle (> 0.5), the
       code wire on the plain route, the staged kernel route (kernels 6
       and 5: codes within 1 LSB on at most 1 % of rows, accuracy within
       0.05 of the oracle) and the delta-gated serve at eps 0 (kernels 2,
       3 and 5, ``drift_frames`` drift frames: accuracy at least the code
       wire's - 0.08), launch counts reset before each served route and
       read after it. Every result a served route took from a kernel is
       held against the kernel's plain version on the same inputs (codes
       within 1 LSB on at most 1 % of live rows, attention within 1e-5,
       the embed bitwise, rows past the counts zero).
    4. The ``big`` parameters served once on the staged kernel route on
       the card against the plain route on the CPU: codes within 1 LSB on
       at most 1 % of rows, logits within 1e-4 on slots whose codes agree,
       each kernel result held as in 3; then kernels 6 and 5 timed at that width beside their bounds, their
       plain versions and their library yardsticks.
    5. The CNN baseline trained on the same batches; its held-out accuracy
       is printed beside the ViT's, not gated."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.convert import tree_flatten_with_paths, tree_to
    from repro_torch.core import frontend as fe
    from repro_torch.core import saliency as sal
    from repro_torch.core.frontend import FrontendConfig
    from repro_torch.core.projection import PatchSpec
    from repro_torch.core.switched_cap import SummerSpec
    from repro_torch.core.temporal import TemporalSpec, init_feature_cache
    from repro_torch.data.pipeline import SceneStream
    from repro_torch.examples.train_ip2_classifier import preset_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.backend_delta import init_backend_cache
    from repro_torch.models.cnn import cnn_loss, init_cnn
    from repro_torch.models.vit import (ViTConfig, init_vit, prepare_quant_embed,
                                        vit_forward_compact, vit_loss)
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.roofline.analysis import PEAK_FLOPS_FP32, model_flops
    from repro_torch.train.trainer import (Trainer, TrainerConfig, loss_and_grads,
                                           make_train_step)

    opt = AdamWConfig(lr=2e-3, weight_decay=0.01)

    def leaves(tree):
        return [x for _, x in tree_flatten_with_paths(tree)]

    def fed(batches):
        return [{"rgb": torch.from_numpy(r).to(dev), "labels": torch.from_numpy(y).to(dev)}
                for r, y in batches]

    # ---- 1. the 100m preset through the Trainer, interrupted and resumed ----
    cfg = preset_config(big)
    loss_fn = lambda p, rgb, labels: vit_loss(p, rgb, labels, cfg)  # noqa: E731
    step = make_train_step(loss_fn, opt)
    t0 = time.perf_counter()
    stream = SceneStream(image=cfg.frontend.image_h)
    data = fed([stream.batch(s, big_batch) for s in range(big_steps)])
    init = init_vit(cfg, torch.Generator().manual_seed(0), device="cpu")
    big_out = out["train_100m"] = {"preset": big, "batch": big_batch, "steps": big_steps,
                                   "setup_s": time.perf_counter() - t0}
    n_params = sum(x.numel() for x in leaves(init))
    tokens = big_batch * cfg.frontend.n_patches

    def trainer(name, fail=None):
        tcfg = TrainerConfig(total_steps=big_steps, ckpt_every=4, keep=2, log_every=1,
                             ckpt_dir=str(ckpt_dir / name), fail_at_step=fail)
        return Trainer(step, data.__getitem__, tcfg)

    def fresh():
        params = tree_to(init, dev)
        return params, init_opt_state(params, opt)

    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr_a = trainer("a")
    p_a, o_a, h_a = tr_a.run(*fresh())
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir / "a", ignore_errors=True)
    step_s = float(np.median(tr_a.step_times[2:]))
    big_out.update(
        n_params=n_params, tokens_per_step=tokens, run_s=run_s,
        losses=[h["loss"] for h in h_a], step_ms=[t * 1e3 for t in tr_a.step_times],
        step_ms_median=step_s * 1e3, tokens_per_s=tokens / step_s,
        model_flops_per_step=model_flops(n_params, tokens, is_train=True),
        fp32_peak_share=model_flops(n_params, tokens, is_train=True) / step_s / PEAK_FLOPS_FP32,
        max_memory_allocated=peak, stragglers=tr_a.n_stragglers)
    # where a step's time goes: the device's kernels by name, and the host
    # clock of the whole step and of its two halves (autograd; AdamW)
    b0 = data[0]
    kernels = _device_by_name(lambda: step(p_a, o_a, b0))
    grads = loss_and_grads(loss_fn, p_a, b0["rgb"], b0["labels"])[2]
    dev_ms = sum(ms for _, ms, _ in kernels)
    wall = _host_ms(lambda: step(p_a, o_a, b0), n=3, warm=1)
    big_out["breakdown"] = {
        "step_wall_ms": wall, "device_ms": dev_ms, "device_busy_share": dev_ms / wall,
        "device_launches": sum(k for *_, k in kernels),
        "gemm_ms": sum(ms for n, ms, _ in kernels if "gemm" in n.lower()),
        "top_kernels": [(n[:90], ms, k) for n, ms, k in kernels[:10]],
        "fwd_bwd_wall_ms": _host_ms(lambda: loss_and_grads(
            loss_fn, p_a, b0["rgb"], b0["labels"]), n=3, warm=1),
        "adamw_wall_ms": _host_ms(lambda: adamw_update(grads, o_a, p_a, opt, opt.lr),
                                  n=3, warm=1)}
    del grads
    print(json.dumps({"h_train_100m": big_out}))
    assert len(h_a) == big_steps and all(np.isfinite(h["loss"]) for h in h_a), h_a
    tr_b = trainer("b", fail_at)
    try:
        tr_b.run(*fresh())
        raise AssertionError("the injected failure did not fire")
    except RuntimeError as e:
        assert "injected failure" in str(e), e
    tr_b.ckpt.wait()   # the commit in flight when the step failed
    p_b, o_b, h_b = trainer("b").run(*fresh())
    shutil.rmtree(ckpt_dir / "b", ignore_errors=True)
    resumed = [h["step"] for h in h_b]
    same = all(torch.equal(x, y) for x, y in zip(leaves((p_a, o_a)), leaves((p_b, o_b))))
    big_out.update(resumed_steps=resumed, resumed_bitwise=same,
                   resumed_losses=[h["loss"] for h in h_b], launches=dict(ops.LAUNCHES))
    # resumed after the last commit before the failure (every 4 steps)
    assert resumed == list(range((fail_at - 1) // 4 * 4 + 1, big_steps)), resumed
    assert big_out["resumed_losses"] == [h["loss"] for h in h_a[resumed[0]:]], big_out
    assert same, "the resumed run's parameters or optimiser state differ from the uninterrupted run"
    assert sum(ops.LAUNCHES.values()) == 0, f"training launched a kernel: {ops.LAUNCHES}"

    # ---- 2. one step on the card against the CPU ------------------------------
    out["card_vs_cpu_step"] = card_vs_cpu_step(dev, opt)

    # ---- 3. bench_accuracy's arm B: train, then serve through the kernels ----
    fcfg_b = FrontendConfig(image_h=64, image_w=64, patch=PatchSpec(16, 16, n_vectors=32),
                            active_fraction=0.25, aa_cutoff=0.5)
    cfg_b = ViTConfig(frontend=fcfg_b)
    s64 = SceneStream(image=64)

    def train(loss_fn, params):
        state = init_opt_state(params, opt)
        st = make_train_step(loss_fn, opt)
        losses = []
        t0 = time.perf_counter()
        for i in range(steps):
            params, state, m = st(params, state, fed([s64.batch(i, batch)])[0])
            losses.append(m["loss"])
        losses = torch.stack(losses).cpu()
        assert bool(torch.isfinite(losses).all()), "a training loss is not finite"
        return params, {"steps": steps, "s": time.perf_counter() - t0,
                        "first_loss": float(losses[0]), "last_loss": float(losses[-1])}

    held = fed([s64.batch(100_000 + j, batch) for j in range(eval_batches)])

    def acc(logits, b):
        return float((logits.argmax(-1) == b["labels"]).float().mean())

    ops.reset_launches()
    params, arm = train(lambda p, r, y: vit_loss(p, r, y, cfg_b),
                        init_vit(cfg_b, torch.Generator().manual_seed(0), device=dev))
    assert sum(ops.LAUNCHES.values()) == 0, f"training launched a kernel: {ops.LAUNCHES}"
    with torch.no_grad():
        arm["dense_oracle_acc"] = float(np.mean(
            [float(vit_loss(params, b["rgb"], b["labels"], cfg_b)[1]) for b in held]))
        arm["code_wire_plain_acc"] = float(np.mean(
            [acc(vit_forward_compact(params, b["rgb"], cfg_b, wire="codes")[0], b)
             for b in held]))
        # the staged kernel route: kernel 6's codes adapter, kernel 5's embed
        cfg_k = dataclasses.replace(cfg_b, quant_embed=True)
        pq = prepare_quant_embed(params)
        pf = ops.ip2_codes_fn(fcfg_b.patch, fcfg_b.adc)
        ops.reset_launches()
        with _recording(ops) as calls:
            arm["code_wire_kernel_acc"] = float(np.mean(
                [acc(vit_forward_compact(pq, b["rgb"], cfg_k, project_fn=pf)[0], b)
                 for b in held]))
        torch.cuda.synchronize()
        arm["kernel_route_launches"] = {n: c for n, c in ops.LAUNCHES.items() if c}
        arm["kernel_route_held"] = _hold_served(calls)
        moved = rows = 0
        for b in held:
            kc = fe.apply_frontend(params["ip2"], b["rgb"], fcfg_b, mode="compact",
                                   project_fn=pf).features
            pc = fe.apply_frontend(params["ip2"], b["rgb"], fcfg_b, mode="compact").features
            d = (kc.int() - pc.int()).abs().reshape(-1, kc.shape[-1])
            assert int(d.max()) <= 1, f"codes differ by {int(d.max())} LSB"
            moved, rows = moved + int((d.amax(-1) > 0).sum()), rows + d.shape[0]
        arm["code_rows_moved"], arm["code_rows"] = moved, rows
        # the delta-gated serve at eps 0 (bench_accuracy._eval_delta): the
        # gated codes adapter (kernel 2 at the stale counts), the ragged
        # attention (kernel 3) and the code-wire embed (kernel 5)
        fcfg_d = dataclasses.replace(
            fcfg_b, patch=dataclasses.replace(
                fcfg_b.patch, summer=SummerSpec(mode="passive", hold_time_s=0.0)),
            temporal=TemporalSpec(delta_threshold=1e-3))
        dcfg = dataclasses.replace(cfg_k, frontend=fcfg_d, delta_kernel=True,
                                   saliency_layers="last")
        pf_d = ops.ip2_codes_fn(fcfg_d.patch, fcfg_d.adc)
        eps = torch.zeros((batch,), dtype=torch.float32, device=dev)
        ops.reset_launches()
        accs = []
        with _recording(ops) as calls:
            for j, b in enumerate(held):
                tcache = init_feature_cache(fcfg_d, (batch,), device=dev)
                bc = init_backend_cache(dcfg, fcfg_d.n_active, (batch,),
                                        dtype=fcfg_d.adc.code_dtype, device=dev)
                rgb_np = s64.batch(100_000 + j, batch)[0]
                for t in range(drift_frames):
                    frame = torch.from_numpy(np.clip(rgb_np * (1.0 + 0.005 * t), 0.0, 1.0)
                                             .astype(np.float32)).to(dev)
                    logits, aux = vit_forward_compact(pq, frame, dcfg, project_fn=pf_d,
                                                      cache=tcache, backend_cache=bc,
                                                      backend_eps=eps)
                    tcache, bc = aux["cache"], aux["backend_cache"]
                    accs.append(acc(logits, b))
        torch.cuda.synchronize()
        arm["delta_eps0_acc"] = float(np.mean(accs))
        arm["delta_launches"] = {n: c for n, c in ops.LAUNCHES.items() if c}
        arm["delta_held"] = _hold_served(calls)
    out["arm_b"] = arm
    print(json.dumps({"h_arm_b": arm}))
    assert arm["dense_oracle_acc"] > 0.5, arm
    assert moved <= rows // 100, arm
    assert all(arm["kernel_route_launches"].get(n, 0) > 0
               for n in ("ip2_project", "quant_matmul")), arm
    assert abs(arm["code_wire_kernel_acc"] - arm["dense_oracle_acc"]) <= 0.05, arm
    assert all(arm["delta_launches"].get(n, 0) > 0
               for n in ("ip2_ragged", "delta_attention", "quant_matmul")), arm
    assert arm["delta_eps0_acc"] >= arm["code_wire_plain_acc"] - 0.08, arm

    # ---- 4. the trained 100m parameters: kernel route vs plain route ----------
    cfg_q = dataclasses.replace(cfg, quant_embed=True)
    pq_g = prepare_quant_embed(p_a)
    pq_c = tree_to(pq_g, "cpu")
    pf_q = ops.ip2_codes_fn(cfg.frontend.patch, cfg.frontend.adc)
    x_c = torch.from_numpy(stream.batch(200_000, serve_frames)[0])
    with torch.no_grad():
        ops.reset_launches()
        with _recording(ops) as calls:
            l_g, a_g = vit_forward_compact(pq_g, x_c.to(dev), cfg_q, project_fn=pf_q)
        torch.cuda.synchronize()
        launched = {n: c for n, c in ops.LAUNCHES.items() if c}
        held_100m = _hold_served(calls)
        del calls
        l_c, a_c = vit_forward_compact(pq_c, x_c, cfg_q, project_fn=pf_q)
        codes = [fe.apply_frontend(p["ip2"], x, cfg.frontend, mode="compact",
                                   project_fn=pf_q).features.cpu()
                 for p, x in ((pq_g, x_c.to(dev)), (pq_c, x_c))]
    d = (codes[0].int() - codes[1].int()).abs()
    agree = (d == 0).all(-1).all(-1)
    err = float((l_g.cpu() - l_c).abs()[agree].max()) if bool(agree.any()) else None
    sv = out["serve_100m"] = {
        "frames": serve_frames, "launches": launched, "max_code_diff": int(d.max()),
        "rows_moved": int((d.reshape(-1, d.shape[-1]).amax(-1) > 0).sum()),
        "rows": d.shape[0] * d.shape[1], "slots_agreeing": int(agree.sum()),
        "max_logit_err_agreeing": err, "held": held_100m}
    print(json.dumps({"h_serve_100m": sv}))
    assert torch.equal(a_g["indices"].cpu(), a_c["indices"]), "the selection differs"
    assert sv["max_code_diff"] <= 1 and sv["rows_moved"] <= sv["rows"] // 100, sv
    assert launched.get("ip2_project", 0) > 0 and launched.get("quant_matmul", 0) > 0, sv
    assert err is not None and err <= 1e-4, sv
    assert bool(torch.isfinite(l_g).all()), "non-finite logits"
    # kernels 6 and 5 at this width, shapes no other phase gives them:
    # 1024 x 1024 x 400 (12.5 column tiles) and K = 400 (off the 64-k step)
    x_g = x_c.to(dev)
    patches, weights = fe.sensor_patches(pq_g["ip2"], x_g, cfg.frontend)
    gathered = sal.gather_patches(patches, a_g["indices"]).reshape(
        -1, patches.shape[-1]).contiguous()
    w_t = ops._dac_weights(weights, cfg.frontend.patch).T.contiguous()
    bias = torch.zeros(w_t.shape[1], device=dev)
    p_codes = ops.kernel_params_from_spec(cfg.frontend.patch, cfg.frontend.adc, codes=True)
    codes = ops._ip2_project_cuda(gathered, w_t, bias, p_codes)
    w8, s_w = pq_g["embed_q"]
    s_a = torch.full((codes.shape[0],), cfg.frontend.adc.lsb, device=dev)
    rows, k_in, m, d = gathered.shape[0], gathered.shape[1], w_t.shape[1], w8.shape[1]
    timed = {
        "ip2_project": dict(
            shape=[rows, k_in, m], symbol="ip2_project_kernel",
            kernel=lambda: ops._ip2_project_cuda(gathered, w_t, bias, p_codes),
            plain=lambda: ref.ip2_project_ref(gathered, w_t, bias, p_codes),
            library=lambda: torch.matmul(gathered, w_t),
            bound=_bound(rows * k_in * 4 + k_in * m * 4 + rows * m,
                         fp32_flops=2.0 * rows * k_in * m)),
        "quant_matmul": dict(
            shape=[rows, m, d], symbol="quant_matmul_kernel",
            kernel=lambda: ops._quant_matmul_cuda(codes, s_a, w8, s_w),
            plain=lambda: ref.quant_matmul_ref(codes, s_a, w8, s_w),
            library=lambda: torch._int_mm(codes, w8),
            bound=_bound(rows * m + rows * 4 + m * d + d * 4 + rows * d * 4,
                         int8_ops=2.0 * rows * m * d))}
    d6 = (codes.int() - ref.ip2_project_ref(gathered, w_t, bias, p_codes).int()).abs()
    assert int(d6.max()) <= 1 and int((d6.amax(-1) > 0).sum()) <= rows // 100, \
        "kernel 6 at the 100m width against its plain version"
    assert torch.equal(timed["quant_matmul"]["kernel"](), timed["quant_matmul"]["plain"]()), \
        "kernel 5 at K 400 against its plain version"
    sv["times"] = {name: {
        "shape": t["shape"], "ms": _time_ms(t["kernel"]),
        "device_ms": _device_ms(t["kernel"], kernel=t["symbol"]),
        "plain_ms": _time_ms(t["plain"]), "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
        "library_ms": _time_ms(t["library"]), "library_device_ms": _device_ms(t["library"])}
        for name, t in timed.items()}
    print(json.dumps({"h_kernels_100m": sv["times"]}))

    # ---- 5. the CNN baseline on the same batches --------------------------------
    cparams, cnn = train(cnn_loss, init_cnn(torch.Generator().manual_seed(0), device=dev))
    with torch.no_grad():
        cnn["held_out_acc"] = float(np.mean(
            [float(cnn_loss(cparams, b["rgb"], b["labels"])[1]) for b in held]))
    cnn["vit_dense_oracle_acc"] = arm["dense_oracle_acc"]
    out["cnn"] = cnn
    print(json.dumps({"h_cnn": cnn}))


def _busy(fn):
    """Device busy share of one call of ``fn``: the union of the device
    intervals of a profiler window over the host's wall time of the call
    (its synchronise included). The profiler loses some of a window's first
    device events (see ``_device_ms``), so the share reads low, if at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:                          # union of device intervals
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return {"busy_ms": busy / 1e3, "wall_ms": wall_ms,
            "busy_share": busy / 1e3 / wall_ms if spans else None, "device_events": len(spans)}


class _FleetTraffic:
    """Deterministic fleet traffic: streams join in the four priority classes
    in turn, each with a frame period of 1, 2 or 4 ticks (and a phase), and
    leave a few at a time; each stream's scene changes every 4 ticks. The
    fleet's admits and evicts are mirrored into per-host standalone engines
    and one engine of the fleet's whole capacity, with the same priorities
    and in the same order, so their slots line up."""

    def __init__(self, fleet, pool, seed, mirrors=(), whole=None):
        import numpy as np
        from repro_torch.serve.fleet import PRIORITY_CLASSES
        self.fleet, self.pool, self.mirrors, self.whole = fleet, pool, list(mirrors), whole
        self.classes = list(PRIORITY_CLASSES)
        self.rng = np.random.default_rng(seed)
        self.period, self.phase = {}, {}
        self.next_id = 0

    def _twins(self, host):
        """The engines that mirror ``host``: its standalone one, the whole one."""
        return [e for e in ([self.mirrors[host]] if self.mirrors else []) + [self.whole]
                if e is not None]

    def join(self, n):
        for _ in range(n):
            i = self.next_id
            sid = f"f{i}"
            self.fleet.submit(sid, self.classes[i % len(self.classes)])
            self.period[sid] = (1, 2, 4)[i % 3]
            self.phase[sid] = i % self.period[sid]
            self.next_id += 1

    def churn(self, n_out):
        """``n_out`` admitted streams leave (and one queued request is
        cancelled, if any); as many new ones join."""
        live = sorted(self.fleet.stream_ids)
        for sid in self.rng.choice(live, size=min(n_out, len(live)), replace=False):
            sid = str(sid)
            twins = self._twins(self.fleet.host_of(sid))
            self.fleet.evict(sid)
            for eng in twins:
                eng.evict(sid)
            del self.period[sid], self.phase[sid]
        queued = sorted(set(self.period) - set(self.fleet.stream_ids))
        if queued:
            self.fleet.evict(queued[0])
            del self.period[queued[0]], self.phase[queued[0]]
        self.join(n_out + (1 if queued else 0))

    def drain(self):
        """Admit the queues now, mirror the admits and the hosts' budgets."""
        for sid in self.fleet.drain():
            h = self.fleet.host_of(sid)
            for eng in self._twins(h):
                eng.admit(sid, priority=self.fleet.engines[h]._priority[sid])
        for eng, mir in zip(self.fleet.engines, self.mirrors):
            if eng.budget_mw is not None and mir.budget_mw != eng.budget_mw:
                mir.set_budget_mw(eng.budget_mw)

    def frames(self, t, every=False):
        live = set(self.fleet.stream_ids)
        return {sid: self.pool[(int(sid[1:]) + t // 4) % len(self.pool)]
                for sid in self.period if sid in live
                and (every or t % self.period[sid] == self.phase[sid])}


def fleet_phase(dev, out, params, cfg_s, cfg_g, n_hosts=4, cap=16, ticks=12, seed=21,
                time_ticks=10):
    """Phase (i), the fleet half: ``n_hosts`` x ``cap`` slots of the engine of
    (b) on the one card, on the staged route (kernels 6 + 5) and the gated
    one (temporal gate, a fleet governor at half the ungoverned fleet's mW,
    the delta backend with its ragged attention: kernels 2 + 3 + 5). Each
    serves ``ticks`` ticks by ``step`` then ``ticks`` by ``step_rollout``
    under churn, more streams than slots in four priority classes, frame
    periods of 1, 2 and 4 ticks. Holds: every host's logits bitwise a
    standalone engine's given the same admits, frames and (gated) budget
    share, in step mode and against the rollout; fleet -> host -> slot
    budgets summing to rel 1e-5; a slack fleet budget bitwise an ungoverned
    fleet; logits within 1e-5 of one engine of the fleet's capacity on the
    slots whose codes agree; every kernel result against its plain version.
    Then full-feed tick times (dispatch, fetch) and the device busy share,
    beside the whole-capacity engine's."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import SceneStream
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import SaccadeEngine
    from repro_torch.serve.fleet import SaccadeFleet
    from repro_torch.serve.governor import GovernorSpec

    pool, _ = SceneStream(seed=seed, image=cfg_s.frontend.image_h).batch(0, 24)
    routes = {
        "staged": (cfg_s, {"project_fn": ops.ip2_codes_fn(cfg_s.frontend.patch,
                                                           cfg_s.frontend.adc)}),
        "gated": (cfg_g, {"project_fn": ops.ip2_codes_fn(cfg_g.frontend.patch,
                                                          cfg_g.frontend.adc),
                          "temporal": True, "backend_delta": True}),
    }
    k_tok = cfg_s.frontend.n_active
    n_join = n_hosts * cap + cap // 2            # more streams than slots: queues wait
    for route, (cfg, kw) in routes.items():
        res = out[route] = {}
        gov = None
        if route == "gated":
            # a slack fleet budget against an ungoverned fleet of the same
            # shape (bitwise), which also meters the fleet mW the governed
            # fleet gets half of
            pair = {name: SaccadeFleet(cfg, params, n_hosts=n_hosts, capacity=cap,
                                       governor=g, **kw)
                    for name, g in (("slack", GovernorSpec(budget_mw=1e9)), ("ungoverned", None))}
            traffic = {name: _FleetTraffic(fl, pool, seed) for name, fl in pair.items()}
            fleet_mw = []
            for t in range(6):
                outs = {}
                for name, tr in traffic.items():
                    if t:
                        tr.churn(3)
                    else:
                        tr.join(n_join)
                    tr.drain()
                    outs[name] = pair[name].step(tr.frames(t))
                assert outs["slack"].keys() == outs["ungoverned"].keys()
                for sid, v in outs["slack"].items():
                    assert np.array_equal(v, outs["ungoverned"][sid]), \
                        f"tick {t} {sid}: the slack fleet budget moved a logit"
                fleet_mw.append(pair["ungoverned"].fleet_power_mw())
            del pair, traffic
            gov = GovernorSpec(budget_mw=0.5 * float(np.mean(fleet_mw)), backend_eps=1e-3)
            res["ungoverned_fleet_mw"] = fleet_mw
            res["budget_mw"] = gov.budget_mw

        fleet = SaccadeFleet(cfg, params, n_hosts=n_hosts, capacity=cap, governor=gov, **kw)
        mirrors = [SaccadeEngine(cfg, params, capacity=cap, governor=gov, **kw)
                   for _ in range(n_hosts)]
        whole = SaccadeEngine(cfg, params, capacity=n_hosts * cap, governor=gov, **kw)
        tr = _FleetTraffic(fleet, pool, seed, mirrors, whole)
        launches = dict.fromkeys(ops.LAUNCHES, 0)
        host_ticks = 0
        agree = {}                               # gated: cumulative per stream
        worst_bit = {"compared": 0}
        vs_whole = {"compared": 0, "skipped": 0, "max_logit_err": 0.0}
        budgets = []

        def fleet_call(fn):
            ops.reset_launches()
            r = fn()
            for n, c in ops.LAUNCHES.items():
                launches[n] += c
            return r

        def hold_bitwise(t, got, want):
            assert got.keys() == want.keys(), f"tick {t}: fed streams differ"
            for sid, v in got.items():
                assert np.array_equal(v, want[sid]), \
                    f"{route} tick {t} {sid}: the fleet's host and its standalone engine differ"
                assert np.isfinite(v).all()
                worst_bit["compared"] += 1

        def check_budgets(t):
            if gov is None:
                return
            hosts = []
            for eng in fleet.engines:
                slots = [eng.slot_of(s) for s in eng.stream_ids]
                if slots:
                    b = float(eng.state.controls.budget_mw[slots].sum())
                    assert abs(b - eng.budget_mw) <= 1e-5 * eng.budget_mw, (t, b, eng.budget_mw)
                    hosts.append(eng.budget_mw)
            assert abs(sum(hosts) - gov.budget_mw) <= 1e-5 * gov.budget_mw, (t, hosts)
            budgets.append(hosts)

        with _recording(ops) as calls:
            tr.join(n_join)
            for t in range(ticks):
                if t:
                    tr.churn(3)
                tr.drain()
                assert t > 0 or fleet.queued > 0, "no stream waited in a queue"
                frames = tr.frames(t)
                n_call = len(calls["_ip2_project_cuda"])
                got = fleet_call(lambda: fleet.step(frames))
                host_ticks += len({fleet.host_of(s) for s in frames})
                fleet_calls = calls["_ip2_project_cuda"][n_call:]
                want = {}
                for h, eng in enumerate(mirrors):
                    fh = {s: f for s, f in frames.items() if fleet.host_of(s) == h}
                    if fh:
                        want.update(eng.step(fh))
                hold_bitwise(t, got, want)
                check_budgets(t)
                n_call = len(calls["_ip2_project_cuda"])
                w_out = whole.step(frames)
                # the slots whose codes agree with the whole-capacity engine
                if route == "staged":
                    (w_args, w_codes), = calls["_ip2_project_cuda"][n_call:]
                    fed_hosts = sorted({fleet.host_of(s) for s in frames})
                    by_host = dict(zip(fed_hosts, (c for _, c in fleet_calls)))
                    same = {}
                    for sid in frames:
                        h = fleet.host_of(sid)
                        a = fleet.engines[h].slot_of(sid)
                        b = whole.slot_of(sid)
                        same[sid] = torch.equal(by_host[h][a * k_tok:(a + 1) * k_tok],
                                                w_codes[b * k_tok:(b + 1) * k_tok])
                else:
                    w_st = whole.state
                    same = {}
                    for sid in frames:
                        h_st = fleet.engines[fleet.host_of(sid)].state
                        a = fleet.engines[fleet.host_of(sid)].slot_of(sid)
                        b = whole.slot_of(sid)
                        ok = torch.equal(h_st.cache.features[a], w_st.cache.features[b])
                        for name in ("j_cap", "tier", "eps"):
                            ok &= torch.equal(getattr(h_st.controls, name)[a],
                                              getattr(w_st.controls, name)[b])
                        same[sid] = agree[sid] = agree.get(sid, True) and bool(ok)
                for sid, v in got.items():
                    if same[sid]:
                        e = float(np.abs(v - w_out[sid]).max())
                        vs_whole["max_logit_err"] = max(vs_whole["max_logit_err"], e)
                        vs_whole["compared"] += 1
                        assert e <= 1e-5, f"{route} tick {t} {sid}: {e} off the whole engine"
                    else:
                        vs_whole["skipped"] += 1
            # the rollout half: churn once at its boundary, then `ticks` ticks
            # in one step_rollout per fed host, against the mirrors' step loops
            tr.churn(3)
            tr.drain()
            sched = [tr.frames(t) for t in range(ticks, 2 * ticks)]
            roll = fleet_call(lambda: fleet.step_rollout(sched))
            host_ticks += ticks * len({fleet.host_of(s) for fr in sched for s in fr})
            for t, frames in enumerate(sched):
                want = {}
                for h, eng in enumerate(mirrors):
                    fh = {s: f for s, f in frames.items() if fleet.host_of(s) == h}
                    if fh:
                        want.update(eng.step(fh))
                hold_bitwise(ticks + t, roll[t], want)
            check_budgets(2 * ticks)
            res["held"] = _hold_served(calls)
        res.update({"launches": launches, "host_ticks": host_ticks,
                    "bitwise_stream_ticks": worst_bit["compared"], "vs_whole_engine": vs_whole,
                    "host_budgets_mw": budgets[-1] if budgets else None,
                    "streams_joined": tr.next_id})
        if route == "staged":
            assert launches["ip2_project"] == host_ticks and launches["quant_matmul"] == host_ticks
            assert launches["ip2_ragged"] == launches["delta_attention"] == 0
        else:
            assert launches["ip2_ragged"] == host_ticks, (launches, host_ticks)
            assert launches["delta_attention"] > 0 and launches["quant_matmul"] > 0, launches
            assert launches["ip2_project"] == 0
        assert launches["ip2_fused_embed"] == launches["ip2_project_sparse"] == 0, launches
        assert vs_whole["compared"] >= 0.8 * (vs_whole["compared"] + vs_whole["skipped"]), vs_whole
        del mirrors

        # full-feed tick times: every admitted stream fed, split into the
        # non-blocking dispatch and the fetch; the same for the whole engine
        frames = tr.frames(0, every=True)
        timing = {}
        for name, step in (("fleet", fleet.step), ("whole_engine", whole.step)):
            for _ in range(3):
                step(frames)
            disp, fetch = [], []
            for _ in range(time_ticks):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h = step(frames, block=False)
                t1 = time.perf_counter()
                h.result()
                disp.append((t1 - t0) * 1e3)
                fetch.append((time.perf_counter() - t1) * 1e3)
            timing[name] = {"streams": len(frames), "dispatch_ms": float(np.median(disp)),
                            "fetch_ms": float(np.median(fetch)),
                            "tick_ms": float(np.median(np.add(disp, fetch))),
                            "dispatch_ms_all": disp, "fetch_ms_all": fetch,
                            **_busy(lambda: step(frames))}
        res["times"] = timing
        del fleet, whole, tr
        torch.cuda.empty_cache()
    return out


def lm_phase(dev, out, seed=0, batch=8, prompt_len=128, gen=64, cfg=None):
    """Phase (i), the LM half: smollm-135m at full width and depth (30
    layers, d_model 576, 9 Q / 3 KV heads, vocab 49 152, tied embeddings)
    with seeded weights serves ``batch`` prompts of ``prompt_len`` tokens
    from ``TokenStream`` and ``gen`` greedy decode steps with each cache
    dtype: decode == forward within 2e-4 on the float32 cache and within
    1.5 % of the logit scale (the reference's int8 criterion) on bf16 and
    int8; prefill ms, decode ms per step, tokens/s, peak memory, one decode
    step's device busy share. The card against the CPU at 2 of the 30
    layers (1e-4). The other families at their smoke configs, decode ==
    forward (2e-4): recurrentgemma with a 6-token window, xlstm, the
    qwen3 MoE dropless (and at a binding capacity the card's dropped
    (token, expert) pairs are the CPU's), whisper, pixtral with the IP2
    frontend. No kernel launches in any of it. ``cfg`` replaces smollm-135m
    (a smaller one rehearses the phase on the CPU)."""
    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.convert import tree_flatten_with_paths, tree_to
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    ops.reset_launches()
    plan = M.DEFAULT_PLAN
    cfg = cfg or get_config("smollm-135m")
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    n_params = sum(x.numel() for _, x in tree_flatten_with_paths(params))
    out["smollm"] = {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_params": n_params,
                     "param_count": cfg.param_count(), "init_s": time.perf_counter() - t0,
                     "batch": batch, "prompt_len": prompt_len, "gen": gen, "caches": {}}
    prompt = torch.from_numpy(TokenStream(DataConfig(
        seed=seed + 1, vocab=cfg.vocab, seq_len=prompt_len, global_batch=batch)).batch(0)[
        "tokens"]).to(dev)
    prefill = make_prefill_step(cfg, plan)
    decode = make_decode_step(cfg, plan)
    sync = torch.cuda.synchronize
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                     ("int8", torch.int8)):
        def fresh():
            return M.init_decode_state(cfg, plan, batch, prompt_len + gen, cache_dtype=dt,
                                       device=dev)
        lg, st = prefill(params, {"tokens": prompt}, fresh())         # warm-up
        decode(params, st, torch.argmax(lg, -1).to(torch.int32),
               torch.full((), prompt_len, dtype=torch.int32, device=dev))
        torch.cuda.reset_peak_memory_stats()
        st = fresh()
        sync()
        t0 = time.perf_counter()
        lg, st = prefill(params, {"tokens": prompt}, st)
        sync()
        t_pre = time.perf_counter() - t0
        nxt = torch.argmax(lg, -1).to(torch.int32)
        logits, toks = [lg], [nxt]
        t0 = time.perf_counter()
        for i in range(gen):
            pos = torch.full((), prompt_len + i, dtype=torch.int32, device=dev)
            nxt, lg, st = decode(params, st, nxt, pos)
            logits.append(lg)
            toks.append(nxt)
        sync()
        t_dec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        pos = torch.full((), prompt_len + gen - 1, dtype=torch.int32, device=dev)
        busy = _busy(lambda: decode(params, st, toks[-2], pos))
        seq = torch.cat([prompt, torch.stack(toks[:gen], 1)], 1)
        full, _ = M.forward(params, {"tokens": seq}, cfg)
        errs = [float((logits[i] - full[:, prompt_len - 1 + i]).abs().max())
                for i in range(gen + 1)]
        scale = float(full.abs().max())
        rec = out["smollm"]["caches"][name] = {
            "prefill_ms": t_pre * 1e3, "decode_ms_per_step": t_dec * 1e3 / gen,
            "decode_tokens_per_s": batch * gen / t_dec,
            "prefill_tokens_per_s": batch * prompt_len / t_pre,
            "peak_mem_bytes": peak, "decode_step_busy": busy,
            "max_err_vs_forward": max(errs), "logit_scale": scale,
            "rel_err_vs_forward": max(errs) / scale,
            "first_tokens": seq[0, prompt_len:prompt_len + 8].tolist()}
        assert all(np.isfinite(errs)), rec
        if dt == torch.float32:
            assert max(errs) <= 2e-4, f"smollm float32 cache: decode off forward by {max(errs)}"
        else:
            assert max(errs) / scale < LM_CACHE_REL_BOUND, \
                f"smollm {name} cache: {max(errs)} of {scale}"
        del st, logits, full

    # the card against the CPU at 2 of the 30 layers, same weights
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p_cpu = M.init_params(torch.Generator().manual_seed(seed + 2), cfg2, device="cpu")
    p_gpu = tree_to(p_cpu, dev)
    toks = prompt[:2, :32]
    n = toks.shape[1]
    lc, _ = M.forward(p_cpu, {"tokens": toks.cpu()}, cfg2)
    lgpu, _ = M.forward(p_gpu, {"tokens": toks}, cfg2)
    e_fwd = float((lgpu.cpu() - lc).abs().max())
    lc1, sc = M.prefill(p_cpu, {"tokens": toks[:, :n - 4].cpu()}, cfg2, plan, M.init_decode_state(
        cfg2, plan, 2, n, cache_dtype=torch.float32, device="cpu"))
    lg1, sg = M.prefill(p_gpu, {"tokens": toks[:, :n - 4]}, cfg2, plan, M.init_decode_state(
        cfg2, plan, 2, n, cache_dtype=torch.float32, device=dev))
    e_dec = float((lg1.cpu() - lc1).abs().max())
    for i in range(n - 4, n):
        lc1, sc = M.decode_step(p_cpu, sc, toks[:, i].cpu(), torch.tensor(i), cfg2)
        lg1, sg = M.decode_step(p_gpu, sg, toks[:, i], torch.full((), i, device=dev), cfg2)
        e_dec = max(e_dec, float((lg1.cpu() - lc1).abs().max()))
    out["smollm"]["card_vs_cpu_2_layers"] = {"forward_max_err": e_fwd, "decode_max_err": e_dec}
    assert e_fwd <= 1e-4 and e_dec <= 1e-4, out["smollm"]["card_vs_cpu_2_layers"]
    del params, p_gpu

    # the other families at their smoke configs, decode == forward
    fam = out["families"] = {}
    g = np.random.default_rng(seed + 3)
    cases = [("recurrentgemma-2b", {"local_window": 6}, 20, 10),
             ("xlstm-1.3b", {}, 16, 8), ("qwen3-moe-235b-a22b", {}, 16, 8),
             ("whisper-tiny", {}, 16, 8), ("pixtral-12b", {"vision_frontend": "ip2"}, 16, 8)]
    for arch, repl, s, half in cases:
        c = dataclasses.replace(smoke_config(arch), **repl)
        p = M.init_params(torch.Generator().manual_seed(seed + 4), c, device=dev)
        b = {"tokens": torch.from_numpy(g.integers(0, c.vocab, size=(2, s))).to(dev)}
        if c.is_encoder_decoder:
            b["frames"] = torch.from_numpy(
                g.normal(size=(2, c.n_encoder_frames, c.d_model)).astype(np.float32)).to(dev)
        if c.is_vlm:
            edge = 2 * c.ip2_patch
            b["images_rgb"] = torch.from_numpy(
                g.uniform(size=(2, edge, edge, 3)).astype(np.float32)).to(dev)
        full, aux = M.forward(p, b, c)
        n_pre = full.shape[1] - s
        st = M.init_decode_state(c, plan, 2, n_pre + s, cache_dtype=torch.float32, device=dev)
        lg, st = M.prefill(p, dict(b, tokens=b["tokens"][:, :half]), c, plan, st)
        errs = [float((lg - full[:, n_pre + half - 1]).abs().max())]
        for t in range(half, s):
            lg, st = M.decode_step(p, st, b["tokens"][:, t],
                                   torch.full((), n_pre + t, dtype=torch.int32, device=dev), c)
            errs.append(float((lg - full[:, n_pre + t]).abs().max()))
        fam[arch] = {"decode_vs_forward_max_err": max(errs), "moe_aux": float(aux["moe_aux"]),
                     "positions": n_pre + s}
        assert max(errs) <= 2e-4, (arch, fam[arch])
    # a binding capacity: the card drops the CPU's (token, expert) pairs
    c = smoke_config("qwen3-moe-235b-a22b")
    c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=0.5))
    p_cpu = moe_mod.init_moe(torch.Generator().manual_seed(seed + 5), c)
    h = torch.from_numpy(g.normal(size=(2, 16, c.d_model)).astype(np.float32))
    dropped = {}
    for d in ("cpu", dev):
        p_d, h_d = tree_to(p_cpu, d), h.to(d)
        _, _, ids = moe_mod.route(p_d, h_d.reshape(-1, c.d_model), c)
        dp = moe_mod.dispatch(ids, c.moe.n_experts, moe_mod.capacity(c, 32))
        dropped[str(d)] = sorted((int(a), int(e)) for a, e, k in zip(
            dp["tok_of"].cpu(), dp["expert"].cpu(), dp["keep"].cpu()) if not k)
        dropped[str(d) + "_out"] = moe_mod.apply_moe(p_d, h_d, c)[0].cpu()
    e_moe = float((dropped[str(dev) + "_out"] - dropped["cpu_out"]).abs().max())
    fam["moe_binding"] = {"dropped_pairs": len(dropped["cpu"]), "card_vs_cpu_max_err": e_moe}
    assert dropped[str(dev)] == dropped["cpu"] and dropped["cpu"], "dropped pairs differ"
    assert e_moe <= 1e-5, fam["moe_binding"]
    out["launches"] = dict(ops.LAUNCHES)
    assert not any(ops.LAUNCHES.values()), f"a kernel launched in the LM part: {ops.LAUNCHES}"
    return out


def gated_steps_phase(dev, out, params, cfg_g, capacity=CAPACITY, frames=12, seed=9):
    """Phase (j1): the gated forms of ``make_saccade_step`` at the width of
    ``cfg_g`` on the staged kernel route (``ops.ip2_codes_fn``), ``capacity``
    streams, ``frames`` frames of ``SceneStream`` scenes that change every 4
    frames, every stream fed every frame, no governor.

    ``step_temporal_backend`` and ``step_temporal`` each against a
    ``SaccadeEngine`` of the same mode (``temporal=True``, with and without
    ``backend_delta``) fed every slot every tick, which is one
    ``make_saccade_step`` frame per slot: logits within 1e-5, next indices,
    ``n_stale`` and the caches' integer leaves equal (bitwise or not is
    reported). Launch counts are reset before each form's frames and read
    after them: ``ip2_ragged`` and ``quant_matmul`` once a frame,
    ``delta_attention`` on every layer but the last (never without the
    backend cache); the backend computes both of its regimes every frame
    and selects on the device, so a frame whose backend MACs are all zero
    launches the same kernels (the computed frames are counted). Every
    kernel result of the forms is held against its plain version on its
    own inputs (``_recording``, ``_hold_served``). Then both forms on a
    small input on the card against the CPU: 1e-4 on the slots whose codes
    agree. Fills ``out``; ms per frame by the host clock to a synchronise."""
    import numpy as np
    import torch
    from repro_torch.convert import tree_to
    from repro_torch.core.frontend import FrontendConfig
    from repro_torch.core.projection import PatchSpec
    from repro_torch.core.switched_cap import SummerSpec
    from repro_torch.core.temporal import TemporalSpec, init_feature_cache
    from repro_torch.data.pipeline import SceneStream
    from repro_torch.kernels import ops
    from repro_torch.models.backend_delta import init_backend_cache
    from repro_torch.models.vit import ViTConfig, init_vit, prepare_quant_embed
    from repro_torch.serve.engine import SaccadeEngine
    from repro_torch.serve.serve_step import make_bootstrap_indices, make_saccade_step

    fcfg = cfg_g.frontend
    k = fcfg.n_active
    pool, _ = SceneStream(seed=seed, image=fcfg.image_h).batch(0, 24)
    clip = [np.stack([pool[(i + t // 4) % len(pool)] for i in range(capacity)])
            for t in range(frames)]

    def run_form(cfg, p, backend, device, n_frames, record=None):
        """The form's frames on ``device``: per frame (logits, next indices,
        n_stale, cache, bcache, backend MACs, launches, ms)."""
        pf = ops.ip2_codes_fn(cfg.frontend.patch, cfg.frontend.adc)
        step = make_saccade_step(cfg, project_fn=pf, temporal=True, backend=backend)
        params_d = p["params"]
        rgb0 = torch.from_numpy(p["clip"][0]).to(device)
        n = rgb0.shape[0]
        idx = make_bootstrap_indices(cfg)(params_d, rgb0)
        cache = init_feature_cache(cfg.frontend, (n,), device=device)
        state = [cache]
        if backend:
            state.append(init_backend_cache(cfg, cfg.frontend.n_active, (n,),
                                            dtype=cfg.frontend.adc.code_dtype, device=device))
        rows = []
        for t in range(n_frames):
            rgb = torch.from_numpy(p["clip"][t]).to(device)
            pre = dict(ops.LAUNCHES)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, nxt, aux, *state = step(params_d, rgb, idx, *state)
            if device.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({"logits": logits, "next": nxt, "n_stale": aux["n_stale"],
                         "state": list(state), "macs": aux["events"].backend_macs,
                         "launched": {m: ops.LAUNCHES[m] - pre[m] for m in pre}, "ms": ms})
            idx = nxt
        return rows

    def int_leaves(st):
        return {f"{type(x).__name__}.{name}": v for x in st
                for name, v in zip(x._fields, x)
                if not v.is_floating_point()}

    big = {"params": params, "clip": clip}
    for backend in (True, False):
        form = "step_temporal_backend" if backend else "step_temporal"
        rec = out[form] = {}
        with _recording(ops) as calls:
            ops.reset_launches()
            rows = run_form(cfg_g, big, backend, dev, frames)
            launches = dict(ops.LAUNCHES)
        rec["held"] = _hold_served(calls)
        del calls
        # both regimes of the delta backend run every frame (a device-side
        # select picks one), so every frame launches the same kernels;
        # a computed frame is one whose backend MACs are not all zero
        per_frame = {"ip2_ragged": 1, "quant_matmul": 1,
                     "delta_attention": cfg_g.n_layers - 1 if backend else 0}
        computed = [bool((r["macs"] > 0).any()) for r in rows] if backend else [True] * frames
        rec.update(frames=frames, streams=capacity, launches=launches,
                   computed_frames=sum(computed),
                   ms_per_frame=[r["ms"] for r in rows],
                   ms_per_frame_median=float(np.median([r["ms"] for r in rows[2:]])),
                   mean_n_stale=[float(r["n_stale"].float().mean()) for r in rows])
        for r in rows:
            assert all(r["launched"][m] == v for m, v in per_frame.items()), r["launched"]
        assert all(launches[m] == frames * v for m, v in per_frame.items()), launches
        assert all(launches[n] == 0 for n in ("ip2_project", "ip2_fused_embed",
                                               "ip2_project_sparse")), launches
        assert sum(computed) > 0 and all(torch.isfinite(r["logits"]).all() for r in rows)

        # the engine of the same mode, every slot fed every tick
        eng = SaccadeEngine(cfg_g, params, capacity=capacity,
                            project_fn=ops.ip2_codes_fn(cfg_g.frontend.patch,
                                                        cfg_g.frontend.adc),
                            temporal=True, backend_delta=backend, device=dev)
        sids = [f"s{i}" for i in range(capacity)]
        for s in sids:
            eng.admit(s)
        worst, bitwise = 0.0, True
        for t, r in enumerate(rows):
            got = eng.step({s: clip[t][i] for i, s in enumerate(sids)})
            lg = torch.from_numpy(np.stack([got[s] for s in sids]))
            e = float((lg - r["logits"].cpu()).abs().max())
            worst, bitwise = max(worst, e), bitwise and e == 0.0
            assert e <= 1e-5, f"{form} frame {t}: engine off by {e}"
            st = eng.state
            assert torch.equal(st.indices, r["next"]), f"{form} frame {t}: indices differ"
            assert torch.equal(st.cache.n_stale, r["n_stale"]), f"{form} frame {t}: n_stale"
            eng_st = [st.cache] + ([st.bcache] if backend else [])
            a, b = int_leaves(eng_st), int_leaves(r["state"])
            assert a.keys() == b.keys()
            for name in a:
                assert torch.equal(a[name], b[name]), f"{form} frame {t}: {name} differs"
            bitwise = bitwise and all(torch.equal(x, y) for s1, s2 in zip(eng_st, r["state"])
                                      for x, y in zip(s1, s2))
        rec["vs_engine"] = {"max_logit_err": worst, "bitwise": bitwise}
        del eng, rows

    # a small input: the kernel route on the card, the plain route on the CPU
    sfe = FrontendConfig(image_h=64, image_w=64, active_fraction=0.25,
                         patch=PatchSpec(16, 16, n_vectors=32,
                                         summer=SummerSpec(mode="passive", hold_time_s=0.0)),
                         temporal=TemporalSpec(delta_threshold=1e-3, recompute_budget=2))
    scfg = ViTConfig(frontend=sfe, n_layers=2, d_model=64, n_heads=4, d_ff=128,
                     quant_embed=True, saliency_layers="last", delta_kernel=True)
    p_cpu = prepare_quant_embed(init_vit(scfg, torch.Generator().manual_seed(1), device="cpu"))
    spool, _ = SceneStream(seed=4, image=64).batch(0, 10)
    sclip = [np.stack([spool[(i + t // 2) % 10] for i in range(8)]) for t in range(6)]
    small = out["card_vs_cpu_small"] = {}
    for backend in (True, False):
        on_cpu, on_card = (run_form(scfg, {"params": tree_to(p_cpu, d), "clip": sclip},
                                    backend, d, len(sclip))
                           for d in (torch.device("cpu"), dev))
        agree, worst = torch.ones(8, dtype=torch.bool), 0.0
        for t, (a, b) in enumerate(zip(on_card, on_cpu)):
            agree &= (a["state"][0].features.cpu() == b["state"][0].features).all(-1).all(-1)
            e = float((a["logits"].cpu() - b["logits"]).abs()[agree].max())
            worst = max(worst, e)
            assert e <= 1e-4, f"small input frame {t}: card off the CPU by {e}"
        small["backend" if backend else "temporal"] = {
            "slots_agreeing": int(agree.sum()), "max_logit_err": worst}
        assert int(agree.sum()) >= 6, f"only {int(agree.sum())} of 8 slots kept equal codes"
    return out


def lm_train_phase(dev, out, ckpt_dir, cfg=None, batch=8, seq=512, steps=8, fail_at=6,
                   seed=0, small_batch=2, small_seq=64):
    """Phase (j2): LM training of smollm-135m at full width and depth (30
    layers, d_model 576, 9 Q / 3 KV heads, vocab 49 152, tied embeddings,
    as ``get_config`` gives it; ``cfg`` replaces it to rehearse on the CPU)
    from seeded weights on ``TokenStream`` batches of ``batch`` x ``seq``,
    bf16 compute on float32 masters, AdamW (lr 1e-3, 2 warm-up steps)
    through ``Trainer``.

    ``steps`` steps with remat off, ``"nothing"`` and ``"dots"``: every loss
    finite, the last below the first; per policy the median step ms,
    tokens/s, peak memory, and one step's device time, busy share and
    device kernel launches. The ``"nothing"`` run checkpoints every 4
    steps; the same run failing at ``fail_at`` and resumed equals it
    bitwise (parameters and AdamW state). One float32 gradient at 2 of the
    layers on the card against the CPU (each leaf within 1e-4 of its
    largest |g|), and ``microbatches=4`` against 1 in float32 on the card
    (loss rel 1e-5, gradients within 1e-5 of each leaf's largest). No
    kernel launches (the reference's training reaches none)."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_flatten_with_paths, tree_to
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.examples.train_lm import token_batches
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_grads_fn, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def leaves(tree):
        return [x for _, x in tree_flatten_with_paths(tree)]

    plan = M.DEFAULT_PLAN
    cfg = cfg or get_config("smollm-135m")
    opt = AdamWConfig(lr=1e-3)
    init = M.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    n_params = sum(x.numel() for x in leaves(init))
    stream = TokenStream(DataConfig(seed=seed + 1, vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch))
    host = token_batches(cfg, stream, batch, "cpu")
    data = [{k: v.to(dev) for k, v in host(s).items()} for s in range(steps)]
    tokens = batch * seq
    out.update(name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
               n_params=n_params, batch=batch, seq=seq, steps=steps, policies={})
    ops.reset_launches()

    def trainer(c, name, every, fail=None):
        tcfg = TrainerConfig(total_steps=steps, ckpt_every=every, keep=2, log_every=1,
                             ckpt_dir=str(ckpt_dir / name), fail_at_step=fail)
        step = make_train_step(c, plan, opt, compute_dtype=torch.bfloat16, warmup=2,
                               total_steps=steps)
        return step, Trainer(step, data.__getitem__, tcfg)

    def fresh():
        params = tree_to(init, dev)
        return params, init_opt_state(params, opt)

    final = {}
    for name, remat, policy in (("off", False, "nothing"), ("nothing", True, "nothing"),
                                ("dots", True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        step, tr = trainer(c, name, 4 if name == "nothing" else steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, o, hist = tr.run(*fresh())
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if name == "nothing":
            final["a"] = (p, o, hist)
        shutil.rmtree(ckpt_dir / name, ignore_errors=True)
        step_s = float(np.median(tr.step_times[2:]))
        kernels = _device_by_name(lambda: step(p, o, data[0]))
        dev_ms = sum(ms for _, ms, _ in kernels)
        wall = _host_ms(lambda: step(p, o, data[0]), n=3, warm=1)
        losses = [h["loss"] for h in hist]
        rec = out["policies"][name] = {
            "remat": remat, "remat_policy": policy, "run_s": run_s, "losses": losses,
            "step_ms": [t * 1e3 for t in tr.step_times], "step_ms_median": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "max_memory_allocated": peak,
            "step_wall_ms": wall, "device_ms": dev_ms, "device_busy_share": dev_ms / wall,
            "device_launches": sum(n for *_, n in kernels),
            "gemm_ms": sum(ms for n, ms, _ in kernels if "gemm" in n.lower()),
            "top_kernels": [(n[:90], ms, k) for n, ms, k in kernels[:8]]}
        print(json.dumps({"j_train_" + name: {k: v for k, v in rec.items()
                                              if k != "top_kernels"}}))
        assert len(losses) == steps and all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], f"remat {name}: the loss did not drop: {losses}"
        del p, o
    # interrupted at fail_at and resumed: bitwise the uninterrupted "nothing" run
    c = dataclasses.replace(cfg, remat=True, remat_policy="nothing")
    _, tr_b = trainer(c, "b", 4, fail_at)
    try:
        tr_b.run(*fresh())
        raise AssertionError("the injected failure did not fire")
    except RuntimeError as e:
        assert "injected failure" in str(e), e
    tr_b.ckpt.wait()
    p_b, o_b, h_b = trainer(c, "b", 4)[1].run(*fresh())
    shutil.rmtree(ckpt_dir / "b", ignore_errors=True)
    p_a, o_a, h_a = final.pop("a")
    resumed = [h["step"] for h in h_b]
    same = all(torch.equal(x, y) for x, y in zip(leaves((p_a, o_a)), leaves((p_b, o_b))))
    out["resume"] = {"resumed_steps": resumed, "bitwise": same,
                     "losses_equal": [h["loss"] for h in h_b]
                     == [h["loss"] for h in h_a[resumed[0]:]]}
    assert resumed == list(range((fail_at - 1) // 4 * 4 + 1, steps)), resumed
    assert same and out["resume"]["losses_equal"], out["resume"]
    del p_a, o_a, p_b, o_b

    # one float32 gradient at 2 of the layers, card against CPU
    c2 = dataclasses.replace(cfg, n_layers=2, remat=False)
    p2 = M.init_params(torch.Generator().manual_seed(seed + 2), c2, device="cpu")
    b2 = {"tokens": data[0]["tokens"][:small_batch, :small_seq].cpu()}
    grads = make_grads_fn(c2, plan, opt, torch.float32)
    l_cpu, _, g_cpu = grads(p2, b2)
    l_gpu, _, g_gpu = grads(tree_to(p2, dev), tree_to(b2, dev))
    (share, at), floored = _worst_grad_share(tree_to(g_gpu, "cpu"), g_cpu)
    out["card_vs_cpu_2_layers"] = {"loss_card": float(l_gpu), "loss_cpu": float(l_cpu),
                                   "worst_grad_share": share, "at": at,
                                   "floored": floored}
    assert abs(float(l_gpu) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu)), out
    assert share <= 1e-4, out["card_vs_cpu_2_layers"]

    # microbatches=4 against 1, float32, full depth, on the card
    c = dataclasses.replace(cfg, remat=True, remat_policy="nothing")
    params = tree_to(init, dev)
    one = make_grads_fn(c, plan, opt, torch.float32)(params, data[0])
    four = make_grads_fn(c, plan, opt, torch.float32, 4)(params, data[0])
    loss_rel = abs(float(four[0]) - float(one[0])) / abs(float(one[0]))
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(leaves(four[2]), leaves(one[2])))
    out["microbatches_4_vs_1"] = {"loss_rel": loss_rel, "worst_grad_share": worst,
                                  "metrics": sorted(four[1])}
    assert loss_rel <= 1e-5 and worst <= 1e-5, out["microbatches_4_vs_1"]
    out["launches"] = dict(ops.LAUNCHES)
    assert not any(ops.LAUNCHES.values()), f"LM training launched a kernel: {ops.LAUNCHES}"
    return out


# a decode step's bytes allocated (``torch.cuda.memory_stats``), as a
# multiple of the caches' elements at bf16 width, per cache dtype: one copy
# of each cache a step (the int8 cache also widened to one bf16 operand per
# layer) and the float32 scores; ~2.2 (bf16) / ~2.4 (int8) when a step
# copied each cache twice, ~6.2 with a float32 copy of each cache per
# product before that (PERF.md section 5)
CACHE_ALLOC_BOUND = {"bfloat16": 1.5, "int8": 2.0}


def long_context_phase(dev, out, cfg=None, batch=8, context=8192, gen=8, long=32768,
                       seed=0, repeats=2, hold_storage=True):
    """Phase (j3): smollm-135m's decode over long caches, bf16 and int8.

    1. ``batch`` sequences prefilled with ``context`` seeded tokens, then
       ``gen`` greedy decode steps: decode == forward (the forward's last
       ``gen`` + 1 positions) within ``LM_CACHE_REL_BOUND`` of the logit
       scale.
    2. At ``context`` and at ``long`` positions (caches of seeded values,
       no prefill), ``repeats`` runs of ``gen`` steps each: decode ms per
       step (host clock to a synchronise), the peak device memory of a
       step above what is resident and the bytes a step allocates
       (``allocated_bytes``), held at ``CACHE_ALLOC_BOUND`` times the
       caches' elements at bf16 width; the bytes a step must move
       (weights, both caches read once) beside those of the step's one
       copy of the caches (each cache read and written once).
    3. ``attention._contract_cache`` (the card's ``bmm`` per kv head) on
       layer 0's stored long cache, scores and values, against the
       float32 einsum of the same values, each element within what two
       float32 sums of its K terms may be off by (2 K u sum|a c|, u =
       2^-24): on the card the bf16 GEMM's error grows with the number
       of positions (within 1e-5 of the largest value at 1000, 1.9e-4
       at 32 768), so a bound on the largest value alone does not hold.
    4. ``_write_slot`` alone on one layer's cache at ``long``: ms and its
       bytes.

    ``tools/long_context_decode.py`` runs this phase on another tree of
    the port (an earlier contraction, for one) with ``hold_storage=False``:
    steps 1, 2 and 4 without the allocation bound, no step 3."""
    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_flatten_with_paths
    from repro_torch.models import attention as attn

    plan = M.DEFAULT_PLAN
    cfg = cfg or get_config("smollm-135m")
    params = M.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    w_bytes = sum(x.numel() * x.element_size() for _, x in tree_flatten_with_paths(params))
    g = np.random.default_rng(seed + 7)
    prompt = torch.from_numpy(g.integers(0, cfg.vocab, size=(batch, context))).to(dev)
    out.update(batch=batch, context=context, long=long, gen=gen, weight_bytes=w_bytes,
               caches={})
    sync = torch.cuda.synchronize

    def decode_run(st, first, start, n):
        """``n`` greedy steps from ``st``: (logits list, ms per step, peak
        above resident, bytes allocated per step)."""
        nxt, logits = first, []
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
        t0 = time.perf_counter()
        for i in range(n):
            pos = torch.full((), start + i, dtype=torch.int32, device=dev)
            lg, st = M.decode_step(params, st, nxt, pos, cfg, plan)
            nxt = torch.argmax(lg, -1).to(torch.int32)
            logits.append(lg)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / n
        alloc = (torch.cuda.memory_stats()["allocated_bytes.all.allocated"] - a0) / n
        return logits, ms, torch.cuda.max_memory_allocated() - base, alloc

    def sizes(st):
        """(bytes of the state, the caches' elements at bf16 width)."""
        leaves = [x for _, x in tree_flatten_with_paths(st)]
        return (sum(x.numel() * x.element_size() for x in leaves),
                2 * sum(x.numel() for x in leaves if x.dtype in (torch.bfloat16, torch.int8)))

    def timed(rec, st, first, start, name):
        """``repeats`` decode runs from ``st`` into ``rec``; bytes held."""
        n_bytes, bf16_width = sizes(st)
        rec.update(cache_bytes=n_bytes, bytes_to_move=w_bytes + n_bytes,
                   write_slot_copy_bytes=2 * n_bytes, decode_ms_per_step=[],
                   peak_above_resident=[], allocated_bytes_per_step=[])
        for _ in range(repeats):
            with torch.no_grad():
                _, ms, peak, alloc = decode_run(st, first, start, gen)
            rec["decode_ms_per_step"].append(ms)
            rec["peak_above_resident"].append(peak)
            rec["allocated_bytes_per_step"].append(alloc)
        rec["allocated_per_bf16_cache_byte"] = max(rec["allocated_bytes_per_step"]) / bf16_width
        assert (not hold_storage
                or rec["allocated_per_bf16_cache_byte"] <= CACHE_ALLOC_BOUND[name]), rec

    for name, dt in (("bfloat16", torch.bfloat16), ("int8", torch.int8)):
        rec = out["caches"][name] = {}
        st0 = M.init_decode_state(cfg, plan, batch, context + gen, cache_dtype=dt, device=dev)
        with torch.no_grad():
            lg0, st0 = M.prefill(params, {"tokens": prompt}, cfg, plan, st0)
        first = torch.argmax(lg0, -1).to(torch.int32)
        with torch.no_grad():
            steps_lg = decode_run(st0, first, context, gen)[0]
        # decode == forward over the decoded tokens
        toks = [first] + [torch.argmax(x, -1).to(torch.int32) for x in steps_lg[:-1]]
        seq = torch.cat([prompt, torch.stack(toks, 1)], 1)
        with torch.no_grad():
            full = _tail_logits(params, {"tokens": seq}, cfg, seq.shape[1] - context + 1)
        scale = float(full.abs().max())
        err = max(float((a - full[:, i]).abs().max()) for i, a in enumerate([lg0] + steps_lg))
        rec["rel_err_vs_forward"] = err / scale
        assert err / scale < LM_CACHE_REL_BOUND, (name, err, scale)
        del full, steps_lg
        timed(rec, st0, first, context, name)
        del st0

        # a long cache of seeded values, no prefill: time and memory only
        st = M.init_decode_state(cfg, plan, batch, long, cache_dtype=dt, device=dev)
        gen_t = torch.Generator(device=dev).manual_seed(seed + 11)
        for _, leaf in tree_flatten_with_paths(st):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen_t, device=dev))
            elif leaf.is_floating_point():
                leaf.copy_(torch.rand(leaf.shape, generator=gen_t, device=dev) * 0.02)
        long_rec = rec[f"at_{long}"] = {}
        timed(long_rec, st, first, long - gen, name)
        ck, cv = st["stacks"][0]["k"][0], st["stacks"][0]["v"][0]
        if hold_storage:   # the contraction on one layer's stored cache against float32
            b, t, hkv, dh = ck.shape
            grp = cfg.n_heads // hkv
            qg = torch.randn((b, hkv, grp, dh), generator=gen_t, device=dev)
            wts = torch.softmax(torch.randn((b, hkv, grp, t), generator=gen_t, device=dev), -1)
            held = {}
            for spec, a, c in (("bngd,btnd->bngt", qg, ck), ("bngt,btnd->bngd", wts, cv)):
                with torch.no_grad():
                    got = attn._contract_cache(spec, a, c)
                    ab, cf = a.to(torch.bfloat16).to(torch.float32), c.to(torch.float32)
                    want = torch.einsum(spec, ab, cf)
                    # a float32 sum of K terms: off by at most K u sum|terms| each
                    bound = 2 * a.shape[-1] * 2.0**-24 * torch.einsum(spec, ab.abs(), cf.abs())
                    err = (got - want).abs()
                held[spec] = {"rel_max": float(err.max()) / float(want.abs().max()),
                              "share_of_f32_sum_bound": float((err / bound).max())}
                del got, ab, cf, want, bound, err
            long_rec["contract_cache_vs_float32"] = held
            assert all(h["share_of_f32_sum_bound"] <= 1 for h in held.values()), held
        # _write_slot alone on one layer's key cache
        new = ck[:, :1].clone()
        slot = torch.full((), long - 1, dtype=torch.int32, device=dev)
        long_rec["write_slot_one_cache_ms"] = _time_ms(lambda: attn._write_slot(ck, new, slot))
        long_rec["write_slot_one_cache_bytes"] = 2 * ck.numel() * ck.element_size()
        print(json.dumps({"j_long_context_" + name: rec}))
        del st, ck, cv
    return out


def distributed_phase(dev, out, params, cfg_s, cfg_g, ckpt_dir, backend="nccl", lm_cfg=None,
                      batch=8, seq=512, steps=3, capacity=CAPACITY, ticks=12,
                      pipe_seq=128, n_micro=8, seed=0):
    """Phase (k): the distributed layer on one card, in a process group of
    world size 1 (``backend`` NCCL; gloo only to rehearse on the CPU).

    k1: smollm-135m (``get_config``'s, ``lm_cfg`` to rehearse) trained
    ``steps`` steps at ``batch`` x ``seq``, bf16 compute, once as plain
    tensors and once as ``DTensor``s on a (1, 1) ("data", "model")
    ``DeviceMesh`` laid out by ``plan_for`` / ``shardings_for`` under
    ``constrainer_ctx``: losses within 2e-4 and parameters within 5e-5 (the
    reference's bounds), printed; step ms and device launches a step for
    both. k2: ``pipeline_forward`` over the model's layers as one stage with
    ``n_micro`` microbatches against the layers run in turn (1e-6);
    ``apply_moe_a2a`` against ``moe.apply_moe`` on the qwen3-moe smoke
    config (1e-5, aux 1e-6); one compressed all-reduce of the full gradient
    tree against ``quantize_ef``'s dequantised codes (bitwise). k3: the
    slot-sharded engines at the width of ``cfg_s`` / ``cfg_g``, ``capacity``
    slots, ``ticks`` ticks of scenes that change every 4 ticks: a
    ``LocalMesh`` of the card 4 times and of the card once, the staged
    route (kernels 6 + 5) and the gated one (temporal gate and delta
    backend: kernels 2 + 3 + 5), each against the unsharded engine (logits
    within 1e-5, gaze and ``n_stale`` equal), every kernel result of the
    4-shard runs held against its plain version (``_recording``,
    ``_hold_served``), the launch counts reset before and read after each
    4-shard run (4x the unsharded ones a tick), tick ms; capacity
    ``capacity - 2`` runs unsharded; a fleet of 2 hosts over
    ``make_fleet_meshes(2, devices=[card] * 4)``. k4: k1's ``DTensor``
    state saved and restored onto ``Replicate`` and onto ``Shard(0)``, and
    a checkpoint saved from CPU tensors restored onto the mesh: bytes
    equal. Fills ``out``; returns the 4-shard runs' launches by kernel."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import models as M
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, smoke_config
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.convert import tree_flatten_with_paths, tree_map, tree_to, tree_unflatten
    from repro_torch.data.pipeline import DataConfig, SceneStream, TokenStream
    from repro_torch.distributed.pipeline import pipeline_forward, split_layers_to_stages
    from repro_torch.examples.train_lm import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.launch.shardings import (Sharding, constrainer_ctx, plan_for, shard_tree,
                                              shardings_for)
    from repro_torch.models import blocks as blk
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.moe_a2a import apply_moe_a2a
    from repro_torch.models.sharding_ctx import P
    from repro_torch.optim import AdamWConfig, init_opt_state, opt_state_specs
    from repro_torch.optim.compression import make_compressed_allreduce, quantize_ef
    from repro_torch.serve.engine import SaccadeEngine
    from repro_torch.serve.fleet import SaccadeFleet, make_fleet_meshes
    from repro_torch.train.train_step import make_grads_fn, make_train_step

    def leaves(tree):
        return [x for _, x in tree_flatten_with_paths(tree)]

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, rank=0, world_size=1, store=dist.HashStore())
    try:
        out["process_group"] = {
            "backend": dist.get_backend(), "world_size": dist.get_world_size(),
            "nccl_version": (".".join(map(str, torch.cuda.nccl.version()))
                             if backend == "nccl" else None),
            "device_count": torch.cuda.device_count()}
        print(json.dumps({"k_process_group": out["process_group"]}))
        if dev.type == "cuda":
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip())

        # ---- k1: the sharded LM train step -----------------------------
        cfg = lm_cfg or get_config("smollm-135m")
        mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
        plan = plan_for(cfg, mesh)
        opt = AdamWConfig(lr=1e-3)
        init = M.init_params(torch.Generator().manual_seed(seed), cfg, plan, device="cpu")
        stream = TokenStream(DataConfig(seed=seed + 1, vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch))
        data = [token_batches(cfg, stream, batch, dev)(s) for s in range(steps)]
        step = make_train_step(cfg, plan, opt, compute_dtype=torch.bfloat16, warmup=2,
                               total_steps=steps)
        pspecs = M.param_specs(cfg, plan)
        b_sh = {"tokens": Sharding(mesh, P(plan.dp_axes, None))}

        def run(sharded):
            p = tree_to(init, dev)
            o = init_opt_state(p, opt)
            if sharded:
                p_sh = shardings_for(pspecs, p, mesh)
                p = shard_tree(p, p_sh)
                o = shard_tree(o, shardings_for(opt_state_specs(pspecs), o, mesh))
            losses, ms = [], []
            for s in range(steps):
                b = shard_tree(data[s], b_sh) if sharded else data[s]
                sync()
                t0 = time.perf_counter()
                with constrainer_ctx(mesh if sharded else None, plan):
                    p, o, m = step(p, o, b)
                losses.append(float(full(m["loss"])))
                ms.append((time.perf_counter() - t0) * 1e3)
            b = shard_tree(data[0], b_sh) if sharded else data[0]
            with constrainer_ctx(mesh if sharded else None, plan):
                by_name = _device_by_name(lambda: step(p, o, b)) if dev.type == "cuda" else []
            return p, o, losses, ms, by_name

        k1 = out["k1"] = {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                          "batch": batch, "seq": seq, "steps": steps}
        runs = {}
        for name, sharded in (("plain", False), ("dtensor", True)):
            p, o, losses, ms, by_name = run(sharded)
            runs[name] = (p, o)
            k1[name] = {"losses": losses, "step_ms": ms,
                        "step_ms_after_first": float(np.median(ms[1:])) if steps > 1 else None,
                        "device_launches": sum(n for *_, n in by_name),
                        "device_ms": sum(ms_ for _, ms_, _ in by_name)}
        (pa, _), (pb, ob) = runs["plain"], runs["dtensor"]
        k1["loss_diff"] = max(abs(a - b) for a, b in zip(k1["plain"]["losses"],
                                                          k1["dtensor"]["losses"]))
        k1["param_diff"] = max(float((a.float() - full(b).float()).abs().max())
                               for a, b in zip(leaves(pa), leaves(pb)))
        k1["all_dtensor"] = all(type(x).__name__ == "DTensor" for x in leaves(pb) + leaves(ob))
        print(json.dumps({"k1": k1}))
        assert k1["all_dtensor"], "the sharded step left DTensor land"
        assert all(np.isfinite(k1["dtensor"]["losses"])), k1
        assert k1["loss_diff"] < 2e-4, k1
        assert k1["param_diff"] < 5e-5, k1

        # ---- k2: the collectives at world size 1 -------------------------
        k2 = out["k2"] = {}
        pod = init_device_mesh(dev.type, (1,), mesh_dim_names=("pod",))
        stacks = split_layers_to_stages(pa["stacks"][0], 1)
        kind = cfg.block_pattern[0]
        positions = torch.arange(pipe_seq, device=dev)

        def stage_fn(p_stage, x):
            for i in range(p_stage["norm1"].shape[0]):
                x, _, _ = blk.apply_block({k_: _index(v, i) for k_, v in p_stage.items()},
                                          kind, x, cfg, positions, None)
            return x

        g = torch.Generator().manual_seed(seed + 2)
        mbs = (torch.randn((n_micro, 1, pipe_seq, cfg.d_model), generator=g) * 0.5).to(dev)
        with torch.no_grad():
            got = pipeline_forward(stacks, mbs, stage_fn, pod)
            seq_out = torch.stack([stage_fn(_index_tree(stacks, 0), mbs[i])
                                   for i in range(n_micro)])
        k2["pipeline"] = {"layers": cfg.n_layers, "n_micro": n_micro, "seq": pipe_seq,
                          "max_abs_err": float((got - seq_out).abs().max()),
                          "finite": bool(torch.isfinite(got).all())}
        mcfg = smoke_config("qwen3-moe-235b-a22b")
        mp = tree_to(moe_mod.init_moe(torch.Generator().manual_seed(seed + 3), mcfg), dev)
        xm = (torch.randn((4, 16, mcfg.d_model), generator=g) * 0.5).to(dev)
        m11 = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
        with torch.no_grad():
            o_a2a, aux_a2a = apply_moe_a2a(mp, xm, mcfg, m11, ("data",), "model")
            o_ref, aux_ref = moe_mod.apply_moe(mp, xm, mcfg)
        k2["moe_a2a"] = {"max_abs_err": float((o_a2a - o_ref).abs().max()),
                         "aux_err": abs(float(aux_a2a) - float(aux_ref))}
        grads = make_grads_fn(cfg, plan, opt, compute_dtype=torch.bfloat16)(
            tree_to(init, dev), data[0])[2]
        errs = [torch.zeros(x.shape, dtype=torch.float32, device=dev) for x in leaves(grads)]
        fn = make_compressed_allreduce(mesh, "data")
        mean, new_err = fn(grads, tree_unflatten(grads, errs))
        same = True
        for gl, ml, el in zip(leaves(grads), leaves(mean), leaves(new_err)):
            scale = torch.clamp_min(gl.float().abs().amax(), 1e-12) / torch.full(
                (), 127.0, device=dev)
            codes, e2 = quantize_ef(gl, torch.zeros_like(el), scale)
            same &= torch.equal(ml, codes.float() * scale) and torch.equal(el, e2)
        k2["compressed_allreduce"] = {"leaves": len(errs), "bitwise": bool(same),
                                      "elements": sum(e.numel() for e in errs)}
        print(json.dumps({"k2": k2}))
        assert k2["pipeline"]["finite"] and k2["pipeline"]["max_abs_err"] <= 1e-6, k2
        assert k2["moe_a2a"]["max_abs_err"] <= 1e-5 and k2["moe_a2a"]["aux_err"] <= 1e-6, k2
        assert same, "compressed all-reduce differs from quantize_ef's codes"
        del grads, mean, new_err, errs

        # ---- k3: the slot-sharded engines ---------------------------------
        k3 = out["k3"] = {}
        pool, _ = SceneStream(seed=seed + 9, image=cfg_s.frontend.image_h).batch(0, 24)
        sids = list(range(capacity))
        clip = [{s: pool[(s + t // 4) % len(pool)] for s in sids} for t in range(ticks)]
        mesh4, mesh1 = LocalMesh([dev] * 4), LocalMesh([dev])
        launched = {n: 0 for n in ops.LAUNCHES}
        for route, cfg_r, kw in (
                ("staged", cfg_s, {}),
                ("gated", cfg_g, {"temporal": True, "backend_delta": True})):
            pf = ops.ip2_codes_fn(cfg_r.frontend.patch, cfg_r.frontend.adc)

            def engine(cap=capacity, **mk):
                e = SaccadeEngine(cfg_r, params, capacity=cap, project_fn=pf, **kw, **mk)
                for s in range(cap):
                    e.admit(s)
                return e

            def serve(e):
                rows, per_tick = [], []
                for t in range(ticks):
                    pre = dict(ops.LAUNCHES)
                    o = e.step(clip[t])
                    per_tick.append(sum(ops.LAUNCHES[n] - pre[n] for n in pre))
                    st = e.state
                    rows.append((np.stack([o[s] for s in sids]), st.indices.cpu(),
                                 None if st.cache is None else st.cache.n_stale.cpu()))
                return rows, per_tick

            base, base_ticks = serve(engine(device=dev))
            rec = k3[route] = {"unsharded_launches_per_tick": base_ticks}
            for mname, mesh_r in (("x4", mesh4), ("x1", mesh1)):
                e = engine(mesh=mesh_r)
                with _recording(ops) as calls:
                    ops.reset_launches()
                    rows, per_tick = serve(e)
                    counts = dict(ops.LAUNCHES)
                if mname == "x4":
                    for n, c in counts.items():
                        launched[n] += c
                    rec["held"] = {n: {k_: v for k_, v in h.items() if k_ != "shapes"}
                                   for n, h in _hold_served(calls).items()}
                del calls
                err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(rows, base))
                gaze = all(torch.equal(a[1], b[1]) for a, b in zip(rows, base))
                stale = all(a[2] is None or torch.equal(a[2], b[2]) for a, b in zip(rows, base))
                rec[mname] = {"n_shards": e.n_shards, "max_abs_err": err, "gaze_equal": gaze,
                              "n_stale_equal": stale, "launches": counts,
                              "launches_per_tick": per_tick,
                              "tick_ms": _host_ms(lambda: e.step(clip[0]), n=5, warm=1)
                              if dev.type == "cuda" else None}
                assert e.n_shards == (4 if mname == "x4" else 1), rec[mname]
                assert err <= 1e-5 and gaze and stale, (route, mname, rec[mname])
            u = engine(device=dev)
            rec["unsharded_tick_ms"] = (_host_ms(lambda: u.step(clip[0]), n=5, warm=1)
                                        if dev.type == "cuda" else None)
            rec["launch_ratio"] = (sum(rec["x4"]["launches_per_tick"])
                                   / max(1, sum(base_ticks)))
            print(json.dumps({"k3_" + route: {k_: v for k_, v in rec.items() if k_ != "held"}}))
        odd = SaccadeEngine(cfg_s, params, capacity=capacity - 2, mesh=mesh4)
        k3["odd_capacity_shards"] = odd.n_shards
        assert odd.n_shards == 1, "an indivisible capacity was sharded"
        pf = ops.ip2_codes_fn(cfg_s.frontend.patch, cfg_s.frontend.adc)
        fleet = SaccadeFleet(cfg_s, params, n_hosts=2, capacity=capacity // 2, project_fn=pf,
                             meshes=make_fleet_meshes(2, devices=[dev] * 4))
        whole = SaccadeEngine(cfg_s, params, capacity=capacity, project_fn=pf, device=dev)
        for s in sids:
            fleet.submit(s)
            whole.admit(s)
        fleet.drain()
        f_err, f_gaze = 0.0, True
        for t in range(4):
            a, b = fleet.step(clip[t]), whole.step(clip[t])
            f_err = max(f_err, max(float(np.abs(a[s] - b[s]).max()) for s in sids))
            f_gaze &= all((fleet.engines[fleet.host_of(s)].gaze(s) == whole.gaze(s)).all()
                          for s in sids)
        k3["fleet"] = {"hosts": 2, "shards": [e.n_shards for e in fleet.engines],
                       "max_abs_err": f_err, "gaze_equal": bool(f_gaze)}
        print(json.dumps({"k3_fleet": k3["fleet"], "odd_capacity_shards": odd.n_shards}))
        assert k3["fleet"]["shards"] == [2, 2] and f_err <= 1e-5 and f_gaze, k3["fleet"]
        del fleet, whole, odd

        # ---- k4: elastic restore on the card ------------------------------
        k4 = out["k4"] = {}
        state = {"params": pb, "opt": ob}
        want = [full(x).detach().cpu() for x in leaves(state)]
        like = {"params": tree_to(init, "cpu"), "opt": init_opt_state(init, opt)}
        cm = CheckpointManager(str(ckpt_dir / "dtensor"))
        cm.save(1, state, blocking=True)

        def same_bytes(tree, ref_leaves):
            return all(torch.equal(full(x).detach().cpu().reshape(-1).view(torch.uint8),
                                   w.reshape(-1).view(torch.uint8))
                       for x, w in zip(leaves(tree), ref_leaves))

        def placed(tree, shard0):
            # explicit placements: a Shard() over a size-1 axis, which
            # placements_for writes as Replicate(), is still a layout
            # restore must take
            return tree_map(lambda x: types.SimpleNamespace(mesh=mesh, placements=(
                Shard(0) if shard0 and x.dim() else Replicate(), Replicate())), tree)

        for name, shard0 in (("replicate", False), ("shard0", True)):
            got, step_no = cm.restore(like, shardings=placed(like, shard0))
            pl = {str(tuple(x.placements)) for x in leaves(got)}
            k4[name] = {"step": step_no, "bytes_equal": same_bytes(got, want),
                        "placements": sorted(pl)}
            assert k4[name]["bytes_equal"] and step_no == 1, k4
            del got
        cpu_params = tree_to(init, "cpu")
        CheckpointManager(str(ckpt_dir / "cpu")).save(2, cpu_params, blocking=True)
        got, _ = CheckpointManager(str(ckpt_dir / "cpu")).restore(
            cpu_params, shardings=placed(cpu_params, True))
        k4["from_cpu"] = {"bytes_equal": same_bytes(got, leaves(cpu_params)),
                          "device": str(leaves(got)[0].device)}
        print(json.dumps({"k4": k4}))
        assert k4["from_cpu"]["bytes_equal"], k4
        return launched
    finally:
        dist.destroy_process_group()


def fused_past_tile_phase(dev, out, n_slots=CAPACITY, n_patches=64, k=16, kk=1024, d=256,
                          seed=24):
    """Phase (l1): ``ip2_fused_embed`` where the bank's code tile does not
    fit a block's shared memory in one chunk (M 2560 int8, 1280 int16, 640
    int32: 2 chunks; M 5000 int8: 3), on ``n_slots`` x ``k`` of
    ``n_patches`` patches of ``kk`` pixels, D ``d``, with ragged counts:
    bitwise the staged kernels and bitwise its plain version on the rows
    whose codes agree; device ms beside the staged pair's, the plain
    version's ms and the bound of the live rows' work."""
    import torch
    from repro_torch.core import saliency as sal
    from repro_torch.core.adc import ADCSpec
    from repro_torch.core.projection import PatchSpec
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n_slots, n_patches, kk), generator=g).to(dev)
    idx = torch.stack([torch.randperm(n_patches, generator=g)[:k]
                       for _ in range(n_slots)]).int().to(dev)
    cnt = torch.tensor([(0, 5, k, 11)[i % 4] for i in range(n_slots)], dtype=torch.int32,
                       device=dev)
    live = torch.arange(k, device=dev)[None, :] < cnt[:, None]
    gathered = sal.gather_patches(x, idx)
    for bits, m in ((8, 2560), (16, 1280), (32, 640), (8, 5000)):
        spec = PatchSpec(32, 32, n_vectors=m)
        adc = ADCSpec(bits=bits)
        w = (torch.randn((m, kk), generator=g) * 6.4).to(dev)
        w8, s_w = ops.quantize_weights_int8((torch.randn((m, d), generator=g) * 0.1).to(dev))
        n0 = ops.LAUNCHES["ip2_fused_embed"]
        fused = ops.ip2_fused_embed(x, w, idx, spec, adc, w8, s_w, row_counts=cnt)
        assert ops.LAUNCHES["ip2_fused_embed"] == n0 + 1, "ip2_fused_embed did not launch"
        codes = ops.ip2_project(gathered, w, spec, adc=adc, codes=True)
        staged = torch.where(live[..., None], ops.quant_matmul_pre(codes, adc.lsb, w8, s_w),
                             torch.zeros((), device=dev))
        assert torch.equal(fused.view(torch.int32), staged.view(torch.int32)), \
            f"M {m}, {bits}-bit codes: ip2_fused_embed differs from the staged kernels"
        w_t = ops._dac_weights(w, spec).T.contiguous()
        table, cnt_c = ops._ragged_tables(idx, n_patches, cnt)
        p_codes = ops.kernel_params_from_spec(spec, adc, codes=True)
        flat = x.reshape(-1, kk)
        plain = ref.ip2_fused_embed_ref(table, cnt_c, flat, w_t, w8, s_w, p_codes,
                                        k).reshape(fused.shape)
        plain_codes = ref.ip2_project_ref(flat[table.long()], w_t,
                                          torch.zeros(m, device=dev), p_codes)
        same = (plain_codes.reshape(codes.shape) == codes).all(-1)
        assert torch.equal(fused[same].view(torch.int32), plain[same].view(torch.int32)), \
            f"M {m}, {bits}-bit codes: ip2_fused_embed differs from its plain version"
        zero = torch.zeros(m, device=dev)
        s_a = torch.full((n_slots * k,), adc.lsb, dtype=torch.float32, device=dev)
        flat_g = gathered.reshape(-1, kk).contiguous()
        n_live = int(live.sum())
        bound, bound_by = _bound(n_live * kk * 4 + kk * m * 4 + m * d + d * 4
                                 + n_slots * k * d * 4, fp32_flops=2.0 * n_live * kk * m,
                                 int8_ops=2.0 * n_live * m * d)
        rec = {"bits": bits, "m": m, "rows": n_slots * k, "live_rows": n_live,
               "rows_codes_agree": int(same.sum()), "bound_ms": bound, "bound_by": bound_by,
               "plain_ms": _time_ms(lambda: ref.ip2_fused_embed_ref(
                   table, cnt_c, flat, w_t, w8, s_w, p_codes, k), n=5, warm=1),
               "device_ms": _device_ms(lambda: ops._fused_embed_cuda(
                   table, cnt_c, flat, w_t, w8, s_w, adc.lsb, p_codes, k),
                   kernel="ip2_fused_embed_kernel"),
               "staged_device_ms": _device_ms(lambda: ops._quant_matmul_cuda(
                   ops._ip2_project_cuda(flat_g, w_t, zero, p_codes), s_a, w8, s_w))}
        out[f"M{m}_{bits}bit"] = rec
        print(json.dumps({"l1_fused_past_tile": rec}))


def dryrun_l2_phase(out, arch="llama3-8b", shape="train_4k", mesh="single"):
    """Phase (l2): the dry run of one production cell on fake ranks (256
    for the single pod), with its roofline points; the record's memory,
    microbatches, bottleneck and seconds."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, mesh)
    rec["wall_s"] = time.perf_counter() - t0
    out["record"] = rec
    rl = rec["roofline"]
    brief = {"cell": f"{arch}/{shape}/{mesh}", "chips": rec["chips"], "plan": rec["plan"],
             "microbatches": rec["microbatches"], "memory": rec["memory"],
             "microbatch_trail": rec["microbatch_trail"],
             "full_collectives": rec["full_collectives"],
             "bottleneck": rl["bottleneck"], "t_compute_s": rl["t_compute_s"],
             "t_memory_s": rl["t_memory_s"], "t_collective_s": rl["t_collective_s"],
             "useful_flops_ratio": rl["useful_flops_ratio"],
             "lower_s": rec["lower_s"], "compile_s": rec["compile_s"], "wall_s": rec["wall_s"]}
    print(json.dumps({"l2_dryrun": brief}))
    assert rec["chips"] == 256 and rl["flops_per_chip"] > 0


def estimate_phase(dev, out, cfg=None, batch=8, seq=512, seed=0):
    """Phase (l3): the dry run's estimate of one training step against the
    step on the card. smollm-135m (``cfg`` replaces it to rehearse on the
    CPU) at batch x seq, bf16 compute on float32 masters, remat
    ``"nothing"`` (phase j2's setup): ``lower_cell`` on a fake (1, 1) mesh,
    then the same step on real tensors after a warm-up step. Held: the
    estimate's peak above its arguments within ``ESTIMATE_PEAK_REL`` of
    ``max_memory_allocated`` above what was resident before the step, and
    its flops equal to ``FlopCounterMode``'s count of the real step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import plan_for, train_plan_for
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.roofline.trace import fake_world
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(cfg or get_config("smollm-135m"), remat=True,
                              remat_policy="nothing")
    shape = ShapeConfig("l3", seq, batch, "train")
    with fake_world(1):
        mesh = make_host_mesh(1, 1, device_type=dev.type)
        plan = plan_for(cfg, mesh)
        tr = dryrun.lower_cell(cfg, shape, mesh, plan)
    tplan = train_plan_for(cfg)
    opt = AdamWConfig(moment_dtype=getattr(torch, tplan.moment_dtype))
    params = lm.init_params(torch.Generator().manual_seed(seed), cfg, plan,
                            dtype=getattr(torch, tplan.param_dtype), device=dev)
    ostate = init_opt_state(params, opt)
    g = torch.Generator().manual_seed(seed + 1)
    batch_in = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                                        dtype=torch.int32).to(dev)}
    step = make_train_step(cfg, plan, opt)
    warm = step(params, ostate, batch_in)       # workspaces and allocator warm-up
    del warm
    # no garbage of earlier phases may be collected inside the measured step
    # (it would lower the allocated bytes the peak is read against)
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        new = step(params, ostate, batch_in)
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated() - resident
        card_kept = torch.cuda.memory_allocated() - resident
    finally:
        gc.enable()
    del new
    with FlopCounterMode(display=False) as fc:
        new = step(params, ostate, batch_in)
    del new
    est_peak = tr.peak_bytes - tr.argument_bytes
    rec = {"cfg": cfg.name, "batch": batch, "seq": seq, "resident_bytes": resident,
           "argument_bytes": tr.argument_bytes, "output_bytes": tr.output_bytes,
           "estimate_peak_above_arguments": est_peak, "card_peak_above_resident": card_peak,
           "card_kept_after_step": card_kept,
           "peak_rel_err": est_peak / card_peak - 1.0, "estimate_flops": tr.flops,
           "card_flops": fc.get_total_flops(), "estimate_step_s": tr.step_s}
    out.update(rec)
    print(json.dumps({"l3_estimate_vs_card": rec}))
    assert abs(rec["peak_rel_err"]) <= ESTIMATE_PEAK_REL, rec
    assert rec["estimate_flops"] == rec["card_flops"], rec


# The reference's compiled cells on the production mesh: its ``lower_cell``
# compiled for 256 forced CPU devices on an ``Auto`` (16, 16) ("data",
# "model") mesh (jax 0.9.0), ``memory_analysis()`` per device: (argument
# bytes, output bytes). Its output size also counts the result tuple's
# 8-byte pointer per output leaf (``tests/test_torch_dryrun.py``).
REFERENCE_FAULT_CELLS = {
    ("xlstm-1.3b", "decode_32k"): (596_606_400, 353_335_984),
    ("xlstm-1.3b", "long_500k"): (287_481_668, 44_167_236),
    ("recurrentgemma-2b", "long_500k"): (488_327_304, 16_838_116),
}


def dryrun_faults_phase(out, cells=REFERENCE_FAULT_CELLS, device_type="cuda", cfg_of=None,
                        mesh_shape=(16, 16), shapes=None):
    """Phase (l4): the cells the port's dry run once raised on (xlstm's 4
    heads on the 16-way model axis; long_500k's batch of one on 16 data
    ranks), each one step on the production mesh of fake ranks
    (``lower_cell``, no roofline points): the plan, the argument bytes per
    rank equal to the reference's and the output bytes plus the tuple's
    8 B a leaf equal to its, by ``tests/test_torch_dryrun.py``'s rules;
    seconds a cell. ``cfg_of``, ``mesh_shape`` and ``shapes`` (a name ->
    ``ShapeConfig`` map) replace the production ones to rehearse on the
    CPU; an expected ``None`` is not compared."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import plan_for
    from repro_torch.roofline.trace import fake_world

    cfg_of, shapes = cfg_of or get_config, shapes or SHAPES
    out["cells"] = {}
    for (arch, shape), want in cells.items():
        t0 = time.perf_counter()
        with fake_world(mesh_shape[0] * mesh_shape[1]):
            mesh = make_host_mesh(*mesh_shape, device_type=device_type)
            cfg = cfg_of(arch)
            plan = plan_for(cfg, mesh)
            tr = dryrun.lower_cell(cfg, shapes[shape], mesh, plan)
        rec = out["cells"][f"{arch}/{shape}"] = {
            "plan": {"tp": plan.tp, "fsdp": plan.fsdp}, "argument_bytes": tr.argument_bytes,
            "output_bytes": tr.output_bytes, "n_outputs": tr.n_outputs,
            "peak_bytes": tr.peak_bytes, "step_s": tr.step_s, "s": time.perf_counter() - t0}
        if want is not None:
            rec["reference"] = {"argument_bytes": want[0], "output_bytes": want[1]}
        print(json.dumps({"l4_dryrun_fault_cell": {"cell": f"{arch}/{shape}", **rec}}))
        if want is not None:
            assert rec["argument_bytes"] == want[0], rec
            assert rec["output_bytes"] + 8 * rec["n_outputs"] == want[1], rec


DRYRUN_PHASES = ("l2_dryrun", "l4_dryrun_faults")


def dryrun_worker(path):
    """Phases l2 and l4 in a process of their own, which ``main`` starts
    before the build and waits for before the first phase it times: both
    trace on fake tensors on the host's CPU. Each phase's record (or its error) and seconds, as
    JSON at ``path``; the lines the phases print go to this process's
    output. Its kernel launch counts must stay 0."""
    from repro_torch.kernels import ops

    res = {}
    for name, fn in zip(DRYRUN_PHASES, (dryrun_l2_phase, dryrun_faults_phase)):
        out, t0 = {}, time.perf_counter()
        try:
            ops.reset_launches()
            fn(out)
            assert not any(ops.LAUNCHES.values()), f"the dry run launched {ops.LAUNCHES}"
            res[name] = {"ok": True, "out": out}
        except Exception:
            res[name] = {"ok": False, "error": traceback.format_exc()}
        res[name]["s"] = time.perf_counter() - t0
    Path(path).write_text(json.dumps(res, default=str))


# ---------------------------------------------------------------------------
# (m) the LM families at their own widths
# ---------------------------------------------------------------------------

# One entry a family: ``layers`` cuts the depth to what one card holds (the
# whole model otherwise); ``batch`` x ``prompt`` tokens are prefilled and
# ``gen`` greedy steps decoded with each of ``caches``; ``image`` is the
# IP2 image's edge in pixels; ``long`` decodes a batch over seeded bf16
# caches of that many positions (llama3-8b's decode_32k); ``long_pos``
# decodes from that position on the state prefill left (long_500k);
# ``train`` runs that many steps of ``make_train_step`` (``dtype``:
# parameters and AdamW moments in that dtype, float32 otherwise). xlstm
# trains on 2048 tokens, not 4096: its sLSTM loops over the positions
# forward, again under remat and backward, so a step at 4096 took 88-105 s
# on the card, at 2048 42-54 s (PERF.md §5).
# xlstm's bounds are twice what the port measures on the CPU at the same
# widths and depth, since float32 sums over its 1024-wide heads, through
# exponential gates, round apart by more than the 1e-4 of the other
# families. ``f32_rel_bound`` holds its float32 decode by the logit scale:
# the recurrent decode drifts from the parallel forward with depth
# (``tools/decode_drift.py``: 48 layers at its widths, prompt 4096, 32
# steps, the port on the H100 host's CPU 6.91e-4 of the scale, on the card
# 9.10e-4 with the same weights). ``card_cpu_bound`` /
# ``grad_bound`` replace ``FAMILY_CARD_CPU_BOUND`` for its card-vs-CPU
# logits and gradients at 8 layers: the port's CPU readings against the
# reference's at those 8 layers are 7.0e-5 (logits) and 2.36e-4 of a
# leaf's largest |g| (``tests/test_torch_lm_widths_recurrent.py``).
FAMILY_SPECS = (
    {"arch": "llama3-8b", "batch": 2, "prompt": 4096, "gen": 32,
     "caches": ("float32", "bfloat16", "int8"),
     "long": {"batch": 4, "positions": 32768, "gen": 8}},
    {"arch": "pixtral-12b", "repl": {"vision_frontend": "ip2"}, "batch": 1, "prompt": 512,
     "gen": 32, "image": 1024, "caches": ("float32",)},
    {"arch": "qwen2.5-32b", "layers": 8, "batch": 2, "prompt": 2048, "gen": 32,
     "caches": ("float32",)},
    {"arch": "qwen3-moe-235b-a22b", "layers": 4, "batch": 2, "prompt": 1024, "gen": 16,
     "caches": ("float32",)},
    {"arch": "recurrentgemma-2b", "batch": 1, "prompt": 8192, "gen": 32, "caches": ("float32",),
     "long_pos": 524288, "train": {"batch": 1, "seq": 4096, "steps": 3, "dtype": "bfloat16"}},
    {"arch": "xlstm-1.3b", "batch": 1, "prompt": 4096, "gen": 32, "caches": ("float32",),
     "f32_rel_bound": 2 * 6.91e-4, "card_cpu_bound": 2 * 7.0e-5, "grad_bound": 2 * 2.36e-4,
     "long_pos": 524288, "train": {"batch": 1, "seq": 2048, "steps": 3}},
    {"arch": "whisper-tiny", "batch": 4, "prompt": 64, "gen": 32, "caches": ("float32",),
     "train": {"batch": 4, "seq": 4096, "steps": 3}},
)
# decode against the forward: the float32 cache absolutely, bf16 / int8 by
# the logit scale (phase i's criteria); greedy tokens where the top-2 gap is
# wider than this (and than twice the decode's largest logit error)
FAMILY_F32_BOUND = 2e-4
GREEDY_GAP = 6e-3
# the card against the CPU at one repeat of the block pattern (2 layers of
# a one-block pattern): logits, and each gradient leaf by its largest |g|
FAMILY_CARD_CPU_BOUND = 1e-4


def _tree_bytes(tree):
    from repro_torch.convert import tree_flatten_with_paths
    return sum(x.numel() * x.element_size() for _, x in tree_flatten_with_paths(tree))


def _tail_logits(params, batch, cfg, n):
    """The forward's logits at the last ``n`` positions (B, n, V), without
    the (B, S, V) logits of the whole sequence."""
    from repro_torch import models as M
    from repro_torch.models import lm as lm_mod

    if cfg.is_encoder_decoder:
        return M.forward(params, batch, cfg)[0][:, -n:]
    x = lm_mod.embed_inputs(params, batch, cfg)
    x, _, _ = lm_mod._run_stacks(params, x, cfg, M.DEFAULT_PLAN)
    return lm_mod._logits(params, x[:, -n:], cfg)


def _first_layers(params, cfg, n_layers):
    """The parameters of the model's first ``n_layers`` (whole repeats of its
    block pattern): views of the stacks, no tail."""
    from repro_torch.convert import tree_map
    n_rep = n_layers // len(cfg.block_pattern)
    return dict(params, stacks=[tree_map(lambda a: a[:n_rep], s) for s in params["stacks"]],
                tail=[])


def _family_inputs(cfg, spec, rng, dev, batch, n_tokens, image=None):
    """Seeded tokens (batch, n_tokens) and the arch's other inputs."""
    import numpy as np
    import torch

    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(batch, n_tokens))).to(dev)}
    if cfg.is_vlm:
        edge = image or spec["image"]
        b["images_rgb"] = torch.from_numpy(
            rng.uniform(size=(batch, edge, edge, 3)).astype(np.float32)).to(dev)
    if cfg.is_encoder_decoder:
        b["frames"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.n_encoder_frames, cfg.d_model)).astype(np.float32)).to(dev)
    return b


def family_phase(dev, rec, spec, cfg, seed=0, check_image=64):
    """One family of phase (m) at ``cfg`` (its widths, the depth of
    ``spec["layers"]``): seeded weights drawn on the card, serving through
    ``make_prefill_step`` / ``make_decode_step`` with each cache dtype
    (decode == forward, greedy tokens), the long-position decode, the card
    against the CPU at one pattern repeat, the MoE's dropped pairs, and
    training steps; times and memory into ``rec``."""
    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.convert import tree_flatten_with_paths, tree_to
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    from repro_torch.train.train_step import cast_tree, make_grads_fn, make_train_step

    plan = M.DEFAULT_PLAN
    sync = torch.cuda.synchronize
    rng = np.random.default_rng(seed + 1)
    bsz, n_prompt, n_gen = spec["batch"], spec["prompt"], spec["gen"]
    rec.update(name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
               d_ff=cfg.d_ff, vocab=cfg.vocab, batch=bsz, prompt=n_prompt, gen=n_gen)
    if cfg.moe is not None:
        rec["moe"] = {"n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
                      "d_expert": cfg.moe.d_expert, "capacity_factor": cfg.moe.capacity_factor}
    sync()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    sync()
    rec["init_s"] = time.perf_counter() - t0
    rec["n_params"] = sum(x.numel() for _, x in tree_flatten_with_paths(params))
    rec["param_bytes"] = _tree_bytes(params)

    prompt = _family_inputs(cfg, spec, rng, dev, bsz, n_prompt)
    n_pre = (spec["image"] // cfg.ip2_patch) ** 2 if cfg.is_vlm else 0
    rec["prefix_tokens"] = n_pre
    prefill, decode = make_prefill_step(cfg, plan), make_decode_step(cfg, plan)

    def pos_of(t):
        return torch.full((), t, dtype=torch.int32, device=dev)

    def serve(c, name):
        """Prefill, ``n_gen`` greedy steps, decode against the forward."""
        dt = getattr(torch, name)
        pre, dec = make_prefill_step(c, plan), make_decode_step(c, plan)
        state = M.init_decode_state(c, plan, bsz, n_pre + n_prompt + n_gen, cache_dtype=dt,
                                    device=dev)
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lg, st_pre = pre(params, prompt, state)
        sync()
        t_pre = time.perf_counter() - t0
        del state
        nxt = torch.argmax(lg, -1).to(torch.int32)
        logits, toks, st = [lg], [nxt], st_pre
        t0 = time.perf_counter()
        for i in range(n_gen):
            nxt, lg, st = dec(params, st, nxt, pos_of(n_pre + n_prompt + i))
            logits.append(lg)
            toks.append(nxt)
        sync()
        t_dec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        last = pos_of(n_pre + n_prompt + n_gen - 1)
        busy = _busy(lambda: dec(params, st, toks[-2], last))
        seq = torch.cat([prompt["tokens"], torch.stack(toks[:n_gen], 1)], 1)
        want = _tail_logits(params, dict(prompt, tokens=seq), c, n_gen + 1)
        got = torch.stack(logits, 1)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        # greedy tokens where the forward's top-2 gap is wider than
        # GREEDY_GAP and than twice the largest logit error (two logits each
        # off by at most the error cannot swap past it; a bf16 / int8 cache
        # is off by up to 1.5 % of the scale)
        gap = torch.topk(want, 2, dim=-1).values.diff(dim=-1).neg()[..., 0]
        wide = gap > max(GREEDY_GAP, 2 * err)
        agree = torch.argmax(want, -1).to(torch.int32) == torch.stack(toks, 1)
        r = {"prefill_ms": t_pre * 1e3, "decode_ms_per_step": t_dec * 1e3 / n_gen,
             "decode_tokens_per_s": bsz * n_gen / t_dec,
             "prefill_tokens_per_s": bsz * (n_pre + n_prompt) / t_pre,
             "peak_mem_bytes": peak, "decode_step_busy": busy,
             "max_err_vs_forward": err, "logit_scale": scale, "rel_err_vs_forward": err / scale,
             "greedy_gap": max(GREEDY_GAP, 2 * err), "greedy_checked": int(wide.sum()),
             "greedy_equal": bool(agree[wide].all()),
             "greedy_differ_past_6e-3": int((~agree & (gap > GREEDY_GAP)).sum())}
        del logits, got, want, st
        return r, st_pre, toks

    with torch.no_grad():
        # warm-up: a short prompt and one step (kernels, workspaces)
        st = M.init_decode_state(cfg, plan, bsz, n_pre + 17, cache_dtype=torch.float32,
                                 device=dev)
        lg, st = prefill(params, dict(prompt, tokens=prompt["tokens"][:, :16]), st)
        decode(params, st, torch.argmax(lg, -1).to(torch.int32), pos_of(n_pre + 16))
        del st, lg
        rec["serving"] = {}
        dropless = None
        if cfg.moe is not None:
            # the config's capacity factor drops tokens by batch, so decode
            # equals the forward only without drops: top_k * factor ==
            # n_experts gives every expert a slot for every token
            dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        for name in spec["caches"]:
            r, st_pre, toks = serve(cfg, name)
            rec["serving"][name] = r
            print(json.dumps({"m_serve": {"arch": spec["arch"], "cache": name, **{
                k: v for k, v in r.items() if k != "decode_step_busy"}}}))
            if dropless is None:
                if name == "float32" and "f32_rel_bound" in spec:
                    assert r["rel_err_vs_forward"] <= spec["f32_rel_bound"], (spec["arch"], r)
                elif name == "float32":
                    assert r["max_err_vs_forward"] <= FAMILY_F32_BOUND, (spec["arch"], r)
                else:
                    assert r["rel_err_vs_forward"] < LM_CACHE_REL_BOUND, (spec["arch"], r)
                assert r["greedy_equal"], (spec["arch"], name, r)
        if dropless is not None:
            del st_pre
            r, st_pre, toks = serve(dropless, "float32")
            r["capacity_factor"] = dropless.moe.capacity_factor
            rec["serving"]["float32_dropless"] = r
            assert r["max_err_vs_forward"] <= FAMILY_F32_BOUND, (spec["arch"], r)
            assert r["greedy_equal"], (spec["arch"], r)

        if spec.get("long_pos"):
            # the state prefill left, decoded from position long_pos on
            lp, n_long = spec["long_pos"], 8
            st, nxt = st_pre, toks[0]
            finite = True
            sync()
            t0 = time.perf_counter()
            for i in range(n_long):
                nxt, lg, st = decode(params, st, nxt, pos_of(lp + i))
                finite = finite and bool(torch.isfinite(lg).all())
            sync()
            rec["long_positions"] = {
                "from_position": lp, "steps": n_long, "finite": finite,
                "decode_ms_per_step": (time.perf_counter() - t0) * 1e3 / n_long,
                "state_bytes": _tree_bytes(st), "prefill_state_bytes": _tree_bytes(st_pre)}
            lr = rec["long_positions"]
            assert finite and lr["state_bytes"] == lr["prefill_state_bytes"], lr
            del st
        del st_pre, toks

        if spec.get("long"):
            rec["long_context"] = _family_long_cache(dev, params, cfg, spec["long"], seed)

    # the card against the CPU at one pattern repeat, on a small input
    pat = len(cfg.block_pattern)
    n_check = cfg.n_layers if cfg.is_encoder_decoder else (2 if pat == 1 else pat)
    c_r = dataclasses.replace(cfg, n_layers=n_check)
    p_card = params if cfg.is_encoder_decoder else _first_layers(params, cfg, n_check)
    p_cpu = tree_to(p_card, "cpu")
    small = _family_inputs(cfg, spec, rng, dev, 1, 32, image=check_image)
    small_cpu = tree_to(small, "cpu")
    n_pre_s = (check_image // cfg.ip2_patch) ** 2 if cfg.is_vlm else 0
    with torch.no_grad():
        e_fwd = float((M.forward(p_card, small, c_r)[0].cpu()
                       - M.forward(p_cpu, small_cpu, c_r)[0]).abs().max())
        states = [M.init_decode_state(c_r, plan, 1, n_pre_s + 32, cache_dtype=torch.float32,
                                      device=d) for d in (dev, "cpu")]
        head = [dict(b, tokens=b["tokens"][:, :28]) for b in (small, small_cpu)]
        (lg, sg), (lc, sc) = (M.prefill(p, h, c_r, plan, s) for p, h, s in
                              zip((p_card, p_cpu), head, states))
        e_dec = float((lg.cpu() - lc).abs().max())
        for t in range(28, 32):
            lg, sg = M.decode_step(p_card, sg, small["tokens"][:, t], pos_of(n_pre_s + t), c_r)
            lc, sc = M.decode_step(p_cpu, sc, small_cpu["tokens"][:, t],
                                   torch.full((), n_pre_s + t, dtype=torch.int32), c_r)
            e_dec = max(e_dec, float((lg.cpu() - lc).abs().max()))
    rec["card_vs_cpu"] = {"n_layers": n_check, "forward_max_err": e_fwd,
                          "decode_max_err": e_dec}
    del states, sg, sc
    if spec.get("train"):
        grads = make_grads_fn(c_r, plan, AdamWConfig(), torch.float32)
        l_cpu, _, g_cpu = grads(p_cpu, small_cpu)
        l_card, _, g_card = grads(p_card, small)
        (share, at), floored = _worst_grad_share(tree_to(g_card, "cpu"), g_cpu)
        rec["card_vs_cpu"].update(loss_card=float(l_card), loss_cpu=float(l_cpu),
                                  worst_grad_share=share, at=at, floored=floored)
        del g_cpu, g_card
    bound = spec.get("card_cpu_bound", FAMILY_CARD_CPU_BOUND)
    assert e_fwd <= bound and e_dec <= bound, rec["card_vs_cpu"]
    if spec.get("train"):
        assert (rec["card_vs_cpu"]["worst_grad_share"]
                <= spec.get("grad_bound", FAMILY_CARD_CPU_BOUND)), rec["card_vs_cpu"]

    if cfg.moe is not None:
        # the first MoE layer's router at the config's capacity factor, on
        # 2 x 64 tokens with a shared component (its favourite experts
        # overflow): the card drops the CPU's (token, expert) pairs
        router = {"router": p_card["stacks"][0]["moe"]["router"][0]}
        h = rng.normal(size=(128, cfg.d_model)) + 2.0 * rng.normal(size=(1, cfg.d_model))
        h = torch.from_numpy(h.astype(np.float32))
        dropped = {}
        for d in ("cpu", dev):
            _, _, ids = moe_mod.route(tree_to(router, d), h.to(d), cfg)
            dp = moe_mod.dispatch(ids, cfg.moe.n_experts, moe_mod.capacity(cfg, 128))
            dropped[str(d)] = sorted((int(a), int(e)) for a, e, k in zip(
                dp["tok_of"].cpu(), dp["expert"].cpu(), dp["keep"].cpu()) if not k)
        rec["moe_binding"] = {"tokens": 128, "dropped_pairs": len(dropped["cpu"]),
                              "card_equals_cpu": dropped[str(dev)] == dropped["cpu"]}
        assert rec["moe_binding"]["card_equals_cpu"] and dropped["cpu"], rec["moe_binding"]
    del p_cpu, small_cpu

    if spec.get("train"):
        tr = spec["train"]
        seq = tr["seq"]
        # recurrentgemma's 3.5 B parameters: float32 masters and moments
        # (4 x 14.2 GB, and the functional AdamW holds the old state beside
        # the new) do not fit one card; bf16 ones do (the reference's train
        # plan for 100 B+ models)
        dt = getattr(torch, tr.get("dtype", "float32"))
        opt = AdamWConfig(lr=1e-4, moment_dtype=dt)
        step = make_train_step(cfg, plan, opt, warmup=1, total_steps=tr["steps"])
        batch = _family_inputs(cfg, spec, rng, dev, tr["batch"], seq)
        if "frames" in batch:   # in the compute dtype, as the dry run's batch specs give them
            batch["frames"] = batch["frames"].to(torch.bfloat16)
        p = cast_tree(params, dt)
        del params, p_card
        o = init_opt_state(p, opt)
        gc.collect()
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(tr["steps"]):
            t0 = time.perf_counter()
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        rec["train"] = {"batch": tr["batch"], "seq": seq, "steps": tr["steps"],
                        "remat": cfg.remat, "remat_policy": cfg.remat_policy,
                        "compute_dtype": "bfloat16", "param_and_moment_dtype": str(dt),
                        "step_ms": [t * 1e3 for t in times],
                        "tokens_per_s": tr["batch"] * seq / min(times),
                        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "losses": losses}
        assert all(np.isfinite(losses)), rec["train"]
        del p, o, m, batch


def _family_long_cache(dev, params, cfg, spec, seed):
    """Decode at ``spec["positions"]`` over seeded bf16 caches of a batch of
    ``spec["batch"]`` (phase j3's setup at this family's width): ms a step,
    peak above resident, bytes allocated a step against
    ``CACHE_ALLOC_BOUND``, finite logits."""
    import torch
    from repro_torch import models as M
    from repro_torch.convert import tree_flatten_with_paths
    from repro_torch.serve.serve_step import make_decode_step

    plan = M.DEFAULT_PLAN
    decode = make_decode_step(cfg, plan)
    b, t, n = spec["batch"], spec["positions"], spec["gen"]
    st = M.init_decode_state(cfg, plan, b, t, cache_dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    leaves = [x for _, x in tree_flatten_with_paths(st)]
    for leaf in leaves:
        for layer in leaf.unbind(0):      # one layer's random draw at a time
            if layer.is_floating_point():
                layer.copy_(torch.rand(layer.shape, generator=g, device=dev) * 0.02)
    bf16_width = 2 * sum(x.numel() for x in leaves if x.dtype == torch.bfloat16)
    del leaves, layer    # a step holds the state it was given and the new one, no third
    nxt = torch.zeros((b,), dtype=torch.int32, device=dev)
    finite = True
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
        t0 = time.perf_counter()
        for i in range(n):
            nxt, lg, st = decode(params, st, nxt, torch.full((), t - n + i, dtype=torch.int32,
                                                             device=dev))
            finite = finite and bool(torch.isfinite(lg).all())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        alloc = (torch.cuda.memory_stats()["allocated_bytes.all.allocated"] - a0) / n
    r = {"batch": b, "positions": t, "steps": n, "cache_bytes": _tree_bytes(st),
         "decode_ms_per_step": ms, "peak_above_resident": torch.cuda.max_memory_allocated()
         - base, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
         "allocated_bytes_per_step": alloc,
         "allocated_per_bf16_cache_byte": alloc / bf16_width, "finite": finite}
    del st
    assert finite and r["allocated_per_bf16_cache_byte"] <= CACHE_ALLOC_BOUND["bfloat16"], r
    return r


def families_phase(dev, out, specs=FAMILY_SPECS, seed=0, cfg_of=None):
    """Phase (m): every LM family one card holds, at its own widths (each
    ``FAMILY_SPECS`` entry, the depth cut where the card does not hold the
    model), through the serving entry points and, for the families marked,
    the training step; each family's record on a line of its own, the
    phase's seconds. ``cfg_of(arch)`` replaces ``get_config`` (smaller
    configs rehearse the phase on the CPU). No kernel launches: the LM
    reaches none, in the reference too."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg_of = cfg_of or get_config
    ops.reset_launches()
    t_phase = time.perf_counter()
    out["families"] = {}
    for spec in specs:
        gc.collect()
        torch.cuda.empty_cache()
        full = cfg_of(spec["arch"])
        cfg = dataclasses.replace(full, **spec.get("repl", {}),
                                  n_layers=spec.get("layers", full.n_layers))
        rec = out["families"][spec["arch"]] = {"of_layers": full.n_layers,
                                               "param_count_full": full.param_count()}
        t0 = time.perf_counter()
        try:
            family_phase(dev, rec, spec, cfg, seed)
        finally:
            rec["s"] = time.perf_counter() - t0
            print(json.dumps({"m_family": rec}, default=str))
    out["s"] = time.perf_counter() - t_phase
    out["launches"] = dict(ops.LAUNCHES)
    assert not any(ops.LAUNCHES.values()), f"a kernel launched in the LM families: {ops.LAUNCHES}"


def _index(x, i):
    """Leaf ``i`` of a stacked (L, ...) tree node: a tensor or a dict of them."""
    if isinstance(x, dict):
        return {k: _index(v, i) for k, v in x.items()}
    return x[i]


def _index_tree(tree, i):
    return {k: _index(v, i) for k, v in tree.items()}


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
        import numpy as np
        from repro_torch.convert import tree_to
        from repro_torch.core import frontend as fe
        from repro_torch.core.adc import ADCSpec, encode
        from repro_torch.core import saliency as sal
        from repro_torch.core.frontend import FrontendConfig
        from repro_torch.core.projection import PatchSpec
        from repro_torch.core.switched_cap import SummerSpec
        from repro_torch.core.temporal import TemporalSpec
        from repro_torch.data.pipeline import SceneStream
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.models import backend_delta as bdel
        from repro_torch.models import vit as vit_mod
        from repro_torch.models.vit import ViTConfig, init_vit, prepare_quant_embed, \
            vit_forward_compact
        from repro_torch.core.power import (AreaBudget, EnergyMeter, SensorConfig,
                                            data_reduction, power_report)
        from repro_torch.core.qth_attention import QTHSpec, qth_attention_weights
        from repro_torch.core.throughput import rate_point
        from repro_torch.examples import quickstart
        from repro_torch.serve import governor as gov_mod
        from repro_torch.serve.engine import SaccadeEngine
        from repro_torch.serve.governor import GovernorSpec
    except ImportError as e:
        _fail(f"the port is not beside this script ({e})")

    t_script = time.perf_counter()
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

    # (l2, l4) the dry runs trace on the host's CPU: in a process of their
    # own, started before the build and waited for after it, so that no
    # phase timed on the host shares the CPU with it; phases l2 and l4 read
    # its results
    (ROOT / "build").mkdir(exist_ok=True)
    dry_json = ROOT / "build" / "dryrun_worker.json"
    dry_json.unlink(missing_ok=True)
    dry_log = open(ROOT / "build" / "dryrun_worker.log", "w+")
    dry_proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path[:0] = sys.argv[1:3]; import chip_smoke; "
         "chip_smoke.dryrun_worker(sys.argv[3])", str(ROOT), str(ROOT / "src"), str(dry_json)],
        cwd=ROOT, stdout=dry_log, stderr=subprocess.STDOUT)

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
        dry_proc.kill()
        dry_proc.wait()
        _fail("kernel build failed: " + "; ".join(failures))

    @phase("dryrun_wait")
    def _dry_wait():
        try:
            dry_proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            dry_proc.kill()
            dry_proc.wait()
            raise

    dry = {}

    def dry_result(name):
        """Phase ``name``'s record from the dry-run process (waited for)."""
        if not dry:
            dry_proc.wait()
            dry_log.seek(0)
            print(dry_log.read(), end="", flush=True)
            if not dry_json.exists():
                raise RuntimeError(f"the dry-run process exited {dry_proc.returncode} "
                                   "without its results")
            dry.update(json.loads(dry_json.read_text()))
        res = dry[name]
        report[name] = res.get("out", {})
        report[name]["worker_s"] = res["s"]
        if not res["ok"]:
            raise RuntimeError(res["error"])

    fcfg = FrontendConfig(image_h=256, image_w=256,
                          patch=PatchSpec(32, 32, n_vectors=192), active_fraction=0.25)
    cfg_s = ViTConfig(frontend=fcfg, n_layers=6, d_model=256, n_heads=4, d_ff=1024,
                      quant_embed=True)
    cfg_f = dataclasses.replace(cfg_s, fused_embed=True)
    # the gated engine: droop-free summer (held gains stay 1.0, so unchanged
    # rows are bitwise unchanged), temporal gate j = 8 of k = 16, the delta
    # backend with the ragged attention kernel on layers 0-4
    fcfg_g = dataclasses.replace(
        fcfg, patch=PatchSpec(32, 32, n_vectors=192,
                              summer=SummerSpec(mode="passive", hold_time_s=0.0)),
        temporal=TemporalSpec(delta_threshold=1e-3, recompute_budget=8))
    cfg_g = dataclasses.replace(cfg_s, frontend=fcfg_g, saliency_layers="last",
                                delta_kernel=True)
    params = prepare_quant_embed(init_vit(cfg_s, torch.Generator().manual_seed(0)))
    adc = fcfg.adc
    stream = SceneStream(seed=7, image=256)
    k_tok = fcfg.n_active
    j_rows = fcfg_g.temporal.budget(k_tok)

    # path-shaped operands: 64 slots of the first frames, energy bootstrap
    rgb0, _ = stream.batch(1000, CAPACITY)
    patches, weights = fe.sensor_patches(params["ip2"], torch.from_numpy(rgb0).to(dev), fcfg)
    idx = sal.topk_patch_indices(sal.patch_energy(patches), k_tok)
    gathered = sal.gather_patches(patches, idx).reshape(-1, patches.shape[-1]).contiguous()
    w_t = ops._dac_weights(weights, fcfg.patch).T.contiguous()
    zero_bias = torch.zeros(w_t.shape[1], device=dev)
    p_codes = ops.kernel_params_from_spec(fcfg.patch, adc, codes=True)
    w8, s_w = params["embed_q"]
    r_rows, k_in, m = gathered.shape[0], gathered.shape[1], w_t.shape[1]
    d = w8.shape[1]
    s_a = torch.full((r_rows,), adc.lsb, dtype=torch.float32, device=dev)
    # the fused and sparse kernels' own operands: dense row table, counts
    table = (idx.int() + torch.arange(CAPACITY, device=dev, dtype=torch.int32)[:, None]
             * patches.shape[1]).reshape(-1).contiguous()
    counts = torch.full((CAPACITY,), k_tok, dtype=torch.int32, device=dev)
    flat_p = patches.reshape(-1, k_in).contiguous()
    # the ragged projection's: each slot's j stale rows, gathered (the gate
    # hands the codes adapter these, with identity indices)
    stale = sal.gather_patches(patches, idx[:, :j_rows]).contiguous()
    stale_flat = stale.reshape(-1, k_in)
    table2, _ = ops._ragged_tables(ops._identity_indices(stale), j_rows, None)
    cnt_mix = torch.tensor([(0, 3, j_rows, 5)[i % 4] for i in range(CAPACITY)],
                           dtype=torch.int32, device=dev)
    pf = ops.ip2_codes_fn(fcfg.patch, adc)
    # delta_attention's: layer 0's q, k, v over seeded tokens; 16, 12 or 8
    # valid tokens per slot (the governor's tiers)
    g3 = torch.Generator().manual_seed(5)
    h3 = (torch.randn((CAPACITY, k_tok, cfg_s.d_model), generator=g3)).to(dev)
    a0 = params["layers"][0]["attn"]
    q3, k3, v3 = (torch.einsum("bsd,dhk->bshk", h3, a0[w]) + a0[b]
                  for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    h3, dh3 = q3.shape[2], q3.shape[3]
    n_valid = torch.tensor([(16, 12, 8)[i % 3] for i in range(CAPACITY)], device=dev)
    valid3 = torch.arange(k_tok, device=dev)[None, :] < n_valid[:, None]
    cnt3_mix = torch.tensor([(0, 5, k_tok, 11)[i % 4] for i in range(CAPACITY)],
                            dtype=torch.int32, device=dev)

    def fused_plain(p=p_codes):
        return ref.ip2_fused_embed_ref(table, counts, flat_p, w_t, w8, s_w, p, k_tok)

    kernels = {}
    hashes = {}  # ip2_fused_embed's output at fixed seeded inputs

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
        hashes["serving"] = _sha(fused)
        assert torch.equal(fused, y), "ip2_fused_embed differs from ip2_project -> quant_matmul"
        same = dc.amax(-1) == 0
        assert torch.equal(fused[same], fused_plain()[same]), \
            "ip2_fused_embed differs from its plain version on rows whose codes agree"

    @phase("a_kernels_1_to_3_vs_plain")
    def _a2():
        codes = ops.ip2_project(gathered, weights, fcfg.patch, adc=adc, codes=True)
        # kernel 1: the sparse gather on the dense 64-slot grid
        sp = ops.ip2_project_sparse(patches, weights, idx, fcfg.patch, adc=adc, codes=True)
        plain1 = ref.ip2_project_sparse_ref(table, None, flat_p, w_t, zero_bias, p_codes, k_tok)
        torch.cuda.synchronize()
        assert torch.equal(sp.reshape(r_rows, m), codes), \
            "ip2_project_sparse differs from ip2_project on the gathered rows"
        err, flips = _flip_rows(sp, plain1, r_rows)
        kernels["ip2_project_sparse"] = {"max_abs_err": err, "flip_rows": flips, "rows": r_rows}
        # kernel 2 through the codes adapter, as the gate calls it, with
        # counts 0, partial and full per slot
        rg = pf(stale, weights, fcfg.patch, row_counts=cnt_mix)
        plain2 = ref.ip2_project_sparse_ref(table2, cnt_mix, stale_flat, w_t, zero_bias,
                                            p_codes, j_rows)
        torch.cuda.synchronize()
        live = torch.arange(j_rows, device=dev)[None, :] < cnt_mix[:, None]
        assert torch.equal(rg[live], sp[:, :j_rows][live]), \
            "ip2_ragged differs from the sparse kernel below the counts"
        assert not rg[~live].any(), "ip2_ragged rows past the counts are not zero"
        err, flips = _flip_rows(rg, plain2, rg.shape[0] * rg.shape[1])
        kernels["ip2_ragged"] = {"max_abs_err": err, "flip_rows": flips,
                                 "rows": int(cnt_mix.sum())}
        # kernel 3
        o3 = ops._delta_attention_cuda(q3, k3, v3, valid3, cnt3_mix)
        plain3 = ref.delta_attention_ref(q3, k3, v3, valid3, cnt3_mix)
        torch.cuda.synchronize()
        err3 = float((o3 - plain3).abs().max())
        kernels["delta_attention"] = {"max_abs_err": err3}
        assert err3 <= 1e-5, f"delta_attention off its plain version by {err3}"
        live3 = torch.arange(k_tok, device=dev)[None, :] < cnt3_mix[:, None]
        assert not o3[~live3].any(), "delta_attention rows past the counts are not zero"
        # kernel 3's edges: counts below 0 and above S, a slot with no valid
        # key (uniform softmax over its -1e30 scores), S 40 (two key chunks)
        g4 = torch.Generator().manual_seed(6)
        edge = {}
        for s_e in (k_tok, 40):
            qe, ke, ve = (torch.randn((CAPACITY, s_e, h3, dh3), generator=g4).to(dev)
                          for _ in range(3))
            me = torch.rand((CAPACITY, s_e), generator=g4) < 0.8
            me[:, 0] = True
            me[-1] = False
            me = me.to(dev)
            ce = torch.tensor([(0, 1, s_e // 2, s_e, -2, s_e + 5)[i % 6] for i in
                               range(CAPACITY - 1)] + [s_e], dtype=torch.int32, device=dev)
            oe = ops._delta_attention_cuda(qe, ke, ve, me, ce)
            pe = ref.delta_attention_ref(qe, ke, ve, me, ce)
            torch.cuda.synchronize()
            edge[s_e] = float((oe - pe).abs().max())
            assert edge[s_e] <= 1e-5, f"delta_attention at S {s_e} off by {edge[s_e]}"
            le = torch.arange(s_e, device=dev)[None, :] < ce.clamp(0, s_e)[:, None]
            assert not oe[~le].any(), f"delta_attention at S {s_e}: rows past the counts"
        kernels["delta_attention"]["edge_max_abs_err"] = edge

    @phase("a_wide_codes")
    def _aw():
        # a 10- and a 16-bit ADC store int16 codes, a 24-bit one int32 codes;
        # both embed kernels split them into 2 or 4 byte planes
        out = {}
        eye = torch.eye(m, dtype=torch.int8, device=dev)
        ones = torch.ones(m, device=dev)
        for bits in (10, 16, 24):
            wide = ADCSpec(bits=bits)
            p_w = ops.kernel_params_from_spec(fcfg.patch, wide, codes=True)
            codes = ops.ip2_project(gathered, weights, fcfg.patch, adc=wide, codes=True)
            assert codes.dtype == wide.code_dtype
            s_aw = torch.full((r_rows,), wide.lsb, dtype=torch.float32, device=dev)
            y = ops.quant_matmul_pre(codes, wide.lsb, w8, s_w)
            assert torch.equal(y, ref.quant_matmul_ref(codes, s_aw, w8, s_w)), \
                f"{bits} bits: quant_matmul differs from its plain version"
            fused = ops.ip2_fused_embed(patches, weights, idx, fcfg.patch, wide, w8, s_w)
            fused = fused.reshape(r_rows, d)
            assert torch.equal(fused, y), f"{bits} bits: fused and staged routes differ"
            plain_codes = ref.ip2_project_ref(gathered, w_t, zero_bias, p_w)
            same = (plain_codes == codes).all(-1)
            assert bits > 10 or int(same.sum()) >= r_rows // 2, \
                f"{bits} bits: codes agree on {int(same.sum())} rows"
            assert torch.equal(fused[same], fused_plain(p_w)[same]), \
                f"{bits} bits: ip2_fused_embed differs from its plain version"
            out[bits] = {"rows_with_equal_codes": int(same.sum()), "rows": r_rows}
            if bits > 16:
                continue
            # the LSB distance of kernels 6 and 4 from the plain projection:
            # kernel 4's codes through its embed of the M x M identity
            k4 = ops.ip2_fused_embed(patches, weights, idx, fcfg.patch, wide, eye, ones)
            k4 = torch.round(k4.reshape(r_rows, m) / wide.lsb).to(torch.int64)
            for name, got in (("ip2_project", codes.to(torch.int64)), ("ip2_fused_embed", k4)):
                dist = (got - plain_codes.to(torch.int64)).abs()
                moved = int((dist > 0).sum())
                out[bits][name] = {"max_lsb": int(dist.max()), "codes_moved": moved,
                                   "rows_moved": int((dist.amax(-1) > 0).sum()),
                                   "codes": dist.numel()}
                assert int(dist.max()) <= 1, f"{bits} bits {name}: {int(dist.max())} LSB apart"
                assert moved <= LSB_MOVES[bits] * dist.numel(), \
                    f"{bits} bits {name}: {moved} codes moved by 1 LSB"
        report["wide_codes"] = out
        print(json.dumps({"wide_codes": out}))

    # ---- (b) the main paths ------------------------------------------------
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
        for name in ("ip2_project", "quant_matmul", "ip2_fused_embed"):
            kernels.setdefault(name, {})["launches"] = launches[name]
        report["main_path"] = {"ticks": len(schedule), "launches": launches}
        assert all(launches[n] > 0 for n in ("ip2_project", "quant_matmul",
                                              "ip2_fused_embed")), \
            f"a kernel never ran: {launches}"

    # the gated path: each stream watches one scene that changes every 4
    # ticks, so held charge and backend work get reused
    scene_pool, _ = SceneStream(seed=9, image=256).batch(0, 24)
    pf_g = ops.ip2_codes_fn(fcfg_g.patch, adc)
    gated = {}

    def gated_frames(t, sids):
        return {s: scene_pool[(ids.index(s) + t // 4) % len(scene_pool)] for s in sids}

    def drive(eng, on_tick):
        """The 12-tick schedule on one engine; ``on_tick(t, frames, outs,
        held, before, launched)`` after each step."""
        for t, (evicts, admits, fed) in enumerate(schedule):
            for sid in evicts:
                eng.evict(sid)
            for sid in admits:
                eng.admit(sid)
            live = eng.stream_ids
            feed = live if fed is None else [s for s in fed if s in live]
            frames = gated_frames(t, feed)
            held = [eng.slot_of(s) for s in live if s not in frames]
            before = int_state(eng)
            pre = dict(ops.LAUNCHES)
            outs = eng.step(frames)
            launched = {n: ops.LAUNCHES[n] - pre[n] for n in pre}
            on_tick(t, frames, outs, held, before, launched)

    def int_state(eng):
        """The engine's integer (and discrete) state, copied."""
        st = eng.state
        parts = {"indices": st.indices, "frame_age": st.frame_age, "active": st.active}
        for group in ("cache", "controls", "bcache"):
            leaf = getattr(st, group)
            for name, x in zip(leaf._fields if leaf is not None else (), leaf or ()):
                if not x.is_floating_point() or name == "eps":
                    parts[f"{group}.{name}"] = x
        return {n: x.clone() for n, x in parts.items()}

    @phase("b_gated_path")
    def _bg():
        # the ungoverned engine's metered fleet power on the same frames;
        # the governor gets half of it
        ung = SaccadeEngine(cfg_g, params, capacity=CAPACITY, project_fn=pf_g,
                            temporal=True, backend_delta=True)
        fleet_mw = []
        drive(ung, lambda *a: fleet_mw.append(ung.fleet_power_mw()))
        del ung
        budget = 0.5 * float(np.mean(fleet_mw))
        gov = GovernorSpec(budget_mw=budget, backend_eps=1e-3)

        # record the ragged kernels' counts as the path hands them over
        rec = {"ip2_ragged": [], "delta_attention": []}
        orig = {"ip2_ragged": ops._ip2_sparse_cuda, "delta_attention": ops._delta_attention_cuda}

        def rec_sparse(table, counts, *a, **kw):
            out = orig["ip2_ragged"](table, counts, *a, **kw)
            rec["ip2_ragged"].append(None if counts is None else counts.cpu())
            return out

        def rec_attn(q, k, v, key_mask, q_counts):
            out = orig["delta_attention"](q, k, v, key_mask, q_counts)
            rec["delta_attention"].append(q_counts.cpu())
            return out

        main = SaccadeEngine(cfg_g, params, capacity=CAPACITY, project_fn=pf_g,
                             temporal=True, governor=gov, backend_delta=True)
        gated["main"] = main
        ticks = []

        def on_main(t, frames, outs, held, before, launched):
            st = main.state
            after = int_state(main)
            for s in held:
                for n in after:
                    assert torch.equal(after[n][s], before[n][s]), f"tick {t}: held {n} moved"
            fed = [main.slot_of(s) for s in frames]
            for sid in frames:
                assert np.isfinite(outs[sid]).all(), f"tick {t}: non-finite logits"
            macs = st.events_last.backend_macs[fed]
            computed = bool((macs > 0).any())
            assert computed == bool((macs > 0).all()), "the batch skip split the fleet"
            k3 = rec["delta_attention"][-launched["delta_attention"]:] \
                if launched["delta_attention"] else []
            ticks.append({
                "tick": t, "fed": len(fed), "launches": {n: c for n, c in launched.items() if c},
                "computed": computed,
                "mean_n_stale": float(st.cache.n_stale[fed].float().mean()),
                "mean_q_counts": (float(torch.stack(k3)[:, fed].float().mean())
                                  if k3 else None),
                "j_cap_hist": {int(v): int(c) for v, c in zip(
                    *np.unique(st.controls.j_cap[fed].cpu().numpy(), return_counts=True))},
                "tier_hist": {int(v): int(c) for v, c in zip(
                    *np.unique(st.controls.tier[fed].cpu().numpy(), return_counts=True))},
            })

        ops._ip2_sparse_cuda, ops._delta_attention_cuda = rec_sparse, rec_attn
        try:
            ops.reset_launches()
            drive(main, on_main)
            launches = dict(ops.LAUNCHES)
        finally:
            ops._ip2_sparse_cuda, ops._delta_attention_cuda = \
                orig["ip2_ragged"], orig["delta_attention"]
        n_computed = sum(t["computed"] for t in ticks)
        for name in ("ip2_ragged", "delta_attention"):
            kernels.setdefault(name, {})["launches"] = launches[name]
        k2 = torch.stack([c for c in rec["ip2_ragged"] if c is not None])
        k3 = torch.stack(rec["delta_attention"]) if rec["delta_attention"] else None
        ragged2 = int(((k2 > 0) & (k2 < j_rows)).sum())
        ragged3 = 0 if k3 is None else int(((k3 > 0) & (k3 < k_tok)).sum())
        # the last counts with work in them, for the kernel timings of (c)
        gated["counts"] = tuple(None if c is None else c[int(torch.nonzero(
            c.sum(1) > 0).max())] for c in (k2, k3))
        report["gated_path"] = {
            "budget_mw": budget, "ungoverned_fleet_mw": fleet_mw, "launches": launches,
            "computed_ticks": n_computed, "ragged_slot_ticks": {
                "ip2_ragged": ragged2, "delta_attention": ragged3},
            "ticks": ticks}
        print(json.dumps({"gated_ticks": ticks}))
        print(json.dumps({"gated_path": {k: v for k, v in report["gated_path"].items()
                                         if k != "ticks"}}))
        assert launches["ip2_ragged"] == len(schedule), launches
        assert launches["delta_attention"] == (cfg_g.n_layers - 1) * n_computed, launches
        assert launches["quant_matmul"] == n_computed, launches
        assert n_computed > 0 and launches["delta_attention"] > 0, launches
        assert all(launches[n] == 0 for n in ("ip2_project", "ip2_fused_embed",
                                               "ip2_project_sparse")), launches
        assert ragged2 > 0, "ip2_ragged never ran ragged (0 < count < j)"
        assert ragged3 > 0, "delta_attention never ran ragged (0 < count < k)"
        caps = set().union(*(t["j_cap_hist"] for t in ticks))
        tiers = set().union(*(t["tier_hist"] for t in ticks))
        assert len(caps) > 1 and len(tiers) > 1, f"the governor never moved: {caps} {tiers}"

        # delta_kernel=True against dense attention (delta_kernel=False). With
        # eps > 0 the two differ by design, in the JAX package too: the
        # ragged kernel leaves the rows past the stale prefix on their cached
        # values, where dense attention keeps every row that moved by more
        # than eps. In the exact regime (backend_eps 0) a changed layer
        # re-attends every row, so there they must agree.
        exact = dataclasses.replace(gov, backend_eps=0.0)
        pair = {dk: SaccadeEngine(dataclasses.replace(cfg_g, delta_kernel=dk), params,
                                  capacity=CAPACITY, project_fn=pf_g, temporal=True,
                                  governor=exact, backend_delta=True)
                for dk in (True, False)}
        hist, n_attn = [], [0]

        def on_kernel(t, frames, outs, held, before, launched):
            hist.append((outs, int_state(pair[True])))
            n_attn[0] += launched["delta_attention"]

        worst = [0.0]

        def on_dense(t, frames, outs, held, before, launched):
            ref_outs, ref_state = hist[t]
            for sid in frames:
                e = float(np.abs(outs[sid] - ref_outs[sid]).max())
                worst[0] = max(worst[0], e)
                assert e <= 1e-5, f"tick {t} {sid}: dense attention off by {e}"
            now = int_state(pair[False])
            for n in now:
                assert torch.equal(now[n], ref_state[n]), f"tick {t}: {n} differs"

        drive(pair[True], on_kernel)
        drive(pair[False], on_dense)
        report["gated_path"]["exact_regime"] = {
            "delta_attention_launches": n_attn[0], "kernel_vs_dense_max_logit_err": worst[0]}
        assert n_attn[0] > 0, "the exact-regime engine never launched delta_attention"

    # ---- (a') the projection tiles at awkward shapes, after (b) so that the
    # gated path's counts are known
    @phase("a_odd_shapes")
    def _a3():
        s_n, p_n = CAPACITY + 1, 16          # 65 slots x 8 rows: 520 rows
        last = gated.get("counts", (None, None))[0]
        if last is None:                     # (b) failed: a pattern of its kind
            last = torch.tensor([2] * 5 + [3] * 3 + [1] * 12 + [0] + [1] * 19 + [0]
                                + [1] * 23, dtype=torch.int32)
        raw = torch.tensor([(-3, j_rows + 4, 5, 0, j_rows, -1, 1)[i % 7]
                            for i in range(s_n)], dtype=torch.int32)
        one_full = torch.zeros(s_n, dtype=torch.int32)
        one_full[s_n // 2] = j_rows
        patterns = {"zero": torch.zeros(s_n, dtype=torch.int32),
                    "full": torch.full((s_n,), j_rows, dtype=torch.int32),
                    "one_full": one_full,
                    "gated": torch.cat([last.int(), torch.ones(1, dtype=torch.int32)]),
                    "clipped": raw}
        out = {}
        for kk, mm in ((1000, 100), (250, 30)):
            g = torch.Generator().manual_seed(kk)
            spec = PatchSpec(32, 32, n_vectors=mm)
            x = torch.rand((s_n, p_n, kk), generator=g).to(dev)
            wts = (torch.randn((mm, kk), generator=g) * 6.4).to(dev)
            idx = torch.stack([torch.randperm(p_n, generator=g)[:j_rows]
                               for _ in range(s_n)]).int().to(dev)
            w8_o, s_w_o = ops.quantize_weights_int8(
                (torch.randn((mm, 40), generator=g) * 0.1).to(dev))
            codes_o = ops.ip2_project(sal.gather_patches(x, idx), wts, spec, adc=adc,
                                      codes=True)
            fused_o = ops.ip2_fused_embed(x, wts, idx, spec, adc, w8_o, s_w_o)
            hashes[f"K{kk}_M{mm}"] = _sha(fused_o)
            assert torch.equal(ops.quant_matmul_pre(codes_o, adc.lsb, w8_o, s_w_o), fused_o), \
                f"K {kk} M {mm}: ip2_project -> quant_matmul differs from ip2_fused_embed"
            sp = ops.ip2_project_sparse(x, wts, idx, spec, adc=adc, codes=True)
            assert torch.equal(sp, codes_o), f"K {kk} M {mm}: sparse differs from ip2_project"
            # the ragged kernel gets the counts unclipped: it clips them itself
            table_o, _ = ops._ragged_tables(idx, p_n, None)
            w_t_o = ops._dac_weights(wts, spec).T.contiguous()
            p_o = ops.kernel_params_from_spec(spec, adc, codes=True)
            zero_o = torch.zeros(mm, device=dev)
            for name, cnt in patterns.items():
                cnt = cnt.to(dev)
                rg = ops._ip2_sparse_cuda(table_o, cnt, x.reshape(-1, kk), w_t_o, zero_o,
                                          p_o, j_rows).reshape(s_n, j_rows, mm)
                fz = ops.ip2_fused_embed(x, wts, idx, spec, adc, w8_o, s_w_o, row_counts=cnt)
                hashes[f"K{kk}_M{mm}_{name}"] = _sha(fz)
                live = torch.arange(j_rows, device=dev)[None, :] < cnt.clamp(0, j_rows)[:, None]
                assert torch.equal(ops.quant_matmul_pre(rg, adc.lsb, w8_o, s_w_o), fz), \
                    f"K {kk} M {mm} {name}: ip2_ragged -> quant_matmul differs from fused"
                assert torch.equal(rg[live], codes_o[live]), \
                    f"K {kk} M {mm} {name}: ip2_ragged differs from ip2_project"
                assert not rg[~live].any(), f"K {kk} M {mm} {name}: rows past the counts"
                out[f"K{kk}_M{mm}_{name}"] = int(live.sum())
        report["odd_shapes"] = {"rows": s_n * j_rows, "live_rows": out}

    report["fused_sha256"] = hashes
    print(json.dumps({"fused_sha256": hashes}))

    # ---- (ref) small input: kernel route on the card vs plain on the CPU --
    small_fe = FrontendConfig(image_h=64, image_w=64,
                              patch=PatchSpec(16, 16, n_vectors=32), active_fraction=0.25)
    small = ViTConfig(frontend=small_fe, n_layers=2, d_model=64, n_heads=4,
                      d_ff=128, quant_embed=True)

    @phase("ref_small_input")
    def _ref():
        p_cpu = prepare_quant_embed(init_vit(small, torch.Generator().manual_seed(1),
                                             device="cpu"))
        p_gpu = tree_to(p_cpu, dev)
        rgb, _ = SceneStream(seed=3, image=64).batch(0, 8)
        x_cpu = torch.from_numpy(rgb)
        pf_s = ops.ip2_codes_fn(small_fe.patch, small_fe.adc)
        cf_cpu = fe.apply_frontend(p_cpu["ip2"], x_cpu, small_fe, project_fn=pf_s,
                                   mode="compact")
        cf_gpu = fe.apply_frontend(p_gpu["ip2"], x_cpu.to(dev), small_fe, project_fn=pf_s,
                                   mode="compact")
        assert torch.equal(cf_gpu.indices.cpu(), cf_cpu.indices), "selection differs"
        agree = (cf_gpu.features.cpu() == cf_cpu.features).all(-1).all(-1)
        assert int((~agree).sum()) <= 1, f"{int((~agree).sum())} slots with a moved code"
        l_cpu, a_cpu = vit_forward_compact(p_cpu, x_cpu, small, project_fn=pf_s)
        outs = {route: vit_forward_compact(p_gpu, x_cpu.to(dev), c, **kw) for route, c, kw in
                (("staged", small, {"project_fn": pf_s}),
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

    @phase("ref_gated_small_input")
    def _refg():
        """The gated engine at small size: kernel route on the card, plain
        route on the CPU, 6 ticks on 8 streams whose scenes hold for two
        ticks; held to 1e-4 on the slots whose codes have agreed so far."""
        sfe = dataclasses.replace(
            small_fe, patch=PatchSpec(16, 16, n_vectors=32,
                                      summer=SummerSpec(mode="passive", hold_time_s=0.0)),
            temporal=TemporalSpec(delta_threshold=1e-3, recompute_budget=2))
        scfg = dataclasses.replace(small, frontend=sfe, saliency_layers="last",
                                   delta_kernel=True)
        p_cpu = prepare_quant_embed(init_vit(scfg, torch.Generator().manual_seed(1),
                                             device="cpu"))
        gov = GovernorSpec(budget_mw=1.0, backend_eps=1e-3, refresh_horizon=2)
        pf_s = ops.ip2_codes_fn(sfe.patch, sfe.adc)
        engs = {d_: SaccadeEngine(scfg, p_cpu, capacity=8, project_fn=pf_s, temporal=True,
                                  governor=gov, backend_delta=True, device=d_)
                for d_ in ("cpu", "cuda")}
        pool, _ = SceneStream(seed=4, image=64).batch(0, 10)
        for e in engs.values():
            for i in range(8):
                e.admit(f"s{i}")
        agree = torch.ones(8, dtype=torch.bool)
        worst = 0.0
        for t in range(6):
            frames = {f"s{i}": pool[(i + t // 2) % 10] for i in range(8)}
            outs = {d_: e.step(frames) for d_, e in engs.items()}
            st = {d_: e.state for d_, e in engs.items()}
            agree &= (st["cuda"].cache.features.cpu() == st["cpu"].cache.features) \
                .all(-1).all(-1)
            for i in torch.nonzero(agree).flatten().tolist():
                e = float(np.abs(outs["cuda"][f"s{i}"] - outs["cpu"][f"s{i}"]).max())
                worst = max(worst, e)
                assert e <= 1e-4, f"tick {t} slot {i}: logits off by {e}"
                for name in ("j_cap", "tier"):
                    assert int(getattr(st["cuda"].controls, name)[i]) == \
                        int(getattr(st["cpu"].controls, name)[i])
        report["ref_gated_small_input"] = {"slots_agreeing": int(agree.sum()),
                                           "max_logit_err": worst}
        assert int(agree.sum()) >= 6, f"only {int(agree.sum())} of 8 slots kept equal codes"

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
        if "main" in gated:
            # the gated engine on fresh streams whose scenes change every 4
            # ticks: compute, partial-reuse and cached ticks mixed
            eng = gated["main"]
            for sid in list(eng.stream_ids):
                eng.evict(sid)
            for i in range(CAPACITY):
                eng.admit(f"t{i}")
            per_tick = []
            for t in range(15):
                frames = {f"t{i}": scene_pool[(i + t // 4) % len(scene_pool)]
                          for i in range(CAPACITY)}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.step(frames)
                per_tick.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.mean(per_tick[3:]))
            timing["gated"] = {"tick_ms": ms, "stream_frames_per_s": CAPACITY / ms * 1e3,
                               "tick_ms_each": per_tick[3:]}
        report["engine"] = timing
        print(json.dumps({"engine": {n: {k: v for k, v in t.items() if k != "tick_ms_each"}
                                     for n, t in timing.items()}}))

        codes = ops._ip2_project_cuda(gathered, w_t, zero_bias, p_codes)
        fp32_ops = 2.0 * r_rows * k_in * m
        int8_ops = 2.0 * r_rows * m * d
        # kernels 2 and 3 at counts the gated path produced (its last tick)
        cnt2, cnt3 = gated.get("counts", (cnt_mix, cnt3_mix))
        cnt2 = cnt2.to(dev).int().contiguous()
        cnt3 = (cnt3_mix if cnt3 is None else cnt3).to(dev).int().contiguous()
        live2 = (torch.arange(j_rows, device=dev)[None, :] < cnt2[:, None]).reshape(-1)
        rows2 = int(cnt2.sum())
        live_rows2 = stale_flat[live2].contiguous()
        rows3 = int(cnt3.sum())
        slots3 = int((cnt3 > 0).sum())
        h, dh = h3, dh3
        qt, kt, vt = (x.transpose(1, 2) for x in (q3, k3, v3))
        sdpa_mask = valid3[:, None, None, :]
        rows = {
            "ip2_project_sparse": dict(
                redesigned="PR 13",
                replaces="src/repro/kernels/ip2_project_sparse.py:79",
                source="src/repro_torch/kernels/csrc/ip2_ragged.cu",
                symbol="ip2_ragged_kernel",
                kernel=lambda: ops._ip2_sparse_cuda(table, None, flat_p, w_t, zero_bias,
                                                    p_codes, k_tok),
                plain=lambda: ref.ip2_project_sparse_ref(table, None, flat_p, w_t, zero_bias,
                                                         p_codes, k_tok),
                library=lambda: torch.matmul(gathered, w_t),
                bytes=r_rows * k_in * 4 + r_rows * 4 + k_in * m * 4 + r_rows * m,
                fp32=fp32_ops),
            "ip2_ragged": dict(
                redesigned="PR 13",
                replaces="src/repro/kernels/ip2_megakernel.py:122",
                source="src/repro_torch/kernels/csrc/ip2_ragged.cu",
                symbol="ip2_ragged_kernel",
                kernel=lambda: ops._ip2_sparse_cuda(table2, cnt2, stale_flat, w_t, zero_bias,
                                                    p_codes, j_rows),
                plain=lambda: ref.ip2_project_sparse_ref(table2, cnt2, stale_flat, w_t,
                                                         zero_bias, p_codes, j_rows),
                library=lambda: torch.matmul(live_rows2, w_t),
                # the rows below the counts are read; every output row written
                bytes=(rows2 * k_in * 4 + table2.numel() * 4 + CAPACITY * 4
                       + k_in * m * 4 + table2.numel() * m),
                fp32=2.0 * rows2 * k_in * m),
            "delta_attention": dict(
                redesigned="PR 14",
                replaces="src/repro/kernels/vit_delta_attention.py:130",
                source="src/repro_torch/kernels/csrc/delta_attention.cu",
                symbol="delta_attention_kernel",
                kernel=lambda: ops._delta_attention_cuda(q3, k3, v3, valid3, cnt3),
                plain=lambda: ref.delta_attention_ref(q3, k3, v3, valid3, cnt3),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask),
                # query rows below the counts, keys and values of the slots
                # with any, the mask and counts; every output row written
                bytes=(rows3 * h * dh * 4 + 2 * slots3 * k_tok * h * dh * 4
                       + CAPACITY * k_tok + CAPACITY * 4 + q3.numel() * 4),
                fp32=4.0 * rows3 * h * k_tok * dh),
            "ip2_fused_embed": dict(
                redesigned="PR 15",
                replaces="src/repro/kernels/ip2_megakernel.py:251",
                source="src/repro_torch/kernels/csrc/ip2_fused_embed.cu",
                symbol="ip2_fused_embed_kernel",
                kernel=lambda: ops._fused_embed_cuda(
                    table, counts, flat_p, w_t, w8, s_w, adc.lsb, p_codes, k_tok),
                plain=fused_plain,
                library=None,
                # the port's own yardstick: the staged pair on the same operands
                staged=lambda: ops._quant_matmul_cuda(
                    ops._ip2_project_cuda(gathered, w_t, zero_bias, p_codes), s_a, w8, s_w),
                # the gathered rows this run's selection needs, read once
                bytes=(r_rows * k_in * 4 + r_rows * 4 + CAPACITY * 4 + k_in * m * 4
                       + m * d + d * 4 + r_rows * d * 4),
                fp32=fp32_ops, int8=int8_ops),
            "quant_matmul": dict(
                redesigned="PR 14",
                replaces="src/repro/kernels/quant_matmul.py:55",
                source="src/repro_torch/kernels/csrc/quant_matmul.cu",
                symbol="quant_matmul_kernel",
                kernel=lambda: ops._quant_matmul_cuda(codes, s_a, w8, s_w),
                plain=lambda: ref.quant_matmul_ref(codes, s_a, w8, s_w),
                library=lambda: torch._int_mm(codes, w8),
                bytes=r_rows * m + r_rows * 4 + m * d + d * 4 + r_rows * d * 4,
                int8=int8_ops),
            "ip2_project": dict(
                redesigned="PR 13",
                replaces="src/repro/kernels/ip2_project.py:138",
                source="src/repro_torch/kernels/csrc/ip2_project.cu",
                symbol="ip2_project_kernel",
                kernel=lambda: ops._ip2_project_cuda(gathered, w_t, zero_bias, p_codes),
                plain=lambda: ref.ip2_project_ref(gathered, w_t, zero_bias, p_codes),
                library=lambda: torch.matmul(gathered, w_t),
                bytes=r_rows * k_in * 4 + k_in * m * 4 + r_rows * m,
                fp32=fp32_ops),
        }
        report["timed_counts"] = {"ip2_ragged": cnt2.tolist(), "delta_attention": cnt3.tolist()}
        occupancy = getattr(_build.load("ip2_fused_embed"), "ip2_fused_embed_occupancy", None)
        if occupancy is not None:  # kernel 4's clusters on this card, at M 192
            report["fused_occupancy"] = {}
            for b in (1, 2):
                res = (ctypes.c_int * 4)()
                assert occupancy(m, b, res) == 0, "ip2_fused_embed occupancy query failed"
                report["fused_occupancy"][f"{b}-byte codes"] = dict(zip(
                    ("cluster_blocks", "dynamic_smem_bytes", "blocks_per_sm",
                     "max_active_clusters"), res))
            print(json.dumps({"fused_occupancy": report["fused_occupancy"]}))
        for name, row in rows.items():
            ms = _time_ms(row["kernel"])
            device_ms = _device_ms(row["kernel"], kernel=row["symbol"])
            plain_ms = _time_ms(row["plain"])
            lib_ms = _time_ms(row["library"]) if row["library"] else None
            lib_device_ms = _device_ms(row["library"]) if row["library"] else None
            bound_ms, bound_by = _bound(row["bytes"], row.get("fp32", 0.0), row.get("int8", 0.0))
            if row.get("staged"):
                kernels.setdefault(name, {})["staged_device_ms"] = _device_ms(row["staged"])
            kernels.setdefault(name, {}).update(
                name=name, route="cuda", source=row["source"], replaces=row["replaces"],
                symbol=row["symbol"], redesigned=row["redesigned"],
                launches=kernels.get(name, {}).get("launches", 0), ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, library_device_ms=lib_device_ms)
        # kernel 6's no-ADC readout (dense mode's) at the dense shape: every
        # patch of the 64 frames, 4096 x 1024 x 192
        p_noadc = ops.kernel_params_from_spec(fcfg.patch)
        kern = lambda: ops._ip2_project_cuda(flat_p, w_t, zero_bias, p_noadc)  # noqa: E731
        plain = lambda: ref.ip2_project_ref(flat_p, w_t, zero_bias, p_noadc)   # noqa: E731
        n_dense = flat_p.shape[0]
        bound_ms, bound_by = _bound(n_dense * k_in * 4 + k_in * m * 4 + m * 4 + n_dense * m * 4,
                                    fp32_flops=2.0 * n_dense * k_in * m)
        report["noadc_dense"] = {
            "shape": [n_dense, k_in, m], "max_abs_err": float((kern() - plain()).abs().max()),
            "ms": _time_ms(kern), "device_ms": _device_ms(kern, kernel="ip2_project_kernel"),
            "plain_ms": _time_ms(plain), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _time_ms(lambda: torch.matmul(flat_p, w_t)),
            "library_device_ms": _device_ms(lambda: torch.matmul(flat_p, w_t))}
        print(json.dumps({"noadc_dense": report["noadc_dense"]}))

    # ---- where the device time goes in the engines' ticks -----------------
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
        for name, eng in {**engines, **({"gated": gated["main"]} if "main" in gated
                                       else {})}.items():
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

    # ---- (d) device rollouts and the async surface ------------------------
    meter = EnergyMeter()
    ppp, n_vec = fcfg_g.patch.pixels_per_patch, fcfg_g.patch.n_vectors
    sign_spec = GovernorSpec(budget_mw=1.0, sign_tier=True)
    fixed_min = float(gov_mod.fixed_power_mw(
        meter, float(fcfg_g.image_h * fcfg_g.image_w), ppp, n_vec,
        torch.full((1,), sign_spec.tier_tokens(k_tok)[-1], dtype=torch.int32), 30.0)[0])
    # a share below the finest k tier's floor enters the sign tier
    floor_mw = fixed_min + 1e3 * meter.slot_recompute_power_w(ppp, n_vec, 30.0)
    roll_ids = [f"r{i}" for i in range(CAPACITY)]

    def make_engine(mode):
        if mode == "staged":
            return SaccadeEngine(cfg_s, params, capacity=CAPACITY,
                                 project_fn=ops.ip2_codes_fn(fcfg.patch, adc))
        if mode == "fused":
            return SaccadeEngine(cfg_f, params, capacity=CAPACITY)
        if mode == "gated":
            budget = report.get("gated_path", {}).get("budget_mw", 2.0 * CAPACITY * floor_mw)
            return SaccadeEngine(cfg_g, params, capacity=CAPACITY, project_fn=pf_g,
                                 temporal=True, backend_delta=True,
                                 governor=GovernorSpec(budget_mw=budget, backend_eps=1e-3))
        # sign tier: priorities 1 and 2 alternate, so a priority-1 share is
        # 0.53 of the floor (into the sign tier) and a priority-2 one 1.07
        return SaccadeEngine(cfg_g, params, capacity=CAPACITY, project_fn=pf_g,
                             temporal=True, governor=dataclasses.replace(
                                 sign_spec, budget_mw=0.8 * CAPACITY * floor_mw))

    def admit_all(eng, mode):
        for i, sid in enumerate(roll_ids):
            eng.admit(sid, priority=(1.0, 2.0)[i % 2] if mode == "sign_tier" else 1.0)

    def roll_frames(mode, t, fed_ids):
        held = mode in ("gated", "sign_tier")     # scenes hold for 4 ticks
        return {sid: scene_pool[(roll_ids.index(sid) + (t // 4 if held else t))
                                % len(scene_pool)] for sid in fed_ids}

    def roll_sched(mode, t0, t_len=8):
        """The reference's partial-fed pattern over 64 streams: a third fed
        every tick, a third every other tick, a third once; one tick feeds
        nobody."""
        out = []
        for t in range(t0, t0 + t_len):
            fed = [] if t % 8 == 3 else [
                sid for i, sid in enumerate(roll_ids)
                if i % 3 == 0 or (i % 3 == 1 and t % 2 == 0) or (i % 3 == 2 and t % 8 == 2)]
            out.append(roll_frames(mode, t, fed))
        return out

    def state_leaves(eng):
        out = []
        for leaf in eng.state:
            if isinstance(leaf, torch.Tensor):
                out.append(leaf)
            elif leaf is not None:
                out.extend(leaf)
        return out

    def same_outputs(seq, roll, msg):
        assert len(seq) == len(roll), msg
        for t, (a, b) in enumerate(zip(seq, roll)):
            assert a.keys() == b.keys(), f"{msg} tick {t}: fed cover differs"
            for sid in a:
                assert np.array_equal(a[sid], b[sid]), f"{msg} tick {t} {sid}: logits differ"
                assert np.isfinite(a[sid]).all(), f"{msg} tick {t}: non-finite logits"

    def same_states(a, b, msg):
        la, lb = state_leaves(a), state_leaves(b)
        assert len(la) == len(lb)
        for i, (x, y) in enumerate(zip(la, lb)):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{msg}: state leaf {i} differs"

    @phase("d_rollout")
    def _d():
        out = {}
        n_kt = len(sign_spec.k_tiers)
        # the one host wait the async path may make: a staging buffer whose
        # previous upload is still in flight. It is exempt from the sync
        # check below (run with the check off), and counted.
        waits = {"calls": 0, "pending": 0}
        orig_wait = SaccadeEngine.__dict__["_wait_staging"]   # the staticmethod

        def exempt_wait(st):
            waits["calls"] += 1
            if st.event is not None and not st.event.query():
                waits["pending"] += 1
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                orig_wait.__func__(st)
            finally:
                torch.cuda.set_sync_debug_mode(prev)

        for mode in ("staged", "fused", "gated", "sign_tier"):
            seq, roll = make_engine(mode), make_engine(mode)
            for e in (seq, roll):
                admit_all(e, mode)
            sched = roll_sched(mode, 0)
            ops.reset_launches()
            got = roll.step_rollout(sched)
            torch.cuda.synchronize()
            launches = {n: c for n, c in ops.LAUNCHES.items() if c}
            want, sign_ticks = [], 0
            for fr in sched:
                want.append(seq.step(fr))
                if seq.governor is not None and seq.governor.sign_tier:
                    sign_ticks += int((seq.state.controls.tier >= n_kt).any())
            same_outputs(want, got, f"{mode} rollout")
            same_states(seq, roll, f"{mode} rollout")
            # warm state, churn at the boundary, and both block=False paths
            # under the sync check, from the call until the handle returns
            for e in (seq, roll):
                e.evict(roll_ids[5])
                e.admit(roll_ids[5], priority=2.0 if mode == "sign_tier" else 1.0)
            sched2 = roll_sched(mode, 8)
            SaccadeEngine._wait_staging = staticmethod(exempt_wait)
            torch.cuda.set_sync_debug_mode("error")
            try:
                hs = [seq.step(fr, block=False) for fr in sched2]
                hr = roll.step_rollout(sched2, block=False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                SaccadeEngine._wait_staging = orig_wait
            same_outputs([h.result() for h in hs], hr.result(), f"{mode} block=False")
            same_states(seq, roll, f"{mode} block=False")
            if mode == "sign_tier":
                for sid in roll_ids:
                    sign_ticks += int(seq.sign_readout(sid))
            out[mode] = {"ticks": 2 * len(sched), "rollout_launches": launches,
                         "sign_readout_ticks": sign_ticks}
            need = {"staged": ("ip2_project", "quant_matmul"), "fused": ("ip2_fused_embed",),
                    "gated": ("ip2_ragged", "delta_attention", "quant_matmul"),
                    "sign_tier": ("ip2_ragged", "quant_matmul")}[mode]
            assert all(launches.get(n, 0) > 0 for n in need), f"{mode}: {launches}"
            del seq, roll
        assert out["sign_tier"]["sign_readout_ticks"] > 0, "no slot reached the sign tier"
        # two engines issued before either result is fetched, against two
        # served one after the other
        pair = [make_engine("staged") for _ in range(4)]
        for e in pair:
            admit_all(e, "staged")
        for t in range(2):
            f1, f2 = roll_frames("staged", t, roll_ids), roll_frames("staged", t + 7, roll_ids)
            h1, h2 = pair[0].step(f1, block=False), pair[1].step(f2, block=False)
            o1, o2 = h1.result(), h2.result()
            same_outputs([pair[2].step(f1), pair[3].step(f2)], [o1, o2], f"overlap tick {t}")
        del pair
        out["staging_waits"] = waits
        report["d_rollout"] = out
        print(json.dumps({"d_rollout": out}))

    # ---- (e) ticks per second: step, rollouts, the async return, ingest ----
    @phase("e_async_times")
    def _e():
        out = {}
        for mode in ("staged", "gated"):
            eng = make_engine(mode)
            admit_all(eng, mode)

            def frames_at(t):
                return roll_frames(mode, t, roll_ids)

            for t in range(3):
                eng.step(frames_at(t))
            torch.cuda.synchronize()
            n = 10
            t0 = time.perf_counter()
            for t in range(n):
                eng.step(frames_at(t))
            step_s = (time.perf_counter() - t0) / n
            ret, tick = [], []
            for t in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h = eng.step(frames_at(t), block=False)
                t1 = time.perf_counter()
                h.result()
                ret.append((t1 - t0) * 1e3)
                tick.append((time.perf_counter() - t0) * 1e3)
            rollout = {}
            for t_len in (1, 4, 16, 64):
                ticks = [frames_at(t) for t in range(t_len)]
                eng.step_rollout(ticks)                      # staging allocated
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h = eng.step_rollout(ticks, block=False)
                t1 = time.perf_counter()
                h.result()
                dt = time.perf_counter() - t0
                rollout[t_len] = {"ticks_per_s": t_len / dt, "ms_per_tick": dt * 1e3 / t_len,
                                  "host_return_ms": (t1 - t0) * 1e3}
            ticks = [frames_at(t) for t in range(16)]
            busy = _busy(lambda: eng.step_rollout(ticks))
            out[mode] = {
                "step_ticks_per_s": 1.0 / step_s, "step_ms": step_s * 1e3,
                "step_nonblocking_return_ms": float(np.median(ret)),
                "step_nonblocking_tick_ms": float(np.median(tick)),
                "rollout": rollout,
                "rollout16_device_busy_ms": busy["busy_ms"],
                "rollout16_wall_ms": busy["wall_ms"],
                "rollout16_device_busy_share": busy["busy_share"],
                "rollout16_device_events": busy["device_events"],
            }
            del eng
        # the 64 fed frames (50 MB) alone: pageable against page-locked
        host = np.ascontiguousarray(np.stack([scene_pool[i % len(scene_pool)]
                                              for i in range(CAPACITY)]))
        src = torch.from_numpy(host)
        pinned = src.pin_memory()
        copies = {}
        for name, fn in (("pageable", lambda: src.to(dev)),
                         ("pinned", lambda: pinned.to(dev, non_blocking=True))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            copies[name] = {"ms": (time.perf_counter() - t0) * 1e2, "bytes": host.nbytes}
            copies[name]["gb_per_s"] = host.nbytes / copies[name]["ms"] / 1e6
        out["frame_copy_64"] = copies
        # what the staging holds: the per-T pinned rows of one engine
        row_bytes = fcfg.image_h * fcfg.image_w * 3 * 4
        out["staging_bytes"] = {"step_pinned": 2 * CAPACITY * row_bytes,
                                "rollout_T64_pinned": 64 * CAPACITY * row_bytes,
                                "rollout_T64_device_rows": 64 * CAPACITY * row_bytes}
        report["async_times"] = out
        print(json.dumps({"async_times": out}))

    @phase("e_delta_skip_cost")
    def _e2():
        out = {}
        # what the delta backend's device-side skip costs: a fully cached
        # frame at 64 slots now runs the encoder and selects the cache
        eng = make_engine("gated")
        admit_all(eng, "gated")
        for t in range(2):
            eng.step(roll_frames("gated", 0, roll_ids))
        bc = eng.state.bcache
        scale, zero = fe.feature_scale_zero(params["ip2"], fcfg_g)
        cf = fe.CompactFeatures(bc.feats, bc.indices, bc.tvalid,
                                torch.zeros((CAPACITY, fcfg_g.n_patches), device=dev),
                                scale, zero, bc.gain)
        eps = torch.zeros(CAPACITY, device=dev)

        def delta(cf_):
            return bdel.delta_forward(params, cfg_g, cf_, lambda: vit_mod._embed_tokens(
                params, cf_, cfg_g) + params["pos"][cf_.indices.long()], bc, eps)

        changed = cf._replace(gain=torch.where(torch.arange(k_tok, device=dev) == 0,
                                               bc.gain * 0.5, bc.gain))
        macs = {n: float(delta(c)[3].sum()) for n, c in (("cached", cf), ("computed", changed))}
        assert macs["cached"] == 0.0 and macs["computed"] > 0.0, macs
        out["delta_forward_64_slots"] = {
            n: {"device_ms": _device_ms(lambda c=c: delta(c)),
                "ms": _time_ms(lambda c=c: delta(c))}
            for n, c in (("cached", cf), ("computed", changed))}
        del eng
        report["delta_skip_cost"] = out
        print(json.dumps({"delta_skip_cost": out}))

    # ---- (f) dense mode, the float and sign wires, the float simulation ----
    @phase("f_wires_dense")
    def _f():
        rgb, _ = stream.batch(7000, CAPACITY)
        out = report["f_wires_dense"] = {}
        try:
            wires_dense_phase(dev, params, cfg_s, dataclasses.replace(cfg_s, frontend=fcfg_g),
                              small, rgb, scene_pool, out)
        finally:
            print(json.dumps({"f_wires_dense": out}))

    def qth_path(out):
        """ViTConfig(qth=True) at ip2-vit width: the staged and the gated
        engine on the 12-tick churn schedule, launch counts reset before each
        and read after; then card against CPU on a small input, the QTH
        weights' factor-2 flips card against CPU, and tick times."""
        cfg_sq = dataclasses.replace(cfg_s, qth=True)
        cfg_gq = dataclasses.replace(cfg_g, qth=True)
        budget = report.get("gated_path", {}).get("budget_mw", 2.0 * CAPACITY * floor_mw)
        engs = {"staged": SaccadeEngine(cfg_sq, params, capacity=CAPACITY,
                                        project_fn=ops.ip2_codes_fn(fcfg.patch, adc)),
                "gated": SaccadeEngine(cfg_gq, params, capacity=CAPACITY, project_fn=pf_g,
                                       temporal=True, backend_delta=True,
                                       governor=GovernorSpec(budget_mw=budget,
                                                             backend_eps=1e-3))}
        for name, eng in engs.items():
            per_tick = []

            def on_tick(t, frames, outs, held, before, launched, eng=eng, per_tick=per_tick):
                after = int_state(eng)
                for s_ in held:
                    for n in after:
                        assert torch.equal(after[n][s_], before[n][s_]), \
                            f"{name} tick {t}: held {n} moved"
                for sid in frames:
                    assert np.isfinite(outs[sid]).all(), f"{name} tick {t}: non-finite logits"
                fed = [eng.slot_of(s_) for s_ in frames]
                computed = (name == "staged"
                            or bool((eng.state.events_last.backend_macs[fed] > 0).any()))
                per_tick.append({"fed": len(fed), "computed": computed,
                                 "launches": {n: c for n, c in launched.items() if c}})

            ops.reset_launches()
            drive(eng, on_tick)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            n_computed = sum(t["computed"] for t in per_tick)
            out[name] = {"ticks": len(per_tick), "computed_ticks": n_computed,
                         "launches": launches}
            if name == "staged":
                assert launches["ip2_project"] == len(schedule), launches
                assert launches["quant_matmul"] == len(schedule), launches
            else:
                assert launches["ip2_ragged"] == len(schedule), launches
                assert 0 < n_computed and launches["quant_matmul"] == n_computed, launches
                assert launches["delta_attention"] == 0, "qth reached delta_attention"
            assert all(t["launches"] for t in per_tick), f"{name}: a tick launched nothing"

        # kernel route on the card against the plain route on the CPU, small
        small_q = dataclasses.replace(small, qth=True)
        p_cpu = prepare_quant_embed(init_vit(small_q, torch.Generator().manual_seed(1),
                                             device="cpu"))
        p_gpu = tree_to(p_cpu, dev)
        rgb, _ = SceneStream(seed=3, image=64).batch(0, 8)
        x_cpu = torch.from_numpy(rgb)
        pf_s = ops.ip2_codes_fn(small_fe.patch, small_fe.adc)
        cfs = [fe.apply_frontend(p["ip2"], x, small_fe, project_fn=pf_s, mode="compact")
               for p, x in ((p_cpu, x_cpu), (p_gpu, x_cpu.to(dev)))]
        agree = (cfs[1].features.cpu() == cfs[0].features).all(-1).all(-1)
        l_cpu, a_cpu = vit_forward_compact(p_cpu, x_cpu, small_q, project_fn=pf_s)
        l_gpu, a_gpu = vit_forward_compact(p_gpu, x_cpu.to(dev), small_q, project_fn=pf_s)
        err = float((l_gpu.cpu() - l_cpu).abs()[agree].max())
        out["small_card_vs_cpu"] = {"slots_agreeing": int(agree.sum()), "max_logit_err": err}
        assert torch.equal(a_gpu["indices"].cpu(), a_cpu["indices"]), "qth: selection differs"
        assert int(agree.sum()) >= 7 and err <= 1e-4, out["small_card_vs_cpu"]

        # factor-2 flips of the QTH weights, card against CPU, on seeded
        # scores at the serving attention shape (64 slots, 4 heads, 16 tokens)
        g = torch.Generator().manual_seed(18)
        flips = 0
        for _ in range(8):
            sc = torch.randn((CAPACITY, 4, k_tok, k_tok), generator=g) * 2.0
            spec = QTHSpec(renormalize=False)
            wc = qth_attention_weights(sc.to(dev), spec).cpu()
            wp = qth_attention_weights(sc, spec)
            diff = wc != wp
            ratio = wc[diff] / wp[diff].clamp_min(1e-30)
            assert bool(((ratio == 2) | (ratio == 0.5) | (wc[diff] == 0) | (wp[diff] == 0))
                        .all()), "a QTH weight moved by other than a factor of 2"
            flips += int(diff.sum())
        out["flips_card_vs_cpu"] = {"calls": 8, "coefficients": 8 * CAPACITY * 4 * k_tok ** 2,
                                    "flips": flips}

        # tick times at 64 fed streams, beside the softmax engines of (c)
        rgb_t, _ = stream.batch(5000, CAPACITY)
        for name, eng in engs.items():
            for sid in list(eng.stream_ids):
                eng.evict(sid)
            for i in range(CAPACITY):
                eng.admit(f"t{i}")
            per = []
            for t in range(13):
                frames = ({f"t{i}": rgb_t[i] for i in range(CAPACITY)} if name == "staged"
                          else {f"t{i}": scene_pool[(i + t // 4) % len(scene_pool)]
                                for i in range(CAPACITY)})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.step(frames)
                per.append((time.perf_counter() - t0) * 1e3)
            out[name]["tick_ms"] = float(np.mean(per[3:]))
            out[name]["softmax_tick_ms_phase_c"] = report.get("engine", {}).get(
                name, {}).get("tick_ms")

    # ---- (g) conv-in-pixel on kernel 6, QTH attention in both engines, the
    # paper's figures
    @phase("g_conv_qth")
    def _g():
        out = report["g_conv_qth"] = {"conv": {}, "qth": {}}
        try:
            conv_phase(dev, out["conv"])
            print(json.dumps({"g_conv": out["conv"]}))
            qth_path(out["qth"])
        finally:
            print(json.dumps({"g_qth": out["qth"]}))
        rep = power_report(SensorConfig())
        figures = {
            "note": "the paper's sensor model (SensorConfig 2 Mpix at 30 Hz), not device numbers",
            "power_mw": rep.total_w * 1e3, "mw_per_mpix": rep.mw_per_mpix,
            "data_reduction": data_reduction(SensorConfig()),
            "data_reduction_vs_rgb": data_reduction(SensorConfig(), vs_rgb=True),
            "frame_hz_1080p_c2_400": rate_point("1080p", 2, 32, 400).frame_hz,
            "area_total_um2": AreaBudget().totals()["Total"]["total_um2"],
            "pitch_um": AreaBudget().totals()["Total"]["pitch_um"]}
        out["paper_figures"] = figures
        print(json.dumps({"paper_figures": figures}))
        # the quickstart example on the card: its projection line is kernel 6
        n0 = ops.LAUNCHES["ip2_project"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            qs = quickstart.main([])
        out["quickstart"] = {"stdout": buf.getvalue(), **{k: v for k, v in qs.items()
                                                           if k != "compact_shape"}}
        assert ops.LAUNCHES["ip2_project"] == n0 + 1, "the quickstart did not launch kernel 6"
        assert qs["kernel_max_abs_diff"] <= 1e-5, qs

    # ---- (h) co-design training on the card, then the trained models served
    # through kernels 6, 5, 2 and 3
    @phase("h_train")
    def _h():
        out = report["h_train"] = {}
        ckpt_dir = ROOT / "build" / "ckpt_h_train"
        try:
            train_phase(dev, out, ckpt_dir)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    @phase("i_fleet_lm")
    def _i():
        out = report["i_fleet_lm"] = {"fleet": {}, "lm": {}}
        t0 = time.perf_counter()
        fleet_phase(dev, out["fleet"], params, cfg_s, cfg_g)
        out["fleet_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lm_phase(dev, out["lm"])
        out["lm_s"] = time.perf_counter() - t0
        fl = {r: {"launches": {n: c for n, c in v["launches"].items() if c},
                  "host_ticks": v["host_ticks"], "vs_whole_engine": v["vs_whole_engine"],
                  "held": {n: {k: x for k, x in h.items() if k != "shapes"}
                           for n, h in v["held"].items()},
                  "times": {n: {k: x for k, x in tm.items() if not k.endswith("_all")}
                            for n, tm in v["times"].items()},
                  **({"budget_mw": v["budget_mw"]} if "budget_mw" in v else {})}
              for r, v in out["fleet"].items()}
        print(json.dumps({"fleet": fl, "fleet_s": out["fleet_s"]}))
        print(json.dumps({"lm": out["lm"], "lm_s": out["lm_s"]}))

    # ---- (j) the gated step forms, LM training, the caches at long context
    @phase("j1_gated_steps")
    def _j1():
        out = report["j1_gated_steps"] = {}
        try:
            gated_steps_phase(dev, out, params, cfg_g)
        finally:
            print(json.dumps({"j1_gated_steps": {
                f: {k: v for k, v in r.items() if k != "held"} if isinstance(r, dict) else r
                for f, r in out.items()}}))

    @phase("j2_lm_train")
    def _j2():
        out = report["j2_lm_train"] = {}
        ckpt_dir = ROOT / "build" / "ckpt_j_train"
        try:
            lm_train_phase(dev, out, ckpt_dir)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            print(json.dumps({"j2_lm_train": {k: v for k, v in out.items()
                                              if k != "policies"}}))

    @phase("j3_long_context")
    def _j3():
        out = report["j3_long_context"] = {}
        long_context_phase(dev, out)

    # ---- (k) the distributed layer: NCCL at world size 1, the slot-sharded
    # engines through kernels 6 + 5 and 2 + 3 + 5 on every shard
    @phase("k_distributed")
    def _k():
        out = report["k_distributed"] = {}
        ckpt_dir = ROOT / "build" / "ckpt_k"
        try:
            launched = distributed_phase(dev, out, params, cfg_s, cfg_g, ckpt_dir)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        for name, c in launched.items():
            kernels.setdefault(name, {})["sharded_launches"] = c

    # ---- (l) kernel 4 past its one-chunk code tile; the dry run on fake ranks
    @phase("l1_fused_past_tile")
    def _l1():
        out = report["l1_fused_past_tile"] = {}
        fused_past_tile_phase(dev, out)
        if FUSED_SHA256 is not None:
            moved = sorted(k for k in set(hashes) | set(FUSED_SHA256)
                           if hashes.get(k) != FUSED_SHA256.get(k))
            assert not moved, f"fused_sha256 differs from the one-chunk kernel's at {moved}"

    @phase("l2_dryrun")
    def _l2():
        dry_result("l2_dryrun")

    @phase("l3_estimate")
    def _l3():
        out = report["l3_estimate"] = {}
        ops.reset_launches()
        estimate_phase(dev, out)
        assert not any(ops.LAUNCHES.values()), f"the step launched {ops.LAUNCHES}"

    @phase("l4_dryrun_faults")
    def _l4():
        dry_result("l4_dryrun_faults")

    # ---- (m) every LM family one card holds, at its own widths
    @phase("m_families")
    def _m():
        out = report["m_families"] = {}
        families_phase(dev, out)
        print(json.dumps({"m_families_s": out["s"]}))

    if dry_proc.poll() is None:      # a phase before l2 failed the script's own way
        dry_proc.kill()
        dry_proc.wait()
    dry_log.close()

    lost = [k for k in PREROLL_LOST if k is not None]
    report["profiler_preroll_lost"] = {"windows": len(PREROLL_LOST), "max": max(lost, default=None),
                                       "total": sum(lost), "marks_lost": PREROLL_LOST.count(None)}
    print(json.dumps({"profiler_preroll_lost": report["profiler_preroll_lost"]}))
    report["kernels"] = [kernels.get(n, {"name": n}) for n in KERNELS]
    keys = ("name", "route", "source", "symbol", "replaces", "redesigned", "launches",
            "sharded_launches", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "staged_device_ms")
    print(json.dumps({"kernels": [{k: row.get(k) for k in keys} for row in report["kernels"]]}))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e!r}"
    report["nvidia_smi"] = smi
    report["script_s"] = time.perf_counter() - t_script
    print(json.dumps({"script_s": report["script_s"],
                      "phase_s": {k: v.get("s") for k, v in report["phases"].items()}}))
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
