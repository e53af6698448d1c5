#!/usr/bin/env python3
"""Where ip2_fused_embed's clusters land, and what that costs, on one GPU.

    python3 tools/fused_embed_variants.py [--out DIR]

Builds variants of ``src/repro_torch/kernels/csrc/ip2_fused_embed.cu`` that
differ only in the projection tile (the bank height, and with it the
number and size of the clusters), each also without its embed (the
kernel returns after the code exchange) and with each block recording the
SM it ran on (``%smid``). At the serving shape (64 slots x 16 rows, K
1024, M 192, D 256) it checks every full variant bitwise against the
staged kernels ip2_project -> quant_matmul, and prints per variant the
device time per call (profiler kernel events over 50 calls, two rounds),
the number of distinct SMs the blocks ran on and how many SMs held two
blocks, beside ip2_project's and quant_matmul's device times. Runs from
the repository root; needs one CUDA device and nvcc.
"""

import argparse
import collections
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
TILE_LINE = "using T = ip2::FusedTile;"
# name -> (projection tile, blocks per cluster at M 192)
TILES = {
    "48x32": ("ip2::ProjectTile", 6),          # ip2_project's tile: 22 clusters of 6
    "64x32": ("ip2::FusedTile", 6),            # the committed tile: 16 clusters of 6
    "24x64": ("ip2::Tile<24, 64, 3, 4, 3, 64>", 3),  # 43 clusters of 3
}
NO_EMBED = ("  cluster_wait();  // the whole bank's codes are in every block of the cluster",
            "  cluster_wait();  // the whole bank's codes are in every block of the cluster\n"
            "  if (p.M > 0) return;")
SMID = ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;",
        "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
        "  if (tid == 0) {\n"
        "    unsigned sm;\n"
        "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
        "    g_smid[blockIdx.x] = sm;\n"
        "  }")
SMID_DECL = ("struct Args {", "__device__ unsigned g_smid[1 << 16];\n\nstruct Args {")
SMID_READ = ('\nextern "C" int read_smid(unsigned* host, int n) {\n'
             "  return (int)cudaMemcpyFromSymbol(host, g_smid, n * sizeof(unsigned));\n}\n")


def variant_source(tile, embed=True, smid=False):
    src = (CSRC / "ip2_fused_embed.cu").read_text()
    edits = [(TILE_LINE, f"using T = {tile};")]
    if not embed:
        edits.append(NO_EMBED)
    if smid:
        edits += [SMID_DECL, SMID]
    for old, new in edits:
        assert src.count(old) == 1, f"the source no longer has {old!r}"
        src = src.replace(old, new)
    return src + (SMID_READ if smid else "")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "fused_variants")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_embed_variants: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.adc import ADCSpec
    from repro_torch.core.projection import PatchSpec
    from repro_torch.kernels import _build, ops

    variants = {}
    for name, (tile, _) in TILES.items():
        variants[name] = variant_source(tile)
        variants[f"{name} no embed"] = variant_source(tile, embed=False)
        variants[f"{name} smid"] = variant_source(tile, smid=True)
    args.out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for i, (name, src) in enumerate(variants.items()):
        cu = args.out / f"v{i}.cu"
        cu.write_text(src)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE), cu)
    _build.build()
    libs = {}
    for name, (proc, cu) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{err.decode()[-3000:]}")
        lib = ctypes.CDLL(str(cu.with_suffix(".so")))
        lib.ip2_fused_embed_launch.argtypes = ops._ARGTYPES["ip2_fused_embed"]
        libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    S, k, P, K, M, D = 64, 16, 64, 1024, 192, 256
    patches = torch.rand((S * P, K), generator=g).to(dev)
    table = torch.stack([torch.randperm(P, generator=g)[:k] + i * P
                         for i in range(S)]).reshape(-1).int().to(dev)
    counts = torch.full((S,), k, dtype=torch.int32, device=dev)
    spec, adc = PatchSpec(32, 32, n_vectors=M), ADCSpec()
    w_t = ops._dac_weights((torch.randn((M, K), generator=g) * 6.4).to(dev), spec).T.contiguous()
    w8, s_w = ops.quantize_weights_int8((torch.randn((M, D), generator=g) * 0.1).to(dev))
    params = ops.kernel_params_from_spec(spec, adc, codes=True)
    ep = ops._epilogue(params)
    stream = torch.cuda.current_stream().cuda_stream
    gathered = patches[table.long()].contiguous()
    zero = torch.zeros(M, device=dev)
    codes = ops._ip2_project_cuda(gathered, w_t, zero, params)
    s_a = torch.full((S * k,), adc.lsb, device=dev)
    staged = ops._quant_matmul_cuda(codes, s_a, w8, s_w)

    def fused(lib):
        out = torch.empty((S * k, D), device=dev)
        rc = lib.ip2_fused_embed_launch(patches.data_ptr(), table.data_ptr(), counts.data_ptr(),
                                        S, k, K, w_t.data_ptr(), M, w8.data_ptr(), s_w.data_ptr(),
                                        adc.lsb, D, out.data_ptr(), ctypes.byref(ep), stream)
        assert rc == 0, f"launch failed: cudaError {rc}"
        return out

    def device_ms(fn, symbol, n=50):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        for _ in range(3):  # the profiler now and then drops a window
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and symbol in e.name]
            if len(evs) >= n - 2:
                return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / len(evs)
        return None

    report = {"device": torch.cuda.get_device_name(0), "device_ms": {}, "placement": {}}
    for name, lib in libs.items():
        if "no embed" not in name:
            got = fused(lib)
            torch.cuda.synchronize()
            assert torch.equal(got, staged), f"{name}: differs from the staged kernels"
    for rnd in range(2):
        report["device_ms"].setdefault("ip2_project", []).append(device_ms(
            lambda: ops._ip2_project_cuda(gathered, w_t, zero, params), "ip2_project_kernel"))
        report["device_ms"].setdefault("quant_matmul", []).append(device_ms(
            lambda: ops._quant_matmul_cuda(codes, s_a, w8, s_w), "quant_matmul_kernel"))
        for name, lib in libs.items():
            if "smid" not in name:
                report["device_ms"].setdefault(f"fused {name}", []).append(
                    device_ms(lambda: fused(lib), "ip2_fused_embed_kernel"))
    for name, (_, cs) in TILES.items():
        lib = libs[f"{name} smid"]
        fused(lib)
        torch.cuda.synchronize()
        rows = int(name.split("x")[0])
        n_blocks = -(-S * k // rows) * cs
        buf = (ctypes.c_uint * n_blocks)()
        assert lib.read_smid(buf, n_blocks) == 0
        per_sm = collections.Counter(buf)
        report["placement"][name] = {
            "clusters": n_blocks // cs, "blocks_per_cluster": cs, "blocks": n_blocks,
            "distinct_sms": len(per_sm),
            "sms_with_two_or_more_blocks": sum(c > 1 for c in per_sm.values())}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    report["nvidia_smi"] = smi
    (args.out / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
