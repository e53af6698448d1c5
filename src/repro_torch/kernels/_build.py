"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, from the sources in this package only, into
``build/kernels/<hash>/`` at the repository root, where ``<hash>`` covers
every source and the flags, so an edited source rebuilds and an unchanged
one is reused. All sources compile in parallel (one ``nvcc`` each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ip2_project", "quant_matmul", "ip2_fused_embed", "ip2_ragged",
           "delta_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the epilogue's rounding is part of the contract
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_root() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return found


def build() -> dict[str, Path]:
    """Compile every source that has no library yet; returns name -> .so.
    The compiler's ``-Xptxas -v`` report lands in ``<name>.log`` beside it."""
    out_dir = build_root() / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {n: out_dir / f"lib{n}.so" for n in SOURCES}
    todo = [n for n in SOURCES if not libs[n].exists()]
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            log = open(out_dir / f"{n}.log", "w")
            procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                        tmp, log)
        failed = []
        for n, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(n)
            else:
                os.replace(tmp, libs[n])
        if failed:
            logs = "\n".join((out_dir / f"{n}.log").read_text() for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return libs


def build_logs() -> dict[str, str]:
    """The compiler reports of the current build (registers, shared memory,
    spills), for the record."""
    out_dir = build_root() / _digest()
    return {n: (out_dir / f"{n}.log").read_text()
            for n in SOURCES if (out_dir / f"{n}.log").exists()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build()[name]))
        return _libs[name]
