"""Atomic, asynchronous checkpoints of a tree of tensors, in the reference's
on-disk format, so each package restores the other's checkpoints.

Layout (one directory per step):
    <dir>/step_00000100.tmp/       # written first
        manifest.json              # {"step": 100, "paths": [...]}
        arr_<i>.npy                # one file per leaf, in the manifest's order
    <dir>/step_00000100/           # atomic rename on completion = commit

Leaves are ordered and named as JAX's ``tree_flatten_with_path`` names
them (dict keys sorted, ``"['opt']/['m']/..."``). A bfloat16 leaf is
written as the reference's ``np.save`` writes one: its 2-byte words under
the descr ``'<V2'``; such a file is read back as ``torch.bfloat16``.

Properties kept from the reference:
  * atomic commit: a crash mid-write leaves only a ``.tmp`` directory,
    which restore ignores and the next save of that step replaces;
  * asynchronous: ``save`` copies every leaf to host memory before it
    returns (a later in-place update cannot race the write), then writes
    on a background thread; at most one save is pending;
  * keep-last-N garbage collection after each commit;
  * elastic restore: a tree of ``DTensor``s is saved whole (each leaf's
    ``full_tensor()``, gathered by every rank before ``save`` returns, then
    written by rank 0 alone: the same bytes as one process saving the full
    arrays), and ``restore(shardings=...)`` lays each leaf onto any mesh
    and placements with ``distribute_tensor``; without ``shardings`` the
    leaves go to ``device``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.convert import tree_flatten_with_paths, tree_unflatten

_BF16_DESCR = "<V2"


def _save_leaf(path: str, t: torch.Tensor) -> None:
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
    else:
        np.save(path, t.numpy())


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _load_leaf(path: str) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None
        self._barrier = False      # a distributed save is pending
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False) -> None:
        self.wait()
        flat = tree_flatten_with_paths(tree)
        paths = [p for p, _ in flat]
        distributed = any(_is_dtensor(x) for _, x in flat)
        # the snapshot, before save returns (a DTensor gathered whole)
        host_leaves = [(x.detach().full_tensor() if _is_dtensor(x) else x.detach())
                       .to("cpu", copy=True).contiguous() for _, x in flat]
        if distributed:
            import torch.distributed as dist

            self._barrier = True
            if dist.get_rank() != 0:           # one writer
                if blocking:
                    self.wait()
                return

        def write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "paths": paths}
            for i, t in enumerate(host_leaves):
                _save_leaf(os.path.join(tmp, f"arr_{i}.npy"), t)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic commit
            self._gc()

        if blocking:
            write()
            self.wait()
            return

        def background():
            try:
                write()
            except Exception as e:  # noqa: BLE001  re-raised by wait()
                self._error = e

        self._pending = threading.Thread(target=background, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Join the pending save; raise what it raised. After a save of
        ``DTensor``s every rank waits here until the writer has committed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._barrier:
            import torch.distributed as dist

            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, device=None, shardings=None):
        """``(tree, step)``: the checkpoint of ``step`` (the latest by
        default) in the structure of ``tree_like``. With ``shardings`` (a
        tree of the same structure of records with a ``mesh`` and
        ``placements``, such as ``launch.shardings.Sharding``) each leaf
        becomes a ``DTensor`` on its record's mesh and placements (the
        elastic re-shard path; every rank calls it); otherwise every leaf
        goes to ``device`` (the GPU by default).
        Raises ``ValueError`` when the leaves' paths differ from the
        manifest's."""
        dev = None if shardings is not None else resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        paths = [p for p, _ in tree_flatten_with_paths(tree_like)]
        if paths != manifest["paths"]:
            raise ValueError(
                "checkpoint tree mismatch: "
                f"{set(paths) ^ set(manifest['paths'])}"
            )
        leaves = [_load_leaf(os.path.join(d, f"arr_{i}.npy")) for i in range(len(paths))]
        if shardings is None:
            leaves = [t.to(dev) for t in leaves]
        else:
            from torch.distributed.tensor import distribute_tensor

            shs = [s for _, s in tree_flatten_with_paths(shardings)]
            leaves = [distribute_tensor(t.to(s.mesh.device_type), s.mesh, s.placements)
                      for t, s in zip(leaves, shs)]
        return tree_unflatten(tree_like, leaves), step
