"""Fault-tolerant training loop (the reference's ``repro.train.trainer``).

  * checkpoint / restart: periodic asynchronous atomic saves; on start,
    auto-resume from the latest commit, on the device the given state
    lives on, or with ``shardings`` as ``DTensor``s on any mesh (elastic
    restore); the data function is a pure function of the step, so the
    stream continues exactly;
  * preemption drain: SIGTERM / SIGINT set a flag; the loop finishes the
    current step, writes a blocking checkpoint and returns (the handlers
    are put back when ``run`` returns);
  * failure injection: ``fail_at_step`` raises after that step's update
    and before its checkpoint, so a resumed run must equal an
    uninterrupted one bit for bit;
  * stragglers: each step's wall time, taken until the host has read the
    loss (the step's end on the device), is held against the median of
    the last 20; steps slower than ``straggler_factor`` times it are
    counted.

The classifier's step (``make_train_step``: ``torch.autograd`` of a loss,
then AdamW) and its seekable data function (``stream_batches``) live here
beside the loop that drives them.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import tree_flatten_with_paths, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def loss_and_grads(loss_fn, params, rgb, labels):
    """``(loss, acc, grads)`` of ``loss_fn(params, rgb, labels)`` (which
    returns ``(loss, acc)``) by ``torch.autograd``, the gradients in the
    parameters' tree."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, acc = loss_fn(p, rgb, labels)
    grads = torch.autograd.grad(loss, [x for _, x in tree_flatten_with_paths(p)])
    return loss.detach(), acc.detach(), tree_unflatten(p, grads)


def make_train_step(loss_fn, opt: AdamWConfig):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: the
    gradient of ``loss_fn(params, batch["rgb"], batch["labels"])``, then
    one AdamW update at the constant ``opt.lr``. ``metrics`` holds
    ``loss``, ``acc`` and ``grad_norm`` as device tensors."""
    def step(params, opt_state, batch):
        loss, acc, grads = loss_and_grads(loss_fn, params, batch["rgb"], batch["labels"])
        lr = torch.full((), opt.lr, dtype=torch.float32, device=loss.device)
        params, opt_state, m = adamw_update(grads, opt_state, params, opt, lr)
        return params, opt_state, {"loss": loss, "acc": acc, **m}
    return step


def stream_batches(stream, batch: int, device):
    """``step -> {"rgb", "labels"}`` on ``device`` from ``stream.batch``
    (a ``SceneStream``): a pure function of the step, as the trainer's
    resume needs."""
    def data_fn(step):
        rgb, labels = stream.batch(step, batch)
        return {"rgb": torch.from_numpy(rgb).to(device),
                "labels": torch.from_numpy(labels).to(device)}
    return data_fn


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    # the reference's default; run() resumes from whatever is there, so
    # callers pass a directory of their own
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    log_every: int = 10
    fail_at_step: int | None = None      # failure injection (tests)
    straggler_factor: float = 3.0


class Trainer:
    def __init__(
        self,
        step_fn: Callable,                 # (params, opt, batch) -> (params, opt, metrics)
        data_fn: Callable[[int], dict],    # step -> batch (seekable)
        tcfg: TrainerConfig,
    ):
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.tcfg = tcfg
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self._preempted = False
        self.step_times: list[float] = []
        self.n_stragglers = 0

    def _install_signals(self) -> dict:
        """Point SIGTERM / SIGINT at the drain flag; returns the handlers
        they had (empty off the main thread, where none can be set)."""
        def handler(signum, frame):
            self._preempted = True

        old = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                old[sig] = signal.signal(sig, handler)
        except ValueError:
            pass  # not on the main thread
        return old

    def run(self, params, opt_state, start_step: int = 0, shardings=None):
        """Returns (params, opt_state, history). Auto-resumes if checkpoints
        exist (the restart-after-failure path); ``shardings`` (a tree of
        ``Sharding`` records for ``{"params", "opt"}``) restores onto them."""
        old = self._install_signals()
        try:
            return self._run(params, opt_state, start_step, shardings)
        finally:
            for sig, h in old.items():
                signal.signal(sig, h)

    def _run(self, params, opt_state, start_step: int, shardings):
        tcfg = self.tcfg
        state = {"params": params, "opt": opt_state}
        latest = self.ckpt.latest_step()
        step = start_step
        if latest is not None and latest >= start_step:
            device = tree_flatten_with_paths(params)[0][1].device
            state, step = self.ckpt.restore(state, device=device, shardings=shardings)
            step += 1  # saved after completing `step`
        params, opt_state = state["params"], state["opt"]

        history = []
        while step < tcfg.total_steps:
            t0 = time.time()
            batch = self.data_fn(step)
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = metrics["loss"]
            if hasattr(loss, "full_tensor"):   # a DTensor
                loss = loss.full_tensor()
            loss = float(loss)                 # waits for the step on the device
            dt = time.time() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-20:]))
            if len(self.step_times) > 5 and dt > tcfg.straggler_factor * med:
                self.n_stragglers += 1
            if step % tcfg.log_every == 0:
                history.append({"step": step, "loss": loss, "dt": dt})

            if tcfg.fail_at_step is not None and step == tcfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")

            if step % tcfg.ckpt_every == 0 or step == tcfg.total_steps - 1:
                self.ckpt.save(step, {"params": params, "opt": opt_state})
            if self._preempted:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               blocking=True)
                break
            step += 1

        self.ckpt.wait()
        return params, opt_state, history
