"""Fault-tolerant training loop: checkpoint / restart, straggler flags,
simulated failures (port of `repro.runtime.ft`).

The loop is restart-idempotent: data batches are addressed by (seed, step)
(`repro_torch.data.pipeline`), checkpoints are atomic and committed, and
`run` resumes from the latest committed step.  Failures are injected by
`fault_injector(step) -> raise SimulatedFault` (the launcher's
`--inject-fault`); `run_with_restarts` catches them and restarts the loop
the way a cluster scheduler re-executes a preempted job.

Two differences from the reference, both in what a restart sees: a save
in flight when a fault is raised is committed before the fault leaves
`run` (the reference leaves its writer thread running, so whether the
restart finds that step depends on the thread's timing), and the losses
of the steps a failed attempt ran before the restart point stay in the
result (the reference drops a failed attempt's losses).  So the report
holds one loss for every step 0..total-1, and a run resumes from the
last checkpoint started before the fault.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..checkpoint.ckpt import CheckpointManager, latest_step
from ..optim.adamw import TrainState
from .straggler import StragglerDetector


class SimulatedFault(RuntimeError):
    pass


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    codec: str = "cram"
    log_every: int = 10


@dataclass
class LoopResult:
    final_step: int
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    straggler_flags: list = field(default_factory=list)
    restarts: int = 0


def run(step_fn, state, batch_iter, cfg: LoopConfig, *,
        start_step: int = 0, fault_injector=None,
        detector: StragglerDetector | None = None,
        result: LoopResult | None = None,
        log=print) -> tuple[LoopResult, object]:
    """Steps from `start_step` to `cfg.total_steps`, saving every
    `ckpt_every` steps and at the end.  `result` (a fresh one by default)
    collects the losses and times as they come, so a caller keeps them
    when a fault ends the run."""
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep, codec=cfg.codec)
    det = detector or StragglerDetector(n_hosts=1)
    res = result if result is not None else LoopResult(final_step=start_step)
    try:
        for step, batch in batch_iter:
            if step >= cfg.total_steps:
                break
            if fault_injector is not None:
                fault_injector(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])         # waits for the device
            dt = time.perf_counter() - t0
            flags = det.record(step, [dt])
            if flags:
                res.straggler_flags.append((step, flags))
            res.losses.append(loss)
            res.step_times.append(dt)
            res.final_step = step + 1
            if cfg.log_every and step % cfg.log_every == 0:
                log(f"step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
                mgr.save_async(step + 1, state)
    finally:
        mgr.wait()
    if res.final_step > start_step:
        mgr.save_async(res.final_step, state)
        mgr.wait()
    return res, state


def restore_into(state: TrainState, restored: TrainState) -> TrainState:
    """Copy a restored state's tensors into `state`'s, each in the dtype
    and on the device of the tensor it replaces (the reference's
    `device_put(arr.astype(like.dtype))`); returns `state`."""
    with torch.no_grad():
        for f in ("params", "m", "v"):
            dst, src = getattr(state, f), getattr(restored, f)
            if dst.keys() != src.keys():
                raise ValueError(f"restored {f} keys differ from the "
                                 "state's")
            for k, t in dst.items():
                t.copy_(src[k].to(t.dtype))
        for f in ("step", "dyn_counter"):
            getattr(state, f).copy_(getattr(restored, f).to(torch.int32))
    return state


def run_with_restarts(make_step_fn, make_state, make_batch_iter,
                      cfg: LoopConfig, *, fault_injector=None,
                      max_restarts: int = 5, log=print):
    """Supervisor: restart from the latest committed checkpoint on faults.

    make_state() builds the step-0 state; on restart its tensors are
    overwritten with the latest committed checkpoint's."""
    restarts = 0
    all_losses: list[float] = []
    while True:
        start = latest_step(cfg.ckpt_dir) or 0
        state = make_state()
        if start:
            mgr = CheckpointManager(cfg.ckpt_dir, codec=cfg.codec)
            restored, _ = mgr.restore_latest(state)
            state = restore_into(state, restored)
            log(f"resumed from step {start}")
        step_fn = make_step_fn()
        batch_iter = make_batch_iter(start)
        res = LoopResult(final_step=start)
        try:
            res, state = run(step_fn, state, batch_iter, cfg,
                             start_step=start, fault_injector=fault_injector,
                             result=res, log=log)
            res.restarts = restarts
            res.losses = all_losses[:start] + res.losses
            return res, state
        except SimulatedFault as e:
            all_losses = all_losses[:start] + res.losses
            restarts += 1
            log(f"fault at restart #{restarts}: {e}")
            if restarts > max_restarts:
                raise
        finally:
            if hasattr(batch_iter, "close"):
                batch_iter.close()
