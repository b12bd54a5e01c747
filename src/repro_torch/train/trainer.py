"""Fault-tolerant training loop with DS-Softmax lifecycle management.

* auto-resume from the latest checkpoint (params, optimizer, DS masks,
  data-pipeline step) — a restarted job continues where it stopped;
* preemption-signal checkpointing (SIGTERM → save at step boundary);
* per-step watchdog: steps slower than ``straggler_factor``× the running
  median are logged as straggler suspects;
* transient-failure retry: a failed step is retried from the last good
  state up to ``max_retries`` times before surfacing (the train step is
  functional, so the last good state is the one the failed step was
  given, untouched);
* DS-Softmax mitosis schedule: expert cloning at configured steps (the
  paper's memory-bounded route to large K), with a fresh bundle for the
  new expert count.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.core import mitosis
from repro_torch.models.model_zoo import ModelBundle, build
from repro_torch.optim import adam_init, make_schedule
from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.utils import get_logger

log = get_logger("trainer")


class Trainer:
    def __init__(self, bundle: ModelBundle, tcfg: TrainConfig, data_iter, *, pipeline=None,
                 mitosis_steps: Optional[Dict[int, int]] = None,  # step -> new K (x2 clone)
                 hooks: Optional[Dict[str, Callable]] = None,
                 straggler_factor: float = 3.0, max_retries: int = 2):
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.tcfg = tcfg
        self.data_iter = data_iter
        self.pipeline = pipeline
        self.mitosis_steps = mitosis_steps or {}
        self.hooks = hooks or {}
        self.straggler_factor = straggler_factor
        self.max_retries = max_retries
        self.mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        self.sched = make_schedule(tcfg.schedule, tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
        self._step_fn = None
        self.metrics_history: list[dict] = []

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(device=self.bundle.device).manual_seed(seed)
        params, ds_state = self.bundle.init(gen)
        return TrainState(params=params, opt=adam_init(params), ds_state=ds_state)

    def _compile(self):
        self._step_fn = make_train_step(self.bundle, self.tcfg, self.sched)

    def _rebuild(self, num_experts: int) -> None:
        """A fresh bundle (and step) for a DS head of ``num_experts``."""
        self.cfg = self.cfg.replace(ds=self.cfg.ds.replace(num_experts=num_experts))
        self.bundle = build(self.cfg, device=self.bundle.device)
        self._compile()

    # ------------------------------------------------------------------
    def maybe_resume(self, state: TrainState):
        latest = self.mgr.latest()
        if latest is None:
            return state, 0
        restored, meta = self.mgr.restore(like=state)
        if self.pipeline is not None and meta and "pipeline" in meta:
            self.pipeline.restore(meta["pipeline"])
        if self.cfg.head == "ds":  # a checkpoint taken after mitosis
            K = restored.params["head"]["gate"].shape[0]
            if K != self.cfg.ds.num_experts:
                self._rebuild(K)
        log.info("auto-resumed at step %d", meta["step"])
        return restored, int(meta["step"])

    def _checkpoint(self, step: int, state: TrainState):
        meta: dict = {}
        if self.pipeline is not None:
            meta["pipeline"] = self.pipeline.snapshot()
        self.mgr.save(step, state, meta=meta)

    # ------------------------------------------------------------------
    def _apply_mitosis(self, state: TrainState) -> TrainState:
        """Clone DS experts K -> 2K (paper Fig. 2) and rebuild the opt
        state as ``repro`` does: every moment starts afresh and the step
        count is kept. The gate noise is ``clone_experts``' default, drawn
        from a generator seeded with the step."""
        gen = torch.Generator(device=self.bundle.device).manual_seed(int(state.opt.step))
        head, ds_state = mitosis.clone_experts(gen, state.params["head"], state.ds_state)
        params = dict(state.params)
        params["head"] = head
        opt = adam_init(params)._replace(step=state.opt.step)
        self._rebuild(head["gate"].shape[0])
        log.info("mitosis: experts -> %d", head["gate"].shape[0])
        return TrainState(params=params, opt=opt, ds_state=ds_state)

    def _to_device(self, batch) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.bundle.device)
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def train(self, state: Optional[TrainState] = None, steps: Optional[int] = None):
        if state is None:
            state = self.init_state(self.tcfg.seed)
        state, start = self.maybe_resume(state)
        if self._step_fn is None:
            self._compile()
        steps = steps if steps is not None else self.tcfg.total_steps
        self.mgr.install_preemption_handler()

        durations: list[float] = []
        step = start
        while step < steps:
            if step in self.mitosis_steps:
                state = self._apply_mitosis(state)
            batch = self._to_device(next(self.data_iter))

            retries = 0
            while True:
                try:
                    t0 = time.perf_counter()
                    new_state, metrics = self._step_fn(state, batch)
                    names = sorted(metrics)
                    values = torch.stack([metrics[k].float() for k in names]).tolist()
                    dt = time.perf_counter() - t0
                    break
                except Exception as e:  # noqa: BLE001 — transient-failure retry
                    retries += 1
                    if retries > self.max_retries:
                        log.error("step %d failed %d times: %s", step, retries, e)
                        self._checkpoint(step, state)
                        self.mgr.wait()
                        raise
                    log.warning("step %d retry %d after %s", step, retries, e)
                    self._compile()

            state = new_state
            durations.append(dt)
            med = float(np.median(durations[-50:]))
            if len(durations) > 10 and dt > self.straggler_factor * med:
                log.warning("straggler suspect: step %d took %.3fs (median %.3fs)", step, dt, med)

            rec = dict(zip(names, values))
            rec["step"] = step
            rec["dt"] = dt
            self.metrics_history.append(rec)
            if "on_step" in self.hooks:
                self.hooks["on_step"](step, rec, state)

            step += 1
            if self.mgr.preempted or (self.tcfg.ckpt_every and step % self.tcfg.ckpt_every == 0):
                self._checkpoint(step, state)
                if self.mgr.preempted:
                    self.mgr.wait()
                    log.warning("exiting after preemption checkpoint at step %d", step)
                    return state
        self._checkpoint(steps, state)
        self.mgr.wait()
        return state
