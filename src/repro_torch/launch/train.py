"""Fault-tolerant training driver on one device.

Counterpart of ``repro/launch/train.py``: data pipeline -> train step
(``launch.steps``) -> AdamW (+prox) -> gradual block pruner -> background
checkpoints -> Supervisor restart loop -> straggler monitor. Where the
reference takes a mesh, this driver takes ``device`` (None = the CUDA
card); sharding comes with ROADMAP.md Queue 1 item 8. The loop logic --
``_one_step``, masks updated and applied after each step, ``fit`` with
resume -- follows the reference, as does the donated step. Nothing in it
is BERT's: an LM trains from the same ``tokens`` / ``labels`` batches.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pruner as pruner_mod
from repro_torch.core.tree import map_with_path
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import init_model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                 FaultToleranceConfig,
                                                 StragglerMonitor, Supervisor)
from repro_torch.serving.serialize import dtype_name

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    n_steps: int = 100
    ckpt_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
    grad_accum: int = 1
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    ft: FaultToleranceConfig = dataclasses.field(
        default_factory=FaultToleranceConfig)
    prune: bool = False       # gradual block pruning during training


def _dtype_tree(tree):
    return map_with_path(lambda _, leaf: dtype_name(leaf.dtype), tree)


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device=None,
                 data_cfg: Optional[DataConfig] = None,
                 fault_injector: Optional[FaultInjector] = None):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.data_cfg = data_cfg or DataConfig(vocab_size=cfg.vocab_size)
        self.store = CheckpointStore(tcfg.ckpt_dir, keep=3)
        self.injector = fault_injector
        self.monitor = StragglerMonitor(self.data_cfg.n_hosts, tcfg.ft)
        # donated, as the reference jits its step with donate_argnums=(0, 1):
        # the update writes into the state's tensors (a checkpoint copies
        # them to the host inside save(), so none can be torn)
        self.step_fn = make_train_step(cfg, tcfg.opt, tcfg.grad_accum,
                                       donate=True)

    # -- state management --------------------------------------------------
    def init_state(self):
        params = init_model(self.tcfg.seed, self.cfg, device=self.device)
        opt = init_opt_state(params, self.tcfg.opt)
        masks = (pruner_mod.init_masks(params, self.cfg.sparsity)
                 if self.tcfg.prune and self.cfg.sparsity else None)
        return {"params": params, "opt": opt, "masks": masks}

    @staticmethod
    def save_state(store, step, state):
        store.save(step, {"params": state["params"], "opt": state["opt"],
                          "masks": state["masks"]}, blocking=False)

    def restore_state(self, store, step, like):
        tree = store.restore(_dtype_tree(
            {"params": like["params"], "opt": like["opt"],
             "masks": like["masks"]}), step=step, device=self.device)
        return {"params": tree["params"], "opt": tree["opt"],
                "masks": tree["masks"]}

    # -- step --------------------------------------------------------------
    def _one_step(self, state, step: int):
        if self.injector is not None:
            self.injector.maybe_fail(step)
        batch = {k: torch.from_numpy(v).to(self.device, torch.int64)
                 for k, v in self.pipeline.batch_at(step).items()}
        t0 = time.time()
        params, opt, metrics = self.step_fn(state["params"], state["opt"],
                                            batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        self.monitor.observe({self.data_cfg.host_id: time.time() - t0})
        masks = state["masks"]
        if masks is not None:
            sp = self.cfg.sparsity
            masks = pruner_mod.update_masks(params, masks, step, sp)
            params = pruner_mod.apply_masks(params, masks, sp)
        return {"params": params, "opt": opt, "masks": masks}, metrics

    # -- driver ------------------------------------------------------------
    def fit(self, resume: bool = True):
        """Train ``n_steps`` (from the latest checkpoint with ``resume``).
        Returns (state, history of (step, loss) every ``log_every``)."""
        self.pipeline = DataPipeline(self.data_cfg)
        try:
            state = self.init_state()
            start = 0
            if resume and self.store.latest_step() is not None:
                start = self.store.latest_step()
                state = self.restore_state(self.store, start, state)
                log.info("resumed from step %d", start)

            self.supervisor = Supervisor(self.tcfg.ft, self.store,
                                         self.save_state, self.restore_state)
            history = []

            def on_step(step, metrics):
                if step % self.tcfg.log_every == 0:
                    history.append((step, metrics["loss"]))
                    log.info("step %d loss %.4f", step, metrics["loss"])

            state, end = self.supervisor.run(state, start,
                                             self.tcfg.n_steps - start,
                                             self._one_step, on_step)
            self.save_state(self.store, end, state)
            self.store.wait()
        finally:
            self.pipeline.close()
        return state, history
