"""Fault-tolerant training driver, on one device or on a process mesh.

Counterpart of ``repro/launch/train.py``: data pipeline -> train step
(``launch.steps``) -> AdamW (+prox) -> gradual block pruner -> background
checkpoints -> Supervisor restart loop -> straggler monitor. The loop logic
-- ``_one_step``, masks updated and applied after each step, ``fit`` with
resume -- follows the reference, as does the donated step. Nothing in it
is BERT's: an LM trains from the same ``tokens`` / ``labels`` batches.

``device`` (None = the CUDA card) places one device's run. ``mesh`` (a
``launch.mesh.ProcessMesh``; one process per mesh position, every rank
building its own Trainer) trains every family of the registry as the
reference's Trainer does on a mesh: each rank holds its shard of every
param and AdamW leaf under the train-mode rules (TP over "model", FSDP
over "data", routed experts' E over "model"), takes its rows of one
device's global batch (with ``grad_accum`` its rows of each global
microbatch), and the step computes one device's step up to the order of
fp32 sums (a MoE layer routes the global batch: ``common.ExpertShard``).
A global batch of one row (``DataConfig(global_batch=1)``) whose S divides
over the dp axes is cut along S, the reference's sequence-parallel branch:
each rank trains its block of the row (the dense LM family and BERT; the
other families raise, and so does ``grad_accum`` > 1).
On a multi-pod mesh (("pod", "data", "model")) "pod" is data parallelism
too: a rank's rows and the gradients' mean run over ("pod", "data"),
weights are cut over "data" alone.
The Trainer's batches are ``tokens`` / ``labels``, as the data pipeline
gives them; a vlm step with ``mm_embeds`` or an audio step with
``frames`` goes through ``launch.steps.make_train_step(mesh=)``. The
block masks are whole on every rank. Checkpoints hold whole leaves (rank
0 writes) and restore onto any mesh shape or one device. A
``FaultInjector`` fault fails the step on every rank and every rank
restores; a rank that dies alone ends the job when its peers' next
collective times out (the process group's timeout) -- recovering from
that is not done here.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore, spec_at
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pruner as pruner_mod
from repro_torch.core.tree import map_with_path
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import (local_rows, local_shard,
                                         opt_shardings)
from repro_torch.launch.steps import make_train_step, sequence_shard
from repro_torch.models.api import init_model, init_model_local
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
                 fault_injector: Optional[FaultInjector] = None,
                 mesh=None):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = resolve_device(device)
        self.data_cfg = data_cfg or DataConfig(vocab_size=cfg.vocab_size)
        if mesh is not None:
            if self.data_cfg.n_hosts != 1:
                raise ValueError(
                    "a mesh Trainer takes each rank's rows of one global "
                    "batch: pass a DataConfig with n_hosts=1 (a host's draw "
                    "is seeded by its host_id, so n_hosts draws are not one "
                    "global batch)")
        self.store = CheckpointStore(tcfg.ckpt_dir, keep=3)
        self.injector = fault_injector
        self.monitor = StragglerMonitor(self.data_cfg.n_hosts, tcfg.ft)
        # donated, as the reference jits its step with donate_argnums=(0, 1):
        # the update writes into the state's tensors (a checkpoint copies
        # them to the host inside save(), so none can be torn)
        # a global batch of one row cut along S over the dp axes (the
        # reference's sequence-parallel branch): the steps take the
        # rank's block and its SeqShard
        d = self.data_cfg
        seq = sequence_shard(cfg, {k: torch.empty(
            (d.global_batch, d.seq_len), device="meta")
            for k in ("tokens", "labels")}, mesh)
        self.step_fn = make_train_step(cfg, tcfg.opt, tcfg.grad_accum,
                                       donate=True, mesh=mesh,
                                       packs=None if seq is None
                                       else {"seq": seq})
        self.plan = self.step_fn.plan
        self._specs = None

    # -- state management --------------------------------------------------
    def specs(self):
        """The spec tree of the checkpointed state (``params`` / ``opt``
        under the train-mode rules, the masks whole); None off a mesh."""
        if self.mesh is None:
            return None
        if self._specs is None:
            shapes = self.plan.shapes
            self._specs = {"params": self.plan.specs, "opt": opt_shardings(
                {"m": shapes, "v": shapes,
                 "step": torch.empty((), device="meta")}, self.mesh),
                "masks": None}
        return self._specs

    def init_state(self):
        if self.mesh is None:
            params = init_model(self.tcfg.seed, self.cfg, device=self.device)
        else:
            params = init_model_local(self.tcfg.seed, self.cfg,
                                      self.plan.cut, device=self.device)
        opt = init_opt_state(params, self.tcfg.opt)
        masks = None
        if self.tcfg.prune and self.cfg.sparsity:
            # whole masks on every rank, from the whole leaves' shapes
            masks = pruner_mod.init_masks(
                params if self.mesh is None else self.plan.shapes,
                self.cfg.sparsity)
            if self.mesh is not None:
                masks = map_with_path(lambda _, m: torch.ones(
                    m.shape, dtype=torch.bool, device=self.device), masks)
        return {"params": params, "opt": opt, "masks": masks}

    def save_state(self, store, step, state):
        store.save(step, {"params": state["params"], "opt": state["opt"],
                          "masks": state["masks"]}, blocking=False,
                   mesh=self.mesh, specs=self.specs())

    def restore_state(self, store, step, like):
        tree = {"params": like["params"], "opt": like["opt"],
                "masks": like["masks"]}
        select = None
        if self.mesh is not None:
            specs = self.specs()
            coord = {a: self.mesh.coord(a) for a in self.mesh.axis_names}

            def select(path, arr):
                return local_shard(arr, spec_at(specs, path) or (),
                                   self.mesh, coord)
        tree = store.restore(_dtype_tree(tree), step=step,
                             device=self.device, select=select)
        return {"params": tree["params"], "opt": tree["opt"],
                "masks": tree["masks"]}

    def shards(self, params):
        """{path: LeafShard} of this rank's params (empty off a mesh)."""
        return self.plan.shards(params) if self.mesh is not None else None

    # -- step --------------------------------------------------------------
    def batch_at(self, step: int) -> dict:
        """The step's batch on this rank's device: one device's global
        batch, or on a mesh this rank's rows of it."""
        batch = self.pipeline.batch_at(step)
        if self.mesh is not None:
            batch = local_rows(batch, self.mesh, self.tcfg.grad_accum)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device, torch.int64) for k, v in batch.items()}

    def _one_step(self, state, step: int):
        if self.injector is not None:
            self.injector.maybe_fail(step)
        batch = self.batch_at(step)
        t0 = time.time()
        params, opt, metrics = self.step_fn(state["params"], state["opt"],
                                            batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        self.monitor.observe({self.data_cfg.host_id: time.time() - t0})
        masks = state["masks"]
        if masks is not None:
            sp = self.cfg.sparsity
            shards = self.shards(params)
            masks = pruner_mod.update_masks(params, masks, step, sp, shards)
            params = pruner_mod.apply_masks(params, masks, sp, shards)
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
