"""Trainer: the fault-tolerant training loop with CREAM integration.

Port of ``repro/train/trainer.py``. Per step: deterministic batch -> the
train step. Periodically:

  * **scrub** — the SECDED pool holding the optimizer-moment snapshot is
    swept (the scrub kernel on the card); single-bit SDC is repaired in
    place, rates feed the monitor (paper §3.1 health loop);
  * **snapshot** — moments are re-stored into the pool (warm-restart
    tier; the SECDED encode kernel on the card) and a full
    SECDED-protected checkpoint goes to disk;
  * **restart** — :meth:`Trainer.restore` resumes from the latest disk
    checkpoint; :meth:`Trainer.warm_restore` rebuilds moments from the
    pool after a simulated in-memory crash, repairing any injected bit
    flips on the way (the SECDED decode kernel on the card).

The trainer's state is the reference's: ``params`` is the reference's
parameter tree (:func:`repro_torch.models.params_tree` of a model built
from ``seed`` on ``device``; the trainer's own tensors, not a serving
model's), ``opt_state`` an :class:`~repro_torch.optim.adamw.AdamWState`
over the same tree. Everything runs on ``device`` (``cuda`` unless asked
otherwise).

Across ranks (``replicas``: a host mesh's data-parallel replicas,
:func:`repro_torch.distributed.sharding.data_replicas`): the parameters
start as rank 0's (one broadcast), every rank takes its rows of each
global batch and applies the same averaged update; each rank keeps and
scrubs its own moment pool and runs :meth:`Trainer.warm_restore` on it;
rank 0 writes the checkpoints, and every rank restores after a barrier.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import poolstore
from repro_torch.core.layouts import Layout
from repro_torch.core.monitor import ErrorMonitor
from repro_torch.core.pool import make_pool
from repro_torch.core.scrubber import scrub
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.distributed.sharding import (data_replicas, tree_leaves,
                                              tree_map)
from repro_torch.kernels.common import resolve_device
from repro_torch.models import build_model, params_tree
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step


@dataclass
class Trainer:
    cfg: ModelConfig
    tcfg: TrainConfig
    data: SyntheticStream
    checkpointer: Checkpointer | None = None
    attn_impl: str = "xla"
    device: Any = None
    # runtime state
    params: Any = None
    opt_state: Any = None
    step: int = 0
    metrics_log: list = field(default_factory=list)
    # CREAM: SECDED pool snapshot of the optimizer moments
    moment_pool: Any = None
    moment_toc: Any = None
    monitor: ErrorMonitor = field(default_factory=ErrorMonitor)
    #: data-parallel replicas (None: one process)
    replicas: Any = None

    def initialize(self, seed: int | None = None) -> None:
        """Weights drawn from ``seed`` (default ``tcfg.seed``) on the
        device, zero moments, and the moment pool."""
        self.device = resolve_device(self.device)
        model = build_model(self.cfg, seed=seed if seed is not None
                            else self.tcfg.seed, device=self.device)
        self._start(params_tree(model))

    def load_params(self, tree) -> None:
        """Start from a given parameter tree instead (the reference's, as
        numpy arrays or tensors): zero moments, a fresh moment pool."""
        self.device = resolve_device(self.device)
        self._start(tree_map(
            lambda a: poolstore.as_tensor(a, self.device), tree))

    def _start(self, params) -> None:
        if self.replicas:
            # every replica starts from rank 0's parameters
            import torch.distributed as dist
            src = dist.get_global_rank(self.replicas.group, 0)
            for p in tree_leaves(params):
                dist.broadcast(p, src, group=self.replicas.group)
        self.params = params
        self.opt_state = adamw.init(self.params)
        self.step = 0
        self._step_fn = make_train_step(self.cfg, self.tcfg, self.attn_impl,
                                        replicas=self.replicas)
        if self.tcfg.protect_opt_state:
            self._init_moment_pool()

    def _init_moment_pool(self) -> None:
        moments = {"m": self.opt_state.m, "v": self.opt_state.v}
        rows = poolstore.required_rows(moments)
        self.moment_pool = None          # release a previous pool first
        self.moment_pool = make_pool(rows, Layout.INTERWRAP, boundary=0,
                                     device=self.device)
        self.snapshot_moments()

    # -- CREAM integration ----------------------------------------------------
    def snapshot_moments(self) -> None:
        if self.moment_pool is None:
            return
        moments = {"m": self.opt_state.m, "v": self.opt_state.v}
        self.moment_pool, self.moment_toc = poolstore.store_tree(
            self.moment_pool, moments)

    def scrub_pools(self) -> dict:
        if self.moment_pool is None:
            return {}
        self.moment_pool, stats = scrub(self.moment_pool)
        self.monitor.record("opt_moments", stats)
        return {"corrected": stats.corrected,
                "uncorrectable": stats.detected_uncorrectable,
                "rate": stats.error_rate}

    def warm_restore(self) -> int:
        """Rebuild optimizer moments from the SECDED pool (in-memory crash
        recovery without touching disk). Returns worst decode status seen."""
        moments_like = {"m": self.opt_state.m, "v": self.opt_state.v}
        restored, worst = poolstore.load_tree(self.moment_pool,
                                              self.moment_toc, moments_like)
        self.opt_state = dataclasses.replace(
            self.opt_state, m=restored["m"], v=restored["v"])
        return worst

    # -- checkpoint/restart ----------------------------------------------------
    def _ckpt_tree(self) -> dict:
        return {"params": self.params,
                "opt": {"step": self.opt_state.step, "m": self.opt_state.m,
                        "v": self.opt_state.v},
                "meta": {"step": torch.tensor(self.step, dtype=torch.int64,
                                              device=self.device)}}

    def _barrier(self) -> None:
        if self.replicas:
            import torch.distributed as dist
            dist.barrier(group=self.replicas.group)

    def save(self) -> None:
        """Checkpoint the state (rank 0 writes it; every rank waits)."""
        if self.checkpointer:
            if not self.replicas or self.replicas.rank == 0:
                self.checkpointer.save(self.step, self._ckpt_tree())
            self._barrier()

    def restore(self, step: int | None = None) -> bool:
        if not self.checkpointer:
            return False
        self._barrier()           # rank 0's last save has landed
        step = step if step is not None else self.checkpointer.latest_step()
        if step is None:
            return False
        tree, report = self.checkpointer.restore(step, like=self._ckpt_tree())
        if report.corrupt_leaves:
            raise RuntimeError(
                f"uncorrectable checkpoint leaves: {report.corrupt_leaves}")
        self._adopt(tree)
        return True

    def _adopt(self, tree: dict) -> None:
        """Take params, optimizer state and step from a restored
        checkpoint tree (the old tensors are released first)."""
        self.params = self.opt_state = None
        self.params = tree["params"]
        self.opt_state = adamw.AdamWState(
            step=tree["opt"]["step"], m=tree["opt"]["m"], v=tree["opt"]["v"])
        self.step = int(tree["meta"]["step"])

    # -- the loop ---------------------------------------------------------------
    def run(self, num_steps: int) -> list[dict]:
        for _ in range(num_steps):
            batch = self.data.batch(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["wall_s"] = time.perf_counter() - t0   # after the sync
            rec["step"] = self.step
            self.metrics_log.append(rec)
            self.step += 1
            if self.tcfg.scrub_every and self.step % self.tcfg.scrub_every == 0:
                rec["scrub"] = self.scrub_pools()
            if self.tcfg.checkpoint_every and \
                    self.step % self.tcfg.checkpoint_every == 0:
                self.snapshot_moments()
                self.save()
        return self.metrics_log


def make_trainer(cfg: ModelConfig, tcfg: TrainConfig,
                 ckpt_dir: str | None = None, seed: int = 0,
                 num_shards: int = 1, shard_id: int = 0,
                 seq_len: int = 128, global_batch: int = 8,
                 device=None) -> Trainer:
    """A trainer from ``seed``; under a host mesh of several ranks
    (:func:`~repro_torch.distributed.sharding.use_mesh`) data-parallel,
    each rank taking its rows of the ``global_batch``."""
    device = resolve_device(device)
    reps = data_replicas()
    data = SyntheticStream(
        DataConfig(cfg.vocab_size, seq_len, global_batch, seed=seed),
        num_shards=num_shards, shard_id=shard_id, device=device,
        replica=reps.rank if reps else 0, replicas=reps.size if reps else 1)
    ckpt = Checkpointer(ckpt_dir, device=device) if ckpt_dir else None
    tr = Trainer(cfg, tcfg, data, ckpt, device=device, replicas=reps)
    tr.initialize(seed)
    return tr
