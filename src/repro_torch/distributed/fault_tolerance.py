"""Fault tolerance: the recovery ladder of a large training job.

Port of ``repro/distributed/fault_tolerance.py``. Recovery ladder
(cheapest first), each rung backed by a tested mechanism:

  1. **scrub-repair** (no restart): SECDED pools self-heal single-bit SDC
     in optimizer snapshots (core.scrubber + trainer.scrub_pools).
  2. **targeted restore**: SECDED-uncorrectable pool pages are re-fetched
     from the last checkpoint without touching healthy state.
  3. **warm restart**: a crashed step rebuilds optimizer moments from the
     in-memory SECDED pool (trainer.warm_restore).
  4. **cold restart**: full checkpoint restore; the deterministic data
     pipeline resumes at the exact step (no replayed/skipped batches).
  5. **elastic re-mesh**: pod loss -> reshard_tree to the surviving mesh
     and continue with a scaled data axis (distributed.elastic).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.train.trainer import Trainer


@dataclass
class RecoveryReport:
    rung: str
    details: dict


def recover(trainer: Trainer, failure: str) -> RecoveryReport:
    """Apply the cheapest sufficient rung for the given failure kind."""
    if failure == "sdc_single_bit":
        stats = trainer.scrub_pools()
        if stats.get("uncorrectable", 0) == 0:
            return RecoveryReport("scrub-repair", stats)
        failure = "sdc_multi_bit"
    if failure == "sdc_multi_bit":
        # pool pages are beyond repair -> restore from disk
        step = trainer.checkpointer.latest_step()
        tree, report = trainer.checkpointer.restore(
            step, like=trainer._ckpt_tree())
        bad = report.corrupt_leaves
        if bad:
            raise RuntimeError(f"checkpoint also corrupt: {bad}")
        trainer._adopt(tree)
        trainer.snapshot_moments()
        return RecoveryReport("targeted-restore",
                              {"restored_at_step": trainer.step,
                               "corrected": report.corrected_leaves})
    if failure == "process_crash":
        worst = trainer.warm_restore()
        if worst <= 2:  # clean or corrected
            return RecoveryReport("warm-restart", {"worst_status": worst})
        failure = "host_loss"
    if failure == "host_loss":
        ok = trainer.restore()
        return RecoveryReport("cold-restart",
                              {"restored": ok, "step": trainer.step})
    raise ValueError(failure)
