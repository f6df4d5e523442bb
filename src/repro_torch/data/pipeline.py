"""Deterministic synthetic token pipeline with shard-aware skip/refill.

Port of ``repro/data/pipeline.py``. The contract a large trainer needs:

  * deterministic per-(seed, step, shard) batches — any host can
    regenerate any shard's batch from (seed, step) alone, so restarts and
    elastic re-meshes never replay or skip data;
  * straggler mitigation by construction: there is no shared queue to
    drain — a failed host's shard is recomputed by its replacement;
  * a lightweight mixture model (Zipfian unigrams + a motif token at every
    8th position) so losses move during tests instead of staying at log V.

The draws come from a host ``torch.Generator`` seeded from ``(seed, step,
shard)`` and are then uploaded, so the card and the CPU see the same
tokens. They do not match ``jax.random``'s (the port's convention for
random draws); the Zipf logits do, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


def _zipf_logits(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-cfg.zipf_alpha)
    return np.log(probs / probs.sum())


class SyntheticStream:
    """Deterministic (step, shard) -> batch generator, batches on
    ``device`` (``cuda`` unless asked otherwise)."""

    def __init__(self, cfg: DataConfig, num_shards: int = 1,
                 shard_id: int = 0, device=None):
        if cfg.global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.cfg = cfg
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.local_batch = cfg.global_batch // num_shards
        self.device = resolve_device(device)
        self._probs = torch.from_numpy(np.exp(_zipf_logits(cfg)))

    def _generator(self, step: int) -> torch.Generator:
        seed = np.random.SeedSequence(
            [self.cfg.seed, step, self.shard_id]).generate_state(1)[0]
        return torch.Generator().manual_seed(int(seed))

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        """-> {'tokens': (local_batch, S), 'labels': (local_batch, S)}
        int32 on the stream's device."""
        gen = self._generator(step)
        b, s = self.local_batch, self.cfg.seq_len
        base = torch.multinomial(self._probs, b * (s + 1), replacement=True,
                                 generator=gen).reshape(b, s + 1)
        # periodic motif: every 8th position repeats the motif token,
        # giving the model a learnable structure
        motif = torch.randint(0, self.cfg.vocab_size, (b, 1), generator=gen)
        pos = torch.arange(s + 1)[None, :]
        seq = torch.where(pos % 8 == 0, motif, base).to(torch.int32)
        seq = seq.to(self.device)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield step, self.batch(step)
            step += 1
