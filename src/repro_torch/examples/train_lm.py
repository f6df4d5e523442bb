"""End-to-end driver: train a ~110M-parameter LM with the full CREAM stack.

Exercises every training-path layer: synthetic data pipeline, the
stage-tiled transformer, AdamW, microbatched train step, SECDED-protected
optimizer snapshots with scrubbing, SECDED checkpoints with restart, and a
mid-run injected SDC repaired without losing a step. Port of
``examples/train_lm.py``, with the same flags.

Run (full, a few hundred steps — on the card):
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --seq-len 256 --batch 8
Defaults are sized for a small box (10 steps, 64x2); ``--device cpu`` runs
on the CPU. The checkpoint directory defaults to ``cream_train_lm`` under
the system's temporary directory.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.injection import inject_flips
from repro_torch.examples import parser
from repro_torch.kernels.common import resolve_device
from repro_torch.models import count_params
from repro_torch.train.trainer import make_trainer

CONFIG = dict(name="lm-110m", family="dense", num_layers=14, d_model=640,
              num_heads=10, num_kv_heads=5, d_ff=2560, vocab_size=16384,
              head_dim=64, dtype="float32")


def main(argv=None, device=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "cream_train_lm"))
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    cfg = ModelConfig(**CONFIG)
    print(f"model: {count_params(cfg)/1e6:.1f}M params")

    micro = 2 if args.batch >= 4 else None
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=20,
                       total_steps=max(args.steps, 100), microbatch=micro,
                       scrub_every=5, checkpoint_every=20, remat="block")
    tr = make_trainer(cfg, tcfg, ckpt_dir=args.ckpt, seq_len=args.seq_len,
                      global_batch=args.batch, device=device)
    if tr.restore():
        print(f"resumed from checkpoint at step {tr.step}")

    rng = np.random.default_rng(0)
    t0 = time.time()
    half = args.steps // 2
    tr.run(half)
    # mid-run SDC: flip bits in the protected optimizer snapshot
    stor, recs = inject_flips(tr.moment_pool.storage, rng, 5)
    tr.moment_pool = dataclasses.replace(tr.moment_pool, storage=stor)
    repaired = tr.scrub_pools()
    print(f"injected 5 bit flips -> scrub corrected {repaired['corrected']}")
    log = tr.run(args.steps - half)

    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq_len
    print(f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f} | "
          f"{toks/dt:.0f} tok/s | checkpoints at {args.ckpt}")
    if args.steps >= 30:
        assert log[-1]["loss"] < log[0]["loss"], "model must learn"


if __name__ == "__main__":
    main()
