"""Serving with a CREAM-paged KV cache: the paper's capacity win, live.

Serves the same multi-turn session mix twice — once with the KV pool in
SECDED mode, once in CREAM (Inter-Wrap) mode with +12.5% device pages.
Every sequence's KV blocks live directly in pool pages (one batched page
gather per decode step); sessions park on the pool between turns, and
when frames run out the scheduler preempts the least-recently-used
batch-tier session to the host swap tier. The CREAM run keeps more
sessions device-resident, so fewer turns pay the host round-trip. Port of
``examples/serve_kv_cream.py``.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_kv_cream [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.examples import parser
from repro_torch.kernels.common import resolve_device
from repro_torch.serve import Engine, ServeRequest

CONFIG = dict(name="serve-demo", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
              head_dim=16, dtype="float32")
N_SESSIONS, N_TURNS = 10, 24


def main(argv=None, device=None) -> None:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    cfg = ModelConfig(**CONFIG)
    for mode in ("secded", "cream"):
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 256, size=12).astype(np.int32)
                   for _ in range(N_SESSIONS)]
        # several turns per session: later turns resume the parked KV
        reqs = [ServeRequest(f"s{t % N_SESSIONS}", prompts[t % N_SESSIONS],
                             max_new=6) for t in range(N_TURNS)]
        eng = Engine(cfg, max_batch=4, max_len=48, mode=mode, num_rows=40,
                     row_words=64, device=device)
        out = eng.serve(reqs)
        print(f"{mode:7s}: pages={out['device_pages']:3d} "
              f"tokens/s={out['tokens_per_s']:7.1f} "
              f"p99={out['p99_latency_ms']:7.1f}ms "
              f"preempt={out['preemptions']} restores={out['restores']} "
              f"host_reads={out['host_reads']}")


if __name__ == "__main__":
    main()
