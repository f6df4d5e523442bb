"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

Port of ``repro/launch/serve.py``, with the same flags and defaults. Boots
the CREAM-Serve paged-KV engine and serves a synthetic request mix;
``--pool-mode`` flips the device tier between conventional SECDED and
CREAM (+12.5 % pages) to show the capacity effect, ``--paid-frac``
controls the share of requests on the SECDED-backed paid tier. It runs on
``--device`` (default ``cuda``; ``--device cpu`` runs the plain versions
of the kernels on the CPU). The config is served as it is: a config in
bfloat16 (every full-width one) is refused by the paged KV cache, which
keeps float32 KV only, as in the reference.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serve import Engine, ServeRequest


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--pool-mode", choices=["cream", "secded"],
                    default="cream")
    ap.add_argument("--pool-rows", type=int, default=64)
    ap.add_argument("--row-words", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--paid-frac", type=float, default=0.25,
                    help="share of requests on the SECDED paid tier")
    ap.add_argument("--secded-rows", type=int, default=16,
                    help="rows kept SECDED in cream mode (the paid tier's "
                         "frames; multiple of 8)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(
        f"s{i}",
        rng.integers(0, cfg.vocab_size,
                     size=args.prompt_len).astype(np.int32),
        args.max_new,
        tier="paid" if i < args.paid_frac * args.requests else "batch")
        for i in range(args.requests)]
    eng = Engine(cfg, max_batch=args.batch, max_len=args.max_len,
                 mode=args.pool_mode, num_rows=args.pool_rows,
                 row_words=args.row_words,
                 secded_rows=args.secded_rows if args.paid_frac else 0,
                 device=args.device)
    out = eng.serve(reqs)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}, indent=1))


if __name__ == "__main__":
    main()
