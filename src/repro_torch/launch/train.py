"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke]``.

Port of ``repro/launch/train.py``, with the same flags, defaults and
printed lines, plus ``--device`` (default ``cuda``; ``--device cpu`` runs
the plain versions of the kernels on the CPU). ``--smoke`` selects the
reduced same-family config.

Started by ``torch.distributed.run`` with several ranks (``python -m
torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train
--arch qwen3-0.6b``), each rank joins the process group (NCCL on its own
card, gloo with ``--device cpu``), and the launcher trains under the host
mesh ``(data=n, model=1)`` as the reference does whenever it sees several
devices: data-parallel, each rank taking its rows of the global batch and
the gradients averaged over the ranks; rank 0 writes the checkpoints and
prints each line once. A rank that fails makes ``torch.distributed.run``
exit nonzero. ``--production-mesh`` lays the (data=16, model=16) mesh
(with ``--multi-pod`` the (pod=2, data=16, model=16) one) over the process
group and trains under it: with fewer ranks it raises the mesh's
world-size error.
"""
from __future__ import annotations

import argparse
import contextlib
import os

from repro_torch.configs import TrainConfig, get_config
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     start_process_group)
from repro_torch.train.trainer import Trainer, make_trainer


def main(argv: list[str] | None = None) -> Trainer:
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print the two
    lines, and return the trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the (data=16, model=16) pod mesh (256 ranks)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    # a caller that started the group (a harness) keeps it
    own_group = ranks > 1 and not dist.is_initialized()
    if own_group:
        start_process_group(args.device)
    try:
        return _train(args, ranks)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, ranks: int) -> Trainer:
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    else:
        mesh = make_host_mesh() if ranks > 1 else None
    lead = ranks == 1 or int(os.environ["RANK"]) == 0
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    tcfg = TrainConfig(total_steps=max(args.steps, 100),
                       microbatch=args.microbatch,
                       grad_compression=args.grad_compression,
                       scrub_every=10, checkpoint_every=max(args.steps // 2, 1))
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        tr = make_trainer(cfg, tcfg, ckpt_dir=args.ckpt_dir,
                          seq_len=args.seq_len,
                          global_batch=args.global_batch, device=args.device)
        if args.ckpt_dir and tr.restore() and lead:
            print(f"resumed at step {tr.step}", flush=True)
        log = tr.run(args.steps)
    if lead:
        print(f"{cfg.name}: loss {log[0]['loss']:.4f} -> "
              f"{log[-1]['loss']:.4f} over {args.steps} steps", flush=True)
    return tr


if __name__ == "__main__":
    main()
