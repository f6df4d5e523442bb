"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke]``.

Port of ``repro/launch/train.py``, with the same flags, defaults and
printed lines, plus ``--device`` (default ``cuda``; ``--device cpu`` runs
the plain versions of the kernels on the CPU). ``--smoke`` selects the
reduced same-family config. ``--production-mesh`` lays the (data=16,
model=16) mesh (with ``--multi-pod`` the (pod=2, data=16, model=16) one)
over the process group and trains under it, as the reference does: on one
process it raises the mesh's world-size error. A multi-rank host mesh
(the reference's default on several devices) is not built here.
"""
from __future__ import annotations

import argparse

import contextlib

from repro_torch.configs import TrainConfig, get_config
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch.mesh import make_production_mesh
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

    mesh = make_production_mesh(multi_pod=args.multi_pod) \
        if args.production_mesh else None
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
        if args.ckpt_dir and tr.restore():
            print(f"resumed at step {tr.step}")
        log = tr.run(args.steps)
    print(f"{cfg.name}: loss {log[0]['loss']:.4f} -> "
          f"{log[-1]['loss']:.4f} over {args.steps} steps")
    return tr


if __name__ == "__main__":
    main()
