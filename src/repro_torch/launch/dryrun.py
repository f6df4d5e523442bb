"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on a fake mesh.

Port of ``repro/launch/dryrun.py``. It shows the distribution config is
coherent without the hardware: :func:`main` first starts a fake process
group of 512 ranks in this process (``torch.distributed``'s ``fake``
backend: collectives do nothing and cost nothing), as the reference first
forces 512 host devices; the production mesh is laid over it, every input
is a DTensor over a ``meta`` shard (nothing allocated), and the cell's
step runs once under :class:`repro_torch.roofline.hlo_parse.CostCounter`,
eagerly, with einsum attention (``attn_impl="xla"``; the reference's
dry-run avoids custom calls too). Tensors the model makes itself count as
replicated (``implicit_replication``). A cell passes if its step runs; its
per-device FLOPs, bytes and collective traffic go to ``<out>/<cell>.json``
for :mod:`repro_torch.roofline.analysis`. A failing cell is recorded with
its error and traceback, and the sweep goes on.

The process group belongs to the whole process: run the dry-run in a
process of its own (the tests and ``chip_smoke.py`` start it as one).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      --mesh single --out experiments/dryrun
  python -m repro_torch.launch.dryrun --all --mesh both --cell-timeout 1500
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import signal
import time
import traceback

import torch

from repro_torch.configs import (SHAPES, InputShape, ModelConfig,
                                 TrainConfig, get_config, iter_cells,
                                 shape_applicable)
from repro_torch.distributed.sharding import (P, tree_map, tree_paths,
                                              use_mesh)
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import _make_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.roofline.hlo_parse import CostCounter

#: axis names of a mesh of 1, 2 or 3 dims (the production meshes' order)
_AXES = {1: ("model",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def start_fake_world(world_size: int) -> None:
    """Start a fake process group of ``world_size`` ranks in this process,
    as rank 0; a larger one already started is kept."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is already "
                               f"running; {world_size} are needed")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def mesh_name(shape: tuple[int, ...]) -> str:
    """``pod16x16`` / ``pod2x16x16`` for the production meshes, as the
    reference names them; ``mesh2x4`` for another."""
    if shape in ((16, 16), (2, 16, 16)):
        return "pod" + "x".join(map(str, shape))
    return "mesh" + "x".join(map(str, shape))


def make_mesh(shape: tuple[int, ...]):
    """The production mesh of ``shape``, or a smaller one of the same
    axes (tests)."""
    if shape in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(shape) == 3)
    return _make_mesh(tuple(shape), _AXES[len(shape)])


def _make_args(specs):
    """The DTensor arguments of a step from its specs."""
    from repro_torch.optim.adamw import AdamWState
    out = []
    for s in specs:
        if isinstance(s, AdamWState):
            out.append(AdamWState(step=s.step.make(), m=sh.make_tree(s.m),
                                  v=sh.make_tree(s.v)))
        else:
            out.append(sh.make_tree(s))
    return tuple(out)


def _step_and_specs(cfg: ModelConfig, shape: InputShape, mesh, *,
                    remat: str = "block", grad_compression: str = "none",
                    logits_last: bool = True):
    """Returns (fn, arg_specs tuple) for the cell's step kind."""
    if shape.kind == "train":
        tcfg = TrainConfig(remat=remat, grad_compression=grad_compression,
                           microbatch=None)
        from repro_torch.train.train_step import make_train_step
        fn = make_train_step(cfg, tcfg)
        p = sh.param_specs(cfg, mesh)
        o = sh.opt_specs(p, mesh)
        b = sh.batch_specs(cfg, shape, mesh, with_labels=True)
        return fn, (p, o, b)
    if shape.kind == "prefill":
        def fn(params, tokens):
            return transformer.forward(
                params, cfg, tokens, remat=remat,
                logits_mode="last" if logits_last else "all")
        p = sh.param_specs(cfg, mesh)
        b = sh.batch_specs(cfg, shape, mesh, with_labels=False)
        return fn, (p, b["tokens"])
    if shape.kind == "decode":
        def fn(params, state, tokens):
            return transformer.decode_step(params, cfg, state, tokens)
        p = sh.param_specs(cfg, mesh)
        st = sh.decode_state_specs(cfg, shape, mesh)
        tok = sh.decode_token_spec(shape, mesh)
        return fn, (p, st, tok)
    raise ValueError(shape.kind)


def _count(fn, *args) -> tuple[CostCounter, object]:
    """Run ``fn(*args)`` once under a :class:`CostCounter`, model-made
    tensors replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), CostCounter() as counter:
        out = fn(*args)
    return counter, out


def stage_cost_probe(cfg: ModelConfig, shape: InputShape, mesh, *,
                     remat: str = "block") -> dict:
    """Trace one stage alone for its per-stage cost.

    The reference needs it because XLA counts a scan body once; the port's
    eager loop counts every stage, so here it only checks that a step's
    count is ``num_stages`` stages plus embedding and head. For train the
    probe differentiates through the stage (fwd + bwd + remat); for
    prefill it's the forward; for decode the decode stage.
    """
    b, s = shape.global_batch, shape.seq_len
    dt = cfg.activation_dtype

    def stage0(specs):
        """Stage 0's slice of stacked specs, cut as the step cuts it."""
        return transformer._unstack(sh.make_tree(specs), cfg.num_stages)[0]

    sp = stage0(sh.param_specs(cfg, mesh)["stages"])

    def xspec(seq, dtype=dt):
        # placed as the step places a stage's input: batch over 'data'
        return sh.ShapeDtypeStruct(
            (b, seq, cfg.d_model), dtype,
            sh.shard(mesh, P("data", None, None), (b, seq, cfg.d_model))
        ).make()

    if shape.kind == "train":
        def stage(x, spar):
            return transformer._stage(cfg, "xla", x, spar)

        def fn(spar, x, cot):
            spar = tree_map(lambda p: p.detach().requires_grad_(True), spar)
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                if remat in ("block", "full"):
                    y, aux = torch.utils.checkpoint.checkpoint(
                        stage, x, spar, use_reentrant=False)
                else:
                    y, aux = stage(x, spar)
                loss = torch.sum(y.float() * cot)
                if aux is not None:
                    loss = loss + aux
                leaves = list(tree_paths(spar).values())
                return loss, torch.autograd.grad(loss, leaves + [x])
        args = (sp, xspec(s), xspec(s, torch.float32))
    elif shape.kind == "prefill":
        def fn(spar, x):
            return transformer._stage(cfg, "xla", x, spar)[0]
        args = (sp, xspec(s))
    else:  # decode
        st_full = sh.decode_state_specs(cfg, shape, mesh)
        st = stage0({k: v for k, v in st_full.items() if k != "cache_len"})

        def fn(spar, stg, x, clen_):
            return transformer.decode_stage(cfg, spar, stg, x, clen_)
        args = (sp, st, xspec(1), st_full["cache_len"].make())

    with torch.no_grad():
        counter, _ = _count(fn, *args)
    return dict(counter.as_dict(), num_stages=cfg.num_stages)


def _local_bytes(tree) -> int:
    """Bytes one rank holds of the tensors in ``tree`` (dicts, lists,
    tuples, an AdamWState)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return sum(_local_bytes(getattr(tree, f))
                   for f in tree.__dataclass_fields__)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


@contextlib.contextmanager
def _deadline(seconds: int):
    """Raise TimeoutError in the main thread after ``seconds`` (0: never).
    DTensor's sharding propagation over a 3-D mesh can take hours on one
    operation; a cell that runs out of time is recorded as failing."""
    if not seconds:
        yield
        return

    def fire(*_):
        raise TimeoutError(f"the cell was not traced within {seconds} s")
    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def run_cell(cfg: ModelConfig, shape: InputShape, multi_pod: bool,
             out_dir: str | None = None, mesh_shape: tuple | None = None,
             timeout_s: int = 0, **step_kw) -> dict:
    """Trace one cell and record it (``mesh_shape`` overrides the
    production mesh, for tests; ``timeout_s`` bounds the cell)."""
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod
                                      else (16, 16)))
    mname = mesh_name(mesh_shape)
    cell = f"{cfg.name}__{shape.name}__{mname}"
    rec: dict = {"arch": cfg.name, "shape": shape.name, "mesh": mname,
                 "kind": shape.kind, "chips": math.prod(mesh_shape),
                 "ok": False}
    t0 = time.perf_counter()
    try:
        with _deadline(timeout_s):
            mesh = make_mesh(mesh_shape)
            with use_mesh(mesh):
                fn, specs = _step_and_specs(cfg, shape, mesh, **step_kw)
                args = _make_args(specs)
                rec["lower_s"] = time.perf_counter() - t0
                t1 = time.perf_counter()
                grad = torch.enable_grad() if shape.kind == "train" \
                    else torch.no_grad()
                with grad:
                    counter, out = _count(fn, *args)
                rec["compile_s"] = time.perf_counter() - t1
                rec["argument_size_in_bytes"] = _local_bytes(args)
                rec["output_size_in_bytes"] = _local_bytes(out)
                rec["hlo_flops"] = float(counter.flops)
                rec["hlo_bytes"] = float(counter.bytes)
                rec["collectives"] = counter.collectives.as_dict()
                rec["stage"] = stage_cost_probe(
                    cfg, shape, mesh, remat=step_kw.get("remat", "block"))
        # the eager loop over stages counts every stage: nothing to scale
        rec["hlo_flops_scaled"] = rec["hlo_flops"]
        rec["hlo_bytes_scaled"] = rec["hlo_bytes"]
        rec["collective_wire_bytes_scaled"] = float(
            rec["collectives"]["wire_bytes"])
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.perf_counter() - t0

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, cell + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    status = "OK " if rec["ok"] else "FAIL"
    print(f"[{status}] {cell}  lower={rec.get('lower_s', 0):.1f}s "
          f"compile={rec.get('compile_s', 0):.1f}s "
          f"flops={rec.get('hlo_flops', 0):.3e} "
          f"coll={rec.get('collectives', {}).get('wire_bytes', 0):.3e}B"
          + ("" if rec["ok"] else f"  err={rec.get('error')}"), flush=True)
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="sweep every applicable (arch x shape)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--remat", default="block")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--cell-timeout", type=int, default=0,
                    help="seconds a cell may take before it is recorded as "
                         "failing (0: no limit)")
    args = ap.parse_args(argv)

    shapes = {"single": [(16, 16)], "multi": [(2, 16, 16)],
              "both": [(16, 16), (2, 16, 16)]}[args.mesh]
    # first of all, as the reference's XLA_FLAGS line: the ranks
    start_fake_world(max(math.prod(s) for s in shapes))

    cells: list[tuple[ModelConfig, InputShape]] = []
    if args.all:
        cells = list(iter_cells())
    else:
        cfg = get_config(args.arch)
        shp = SHAPES[args.shape]
        if not shape_applicable(cfg, shp):
            print(f"[SKIP] {cfg.name} x {shp.name}: full-attention arch, "
                  f"long-context cell skipped per DESIGN.md §4")
            return
        cells = [(cfg, shp)]

    failures = 0
    for cfg, shp in cells:
        for ms in shapes:
            rec = run_cell(cfg, shp, len(ms) == 3, out_dir=args.out,
                           mesh_shape=ms, timeout_s=args.cell_timeout,
                           remat=args.remat,
                           grad_compression=args.grad_compression)
            failures += 0 if rec["ok"] else 1
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
