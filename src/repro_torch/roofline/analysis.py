"""Roofline analysis: three terms per (arch × shape × mesh) from dry-run JSONs.

Port of ``repro/roofline/analysis.py``, over an H100's rates
(:mod:`repro_torch.launch.mesh`) unless others are passed:

    compute    = FLOPs / 1070.5 TFLOP/s bf16
    memory     = bytes / 3.35 TB/s
    collective = collective_wire_bytes / 50 GB/s per GPU

All numerators are per device (:mod:`repro_torch.launch.dryrun` counts one
rank's shards), so the denominators are one card's rates. MODEL_FLOPS =
6·N_active·D for a train step (2·N_active·D for prefill and decode) checks
how much counted compute is useful. A record of the card alone (mesh
``card``, one chip, no collective) comes from ``chip_smoke.py``'s
``roofline`` phase.

Usage: PYTHONPATH=src python -m repro_torch.roofline.analysis [--dir experiments/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass

from repro_torch.launch.mesh import HBM_BW, NET_BW_PER_GPU, PEAK_FLOPS_BF16

CHIPS = {"pod16x16": 256, "pod2x16x16": 512, "card": 1}
#: one H100's rates: (FLOP/s, HBM bytes/s, network bytes/s)
H100 = (PEAK_FLOPS_BF16, HBM_BW, NET_BW_PER_GPU)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    kind: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_dev: float
    hlo_flops_per_dev: float
    bound: str
    step_s: float              # max of the three (no-overlap bound)
    roofline_frac: float       # ideal (MODEL_FLOPS) time / step_s
    useful_ratio: float        # MODEL_FLOPS / counted FLOPs

    def row(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:10s} "
                f"{self.compute_s:9.2e} {self.memory_s:9.2e} "
                f"{self.collective_s:9.2e} {self.bound:10s} "
                f"{self.roofline_frac:5.2f} {self.useful_ratio:5.2f}")


def model_flops_for(arch: str, shape_name: str, kind: str,
                    global_batch: int, seq_len: int) -> float:
    """Total MODEL_FLOPS for the step (all devices together)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import count_params
    cfg = get_config(arch)
    n_active = count_params(cfg, active_only=True)
    if kind == "train":
        tokens = global_batch * seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = global_batch * seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * global_batch


def analyze_record(rec: dict, rates: tuple = H100) -> Roofline | None:
    """The record's three terms over ``rates`` = (FLOP/s, memory bytes/s,
    collective bytes/s), per chip."""
    if not rec.get("ok"):
        return None
    peak_flops, mem_bw, net_bw = rates
    chips = CHIPS[rec["mesh"]] if rec["mesh"] in CHIPS else rec["chips"]
    flops = rec.get("hlo_flops_scaled", rec.get("hlo_flops", 0.0))
    mem_bytes = rec.get("hlo_bytes_scaled", rec.get("hlo_bytes", 0.0))
    coll_bytes = rec.get("collective_wire_bytes_scaled",
                         rec.get("collectives", {}).get("wire_bytes", 0))

    compute_s = flops / peak_flops
    memory_s = mem_bytes / mem_bw
    collective_s = coll_bytes / net_bw

    if "global_batch" in rec:       # a step of its own (the card's)
        b, s = rec["global_batch"], rec["seq_len"]
    else:
        from repro_torch.configs import SHAPES
        b, s = SHAPES[rec["shape"]].global_batch, SHAPES[rec["shape"]].seq_len
    mf_total = model_flops_for(rec["arch"], rec["shape"], rec["kind"], b, s)
    mf_dev = mf_total / chips

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    step_s = max(terms.values())
    ideal_s = mf_dev / peak_flops
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        kind=rec["kind"], compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, model_flops_per_dev=mf_dev,
        hlo_flops_per_dev=flops, bound=bound, step_s=step_s,
        roofline_frac=ideal_s / step_s if step_s else 0.0,
        useful_ratio=mf_dev / flops if flops else 0.0)


def load_all(directory: str, rates: tuple = H100) -> list[Roofline]:
    out = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            r = analyze_record(json.load(fh), rates)
        if r is not None:
            out.append(r)
    return out


def print_table(rows: list[Roofline]) -> None:
    print(f"{'arch':22s} {'shape':12s} {'mesh':10s} {'compute_s':>9s} "
          f"{'memory_s':>9s} {'collect_s':>9s} {'bound':10s} "
          f"{'rfrac':>5s} {'usefl':>5s}")
    for r in rows:
        print(r.row())


def interesting_cells(rows: list[Roofline]) -> dict[str, Roofline]:
    """The three hillclimb candidates."""
    single = [r for r in rows if r.mesh == "pod16x16"]
    worst = min(single, key=lambda r: r.roofline_frac)
    coll = max(single, key=lambda r: (r.collective_s /
                                      max(r.step_s, 1e-30)))
    # most CREAM-representative: the serving-decode cell of the largest
    # KV-capacity-sensitive arch (decode = where pool capacity bites)
    decode = [r for r in single if r.kind == "decode"]
    rep = max(decode, key=lambda r: r.model_flops_per_dev)
    return {"worst_roofline": worst, "most_collective_bound": coll,
            "most_representative": rep}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--json-out", default="experiments/roofline.json")
    args = ap.parse_args(argv)
    rows = load_all(args.dir)
    print_table(rows)
    picks = interesting_cells(rows)
    print("\nHillclimb candidates:")
    for why, r in picks.items():
        print(f"  {why:24s} -> {r.arch} x {r.shape} ({r.bound}-bound, "
              f"frac={r.roofline_frac:.3f})")
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump({"cells": [r.__dict__ for r in rows],
                   "picks": {k: v.__dict__ for k, v in picks.items()}},
                  f, indent=1)


if __name__ == "__main__":
    main()
