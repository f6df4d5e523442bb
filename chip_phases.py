#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on the card.

Usage (from the repository root, on a machine with one NVIDIA GPU)::

    python3 chip_phases.py PHASE [PHASE ...] [--root DIR]

Builds the kernels and turns TF32 off as ``chip_smoke.main`` does, then
runs each named phase and prints its JSON line, and last the card's name
and power limit. Phases: ``serve-olmoe``, ``olmoe-reference``,
``decode-xlstm``, ``families-smoke``, ``surface``, ``widths``,
``steps``: the serve requests on qwen3-0.6b and on starcoder2-7b in
cream mode, each with a full-batch decode profile over 32 steps
(host-clock step, device time, launches),
``roofline``: the serve requests on qwen3-0.6b and on olmoe-1b-7b in
cream mode, each with a counted full-batch decode profile, then
``chip_smoke.py``'s roofline phase on them, and ``mesh``: CREAM-Shard's
banks across min(cards, 4) ranks, and with 4 the data-parallel training
(run it on a machine with four cards: ``python3 chip_phases.py mesh``).

``--root`` takes the phases from another checkout's ``chip_smoke.py``
and package (its kernels build under its own ``build/``). To compare two
commits on one card, unpack one under ``build/`` (``git archive``) and
run ``steps`` from each in turns in one call::

    for r in build/parent . . build/parent; do
        python3 chip_phases.py steps --root $r; done
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import time
from pathlib import Path


STEP_WINDOW = 32           # decode steps in each timed window of ``steps``


def steps(cs, torch, np) -> dict:
    """qwen3-0.6b and starcoder2-7b served in cream mode, then a
    full-batch decode profile of each engine over STEP_WINDOW steps."""
    from repro_torch.configs import get_config
    cs.PROFILE_STEPS = STEP_WINDOW
    out = {}
    eng, _, stats, launches, _, _ = cs.serve_phase(torch, np, "cream")
    prof = cs.decode_profile(torch, np, eng)
    out["qwen3-0.6b"] = dict(tokens_per_s=stats["tokens_per_s"],
                             step_ms=prof["step_ms"],
                             device_ms=prof.get("device_ms"),
                             launches=launches)
    del eng
    torch.cuda.empty_cache()
    rows = cs.kv_rows(torch, get_config("starcoder2-7b"))
    eng, _, stats, launches, _ = cs.serve_full_width(
        torch, np, "starcoder2-7b", "cream", rows)
    prof = cs.decode_profile(torch, np, eng)
    out["starcoder2-7b"] = dict(tokens_per_s=stats["tokens_per_s"],
                                step_ms=prof["step_ms"],
                                device_ms=prof.get("device_ms"),
                                launches=launches)
    return out


def roofline(cs, torch, np) -> dict:
    """The roofline phase, its decode steps from fresh cream engines of
    qwen3-0.6b and olmoe-1b-7b."""
    from repro_torch.configs import get_config
    eng = cs.serve_phase(torch, np, "cream")[0]
    qwen = cs.decode_profile(torch, np, eng, count=True)
    del eng
    torch.cuda.empty_cache()
    rows = cs.resident_rows(torch, get_config(cs.OLMOE))
    eng = cs.serve_full_width(torch, np, cs.OLMOE, "cream", rows)[0]
    olmoe = cs.decode_profile(torch, np, eng, count=True)
    del eng
    torch.cuda.empty_cache()
    return cs.phase_roofline(torch, np, qwen, olmoe)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    cs = importlib.import_module("chip_smoke")
    from repro_torch.kernels import common
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    common.library()
    rate = cs.int_rate(torch)            # the bounds' rates, as main sets
    cs.INT_OPS_S, cs.FP32_FLOPS_S = rate["int_ops_s"], rate["fp32_flops_s"]
    cs.BF16_FLOPS_S = rate["bf16_flops_s"]
    cs.emit(dict(phase="build", root=str(root),
                 seconds=time.perf_counter() - t0))
    for name in args.phases:
        if name in ("steps", "roofline"):
            out = {"steps": steps, "roofline": roofline}[name](cs, torch, np)
        else:
            out = getattr(cs, "phase_" + name.replace("-", "_"))(torch, np)
        result = out[0] if isinstance(out, tuple) else out
        cs.emit(dict(phase=name, root=str(root),
                     elapsed_s=time.perf_counter() - t0, **result))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
