#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on the card.

Usage (from the repository root, on a machine with one NVIDIA GPU and the
CUDA toolkit)::

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits nonzero:

  1. build        nvcc builds the port's kernels from ``src/repro_torch/csrc``;
  2. kernels      each kernel against its plain PyTorch version on the card,
                  bit-exact, at the serving shapes (W=2048 words per lane, one
                  decode step's B·L·maxB pages), with seeded single- and
                  double-bit flips so every SECDED status occurs; median
                  times with CUDA events beside the plain version, the
                  memory/ALU bound and, where one PyTorch call computes the
                  same function, that call;
  3. reference    a small model served on the card and on the CPU from the
                  same weights: logits within 1e-4, identical tokens;
  4. serve-cream  CREAM-Serve on qwen3-0.6b (full width and depth, float32,
                  random weights from a seed) on an InterWrap CREAM pool;
                  exactly one mixed-read launch per decode step;
  5. profile      where a full-batch decode step's time goes on the card:
                  host-clock step time, then device kernel time by class
                  under torch.profiler, and the device's busy share;
  6. serve-secded the same requests on an all-SECDED pool sized so the
                  working set does not fit: identical tokens, fewer device
                  pages, preemptions, SECDED encode and decode launches, and
                  every SECDED row decodes clean afterwards;
  7. serve-repartition  phase 4 with a mid-decode protection upgrade
                  (boundary -> 0) through the migration engine: identical
                  tokens, pages migrated through the gather/re-encode kernel.

Then the card's name and power limit, one JSON line listing every kernel
with its launches on the serve phases and its phase-2 numbers, and, last,
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and cuDNN, so
float32 products are full float32.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BYTES_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_S = 67e12          # non-tensor 32-bit rate (data sheet fp32 peak)
W = 2048                   # words per lane per row: 64 KiB pages
B, MAX_LEN = 4, 128        # decode slots, tokens per sequence
NUM_ROWS = 1600            # fits 8 sessions in CREAM mode, not in SECDED
N_REQ, PROMPT, MAX_NEW = 8, 32, 32
PROFILE_STEPS = 8          # decode steps in the profiled window
SEED = 0
DEVICE = "cuda"

# kernel -> (source, TPU kernel it replaces)
KERNELS = {
    "secded_encode": ("src/repro_torch/csrc/secded.cu",
                      "src/repro/kernels/secded/kernel.py:127"),
    "secded_decode": ("src/repro_torch/csrc/secded.cu",
                      "src/repro/kernels/secded/kernel.py:142"),
    "mixed_read_correct": ("src/repro_torch/csrc/mixed.cu",
                           "src/repro/kernels/mixed/kernel.py:90"),
    "migrate_gather_encode": ("src/repro_torch/csrc/migrate.cu",
                              "src/repro/kernels/migrate/kernel.py:59"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-launch CUDA-event timings after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_mem, t_ops = nbytes / MEM_BYTES_S, ops / ALU_OPS_S
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def max_abs_err(a, b) -> int:
    import torch
    outs_a = a if isinstance(a, tuple) else (a,)
    outs_b = b if isinstance(b, tuple) else (b,)
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(outs_a, outs_b, strict=True))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def plant_flips(data, codes, rng, n_each: int):
    """Seeded single data-bit, single code-bit and same-beat double-bit
    flips in the rows of (data (N, D), codes (N, D/8)) -> flipped copies."""
    import numpy as np
    import torch
    d, c = data.clone(), codes.clone()
    n, dw = d.shape
    rows = rng.choice(n, size=3 * n_each, replace=False)
    dr = torch.as_tensor(rows[:n_each], device=d.device)
    cr = torch.as_tensor(rows[n_each:2 * n_each], device=d.device)
    xr = torch.as_tensor(rows[2 * n_each:], device=d.device)
    bit = lambda b: torch.as_tensor(  # noqa: E731
        (np.uint32(1) << b.astype(np.uint32)).view(np.int32), device=d.device)
    w = torch.as_tensor(rng.integers(0, dw, n_each), device=d.device)
    d[dr, w] ^= bit(rng.integers(0, 32, n_each))                 # status 1
    wc = torch.as_tensor(rng.integers(0, dw // 8, n_each), device=d.device)
    c[cr, wc] ^= bit(rng.integers(0, 32, n_each))                # status 2
    w2 = torch.as_tensor(rng.integers(0, dw, n_each), device=d.device)
    b0 = rng.integers(0, 16, n_each)
    d[xr, w2] ^= bit(b0) | bit(b0 + 16)                          # status 3
    return d, c


def phase_kernels(torch, np, dev) -> dict:
    from repro_torch.core import secded
    from repro_torch.core.layouts import (LANES, Layout, page_coords,
                                          total_pages)
    from repro_torch.kernels.migrate import ops as migrate_ops
    from repro_torch.kernels.migrate import ref as migrate_ref
    from repro_torch.kernels.mixed import ops as mixed_ops
    from repro_torch.kernels.mixed import ref as mixed_ref
    from repro_torch.kernels.secded import ops as secded_ops
    from repro_torch.kernels.secded import ref as secded_ref
    from repro_torch.models.transformer import num_attn_layers
    from repro_torch.configs.qwen3_0_6b import CONFIG

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    L = num_attn_layers(CONFIG)
    max_blocks = -(-MAX_LEN // (8 * W // (2 * CONFIG.num_kv_heads
                                          * CONFIG.head_dim_)))
    n = B * L * max_blocks                      # one decode step's gather
    D = 8 * W
    words = lambda *shape: torch.randint(  # noqa: E731
        -2**31, 2**31, shape, generator=gen, device=dev, dtype=torch.int32)
    out = {}

    # -- SECDED encode / decode over (n, 8W) page blocks ---------------------
    data = words(n, D)
    codes = secded_ref.encode(data)
    enc_k = secded_ops.encode(data)
    torch.cuda.synchronize()
    flipped, fcodes = plant_flips(data, codes, rng, n_each=max(1, n // 8))
    dec_k = secded_ops.decode(flipped, fcodes)
    dec_p = secded_ref.decode(flipped, fcodes)
    torch.cuda.synchronize()
    statuses = sorted(int(s) for s in torch.unique(dec_k[2]))
    check(statuses == [0, 1, 2, 3], f"decode statuses {statuses}")
    beats = n * D // 2
    out["secded_encode"] = dict(
        max_abs_err=max_abs_err(enc_k, codes),
        ms=median_ms(lambda: secded_ops.encode(data), 20),
        plain_ms=median_ms(lambda: secded_ref.encode(data), 3),
        library_ms=None,
        bound=bound_ms(4 * (n * D + n * D // 8), 40 * beats))
    out["secded_decode"] = dict(
        max_abs_err=max_abs_err(dec_k, dec_p),
        ms=median_ms(lambda: secded_ops.decode(flipped, fcodes), 20),
        plain_ms=median_ms(lambda: secded_ref.decode(flipped, fcodes), 3),
        library_ms=None, statuses=statuses,
        bound=bound_ms(4 * (2 * n * D + 2 * n * D // 8 + n * D // 2),
                       48 * beats))

    # -- mixed read: a mixed-boundary pool with flips, and the CREAM pool ----
    mixed_boundary = NUM_ROWS // 2
    sto = words(NUM_ROWS, LANES, W)
    sec = torch.arange(mixed_boundary, NUM_ROWS, device=dev)
    rows_data = sto[sec, :8, :].reshape(len(sec), D)
    rows_codes = secded.encode_block(rows_data)
    fd, fc = plant_flips(rows_data, rows_codes, rng, n_each=len(sec) // 8)
    sto[sec, :8, :] = fd.reshape(len(sec), 8, W)
    sto[sec, 8, :] = fc
    n_pages = total_pages(Layout.INTERWRAP, mixed_boundary, W) \
        + (NUM_ROWS - mixed_boundary)
    ids = torch.as_tensor(rng.integers(0, n_pages, n), dtype=torch.int32,
                          device=dev)
    mix_args = (sto, ids, Layout.INTERWRAP, NUM_ROWS, mixed_boundary)
    err_mixed = max_abs_err(mixed_ops.read_correct(*mix_args),
                            mixed_ref.read_correct(*mix_args))
    mixed_ms = median_ms(lambda: mixed_ops.read_correct(*mix_args), 20)
    n_sec = int(((ids >= mixed_boundary) & (ids < NUM_ROWS)).sum())

    cream = words(NUM_ROWS, LANES, W)
    cids = torch.as_tensor(rng.integers(
        0, total_pages(Layout.INTERWRAP, NUM_ROWS, W), n), dtype=torch.int32,
        device=dev)
    cream_args = (cream, cids, Layout.INTERWRAP, NUM_ROWS, NUM_ROWS)
    got = mixed_ops.read_correct(*cream_args)
    err_cream = max_abs_err(got, mixed_ref.read_correct(*cream_args))
    rows, lanes, _ = page_coords(Layout.INTERWRAP, NUM_ROWS, NUM_ROWS, cids,
                                 W)
    lib = lambda: cream[rows, lanes]  # noqa: E731  (yardstick, not the port)
    check(torch.equal(lib().reshape(n, D), got), "indexing yardstick differs")
    out["mixed_read_correct"] = dict(
        max_abs_err=max(err_mixed, err_cream),
        ms=median_ms(lambda: mixed_ops.read_correct(*cream_args), 20),
        plain_ms=median_ms(lambda: mixed_ref.read_correct(*cream_args), 3),
        library_ms=median_ms(lib, 20),
        bound=bound_ms(4 * (2 * n * D + n), 0),
        mixed_pool=dict(boundary=mixed_boundary, secded_pages=n_sec,
                        ms=mixed_ms, bound_ms=bound_ms(
                            4 * (2 * n * D + n + n_sec * W),
                            48 * n_sec * D // 2)[0]))

    # -- migrate gather/re-encode over the CREAM pool ------------------------
    mig_k = migrate_ops.gather_encode(cream, cids, NUM_ROWS)
    mig_p = migrate_ref.gather_encode(cream, cids, NUM_ROWS)
    out["migrate_gather_encode"] = dict(
        max_abs_err=max_abs_err(mig_k, mig_p),
        ms=median_ms(lambda: migrate_ops.gather_encode(cream, cids, NUM_ROWS),
                     20),
        plain_ms=median_ms(
            lambda: migrate_ref.gather_encode(cream, cids, NUM_ROWS), 3),
        library_ms=None,
        bound=bound_ms(4 * (2 * n * D + n * W + n), 40 * n * D // 2))
    for name, r in out.items():
        check(r["max_abs_err"] == 0, f"{name} disagrees with its plain version")
    return dict(n_pages=n, row_words=W, kernels=out)


# ---------------------------------------------------------------------------
# Phases 3-6: serving
# ---------------------------------------------------------------------------


def requests(np, vocab: int, n: int | None = None,
             prompt: int | None = None, max_new: int | None = None):
    """Seeded prompts (default: the serve phases' N_REQ x PROMPT tokens,
    MAX_NEW new tokens each)."""
    from repro_torch.serve import ServeRequest
    n, prompt = n or N_REQ, prompt or PROMPT
    max_new = max_new or MAX_NEW
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, vocab, size=prompt).astype(np.int32)
               for _ in range(n)]
    return [ServeRequest(f"s{i}", p, max_new) for i, p in enumerate(prompts)]


def phase_reference(torch, np) -> dict:
    """A small model on the card vs the CPU, same weights and requests."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve import Engine
    cfg = ModelConfig(name="serve-test", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=256, head_dim=16, dtype="float32")
    cpu = Engine(cfg, max_batch=4, max_len=32, num_rows=64, row_words=64,
                 device="cpu")
    gpu = Engine(cfg, max_batch=4, max_len=32, num_rows=64, row_words=64,
                 device=DEVICE)
    gpu.model.load_state_dict(cpu.model.state_dict())
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, 256, 12))
    lc, _ = cpu.model.prefill(toks[None])
    lg, _ = gpu.model.prefill(toks[None].to(DEVICE))
    err = float((lg.cpu() - lc).abs().max())
    check(err <= 1e-4, f"prefill logits differ by {err}")
    rc = requests(np, 256, n=6, prompt=12, max_new=8)
    rg = requests(np, 256, n=6, prompt=12, max_new=8)
    cpu.serve(rc)
    gpu.serve(rg)
    check([r.generated for r in rc] == [r.generated for r in rg],
          "card and CPU decode different tokens")
    return dict(max_abs_logit_err=err, tokens_equal=True)


def serve_phase(torch, np, mode: str, repartition: bool = False):
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.kernels import common
    from repro_torch.serve import Engine
    from repro_torch.vm.migration import MigrationEngine
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    eng = Engine(cfg, max_batch=B, max_len=MAX_LEN, mode=mode,
                 num_rows=NUM_ROWS, row_words=W, seed=SEED, device=DEVICE)
    reqs = requests(np, cfg.vocab_size)
    info = None
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    t0 = time.perf_counter()
    if not repartition:
        stats = eng.serve(reqs)
    else:
        mig = MigrationEngine(eng.vm)
        for r in reqs:
            eng.submit(r)
        done = []
        alloc = eng.vm.allocators[eng.pool_name]
        while eng.sched.has_work():
            done.extend(eng.poll())
            if info is None and any(p >= eng.pool.num_rows
                                    for p in alloc.owner):
                info = mig.repartition_with_migration(eng.pool_name, 0)
                eng.refresh_translation()
        stats = dict(decode_steps=eng.steps, requests=len(done),
                     **eng.sched.stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    tokens = [r.generated for r in reqs]
    check(all(len(t) == MAX_NEW for t in tokens), "requests unfinished")
    check(all(0 <= x < cfg.vocab_size for t in tokens for x in t),
          "token out of vocabulary")
    check(launches.get("mixed_read_correct", 0) == eng.steps,
          f"{launches.get('mixed_read_correct')} mixed reads for "
          f"{eng.steps} decode steps")
    return eng, tokens, stats, launches, info, wall


def _kernel_class(name: str) -> str:
    low = name.lower()
    for key, cls in (("mixed_read_correct", "mixed read"),
                     ("secded", "secded codec"),
                     ("migrate", "migrate"),
                     ("gemm", "matmul"), ("gemv", "matmul"),
                     ("cutlass", "matmul"), ("xmma", "matmul"),
                     ("index", "index/gather/scatter"),
                     ("gather", "index/gather/scatter"),
                     ("scatter", "index/gather/scatter"),
                     ("reduce", "reduction/softmax"),
                     ("softmax", "reduction/softmax"),
                     ("memcpy", "copy"), ("memset", "copy"),
                     ("copy", "copy")):
        if key in low:
            return cls
    return "elementwise/other"


def phase_profile(torch, np, eng) -> dict:
    """Where a decode step's time goes: PROFILE_STEPS decode steps of the
    CREAM engine with every slot busy, timed on the host clock without the
    profiler, then again under ``torch.profiler`` for device kernel time by
    kernel and by class, and the device's busy share of the window."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(SEED + 1)
    for i in range(B):
        eng.submit(ServeRequest(
            f"profile{i}",
            rng.integers(0, eng.cfg.vocab_size, PROMPT).astype(np.int32),
            2 * PROFILE_STEPS + 4))
    for _ in range(2):
        eng.poll()
    check(len(eng.sched.active_slots()) == B, "profile batch is not full")

    def window() -> float:
        torch.cuda.synchronize()
        steps, t0 = eng.steps, time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.poll()
        torch.cuda.synchronize()
        check(eng.steps - steps == PROFILE_STEPS, "a poll was not one step")
        return (time.perf_counter() - t0) * 1e3

    plain_ms = window()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = window()
    while eng.sched.has_work():
        eng.poll()
    by_name: Counter = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    out = dict(steps=PROFILE_STEPS, batch=B,
               step_ms=plain_ms / PROFILE_STEPS,
               profiled_step_ms=prof_ms / PROFILE_STEPS)
    if not by_name:
        return dict(out, device_time="not measured")
    by_class: Counter = Counter()
    for name, us in by_name.items():
        by_class[_kernel_class(name)] += us
    busy_us = sum(by_name.values())
    return dict(out, device_busy_share=busy_us / (prof_ms * 1e3),
                device_ms_per_step=busy_us / 1e3 / PROFILE_STEPS,
                ms_per_step_by_class={k: v / 1e3 / PROFILE_STEPS
                                      for k, v in by_class.most_common()},
                top_kernels_ms_per_step=[
                    (name[:96], us / 1e3 / PROFILE_STEPS)
                    for name, us in by_name.most_common(12)])


def summary(stats: dict, launches: dict, wall: float) -> dict:
    keep = ("tokens", "tokens_per_s", "p50_latency_ms", "p99_latency_ms",
            "decode_steps", "device_pages", "preemptions", "restores",
            "host_reads")
    return dict({k: stats[k] for k in keep if k in stats},
                wall_s=wall, launches=launches)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    common.library()
    log = (common.BUILD_DIR / "build.log").read_text() \
        if (common.BUILD_DIR / "build.log").exists() else ""
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              ptxas=[ln.strip() for ln in log.splitlines()
                     if "registers" in ln]))

    kern = phase_kernels(torch, np, dev)
    emit(dict(phase="kernels", **kern))
    emit(dict(phase="reference", **phase_reference(torch, np)))

    eng, tok_c, st_c, l_c, _, wall_c = serve_phase(torch, np, "cream")
    emit(dict(phase="serve-cream", **summary(st_c, l_c, wall_c)))
    emit(dict(phase="profile", **phase_profile(torch, np, eng)))
    del eng
    torch.cuda.empty_cache()

    eng, tok_s, st_s, l_s, _, wall_s = serve_phase(torch, np, "secded")
    check(tok_s == tok_c, "secded tokens differ from cream tokens")
    check(st_c["device_pages"] > st_s["device_pages"],
          "cream mode must offer more device pages")
    check(st_s["preemptions"] > 0, "secded pool should have preempted")
    check(l_s.get("secded_encode", 0) > 0, "no SECDED encode launched")
    check(l_s.get("secded_decode", 0) > 0, "no SECDED decode launched")
    from repro_torch.kernels.secded import ops as secded_ops
    pool = eng.pool
    _, _, status = secded_ops.decode(
        pool.storage[:, :8, :].reshape(pool.num_rows, -1).contiguous(),
        pool.storage[:, 8, :].contiguous())
    check(int(status.max()) == 0, "SECDED rows do not decode clean")
    emit(dict(phase="serve-secded", tokens_equal=True, rows_clean=True,
              **summary(st_s, l_s, wall_s)))
    del eng, pool
    torch.cuda.empty_cache()

    eng, tok_r, st_r, l_r, info, wall_r = serve_phase(torch, np, "cream",
                                                      repartition=True)
    check(info is not None and info["migrated"] > 0, "no page migrated")
    check(l_r.get("migrate_gather_encode", 0) > 0, "no gather_encode launch")
    check(tok_r == tok_c, "repartition changed the tokens")
    emit(dict(phase="serve-repartition", tokens_equal=True,
              repartition=info, **summary(st_r, l_r, wall_r)))
    del eng

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: " + smi.stderr.strip(), flush=True)
    line = []
    for name, (source, replaces) in KERNELS.items():
        r = kern["kernels"][name]
        bms, by = r["bound"]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(l.get(name, 0) for l in (l_c, l_s, l_r)),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=bms, bound_by=by, library_ms=r["library_ms"]))
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
