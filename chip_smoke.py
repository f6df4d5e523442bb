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
                  double-bit flips so every SECDED status occurs; the DAEC
                  kernels also at the campaign-daec tier (512 rows), with
                  planted singles, adjacent and same-codeword doubles and
                  the expected status count of each; median times with
                  CUDA events beside the plain version, the bound (bytes
                  over 3.35 TB/s, or integer ops over the card's int32
                  rate: SMs × 64 × max SM clock, read from the card) and,
                  where one PyTorch call computes the same function, that
                  call;
  3. reference    a small model served on the card and on the CPU from the
                  same weights: logits within 1e-4, identical tokens;
  4. serve-cream  CREAM-Serve on qwen3-0.6b (full width and depth, float32,
                  random weights from a seed) on an InterWrap CREAM pool;
                  exactly one mixed-read launch per decode step;
  5. profile      where a full-batch decode step's time goes on the card:
                  host-clock step time, then device kernel time by class
                  under torch.profiler, and the device's busy share; then
                  two schedule_migration calls of 64 pages on this local
                  pool, each beside one step, read back intact, the second
                  traced: the side stream's busy time, the part of it
                  concurrent with model-stream kernels, and the part
                  inside the model stream's span;
  6. serve-secded the same requests on an all-SECDED pool sized so the
                  working set does not fit: identical tokens, fewer device
                  pages, preemptions, SECDED encode and decode launches, and
                  every SECDED row decodes clean afterwards;
  7. serve-repartition  phase 4 with a mid-decode protection upgrade
                  (boundary -> 0) through the migration engine: identical
                  tokens, pages migrated through the gather/re-encode kernel;
  8. cache-reference  CREAM-Cache at 16 rows of W=64 on the card and on the
                  CPU, the same seeded trace and one policy step on each of
                  the three protection configurations: identical values,
                  stats and storage;
  9. cache-zipf   CREAM-Cache at R=16384 rows of W=2048 (64 KiB values,
                  1.125 GiB of storage) on the configurations of
                  benchmarks/bench_objcache.py (all-SECDED baseline, PARITY,
                  correction-free InterWrap) over a zipfian trace: every hit
                  verified, device pages and hit rates ordered, one
                  hash_lookup_read launch per get, parity8 launches only on
                  the PARITY pool;
 10. cache-websearch  the same over the WebSearch hot/cold trace;
 11. cache-demotion  the baseline for half the trace, a live move to
                  correction-free, every value intact, then the second half;
 12. cache-adapt  a filled PARITY pool at boundary R/2 with planted flips in
                  frames that hold no value: VMPolicy.step scrubs (scrub and
                  parity8 check kernels), counts exactly the planted flips
                  and upgrades the pool to all-SECDED with every value intact;
 13. cache-profile  one full-batch get and set: host-clock time, device
                  kernel time by class under torch.profiler, the device
                  operations each ran, busy share, and the port's launches
                  (a set is one parity8_write, no standalone encode);
 14. campaign-serve  the serve phases' requests (two on the paid tier, six
                  on batch) on a pool with a quarter of its rows CREAM,
                  under memcached-FIT single-bit injection with the tenant
                  SLO armed (FaultCampaign, one tick per poll, a scrub
                  every third): SECDED never silent nor detected, NONE
                  silent, serve/batch escalated with zero loss, the paid
                  tokens equal to serve-cream's, every gather seen by the
                  shadow oracle;
 15. campaign-daec  a tenant's 512 SECDED pages under adjacent-double
                  upsets: the SLO escalates to DAEC by carving a 512-row
                  tier, zero silent reads in every class, no DAEC read
                  detected; then planted singles and adjacent doubles in
                  the tier are scrubbed, 2 beats per superbeat, as the
                  plain version on the CPU does on the same rows, and the
                  payload reads back unchanged;
 16. prefill-long  qwen3-0.6b (full width and depth, float32) prefills one
                  seeded 8192-token prompt through the flash-attention
                  kernel (build_model(cfg, attn_impl="flash")) and through
                  the plain einsum attention with the same weights: last-
                  position logits within 1e-3 relative, exactly one flash
                  launch per layer, then the same greedy token and 16 dense
                  decode_step tokens on both paths; seconds, tokens/s and
                  peak memory of each;
 17. seqcache     nine sessions, each a seeded 1024-token prompt prefilled
                  through flash, packed (max_len 1088: ~250 MB, 3809 pages
                  of 64 KiB) and parked in a SequenceCache whose pool has 8
                  sessions' pages of rows, then three turns of resume_many,
                  16 dense decode tokens each and park again; on an
                  all-InterWrap pool (cream: 9 sessions fit, every resume a
                  device hit, page traffic through the InterWrap kernels) and
                  an all-SECDED one (secded: 8 fit, the cyclic turns thrash
                  one through the host): tokens equal across modes and equal
                  to an uninterrupted 48-token decode of each session.
 18. ecc-mlp      ecc_matmul's own path: one qwen3-0.6b SwiGLU MLP with
                  SECDED-protected bf16 weights over a 4096-token prefill
                  and the 4-token decode batch (6 launches), each product
                  within 1e-5 of its scale against the plain version;
 19. shard-reference  one seeded sequence on a CREAM-Shard pool of 4 banks
                  (64 global rows, W 64) on the card and on the CPU: writes
                  with duplicate ids, routed and status reads, a 4-D
                  injection, a migration across banks, repartition down and
                  up, a carved DAEC tier and a scrub: identical storage,
                  reads, statuses, censuses and evicted ids;
 20. serve-shard  the serve phases' requests on a pool added with shards=4
                  (1600 global rows in 4 banks, InterWrap, boundary 1280,
                  1760 pages): tokens equal to serve-cream's, each step's
                  gather one mixed_read_correct_routed launch, and three
                  times a schedule_migration of 64 pages across banks
                  beside one step on a second stream, read back intact:
                  a warm-up, one timed against the median step, one
                  traced as in phase 5.

Phase 2 also holds parity8_write, the PARITY pool's one-pass write,
bit-exact against its plain version and against the eager chain it
replaced (page_coords scatter, id upload, gather, standalone encode,
parity scatter) on a half-CREAM PARITY pool of CACHE_ROWS rows, at the
set batch (CREAM, SECDED and extra ids) and at a sweep of the R/2 CREAM
pages: its time beside the chain's, a one-element fill's (the launch
floor) and its byte bound, and the device operations one write makes
under torch.profiler, fused and chained. No main-path phase may launch
the standalone parity8_encode.

Phase 2 also holds the InterWrap gather / scatter bit-exact against their
plain versions on every page id (extras included) of the serve pool and of
a seqcache pool, and flash attention within 2e-5 of the output's scale at
the prefill shape (and on a ragged S, in float32 and bfloat16); their
bounds are bytes over 3.35 TB/s and, for flash attention, its flops over
the card's float32 FMA rate (SMs x 128 x 2 x max SM clock). It holds the
router-fused mixed read bit-exact on every page id of the serve-shard
pool and of a 16384-row pool in 8 banks, with planted flips; and
ecc_matmul at qwen3-0.6b's MLP shapes over 4096 tokens and 4, a ragged
shape, the decode threshold and the reference sweep's, with single
data-bit flips in a seeded 1 % of the weight beats and some code-bit
flips: equal to the clean product and within 1e-5 of scale, then with
uncorrectable doubles added within 1e-5 of scale; both designs timed
(the tensor-core tiled product, whose SASS must hold HGMMA, and the
decode pass up to N = 16), its bound the larger of bytes over 3.35 TB/s
and flops over the card's dense bf16 tensor rate (SMs x 4096 x max SM
clock), torch.matmul of the clean A beside it.

Then the card's name and power limit, one JSON line listing every kernel
with its launches on the serve, serve-shard, cache, campaign,
prefill-long, seqcache and ecc-mlp phases and its phase-2 numbers,
and, last,
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and cuDNN, so
float32 products are full float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BYTES_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
#: int32 lanes an SM issues per clock on Hopper (64; __popc at 16 is not
#: counted apart). main() sets INT_OPS_S = SMs x 64 x the SM's max clock,
#: read from the card, and the ALU side of every bound uses it.
INT_LANES_PER_SM = 64
INT_OPS_S = None
#: float32 FMA lanes an SM issues per clock on Hopper (128, 2 flops each);
#: main() sets FP32_FLOPS_S = SMs x 128 x 2 x the SM's max clock
FP32_LANES_PER_SM = 128
FP32_FLOPS_S = None
#: integer-pipe instructions per 128-bit superbeat of the DAEC kernels,
#: counted by main() in the SASS of this build (see sass_loop_ops)
DAEC_OPS: dict = {}
W = 2048                   # words per lane per row: 64 KiB pages
B, MAX_LEN = 4, 128        # decode slots, tokens per sequence
NUM_ROWS = 1600            # fits 8 sessions in CREAM mode, not in SECDED
N_REQ, PROMPT, MAX_NEW = 8, 32, 32
PROFILE_STEPS = 8          # decode steps in the profiled window
SEED = 0
DEVICE = "cuda"
CACHE_ROWS = 16384         # 1.125 GiB of pool storage at W = 2048
CACHE_ACCESSES = 131072    # per configuration and trace
GET_BATCH, SET_BATCH = 512, 128
CACHE_PROBE = 16
ADAPT_FLIPS = 8            # single-bit flips planted in free SECDED rows
DAEC_PAGES = 512           # campaign-daec payload (32 MiB), its tier's rows
DAEC_PLANTS = 4            # singles and adjacent doubles of the final scrub
#: benchmarks/cache_sim.py's fault-penalty model (µs per miss / per hit)
FAULT_PENALTY_US, HIT_COST_US = 500.0, 0.1
SLEEP_CYCLES = 2_000_000   # ~1 ms of device sleep ahead of each timed call
LONG_PROMPT = 8192         # prefill-long: one prompt, B = 1
DECODE_NEW = 16            # dense decode tokens after a prefill / per turn
SESSIONS, SESSION_PROMPT, TURNS = 9, 1024, 3
SESSION_MAX_LEN = SESSION_PROMPT + TURNS * DECODE_NEW + 16      # 1088
SHARDS, SHARD_BOUNDARY = 4, 1280       # serve-shard: 4 banks of 400 rows
MIG_PAGES, MIG_AT_STEP = 64, 8         # a scheduled migration's pages
ROUTED_ROWS, ROUTED_SHARDS = 16384, 8  # the routed read's large pool
#: (M, K, N) of the ecc_matmul row: qwen3-0.6b's MLP weights over a
#: 4096-token prefill (up / gate, down) and the decode batch (up / gate,
#: down), a ragged shape that fits no tile or TMA stride, 16 columns and
#: the decode threshold (ops.DECODE_MAX_N = 16) - 1 and + 1, a B whose
#: rows take 2-D TMA boxes but not the 3-D one (N % 64 != 0), then the
#: reference sweep's shapes (tests/test_kernels_sweep.py)
ECC_SHAPES = ((3072, 1024, 4096), (1024, 3072, 4096), (3072, 1024, 4),
              (1024, 3072, 4), (200, 208, 1001), (3072, 1024, 16),
              (3072, 1024, 15), (3072, 1024, 17), (300, 320, 520),
              (64, 128, 64), (256, 512, 128))
ECC_FLIP_SHARE = 0.01      # beats with one planted data-bit flip
ECC_CODE_SHARE = 0.001     # beats with one planted code-bit flip
ECC_DOUBLES = 8            # beats with two mantissa-bit flips (uncorrectable)
ECC_TOKENS = (4096, 4)                 # the ecc-mlp path's token batches
#: dense bf16 tensor-core flops an SM does per clock on Hopper (NVIDIA's
#: 989 TFLOP/s at 132 SMs and 1830 MHz); main() sets BF16_FLOPS_S
BF16_FLOPS_PER_SM = 4096
BF16_FLOPS_S = None

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
    "hash_lookup_read": ("src/repro_torch/csrc/hash.cu",
                         "src/repro/kernels/hash/kernel.py:76"),
    "parity8_encode": ("src/repro_torch/csrc/parity8.cu",
                       "src/repro/kernels/parity8/kernel.py:52"),
    "parity8_check": ("src/repro_torch/csrc/parity8.cu",
                      "src/repro/kernels/parity8/kernel.py:67"),
    "parity8_write": ("src/repro_torch/csrc/parity8.cu",
                      "src/repro/kernels/parity8/kernel.py:52"),
    "scrub_rows": ("src/repro_torch/csrc/scrub.cu",
                   "src/repro/kernels/scrub/kernel.py:51"),
    "daec_encode": ("src/repro_torch/csrc/daec.cu",
                    "src/repro/kernels/daec/kernel.py:130"),
    "daec_decode": ("src/repro_torch/csrc/daec.cu",
                    "src/repro/kernels/daec/kernel.py:145"),
    "interwrap_gather": ("src/repro_torch/csrc/interwrap.cu",
                         "src/repro/kernels/interwrap/kernel.py:51"),
    "interwrap_scatter": ("src/repro_torch/csrc/interwrap.cu",
                          "src/repro/kernels/interwrap/kernel.py:76"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:67"),
    "mixed_read_correct_routed": ("src/repro_torch/csrc/mixed.cu",
                                  "src/repro/kernels/mixed/kernel.py:139"),
    "ecc_matmul": ("src/repro_torch/csrc/ecc_matmul.cu",
                   "src/repro/kernels/ecc_matmul/kernel.py:61"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-call CUDA-event timings after a warm-up.

    Each timed call is queued behind a device-side sleep of about 1 ms, so
    the events bracket the device work of ``fn`` and not the host time its
    wrapper spends before the launch (tens of µs, as long as a small
    kernel itself)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def int_rate(torch) -> dict:
    """The card's int32 rate, SMs x INT_LANES_PER_SM x max SM clock, its
    float32 FMA rate, SMs x FP32_LANES_PER_SM x 2 x max SM clock, and its
    dense bf16 tensor rate, SMs x BF16_FLOPS_PER_SM x max SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    return dict(sms=sms, max_sm_clock_mhz=mhz,
                int_ops_s=sms * INT_LANES_PER_SM * mhz * 1e6,
                fp32_flops_s=sms * FP32_LANES_PER_SM * 2 * mhz * 1e6,
                bf16_flops_s=sms * BF16_FLOPS_PER_SM * mhz * 1e6)


SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)(?:\.[A-Z0-9_.]+)?\s*([^;]*);")
SASS_TARGET = re.compile(r"0x([0-9a-f]+)")
#: opcodes that do not issue on the integer ALU pipe: IMAD goes to the
#: FMA pipe, the rest are memory and control
SASS_OFF_ALU = {"IMAD", "LDG", "STG", "LDC", "LDS", "STS", "BRA", "BSSY",
                "BSYNC", "EXIT", "NOP"}


def sass_loop_ops(obj: Path) -> dict:
    """Instructions one iteration of each kernel's grid-stride loop issues,
    from ``cuobjdump -sass`` of the built object: ALU-pipe instructions
    (``alu``) and IMADs, on the common path — a conditional forward branch
    to a BSYNC (the DAEC decode's correction of a nonzero syndrome) is
    taken, so the region it skips is not counted — and every opcode of the
    whole function (``function_opcodes``)."""
    from repro_torch.kernels import common
    tool = Path(common._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(obj)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        insns = [(int(m[1], 16), bool(m[2]), m[3], m[4])
                 for m in SASS_INSN.finditer(fn)]
        op_at = {a: op for a, _, op, _ in insns}
        # a branch's target is its hex operand (predicate operands such as
        # `!P3,` may come first)
        target = {a: int(m[1], 16) for a, _, op, args in insns
                  if op == "BRA" and (m := SASS_TARGET.search(args))}
        back = [(a, t) for a, t in target.items() if t < a]
        end, start = back[-1] if back else (-1, 0)
        counts: dict = {}
        skip = -1
        for a, pred, op, args in insns:
            if not start <= a <= end or a < skip:
                continue
            if op == "BRA" and pred and a in target:
                t = target[a]
                if t > a and op_at.get(t) == "BSYNC":
                    skip = t
            counts[op] = counts.get(op, 0) + 1
        out[fn.split()[0]] = dict(
            alu=sum(n for op, n in counts.items() if op not in SASS_OFF_ALU),
            imad=counts.get("IMAD", 0), opcodes=counts,
            function_opcodes=sorted({op for _, _, op, _ in insns}))
    return out


def bound_ms(nbytes: int, ops: int, rate: float | None = None
             ) -> tuple[float, str, float, float]:
    """(bound ms, the side that binds, bytes side ms, operations side ms);
    operations run at ``rate`` per second, the int32 rate by default."""
    t_mem, t_ops = nbytes / MEM_BYTES_S, ops / (rate or INT_OPS_S)
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations",
            t_mem * 1e3, t_ops * 1e3)


def words_err(a, b) -> int:
    """max_abs_err of two large word tensors, without int64 copies when
    they are equal."""
    import torch
    return 0 if torch.equal(a, b) else max_abs_err(a, b)


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


def plant_daec(data, codes, rng, n_each: int):
    """Seeded flips in superbeats of distinct rows of (data (N, D), codes
    (N, D/8)) -> (flipped copies, expected beats per status 0..3): single
    data bits and adjacent doubles (bits b, b+1: corrected, status 1),
    single code-field bits (2), and same-codeword doubles (bits b, b+2:
    detected, 3). Each planted superbeat reports on both its beats."""
    import numpy as np
    import torch
    d, c = data.clone(), codes.clone()
    n, dw = d.shape
    rows = rng.choice(n, size=4 * n_each, replace=False)
    bit = lambda b: torch.as_tensor(  # noqa: E731
        (np.uint32(1) << np.asarray(b, np.uint32)).view(np.int32),
        device=d.device)
    for k, pat in enumerate(((0,), (0, 1), None, (0, 2))):
        r = torch.as_tensor(rows[k * n_each:(k + 1) * n_each], device=d.device)
        if pat is None:                      # a bit of the 16-bit field
            wc = torch.as_tensor(rng.integers(0, dw // 8, n_each),
                                 device=d.device)
            c[r, wc] ^= bit(rng.integers(0, 32, n_each))
            continue
        w = torch.as_tensor(rng.integers(0, dw, n_each), device=d.device)
        b0 = rng.integers(0, 32 - pat[-1], n_each)
        mask = bit(b0)
        for extra in pat[1:]:
            mask = mask | bit(b0 + extra)
        d[r, w] ^= mask
    beats = 2 * n_each
    return d, c, [n * dw // 2 - 4 * beats, 2 * beats, beats, beats]


def phase_kernels(torch, np, dev) -> dict:
    from repro_torch.core import secded
    from repro_torch.core.layouts import (LANES, Layout, page_coords,
                                          total_pages)
    from repro_torch.kernels.daec import ops as daec_ops
    from repro_torch.kernels.daec import ref as daec_ref
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
    # each input read once: distinct pages (and their codes) in, n out
    u_ids = torch.unique(ids)
    n_sec = int(((u_ids >= mixed_boundary) & (u_ids < NUM_ROWS)).sum())

    cream = words(NUM_ROWS, LANES, W)
    cids = torch.as_tensor(rng.integers(
        0, total_pages(Layout.INTERWRAP, NUM_ROWS, W), n), dtype=torch.int32,
        device=dev)
    cream_args = (cream, cids, Layout.INTERWRAP, NUM_ROWS, NUM_ROWS)
    n_read = int(torch.unique(cids).numel())
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
        pages_read=n_read, bound=bound_ms(4 * ((n_read + n) * D + n), 0),
        mixed_pool=dict(boundary=mixed_boundary, secded_pages=n_sec,
                        pages_read=int(u_ids.numel()), ms=mixed_ms,
                        bound_ms=bound_ms(
                            4 * ((u_ids.numel() + n) * D + n + n_sec * W),
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
        bound=bound_ms(4 * ((n_read + n) * D + n * W + n), 40 * n * D // 2))
    # -- SEC-DAEC encode / decode: the serve shape and the campaign tier ----
    enc, dec = {}, {}
    for name, rows in (("serve", n), ("campaign_tier", DAEC_PAGES)):
        data = words(rows, D)
        codes = daec_ref.encode(data)
        e_got = daec_ops.encode(data)
        bad, bad_codes, want = plant_daec(data, codes, rng,
                                          n_each=max(1, rows // 16))
        d_got = daec_ops.decode(bad, bad_codes)
        d_want = daec_ref.decode(bad, bad_codes)
        torch.cuda.synchronize()
        counts = torch.bincount(d_got[2].reshape(-1), minlength=4).tolist()
        check(counts == want, f"daec decode statuses {counts} != {want}")
        superbeats = rows * D // 4
        enc[name] = dict(
            rows=rows, max_abs_err=max_abs_err(e_got, codes),
            ms=median_ms(lambda: daec_ops.encode(data), 20),
            plain_ms=median_ms(lambda: daec_ref.encode(data), 3),
            bound=bound_ms(4 * (rows * D + rows * D // 8),
                           DAEC_OPS["encode"] * superbeats))
        dec[name] = dict(
            rows=rows, max_abs_err=max_abs_err(d_got, d_want),
            status_beats=counts,
            ms=median_ms(lambda: daec_ops.decode(bad, bad_codes), 20),
            plain_ms=median_ms(lambda: daec_ref.decode(bad, bad_codes), 3),
            bound=bound_ms(4 * (2 * rows * D + 2 * rows * D // 8
                                + rows * D // 2),
                           DAEC_OPS["decode"] * superbeats))
        del data, codes, bad, bad_codes, d_got, d_want
    for name, per_shape in (("daec_encode", enc), ("daec_decode", dec)):
        out[name] = dict(per_shape["serve"], library_ms=None,
                         max_abs_err=max(r["max_abs_err"]
                                         for r in per_shape.values()),
                         shapes=per_shape)
    for name, r in out.items():
        check(r["max_abs_err"] == 0, f"{name} disagrees with its plain version")
    return dict(n_pages=n, row_words=W, kernels=out)


def profiled_ops(torch, fn):
    """Device operations (kernels, copies, fills) of one call of ``fn``
    under torch.profiler, or "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_breakdown(prof, 1.0).get("device_events", "not measured")


def parity_chain(torch, np, storage, ids, pages, data, num_rows: int,
                 boundary: int) -> None:
    """The PARITY pool's write before the fused kernel, call for call: the
    page_coords scatter of the data, an upload of the positions of the
    CREAM and extra pages (``ids`` on the host), the standalone parity8
    encode over a gathered copy of them and the parity-index scatter into
    the code lane (int64 ``pages``, as the pool uploaded them)."""
    from repro_torch.core.layouts import (CODE_LANE, Layout, page_coords,
                                          parity_coords)
    from repro_torch.kernels.common import upload
    from repro_torch.kernels.parity8 import ops as parity8_ops
    W = storage.shape[2]
    rows, lanes, _ = page_coords(Layout.PARITY, num_rows, boundary, pages, W)
    storage[rows, lanes, :] = data.reshape(-1, 8, W)
    keep = (ids < boundary) | (ids >= num_rows)
    sel = upload(np.flatnonzero(keep), storage.device)
    prow, off = parity_coords(num_rows, boundary, pages[sel], W)
    idx = off[:, None] + torch.arange(W // 8, device=pages.device)
    storage[torch.clamp(prow, 0, num_rows - 1)[:, None], CODE_LANE,
            idx] = parity8_ops.encode(data[sel])


def parity_write_kernel(torch, np, dev, words, rng) -> dict:
    """parity8_write on a half-CREAM PARITY pool of CACHE_ROWS rows, at the
    set batch (SET_BATCH distinct ids mixing CREAM, SECDED and extra
    pages) and at a sweep of the R/2 CREAM pages: bit-exact against its
    plain version and against the eager chain it replaces, with its time,
    the chain's (``chain_ms``), the plain version's, the bound, a launch's
    floor and the device operations one write makes under torch.profiler,
    fused and chained."""
    from repro_torch.core.layouts import LANES, Layout, extra_page_count
    from repro_torch.kernels.parity8 import ops as parity8_ops
    from repro_torch.kernels.parity8 import ref as parity8_ref
    R, half, D = CACHE_ROWS, CACHE_ROWS // 2, 8 * W
    extra = extra_page_count(Layout.PARITY, half, W)
    sec_n = extra_n = SET_BATCH // 8
    set_ids = np.concatenate([
        rng.choice(half, SET_BATCH - sec_n - extra_n, replace=False),
        half + rng.choice(R - half, sec_n, replace=False),
        R + rng.choice(extra, extra_n, replace=False)])
    batches = {"set_batch": rng.permutation(set_ids),
               "sweep": np.arange(half)}
    storage = words(R, LANES, W)
    one = torch.empty(1, device=dev)
    floor_ms = median_ms(lambda: one.fill_(1.0), 20)
    shapes = {}
    for name, ids in batches.items():
        n = len(ids)
        coded = int(((ids < half) | (ids >= R)).sum())
        pages = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        data = words(n, D)
        got, want, chained = (storage.clone() for _ in range(3))
        parity8_ops.write(got, pages, data, half)
        parity8_ref.write(want, pages, data, half)
        parity_chain(torch, np, chained, ids, pages, data, R, half)
        torch.cuda.synchronize()
        check(not torch.equal(got, storage), f"parity8_write {name} wrote "
              "nothing")
        shapes[name] = dict(
            pages=n, coded_pages=coded,
            max_abs_err=words_err(got, want),
            chain_max_abs_err=words_err(chained, want),
            ms=median_ms(lambda: parity8_ops.write(got, pages, data, half),
                         20),
            chain_ms=median_ms(lambda: parity_chain(
                torch, np, chained, ids, pages, data, R, half), 20),
            plain_ms=median_ms(lambda: parity8_ref.write(
                want, pages, data, half), 3),
            launch_floor_ms=floor_ms,
            device_ops_per_write=dict(
                fused=profiled_ops(torch, lambda: parity8_ops.write(
                    got, pages, data, half)),
                chain=profiled_ops(torch, lambda: parity_chain(
                    torch, np, chained, ids, pages, data, R, half))),
            # each page read once and its slices written once, the int64
            # ids read once, W/8 parity words written per CREAM or extra
            # page
            bound=bound_ms(4 * (2 * n * D + 2 * n + coded * W // 8),
                           coded * D // 4))
        check(shapes[name]["chain_max_abs_err"] == 0,
              f"the eager chain and the plain write differ ({name})")
        del got, want, chained, data
    del storage
    torch.cuda.empty_cache()
    return dict(shapes["set_batch"], library_ms=None,
                max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
                shapes=shapes)


def phase_cache_kernels(torch, np, dev) -> dict:
    """The CREAM-Cache path's kernels against their plain versions, at the
    shapes that path gives them: the get batch against a filled index on a
    pool with boundary R/2; the set batch and the parity sweep of a
    half-CREAM PARITY pool; the SECDED sweep of R/2 rows."""
    from repro_torch.core import secded
    from repro_torch.core.layouts import LANES, Layout, total_pages
    from repro_torch.kernels.hash import ops as hash_ops
    from repro_torch.kernels.hash import ref as hash_ref
    from repro_torch.kernels.parity8 import ops as parity8_ops
    from repro_torch.kernels.parity8 import ref as parity8_ref
    from repro_torch.kernels.scrub import ops as scrub_ops
    from repro_torch.kernels.scrub import ref as scrub_ref
    from repro_torch.objcache import hash_index as hix

    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    R, half, D = CACHE_ROWS, CACHE_ROWS // 2, 8 * W
    words = lambda *shape: torch.randint(  # noqa: E731
        -2**31, 2**31, shape, generator=gen, device=dev, dtype=torch.int32)

    def coded_rows(n: int):
        """(n, 9, W) SECDED rows with seeded flips of every status."""
        data = words(n, D)
        codes = secded.encode_block(data)
        data, codes = plant_flips(data, codes, rng, n_each=n // 8)
        return torch.cat([data.reshape(n, 8, W), codes[:, None, :]], dim=1)

    def flipped(t, n: int):
        """A copy of the (N, K) words ``t`` with ``n`` single-bit flips."""
        out = t.clone()
        flat = out.view(-1)
        idx = torch.as_tensor(rng.choice(flat.numel(), n, replace=False),
                              device=dev)
        flat[idx] ^= torch.as_tensor(
            (np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32))
            .view(np.int32), device=dev)
        return out

    out = {}

    # -- hash probe + gather: the get batch on a pool with boundary R/2 -----
    sto = torch.cat([words(half, LANES, W), coded_rows(R - half)])
    n_pages = total_pages(Layout.INTERWRAP, half, W) + (R - half)
    index = hix.make_index(4 * R, CACHE_PROBE, device=dev)
    keys = rng.choice(2**31, R + GET_BATCH, replace=False)
    index, _, ok = hix.insert(
        index, torch.as_tensor(keys[:R], dtype=torch.int32, device=dev),
        torch.as_tensor(rng.integers(0, n_pages, R), dtype=torch.int32,
                        device=dev),
        torch.zeros(R, dtype=torch.int32, device=dev),
        torch.full((R,), D, dtype=torch.int32, device=dev))
    stored = keys[:R][ok.cpu().numpy()]
    q = np.concatenate([rng.choice(stored, 3 * GET_BATCH // 4),
                        keys[R:R + GET_BATCH // 4]])        # 1/4 absent
    q = torch.as_tensor(rng.permutation(q), dtype=torch.int32, device=dev)
    hash_args = (sto, index.key, index.page, q, Layout.INTERWRAP, R, half,
                 CACHE_PROBE)
    got = hash_ops.lookup_read(*hash_args)
    want = hash_ref.lookup_read(*hash_args)
    # each input read once: the distinct pages the queries resolve to
    # (absent keys all read page 0), written once per query
    pages = torch.unique(hash_ref.resolve_pages(index.key, index.page, q,
                                                CACHE_PROBE))
    n_read = int(pages.numel())
    n_sec = int(((pages >= half) & (pages < R)).sum())
    n = GET_BATCH
    out["hash_lookup_read"] = dict(
        max_abs_err=max_abs_err(got, want),
        ms=median_ms(lambda: hash_ops.lookup_read(*hash_args), 20),
        plain_ms=median_ms(lambda: hash_ref.lookup_read(*hash_args), 3),
        library_ms=None, queries=n, pages_read=n_read, secded_pages=n_sec,
        found=int(np.isin(q.cpu().numpy(), stored).sum()),
        bound=bound_ms(4 * ((n_read + n) * D + n_sec * W
                            + n * (CACHE_PROBE + 1)), 48 * n_sec * D // 2))
    # a window wider than a warp: 48 keys share one home slot, so matches
    # sit at window positions 0..47 and absent keys scan two chunks of 32
    wide = 48
    cand = torch.arange(1 << 20, dtype=torch.int32)
    home = cand[(hix.hash_u32(cand).long() & 0xFFFFFFFF) % 256 == 7]
    small = hix.make_index(256, wide, device=dev)
    small, _, ok = hix.insert(
        small, home[:wide].to(dev),
        torch.as_tensor(rng.integers(0, n_pages, wide), dtype=torch.int32,
                        device=dev),
        torch.zeros(wide, dtype=torch.int32, device=dev),
        torch.full((wide,), D, dtype=torch.int32, device=dev))
    check(bool(ok.all()), "wide-window insert failed")
    wq = home[:wide + 8].flip(0).contiguous().to(dev)     # 8 absent keys
    wide_args = (sto, small.key, small.page, wq, Layout.INTERWRAP, R, half,
                 wide)
    out["hash_lookup_read"].update(
        wide_window=dict(probe=wide, queries=wide + 8),
        max_abs_err=max(out["hash_lookup_read"]["max_abs_err"], max_abs_err(
            hash_ops.lookup_read(*wide_args),
            hash_ref.lookup_read(*wide_args))))
    del sto, index, small

    # -- parity8 encode / check: the set batch and the parity sweep ---------
    shapes = {"set_batch": SET_BATCH, "sweep": half}
    enc, chk = {}, {}
    for name, rows in shapes.items():
        data = words(rows, D)
        parity = parity8_ref.encode(data)
        e_got = parity8_ops.encode(data)
        bad, bad_parity = flipped(data, 8), flipped(parity, 8)
        c_got = parity8_ops.check(bad, bad_parity)
        c_want = parity8_ref.check(bad, bad_parity)
        statuses = sorted(int(x) for x in torch.unique(c_got))
        check(statuses == [0, 1], f"parity8 check statuses {statuses}")
        enc[name] = dict(
            rows=rows, max_abs_err=max_abs_err(e_got, parity),
            ms=median_ms(lambda: parity8_ops.encode(data), 20),
            plain_ms=median_ms(lambda: parity8_ref.encode(data), 3),
            bound=bound_ms(4 * (rows * D + rows * D // 64), rows * D // 4))
        chk[name] = dict(
            rows=rows, max_abs_err=max_abs_err(c_got, c_want),
            ms=median_ms(lambda: parity8_ops.check(bad, bad_parity), 20),
            plain_ms=median_ms(lambda: parity8_ref.check(bad, bad_parity), 3),
            bound=bound_ms(4 * (rows * D + rows * D // 64 + rows * D // 16),
                           rows * D // 4))
        del data, parity, bad, bad_parity
    for name, per_shape, main in (("parity8_encode", enc, "set_batch"),
                                  ("parity8_check", chk, "sweep")):
        out[name] = dict(per_shape[main], library_ms=None,
                         max_abs_err=max(r["max_abs_err"]
                                         for r in per_shape.values()),
                         shapes=per_shape)

    # -- parity8 write: a set batch and a sweep into a half-CREAM PARITY
    # pool, against its plain version and the eager chain it replaces -----
    out["parity8_write"] = parity_write_kernel(torch, np, dev, words, rng)

    # -- scrub: the SECDED sweep of R/2 rows --------------------------------
    rows = coded_rows(half)
    s_got = scrub_ops.scrub_rows(rows)
    s_want = scrub_ref.scrub_rows(rows)
    statuses = sorted(int(x) for x in torch.unique(s_got[1]))
    check(statuses == [0, 1, 2, 3], f"scrub statuses {statuses}")
    out["scrub_rows"] = dict(
        max_abs_err=max_abs_err(s_got, s_want),
        ms=median_ms(lambda: scrub_ops.scrub_rows(rows), 20),
        plain_ms=median_ms(lambda: scrub_ref.scrub_rows(rows), 3),
        library_ms=None, rows=half, statuses=statuses,
        bound=bound_ms(4 * (2 * half * LANES * W + half * D // 2),
                       48 * half * D // 2))
    del rows, s_got, s_want
    for name, r in out.items():
        check(r["max_abs_err"] == 0, f"{name} disagrees with its plain version")
    return out


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
    for key, cls in (("hash_lookup_read", "hash probe+gather"),
                     ("interwrap", "interwrap gather/scatter"),
                     ("flash_attention", "flash attention"),
                     ("parity8", "parity8 codec"),
                     ("scrub_rows", "scrub"),
                     ("mixed_read_correct", "mixed read"),
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
    kernel and by class, and the device's busy share of the window. Then
    two schedule_migration calls of MIG_PAGES pages on this local pool,
    each run beside one full-batch step and read back intact, the second
    traced (stream_overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(SEED + 1)
    for i in range(B):
        eng.submit(ServeRequest(
            f"profile{i}",
            rng.integers(0, eng.cfg.vocab_size, PROMPT).astype(np.int32),
            2 * PROFILE_STEPS + 8))
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
    # a scheduled migration on this local pool beside a full-batch step:
    # one to warm the side stream up, one traced. The sessions parked by
    # serve-cream hold the rest of the pool's frames: close them first.
    for seq_id, sess in list(eng.sched.sessions.items()):
        if sess.slot is None:
            eng.sched.close_session(seq_id)
    eng.vm.create_tenant("mig")
    vpns = eng.vm.alloc("mig", 2 * MIG_PAGES, allow_host=False)
    check(vpns is not None, "no frames for the migration")
    phys = [eng.vm.translate("mig", v).phys for v in vpns]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    overlap = None
    for profiled in (False, True):
        check(len(eng.sched.active_slots()) == B, "migration batch not full")
        moving = torch.randint(-2**31, 2**31, (MIG_PAGES, 8 * W),
                               generator=gen, device=DEVICE,
                               dtype=torch.int32)
        _, overlap = migration_step(torch, np, eng, phys[:MIG_PAGES],
                                    phys[MIG_PAGES:], vpns[:MIG_PAGES],
                                    moving, profiled)
    while eng.sched.has_work():
        eng.poll()
    return dict(steps=PROFILE_STEPS, batch=B,
                step_ms=plain_ms / PROFILE_STEPS,
                profiled_step_ms=prof_ms / PROFILE_STEPS,
                **device_breakdown(prof, prof_ms, PROFILE_STEPS),
                local_migration=dict(pages=MIG_PAGES, intact=True,
                                     overlap=overlap))


def device_breakdown(prof, window_ms: float, per: int = 1,
                     top: int = 12) -> dict:
    """Device time seen by ``prof``: by kernel class and by kernel (ms per
    ``per`` steps), the device events and their busy share of a window of
    ``window_ms``; "not measured" when the profiler saw no device time."""
    from collections import Counter

    from torch.autograd import DeviceType
    by_name: Counter = Counter()
    events = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            events += 1
    if not by_name:
        return dict(device_time="not measured")
    by_class: Counter = Counter()
    for name, us in by_name.items():
        by_class[_kernel_class(name)] += us
    busy = sum(by_name.values())
    return dict(device_events=events, device_ms=busy / 1e3 / per,
                device_busy_share=busy / (window_ms * 1e3),
                ms_by_class={k: v / 1e3 / per
                             for k, v in by_class.most_common()},
                top_kernels_ms=[(name[:96], us / 1e3 / per)
                                for name, us in by_name.most_common(top)])


# ---------------------------------------------------------------------------
# Phases 8-13: CREAM-Cache
# ---------------------------------------------------------------------------


def zipf_trace(np, rng, n_pages: int, n_accesses: int,
               alpha: float = 0.99):
    """Zipfian key popularity over shuffled ids (benchmarks/cache_sim.py)."""
    ranks = np.arange(1, n_pages + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    perm = rng.permutation(n_pages)
    return perm[rng.choice(n_pages, size=n_accesses, p=probs)]


def websearch_trace(np, rng, hot_pages: int, cold_pages: int,
                    n_accesses: int, hot_frac: float = 0.95,
                    alpha: float = 0.99):
    """A zipfian hot set over a uniform cold tail (benchmarks/cache_sim.py)."""
    hot = zipf_trace(np, rng, hot_pages, n_accesses, alpha)
    cold = hot_pages + rng.integers(0, cold_pages, size=n_accesses)
    return np.where(rng.random(n_accesses) < hot_frac, hot, cold)


def values_for(np, keys, span: int):
    """Deterministic value per key (verifiable replay)."""
    keys = np.asarray(keys, np.uint32)
    return keys[:, None] * np.arange(1, span + 1, dtype=np.uint32)


def cache_configs():
    """bench_objcache.py's three protection levels: (name, layout,
    boundary), boundary None = the whole pool in CREAM mode."""
    from repro_torch.core.layouts import Layout
    return [("baseline", Layout.INTERWRAP, 0),
            ("parity", Layout.PARITY, None),
            ("correction_free", Layout.INTERWRAP, None)]


def build_cache(layout, boundary, rows: int, row_words: int, device):
    from repro_torch.objcache import ObjCache
    from repro_torch.vm import VirtualMemory
    vm = VirtualMemory(row_words=row_words, device=device)
    vm.add_pool("dimm", rows, layout, boundary=boundary)
    return vm, ObjCache(vm, "dimm", index_capacity=4 * rows,
                        probe=CACHE_PROBE)


def replay(np, cache, trace, get_batch: int, set_batch: int,
           warmup: bool = True) -> tuple[float, int]:
    """bench_objcache.replay with verify=True -> (wall seconds, get calls).

    Misses queue up and are admitted ``set_batch`` at a time as full-page
    values; every hit is checked against ``values_for``. ``warmup`` runs
    one get/set round first and resets the stats. Each get and each set
    ends in a host copy, so the host clock covers the device work.
    """
    span = cache.max_value_words
    gets = 0
    if warmup:
        ks = trace[:get_batch]
        _, _, found = cache.get_many(ks)
        gets += 1
        miss = np.unique(ks[~found])[:set_batch]
        pad = np.arange(2**30, 2**30 + set_batch - len(miss), dtype=np.int64)
        batch = np.concatenate([miss, pad])
        cache.set_many(batch, values_for(np, batch, span))
        if len(pad):
            cache.delete_many(pad)
        cache.stats = type(cache.stats)()
    t0 = time.perf_counter()
    pending = np.zeros(0, np.int64)
    for i in range(0, len(trace) - len(trace) % get_batch, get_batch):
        ks = trace[i:i + get_batch]
        vals, _, found = cache.get_many(ks)
        gets += 1
        check(bool((vals[found, :span] == values_for(np, ks[found], span))
                   .all()), "a cached value came back corrupted")
        pending = np.unique(np.concatenate([pending, ks[~found]]))
        while len(pending) >= set_batch:
            batch, pending = pending[:set_batch], pending[set_batch:]
            cache.set_many(batch, values_for(np, batch, span))
    return time.perf_counter() - t0, gets


def cache_summary(cache, seconds: float) -> dict:
    s = cache.stats
    ops = s.gets + s.sets
    return dict(hit_rate=s.hit_rate,
                us_per_op=seconds * 1e6 / ops if ops else 0.0,
                model_total_us=s.misses * FAULT_PENALTY_US
                + s.hits * HIT_COST_US,
                device_pages=cache.pool.num_pages, gets=s.gets, sets=s.sets,
                evictions=s.evictions, host_hits=s.host_hits)


def live_keys(np, cache):
    """Keys of every value the cache holds (from its device index)."""
    from repro_torch.kernels.common import to_u32
    return to_u32(cache.index.key)[cache._live].astype(np.int64)


def check_all_values(np, cache) -> int:
    """Read back every live value; all must equal ``values_for``."""
    keys = live_keys(np, cache)
    for i in range(0, len(keys), GET_BATCH):
        ks = keys[i:i + GET_BATCH]
        vals, lens, found = cache.get_many(ks)
        check(bool(found.all()), "a cached value was lost")
        check(bool((vals == values_for(np, ks, cache.max_value_words))
                   .all()), "a cached value changed")
    return len(keys)


def phase_cache_reference(torch, np) -> dict:
    """The same seeded trace and one policy step, with a planted flip, on a
    small cache on the card and on the CPU: identical per-batch results,
    stats and storage."""
    from repro_torch.core.monitor import MonitorConfig
    from repro_torch.kernels.common import to_u32
    from repro_torch.vm.policy import VMPolicy
    rows, w = 16, 64
    out = {}
    for name, layout, boundary in cache_configs():
        rng = np.random.default_rng(SEED + 3)
        trace = zipf_trace(np, rng, 4 * rows, 512)
        twins = [build_cache(layout, boundary, rows, w, d)
                 for d in (DEVICE, "cpu")]
        span = twins[0][1].max_value_words
        pending = np.zeros(0, np.int64)
        for i in range(0, len(trace), 16):
            ks = trace[i:i + 16]
            res = [c.get_many(ks) for _, c in twins]
            for a, b in zip(*res, strict=True):
                check(np.array_equal(a, b), f"{name}: card and CPU gets "
                      "differ")
            pending = np.unique(np.concatenate([pending, ks[~res[0][2]]]))
            while len(pending) >= 4:
                batch, pending = pending[:4], pending[4:]
                lens = rng.integers(1, span + 1, 4)
                got = [c.set_many(batch, values_for(np, batch, span), lens)
                       for _, c in twins]
                check(np.array_equal(*got), f"{name}: card and CPU sets "
                      "differ")
        steps = []
        for vm, _ in twins:
            pool = vm.pools["dimm"]
            flip = torch.zeros_like(pool.storage)
            flip[rows - 1, 2, 5] = 1 << 3        # a SECDED or CREAM row
            vm.pools["dimm"] = dataclasses.replace(
                pool, storage=pool.storage ^ flip)
            stats, performed = VMPolicy(vm, config=MonitorConfig(
                window=1)).step(use_kernel=True)
            steps.append((stats["dimm"], performed))
        check(steps[0] == steps[1], f"{name}: policy steps differ")
        (vm_a, c_a), (vm_b, c_b) = twins
        check(np.array_equal(to_u32(vm_a.pools["dimm"].storage),
                             to_u32(vm_b.pools["dimm"].storage)),
              f"{name}: card and CPU storage differ")
        sa, sb = (dataclasses.asdict(c.stats) for c in (c_a, c_b))
        for k in ("get_s", "set_s"):
            sa.pop(k), sb.pop(k)
        check(sa == sb, f"{name}: card and CPU stats differ")
        out[name] = dict(sa, boundary_after=vm_a.pools["dimm"].boundary,
                         scrub=dataclasses.asdict(steps[0][0]))
    return out


def phase_cache_replay(torch, np, kind: str) -> tuple[dict, dict, object]:
    """One trace over the three configurations at full size -> (results,
    launches per configuration, the PARITY cache for the profile)."""
    from repro_torch.kernels import common
    rows = CACHE_ROWS
    if kind == "zipf":
        trace = zipf_trace(np, np.random.default_rng(SEED), 4 * rows,
                           CACHE_ACCESSES)
    else:
        trace = websearch_trace(np, np.random.default_rng(SEED + 1),
                                int(1.25 * rows), 8 * rows, CACHE_ACCESSES)
    out, launches, keep = {}, {}, None
    for name, layout, boundary in cache_configs():
        _, cache = build_cache(layout, boundary, rows, W, DEVICE)
        torch.cuda.synchronize()
        common.LAUNCHES.clear()              # counts of the main path only
        seconds, gets = replay(np, cache, trace, GET_BATCH, SET_BATCH)
        torch.cuda.synchronize()
        launches[name] = dict(common.LAUNCHES)
        out[name] = dict(cache_summary(cache, seconds), seconds=seconds,
                         launches=launches[name])
        check(launches[name].get("hash_lookup_read", 0) == gets,
              f"{kind}/{name}: {launches[name].get('hash_lookup_read')} "
              f"hash launches for {gets} gets")
        uses_parity = any(k.startswith("parity8") and v
                          for k, v in launches[name].items())
        check(uses_parity == (name == "parity"),
              f"{kind}/{name}: parity8 launched = {uses_parity}")
        if name == "parity" and kind == "zipf":
            keep = cache
        del cache
        torch.cuda.empty_cache()
    base = out["baseline"]["model_total_us"]
    for name in out:
        cur = out[name]["model_total_us"]
        out[name]["model_speedup"] = base / cur if cur else 0.0
    pages = [out[n]["device_pages"] for n, _, _ in cache_configs()]
    check(pages[0] < pages[1] < pages[2], f"{kind}: device pages {pages}")
    for name in ("parity", "correction_free"):
        check(out[name]["hit_rate"] > out["baseline"]["hit_rate"],
              f"{kind}: {name} hit rate is not above the baseline's")
    return out, launches, keep


def phase_cache_demotion(torch, np) -> tuple[dict, dict]:
    """All-SECDED for the first half of the zipf trace, a live demotion to
    correction-free (repartition_with_migration + refresh_translation),
    every value read back, then the second half."""
    from repro_torch.core.layouts import Layout
    from repro_torch.kernels import common
    from repro_torch.vm import MigrationEngine
    rows = CACHE_ROWS
    trace = zipf_trace(np, np.random.default_rng(SEED), 4 * rows,
                       CACHE_ACCESSES)
    half = len(trace) // 2
    vm, cache = build_cache(Layout.INTERWRAP, 0, rows, W, DEVICE)
    torch.cuda.synchronize()
    common.LAUNCHES.clear()
    replay(np, cache, trace[:half], GET_BATCH, SET_BATCH)
    before = cache.stats.hit_rate
    g0, h0 = cache.stats.gets, cache.stats.hits
    t0 = time.perf_counter()
    info = MigrationEngine(vm).repartition_with_migration("dimm", rows)
    refresh = cache.refresh_translation()
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t0
    checked = check_all_values(np, cache)
    replay(np, cache, trace[half:], GET_BATCH, SET_BATCH, warmup=False)
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    after = (cache.stats.hits - h0 - checked) / max(
        cache.stats.gets - g0 - checked, 1)
    check(cache.pool.num_pages == rows + rows // 8,
          f"demotion left {cache.pool.num_pages} pages")
    out = dict(hit_before=before, hit_after=after,
               device_pages=cache.pool.num_pages, values_checked=checked,
               repartition=info, refresh=refresh, move_s=move_s,
               launches=launches)
    del cache, vm
    torch.cuda.empty_cache()
    return out, launches


def phase_cache_adapt(torch, np) -> tuple[dict, dict]:
    """The scrub -> monitor -> adapt loop on a filled PARITY pool at
    boundary R/2. Flips go into frames that hold no value: single-bit flips
    in free SECDED rows and one data bit of a CREAM page whose value was
    deleted. One ``VMPolicy.step`` must count exactly those flips and
    upgrade the pool to all-SECDED, and every value must survive."""
    from repro_torch.core.layouts import Layout
    from repro_torch.kernels import common
    from repro_torch.objcache import hash_index as hix
    from repro_torch.vm.policy import VMPolicy
    rows, half = CACHE_ROWS, CACHE_ROWS // 2
    vm, cache = build_cache(Layout.PARITY, half, rows, W, DEVICE)
    span = cache.max_value_words
    cream_frames = cache.pool.num_pages - (rows - half)
    keys = np.arange(1, cream_frames - 64 + 1)   # every CREAM frame but 64
    t0 = time.perf_counter()
    for i in range(0, len(keys), SET_BATCH):
        batch = keys[i:i + SET_BATCH]
        check(bool(cache.set_many(batch, values_for(np, batch, span)).all()),
              "fill rejected a value")
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    # free one regular CREAM frame: delete the value that lives there
    victim = int(keys[len(keys) // 2])
    slot = int(hix.find(cache.index, torch.as_tensor(
        [victim], dtype=torch.int32, device=vm.device))[0][0])
    page = vm.translate(cache.tenant, int(cache._vpn[slot])).phys
    check(page < half, f"victim page {page} is not a regular CREAM page")
    cache.delete_many([victim])
    owned = set(vm.allocators["dimm"].owner)
    free_sec = [r for r in range(half, rows) if r not in owned]
    rng = np.random.default_rng(SEED + 4)
    flip_rows = rng.choice(free_sec, ADAPT_FLIPS, replace=False)
    pool = vm.pools["dimm"]
    flips = torch.zeros_like(pool.storage)
    for r in flip_rows:                    # one data bit per row: status 1
        flips[int(r), int(rng.integers(0, 8)), int(rng.integers(0, W))] = \
            1 << int(rng.integers(0, 31))
    flips[page, 3, 7] = 1 << 11             # one parity line of page
    vm.pools["dimm"] = dataclasses.replace(pool,
                                           storage=pool.storage ^ flips)
    del pool, flips
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                  # counts of the main path only
    t0 = time.perf_counter()
    policy = VMPolicy(vm)
    stats, performed = policy.step(use_kernel=True)
    refresh = cache.refresh_translation()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    s = stats["dimm"]
    check(launches.get("scrub_rows", 0) > 0, "scrub_rows not launched")
    check(launches.get("parity8_check", 0) > 0, "parity8_check not launched")
    check((s.corrected_data, s.corrected_code, s.detected_uncorrectable,
           s.parity_corrupt_lines) == (ADAPT_FLIPS, 0, 0, 1),
          f"scrub census {s} does not match the planted flips")
    check(sorted(s.corrupt_rows) == [page], f"corrupt rows {s.corrupt_rows}")
    check(vm.pools["dimm"].boundary == 0 and len(performed) == 1,
          "the monitor did not upgrade the pool")
    checked = check_all_values(np, cache)
    check(checked == len(keys) - 1, f"{checked} values after the upgrade")
    out = dict(rows=rows, boundary_before=half, values=len(keys) - 1,
               fill_s=fill_s, step_s=step_s, scrub=dataclasses.asdict(s),
               transitions=[(n, a.value, b.value)
                            for n, a, b in policy.transitions],
               repartition=performed[0], refresh=refresh,
               values_checked=checked, launches=launches)
    del cache, vm, policy
    torch.cuda.empty_cache()
    return out, launches


def phase_cache_profile(torch, np, cache) -> dict:
    """Where a full-batch get and set spend their time on the PARITY cache
    of cache-zipf: host clock without the profiler, then device kernel
    time by class under torch.profiler, the device operations it ran
    (``device_events``: kernels, copies, fills) and the device's busy
    share, and the port's kernel launches of each op."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import common
    span = cache.max_value_words
    rng = np.random.default_rng(SEED + 5)
    fresh = iter(range(2**30, 2**31, SET_BATCH))

    def one(op: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if op == "get":
            cache.get_many(rng.integers(0, 4 * CACHE_ROWS, GET_BATCH))
        else:
            keys = np.arange(SET_BATCH, dtype=np.int64) + next(fresh)
            cache.set_many(keys, values_for(np, keys, span))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {}
    for op in ("get", "set"):
        one(op)                              # warm
        common.LAUNCHES.clear()
        plain = one(op)
        launches = dict(common.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled = one(op)
        out[op] = dict(batch=GET_BATCH if op == "get" else SET_BATCH,
                       host_ms=plain, profiled_ms=profiled,
                       launches=launches,
                       **device_breakdown(prof, profiled, top=8))
    set_l = out["set"]["launches"]
    check(set_l.get("parity8_write") == 1 and "parity8_encode" not in set_l,
          f"a set on the PARITY cache launched {set_l}")
    return out


# ---------------------------------------------------------------------------
# Phases 14-15: CREAM-Campaign
# ---------------------------------------------------------------------------


def phase_campaign_serve(torch, np, tok_c) -> tuple[dict, dict]:
    """The serve phases' requests under memcached-FIT injection with the
    SLO loop armed (tests/test_faults_campaign.py ``campaign_run`` at full
    width): the first two requests on the paid tier (SECDED frames), the
    rest on batch (NONE frames, SLO escalation up to SECDED); one campaign
    tick per poll and a scrub every third tick."""
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core.injection import SINGLES
    from repro_torch.core.layouts import GROUP_ROWS, Layout
    from repro_torch.core.protection import Protection, at_least
    from repro_torch.faults import (MEMCACHED_FIT, FaultCampaign,
                                    hours_for_expected_flips)
    from repro_torch.kernels import common
    from repro_torch.obs import slo
    from repro_torch.serve import Engine
    from repro_torch.vm import VirtualMemory
    from repro_torch.vm.policy import TenantSLO, VMPolicy
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    slo.TRACKER.reset()
    # benchmarks/bench_faults.py: 3/4 of the rows stay SECDED, room for
    # the paid tier and for every batch page the escalation relocates
    boundary = (NUM_ROWS // 4 // GROUP_ROWS) * GROUP_ROWS
    vm = VirtualMemory(row_words=W, device=DEVICE)
    vm.add_pool("kv", NUM_ROWS, Layout.INTERWRAP, boundary=boundary)
    eng = Engine(cfg, max_batch=B, max_len=MAX_LEN, vm=vm, pool="kv",
                 mode="cream", row_words=W, seed=SEED)
    policy = VMPolicy(vm)
    policy.set_tenant_slo("serve", "batch", TenantSLO(
        max_error_rate=1e-3, min_reads=64, ceiling=Protection.SECDED))
    storage = vm.pools["kv"].storage
    hours = hours_for_expected_flips(
        MEMCACHED_FIT, storage.numel() * storage.element_size(), 5.0)
    campaign = FaultCampaign(vm, "kv", policy=policy, engine=eng,
                             fit_per_mbit=MEMCACHED_FIT, hours_per_step=hours,
                             mix=SINGLES, n_hard=0, seed=5)
    reqs = requests(np, cfg.vocab_size)
    for i, r in enumerate(reqs):
        r.tier = "paid" if i < 2 else "batch"
        eng.submit(r)
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    t0 = time.perf_counter()
    done = []
    while eng.sched.has_work():
        done.extend(eng.poll())
        campaign.tick()
        if campaign.steps % 3 == 0:          # periodic repair sweep
            policy.scrub_all()
    campaign.observe()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    report = campaign.report()
    campaign.detach()
    census = {k: dataclasses.asdict(v) for k, v in report.census.items()}
    check(campaign.injected > 0, "the campaign injected no flip")
    sec = report.census["secded"]
    check(sec.silent == 0 and sec.detected == 0 and sec.corrected > 0,
          f"SECDED census {census['secded']}")
    check(report.census["none"].silent > 0, "no silent NONE read")
    esc = report.escalations
    check(bool(esc) and (esc[0]["tenant"], esc[0]["segment"])
          == ("serve", "batch") and esc[0]["moved"] > 0,
          f"serve/batch did not escalate: {esc}")
    target = vm.tenants["serve"].segments["batch"]
    for vpn, pte in vm.tenants["serve"].entries.items():
        if pte.segment == "batch" and pte.pool is not None:
            check(at_least(vm.effective_protection("serve", vpn), target),
                  f"batch page {vpn} below its contract {target}")
    check(len(done) == len(reqs) and all(len(r.generated) == MAX_NEW
                                         for r in reqs),
          "requests unfinished")
    check([r.generated for r in reqs[:2]] == tok_c[:2],
          "paid tokens differ from serve-cream's")
    # every engine gather went through the shadow: the decode step's pages
    # plus the relocation reads, none by the fused mixed read
    # (plus relocation and swap-out reads)
    gathered = eng.steps * B * eng.n_layers * eng.kv.max_blocks
    reads = sum(c.reads for c in report.census.values())
    check(reads >= gathered, "the shadow missed engine reads")
    check(launches.get("mixed_read_correct", 0) == 0,
          "the fused read bypassed the shadow")
    tokens = sum(len(r.generated) for r in reqs)
    return dict(rows=NUM_ROWS, boundary=boundary, hours_per_step=hours,
                ticks=campaign.steps, flips=campaign.injected,
                census=census, rates=report.rates(),
                escalations=[dict(e, **{"from": e["from"].value,
                                        "to": e["to"].value}) for e in esc],
                first_escalation_step=campaign.first_escalation_step,
                decode_steps=eng.steps, gathered_pages=gathered,
                shadow_reads=reads, preemptions=eng.sched.stats.get(
                    "preemptions"), tokens=tokens, tokens_per_s=tokens / wall,
                paid_tokens_equal=True, seconds=wall,
                launches=launches), launches


def phase_campaign_daec(torch, np) -> tuple[dict, dict]:
    """The reference's SECDED -> DAEC acceptance campaign at full page
    size: a tenant's 512 SECDED pages under adjacent-double upsets, the SLO
    escalating to DAEC through a carved tier; then a final scrub of planted
    singles and adjacent doubles in the tier, held against the plain
    version on the CPU."""
    from repro_torch.core.injection import ErrorMix
    from repro_torch.core.layouts import Layout
    from repro_torch.core.pool import make_pool
    from repro_torch.core.protection import Protection
    from repro_torch.faults import (MEMCACHED_FIT, FaultCampaign,
                                    hours_for_expected_flips)
    from repro_torch.kernels import common
    from repro_torch.obs import slo
    from repro_torch.vm import VirtualMemory
    from repro_torch.vm.policy import TenantSLO, VMPolicy
    slo.TRACKER.reset()
    vm = VirtualMemory(row_words=W, device=DEVICE)
    vm.add_pool("p", NUM_ROWS, Layout.INTERWRAP, boundary=0)  # all SECDED
    vm.create_tenant("t", segments={"seg": Protection.SECDED})
    policy = VMPolicy(vm)
    policy.set_tenant_slo("t", "seg", TenantSLO(
        max_error_rate=1e-3, min_reads=32, ceiling=Protection.DAEC))
    vpns = vm.alloc("t", DAEC_PAGES, segment="seg")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    payload = torch.randint(-2**31, 2**31, (DAEC_PAGES, vm.page_words),
                            generator=gen, device=DEVICE, dtype=torch.int32)
    vm.write("t", vpns, payload)
    phys0 = np.asarray([vm.translate("t", v).phys for v in vpns])
    storage = vm.pools["p"].storage
    hours = hours_for_expected_flips(
        MEMCACHED_FIT, storage.numel() * storage.element_size(), 6.0)
    campaign = FaultCampaign(
        vm, "p", policy=policy, fit_per_mbit=MEMCACHED_FIT,
        hours_per_step=hours, mix=ErrorMix(single=0.0, adjacent_double=1.0),
        seed=11)
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    t0 = time.perf_counter()
    escalated = []
    for _ in range(40):
        campaign.inject()
        vm.read("t", vpns)
        campaign.observe()
        escalated = campaign.escalate()
        if escalated:
            break
    for _ in range(6):                      # post-escalation, on the tier
        campaign.inject()
        vm.read("t", vpns)
        campaign.observe()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    report = campaign.report()
    census = {k: dataclasses.asdict(v) for k, v in report.census.items()}
    check(bool(escalated) and escalated[0]["to"] == Protection.DAEC,
          f"no escalation to DAEC: {escalated}")
    check(all(vm.effective_protection("t", v) == Protection.DAEC
              for v in vpns), "a page is not on a DAEC frame")
    check(all(c.silent == 0 for c in report.census.values()),
          f"silent reads: {census}")
    daec = report.census["daec"]
    check(daec.reads > 0 and daec.detected == 0, f"DAEC census {census}")
    check(launches.get("daec_encode", 0) > 0
          and launches.get("daec_decode", 0) > 0, "daec kernels not launched")
    # pages whose SECDED reads were never flagged hold the payload exactly
    # (a flagged page was surfaced wrong, with its flag, and relocated so)
    sh = campaign.shadow
    flagged = sh._detected[phys0] > 0
    data = vm.read("t", vpns)
    keep = torch.as_tensor(np.flatnonzero(~flagged), device=DEVICE)
    check(torch.equal(data[keep], payload[keep]), "an unflagged page changed")
    # the final scrub: a clean-up sweep, then planted flips in the tier
    pool = vm.pools["p"]
    stats0 = policy.scrub_all()["p"]
    snapshot = vm.read("t", vpns)
    rng = np.random.default_rng(SEED + 12)
    tier = sorted(set(range(pool.daec_start, pool.num_rows))
                  & {vm.translate("t", v).phys for v in vpns}
                  - set(stats0.corrupt_rows))
    rows = rng.choice(tier, 2 * DAEC_PLANTS, replace=False)
    sto = pool.storage
    for k, r in enumerate(rows):             # one superbeat each
        lane, word = int(rng.integers(0, 8)), int(rng.integers(0, W))
        b = int(rng.integers(0, 31))
        sto[int(r), lane, word] ^= common.s32(
            (1 if k < DAEC_PLANTS else 3) << b)
    planted = sto[torch.as_tensor(rows, device=DEVICE)].cpu()
    stats1 = policy.scrub_all()["p"]
    cpu = make_pool(len(rows), Layout.INTERWRAP, boundary=0, row_words=W,
                    daec_rows=len(rows), device="cpu")
    cpu.storage.copy_(planted)
    cpu, cstats = cpu.scrub()
    beats = 2 * 2 * DAEC_PLANTS
    check((stats1.corrected_data, stats1.corrected_code) == (beats, 0)
          and stats1.detected_uncorrectable
          == stats0.detected_uncorrectable,
          f"final scrub {stats1} after {stats0}")
    check((cstats.corrected_data, cstats.corrected_code,
           cstats.detected_uncorrectable) == (beats, 0, 0),
          f"plain scrub {cstats}")
    check(torch.equal(vm.pools["p"].storage[torch.as_tensor(
        rows, device=DEVICE)].cpu(), cpu.storage),
          "card and plain scrub repaired differently")
    check(torch.equal(vm.read("t", vpns), snapshot),
          "the payload changed across the final scrub")
    campaign.detach()
    return dict(rows=NUM_ROWS, pages=DAEC_PAGES, hours_per_step=hours,
                ticks=campaign.steps, flips=campaign.injected,
                census=census, rates=report.rates(),
                escalations=[dict(e, **{"from": e["from"].value,
                                        "to": e["to"].value})
                             for e in report.escalations],
                first_escalation_step=campaign.first_escalation_step,
                daec_rows=vm.pools["p"].daec_rows,
                flagged_pages=int(flagged.sum()), seconds=wall,
                final_scrub=dict(
                    planted_superbeats=len(rows),
                    before=dataclasses.asdict(stats0),
                    after=dataclasses.asdict(stats1),
                    plain_cpu=dataclasses.asdict(cstats)),
                launches=launches), launches


# ---------------------------------------------------------------------------
# Phase 2 (cont.): the InterWrap and flash-attention kernels
# ---------------------------------------------------------------------------


def session_pages(cfg) -> int:
    """Pool pages of one packed seqcache session: K and V of every layer at
    SESSION_MAX_LEN positions, float32, plus the int32 cache length."""
    from repro_torch.models.transformer import num_attn_layers
    nbytes = (num_attn_layers(cfg) * 2 * SESSION_MAX_LEN * cfg.num_kv_heads
              * cfg.head_dim_ * 4 + 4)
    return -(-nbytes // (4 * 8 * W))


def phase_interwrap_kernels(torch, np, dev) -> dict:
    """The InterWrap gather / scatter at the serve shape (one decode step's
    B·L·maxB pages of the 1600-row CREAM pool) and at one seqcache session
    (its pages of a pool of 8 sessions' rows): bit-exact against the plain
    versions on every page id of each pool, extras included, then timed on
    a batch of distinct ids as the path gives it."""
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core.layouts import LANES
    from repro_torch.kernels.interwrap import ops, ref
    from repro_torch.models.transformer import num_attn_layers
    rng = np.random.default_rng(SEED + 14)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    words = lambda *shape: torch.randint(  # noqa: E731
        -2**31, 2**31, shape, generator=gen, device=dev, dtype=torch.int32)
    D = 8 * W
    max_blocks = -(-MAX_LEN // (D // (2 * CONFIG.num_kv_heads
                                      * CONFIG.head_dim_)))
    pages = session_pages(CONFIG)
    shapes = {"serve": (NUM_ROWS, B * num_attn_layers(CONFIG) * max_blocks),
              "session": (8 * pages, pages)}
    gat, sca = {}, {}
    for name, (R, n) in shapes.items():
        sto = words(R, LANES, W)
        every = torch.as_tensor(rng.permutation(R + R // 8),
                                dtype=torch.int32, device=dev)
        err_g = words_err(ops.gather(sto, every, R),
                          ref.gather(sto, every, R))
        data = words(every.numel(), D)
        got, want = sto.clone(), sto.clone()
        ops.scatter(got, every, data, R)
        ref.scatter(want, every, data, R)
        torch.cuda.synchronize()
        err_s = words_err(got, want)
        del got, want, data
        ids = every[:n].contiguous()
        data = words(n, D)
        rows, lanes = ref.wrap_coords(ids, R)
        lib_g = lambda: sto[rows, lanes]  # noqa: E731  (yardstick only)
        check(torch.equal(lib_g().reshape(n, D), ops.gather(sto, ids, R)),
              "indexing yardstick differs")
        lib_s = lambda: sto.index_put_(  # noqa: E731  (yardstick only)
            (rows, lanes), data.view(n, 8, W))
        nbytes = 4 * (2 * n * D + n)            # pages in, pages out, ids
        gat[name] = dict(
            rows=R, pages=n, max_abs_err=err_g, ids_checked=every.numel(),
            ms=median_ms(lambda: ops.gather(sto, ids, R), 20),
            plain_ms=median_ms(lambda: ref.gather(sto, ids, R), 3),
            library_ms=median_ms(lib_g, 20), bound=bound_ms(nbytes, 0))
        sca[name] = dict(
            rows=R, pages=n, max_abs_err=err_s, ids_checked=every.numel(),
            ms=median_ms(lambda: ops.scatter(sto, ids, data, R), 20),
            plain_ms=median_ms(lambda: ref.scatter(sto, ids, data, R), 3),
            library_ms=median_ms(lib_s, 20), bound=bound_ms(nbytes, 0))
        del sto, every, ids, data, rows, lanes
        torch.cuda.empty_cache()
    out = {}
    for kname, per_shape in (("interwrap_gather", gat),
                             ("interwrap_scatter", sca)):
        out[kname] = dict(per_shape["session"],
                          max_abs_err=max(r["max_abs_err"]
                                          for r in per_shape.values()),
                          shapes=per_shape)
        check(out[kname]["max_abs_err"] == 0,
              f"{kname} disagrees with its plain version")
    return out


def phase_flash_kernel(torch, np, dev) -> dict:
    """Flash attention at the prefill-long shape (B 1, Hq 16, Hkv 8, S 8192,
    D 128, float32, causal) against its plain version: max abs error
    within 2e-5 of the output's largest magnitude (the reference sweep's
    float32 tolerance). Also a ragged S (1000) causal and not, in float32
    (the same bound) and bfloat16 (|err| <= 2e-2 + 2e-2·|plain|, the
    sweep's). Bound: flops of the causal pairs over the float32 FMA rate,
    or each operand read once and the output written once."""
    import torch.nn.functional as F

    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    hq, hkv, d = CONFIG.num_heads, CONFIG.num_kv_heads, CONFIG.head_dim_

    def operands(s: int, dtype):
        return tuple(torch.randn((1, h, s, d), generator=gen, device=dev)
                     .to(dtype) for h in (hq, hkv, hkv))

    ragged = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = operands(1000, dtype)
        for causal in (True, False):
            got = ops.attention(q, k, v, causal=causal).float()
            want = ref.attention(q, k, v, causal=causal).float()
            err = (got - want).abs()
            if dtype == torch.float32:
                ok = float(err.max()) <= 2e-5 * float(want.abs().max())
            else:
                ok = bool((err <= 2e-2 + 2e-2 * want.abs()).all())
            ragged[f"{str(dtype)[6:]}_{'causal' if causal else 'full'}"] = \
                float(err.max())
            check(ok, f"flash attention off at S=1000 {dtype} {causal}")
    S = LONG_PROMPT
    q, k, v = operands(S, torch.float32)
    got = ops.attention(q, k, v)
    want = ref.attention(q, k, v)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= 2e-5 * scale,
          f"flash attention max abs error {err} at output scale {scale}")
    del got, want
    torch.cuda.empty_cache()
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731  (yardstick)
        q, k, v, is_causal=True, enable_gqa=True)
    flops = 4 * hq * d * S * (S + 1) // 2       # the causal (row, col) pairs
    out = dict(
        shape=dict(B=1, Hq=hq, Hkv=hkv, S=S, D=d, dtype="float32",
                   causal=True),
        max_abs_err=err, output_scale=scale, ragged_max_abs_err=ragged,
        ms=median_ms(lambda: ops.attention(q, k, v), 20),
        plain_ms=median_ms(lambda: ref.attention(q, k, v), 3),
        library_ms=median_ms(lib, 20), flops=flops,
        bound=bound_ms(4 * 2 * (hq + hkv) * S * d, flops, FP32_FLOPS_S))
    out["tflops_s"] = flops / out["ms"] / 1e9
    return {"flash_attention": out}


# ---------------------------------------------------------------------------
# Phases 16-17: long-context prefill, the SequenceCache tier
# ---------------------------------------------------------------------------


def greedy_decode(torch, model, state, tok, steps: int):
    """``steps`` dense decode steps from ``tok`` (1,) int32 -> (the tokens,
    the state after them)."""
    out = []
    for _ in range(steps):
        logits, state = model.decode_step(state, tok)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(int(tok))
    return out, state


def phase_prefill_long(torch, np, model) -> tuple[dict, dict]:
    """One seeded LONG_PROMPT-token prompt through the flash prefill and
    the plain einsum prefill of the same weights, then DECODE_NEW dense
    decode tokens on each; after the flash path's, PROFILE_STEPS more under
    torch.profiler (device time by class of a dense decode step)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import common
    from repro_torch.models.transformer import num_attn_layers
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 16)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, LONG_PROMPT)), device=DEVICE)
    max_len = LONG_PROMPT + DECODE_NEW + PROFILE_STEPS
    runs, logits, launches = {}, {}, {}
    for impl in ("flash", "xla"):
        model.attn_impl = impl
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.LAUNCHES.clear()                 # counts of the main path only
        t0 = time.perf_counter()
        logits[impl], state = model.prefill_state(prompt, max_len,
                                                  logits_mode="last")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[impl] = dict(common.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        tok = logits[impl].argmax(-1).to(torch.int32)
        t1 = time.perf_counter()
        new, state = greedy_decode(torch, model, state, tok, DECODE_NEW)
        torch.cuda.synchronize()
        runs[impl] = dict(prefill_s=secs, prefill_tokens_per_s=LONG_PROMPT
                          / secs, peak_gib=peak / 2**30,
                          decode_ms_per_token=(time.perf_counter() - t1)
                          * 1e3 / DECODE_NEW, tokens=[int(tok)] + new,
                          launches=launches[impl])
        if impl == "flash":
            tok = torch.as_tensor([new[-1]], dtype=torch.int32,
                                  device=DEVICE)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                greedy_decode(torch, model, state, tok, PROFILE_STEPS)
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t1) * 1e3
            runs[impl]["decode_profile"] = dict(
                steps=PROFILE_STEPS, profiled_step_ms=prof_ms / PROFILE_STEPS,
                **device_breakdown(prof, prof_ms, PROFILE_STEPS, top=8))
        del state
        torch.cuda.empty_cache()
    model.attn_impl = "flash"
    check(all(torch.isfinite(lg).all() for lg in logits.values()),
          "non-finite prefill logits")
    rel = float((logits["flash"] - logits["xla"]).abs().max()
                / logits["xla"].abs().max())
    check(rel <= 1e-3, f"flash and plain last logits differ by {rel} rel")
    check(runs["flash"]["tokens"] == runs["xla"]["tokens"],
          "flash and plain prefill decode different tokens")
    layers = num_attn_layers(cfg)
    check(launches["flash"].get("flash_attention", 0) == layers,
          f"{launches['flash'].get('flash_attention')} flash launches for "
          f"{layers} layers")
    check(launches["xla"].get("flash_attention", 0) == 0,
          "the plain prefill launched flash attention")
    return dict(prompt=LONG_PROMPT, max_len=max_len,
                last_logits_rel_err=rel, tokens_equal=True,
                **runs), launches["flash"]


def phase_seqcache(torch, np, model) -> tuple[dict, list]:
    """SESSIONS flash prefills, packed and parked in a SequenceCache with
    8 sessions' pages of rows, TURNS turns of resume_many, DECODE_NEW dense
    decode tokens and park; on a cream (all-InterWrap) and a secded
    (all-SECDED) pool, against an uninterrupted decode of each session."""
    import dataclasses as dc

    from repro_torch.kernels import common
    from repro_torch.serve import SequenceCache, pack_tree, unpack_tree
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 17)
    model.attn_impl = "flash"
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                     # counts of the main path only
    t0 = time.perf_counter()
    blobs, first, spec = {}, {}, None
    for i in range(SESSIONS):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (1, SESSION_PROMPT)),
                                 device=DEVICE)
        logits, state = model.prefill_state(prompt, SESSION_MAX_LEN,
                                            logits_mode="last")
        first[f"q{i}"] = logits.argmax(-1).to(torch.int32)
        blobs[f"q{i}"], spec = pack_tree(state)
        del state
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(common.LAUNCHES)
    pages = session_pages(cfg)
    check(all(-(-b.numel() // (32 * W)) == pages for b in blobs.values()),
          "a session's pages differ from session_pages")
    want = {sid: [int(first[sid])] + greedy_decode(
        torch, model, unpack_tree(b, spec), first[sid], TURNS * DECODE_NEW)[0]
        for sid, b in blobs.items()}
    out = dict(sessions=SESSIONS, prompt=SESSION_PROMPT,
               max_len=SESSION_MAX_LEN, blob_bytes=blobs["q0"].numel(),
               pages_per_session=pages, rows=8 * pages, turns=TURNS,
               prefill_s=prefill_s, prefill_launches=prefill_launches)
    launches, tokens = [prefill_launches], {}
    for mode in ("cream", "secded"):
        cache = SequenceCache(8 * pages, mode, row_words=W, device=DEVICE)
        torch.cuda.synchronize()
        common.LAUNCHES.clear()                 # counts of the main path only
        t0 = time.perf_counter()
        last = dict(first)
        got = {sid: [int(tok)] for sid, tok in first.items()}
        clock = dict(park_s=0.0, decode_s=0.0)

        def timed(key: str, fn, *args):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = fn(*args)
            torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t1
            return r
        for sid, b in blobs.items():
            timed("park_s", cache.park, sid, b)
        for _ in range(TURNS):
            back = cache.resume_many(list(blobs))
            for sid in blobs:
                new, state = timed("decode_s", greedy_decode, torch, model,
                                   unpack_tree(back[sid], spec), last[sid],
                                   DECODE_NEW)
                got[sid] += new
                last[sid] = torch.as_tensor([new[-1]], dtype=torch.int32,
                                            device=DEVICE)
                timed("park_s", cache.park, sid, pack_tree(state)[0])
                del state
            del back
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.append(dict(common.LAUNCHES))
        tokens[mode] = got
        out[mode] = dict(device_pages=cache.device_capacity_pages,
                         used_pages=cache.vm.used_device_pages(),
                         **dc.asdict(cache.stats),
                         fault_rate=cache.stats.fault_rate, seconds=wall,
                         **clock, launches=launches[-1])
        del cache
        torch.cuda.empty_cache()
    check(tokens["cream"] == tokens["secded"] == want,
          "parked sessions decode other tokens than uninterrupted ones")
    c, s = out["cream"], out["secded"]
    check(c["device_pages"] > s["device_pages"],
          "cream must offer more device pages")
    check(c["host_hits"] == 0 and s["host_hits"] > 0,
          f"host hits cream {c['host_hits']} secded {s['host_hits']}")
    iw = ("interwrap_gather", "interwrap_scatter")
    check(all(c["launches"].get(k, 0) > 0 for k in iw),
          "the InterWrap kernels did not run on the cream pool")
    check(not any(s["launches"].get(k, 0) for k in iw),
          "the InterWrap kernels ran on the secded pool")
    return dict(out, tokens_equal=True), launches


# ---------------------------------------------------------------------------
# CREAM-Shard and the SECDED decode-on-load matrix product
# ---------------------------------------------------------------------------


def sharded_words(torch, np, rng, gen, S: int, rows: int, boundary: int):
    """(S, rows/S, 9, W) random words on the card whose SECDED rows (local
    rows boundary/S and up of every bank) carry valid codes, with
    plant_flips' single data-bit, code-bit and same-beat double flips."""
    from repro_torch.core import secded
    r_local, b_local = rows // S, boundary // S
    sto = torch.randint(-2**31, 2**31, (S, r_local, 9, W), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    n_sec = r_local - b_local
    data = sto[:, b_local:, :8].reshape(S * n_sec, 8 * W)
    codes = secded.encode_block(data)
    data, codes = plant_flips(data, codes, rng, n_each=max(1, S * n_sec // 8))
    sto[:, b_local:, :8] = data.view(S, n_sec, 8, W)
    sto[:, b_local:, 8] = codes.view(S, n_sec, W)
    return sto


def phase_routed_kernel(torch, np, dev) -> dict:
    """The router-fused mixed read over all banks in one launch: at the
    serve-shard pool (4 banks, 1600 rows, boundary 1280) on every page id,
    and at 16384 rows in 8 banks (boundary 8192) on every page id, with
    planted flips in the SECDED rows: bit-exact against the plain version.
    Timed on the serve-shard pool; the yardstick is the uncorrected
    advanced-indexing gather."""
    from repro_torch.core.layouts import (REGION_SECDED, Layout, page_coords,
                                          total_pages)
    from repro_torch.kernels.mixed import ops, ref
    from repro_torch.shard import router
    rng = np.random.default_rng(SEED + 15)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    D = 8 * W
    shapes = {}
    for name, S, rows, boundary in (
            ("serve_shard", SHARDS, NUM_ROWS, SHARD_BOUNDARY),
            ("large", ROUTED_SHARDS, ROUTED_ROWS, ROUTED_ROWS // 2)):
        sto = sharded_words(torch, np, rng, gen, S, rows, boundary)
        b_local = boundary // S
        n_pages = rows + S * (total_pages(Layout.INTERWRAP, b_local, W)
                              - b_local)
        ids = torch.as_tensor(rng.permutation(n_pages), dtype=torch.int32,
                              device=dev)
        args = (sto, ids, Layout.INTERWRAP, rows, boundary, S)
        got = ops.read_correct_routed(*args)
        err = words_err(got, ref.read_correct_routed(*args))
        shard, local = router.route(ids, rows, S)
        grow, lanes, region = page_coords(Layout.INTERWRAP, rows // S,
                                          b_local, local, W)
        grow = grow + (shard * (rows // S))[:, None]
        flat = sto.view(-1, 9, W)
        lib = lambda: flat[grow, lanes]  # noqa: E731  (yardstick only)
        plain = region != REGION_SECDED
        check(torch.equal(lib().reshape(-1, D)[plain], got[plain]),
              "indexing yardstick differs")
        n, n_sec = ids.numel(), int((~plain).sum())
        torch.cuda.synchronize()
        r = dict(banks=S, rows=rows, boundary=boundary, pages=n,
                 secded_pages=n_sec, max_abs_err=err)
        if name == "serve_shard":
            # each input read once: every page, and its code slice if
            # SECDED; every page written once; the ids
            r.update(ms=median_ms(lambda: ops.read_correct_routed(*args), 20),
                     plain_ms=median_ms(
                         lambda: ref.read_correct_routed(*args), 3),
                     library_ms=median_ms(lib, 20),
                     bound=bound_ms(4 * (2 * n * D + n_sec * W + n),
                                    48 * n_sec * D // 2))
        else:
            r.update(ms=median_ms(lambda: ops.read_correct_routed(*args), 5))
        shapes[name] = r
        del sto, ids, got, grow, lanes, region, flat
        torch.cuda.empty_cache()
    row = dict(shapes["serve_shard"], shapes=shapes,
               max_abs_err=max(r["max_abs_err"] for r in shapes.values()))
    check(row["max_abs_err"] == 0,
          "mixed_read_correct_routed disagrees with its plain version")
    return {"mixed_read_correct_routed": row}


def plant_ecc_flips(torch, np, bits, codes, rng, doubles: int):
    """Seeded faults in a protected matrix: one data-bit flip in
    ECC_FLIP_SHARE of its 64-bit beats (at most one a beat), one code-bit
    flip in ECC_CODE_SHARE of the others, and two mantissa-bit flips in
    ``doubles`` more (detected, uncorrectable: passed through, and finite).
    Returns the corrupted (bits, codes) and the number of each kind."""
    from repro_torch.kernels import common
    beats = bits.numel() // 2
    n_data = max(1, int(beats * ECC_FLIP_SHARE))
    n_code = max(1, int(beats * ECC_CODE_SHARE))
    n_data, n_code = min(n_data, beats // 2), min(n_code, beats // 4)
    doubles = min(doubles, beats - n_data - n_code)
    pick = rng.choice(beats, n_data + n_code + doubles, replace=False)
    data, code, dbl = np.split(pick, [n_data, n_data + n_code])
    bit = rng.integers(0, 64, n_data)
    words = [2 * data + bit // 32]
    masks = [np.left_shift(np.uint32(1), (bit % 32).astype(np.uint32))]
    # the doubles flip mantissa bits (bits 0..6 of a bf16), so the values
    # that pass through uncorrected stay finite
    mant = np.array([h * 16 + i for h in range(4) for i in range(7)])
    b1 = mant[rng.integers(0, len(mant), len(dbl))]
    b2 = mant[(np.searchsorted(mant, b1) + rng.integers(1, len(mant),
                                                        len(dbl)))
              % len(mant)]                                # a second bit
    for bb in (b1, b2):
        words.append(2 * dbl + bb // 32)
        masks.append(np.left_shift(np.uint32(1), (bb % 32).astype(np.uint32)))
    # fold the two flips of a double that land in one word into one mask
    w = np.concatenate(words)
    m = np.concatenate(masks).astype(np.uint32)
    order = np.argsort(w, kind="stable")
    w, m = w[order], m[order]
    start = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
    w, m = w[start], np.bitwise_xor.reduceat(m, start)
    bad = bits.clone()
    flat = bad.view(-1)
    idx = common.upload(w.astype(np.int64), bits.device)
    flat[idx] ^= common.upload(m.view(np.int32), bits.device)
    bad_codes = codes.clone()
    cbit = rng.integers(0, 8, len(code))
    cw = code // 4                                       # code word of a beat
    cm = np.left_shift(np.uint32(1),
                       (8 * (code % 4) + cbit).astype(np.uint32))
    order = np.argsort(cw, kind="stable")
    cw, cm = cw[order], cm[order]
    start = np.flatnonzero(np.r_[True, cw[1:] != cw[:-1]])
    cw, cm = cw[start], np.bitwise_xor.reduceat(cm, start)
    cflat = bad_codes.view(-1)
    cidx = common.upload(cw.astype(np.int64), codes.device)
    cflat[cidx] ^= common.upload(cm.view(np.int32), codes.device)
    return bad, bad_codes, dict(data_flips=int(n_data),
                                code_flips=int(n_code), doubles=int(len(dbl)))


def phase_ecc_kernel(torch, np, dev) -> dict:
    """The SECDED decode-on-load matrix product at ECC_SHAPES. With seeded
    single data-bit and code-bit flips planted (plant_ecc_flips) the
    product equals the kernel's product of the clean A bit for bit and is
    within 1e-5 of the output's scale (its largest magnitude) of the plain
    version (decode, then a float32 product); with uncorrectable doubles
    added as well, only the tolerance is held, the plain version passing
    them through the same way. Each design's time at each shape where it
    runs (the tiled product everywhere, the decode pass up to N = 16), the
    wrapper's pick as ``ms``, all on the clean weights (``ms_flipped``: the
    wrapper with the flips planted); the bound the larger of bytes over
    3.35 TB/s and flops over the card's dense bf16 tensor rate; beside it
    torch.matmul of the clean bf16 A (a library product, not a port), and
    the time of a one-element fill (the floor of this timing method). The
    tiled kernel's SASS must hold HGMMA (the tensor cores' wgmma). Below
    2**30 multiply-adds a B 2 bytes off alignment must give the same
    product."""
    from repro_torch.kernels import common
    from repro_torch.kernels.ecc_matmul import ops, ref
    sass = sass_loop_ops(common.BUILD_DIR / "ecc_matmul.o")
    tiled = [r for name, r in sass.items() if "ecc_matmul_tiled" in name]
    check(len(tiled) == 1 and "HGMMA" in tiled[0]["function_opcodes"],
          f"no HGMMA in the tiled kernel's SASS: "
          f"{[r['function_opcodes'] for r in tiled]}")
    rng = np.random.default_rng(SEED + 16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)

    def entry(name, bits, codes, b):
        m, n, k = bits.shape[0], b.shape[1], b.shape[0]
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        common.launch(name, bits, codes, b, out, m, n, k)
        return out

    shapes = {}
    for m, k, n in ECC_SHAPES:
        a = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        b = torch.randn((k, n), generator=gen, device=dev).bfloat16()
        bits, codes = ops.protect(a)
        bad, bad_codes, planted = plant_ecc_flips(torch, np, bits, codes,
                                                  rng, 0)
        got = ops.ecc_matmul(bad, bad_codes, b)
        clean = ops.ecc_matmul(bits, codes, b)
        want = ref.ecc_matmul(bad, bad_codes, b)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= 1e-5 * scale,
              f"ecc_matmul {m}x{k}x{n}: {err} off at scale {scale}")
        check(torch.equal(got, clean),
              f"ecc_matmul {m}x{k}x{n} did not correct the planted bits")
        bad2, bad2_codes, with_doubles = plant_ecc_flips(
            torch, np, bits, codes, rng, ECC_DOUBLES)
        got2 = ops.ecc_matmul(bad2, bad2_codes, b)
        want2 = ref.ecc_matmul(bad2, bad2_codes, b)
        torch.cuda.synchronize()
        scale2 = float(want2.abs().max())
        err2 = float((got2 - want2).abs().max())
        check(bool(torch.isfinite(got2).all()) and err2 <= 1e-5 * scale2,
              f"ecc_matmul {m}x{k}x{n} with doubles: {err2} off at scale "
              f"{scale2}")
        if m * n * k < 2**30:
            # B 2 bytes off 16-byte alignment: no TMA, no 16-byte loads
            buf = torch.empty(k * n + 8, dtype=torch.bfloat16, device=dev)
            b_off = buf[1:1 + k * n].view(k, n)
            b_off.copy_(b)
            check(torch.equal(ops.ecc_matmul(bad, bad_codes, b_off), got),
                  f"ecc_matmul {m}x{k}x{n} with an unaligned B differs")
            del buf, b_off
        designs = {"tiled": "ecc_matmul_tiled"}
        if ops.uses_decode(k, n):
            designs["decode"] = "ecc_matmul_decode"
        times = {}
        for design, name in designs.items():
            other = entry(name, bad, bad_codes, b)
            torch.cuda.synchronize()
            check(torch.equal(other, got) or float(
                (other - want).abs().max()) <= 1e-5 * scale,
                f"ecc_matmul {design} {m}x{k}x{n} disagrees")
            times[design] = median_ms(lambda: entry(name, bits, codes, b), 20)
        nbytes = 4 * (m * k // 2 + m * k // 16) + 2 * k * n + 4 * m * n
        # times on the clean protected weights (errors are rare in use);
        # with the planted flips beside them
        shapes[f"{m}x{k}x{n}"] = dict(
            m=m, k=k, n=n, max_abs_err=err, scale=scale,
            max_abs_err_with_doubles=err2, planted=planted,
            planted_with_doubles=with_doubles,
            design="decode" if ops.uses_decode(k, n) else "tiled",
            ms=median_ms(lambda: ops.ecc_matmul(bits, codes, b), 20),
            ms_flipped=median_ms(lambda: ops.ecc_matmul(bad, bad_codes, b),
                                 20),
            design_ms=times,
            plain_ms=median_ms(lambda: ref.ecc_matmul(bits, codes, b), 3),
            library_ms=median_ms(lambda: torch.matmul(a, b), 20),
            bound=bound_ms(nbytes, 2 * m * n * k, BF16_FLOPS_S))
        del a, b, bits, codes, bad, bad_codes, bad2, bad2_codes
        del got, clean, want, got2, want2
        torch.cuda.empty_cache()
    # the floor of this timing method: one launch of a one-element fill
    one = torch.empty(1, device=dev)
    floor_ms = median_ms(lambda: one.fill_(1.0), 20)
    first = shapes["x".join(map(str, ECC_SHAPES[0]))]
    return {"ecc_matmul": dict(first, shapes=shapes,
                               launch_floor_ms=floor_ms,
                               max_abs_err=max(r["max_abs_err"]
                                               for r in shapes.values()))}


def phase_ecc_mlp(torch, np, dev) -> tuple[dict, dict]:
    """ecc_matmul's own path: one qwen3-0.6b SwiGLU MLP (gate and up
    1024 -> 3072, down 3072 -> 1024) with SECDED-protected bf16 weights,
    applied feature-major to a 4096-token prefill and to the 4-token
    decode batch, three ecc_matmul launches each; each product within 1e-5
    of its scale against the plain version on the same inputs."""
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.kernels import common
    from repro_torch.kernels.ecc_matmul import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    d, f = CONFIG.d_model, CONFIG.d_ff
    weights = {name: ops.protect((torch.randn(shape, generator=gen,
                                              device=dev)
                                  / shape[1] ** 0.5).bfloat16())
               for name, shape in (("gate", (f, d)), ("up", (f, d)),
                                   ("down", (d, f)))}
    xs = [torch.randn((d, t), generator=gen, device=dev).bfloat16()
          for t in ECC_TOKENS]
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of this path only
    t0 = time.perf_counter()
    outs = []
    for x in xs:
        g = ops.ecc_matmul(*weights["gate"], x)
        u = ops.ecc_matmul(*weights["up"], x)
        h = (torch.nn.functional.silu(g) * u).bfloat16()
        outs.append((x, g, u, h, ops.ecc_matmul(*weights["down"], h)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    errs = []
    for x, g, u, h, y in outs:
        for got, (name, inp) in ((g, ("gate", x)), (u, ("up", x)),
                                 (y, ("down", h))):
            want = ref.ecc_matmul(*weights[name], inp)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= 1e-5 * scale,
                  f"ecc-mlp {name}: {err} off at scale {scale}")
            errs.append(err / scale)
    check(launches.get("ecc_matmul", 0) == 3 * len(ECC_TOKENS),
          f"ecc_matmul launches {launches}")
    return dict(tokens=list(ECC_TOKENS), seconds=wall,
                max_rel_err=max(errs), launches=launches), launches


def shard_sequence(torch, np, device) -> dict:
    """One seeded sequence of CREAM-Shard operations on a 4-bank pool of
    64 global rows (W 64) on ``device``; returns what it saw as numpy."""
    from repro_torch.core.injection import FaultModel
    from repro_torch.core.layouts import Layout
    from repro_torch.kernels.common import to_u32, to_words
    from repro_torch.shard import make_sharded_pool
    rng = np.random.default_rng(SEED + 18)
    pool = make_sharded_pool(64, Layout.INTERWRAP, 32, num_shards=4,
                             row_words=64, device=device)
    seen = {}
    n = pool.num_pages
    ids = np.concatenate([rng.permutation(n), rng.integers(0, n, 11)])
    data = rng.integers(0, 2**32, (ids.size, pool.page_words),
                        dtype=np.uint32)
    pool = pool.write(ids, to_words(data).to(device),
                      valid=rng.random(ids.size) < 0.9)
    every = rng.permutation(n)

    def look(tag):
        seen[f"{tag}/storage"] = to_u32(pool.storage)
        live = every[every < pool.num_pages]
        seen[f"{tag}/read"] = to_u32(pool.read(live))
        d, st = pool.read(live, status=True)
        seen[f"{tag}/read_status"] = to_u32(d)
        seen[f"{tag}/status"] = st.cpu().numpy()

    look("write")
    model = FaultModel.make(SEED + 18, soft_rate=1e5, n_hard=2,
                            shape=(64, 9, 64))
    pool, flips = model.step_pool(pool)
    seen["flips"] = np.asarray(flips)
    look("inject")
    pool = pool.migrate([1, 6, 64, 40, 3], [2, 8, 67, 45, 7])
    look("migrate")
    pool, info = pool.move_boundary(0)
    seen["evicted_down"] = np.asarray(info["evicted_extra_pages"])
    look("down")
    pool, info = pool.move_boundary(32)
    seen["evicted_up"] = np.asarray(info["evicted_extra_pages"])
    look("up")
    pool = pool.set_daec_rows(8)
    look("daec")
    pool, stats = pool.scrub()
    seen["census"] = np.asarray([v if k != "corrupt_rows" else len(v)
                                 for k, v in vars(stats).items()])
    seen["corrupt_rows"] = np.asarray(stats.corrupt_rows)
    look("scrub")
    return seen


def phase_shard_reference(torch, np) -> dict:
    """shard_sequence on the card and on the CPU: identical storage, reads,
    statuses, censuses and evicted ids at every stage."""
    card = shard_sequence(torch, np, DEVICE)
    cpu = shard_sequence(torch, np, "cpu")
    check(card.keys() == cpu.keys(), "shard-reference stages differ")
    for key in cpu:
        check(np.array_equal(card[key], cpu[key]),
              f"shard-reference: {key} differs between card and CPU")
    return dict(stages=sorted({k.split("/")[0] for k in cpu if "/" in k}),
                flips=int(cpu["flips"]),
                statuses=sorted(set(cpu["inject/status"].tolist())),
                census=cpu["census"].tolist(), identical=True)


def _merged(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _meet_us(x: list, y: list) -> float:
    """Length of the intersection of two merged span lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        total += max(0.0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_overlap(prof, tag: str) -> dict:
    """Device spans of a profiled migration step, by CUDA stream, read from
    its trace (written under build/): the stream with the most kernels runs
    the model step, every other one the migration. Returns the migration's
    busy ms, the ms of it during which a model-stream kernel ran too, and
    the share of it inside the model stream's first-to-last span; "not
    measured" when the trace holds no second stream."""
    from repro_torch.kernels import common
    path = common.BUILD_DIR / f"migration_step_{tag}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    spans: dict = {}
    for e in json.loads(path.read_text()).get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            stream = e.get("args", {}).get("stream", e.get("tid"))
            spans.setdefault(stream, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["cat"] == "kernel"))
    if len(spans) < 2:
        return dict(overlap="not measured", streams=len(spans))
    main = max(spans, key=lambda st: sum(k for *_, k in spans[st]))
    model = _merged([(a, b) for a, b, _ in spans[main]])
    side_ev = [sp for st, v in spans.items() if st != main for sp in v]
    side = _merged([(a, b) for a, b, _ in side_ev])
    side_us = sum(b - a for a, b in side)
    window = [[model[0][0], model[-1][1]]]
    return dict(streams=len(spans), model_events=len(spans[main]),
                migration_events=len(side_ev),
                migration_kernels=sum(k for *_, k in side_ev),
                model_busy_ms=sum(b - a for a, b in model) / 1e3,
                model_span_ms=(window[0][1] - window[0][0]) / 1e3,
                migration_busy_ms=side_us / 1e3,
                concurrent_ms=_meet_us(side, model) / 1e3,
                concurrent_share=_meet_us(side, model) / side_us,
                inside_step_share=_meet_us(side, window) / side_us)


def migration_step(torch, np, eng, src, dst, vpns, moving,
                   profiled: bool) -> tuple[list, dict | None]:
    """Write ``moving`` into tenant "mig"'s pages ``vpns`` (at ``src``),
    queue ``src -> dst`` with schedule_migration and poll until a decode
    step has run it (under torch.profiler when ``profiled``); ``dst`` must
    then read ``moving`` back. The read-back's launches are not counted.
    Returns the finished requests and the step's stream overlap."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import common
    eng.vm.write("mig", vpns, moving)
    eng.schedule_migration(src, dst)
    done = []
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if profiled else contextlib.nullcontext()) as prof:
        while eng._pending_migration is not None:
            check(eng.sched.has_work(), "no decode step left to migrate in")
            done.extend(eng.poll())
        torch.cuda.synchronize()
    counts = dict(common.LAUNCHES)
    check(torch.equal(eng.pool.read(dst), moving),
          "migrated pages do not read back intact")
    common.LAUNCHES.clear()
    common.LAUNCHES.update(counts)
    return done, prof and stream_overlap(prof, type(eng.pool).__name__)


def phase_serve_shard(torch, np, tok_c) -> tuple[dict, dict]:
    """The serve phases' requests on a pool added with shards=SHARDS: 1600
    global rows in 4 banks, InterWrap, boundary 1280 (1760 pages). Every
    step's gather is one mixed_read_correct_routed launch; at decode steps
    MIG_AT_STEP, twice and three times that, a schedule_migration of
    MIG_PAGES pages held by a tenant of their own (no decode sequence's),
    each to another bank, runs on a second stream beside that step's
    model compute and reads back unchanged (fresh contents each time). The
    first warms the stream up, the second is timed, the third traced
    (stream_overlap)."""
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core.layouts import Layout
    from repro_torch.kernels import common
    from repro_torch.serve import Engine
    from repro_torch.shard import ShardedPool, route_np
    from repro_torch.vm import VirtualMemory
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    vm = VirtualMemory(row_words=W, device=DEVICE)
    pool = vm.add_pool("kv", NUM_ROWS, Layout.INTERWRAP,
                       boundary=SHARD_BOUNDARY, shards=SHARDS)
    check(isinstance(pool, ShardedPool), "no sharded pool")
    eng = Engine(cfg, max_batch=B, max_len=MAX_LEN, vm=vm, pool="kv",
                 seed=SEED)
    vm.create_tenant("mig")
    vpns = vm.alloc("mig", 2 * MIG_PAGES, allow_host=False)
    check(vpns is not None, "no frames for the migration")
    phys = [vm.translate("mig", v).phys for v in vpns]
    src = phys[:MIG_PAGES]
    dst = phys[MIG_PAGES + 1:] + phys[MIG_PAGES:MIG_PAGES + 1]
    check((route_np(src, NUM_ROWS, SHARDS)[0]
           != route_np(dst, NUM_ROWS, SHARDS)[0]).all(),
          "a migrated page stays in its bank")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    plan = [(k * MIG_AT_STEP, torch.randint(-2**31, 2**31, (MIG_PAGES, 8 * W),
                                            generator=gen, device=DEVICE,
                                            dtype=torch.int32), k == 3)
            for k in (1, 2, 3)]
    reqs = requests(np, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    gathers, step_s = [], []
    gather, step = eng._gather_pages, eng.step

    def counted_gather(phys_ids):
        before = dict(common.LAUNCHES)
        out = gather(phys_ids)
        gathers.append(tuple(common.LAUNCHES.get(k, 0) - before.get(k, 0)
                             for k in ("mixed_read_correct_routed",
                                       "mixed_read_correct")))
        return out

    def timed_step():
        t = time.perf_counter()
        out = step()
        step_s.append(time.perf_counter() - t)
        return out

    eng._gather_pages, eng.step = counted_gather, timed_step
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    t0 = time.perf_counter()
    done, mig_steps, overlap = [], [], None
    while eng.sched.has_work():
        if plan and eng.steps >= plan[0][0]:
            _, moving, profiled = plan.pop(0)
            mig_steps.append(eng.steps)
            finished, traced = migration_step(torch, np, eng, src, dst,
                                              vpns[:MIG_PAGES], moving,
                                              profiled)
            done.extend(finished)
            overlap = traced or overlap
        else:
            done.extend(eng.poll())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    tokens = [r.generated for r in reqs]
    check(len(done) == len(reqs), "requests unfinished")
    check(tokens == tok_c, "serve-shard tokens differ from serve-cream's")
    check(len(gathers) == eng.steps and set(gathers) == {(1, 0)},
          f"gathers per step: {sorted(set(gathers))} over {len(gathers)}")
    check(not plan and len(mig_steps) == 3, f"migrations run: {mig_steps}")
    n_tok = sum(len(t) for t in tokens)
    plain = [t for i, t in enumerate(step_s) if i not in mig_steps]
    return dict(rows=NUM_ROWS, banks=SHARDS, boundary=SHARD_BOUNDARY,
                device_pages=pool.num_pages, tokens=n_tok,
                tokens_per_s=n_tok / wall, wall_s=wall,
                decode_steps=eng.steps,
                step_ms_median=statistics.median(plain) * 1e3,
                migration_steps=mig_steps,
                migration_step_ms=[step_s[i] * 1e3 for i in mig_steps],
                migration_overlap=overlap,
                migrated_pages=MIG_PAGES, migrated_intact=True,
                tokens_equal=True,
                preemptions=eng.sched.stats.get("preemptions"),
                launches=launches), launches


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
    global INT_OPS_S, FP32_FLOPS_S, BF16_FLOPS_S
    rate = int_rate(torch)
    INT_OPS_S, FP32_FLOPS_S = rate["int_ops_s"], rate["fp32_flops_s"]
    BF16_FLOPS_S = rate["bf16_flops_s"]
    # one loop iteration handles one packed code word: two superbeats
    sass = {re.search(r"daec_(encode|decode)_kernel", name)[1]: r
            for name, r in sass_loop_ops(common.BUILD_DIR / "daec.o").items()}
    DAEC_OPS.update({k: r["alu"] / 2 for k, r in sass.items()})
    check(set(DAEC_OPS) == {"encode", "decode"}, f"daec SASS {list(sass)}")
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              sources=list(common.SOURCES), int_rate=rate,
              daec_sass_per_loop=sass, daec_ops_per_superbeat=DAEC_OPS,
              ptxas=[ln.strip() for ln in log.splitlines()
                     if "registers" in ln]))

    def phase(name: str, result: dict) -> None:
        emit(dict(phase=name, elapsed_s=time.perf_counter() - t0, **result))

    kern = phase_kernels(torch, np, dev)
    kern["kernels"].update(phase_cache_kernels(torch, np, dev))
    kern["kernels"].update(phase_interwrap_kernels(torch, np, dev))
    kern["kernels"].update(phase_flash_kernel(torch, np, dev))
    kern["kernels"].update(phase_routed_kernel(torch, np, dev))
    kern["kernels"].update(phase_ecc_kernel(torch, np, dev))
    phase("kernels", kern)
    ecc_mlp, l_em = phase_ecc_mlp(torch, np, dev)
    phase("ecc-mlp", ecc_mlp)
    phase("reference", phase_reference(torch, np))

    eng, tok_c, st_c, l_c, _, wall_c = serve_phase(torch, np, "cream")
    phase("serve-cream", summary(st_c, l_c, wall_c))
    phase("profile", phase_profile(torch, np, eng))
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
    phase("serve-secded", dict(tokens_equal=True, rows_clean=True,
                               **summary(st_s, l_s, wall_s)))
    del eng, pool
    torch.cuda.empty_cache()

    eng, tok_r, st_r, l_r, info, wall_r = serve_phase(torch, np, "cream",
                                                      repartition=True)
    check(info is not None and info["migrated"] > 0, "no page migrated")
    check(l_r.get("migrate_gather_encode", 0) > 0, "no gather_encode launch")
    check(tok_r == tok_c, "repartition changed the tokens")
    phase("serve-repartition", dict(tokens_equal=True, repartition=info,
                                    **summary(st_r, l_r, wall_r)))
    del eng
    torch.cuda.empty_cache()

    phase("shard-reference", phase_shard_reference(torch, np))
    shard, l_ss = phase_serve_shard(torch, np, tok_c)
    phase("serve-shard", shard)
    torch.cuda.empty_cache()

    phase("cache-reference", phase_cache_reference(torch, np))
    zipf, l_z, pcache = phase_cache_replay(torch, np, "zipf")
    phase("cache-zipf", dict(rows=CACHE_ROWS, row_words=W,
                             accesses=CACHE_ACCESSES, configs=zipf))
    phase("cache-profile", phase_cache_profile(torch, np, pcache))
    del pcache
    torch.cuda.empty_cache()
    web, l_w, _ = phase_cache_replay(torch, np, "websearch")
    phase("cache-websearch", dict(rows=CACHE_ROWS, row_words=W,
                                  accesses=CACHE_ACCESSES, configs=web))
    dem, l_d = phase_cache_demotion(torch, np)
    phase("cache-demotion", dem)
    adapt, l_a = phase_cache_adapt(torch, np)
    phase("cache-adapt", adapt)
    camp, l_cs = phase_campaign_serve(torch, np, tok_c)
    phase("campaign-serve", camp)
    torch.cuda.empty_cache()
    camp, l_cd = phase_campaign_daec(torch, np)
    phase("campaign-daec", camp)
    torch.cuda.empty_cache()

    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(CONFIG, dtype="float32"),
                        attn_impl="flash", seed=SEED, device=DEVICE)
    long_ctx, l_pl = phase_prefill_long(torch, np, model)
    phase("prefill-long", long_ctx)
    seq, l_sq = phase_seqcache(torch, np, model)
    phase("seqcache", seq)
    del model
    main_paths = [l_c, l_s, l_r, l_ss, *l_z.values(), *l_w.values(), l_d,
                  l_a, l_cs, l_cd, l_pl, *l_sq, l_em]
    # a PARITY pool's write is one parity8_write; the standalone encode
    # keeps the TPU kernel's contract and is on no main path
    check(not any(l.get("parity8_encode") for l in main_paths),
          "a main-path phase launched the standalone parity8_encode")
    check(any(l.get("parity8_write") for l in main_paths),
          "no main-path phase launched parity8_write")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: " + smi.stderr.strip(), flush=True)
    line = []
    for name, (source, replaces) in KERNELS.items():
        r = kern["kernels"][name]
        bms, by = r["bound"][:2]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(l.get(name, 0) for l in main_paths),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=bms, bound_by=by, library_ms=r["library_ms"]))
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
