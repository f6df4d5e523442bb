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
 21. regions-reference  examples/adaptive_reliability.py's 8 epochs (64/64/32
                  rows at W = 256, its monitor settings, FaultModel seed 0 at
                  2000 flips/GB a step on database from epoch 3) through a
                  RegionManager on the card and one on the CPU in lockstep:
                  the example's transitions (epoch 1 batch_kv and database
                  SECDED -> PARITY, epoch 3 batch_kv -> NONE and database ->
                  SECDED) and capacities (160, 172, 168 pages), identical
                  capacity reports, evictions and storage every epoch;
 22. regions      the same regions at 65536/65536/16384 rows (1.36 GB on the
                  card), seeded values in every page: the same transitions,
                  capacity up then down, every page of batch_kv and
                  hypervisor reads back its value, the scrub, parity8 check,
                  parity8_write and InterWrap kernels launched; median
                  seconds of scrub_all and of adapt an epoch;
 23. writeback    read_writeback on a SECDED pool, one with a DAEC tier, a
                  PARITY pool and a 4-bank pool (64 rows of W = 2048) with
                  planted single flips and one double: the first read
                  reports them, the second only the double; data, status
                  and storage equal the CPU port's after each read;
 24. launch-serve  repro_torch.launch.serve's main at --arch qwen3-0.6b
                  --smoke --secded-rows 24 on the card and with --device
                  cpu: equal JSON but for times (the reference's defaults
                  deadlock under --smoke: 16 paid-tier SECDED rows hold no
                  paid request's 18 pages), one mixed read a decode step;
 25. serve-starcoder2  starcoder2-7b from the registry at full width and
                  depth in float32 (32 layers, d 4608, 36/4 heads of 128,
                  GELU, vocab 49152; ~26.7 GiB of seeded weights) serving
                  the serve requests on 968 rows (all KV fits in cream mode,
                  not in secded): equal tokens in both, the first
                  request's equal to a dense greedy decode by forward, more
                  pages in cream, preemptions in secded, one mixed read a
                  step, 256 pool pages held against the plain read; a
                  decode-step profile as phase 5's and the step's host
                  time split by span (as phase 27's);
 26. serve-musicgen  musicgen-large the same way in cream mode only (48
                  layers, d 2048, 32/32 heads of 64, vocab 2048; ~9 GiB; 4
                  KV tokens a page): every request's tokens equal a dense
                  greedy decode.
 27. telemetry    (run after phase 7) serve-cream and serve-secded again
                  with the metrics, tracing and CREAM-Lens planes on: the
                  planes-off tokens; the decode-step, prefill and
                  tokens-by-tier counters equal to the engine's own counts;
                  every (class, status) read-status series; the capacity
                  gauges and the SLO tracker's entry equal to the pool's
                  capacity_report; the step's spans, one gather span a
                  decode step, and a Perfetto export that loads; one
                  decode gather a step in CREAM-Lens, and exactly one
                  decode gather and one scatter a step over a full batch.
                  On the cream engine one full-batch step with planes
                  off and one with metrics on, their operations counted
                  at PyTorch's dispatcher: metrics on must add exactly
                  the status read's zeroing, the count reduction and the
                  counts' copy (the eight FOLD_OPS device operations)
                  and two views, and make one mixed-read launch; then,
                  printed and not gated, the step's host time split by
                  its blocking spans (medians of PROFILE_STEPS steps) and
                  the planes' overhead (interleaved windows off / metrics
                  / all: medians and spread). On the secded engine single-bit
                  flips in 16 pages the next step reads: the folded
                  secded/corrected count equals the card's status read of
                  the same ids; then one double-bit flip: one
                  uncorrectable, and the secded SLO breached. Last the
                  serve requests on serve-shard's pool (4 banks) with
                  metrics on, the first on the paid tier: every step's
                  metrics-on gather one mixed_read_correct_routed launch
                  (its status output) with no bank-by-bank secded_decode,
                  its folded counts equal to a bank-by-bank status read of
                  the same ids (with single-bit flips planted in 16 SECDED
                  pages a step reads), the planes-off tokens.
 28. softecc      SoftECC (the Virtualized-ECC baseline): one seeded
                  write / flip / read / scrub sequence on a 72-row pool on
                  the card and on the CPU, bit for bit; then 16380 rows of
                  W = 2048 (the cache phases' 16384 cut to a multiple of 9)
                  on the card: every page written, 16 single-bit flips in
                  data rows and code slices, a scrub whose census is the
                  planted flips and whose storage is the unflipped pool's;
                  the per-layout DRAM operations of plan_line_access /
                  count_device_ops and plan_line_ops over a seeded trace;
 29. train-reference  tests/test_fault_tolerance.py's TINY config (float32)
                  trained 4 steps through the port's Trainer on the card
                  and the CPU from the same weights and batches: losses and
                  grad norms within 1e-4 relative, warm restores
                  bit-identical, a checkpoint round trip bit-exact on the
                  card and restored on the CPU;
 30. train        qwen3-0.6b from the registry at full width (28 layers,
                  d 1024, vocab 151936, bfloat16, 596.0 M parameters)
                  trained through repro_torch.launch.train.main in-process
                  (20 steps, sequence 128, batch 8, saves at 10 and 20),
                  then the launcher again on the same directory (resumed at
                  step 20, one step), then the recovery ladder on a
                  make_trainer of the same config: 5 flips in the 5.00 GiB
                  moment pool corrected by the scrub kernel, a warm restart
                  with the moments bit-identical, a targeted restore and a
                  cold restart; the pool's kernels held against their plain
                  versions at its full 582,080 rows, chunk by chunk on the
                  card: the snapshot's code lane against the plain encode,
                  the rung-1 scrub's storage and per-beat status against
                  the plain sweep of the flipped pool, and the warm
                  restore's decode (at its shape, over the flipped pool)
                  against the plain decode; step ms, tokens/s (all timed
                  steps' tokens over their summed times), peak memory,
                  snapshot and scrub ms, each save's and restore's seconds
                  and size;
 31. train-lm     examples/train_lm.py's scenario: the 110 M float32 LM with
                  batch 4 (microbatch 2, remat "block"), 5 flips in the
                  moment pool at mid-run corrected by the scrub (its
                  storage and status equal to the plain sweep's), the loss
                  before and after.
 32. serve-olmoe  (run after phase 26) olmoe-1b-7b from the registry at full
                  width and depth in float32 (16 layers, d 2048, 16 heads
                  of 128 with qk-norm, 64 experts of d_ff 1024, top 8;
                  25.78 GiB of seeded weights) serving the serve requests
                  in cream and secded mode on rows that hold every
                  session (neither preempts): equal tokens, one mixed read
                  a step, every SECDED row decoding clean afterwards;
                  request 0 served alone in slot 0 equal to the dense KV
                  decode at batch 1 (its routing is the batch of one's:
                  slot 0's choices come first, and the capacity is 1 in
                  both); a decode-step profile with the MoE mixers (and
                  their expert products, aten::bmm) and the attention
                  blocks in profiler ranges; then a secded run on kv_rows
                  rows that preempts, its tokens not compared (an MoE
                  token's output depends on who shares its step);
 33. olmoe-reference  olmoe-1b-7b at full width, depth cut to 2 layers:
                  the serve requests through the engine on the card and
                  on the CPU from the same weights: identical tokens, the
                  last decode step's logits within 1e-4;
 34. decode-xlstm xlstm-1.3b at full width and depth in float32 (48 blocks,
                  7 mLSTM + 1 sLSTM a period; 7.24 GiB): 4 prompts of 32
                  tokens and 16 greedy tokens through prefill_state and
                  decode_step, equal to the parallel-form forward rerun on
                  the grown sequence (logits within 1e-2 of their scale:
                  float32 rounding grows with depth and steps), the
                  decode state's bytes constant; one period (8 blocks) at
                  full width on the card and the CPU from the same
                  weights: equal tokens, logits within 1e-4 of their
                  scale;
 35. families-smoke  olmoe, kimi-k2, jamba and xlstm at smoke():
                  repro_torch.launch.train --smoke for 3 steps each
                  (finite losses); repro_torch.launch.serve --smoke
                  --secded-rows 24 for the two MoE configs on the card and
                  the CPU (equal JSON but times, one mixed read a step);
                  jamba's dense decode on the card equal to the CPU's
                  (tokens, logits within 1e-4).
 36. roofline     (run last) (a) python -m repro_torch.launch.dryrun for
                  qwen3-0.6b's decode_32k and train_4k cells on the fake
                  (16, 16) mesh, each in a process of its own: ok, with
                  positive per-device FLOPs, bytes and collective wire
                  bytes; (b) python -m repro_torch.roofline.analysis over
                  those records; (c) the card's own floors beside steps
                  the script runs: qwen3-0.6b's full-batch serve decode
                  step (phase 5) and olmoe-1b-7b's (phase 32), each
                  counted once more after its profile by the same
                  counter (CostCounter, one rank), and qwen3-0.6b's
                  bfloat16 train step (the launcher's step function at
                  its defaults, from fresh weights): FLOPs and bytes,
                  MODEL_FLOPS, the compute and memory terms over the
                  H100's rates, the measured device time and host-clock
                  step beside the floor, roofline_frac. These extra steps
                  launch nothing the kernels line counts.
 37. mesh         (run after phase 20; ``chip_phases.py mesh`` alone) N =
                  the cards, at most 4, ranks under ``python -m
                  torch.distributed.run --nproc-per-node N`` in an NCCL
                  group, one card a rank: serve-shard's requests and
                  geometry on a pool of N banks, one a rank (the mesh
                  read: one shard-local routed launch and one all-reduce
                  a gather; three 64-page migrations across banks over
                  the ring beside a step when N > 1), and the same on one
                  card in this process first: rank 0 gathers the banks,
                  tokens and every bank's storage equal the one-card
                  pool's, every rank's tokens equal; each rank's median
                  step and the step's all-reduce timed alone beside it.
                  With N = 4 also qwen3-0.6b trained data-parallel by the
                  launcher on the (4, 1) host mesh (20 steps, batch 8,
                  sequence 128, bfloat16), after a one-card run here: the
                  losses within 2e-2 relative of the one-card run's, the
                  parameters bit-identical across the ranks, each rank's
                  step time, tokens/s and gradient all-reduce.

 38. surface      (run after phase 31) the names that complete the
                  reference's surface: read_pool and lookup_pool on the
                  serve pool's geometry, repro_torch.shard's write_any /
                  read_any / read_any_status / read_any_writeback on
                  serve-shard's (and with a DAEC tier), bit-exact against
                  their plain versions on CPU copies and the pools'
                  methods; the functional init_params -> prefill -> 8 x
                  decode_step of qwen3-0.6b (float32, 4 sequences) with
                  the Transformer methods' tokens, both timed; the seven
                  examples' main on the card, each printing the lines of
                  a CPU run of the same example made in a subprocess
                  during the phase (clock numbers and train_lm's losses
                  masked).
 39. widths       (run after phase 23) pools whose row width W is not a
                  multiple of 8, where the pool kernels take their word
                  paths (the `_words` C entries): (a) each of them
                  (mixed read, its routed and shard-local forms, hash,
                  migrate, scrub, InterWrap gather and scatter) and the
                  SECDED / DAEC codecs at W = 7, 12 and 60 bit-exact
                  against its plain version on CPU copies, with SECDED
                  flips in 1 % of the beats (statuses 0, 1 and 2 seen),
                  on storage one row into its buffer (off a 16-byte
                  boundary at W = 7, as a caller's row view may be);
                  (b) pools of the four layouts at boundary R/2 with and
                  without a 32-row DAEC tier, a whole-InterWrap pool, two
                  4-bank pools and a VM repartitioned mid-run (extra pages
                  migrated) and back, at W = 7 and 60: write -> flips ->
                  status read -> migrate -> scrub -> status read, every
                  result equal to the CPU's bit for bit; (c) every kernel
                  wrapper and every sharded-pool read and migration at n =
                  0: the CPU's shapes and dtypes, no launch; (d) each word
                  path timed (median of 20 behind the device sleep) on
                  4096 pages of a ~1 GiB pool at W = 60 and 7 beside its
                  byte bound.

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
mixed read's status output (the metrics-on decode gather: the page's
worst SECDED status from the same launch) on the mixed pool with its
planted flips, data and status bit-exact, every status present, timed
with the wrapper's zero fill beside the data-only read. It holds the
router-fused mixed read bit-exact on every page id of the serve-shard
pool and of a 16384-row pool in 8 banks, with planted flips, and its
status output on the serve-shard pool (data and status bit-exact, every
status present, timed beside the status-free launch); its shard-local
form (one bank and its index, the other banks' rows zero: the mesh
read's launch) on every bank of the serve-shard pool, with and without
status, bit-exact, the banks' shares summing to the all-banks read; and
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
with its launches on the serve, serve-shard, cache, campaign, regions,
writeback, widths, launch-serve, starcoder2, musicgen, olmoe, xlstm,
families-smoke, prefill-long, seqcache, ecc-mlp, telemetry, softecc,
train, train-lm, mesh and surface phases (the mesh's summed over its
ranks) and
its phase-2 numbers,
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
REGION_EPOCHS = 8          # examples/adaptive_reliability.py's epochs
#: rows of the regions phase's batch_kv, database and hypervisor regions
#: at the RegionManager's W = 256: 1.36 GB of storage on the card
REGION_ROWS = (65536, 65536, 16384)
WB_ROWS = 64               # rows of each write-back pool at W
POOL_CHECK_PAGES = 256     # serve-pool pages held against the plain read
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
    "mixed_read_correct_routed_local": (
        "src/repro_torch/csrc/mixed.cu",
        "src/repro/kernels/mixed/kernel.py:139"),
    "ecc_matmul": ("src/repro_torch/csrc/ecc_matmul.cu",
                   "src/repro/kernels/ecc_matmul/kernel.py:61"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def uncounted():
    """Launches inside are a check's (a kernel run again beside its plain
    version), not the main path's: the launch counts are put back after."""
    from repro_torch.kernels import common
    saved = dict(common.LAUNCHES)
    try:
        yield
    finally:
        common.LAUNCHES.clear()
        common.LAUNCHES.update(saved)


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
    # the status output (the metrics-on decode gather) on the same pool:
    # data and per-page worst status bit-exact, every status present
    st_k = mixed_ops.read_correct(*mix_args, status=True)
    st_p = mixed_ref.read_correct(*mix_args, status=True)
    torch.cuda.synchronize()
    st_counts = torch.bincount(st_k[1], minlength=4).tolist()
    check(all(st_counts), f"mixed read statuses {st_counts}")
    status_variant = dict(
        max_abs_err=max_abs_err(st_k, st_p), status_pages=st_counts,
        ms=median_ms(lambda: mixed_ops.read_correct(*mix_args, status=True),
                     20),
        plain_ms=median_ms(
            lambda: mixed_ref.read_correct(*mix_args, status=True), 3),
        data_only_ms=mixed_ms,
        bound=bound_ms(4 * ((u_ids.numel() + n) * D + 2 * n + n_sec * W),
                       48 * n_sec * D // 2))
    check(status_variant["max_abs_err"] == 0,
          "mixed read with status disagrees with its plain version")

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
                            48 * n_sec * D // 2)[0]),
        status_variant=status_variant)

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
    for key, cls in (("nccl", "collective"),
                     ("hash_lookup_read", "hash probe+gather"),
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


def decode_profile(torch, np, eng, ranges: tuple = (),
                   count: bool = False) -> dict:
    """Where a decode step's time goes: PROFILE_STEPS decode steps of the
    engine with every slot busy, timed on the host clock without the
    profiler, then again under ``torch.profiler`` for device kernel time by
    kernel and by class, and the device's busy share of the window (and
    the device time inside each profiler range of ``ranges``, see
    :func:`range_device_ms`); with ``count``, one more step under the
    roofline's CostCounter (its launches not counted). The B requests it
    submits are left running."""
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
    out = dict(steps=PROFILE_STEPS, batch=B,
               step_ms=plain_ms / PROFILE_STEPS,
               profiled_step_ms=prof_ms / PROFILE_STEPS,
               **device_breakdown(prof, prof_ms, PROFILE_STEPS,
                                  skip=ranges))
    if ranges:
        out.update(range_device_ms(prof, ranges, PROFILE_STEPS))
    if count:
        from repro_torch.roofline.hlo_parse import CostCounter
        with uncounted(), CostCounter() as counter:
            eng.poll()
        torch.cuda.synchronize()
        out["count"] = counter.as_dict()
    return out


def phase_profile(torch, np, eng) -> dict:
    """:func:`decode_profile` of the CREAM engine, then two
    schedule_migration calls of MIG_PAGES pages on this local pool, each
    run beside one full-batch step and read back intact, the second traced
    (stream_overlap)."""
    prof = decode_profile(torch, np, eng, count=True)
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
    return dict(prof, local_migration=dict(pages=MIG_PAGES, intact=True,
                                           overlap=overlap))


# ---------------------------------------------------------------------------
# The telemetry phase
# ---------------------------------------------------------------------------

#: spans of one decode step, in the order the step opens them
STEP_SPANS = ("serve.router.dispatch", "engine.step.gather",
              "engine.step.compute", "engine.step.scatter")
OVERHEAD_REPS, OVERHEAD_WINDOW = 5, 4   # interleaved windows of steps
FLIP_PAGES = 16            # SECDED pages given a single-bit flip
#: the device operations the metrics plane adds to a decode step: the
#: status output's zero fill (the mixed read's wrapper), the reduction
#: (engine._status_counts) and the fold's copy of the counts to the host
FOLD_OPS = ("status zero fill", "row*4 + status add", "histogram zero fill",
            "ones_like fill", "index_add_", "corrected-column add",
            "stack (cat)", "counts copy to the host")


def set_planes(metrics: bool = False, tracing: bool = False,
               memprof: bool = False) -> None:
    from repro_torch.obs import memprof as obs_memprof
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracing as obs_tracing
    obs_metrics.enable(metrics)
    obs_tracing.enable(tracing)
    obs_memprof.enable(memprof)


def reset_planes() -> None:
    """Every plane off and empty, the SLO tracker too."""
    from repro_torch import obs
    set_planes()
    obs.metrics.REGISTRY.clear()
    obs.tracing.reset()
    obs.memprof.clear()
    obs.slo.TRACKER.reset()


def full_batch(np, eng, max_new: int, tag: str) -> None:
    """Close the parked sessions (their frames go back to the pool, so the
    batch's steps preempt nothing), submit B seeded requests of
    ``max_new`` tokens and poll until all B slots decode."""
    from repro_torch.serve import ServeRequest
    for seq_id, sess in list(eng.sched.sessions.items()):
        if sess.slot is None:
            eng.sched.close_session(seq_id)
    rng = np.random.default_rng(SEED + 3)
    for i in range(B):
        eng.submit(ServeRequest(
            f"{tag}{i}",
            rng.integers(0, eng.cfg.vocab_size, PROMPT).astype(np.int32),
            max_new))
    for _ in range(2):
        eng.poll()
    check(len(eng.sched.active_slots()) == B, f"{tag} batch is not full")


def drain(eng) -> None:
    while eng.sched.has_work():
        eng.poll()


def span_split(torch, np, eng, steps: int = PROFILE_STEPS) -> dict:
    """The host time of a full-batch decode step split by its spans: the
    median over ``steps`` traced steps of each span's duration and of the
    step's host-clock time, and the rest of the step (scheduling, token
    bookkeeping). The spans block (CUDA events), so a traced step is not
    the untraced step: its phases run one after another."""
    import statistics

    from repro_torch.obs import tracing
    full_batch(np, eng, steps + 6, "split")
    tracing.reset()
    set_planes(tracing=True)
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.poll()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    set_planes()
    per = {name: [e["dur"] / 1e3 for e in tracing.TRACER.events
                  if e["name"] == name] for name in STEP_SPANS}
    check(all(len(v) == steps for v in per.values()),
          f"span counts {[len(v) for v in per.values()]} for {steps} steps")
    med = {name: statistics.median(v) for name, v in per.items()}
    step = statistics.median(step_ms)
    drain(eng)
    tracing.reset()
    return dict(steps=steps, step_ms=step, span_ms=med,
                rest_ms=step - sum(med.values()))


def plane_overhead(torch, np, eng) -> dict:
    """Host-clock ms a full-batch decode step takes with every plane off,
    metrics on, and every plane on: OVERHEAD_REPS interleaved windows of
    OVERHEAD_WINDOW steps each (off, metrics, all, in turn), the median
    of each and its spread (min, max), and the medians' ratios."""
    import statistics
    full_batch(np, eng, 3 * OVERHEAD_REPS * OVERHEAD_WINDOW + 6, "overhead")
    runs = {"off": [], "metrics": [], "all": []}
    for _ in range(OVERHEAD_REPS):
        for name, planes in (("off", {}), ("metrics", dict(metrics=True)),
                             ("all", dict(metrics=True, tracing=True,
                                          memprof=True))):
            set_planes(**planes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OVERHEAD_WINDOW):
                eng.poll()
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter() - t0) * 1e3
                              / OVERHEAD_WINDOW)
    set_planes()
    drain(eng)
    med = {k: statistics.median(v) for k, v in runs.items()}
    return dict(window_steps=OVERHEAD_WINDOW, reps=OVERHEAD_REPS,
                step_ms=med, spread_ms={k: [min(v), max(v)]
                                        for k, v in runs.items()},
                ratio={k: med[k] / med["off"] for k in ("metrics", "all")})


def telemetry_serve(torch, np, mode: str, tok_c):
    """The serve requests at qwen3-0.6b full width (float32) with every
    plane on: the engine, its counts and the checks of the telemetry
    phase (tokens, counters, read-status series, capacity, spans, the
    Perfetto export, CREAM-Lens records)."""
    from collections import Counter

    from repro_torch import obs
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.kernels import common
    from repro_torch.serve import Engine
    m = obs.metrics
    reset_planes()
    set_planes(metrics=True, tracing=True, memprof=True)
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    eng = Engine(cfg, max_batch=B, max_len=MAX_LEN, mode=mode,
                 num_rows=NUM_ROWS, row_words=W, seed=SEED, device=DEVICE)
    prefills = Counter()
    impl = eng._do_prefill_impl

    def counted(slot, req, sess):
        prefills[req.tier] += 1
        impl(slot, req, sess)

    eng._do_prefill_impl = counted
    reqs = requests(np, cfg.vocab_size)
    torch.cuda.synchronize()
    common.LAUNCHES.clear()
    t0 = time.perf_counter()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    check([r.generated for r in reqs] == tok_c,
          f"{mode}: tokens with every plane on differ from planes off")
    check(launches.get("mixed_read_correct", 0) == eng.steps,
          f"{mode}: {launches.get('mixed_read_correct')} mixed reads for "
          f"{eng.steps} decode steps")
    # counters against the engine's own counts
    check(m.REGISTRY.value(m.NAME_DECODE_STEPS) == eng.steps,
          f"{mode}: decode-step counter")
    check(m.REGISTRY.value(m.NAME_PREFILLS) == sum(prefills.values()),
          f"{mode}: prefill counter")
    decoded = Counter()
    for r in reqs:
        decoded[r.tier] += len(r.generated)
    decoded.subtract(prefills)
    for tier, n in decoded.items():
        check(m.REGISTRY.value(m.NAME_TOKENS_DECODED, tier=tier) == n,
              f"{mode}: tokens decoded on tier {tier}")
    snap = m.collect()
    series = {(r["labels"]["cls"], r["labels"]["status"])
              for r in snap[m.NAME_READ_STATUS]["series"]}
    check(series == {(c, s) for c in m.FOLD_CLASSES
                     for s in ("corrected", "uncorrectable")},
          f"{mode}: read-status series {sorted(series)}")
    # capacity gauges and the tracker's entry against capacity_report
    rep = eng.vm.capacity_report()[eng.pool_name]
    secded_pages = rep["rows"] - rep["boundary"] - rep["daec_rows"]
    want = {("secded",): secded_pages,
            ("none",): rep["boundary"] + rep["extra_pages"]}
    got = {(r["labels"]["cls"],): r["value"]
           for r in snap[m.NAME_CAPACITY_PAGES]["series"]}
    check({k: v for k, v in got.items() if v or k in want} ==
          {k: v for k, v in want.items() if v or k in got},
          f"{mode}: capacity gauges {got} != {want}")
    check(m.REGISTRY.value(m.NAME_CAPACITY_RECLAIMED, pool=eng.pool_name)
          == rep["extra_pages"], f"{mode}: reclaimed-pages gauge")
    cap = obs.slo.TRACKER.capacity[eng.pool_name]
    check((cap.total_rows, cap.reclaimed_pages, cap.boundary)
          == (rep["rows"], rep["extra_pages"], rep["boundary"]),
          f"{mode}: SLO capacity entry {cap} != {rep}")
    # spans: the step's phases, one gather per decode step, an export
    names = Counter(e["name"] for e in obs.tracing.TRACER.events)
    check(all(names[n] for n in (*STEP_SPANS, "engine.prefill")),
          f"{mode}: spans {dict(names)}")
    check(names["engine.step.gather"] == eng.steps,
          f"{mode}: {names['engine.step.gather']} gather spans for "
          f"{eng.steps} steps")
    trace = common.BUILD_DIR / f"telemetry_{mode}.json"
    obs.tracing.export(str(trace))
    check(len(json.loads(trace.read_text())["traceEvents"])
          == len(obs.tracing.TRACER.events), f"{mode}: Perfetto export")
    # CREAM-Lens: one decode gather a step, none dropped
    recs = obs.memprof.records()
    check(obs.memprof.PROFILER.dropped == 0, f"{mode}: memprof dropped")
    decode = Counter(r.step for r in recs if r.stream == "decode")
    check(decode == Counter(range(1, eng.steps + 1))
          and all(r.op == "gather" for r in recs if r.stream == "decode"),
          f"{mode}: decode gathers per step")
    prof = obs.memprof.profile(recs[-4:])      # a replay of the last four
    return eng, dict(tokens_equal=True, wall_s=wall, launches=launches,
                     decode_steps=eng.steps,
                     prefills=sum(prefills.values()),
                     spans=dict(names), records=len(recs),
                     bank_profile=dict(prof["overall"], heatmap=None),
                     slo=[dataclasses.astuple(st)
                          for st in obs.slo.TRACKER.report()])


def aten_ops(torch, fn):
    """PyTorch operations ``fn`` runs, by name, counted at the dispatcher
    (views included): unlike a profiler's device-event count, every one
    is seen."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    ops = Counter()
    with Count():
        fn()
    return ops


def fold_ops(torch, np, eng) -> dict:
    """What the metrics plane adds to a full-batch decode step: one step
    with every plane off, one with metrics on, their PyTorch operations
    counted at the dispatcher and their kernel launches. Metrics on must
    run exactly the operations of the step with planes off, less the
    data-only read, plus the read with its status, the reduction and the
    counts' copy to the host, each counted alone on the step's ids, and
    the two views that split the one upload of ids and count rows: the
    eight device operations of FOLD_OPS and views. Both steps make one
    mixed-read launch."""
    from repro_torch.kernels import common
    from repro_torch.kernels.mixed import ops as mixed_ops
    from repro_torch.serve import engine as engine_mod
    full_batch(np, eng, 8, "ops")
    seen, walk = [], eng.kv.gather_phys
    eng.kv.gather_phys = lambda rows: seen.append(walk(rows)) or seen[-1]
    steps = {}
    for metrics in (False, True):
        set_planes(metrics=metrics)
        before = common.LAUNCHES["mixed_read_correct"]
        steps[metrics] = aten_ops(torch, eng.step)
        check(common.LAUNCHES["mixed_read_correct"] - before == 1,
              "a step is one mixed-read launch")
    set_planes()
    del eng.kv.gather_phys
    pool, phys = eng.pool, seen[-1].reshape(-1)
    args = (pool.storage, eng._ids(phys), pool.layout, pool.num_rows,
            pool.boundary)
    rows4 = eng._ids(engine_mod._status_rows(pool, phys))
    _, status = mixed_ops.read_correct(*args, status=True)
    counts = engine_mod._status_counts(rows4, status)
    piece = {
        "read": aten_ops(torch, lambda: mixed_ops.read_correct(*args)),
        "read_status": aten_ops(
            torch, lambda: mixed_ops.read_correct(*args, status=True)),
        "reduction": aten_ops(
            torch, lambda: engine_mod._status_counts(rows4, status)),
        "copy": aten_ops(torch, lambda: np.asarray(counts.cpu()))}
    want = steps[False] - piece["read"] + piece["read_status"] \
        + piece["reduction"] + piece["copy"]
    want["aten.select"] += 2
    check(steps[True] == want,
          f"metrics on: {dict(steps[True] - want)} more and "
          f"{dict(want - steps[True])} fewer operations than named")
    drain(eng)
    return dict(step_ops={"off": sum(steps[False].values()),
                          "metrics": sum(steps[True].values())},
                added={k: v for k, v in (steps[True] - steps[False]).items()},
                removed={k: v for k, v in
                         (steps[False] - steps[True]).items()})


def memprof_steps(np, eng, steps: int = 3) -> int:
    """The property of the reference's CREAM-Lens engine test: with the
    profiler reset after the admissions, each decode step of a full batch
    records exactly one ``decode`` gather and one scatter."""
    from repro_torch.obs import memprof
    full_batch(np, eng, steps + 4, "lens")
    memprof.reset()
    set_planes(metrics=True, memprof=True)
    for _ in range(steps):
        eng.step()
    recs = [(r.step, r.op, r.stream) for r in memprof.records()]
    set_planes()
    check(recs == [(s, op, stream) for s in range(1, steps + 1)
                   for op, stream in (("gather", "decode"),
                                      ("scatter", "main"))],
          f"decode-step records {recs}")
    drain(eng)
    return steps


def plant_singles(torch, np, eng, pages: int) -> int:
    """Single data-bit flips in ``pages`` distinct SECDED pages the next
    step reads (each page's lane k, word w, bit b from a seeded draw);
    returns the pages (with repeats) a status read of the step's ids
    reports corrected on the card right after."""
    pool = eng.pool
    eng.sched.ensure_step()
    rows = np.asarray([s.row if s is not None else -1
                       for s in eng.sched.slots])
    phys = eng.kv.gather_phys(rows).reshape(-1)
    ids = np.unique(phys[(phys >= pool.boundary) & (phys < pool.num_rows)])
    rng = np.random.default_rng(SEED + 30)
    chosen = rng.choice(ids, pages, replace=False)
    for k, page in enumerate(chosen):
        pool.storage[int(page), k % 8, int(rng.integers(0, W))] ^= \
            1 << int(rng.integers(0, 31))
    _, status = pool.read(phys, status=True)
    return int(((status == 1) | (status == 2)).sum())


def phase_telemetry(torch, np, tok_c, off_events) -> tuple[dict, dict]:
    """serve-cream and serve-secded at qwen3-0.6b full width with every
    plane on (telemetry_serve), then on the cream engine the device
    operations the metrics plane adds to a step (fold_ops; the profile
    phase's planes-off window, off_events, is printed beside them) and the
    step's span split and plane overhead, and on the secded engine
    planted flips: single-bit flips in pages the next step reads, whose
    folded secded/corrected count must equal a status read of the same
    ids, then one double-bit flip that must count one uncorrectable and
    breach the secded SLO."""
    from repro_torch import obs
    m = obs.metrics
    out, launches = {}, {}
    eng, out["cream"] = telemetry_serve(torch, np, "cream", tok_c)
    launches = dict(out["cream"]["launches"])
    # device operations a step, every plane off against metrics on
    reset_planes()
    out["device_ops"] = dict(fold_ops(torch, np, eng), named=list(FOLD_OPS),
                             profile_window_planes_off=off_events)
    reset_planes()
    out["span_split"] = span_split(torch, np, eng)
    out["overhead"] = plane_overhead(torch, np, eng)
    memprof_steps(np, eng)
    reset_planes()
    del eng
    torch.cuda.empty_cache()

    eng, out["secded"] = telemetry_serve(torch, np, "secded", tok_c)
    for k, v in out["secded"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    out["memprof_steps"] = memprof_steps(np, eng)
    reset_planes()
    set_planes(metrics=True)
    full_batch(np, eng, 8, "flips")
    want = plant_singles(torch, np, eng, pages=FLIP_PAGES)
    check(want >= FLIP_PAGES,
          f"{want} corrected pages read for {FLIP_PAGES} planted flips")
    eng.step()
    got = m.REGISTRY.value(m.NAME_READ_STATUS, cls="secded",
                           status="corrected")
    check(got == want,
          f"folded secded/corrected {got} != status read {want}")
    check(m.REGISTRY.value(m.NAME_READ_STATUS, cls="secded",
                           status="uncorrectable") == 0, "no double yet")
    eng.sched.ensure_step()
    rows = np.asarray([s.row if s is not None else -1
                       for s in eng.sched.slots])
    phys = eng.kv.gather_phys(rows).reshape(-1)
    page = int(phys[0])
    eng.pool.storage[page, 2, 5] ^= 0b11            # two bits, one beat
    reads = int((phys == page).sum())
    eng.step()
    unc = m.REGISTRY.value(m.NAME_READ_STATUS, cls="secded",
                           status="uncorrectable")
    check(unc == reads == 1, f"{unc} uncorrectable for one double-bit page "
                             f"read {reads} times")
    breached = [st.scope for st in obs.slo.TRACKER.breached()]
    check("class/secded" in breached,
          f"secded SLO not breached: {breached}")
    drain(eng)
    out["flips"] = dict(planted_singles=FLIP_PAGES, corrected_read=want,
                        folded_corrected=got, folded_uncorrectable=unc,
                        breached=breached)
    reset_planes()
    del eng
    torch.cuda.empty_cache()
    out["serve_shard"] = telemetry_shard(torch, np, tok_c)
    for k, v in out["serve_shard"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    return out, launches


UPLOAD_REPS = 200          # timed uploads of one gather's count rows
SHARD_FLIP_AT = 6          # decode step before which telemetry-shard plants


def telemetry_shard(torch, np, tok_c) -> dict:
    """The serve requests on serve-shard's pool (4 banks, 1600 rows,
    InterWrap, boundary 1280) with the metrics plane on, the first request
    on the paid tier (its KV on SECDED frames, so the gathers decode), and
    before decode step SHARD_FLIP_AT single-bit flips in FLIP_PAGES
    SECDED pages that step reads. Every decode step's metrics-on gather
    must be one mixed_read_correct_routed launch (the status output) with
    no bank-by-bank secded_decode or local mixed read, and its folded
    counts must equal those of a bank-by-bank status read of the same ids
    (the check's launches are not the path's); the tokens must be the
    planes-off ones."""
    from repro_torch import obs
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core.layouts import Layout
    from repro_torch.kernels import common
    from repro_torch.serve import Engine
    from repro_torch.serve import engine as engine_mod
    from repro_torch.shard import route_np
    from repro_torch.shard import pool as shard_pool
    from repro_torch.vm import VirtualMemory
    m = obs.metrics
    reset_planes()
    set_planes(metrics=True)
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    vm = VirtualMemory(row_words=W, device=DEVICE)
    pool = vm.add_pool("kv", NUM_ROWS, Layout.INTERWRAP,
                       boundary=SHARD_BOUNDARY, shards=SHARDS)
    check(pool.fused_status, "serve-shard pool takes no fused status read")
    eng = Engine(cfg, max_batch=B, max_len=MAX_LEN, vm=vm, pool="kv",
                 seed=SEED)
    per_gather, mismatches, corrected, last = [], [], [0], [None]
    gather = eng._gather_pages_counts
    kinds = ("mixed_read_correct_routed", "secded_decode",
             "mixed_read_correct")

    def counted(phys):
        last[0] = phys
        before = dict(common.LAUNCHES)
        data, counts = gather(phys)
        per_gather.append(tuple(common.LAUNCHES.get(k, 0) - before.get(k, 0)
                                for k in kinds))
        saved = dict(common.LAUNCHES)
        _, st = shard_pool._read_status(eng.pool, np.asarray(phys, np.int64))
        want = engine_mod._status_counts(
            torch.as_tensor(engine_mod._status_rows(eng.pool, phys),
                            device=st.device), st)
        if not torch.equal(counts, want):
            mismatches.append((counts.tolist(), want.tolist()))
        corrected[0] += int(want[m.FOLD_CLASSES.index("secded"), 0])
        common.LAUNCHES.clear()
        common.LAUNCHES.update(saved)
        return data, counts

    eng._gather_pages_counts = counted
    reqs = requests(np, cfg.vocab_size)
    for i, r in enumerate(reqs):
        r.tier = "paid" if i == 0 else "batch"
        eng.submit(r)
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    t0 = time.perf_counter()
    planted = 0
    while eng.sched.has_work():
        if not planted and eng.steps == SHARD_FLIP_AT:
            eng.sched.ensure_step()
            rows = np.asarray([s.row if s is not None else -1
                               for s in eng.sched.slots])
            phys = eng.kv.gather_phys(rows).reshape(-1)
            ids = np.unique(phys[(phys >= pool.boundary)
                                 & (phys < pool.num_rows)])
            rng = np.random.default_rng(SEED + 31)
            chosen = rng.choice(ids, min(FLIP_PAGES, ids.size),
                                replace=False)
            bank, local = route_np(chosen, pool.num_rows, pool.num_shards)
            for k, (b, loc) in enumerate(zip(bank, local)):
                pool.storage[int(b), int(loc), k % 8,
                             int(rng.integers(0, W))] ^= \
                    1 << int(rng.integers(0, 31))
            planted = int(chosen.size)
        eng.poll()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    folded = m.REGISTRY.value(m.NAME_READ_STATUS, cls="secded",
                              status="corrected")
    reset_planes()
    check([r.generated for r in reqs] == tok_c,
          "telemetry serve-shard tokens differ from planes off")
    check(len(per_gather) == eng.steps and set(per_gather) == {(1, 0, 0)},
          f"metrics-on gathers (routed, secded_decode, mixed): "
          f"{sorted(set(per_gather))} over {len(per_gather)} for "
          f"{eng.steps} steps")
    check(not mismatches, f"folded counts != status read: {mismatches[:2]}")
    check(planted > 0 and folded == corrected[0] > 0,
          f"{planted} planted, folded secded/corrected {folded}, status "
          f"read {corrected[0]}")
    # the gather's count rows go up apart from the page ids (which the
    # pool's read uploads): that upload's host time, to its end on the card
    rows4 = engine_mod._status_rows(pool, last[0])
    up = []
    for _ in range(UPLOAD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._ids(rows4)
        torch.cuda.synchronize()
        up.append(time.perf_counter() - t0)
    del eng, pool, vm
    torch.cuda.empty_cache()
    return dict(banks=SHARDS, rows=NUM_ROWS, boundary=SHARD_BOUNDARY,
                decode_steps=len(per_gather), tokens_equal=True,
                routed_status_gathers=len(per_gather),
                planted_singles=planted, folded_corrected=folded,
                status_read_corrected=corrected[0], wall_s=wall,
                step_ms=wall / len(per_gather) * 1e3,
                count_rows_upload_ms=statistics.median(up) * 1e3,
                launches=launches)


def device_breakdown(prof, window_ms: float, per: int = 1,
                     top: int = 12, skip: tuple = ()) -> dict:
    """Device time seen by ``prof``: by kernel class and by kernel (ms per
    ``per`` steps), the device events and their busy share of a window of
    ``window_ms``; "not measured" when the profiler saw no device time.
    Device events named in ``skip`` (the GPU side of profiler ranges,
    which span kernels counted already) are left out."""
    from collections import Counter

    from torch.autograd import DeviceType
    by_name: Counter = Counter()
    events = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in skip:
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
    advanced-indexing gather. On the serve-shard pool also its status
    output: data and status bit-exact, every status present, its time
    beside the status-free launch's."""
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
            # the status output (the sharded status read and the metrics-on
            # gather): data and per-page worst status bit-exact, every
            # status present, timed beside the status-free launch
            st_k = ops.read_correct_routed(*args, status=True)
            st_p = ref.read_correct_routed(*args, status=True)
            torch.cuda.synchronize()
            counts = torch.bincount(st_k[1], minlength=4).tolist()
            check(all(counts), f"routed read statuses {counts}")
            check(torch.equal(st_k[0], got), "status changed the data")
            status_ms = median_ms(
                lambda: ops.read_correct_routed(*args, status=True), 20)
            r["status_variant"] = dict(
                max_abs_err=max_abs_err(st_k, st_p), status_pages=counts,
                ms=status_ms,
                plain_ms=median_ms(
                    lambda: ref.read_correct_routed(*args, status=True), 3),
                data_only_ms=r["ms"], change=status_ms / r["ms"] - 1,
                bound=bound_ms(4 * (2 * n * D + n_sec * W + 2 * n),
                               48 * n_sec * D // 2))
            check(r["status_variant"]["max_abs_err"] == 0,
                  "routed read with status disagrees with its plain version")
            del st_k, st_p
            local_row = routed_local_row(torch, np, sto, ids, rows, boundary,
                                         S, got)
        else:
            r.update(ms=median_ms(lambda: ops.read_correct_routed(*args), 5))
        shapes[name] = r
        del sto, ids, got, grow, lanes, region, flat
        torch.cuda.empty_cache()
    row = dict(shapes["serve_shard"], shapes=shapes,
               max_abs_err=max(r["max_abs_err"] for r in shapes.values()))
    check(row["max_abs_err"] == 0,
          "mixed_read_correct_routed disagrees with its plain version")
    check(local_row["max_abs_err"] == 0,
          "mixed_read_correct_routed_local disagrees with its plain version")
    return {"mixed_read_correct_routed": row,
            "mixed_read_correct_routed_local": local_row}


def routed_local_row(torch, np, sto, ids, rows: int, boundary: int, S: int,
                     assembled) -> dict:
    """The shard-local routed read, the launch a banks mesh's read makes
    on each rank: bank s's (R_local, 9, W) slice of the serve-shard pool
    and its index, every page id, with and without status, bit-exact
    against the plain version for every bank; the other banks' rows
    zero, and the banks' shares summing to the all-banks read. Timed on
    bank 0; the yardstick is the uncorrected indexing gather of the
    bank's rows (the owned ids, the others at local 0)."""
    from repro_torch.core.layouts import REGION_SECDED, Layout, page_coords
    from repro_torch.kernels.mixed import ops, ref
    from repro_torch.shard import router
    D = 8 * W
    shard, local = router.route(ids, rows, S)
    acc = torch.zeros_like(assembled)
    err = 0
    for s in range(S):
        args = (sto[s], ids, Layout.INTERWRAP, rows, boundary, S)
        got = ops.read_correct_routed_local(*args, s)
        err = max(err, words_err(got, ref.read_correct_routed_local(*args,
                                                                    s)))
        check(not got[shard != s].any(), f"bank {s}: foreign rows not zero")
        acc += got
        err = max(err, max_abs_err(
            ops.read_correct_routed_local(*args, s, status=True),
            ref.read_correct_routed_local(*args, s, status=True)))
        del got
    check(torch.equal(acc, assembled),
          "the banks' shares do not sum to the all-banks read")
    del acc
    args = (sto[0], ids, Layout.INTERWRAP, rows, boundary, S)
    own = shard == 0
    grow, lanes, region = page_coords(Layout.INTERWRAP, rows // S,
                                      boundary // S,
                                      torch.where(own, local, 0), W)
    bank = sto[0]
    lib = lambda: bank[grow, lanes]  # noqa: E731  (yardstick only)
    n, n_own = ids.numel(), int(own.sum())
    n_sec = int((own & (region == REGION_SECDED)).sum())
    torch.cuda.synchronize()
    # each input read once: every owned page and its code slice if
    # SECDED, the ids; every page of the batch written once (zeros too)
    return dict(banks=S, pages=n, owned_pages=n_own, owned_secded_pages=n_sec,
                max_abs_err=err,
                ms=median_ms(lambda: ops.read_correct_routed_local(
                    *args, 0), 20),
                plain_ms=median_ms(
                    lambda: ref.read_correct_routed_local(*args, 0), 3),
                library_ms=median_ms(lib, 20),
                bound=bound_ms(4 * (n_own * D + n_sec * W + n * D + n),
                               48 * n_sec * D // 2))


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


# ---------------------------------------------------------------------------
# Phase 37: CREAM-Shard's banks and the training host mesh across ranks
# ---------------------------------------------------------------------------

MESH_MAX_RANKS = 4         # the ranks of the mesh phase: cards, at most 4
MESH_TIMEOUT_S = 300       # torch.distributed.run's limit, serving only
MESH_TRAIN_TIMEOUT_S = 780  # ... and serving, then training
MESH_TRAIN_RANKS = 4       # the mesh phase trains with this many ranks
MESH_TRAIN_ARGS = ["--arch", "qwen3-0.6b"]     # the launcher's defaults
MESH_LOSS_REL = 2e-2       # data-parallel losses against the one-card run
MESH_AR_REPS = 10          # timed all-reduces of a step's buffer
MESH_PROFILE_STEPS = 3     # train steps timed, then profiled, after the run


def mesh_serve(torch, np, S: int, mesh) -> dict:
    """serve-shard's requests and geometry (NUM_ROWS global rows,
    InterWrap, boundary SHARD_BOUNDARY) on a pool of ``S`` banks: on this
    card (``mesh`` None) or one bank a rank of a banks ``mesh``, where
    every rank runs this with the same arguments. With S > 1 three
    MIG_PAGES migrations across banks, each beside one step (serve-shard's
    plan and contents), read back intact. Returns the engine, tokens,
    each step's host seconds, the migration steps and the launches."""
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core.layouts import Layout
    from repro_torch.kernels import common
    from repro_torch.serve import Engine
    from repro_torch.vm import VirtualMemory
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    vm = VirtualMemory(row_words=W, device=DEVICE)
    vm.add_pool("kv", NUM_ROWS, Layout.INTERWRAP, boundary=SHARD_BOUNDARY,
                shards=S, mesh=mesh)
    eng = Engine(cfg, max_batch=B, max_len=MAX_LEN, vm=vm, pool="kv",
                 seed=SEED)
    plan = []
    if S > 1:
        vm.create_tenant("mig")
        vpns = vm.alloc("mig", 2 * MIG_PAGES, allow_host=False)
        check(vpns is not None, "no frames for the migration")
        phys = [vm.translate("mig", v).phys for v in vpns]
        src = phys[:MIG_PAGES]
        dst = phys[MIG_PAGES + 1:] + phys[MIG_PAGES:MIG_PAGES + 1]
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
        plan = [(k * MIG_AT_STEP, torch.randint(
            -2**31, 2**31, (MIG_PAGES, 8 * W), generator=gen, device=DEVICE,
            dtype=torch.int32)) for k in (1, 2, 3)]
    reqs = requests(np, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    step_s, mig_steps = [], []
    step = eng.step

    def timed_step():
        t = time.perf_counter()
        out = step()
        step_s.append(time.perf_counter() - t)
        return out

    eng.step = timed_step
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    t0 = time.perf_counter()
    while eng.sched.has_work():
        if plan and eng.steps >= plan[0][0]:
            _, moving = plan.pop(0)
            mig_steps.append(eng.steps)
            migration_step(torch, np, eng, src, dst, vpns[:MIG_PAGES],
                           moving, False)
        else:
            eng.poll()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not plan, "migrations left unrun")
    return dict(engine=eng, tokens=[r.generated for r in reqs],
                step_s=step_s, migration_steps=mig_steps, wall_s=wall,
                launches=dict(common.LAUNCHES))


def step_times(step_s: list, mig_steps: list) -> dict:
    plain = [t for i, t in enumerate(step_s) if i not in mig_steps]
    return dict(decode_steps=len(step_s),
                step_ms_median=statistics.median(plain) * 1e3,
                migration_step_ms=[step_s[i] * 1e3 for i in mig_steps])


def bank_digests(torch, storage) -> list:
    """sha256 of each bank of a (S, R_local, 9, W) pool storage; a local
    pool's (R, 9, W) is one bank (the layout of a 1-bank pool)."""
    import hashlib
    if storage.dim() == 3:
        storage = storage[None]
    return [hashlib.sha256(storage[s].cpu().numpy().tobytes()).hexdigest()
            for s in range(storage.shape[0])]


def tree_digest(tree) -> str:
    """sha256 over every leaf's bytes, in tree order."""
    import hashlib

    from repro_torch.core.poolstore import leaf_bytes
    from repro_torch.distributed.sharding import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf_bytes(leaf).cpu().numpy().tobytes())
    return h.hexdigest()


def train_profile(torch, tr) -> dict:
    """MESH_PROFILE_STEPS more steps of a trainer on the host clock, then
    as many under torch.profiler: device time a step by kernel class
    (the NCCL kernels as "collective"; the profiler's own "nccl:*" range
    on the device timeline, which spans the kernel, is left out) and its
    busy share."""
    from torch.profiler import ProfilerActivity, profile
    k = MESH_PROFILE_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(k)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / k
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(k)
        torch.cuda.synchronize()
    return dict(step_ms=host_ms,
                **device_breakdown(prof, host_ms * k, per=k, top=6,
                                   skip=("nccl:all_reduce",)))


def phase_mesh(torch, np) -> tuple[dict, dict]:
    """N = min(cards, MESH_MAX_RANKS) ranks under torch.distributed.run:
    first, in this process, serve-shard's requests on a one-card pool of
    N banks (and with N = MESH_TRAIN_RANKS the launcher's qwen3-0.6b
    training on one card); then the ranks serve the same on a mesh pool
    of N banks, one a rank, and train data-parallel, and rank 0 holds
    them against those runs (:func:`mesh_worker`). Returns the phase's
    line and its launches summed over the ranks."""
    from repro_torch.kernels import common
    from repro_torch.launch import train as launch_train
    n = min(torch.cuda.device_count(), MESH_MAX_RANKS)
    out = common.BUILD_DIR / "mesh"
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("*.json"):
        f.unlink()
    one = mesh_serve(torch, np, n, None)
    ref = dict(tokens=one["tokens"],
               banks=bank_digests(torch, one["engine"].pool.storage),
               **step_times(one["step_s"], one["migration_steps"]))
    del one
    torch.cuda.empty_cache()
    train = n == MESH_TRAIN_RANKS
    if train:
        t = time.perf_counter()
        tr = launch_train.main(MESH_TRAIN_ARGS)
        ref["train"] = dict(losses=[r["loss"] for r in tr.metrics_log],
                            step_ms=statistics.median(
                                r["wall_s"] for r in tr.metrics_log[1:])
                            * 1e3, seconds=time.perf_counter() - t)
        ref["train"]["profile"] = train_profile(torch, tr)
        del tr
        torch.cuda.empty_cache()
    (out / "one_card.json").write_text(json.dumps(ref))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"),
         "--mesh-worker", str(out)] + (["--train"] if train else []),
        capture_output=True, text=True,
        timeout=MESH_TRAIN_TIMEOUT_S if train else MESH_TIMEOUT_S)
    (out / "ranks.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0,
          f"mesh ranks failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    res = json.loads((out / "mesh.json").read_text())
    launches: dict = {}
    for r in res["ranks"]:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    check(launches.get("mixed_read_correct_routed_local", 0) > 0,
          "the mesh read launched no shard-local routed read")
    check(not launches.get("mixed_read_correct_routed"),
          "a mesh rank launched the all-banks read")
    return dict(ranks=n, backend=res["backend"], rows=NUM_ROWS, banks=n,
                boundary=SHARD_BOUNDARY, tokens_equal=True, banks_equal=True,
                one_card=ref, mesh=res, launches=launches,
                seconds=time.perf_counter() - t), launches


def mesh_worker(out: Path, train: bool) -> int:
    """One rank of the mesh phase, under torch.distributed.run: an NCCL
    group on this rank's card, serve-shard's requests on a mesh pool of
    one bank a rank (and with ``train`` the launcher's data-parallel
    training); rank 0 gathers the banks and the other ranks' results,
    holds them against the one-card runs and writes ``out/mesh.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import tree_leaves
    from repro_torch.kernels import common
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_banks_mesh, start_process_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_cpu = torch.device(DEVICE).type == "cpu"   # a rehearsal's gloo
    start_process_group("cpu" if on_cpu else "cuda")
    rank, n = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    check(backend == ("gloo" if on_cpu else "nccl"),
          f"the group is {backend}")
    common.library()
    ref = json.loads((out / "one_card.json").read_text())
    run = mesh_serve(torch, np, n, make_banks_mesh(n))
    eng = run["engine"]
    bank = eng.pool.storage[0]
    banks = torch.empty((n, *bank.shape), dtype=bank.dtype,
                        device=bank.device)
    dist.all_gather_into_tensor(banks, bank.unsqueeze(0))
    tokens = [None] * n
    dist.all_gather_object(tokens, run["tokens"])
    # the step's all-reduce alone: the mesh read's one buffer at its size
    pages = B * eng.n_layers * eng.kv.max_blocks
    buf = torch.zeros(pages * 8 * W, dtype=torch.int32, device=bank.device)
    ar_ms = median_ms(lambda: dist.all_reduce(buf), MESH_AR_REPS)
    mine = dict(rank=rank, device=str(bank.device),
                **step_times(run["step_s"], run["migration_steps"]),
                allreduce_pages=pages, allreduce_ms=ar_ms,
                launches=run["launches"])
    mine["allreduce_share"] = ar_ms / mine["step_ms_median"]
    if rank == 0:
        check(all(t == ref["tokens"] for t in tokens),
              "mesh tokens differ from the one-card pool's")
        check(bank_digests(torch, banks) == ref["banks"],
              "mesh banks differ from the one-card pool's")
    del banks, buf, run, eng, bank
    torch.cuda.empty_cache()
    if train:
        common.LAUNCHES.clear()
        tr = launch_train.main(MESH_TRAIN_ARGS)
        log = list(tr.metrics_log)
        check(tr.replicas is not None and tr.replicas.size == n,
              "the launcher did not train data-parallel")
        digests = [None] * n
        dist.all_gather_object(digests, tree_digest(tr.params))
        # the step's one buffer: the loss and every gradient in float32
        numel = 1 + sum(p.numel() for p in tree_leaves(tr.params))
        step_ms = statistics.median(r["wall_s"] for r in log[1:]) * 1e3
        mine["train"] = dict(
            losses=[r["loss"] for r in log[:len(ref["train"]["losses"])]],
            step_ms=step_ms,
            tokens_per_s=tr.data.cfg.global_batch * tr.data.cfg.seq_len
            / (step_ms / 1e3),
            launches=dict(common.LAUNCHES))
        with uncounted():
            mine["train"]["profile"] = train_profile(torch, tr)
        for k, v in common.LAUNCHES.items():
            mine["launches"][k] = mine["launches"].get(k, 0) + v
        del tr
        torch.cuda.empty_cache()
        gbuf = torch.zeros(numel, dtype=torch.float32, device=DEVICE)
        mine["train"]["allreduce_ms"] = median_ms(
            lambda: dist.all_reduce(gbuf), MESH_AR_REPS)
        mine["train"]["allreduce_share"] = \
            mine["train"]["allreduce_ms"] / step_ms
        del gbuf
        if rank == 0:
            check(len(set(digests)) == 1,
                  "data-parallel replicas hold different parameters")
            want = ref["train"]["losses"]
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(mine["train"]["losses"], want))
            mine["train"]["loss_rel_to_one_card"] = rel
            check(len(want) == len(mine["train"]["losses"])
                  and rel <= MESH_LOSS_REL,
                  f"data-parallel losses {rel} from the one-card run's")
            mine["train"]["params_equal_across_ranks"] = True
    results = [None] * n
    dist.all_gather_object(results, mine)
    if rank == 0:
        (out / "mesh.json").write_text(json.dumps(dict(
            backend=backend, ranks=results)))
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# Phases 21-26: regions, write-back reads, the launcher, full-width serving
# ---------------------------------------------------------------------------


#: examples/adaptive_reliability.py: per epoch its transitions and capacity
#: (pages) at 64/64/32 rows; epochs not listed make no transition
EXAMPLE_EPOCHS = {0: ([], 160),
                  1: ([("batch_kv", "secded", "parity"),
                       ("database", "secded", "parity")], 172),
                  3: ([("batch_kv", "parity", "none"),
                       ("database", "parity", "secded")], 168)}


def region_manager(device, rows: tuple, only: str | None = None):
    """The example's three regions (batch_kv, database, hypervisor) of
    ``rows`` rows at the default W = 256 (with ``only``, that region
    alone), its monitor settings, and its FaultModel over database's
    storage shape."""
    from repro_torch.core.injection import FaultModel
    from repro_torch.core.monitor import MonitorConfig
    from repro_torch.core.protection import Protection, RegionSpec
    from repro_torch.core.regions import RegionManager
    mgr = RegionManager(MonitorConfig(window=2, upgrade_threshold=5e-8,
                                      downgrade_threshold=1e-9,
                                      downgrade_patience=2), device=device)
    for (name, floor), n in zip((("batch_kv", Protection.NONE),
                                 ("database", Protection.PARITY),
                                 ("hypervisor", Protection.SECDED)), rows):
        if only not in (None, name):
            continue
        mgr.add_region(RegionSpec.make(name, Protection.SECDED, n,
                                       min_protection=floor))
    db = mgr.regions["database"].pool
    faults = FaultModel.make(seed=0, soft_rate=2000.0, n_hard=0,
                             shape=tuple(db.storage.shape))
    return mgr, faults


def region_epoch(torch, mgr, faults, epoch: int):
    """One epoch of the example: database's DIMM flips bits from epoch 3,
    then scrub_all and adapt -> (transitions, capacity, scrub_all seconds,
    adapt seconds, the sweep's census by region)."""
    db = mgr.regions["database"]
    if epoch >= 3:
        stor, _ = faults.step(db.pool.storage)
        db.pool = dataclasses.replace(db.pool, storage=stor)
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    census = mgr.scrub_all()
    sync()
    t1 = time.perf_counter()
    trans = [(n, a.value, b.value) for n, a, b in mgr.adapt()]
    sync()
    return trans, mgr.total_capacity_pages(), t1 - t0, \
        time.perf_counter() - t1, census


def check_example_epochs(epochs: list, where: str) -> None:
    """The example's sequence: transitions at epochs 1 and 3 only, the
    capacity at 0, 1 and 3 (rises, then falls) and unchanged between."""
    for e, (trans, cap) in enumerate(epochs):
        want, _ = EXAMPLE_EPOCHS.get(e, ([], None))
        check(trans == want, f"{where} epoch {e}: transitions {trans}")
        if e not in EXAMPLE_EPOCHS:
            check(cap == epochs[e - 1][1], f"{where} epoch {e}: capacity")
    caps = [cap for _, cap in epochs]
    check(caps[0] < caps[1] and caps[3] < caps[1],
          f"{where}: capacity {caps} does not rise, then fall")


def phase_regions_reference(torch, np) -> dict:
    """The example's 8 epochs at its own size through a RegionManager on
    the card and one on the CPU in lockstep: the example's transitions and
    capacities, identical capacity reports and bit-identical storage of
    every region after every epoch."""
    twins = {d: region_manager(d, (64, 64, 32)) for d in (DEVICE, "cpu")}
    epochs = []
    for epoch in range(REGION_EPOCHS):
        out = {d: region_epoch(torch, *twins[d], epoch) for d in twins}
        check(out[DEVICE][:2] == out["cpu"][:2],
              f"epoch {epoch}: card {out[DEVICE][:2]} != CPU "
              f"{out['cpu'][:2]}")
        card, cpu = twins[DEVICE][0], twins["cpu"][0]
        check(card.capacity_report() == cpu.capacity_report(),
              f"epoch {epoch}: capacity reports differ")
        for name, r in card.regions.items():
            check(torch.equal(r.pool.storage.cpu(),
                              cpu.regions[name].pool.storage),
                  f"epoch {epoch}: {name}'s storage differs")
            check(r.evictions == cpu.regions[name].evictions,
                  f"epoch {epoch}: {name}'s evictions differ")
        epochs.append(out[DEVICE][:2])
    check_example_epochs(epochs, "regions-reference")
    check([cap for _, cap in epochs][0::3] == [160, 168, 168],
          f"capacities {[cap for _, cap in epochs]}")
    report = twins[DEVICE][0].capacity_report()
    check({n: (r["protection"], r["pages"]) for n, r in report.items()}
          == {"batch_kv": ("none", 72), "database": ("secded", 64),
              "hypervisor": ("secded", 32)}, f"final report {report}")
    return dict(rows=[64, 64, 32], row_words=256,
                epochs=[dict(epoch=e, transitions=t, capacity=c)
                        for e, (t, c) in enumerate(epochs)],
                final=report, card_equals_cpu=True)


def phase_regions(torch, np) -> tuple[dict, dict]:
    """The example at a host's size (REGION_ROWS at W = 256, 1.36 GB of
    storage on the card): seeded values in every page, then 8 epochs of
    scrub_all / adapt and the same transitions. A CPU twin of database
    (the region that takes the flips, is scrubbed and repartitioned
    SECDED -> PARITY -> SECDED) starts from a copy of its storage and runs
    the same epochs: every census, transition, eviction and the storage
    after every sweep and every adapt equal the card's bit for bit. Every
    page of batch_kv and hypervisor not in their evictions reads back its
    value."""
    from repro_torch.core.protection import Protection
    from repro_torch.kernels import common
    mgr, faults = region_manager(DEVICE, REGION_ROWS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    values = {}
    for name, r in mgr.regions.items():
        values[name] = torch.randint(
            -2**31, 2**31, (r.pool.num_pages, r.pool.page_words),
            generator=gen, device=DEVICE, dtype=torch.int32)
        r.pool = r.pool.write(np.arange(r.pool.num_pages), values[name])
    storage = sum(r.pool.raw_bytes for r in mgr.regions.values())
    twin, twin_faults = region_manager("cpu", REGION_ROWS, only="database")
    db, tdb = mgr.regions["database"], twin.regions["database"]
    tdb.pool = dataclasses.replace(tdb.pool, storage=db.pool.storage.cpu())
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    epochs, scrub_s, adapt_s, census, card_s = [], [], [], [], 0.0
    for epoch in range(REGION_EPOCHS):
        t0 = time.perf_counter()
        trans, cap, s, a, stats = region_epoch(torch, mgr, faults, epoch)
        card_s += time.perf_counter() - t0
        epochs.append((trans, cap))
        scrub_s.append(s)
        adapt_s.append(a)
        ttrans, _, _, _, tstats = region_epoch(torch, twin, twin_faults,
                                               epoch)
        check(stats["database"] == tstats["database"],
              f"regions epoch {epoch}: database's census {stats['database']}"
              f" != the CPU's {tstats['database']}")
        check([t for t in trans if t[0] == "database"] == ttrans,
              f"regions epoch {epoch}: database's transitions differ")
        check(torch.equal(db.pool.storage.cpu(), tdb.pool.storage)
              and db.pool.layout == tdb.pool.layout
              and db.pool.boundary == tdb.pool.boundary
              and db.evictions == tdb.evictions,
              f"regions epoch {epoch}: database differs from the CPU's")
        census.append(dataclasses.asdict(stats["database"]) | dict(
            corrupt_rows=len(stats["database"].corrupt_rows)))
    launches = dict(common.LAUNCHES)
    del twin, tdb
    check_example_epochs(epochs, "regions")
    prot = {n: r.protection for n, r in mgr.regions.items()}
    check(prot == {"batch_kv": Protection.NONE,
                   "database": Protection.SECDED,
                   "hypervisor": Protection.SECDED}, f"final {prot}")
    check(sum(c["corrected_data"] + c["corrected_code"] for c in census) > 0
          and sum(c["parity_corrupt_lines"] for c in census) > 0,
          f"regions: database's census saw no flips {census}")
    for k in ("scrub_rows", "parity8_check", "parity8_write",
              "interwrap_scatter"):
        check(launches.get(k, 0) > 0, f"regions: no {k} launch")
    for name in ("batch_kv", "hypervisor"):
        r = mgr.regions[name]
        ids = np.setdiff1d(np.arange(values[name].shape[0]), r.evictions)
        got = r.pool.read(ids)
        check(torch.equal(got, values[name][torch.as_tensor(
            ids, device=DEVICE)]), f"{name}: a page lost its value")
        del got
    return dict(rows=list(REGION_ROWS), row_words=256,
                storage_bytes=storage,
                epochs=[dict(epoch=e, transitions=t, capacity=c)
                        for e, (t, c) in enumerate(epochs)],
                database_census=census, database_equals_cpu=True,
                final=mgr.capacity_report(),
                scrub_all_s=scrub_s, adapt_s=adapt_s,
                scrub_all_median_s=statistics.median(scrub_s),
                adapt_median_s=statistics.median(adapt_s),
                seconds=card_s, launches=launches), launches


def writeback_pools(torch, np, device) -> dict:
    """The write-back phase's four pools at W on ``device``: all-SECDED,
    with a DAEC tier, PARITY at boundary R/2, and 4 banks; each filled with
    the same seeded pages."""
    from repro_torch.core.layouts import Layout
    from repro_torch.core.pool import make_pool
    from repro_torch.shard import make_sharded_pool
    R = WB_ROWS
    pools = {
        "secded": make_pool(R, Layout.INTERWRAP, boundary=0, row_words=W,
                            device=device),
        "daec-tier": make_pool(R, Layout.INTERWRAP, boundary=0, row_words=W,
                               daec_rows=R // 2, device=device),
        "parity": make_pool(R, Layout.PARITY, boundary=R // 2, row_words=W,
                            device=device),
        "sharded": make_sharded_pool(R, Layout.INTERWRAP, R // 2,
                                     num_shards=4, row_words=W,
                                     device=device)}
    rng = np.random.default_rng(SEED + 40)
    for name, p in pools.items():
        data = rng.integers(0, 2**32, (p.num_pages, p.page_words),
                            dtype=np.uint32)
        pools[name] = p.write(np.arange(p.num_pages), data)
    return pools


def wb_flip(np, pool, rows: list, double_row: int):
    """Seeded single-bit flips, one in each protected page of ``rows``
    (global page ids), and one same-word double (bits b, b + 2: one
    codeword of either codec) in page ``double_row``: the flipped storage
    as a numpy array."""
    rng = np.random.default_rng(SEED + 41 + double_row)
    sto = pool.storage.cpu().numpy().view(np.uint32).copy()
    S = sto.shape[0] if sto.ndim == 4 else 1
    flat = sto.reshape(-1, *sto.shape[-2:])
    at = lambda p: p % S * (pool.num_rows // S) + p // S  # noqa: E731
    for p in rows:
        flat[at(p), rng.integers(0, 9), rng.integers(0, W)] ^= \
            np.uint32(1 << int(rng.integers(0, 32)))
    b = int(rng.integers(0, 30))
    flat[at(double_row), 3, 7] ^= np.uint32((1 << b) | (1 << (b + 2)))
    return sto


def phase_writeback(torch, np) -> tuple[dict, dict]:
    """read_writeback on the card and on the CPU over four pools with
    planted flips: the first read's status shows them, the second is clean
    but for the uncorrectable page, and data, status and storage equal the
    CPU port's after each read. Then a VM made on the default card adopts
    the local and the sharded pool, and reports as the CPU's does."""
    from collections import Counter

    from repro_torch.kernels import common
    from repro_torch.vm.address_space import VirtualMemory
    card, cpu = writeback_pools(torch, np, DEVICE), writeback_pools(
        torch, np, "cpu")
    R, out, launches = WB_ROWS, {}, {}
    singles = {"secded": [3, 9, 20, 41], "daec-tier": [5, 40, 50, 63],
               "parity": [33, 40, 47, 60], "sharded": [32, 37, 50, 63]}
    for name, pool in card.items():
        sto = wb_flip(np, pool, singles[name], double_row=R - 2)
        words = common.to_words(sto)
        card[name] = dataclasses.replace(pool, storage=words.to(DEVICE))
        cpu[name] = dataclasses.replace(cpu[name], storage=words)
        ids = np.random.default_rng(SEED + 42).permutation(pool.num_pages)
        reads = []
        torch.cuda.synchronize()
        common.LAUNCHES.clear()
        t0 = time.perf_counter()
        for _ in range(2):
            d, st, card[name] = card[name].read_writeback(ids)
            cd, cst, cpu[name] = cpu[name].read_writeback(ids)
            check(torch.equal(d.cpu(), cd) and torch.equal(st.cpu(), cst),
                  f"{name}: card and CPU write-back reads differ")
            check(torch.equal(card[name].storage.cpu(), cpu[name].storage),
                  f"{name}: card and CPU storage differ")
            reads.append(np.bincount(st.cpu().numpy(), minlength=4))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = dict(common.LAUNCHES)
        n1 = len(singles[name])
        check(reads[0][1] + reads[0][2] == n1 and reads[0][3] == 1,
              f"{name}: first read {reads[0].tolist()}")
        check(reads[1][1] + reads[1][2] == 0 and reads[1][3] == reads[0][3],
              f"{name}: second read {reads[1].tolist()}")
        out[name] = dict(first=reads[0].tolist(), second=reads[1].tolist(),
                         seconds=secs, launches=launches[name])
    for name, k in (("secded", "secded_decode"), ("daec-tier", "daec_decode"),
                    ("parity", "parity8_check"), ("sharded", "secded_decode")):
        check(launches[name].get(k, 0) > 0, f"{name}: no {k} launch")
    reports = {}
    for where, pools in ((DEVICE, card), ("cpu", cpu)):
        vm = VirtualMemory(row_words=W, device=where)   # no index: "cuda"
        for name in ("secded", "sharded"):
            vm.adopt_pool(name, pools[name])
        reports[where] = vm.capacity_report()
    check(reports[DEVICE] == reports["cpu"]
          and reports[DEVICE]["sharded"]["pages"] == card["sharded"].num_pages,
          f"adopt_pool: card {reports[DEVICE]} != CPU {reports['cpu']}")
    merged = sum((Counter(l) for l in launches.values()), Counter())
    return dict(rows=R, row_words=W, pools=out,
                adopted=reports[DEVICE]), dict(merged)


# ---------------------------------------------------------------------------
# Phase 24: widths — pools whose row width is not a multiple of 8
# ---------------------------------------------------------------------------

WIDTHS_CHECK = (7, 12, 60)    # (a): each word path against its plain version
WIDTHS_POOL = (7, 60)         # (b): pools, a sharded pool, a VM: card vs CPU
WIDTH_ROWS = 256              # rows of the (a) and (b) pools
WIDTH_DAEC = 32               # (b)'s DAEC tier
WIDTH_FLIPS = 0.01            # share of SECDED beats given a planted flip
WIDTH_TIME_BYTES = 1 << 30    # (d): storage of the timed pool
WIDTH_TIME_PAGES = 4096       # (d): pages (rows for the scrub) a timed call
WIDTH_SHARDS = 4


def plant_width_flips(np, rng, sto, rows) -> None:
    """Flip, in place, WIDTH_FLIPS of the SECDED beats of ``rows`` of the
    (N, 9, W) words ``sto`` (at least 3): single data bits (status 1),
    single code bits (2) and, every tenth, two bits of one word (3)."""
    W = sto.shape[2]
    rows = np.asarray(rows)
    beats = 4 * W * rows.size
    for i, beat in enumerate(rng.choice(beats, max(3, int(WIDTH_FLIPS
                                                          * beats)),
                                        replace=False)):
        row, b = int(rows[beat // (4 * W)]), int(beat % (4 * W))
        bit = int(rng.integers(0, 32))
        f = 2 * b + int(rng.integers(0, 2))       # a word of the beat
        if i % 10 == 9:
            sto[row, f // W, f % W] ^= np.uint32((1 << bit)
                                                  | (1 << ((bit + 7) % 32)))
        elif i % 2:
            sto[row, 8, b // 4] ^= np.uint32(1 << (8 * (b % 4) + bit % 8))
        else:
            sto[row, f // W, f % W] ^= np.uint32(1 << bit)


def width_storage(np, rng, rows: int, W: int, boundary: int):
    """(rows, 9, W) seeded uint32 words whose rows [boundary, rows) carry
    SECDED codes of their data lanes, with flips planted."""
    from repro_torch.core import secded
    from repro_torch.kernels import common
    sto = rng.integers(0, 2**32, (rows, 9, W), dtype=np.uint32)
    data = sto[boundary:, :8].reshape(rows - boundary, 8 * W)
    sto[boundary:, 8] = common.to_u32(secded.encode_block(
        common.to_words(data)))
    plant_width_flips(np, rng, sto, range(boundary, rows))
    return sto


def row_view(torch, t):
    """``t`` copied to the card as a view one pool row (9W words) into a
    buffer one row longer. A row is 36W bytes, so at W = 7 the view, and
    each of its banks and row ranges, starts off a 16-byte boundary, as a
    caller's view of a pool's rows may (``scrub_secded`` from any start)."""
    row = 9 * t.shape[-1]
    buf = torch.empty(row + t.numel(), dtype=t.dtype, device=DEVICE)
    view = buf[row:].view(t.shape)
    view.copy_(t)
    return view


def width_kernels(torch, np, W: int) -> dict:
    """(a) at width W: every pool kernel's word path on the card, bit-exact
    against its plain version on CPU copies of the same inputs, and the
    SECDED codecs at (N, 8W). The card's storage is a view one row into
    its buffer (:func:`row_view`). Returns each kernel's max_abs_err and
    the statuses the reads and the scrub saw."""
    from repro_torch.core.layouts import Layout, extra_page_count, total_pages
    from repro_torch.kernels import common
    from repro_torch.kernels.daec import ops as daec_ops
    from repro_torch.kernels.daec import ref as daec_ref
    from repro_torch.kernels.hash import ops as hash_ops
    from repro_torch.kernels.hash import ref as hash_ref
    from repro_torch.kernels.interwrap import ops as interwrap_ops
    from repro_torch.kernels.interwrap import ref as interwrap_ref
    from repro_torch.kernels.migrate import ops as migrate_ops
    from repro_torch.kernels.migrate import ref as migrate_ref
    from repro_torch.kernels.mixed import ops as mixed_ops
    from repro_torch.kernels.mixed import ref as mixed_ref
    from repro_torch.kernels.scrub import ops as scrub_ops
    from repro_torch.kernels.scrub import ref as scrub_ref
    from repro_torch.kernels.secded import ops as secded_ops
    from repro_torch.kernels.secded import ref as secded_ref
    from repro_torch.objcache import hash_index as hix

    rng = np.random.default_rng(SEED + 60 + W)
    R, half, S = WIDTH_ROWS, WIDTH_ROWS // 2, WIDTH_SHARDS
    cpu = common.to_words(width_storage(np, rng, R, W, half))
    card = row_view(torch, cpu)
    banks = common.to_words(np.stack([
        width_storage(np, rng, R // S, W, half // S) for _ in range(S)]))
    bcard = row_view(torch, banks)
    check(W % 4 == 0 or (card.data_ptr() % 16 and bcard[1].data_ptr() % 16
                         and card[half:].data_ptr() % 16),
          f"W={W}: the storage views are 16-byte aligned")
    errs, statuses = {}, set()

    def hold(name, got, want, status=False):
        got = tuple(g.cpu() for g in (got if isinstance(got, tuple)
                                      else (got,)))
        errs[name] = max(errs.get(name, 0), max_abs_err(got, want))
        if status:
            statuses.update(got[-1].unique().tolist())

    def ids(n, k=None):
        p = rng.permutation(n)[:k]
        return torch.as_tensor(p, dtype=torch.int32)

    for layout in (Layout.INTERWRAP, Layout.PACKED):
        p = ids(total_pages(layout, half, W) + R - half)
        hold("mixed_read_correct",
             mixed_ops.read_correct(card, p.to(DEVICE), layout, R, half,
                                    status=True),
             mixed_ref.read_correct(cpu, p, layout, R, half, status=True),
             status=True)
        g = ids(R + S * extra_page_count(layout, half // S, W))
        hold("mixed_read_correct_routed",
             mixed_ops.read_correct_routed(bcard, g.to(DEVICE), layout, R,
                                           half, S, status=True),
             mixed_ref.read_correct_routed(banks, g, layout, R, half, S,
                                           status=True), status=True)
        for s in range(S):
            hold("mixed_read_correct_routed_local",
                 mixed_ops.read_correct_routed_local(
                     bcard[s], g.to(DEVICE), layout, R, half, S, s,
                     status=True),
                 mixed_ref.read_correct_routed_local(
                     banks[s], g, layout, R, half, S, s, status=True))
    # the get of a filled index on the boundary-R/2 pool (1/4 absent keys)
    index = hix.make_index(4 * R, CACHE_PROBE, device="cpu")
    keys = rng.choice(2**31, R + R // 4, replace=False)
    index, _, _ = hix.insert(
        index, torch.as_tensor(keys[:R], dtype=torch.int32),
        torch.as_tensor(rng.integers(0, total_pages(Layout.INTERWRAP, half,
                                                    W) + R - half, R),
                        dtype=torch.int32),
        torch.zeros(R, dtype=torch.int32),
        torch.full((R,), 8 * W, dtype=torch.int32))
    q = torch.as_tensor(rng.permutation(keys), dtype=torch.int32)
    hold("hash_lookup_read",
         hash_ops.lookup_read(card, index.key.to(DEVICE),
                              index.page.to(DEVICE), q.to(DEVICE),
                              Layout.INTERWRAP, R, half, CACHE_PROBE),
         hash_ref.lookup_read(cpu, index.key, index.page, q,
                              Layout.INTERWRAP, R, half, CACHE_PROBE))
    # the same words as a whole-InterWrap pool: gather, re-encode, scatter
    p = ids(total_pages(Layout.INTERWRAP, R, W))
    hold("migrate_gather_encode",
         migrate_ops.gather_encode(card, p.to(DEVICE), R),
         migrate_ref.gather_encode(cpu, p, R))
    hold("interwrap_gather", interwrap_ops.gather(card, p.to(DEVICE), R),
         interwrap_ref.gather(cpu, p, R))
    data = common.to_words(rng.integers(0, 2**32, (p.numel(), 8 * W),
                                        dtype=np.uint32))
    hold("interwrap_scatter",
         interwrap_ops.scatter(row_view(torch, cpu), p.to(DEVICE),
                               data.to(DEVICE), R),
         interwrap_ref.scatter(cpu.clone(), p, data, R))
    hold("scrub_rows", scrub_ops.scrub_rows(card[half:]),
         scrub_ref.scrub_rows(cpu[half:].contiguous()), status=True)
    # the codecs on pages of 8W words: any W already
    data = common.to_words(rng.integers(0, 2**32, (64, 8 * W),
                                        dtype=np.uint32))
    for name, ops, ref in (("secded", secded_ops, secded_ref),
                           ("daec", daec_ops, daec_ref)):
        codes = ref.encode(data)
        hold(name + "_encode", ops.encode(data.to(DEVICE)), codes)
        bad, bad_codes = plant_flips(data, codes, rng, n_each=4)
        hold(name + "_decode", ops.decode(bad.to(DEVICE),
                                          bad_codes.to(DEVICE)),
             ref.decode(bad, bad_codes))
    check(not any(errs.values()), f"W={W}: word paths disagree: {errs}")
    check({0, 1, 2} <= statuses, f"W={W}: statuses {sorted(statuses)}")
    return dict(max_abs_err=errs, statuses=sorted(statuses))


def width_pool_run(torch, np, W: int, device) -> tuple[list, dict]:
    """(b) at width W on ``device``: the seeded sequence write -> flips ->
    status read -> migrate -> scrub -> status read on pools of the four
    layouts at boundary R/2 (with and without a DAEC tier), a whole-
    InterWrap pool and two 4-bank pools, then a VM whose InterWrap pool
    is repartitioned mid-run (mapped extra pages migrated) and back ->
    (every result as CPU tensors and dicts, the repartition reports)."""
    from repro_torch.core.layouts import Layout
    from repro_torch.core.pool import make_pool
    from repro_torch.core.protection import Protection
    from repro_torch.kernels import common
    from repro_torch.shard import make_sharded_pool
    from repro_torch.vm.address_space import VirtualMemory
    from repro_torch.vm.migration import MigrationEngine

    rng = np.random.default_rng(SEED + 70 + W)
    R, half = WIDTH_ROWS, WIDTH_ROWS // 2
    pools = [make_pool(R, layout, half, row_words=W, daec_rows=d,
                       device=device)
             for layout in (Layout.INTERWRAP, Layout.PACKED,
                            Layout.RANK_SUBSET, Layout.BASELINE_ECC)
             for d in (0, WIDTH_DAEC)]
    pools += [make_pool(R, Layout.INTERWRAP, row_words=W, device=device),
              make_sharded_pool(R, Layout.INTERWRAP, half,
                                num_shards=WIDTH_SHARDS, row_words=W,
                                device=device),
              make_sharded_pool(R, Layout.PACKED, half,
                                num_shards=WIDTH_SHARDS, row_words=W,
                                daec_rows=WIDTH_DAEC, device=device)]
    out = []
    for p in pools:
        n = p.num_pages
        ids = rng.permutation(n)
        p = p.write(ids, rng.integers(0, 2**32, (n, p.page_words),
                                      dtype=np.uint32))
        sto = common.to_u32(p.storage)
        flat = sto.reshape(-1, 9, W)
        per_bank = flat.shape[0] // (sto.shape[0] if sto.ndim == 4 else 1)
        b_local = p.boundary * per_bank // p.num_rows
        prot = [r for r in range(flat.shape[0]) if r % per_bank >= b_local]
        if prot:
            plant_width_flips(np, rng, flat, prot)
        p.storage.copy_(common.to_words(sto).to(device))
        out += [t.cpu() for t in p.read(ids, status=True)]
        p = p.migrate(ids[:16], ids[16:32])
        p, stats = p.scrub()
        out += [vars(stats), *(t.cpu() for t in p.read(ids, status=True)),
                p.storage.cpu()]
    vm = VirtualMemory(row_words=W, device=device)
    vm.add_pool("kv", R, Layout.INTERWRAP)
    vm.add_pool("ecc", 64, Layout.BASELINE_ECC)
    vm.create_tenant("loose", Protection.NONE)
    vm.create_tenant("strict", Protection.SECDED)
    vl = vm.alloc("loose", vm.pools["kv"].num_pages)
    vs = vm.alloc("strict", 32)
    for tenant, v in (("loose", vl), ("strict", vs)):
        vm.write(tenant, v, rng.integers(0, 2**32, (len(v), 8 * W),
                                         dtype=np.uint32))
    vm.free("loose", vl[:24])
    live = vl[24:]
    infos = []
    for nb in (half, R):                 # shrink mid-run, then grow back
        out += [vm.read("loose", live).cpu(), vm.read("strict", vs).cpu()]
        infos.append(MigrationEngine(vm).repartition_with_migration("kv",
                                                                    nb))
        live = [v for v in live if v in vm.tenants["loose"].entries]
        vm.write("loose", live[:8], rng.integers(
            0, 2**32, (8, 8 * W), dtype=np.uint32))
    out += [vm.read("loose", live).cpu(), vm.read("strict", vs).cpu(),
            *(vm.pools[k].storage.cpu() for k in ("kv", "ecc"))]
    return out + infos, dict(migrated=[i["migrated"] for i in infos])


def same_results(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def width_empty(torch, np) -> dict:
    """(c) n = 0: every kernel wrapper and every sharded-pool read and
    migration on the card gives the CPU's shapes and dtypes, and nothing
    is launched."""
    from repro_torch.core.layouts import Layout
    from repro_torch.kernels import common
    from repro_torch.kernels.daec import ops as daec_ops
    from repro_torch.kernels.hash import ops as hash_ops
    from repro_torch.kernels.interwrap import ops as interwrap_ops
    from repro_torch.kernels.migrate import ops as migrate_ops
    from repro_torch.kernels.mixed import ops as mixed_ops
    from repro_torch.kernels.parity8 import ops as parity8_ops
    from repro_torch.kernels.scrub import ops as scrub_ops
    from repro_torch.kernels.secded import ops as secded_ops
    from repro_torch.shard import make_sharded_pool
    from repro_torch.shard import pool as shard_pool
    R, W = 32, 7
    calls = {
        "mixed_read_correct": lambda d: mixed_ops.read_correct(
            d(R, 9, W), d(0), Layout.PACKED, R, 16, status=True),
        "mixed_read_correct_routed": lambda d: mixed_ops.read_correct_routed(
            d(4, R // 4, 9, W), d(0), Layout.INTERWRAP, R, 16, 4,
            status=True),
        "mixed_read_correct_routed_local":
            lambda d: mixed_ops.read_correct_routed_local(
                d(R // 4, 9, W), d(0), Layout.INTERWRAP, R, 16, 4, 1,
                status=True),
        "migrate_gather_encode": lambda d: migrate_ops.gather_encode(
            d(R, 9, W), d(0), R),
        "scrub_rows": lambda d: scrub_ops.scrub_rows(d(0, 9, W)),
        "hash_lookup_read": lambda d: hash_ops.lookup_read(
            d(R, 9, W), d(64), d(64), d(0), Layout.PACKED, R, 16, 8),
        "interwrap_gather": lambda d: interwrap_ops.gather(d(R, 9, W), d(0),
                                                           R),
        "interwrap_scatter": lambda d: interwrap_ops.scatter(
            d(R, 9, W), d(0), d(0, 8 * W), R),
        "parity8_encode": lambda d: parity8_ops.encode(d(0, 64)),
        "parity8_check": lambda d: parity8_ops.check(d(0, 64), d(0, 1)),
        "parity8_write": lambda d: parity8_ops.write(d(R, 9, 8), d(0),
                                                     d(0, 64), 16),
        "secded_encode": lambda d: secded_ops.encode(d(0, 8 * W)),
        "secded_decode": lambda d: secded_ops.decode(d(0, 8 * W), d(0, W)),
        "daec_encode": lambda d: daec_ops.encode(d(0, 8 * W)),
        "daec_decode": lambda d: daec_ops.decode(d(0, 8 * W), d(0, W)),
    }
    for S in (1, WIDTH_SHARDS):
        for daec in (0, 2 * S):
            def pool(dev, S=S, daec=daec):
                return make_sharded_pool(64, Layout.INTERWRAP, 32,
                                         num_shards=S, row_words=W,
                                         daec_rows=daec, device=dev)
            key = f"shard{S}{'-daec' if daec else ''}"
            calls[key + ".read"] = lambda d, pool=pool: pool(d.dev).read([])
            calls[key + ".read_status"] = \
                lambda d, pool=pool: pool(d.dev).read([], status=True)
            calls[key + ".read_any"] = \
                lambda d, pool=pool: shard_pool.read_any(pool(d.dev), [])
            calls[key + ".read_any_status"] = \
                lambda d, pool=pool: shard_pool.read_any_status(
                    pool(d.dev), [])
            calls[key + ".migrate"] = \
                lambda d, pool=pool: pool(d.dev).migrate([], []).storage

    def maker(dev):
        def make(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        make.dev = dev
        return make

    shapes = {}
    common.LAUNCHES.clear()
    for name, call in calls.items():
        got, want = call(maker(DEVICE)), call(maker("cpu"))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        check([(tuple(g.shape), g.dtype, g.device.type) for g in got]
              == [(tuple(w.shape), w.dtype, torch.device(DEVICE).type)
                  for w in want],
              f"n = 0: {name} on the card differs from the CPU")
        shapes[name] = [list(w.shape) for w in want]
    torch.cuda.synchronize()
    check(not common.LAUNCHES, f"n = 0 launched {dict(common.LAUNCHES)}")
    return dict(calls=len(shapes), shapes=shapes)


def width_times(torch, np, W: int) -> dict:
    """(d) at width W: each word path timed (median of 20 calls behind the
    device sleep) on WIDTH_TIME_PAGES pages of a pool of about
    WIDTH_TIME_BYTES whose every row carries SECDED codes, each beside its
    byte bound (and the SECDED decode's and encode's operations)."""
    from repro_torch.core.layouts import Layout, extra_page_count, total_pages
    from repro_torch.kernels.hash import ops as hash_ops
    from repro_torch.kernels.hash import ref as hash_ref
    from repro_torch.kernels.interwrap import ops as interwrap_ops
    from repro_torch.kernels.migrate import ops as migrate_ops
    from repro_torch.kernels.mixed import ops as mixed_ops
    from repro_torch.kernels.scrub import ops as scrub_ops
    from repro_torch.kernels.secded import ops as secded_ops
    from repro_torch.objcache import hash_index as hix

    S, n, D = WIDTH_SHARDS, WIDTH_TIME_PAGES, 8 * W
    R = WIDTH_TIME_BYTES // (36 * W) // (8 * S) * (8 * S)
    half = R // 2
    rng = np.random.default_rng(SEED + 80 + W)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 80 + W)
    sto = torch.randint(-2**31, 2**31, (R, 9, W), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    chunk = 1 << 16
    for a in range(0, R, chunk):
        b = min(R, a + chunk)
        sto[a:b, 8] = secded_ops.encode(
            sto[a:b, :8].reshape(b - a, D).contiguous())

    def pages(total: int, distinct: bool = False):
        p = rng.choice(total, n, replace=False) if distinct \
            else rng.integers(0, total, n)
        return torch.as_tensor(p, dtype=torch.int32, device=DEVICE)

    def read_bound(ids, boundary: int, rows: int, extra: int = 0) -> tuple:
        """Each distinct page (and a SECDED page's codes) read once, every
        page written once, the ids and ``extra`` words read; the SECDED
        pages' beats decoded."""
        u = torch.unique(ids)
        sec = int(((u >= boundary) & (u < rows)).sum())
        return bound_ms(4 * ((u.numel() + n) * D + n + sec * W + extra),
                        48 * sec * D // 2)

    out = dict(rows=R, storage_bytes=R * 9 * W * 4)
    ids = pages(total_pages(Layout.INTERWRAP, half, W) + R - half)
    out["mixed_read_correct"] = dict(
        ms=median_ms(lambda: mixed_ops.read_correct(
            sto, ids, Layout.INTERWRAP, R, half), 20),
        bound=read_bound(ids, half, R))
    banks = sto.view(S, R // S, 9, W)
    g = pages(R + S * extra_page_count(Layout.INTERWRAP, half // S, W))
    out["mixed_read_correct_routed"] = dict(
        ms=median_ms(lambda: mixed_ops.read_correct_routed(
            banks, g, Layout.INTERWRAP, R, half, S), 20),
        bound=read_bound(g, half, R))
    from repro_torch.shard import router
    shard, local = router.route(g.long(), R, S)
    own = torch.unique(local[shard == 0])
    sec = int(((own >= half // S) & (own < R // S)).sum())
    out["mixed_read_correct_routed_local"] = dict(
        ms=median_ms(lambda: mixed_ops.read_correct_routed_local(
            banks[0], g, Layout.INTERWRAP, R, half, S, 0), 20),
        bound=bound_ms(4 * ((own.numel() + n) * D + n + sec * W),
                       48 * sec * D // 2))
    index = hix.make_index(2 * n, CACHE_PROBE, device=DEVICE)
    keys = torch.as_tensor(rng.choice(2**31, n, replace=False),
                           dtype=torch.int32, device=DEVICE)
    index, _, _ = hix.insert(index, keys, ids, torch.zeros_like(keys),
                             torch.full_like(keys, D))
    q = keys[torch.as_tensor(rng.permutation(n), device=DEVICE)]
    hit = hash_ref.resolve_pages(index.key, index.page, q, CACHE_PROBE)
    out["hash_lookup_read"] = dict(     # and each query's probe window
        ms=median_ms(lambda: hash_ops.lookup_read(
            sto, index.key, index.page, q, Layout.INTERWRAP, R, half,
            CACHE_PROBE), 20),
        bound=read_bound(hit, half, R, extra=n * CACHE_PROBE))
    iw = pages(total_pages(Layout.INTERWRAP, R, W), distinct=True)
    out["migrate_gather_encode"] = dict(
        ms=median_ms(lambda: migrate_ops.gather_encode(sto, iw, R), 20),
        bound=bound_ms(4 * (2 * n * D + n * W + n), 40 * n * D // 2))
    out["interwrap_gather"] = dict(
        ms=median_ms(lambda: interwrap_ops.gather(sto, iw, R), 20),
        bound=bound_ms(4 * (2 * n * D + n), 0))
    data = torch.randint(-2**31, 2**31, (n, D), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    out["interwrap_scatter"] = dict(
        ms=median_ms(lambda: interwrap_ops.scatter(sto, iw, data, R), 20),
        bound=bound_ms(4 * (2 * n * D + n), 0))
    rows = sto[half:half + n]
    out["scrub_rows"] = dict(
        ms=median_ms(lambda: scrub_ops.scrub_rows(rows), 20),
        bound=bound_ms(4 * (2 * n * 9 * W + n * D // 2), 48 * n * D // 2))
    for r in out.values():
        if isinstance(r, dict):
            r["bound_ms"], r["bound_by"] = r.pop("bound")[:2]
    del sto, banks, rows, data, index
    torch.cuda.empty_cache()
    return out


def phase_widths(torch, np) -> tuple[dict, dict]:
    """Pools of row widths that are not a multiple of 8, on the card: (a)
    each pool kernel's word path bit-exact against its plain version at W
    = 7, 12 and 60, with SECDED flips in 1 % of the beats; (b) pools,
    4-bank pools and a VM through a mid-run repartition, card equal to the
    CPU bit for bit at W = 7 and 60; (c) every wrapper and sharded-pool
    read and migration at n = 0 with the CPU's shapes and no launch; (d)
    each word path timed beside its byte bound on a ~1 GiB pool at W = 60
    and 7. (b)'s launches are the phase's; the others' are checks'."""
    from repro_torch.kernels import common
    out = {}
    with uncounted():
        out["kernels"] = {W: width_kernels(torch, np, W)
                          for W in WIDTHS_CHECK}
    launches, runs = {}, {}
    for W in WIDTHS_POOL:
        common.LAUNCHES.clear()
        card, info = width_pool_run(torch, np, W, DEVICE)
        torch.cuda.synchronize()
        for k, v in common.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        cpu, _ = width_pool_run(torch, np, W, "cpu")
        check(same_results(torch, card, cpu),
              f"W={W}: the card's pools differ from the CPU's")
        check(info["migrated"][0] > 0, f"W={W}: the VM migrated no page")
        runs[W] = dict(results=len(card), **info)
    for k in ("mixed_read_correct_routed", "migrate_gather_encode",
              "interwrap_gather", "interwrap_scatter", "scrub_rows",
              "secded_decode", "daec_decode"):
        check(launches.get(k, 0) > 0, f"widths: no {k} launch")
    out["pools"] = dict(rows=WIDTH_ROWS, daec_rows=WIDTH_DAEC, runs=runs,
                        launches=launches)
    with uncounted():
        out["empty"] = width_empty(torch, np)
        out["times"] = {W: width_times(torch, np, W) for W in (60, 7)}
    return out, launches


LAUNCH_ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--secded-rows", "24"]
#: keys of the launcher's JSON that are times (not compared across devices)
LAUNCH_TIMES = {"wall_s", "tokens_per_s", "p50_latency_ms", "p99_latency_ms"}


def run_launcher(argv: list) -> dict:
    """``repro_torch.launch.serve.main(argv)`` -> the JSON it prints."""
    import io

    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return json.loads(buf.getvalue())


def untimed(out: dict) -> dict:
    """The launcher's JSON without its times."""
    return {k: v for k, v in out.items() if k not in LAUNCH_TIMES}


def phase_launch_serve(torch) -> tuple[dict, dict]:
    """The serving launcher at LAUNCH_ARGS on the card (its default
    device) and with --device cpu: equal JSON on every key that is not a
    time, one mixed read per decode step on the card."""
    from repro_torch.kernels import common
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    card = run_launcher(LAUNCH_ARGS)
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    cpu = run_launcher(LAUNCH_ARGS + ["--device", "cpu"])
    check(untimed(card) == untimed(cpu),
          f"launcher: card {card} != CPU {cpu}")
    check(card["requests"] == 8 and card["tokens"] == 8 * 12,
          f"launcher served {card}")
    check(launches.get("mixed_read_correct", 0) == card["decode_steps"],
          f"{launches.get('mixed_read_correct')} mixed reads for "
          f"{card['decode_steps']} decode steps")
    return dict(argv=LAUNCH_ARGS, card=card, cpu=cpu, equal=True,
                launches=launches), launches


def kv_rows(torch, cfg) -> int:
    """Pool rows at W in which all N_REQ sessions' KV (PROMPT + MAX_NEW
    tokens each) fits in CREAM mode (9/8 pages a row) but not in SECDED
    mode: the least multiple of 8 rows above 15/16 of the pages needed."""
    from repro_torch.models.transformer import num_attn_layers
    from repro_torch.serve.paged_kv import token_words_for
    per_page = 8 * W // token_words_for(cfg.num_kv_heads, cfg.head_dim_,
                                        torch.float32)
    need = N_REQ * num_attn_layers(cfg) * -(-(PROMPT + MAX_NEW) // per_page)
    need += 1                               # the engine's scratch page
    rows = -(-need * 15 // 128) * 8
    check(rows < need <= rows * 9 // 8, f"{need} pages in {rows} rows")
    return rows


def dense_greedy(torch, np, model, reqs, n: int) -> list:
    """``n`` greedy tokens of each request's prompt by repeated full
    forwards of the dense model (no KV cache)."""
    toks = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                           device=DEVICE)
    out = []
    for _ in range(n):
        logits, _ = model.forward(toks, logits_mode="last")
        nxt = logits.argmax(-1).to(toks.dtype)
        out.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1).tolist()


def check_rows_clean(pool, what: str) -> None:
    """Every row of an all-SECDED ``pool`` decodes with status 0 (the
    SECDED decode kernel over the whole storage)."""
    from repro_torch.kernels.secded import ops as secded_ops
    _, _, status = secded_ops.decode(
        pool.storage[:, :8, :].reshape(pool.num_rows, -1).contiguous(),
        pool.storage[:, 8, :].contiguous())
    check(int(status.max()) == 0, f"{what}: SECDED rows do not decode clean")


def check_pool_read(torch, eng) -> int:
    """POOL_CHECK_PAGES seeded pages (the last one too) of the engine's
    pool through the mixed read on the card and its plain version on a CPU
    copy: bit-exact. Launches made here are not counted. Returns the pages
    read."""
    import numpy as np

    from repro_torch.kernels import common
    from repro_torch.kernels.mixed import ops as mixed_ops
    pool = eng.pool
    counts = dict(common.LAUNCHES)
    rng = np.random.default_rng(SEED + 50)
    ids = torch.as_tensor(np.append(rng.choice(
        pool.num_pages - 1, POOL_CHECK_PAGES, replace=False),
        pool.num_pages - 1).astype(np.int32))
    got = mixed_ops.read_correct(pool.storage, ids.to(DEVICE), pool.layout,
                                 pool.num_rows, pool.boundary)
    want = mixed_ops.read_correct(pool.storage.cpu(), ids, pool.layout,
                                  pool.num_rows, pool.boundary)
    check(torch.equal(got.cpu(), want),
          "mixed read differs from its plain version on the serve pool")
    common.LAUNCHES.clear()
    common.LAUNCHES.update(counts)
    return int(ids.numel())


def serve_full_width(torch, np, arch: str, mode: str, rows: int):
    """``arch`` from the registry at full width and depth in float32 (random
    weights from SEED) serving the N_REQ requests at batch B, MAX_LEN, W:
    (engine, tokens, stats, launches, seconds)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    eng = Engine(cfg, max_batch=B, max_len=MAX_LEN, mode=mode, num_rows=rows,
                 row_words=W, seed=SEED, device=DEVICE)
    reqs = requests(np, cfg.vocab_size)
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    t0 = time.perf_counter()
    stats = eng.serve(reqs)
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
    return eng, reqs, stats, launches, wall


def model_shape(cfg) -> dict:
    return dict(layers=cfg.num_layers, d_model=cfg.d_model,
                heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim_, d_ff=cfg.d_ff,
                vocab=cfg.vocab_size, mlp=cfg.mlp_variant)


def phase_serve_starcoder2(torch, np) -> tuple[dict, list]:
    """starcoder2-7b at full width and depth in float32 (about 26.7 GiB of
    weights): the serve requests in cream and secded mode on kv_rows rows,
    equal tokens, more device pages in cream mode, preemptions in secded
    mode, one mixed read per decode step; the first request's tokens equal
    a dense greedy decode; a decode-step profile of the cream engine."""
    from repro_torch.configs import get_config
    cfg = get_config("starcoder2-7b")
    rows = kv_rows(torch, cfg)
    runs, launches, tokens = {}, [], {}
    for mode in ("cream", "secded"):
        eng, reqs, stats, l, wall = serve_full_width(
            torch, np, "starcoder2-7b", mode, rows)
        launches.append(l)
        tokens[mode] = [r.generated for r in reqs]
        runs[mode] = dict(summary(stats, l, wall),
                          pool_pages_checked=check_pool_read(torch, eng))
        if mode == "cream":
            t0 = time.perf_counter()
            dense = dense_greedy(torch, np, eng.model, reqs[:1], MAX_NEW)
            runs["dense_s"] = time.perf_counter() - t0
            check(dense[0] == tokens["cream"][0],
                  "starcoder2-7b: served tokens differ from the dense decode")
            runs["profile"] = decode_profile(torch, np, eng)
            drain(eng)
            runs["span_split"] = span_split(torch, np, eng)
        del eng
        torch.cuda.empty_cache()
    check(tokens["cream"] == tokens["secded"],
          "starcoder2-7b: secded tokens differ from cream tokens")
    check(runs["cream"]["device_pages"] > runs["secded"]["device_pages"],
          "cream mode must offer more device pages")
    check(runs["secded"]["preemptions"] > 0, "secded pool should preempt")
    check(launches[1].get("secded_encode", 0) > 0
          and launches[1].get("secded_decode", 0) > 0,
          "secded mode launched no SECDED codec")
    return dict(model=model_shape(cfg), dtype="float32", rows=rows,
                row_words=W, tokens_equal=True, dense_equal=True,
                **runs), launches


def phase_serve_musicgen(torch, np) -> tuple[dict, dict]:
    """musicgen-large at full width and depth in float32 (about 9 GiB):
    the serve requests in cream mode (head dim 64, MHA: 4 tokens a page),
    every request's tokens equal to a dense greedy decode."""
    from repro_torch.configs import get_config
    cfg = get_config("musicgen-large")
    rows = kv_rows(torch, cfg)
    eng, reqs, stats, launches, wall = serve_full_width(
        torch, np, "musicgen-large", "cream", rows)
    dense = dense_greedy(torch, np, eng.model, reqs, MAX_NEW)
    check(dense == [r.generated for r in reqs],
          "musicgen-large: served tokens differ from the dense decode")
    out = dict(model=model_shape(cfg), dtype="float32", rows=rows,
               row_words=W, dense_equal=True, **summary(stats, launches,
                                                        wall))
    del eng
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# Phases 32-35: the model families (MoE, Mamba, xLSTM)
# ---------------------------------------------------------------------------

OLMOE = "olmoe-1b-7b"
OLMOE_REF_LAYERS = 2       # olmoe-reference: full width, depth cut to 2
XLSTM_REQ, XLSTM_PROMPT, XLSTM_NEW = 4, 32, 16
#: decode-xlstm: the recurrent decode's logits against the parallel form's
#: rerun, as a share of the largest logit. The two float32 algorithms
#: part by rounding that grows with depth and with the decode steps the
#: recurrent state has absorbed: 3.5e-3 at 48 blocks after 15 steps on an
#: H100, 1e-5 at the CPU tests' smoke size
XLSTM_LOGIT_REL = 1e-2
XLSTM_PERIOD_LAYERS = 8    # the CPU twin: one period (7 mLSTM + 1 sLSTM)
FAMILIES = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
            "xlstm-1.3b")
MOE_FAMILIES = FAMILIES[:2]
FAMILY_STEPS = 3           # launch.train --smoke steps per family
FAMILY_TRAIN_ARGS = ["--smoke", "--steps", str(FAMILY_STEPS)]
FAMILY_SERVE_ARGS = ["--smoke", "--secded-rows", "24"]
#: profiler ranges of the MoE decode profile: label -> (module, function)
MOE_RANGES = {"moe": ("repro_torch.models.moe", "apply_moe"),
              "attention": ("repro_torch.models.attention",
                            "apply_attn_decode_paged")}


def resident_rows(torch, cfg) -> int:
    """Pool rows at W that hold all N_REQ sessions' KV (PROMPT + MAX_NEW
    tokens each) one page a row, so that neither a CREAM nor an all-SECDED
    pool preempts: a multiple of 8."""
    from repro_torch.models.transformer import num_attn_layers
    from repro_torch.serve.paged_kv import token_words_for
    per_page = 8 * W // token_words_for(cfg.num_kv_heads, cfg.head_dim_,
                                        torch.float32)
    need = N_REQ * num_attn_layers(cfg) * -(-(PROMPT + MAX_NEW) // per_page)
    return -(-(need + 1) // 8) * 8


def tree_bytes(tree) -> int:
    from repro_torch.distributed.sharding import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def dense_decode(torch, model, toks, n: int, max_len: int):
    """``n`` greedy tokens of each row of ``toks`` (B, S) through the dense
    decode path (``prefill_state``, then ``decode_step``): (tokens as
    lists, each step's logits (n, B, V) float32 on the CPU, host ms of
    each decode step, the state's bytes after the prefill and at the
    end)."""
    logits, state = model.prefill_state(toks, max_len, logits_mode="last")
    first = tree_bytes(state)
    out, lgs, ms = [], [], []
    for i in range(n):
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        lgs.append(logits.float().cpu())
        if i == n - 1:
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.decode_step(state, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return (torch.stack(out, 1).tolist(), torch.stack(lgs), ms,
            (first, tree_bytes(state)))


@contextlib.contextmanager
def profiler_ranges(torch, ranges: dict):
    """Inside, each function of ``ranges`` (label -> (module, name)) runs
    in a ``torch.profiler.record_function`` range of its label."""
    import importlib
    saved = []
    for label, (mod, name) in ranges.items():
        module = importlib.import_module(mod)
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def ranged(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)
        setattr(module, name, ranged)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def range_device_ms(prof, labels, per: int) -> dict:
    """Device ms per step of the kernels launched inside each profiler
    range of ``labels`` (CPU-side ranges: their kernels' summed times), and
    of those launched by ``aten::bmm`` inside the ``moe`` ranges: the expert
    products."""
    from collections import Counter

    from torch.autograd import DeviceType

    def dev_us(e) -> float:
        us = getattr(e, "device_time_total", None)
        return float(us if us is not None else e.cuda_time_total)

    def bmm_us(e) -> float:
        return sum(dev_us(c) if c.name == "aten::bmm" else bmm_us(c)
                   for c in e.cpu_children)

    total: Counter = Counter()
    experts = 0.0
    for e in prof.events():
        if e.name in labels and e.device_type == DeviceType.CPU:
            total[e.name] += dev_us(e)
            if e.name == "moe":
                experts += bmm_us(e)
    if not any(total.values()):
        return dict(range_time="not measured")
    return dict(ms_by_range={k: v / 1e3 / per for k, v in total.items()},
                expert_products_ms=experts / 1e3 / per)


def serve_alone(torch, np, eng, req, batched: list) -> dict:
    """``req``'s prompt served alone on ``eng`` (the parked sessions closed
    first, so it takes slot 0 and the others stay idle), against the dense
    KV decode at batch 1 (``prefill_state`` + ``decode_step``): equal
    tokens. Slot 0's choices come first in the MoE's flattened order and
    the decode capacity is 1 at batch B as at batch 1, so its routing is
    the batch of one's. Whether ``batched`` (request 0's tokens in the
    full run) equals them is printed, not held: in a full batch the
    request shares the capacity with the others."""
    from repro_torch.serve import ServeRequest
    for seq_id, sess in list(eng.sched.sessions.items()):
        if sess.slot is None:
            eng.sched.close_session(seq_id)
    alone = ServeRequest("alone0", req.prompt, MAX_NEW)
    eng.submit(alone)
    eng.poll()
    slots = eng.sched.slots
    check(slots[0] is not None and slots[0].seq_id == "alone0"
          and all(s is None for s in slots[1:]), "request 0 not alone")
    drain(eng)
    toks = torch.as_tensor(req.prompt[None], device=eng.device)
    dense, _, ms, _ = dense_decode(torch, eng.model, toks, MAX_NEW, MAX_LEN)
    check(dense[0] == alone.generated,
          f"{eng.cfg.name}: request 0 alone differs from the dense decode")
    return dict(tokens_equal_dense=True,
                batched_equal_alone=batched == alone.generated,
                dense_step_ms=statistics.median(ms))


def phase_serve_olmoe(torch, np) -> tuple[dict, list]:
    """olmoe-1b-7b at full width and depth in float32 (25.78 GiB of seeded
    weights, 64 experts top-8): the serve requests in cream and secded
    mode on resident_rows rows (neither preempts): equal tokens, one mixed
    read a decode step, every SECDED row decoding clean after the secded
    run; request 0 served alone equal to the dense KV decode at batch 1;
    a decode-step profile of the cream engine with the MoE mixers, their
    expert products and the attention blocks timed apart; then a secded
    run on kv_rows rows that preempts, whose tokens are not compared (the
    MoE's output depends on who shares a step, and preemption changes
    that)."""
    from repro_torch.configs import get_config
    cfg = get_config(OLMOE)
    rows = resident_rows(torch, cfg)
    runs, launches, tokens = {}, [], {}
    for mode in ("cream", "secded"):
        torch.cuda.reset_peak_memory_stats()
        eng, reqs, stats, l, wall = serve_full_width(torch, np, OLMOE, mode,
                                                     rows)
        launches.append(l)
        tokens[mode] = [r.generated for r in reqs]
        check(stats["preemptions"] == 0, f"olmoe {mode} run preempted")
        runs[mode] = dict(summary(stats, l, wall),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          pool_pages_checked=check_pool_read(torch, eng))
        if mode == "cream":
            runs["alone"] = serve_alone(torch, np, eng, reqs[0],
                                        tokens["cream"][0])
            with profiler_ranges(torch, MOE_RANGES):
                runs["profile"] = decode_profile(torch, np, eng,
                                                 ranges=tuple(MOE_RANGES),
                                                 count=True)
            drain(eng)
        else:
            check_rows_clean(eng.pool, "olmoe-1b-7b")
            runs[mode]["rows_clean"] = True
        del eng
        torch.cuda.empty_cache()
    check(tokens["cream"] == tokens["secded"],
          "olmoe-1b-7b: secded tokens differ from cream tokens")
    check(runs["cream"]["device_pages"] > runs["secded"]["device_pages"],
          "cream mode must offer more device pages")
    check(launches[1].get("secded_encode", 0) > 0,
          "secded mode launched no SECDED encode")
    small = kv_rows(torch, cfg)
    eng, reqs, stats, l, wall = serve_full_width(torch, np, OLMOE, "secded",
                                                 small)
    launches.append(l)
    check(stats["preemptions"] > 0, "olmoe secded pool should preempt")
    check(l.get("secded_decode", 0) > 0,
          "the preempting secded run launched no SECDED decode")
    runs["secded_preempting"] = dict(summary(stats, l, wall), rows=small,
                                     tokens_compared=False)
    del eng
    torch.cuda.empty_cache()
    return dict(model=dict(model_shape(cfg), experts=cfg.num_experts,
                           top_k=cfg.experts_per_token,
                           expert_d_ff=cfg.moe_d_ff),
                params=cfg.param_count(),
                active_params=cfg.active_param_count(), dtype="float32",
                rows=rows, row_words=W, tokens_equal=True, **runs), launches


def phase_olmoe_reference(torch, np) -> dict:
    """olmoe-1b-7b at full width with its depth cut to OLMOE_REF_LAYERS,
    float32: the serve requests through the port's engine on the card and
    on the CPU from the same weights (same scheduler, so the same batches):
    identical tokens, the last decode step's logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(get_config(OLMOE), dtype="float32",
                              num_layers=OLMOE_REF_LAYERS)
    rows = resident_rows(torch, cfg)
    engines, last, tokens = {}, {}, {}
    for dev in ("cpu", DEVICE):
        eng = Engine(cfg, max_batch=B, max_len=MAX_LEN, mode="cream",
                     num_rows=rows, row_words=W, seed=SEED, device=dev)

        def keep_logits(*a, _fn=eng.model.decode_step_paged, _dev=dev,
                        **k):
            out = _fn(*a, **k)
            last[_dev] = out[0].float().cpu()
            return out
        eng.model.decode_step_paged = keep_logits
        engines[dev] = eng
    engines[DEVICE].model.load_state_dict(engines["cpu"].model.state_dict())
    seconds = {}
    for dev, eng in engines.items():
        reqs = requests(np, cfg.vocab_size)
        t0 = time.perf_counter()
        eng.serve(reqs)
        seconds[dev] = time.perf_counter() - t0
        tokens[dev] = [r.generated for r in reqs]
    check(tokens["cpu"] == tokens[DEVICE],
          "olmoe-reference: card and CPU decode different tokens")
    err = float((last[DEVICE] - last["cpu"]).abs().max())
    check(err <= 1e-4, f"olmoe-reference: last logits differ by {err}")
    return dict(layers=OLMOE_REF_LAYERS, d_model=cfg.d_model,
                experts=cfg.num_experts, tokens_equal=True,
                decode_steps=engines[DEVICE].steps,
                max_abs_last_logit_err=err, seconds=seconds)


def parallel_rerun(torch, model, toks, got: list, lgs) -> list:
    """The parallel-form forward of ``model`` over each prefix of ``toks``
    grown by the decoded tokens ``got`` against the dense decode's logits
    ``lgs`` (n, B, V): equal greedy tokens, logits within
    XLSTM_LOGIT_REL of their scale. Returns each step's error, as a share
    of the step's largest parallel logit."""
    n = len(got[0])
    grown = torch.cat([toks, torch.as_tensor(got, dtype=torch.int32,
                                             device=toks.device)], dim=1)
    rel, pars = [], []
    for i in range(n):
        par, _ = model.forward(grown[:, :toks.shape[1] + i],
                               logits_mode="last")
        par = par.float().cpu()
        check(par.argmax(-1).tolist() == [t[i] for t in got],
              f"xlstm: parallel and recurrent tokens differ at step {i}")
        rel.append(rel_err(par, lgs[i]))
        pars.append(par)
    check(max(rel) <= XLSTM_LOGIT_REL,
          f"xlstm: logits differ by {max(rel)} of scale")
    return rel, pars


def rel_err(want, got) -> float:
    """Largest difference as a share of ``want``'s largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


def phase_decode_xlstm(torch, np) -> tuple[dict, dict]:
    """xlstm-1.3b at full width and depth in float32 (48 blocks, 7 mLSTM +
    1 sLSTM a period, 7.24 GiB): XLSTM_REQ prompts of XLSTM_PROMPT tokens
    and XLSTM_NEW greedy tokens through the dense decode path, equal to
    the parallel-form forward rerun on the grown sequence (logits within
    XLSTM_LOGIT_REL of their scale), the decode state's bytes constant;
    the same weights on the CPU for one decode step (tokens equal; the
    two forms' rounding there, and the card's parallel logits against the
    CPU's, printed); then one period (8 blocks) at full width on the card
    and on the CPU from the same weights: equal tokens, logits within
    1e-4 of their scale, and its own parallel rerun on the card (the
    rounding at one period's depth)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), dtype="float32")
    rng = np.random.default_rng(SEED + 30)
    prompts = rng.integers(0, cfg.vocab_size, (XLSTM_REQ, XLSTM_PROMPT))
    max_len = XLSTM_PROMPT + XLSTM_NEW
    model = build_model(cfg, seed=SEED, device=DEVICE)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.LAUNCHES.clear()                 # counts of the main path only
    t0 = time.perf_counter()
    got, lgs, ms, (b0, b1) = dense_decode(torch, model, toks, XLSTM_NEW,
                                          max_len)
    decode_s = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(b0 == b1, f"decode state grew from {b0} to {b1} bytes")
    t0 = time.perf_counter()
    rel, pars = parallel_rerun(torch, model, toks, got, lgs)
    parallel_s = time.perf_counter() - t0
    # the same weights on the CPU, one decode step: how far float32
    # rounding alone parts the two forms at full depth there, and the
    # card's parallel form from the CPU's
    model.to("cpu")
    torch.cuda.empty_cache()
    ctoks = toks.cpu()
    c_got, c_lgs, _, _ = dense_decode(torch, model, ctoks, 2, max_len)
    check(c_got == [t[:2] for t in got],
          "xlstm: card and CPU decode different tokens at full depth")
    c_par, _ = model.forward(torch.cat(
        [ctoks, torch.as_tensor(c_got, dtype=torch.int32)[:, :1]], dim=1),
        logits_mode="last")
    cpu_depth = dict(rec_vs_par_rel=rel_err(c_par, c_lgs[1]),
                     card_par_vs_cpu_par_rel=rel_err(c_par, pars[1]),
                     card_rec_vs_cpu_rec_rel=rel_err(c_lgs[1], lgs[1]))
    del model

    twin = dataclasses.replace(cfg, num_layers=XLSTM_PERIOD_LAYERS)
    cpu = build_model(twin, seed=SEED, device="cpu")
    card = build_model(twin, seed=SEED, device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    tc, lc, _, _ = dense_decode(torch, cpu, toks.cpu(), XLSTM_NEW, max_len)
    tg, lg, _, _ = dense_decode(torch, card, toks, XLSTM_NEW, max_len)
    check(tc == tg, "xlstm twin: card and CPU decode different tokens")
    # float32 rounding on two devices through 8 full-width blocks and 15
    # steps of recurrent state: held as a share of the logits' scale
    err = float((lg - lc).abs().max())
    err_rel = err / float(lc.abs().max())
    check(err_rel <= 1e-4, f"xlstm twin: logits differ by {err_rel} of "
          "their scale")
    twin_rel, _ = parallel_rerun(torch, card, toks, tg, lg)
    del cpu, card
    torch.cuda.empty_cache()
    return dict(model=dict(model_shape(cfg), blocks="7 mLSTM + 1 sLSTM"),
                params=cfg.param_count(), dtype="float32",
                requests=XLSTM_REQ, prompt=XLSTM_PROMPT, new=XLSTM_NEW,
                tokens_equal_parallel=True, max_logit_rel_err=max(rel),
                logit_rel_err_by_step=rel, logit_rel_tol=XLSTM_LOGIT_REL,
                state_bytes=b0,
                decode_step_ms=statistics.median(ms),
                decode_step_ms_range=[min(ms), max(ms)],
                ms_per_token=statistics.median(ms) / XLSTM_REQ,
                decode_s=decode_s, parallel_rerun_s=parallel_s,
                peak_gib=peak, cpu_first_step=cpu_depth,
                twin=dict(layers=XLSTM_PERIOD_LAYERS, tokens_equal=True,
                          max_abs_logit_err=err, max_logit_rel_err=err_rel,
                          parallel_rel_err_by_step=twin_rel),
                launches=launches), launches


def phase_families_smoke(torch, np) -> tuple[dict, dict]:
    """Each family's smoke config on the card: repro_torch.launch.train
    --smoke for FAMILY_STEPS steps (finite losses); for the MoE configs
    repro_torch.launch.serve FAMILY_SERVE_ARGS on the card and with
    --device cpu (equal JSON but times, one mixed read a decode step);
    then jamba's dense decode on the card against the CPU from the same
    weights (equal tokens, logits within 1e-4)."""
    import io

    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.launch import train
    from repro_torch.models import build_model
    out = {}
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    for arch in FAMILIES:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            tr = train.main(["--arch", arch, *FAMILY_TRAIN_ARGS])
        losses = [float(m["loss"]) for m in tr.metrics_log]
        check(len(losses) == FAMILY_STEPS
              and all(np.isfinite(x) for x in losses),
              f"{arch}: train losses {losses}")
        out[arch] = dict(train_losses=losses,
                         train_s=time.perf_counter() - t0,
                         printed=buf.getvalue().strip().splitlines()[-1])
        del tr
        if arch in MOE_FAMILIES:
            argv = ["--arch", arch, *FAMILY_SERVE_ARGS]
            before = common.LAUNCHES.get("mixed_read_correct", 0)
            card = run_launcher(argv)
            reads = common.LAUNCHES.get("mixed_read_correct", 0) - before
            with uncounted():
                cpu = run_launcher(argv + ["--device", "cpu"])
            check(untimed(card) == untimed(cpu),
                  f"{arch} launcher: card {card} != CPU {cpu}")
            check(card["requests"] == 8 and card["tokens"] == 8 * 12,
                  f"{arch} launcher served {card}")
            check(reads == card["decode_steps"],
                  f"{arch}: {reads} mixed reads for {card['decode_steps']} "
                  "decode steps")
            out[arch]["serve"] = dict(card=card, equal_cpu=True)
    launches = dict(common.LAUNCHES)
    cfg = get_config("jamba-1.5-large-398b").smoke()
    cpu = build_model(cfg, seed=SEED, device="cpu")
    card = build_model(cfg, seed=SEED, device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(SEED + 31).integers(0, cfg.vocab_size,
                                                     (2, 16))
    toks = torch.as_tensor(toks, dtype=torch.int32)
    tc, lc, _, _ = dense_decode(torch, cpu, toks, 8, 32)
    tg, lg, _, _ = dense_decode(torch, card, toks.to(DEVICE), 8, 32)
    check(tc == tg, "jamba: card and CPU decode different tokens")
    err = float((lg - lc).abs().max())
    check(err <= 1e-4, f"jamba: card and CPU logits differ by {err}")
    out["jamba_dense_decode"] = dict(tokens_equal=True, max_abs_logit_err=err)
    return dict(steps=FAMILY_STEPS, launches=launches, **out), launches


# ---------------------------------------------------------------------------
# Phases 28-31: SoftECC and the training path
# ---------------------------------------------------------------------------

#: the cache phases' 16384 rows, cut to a multiple of SoftECC's 9-row group
SOFTECC_ROWS = 16380
SOFTECC_SMALL = 72         # rows of the card-vs-CPU SoftECC pool
SOFTECC_FLIPS = 16         # single-bit flips planted in the large pool
SOFTECC_LINES = 65536      # line accesses of the plan_line_ops trace
SOFTECC_CACHE_LINES = 512  # code lines the LLC lends SoftECC


def softecc_sequence(torch, np, device) -> dict:
    """A SoftECC pool of SOFTECC_SMALL rows at W on ``device``: seeded
    pages written, a data-bit single, a code-bit single and a same-beat
    double planted, every page read, then a scrub -> host copies of the
    reads, statuses, stats and storage."""
    from repro_torch.core import softecc
    from repro_torch.kernels.common import to_u32
    rng = np.random.default_rng(SEED + 40)
    st = softecc.make_softecc(SOFTECC_SMALL, W, device=device)
    data = rng.integers(0, 2**32, (st.num_pages, st.page_words),
                        dtype=np.uint32)
    st = softecc.write_pages(st, np.arange(st.num_pages), data)
    st.storage[0, 3, 17] ^= 1 << 5                    # page 0: data bit
    st.storage[8, 2, 9] ^= 1 << 30                    # page 2's codes
    st.storage[10, 1, 4] ^= 0b11 << 7                 # page 9: one beat
    reads, status = softecc.read_pages(st, np.arange(st.num_pages))
    st2, stats = softecc.scrub(st)
    return dict(reads=to_u32(reads), status=status.cpu().numpy(),
                stats=stats, storage=to_u32(st2.storage))


def phase_softecc(torch, np) -> tuple[dict, dict]:
    """SoftECC (the Virtualized-ECC baseline): the same seeded sequence on
    a SOFTECC_SMALL-row pool on the card and the CPU, bit for bit; then at
    the cache phases' scale (SOFTECC_ROWS rows of W) on the card: every
    page written, SOFTECC_FLIPS single-bit flips planted in distinct pages
    (data rows and code slices), a scrub whose census is exactly the
    planted flips and whose storage is the unflipped pool's, and seeded
    pages' code slices against the CPU plain encode. Then the access
    accounting: per layout the DRAM operations of a line read and write
    (plan_line_access / count_device_ops, regular and extra pages) and
    the parallelism groups, and plan_line_ops over a seeded trace with an
    LLC code cache."""
    from repro_torch.core import layouts, softecc
    from repro_torch.kernels import common
    from repro_torch.kernels.secded import ref as secded_ref
    card = softecc_sequence(torch, np, DEVICE)
    host = softecc_sequence(torch, np, "cpu")
    check(card["stats"] == host["stats"] == {"corrected_pages": 2,
                                              "uncorrectable_pages": 1},
          f"SoftECC scrub stats {card['stats']} / {host['stats']}")
    for k in ("reads", "status", "storage"):
        check(np.array_equal(card[k], host[k]), f"SoftECC {k}: card != CPU")
    rng = np.random.default_rng(SEED + 41)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    st = softecc.make_softecc(SOFTECC_ROWS, W, device=DEVICE)
    n = st.num_pages
    data = torch.randint(-2**31, 2**31, (n, st.page_words), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = softecc.write_pages(st, np.arange(n), data)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    clean = st.storage.clone()
    pages = rng.choice(n, SOFTECC_FLIPS, replace=False)
    for i, page in enumerate(pages):
        data_row, code_row, _ = softecc._locate(st, int(page))
        w, b = int(rng.integers(0, W)), int(rng.integers(0, 31))
        if i % 2:                       # a bit of the page's code slice
            st.storage[code_row, int(page) % 8, w] ^= 1 << b
        else:
            st.storage[data_row, int(rng.integers(0, 8)), w] ^= 1 << b
    got, status = softecc.read_pages(st, pages)
    check(torch.equal(got, data[torch.as_tensor(pages, device=DEVICE)]),
          "SoftECC read did not correct the planted flips")
    check(sorted(set(status.tolist())) == [1, 2],
          f"SoftECC statuses {status.tolist()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st2, stats = softecc.scrub(st)
    torch.cuda.synchronize()
    scrub_s = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    check(stats == {"corrected_pages": SOFTECC_FLIPS,
                    "uncorrectable_pages": 0},
          f"SoftECC census {stats} for {SOFTECC_FLIPS} planted flips")
    check(torch.equal(st2.storage, clean), "scrubbed pool != unflipped pool")
    sample = rng.choice(n, 64, replace=False)
    codes = torch.stack([softecc._code_slice(st2, int(p)) for p in sample])
    check(torch.equal(codes.cpu(), secded_ref.encode(
        data[torch.as_tensor(sample, device=DEVICE)].cpu())),
          "SoftECC codes differ from the CPU plain encode")
    del st, st2, clean, data, got
    torch.cuda.empty_cache()
    acct = {}
    for layout in layouts.Layout:
        rows = 64
        extra = layouts.extra_page_count(layout, rows)
        acct[layout.value] = dict(
            parallelism_groups=layouts.parallelism_groups(layout),
            read_ops=layouts.count_device_ops(layout, rows, 3, False),
            write_ops=layouts.count_device_ops(layout, rows, 3, True),
            read_accesses=len(layouts.plan_line_access(layout, rows, 3,
                                                       False)),
            extra_read_ops=layouts.count_device_ops(layout, rows, rows,
                                                    False) if extra else None,
            extra_write_ops=layouts.count_device_ops(layout, rows, rows,
                                                     True) if extra else None)
    cache = softecc.CodeCache(SOFTECC_CACHE_LINES)
    ops = {"read": 0, "write": 0}
    trace = rng.integers(0, n, SOFTECC_LINES)
    writes = rng.random(SOFTECC_LINES) < 0.3
    for page, line, wr in zip(trace, rng.integers(0, 128, SOFTECC_LINES),
                              writes):
        ops["write" if wr else "read"] += softecc.plan_line_ops(
            int(page), int(line), bool(wr), cache)
    return dict(rows=SOFTECC_ROWS, row_words=W, pages=n,
                pool_gib=SOFTECC_ROWS * 8 * W * 4 / 2**30,
                card_equals_cpu=dict(rows=SOFTECC_SMALL, **card["stats"]),
                planted=SOFTECC_FLIPS, census=stats, write_s=write_s,
                scrub_s=scrub_s, layouts=acct,
                line_ops=dict(lines=SOFTECC_LINES,
                              cache_lines=SOFTECC_CACHE_LINES,
                              hits=cache.hits, misses=cache.misses,
                              ops_per_line=(ops["read"] + ops["write"])
                              / SOFTECC_LINES, **ops),
                launches=launches), launches


TINY_TRAIN = dict(name="tiny-ft", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                  head_dim=16, dtype="float32")


def same_tree(torch, a, b) -> bool:
    """Two trees of tensors with equal paths and bit-identical leaves."""
    from repro_torch.distributed.sharding import tree_paths
    fa, fb = tree_paths(a), tree_paths(b)
    return list(fa) == list(fb) and all(
        x.dtype == fb[k].dtype and torch.equal(x.cpu(), fb[k].cpu())
        for k, x in fa.items())


def phase_train_reference(torch, np) -> dict:
    """tests/test_fault_tolerance.py's TINY config (float32) trained 4 steps
    through the port's Trainer on the card and on the CPU from the same
    weights (drawn on the CPU, loaded on the card) and the same batches:
    losses and grad norms within 1e-4 relative; on each device a warm
    restore gives back the snapshotted moments bit for bit; a checkpoint
    saved on the card restores bit-exact on the card and on the CPU."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.train.trainer import make_trainer
    cfg = ModelConfig(**TINY_TRAIN)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=40,
                       scrub_every=2, checkpoint_every=0)
    ck = common_build() / "train_reference_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    host = make_trainer(cfg, tcfg, seq_len=32, global_batch=4, device="cpu")
    card = make_trainer(cfg, tcfg, seq_len=32, global_batch=4, device=DEVICE,
                        ckpt_dir=str(ck))
    card.load_params(tree_map(lambda t: t.clone(), host.params))
    logs = {"cpu": host.run(4), "card": card.run(4)}
    rel = {k: max(abs(a[k] - b[k]) / abs(b[k])
                  for a, b in zip(logs["card"], logs["cpu"]))
           for k in ("loss", "grad_norm")}
    check(max(rel.values()) <= 1e-4, f"card vs CPU training: {rel}")
    warm = {}
    for name, tr in (("card", card), ("cpu", host)):
        tr.snapshot_moments()
        before = (tree_map(torch.clone, tr.opt_state.m),
                  tree_map(torch.clone, tr.opt_state.v))
        worst = tr.warm_restore()
        warm[name] = worst
        check(worst == 0 and same_tree(torch, before[0], tr.opt_state.m)
              and same_tree(torch, before[1], tr.opt_state.v),
              f"{name}: warm restore is not bit-identical (worst {worst})")
    card.save()
    tree = card._ckpt_tree()
    back, rep = card.checkpointer.restore(card.step, like=tree)
    check(rep.clean and same_tree(torch, back, tree),
          "card checkpoint round trip is not bit-exact")
    flat, rep2 = Checkpointer(str(ck), device="cpu").restore(card.step)
    check(rep2.clean and same_tree(torch, flat, tree),
          "the card's checkpoint restores differently on the CPU")
    shutil.rmtree(ck, ignore_errors=True)
    return dict(steps=4, rel_err=rel, losses={k: [r["loss"] for r in v]
                                              for k, v in logs.items()},
                warm_restore_worst=warm, checkpoint_bit_exact=True)


def common_build() -> Path:
    from repro_torch.kernels import common
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return common.BUILD_DIR


TRAIN_ARCH = "qwen3-0.6b"
TRAIN_STEPS = 20           # the reference launcher's default
TRAIN_RESUME_STEPS = 1     # the resumed launcher run's steps (one save)
TRAIN_FLIPS = 5            # bit flips the recovery ladder's scrub repairs
PLAIN_ROWS = 32768         # pool rows the plain versions take at once


def plain_chunks(rows: int):
    """``(start, stop)`` spans of PLAIN_ROWS rows covering ``rows``."""
    return ((a, min(a + PLAIN_ROWS, rows)) for a in range(0, rows, PLAIN_ROWS))


def hold_pool_codes(torch, storage) -> int:
    """Every row's code lane of a whole-SECDED pool (written by the main
    path's one secded_encode launch over all its pages) against the plain
    encode of the row's data lanes, chunk by chunk on the card. A SECDED
    row is its page: page p's data is row p's 8 lanes. -> rows held."""
    from repro_torch.kernels.secded import ref as secded_ref
    R = storage.shape[0]
    for a, b in plain_chunks(R):
        want = secded_ref.encode(storage[a:b, :8].reshape(b - a, -1))
        check(torch.equal(want, storage[a:b, 8]),
              f"pool rows {a}:{b}: code lane != plain encode")
    return R


def hold_scrub(torch, flipped, scrubbed) -> list:
    """The main path's scrub of a whole-SECDED pool (``flipped`` ->
    ``scrubbed``, one scrub_rows launch over every row) against the plain
    sweep of the same rows, chunk by chunk on the card: equal storage. The
    kernel runs once more over all of ``flipped`` (not counted) for its
    per-beat status, which must equal the plain one. -> status histogram
    [clean, data fixed, code fixed, uncorrectable]."""
    from repro_torch.kernels.scrub import ops as scrub_ops
    from repro_torch.kernels.scrub import ref as scrub_ref
    with uncounted():
        out, status = scrub_ops.scrub_rows(flipped)
    check(torch.equal(out, scrubbed), "scrub_rows is not deterministic")
    del out
    hist = torch.zeros(4, dtype=torch.int64, device=flipped.device)
    for a, b in plain_chunks(flipped.shape[0]):
        want, want_st = scrub_ref.scrub_rows(flipped[a:b])
        check(torch.equal(want, scrubbed[a:b])
              and torch.equal(want_st, status[a:b]),
              f"pool rows {a}:{b}: scrub != plain scrub")
        hist += torch.bincount(want_st.reshape(-1), minlength=4)
    return hist.tolist()


def hold_decode(torch, flipped) -> list:
    """The secded_decode launch of the warm restore's read at its shape
    (every page of the pool: (R, 8W) data, (R, W) codes, gathered as the
    read gathers them) over the flipped pool (not counted), against the
    plain decode chunk by chunk on the card: data, codes and per-beat
    status equal. -> status histogram."""
    from repro_torch.kernels.secded import ops as secded_ops
    from repro_torch.kernels.secded import ref as secded_ref
    R = flipped.shape[0]
    data = flipped[:, :8].reshape(R, -1).contiguous()
    codes = flipped[:, 8].contiguous()
    with uncounted():
        got = secded_ops.decode(data, codes)
    hist = torch.zeros(4, dtype=torch.int64, device=flipped.device)
    for a, b in plain_chunks(R):
        want = secded_ref.decode(data[a:b], codes[a:b])
        check(all(torch.equal(w, g[a:b]) for w, g in zip(want, got)),
              f"pool rows {a}:{b}: decode != plain decode")
        hist += torch.bincount(want[2].reshape(-1), minlength=4)
    return hist.tolist()


def phase_train(torch, np) -> tuple[dict, dict]:
    """qwen3-0.6b from the registry at full width (28 layers, d 1024, vocab
    151936, bfloat16, 596.0 M parameters) trained through the port's
    launcher in-process (repro_torch.launch.train.main), at the reference
    launcher's defaults (sequence 128, global batch 8, scrub every 10
    steps, a checkpoint every 10): TRAIN_STEPS steps with two saves, then
    the launcher again on the same directory (it must resume at step 20)
    for TRAIN_RESUME_STEPS step. Then the recovery ladder on a
    make_trainer of the same config: TRAIN_FLIPS flips in the 5.00 GiB
    moment pool repaired by the scrub kernel (scrub-repair), a warm
    restart whose moments equal the optimizer's bit for bit, a targeted
    restore and a cold restart from the last checkpoint. Free disk space
    is checked before the first save; the directory is removed at the
    end."""
    import io
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import injection
    from repro_torch.distributed.fault_tolerance import recover
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.kernels import common
    from repro_torch.launch import train as launch_train
    from repro_torch.models import count_params
    from repro_torch.train.trainer import Trainer, make_trainer
    cfg = launch_train.get_config(TRAIN_ARCH)       # as the launcher reads it
    n_params = count_params(cfg)
    ck = common_build() / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    ck.mkdir(parents=True)
    # a save: bf16 params, float32 m and v, their SECDED codes (1/8)
    save_bytes = int(n_params * (2 + 4 + 4) * 9 / 8)
    free = shutil.disk_usage(ck).free
    saves_needed = 3
    if free < saves_needed * save_bytes * 1.1:
        raise RuntimeError(f"{free / 2**30:.1f} GiB free under {ck}; the "
                           f"phase needs {saves_needed} saves of "
                           f"{save_bytes / 2**30:.2f} GiB")
    saves, restores, snaps, scrubs = [], [], [], []
    orig = (Checkpointer.save, Checkpointer.restore,
            Trainer.snapshot_moments, Trainer.scrub_pools)

    def timed(fn, log, step_dir=False):
        """``fn`` timed to the card's end; a checkpoint's size on disk
        too (its step directory: the first argument is the step)."""
        def wrapped(self, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            rec = {"s": time.perf_counter() - t}
            if step_dir:
                rec["bytes"] = sum(f.stat().st_size for f in
                                   Path(self.step_dir(a[0])).iterdir())
            log.append(rec)
            return out
        return wrapped

    Checkpointer.save = timed(orig[0], saves, step_dir=True)
    Checkpointer.restore = timed(orig[1], restores, step_dir=True)
    Trainer.snapshot_moments = timed(orig[2], snaps)
    Trainer.scrub_pools = timed(orig[3], scrubs)
    argv = ["--arch", TRAIN_ARCH, "--ckpt-dir", str(ck), "--device", DEVICE]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.LAUNCHES.clear()             # counts of the main path only
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            tr = launch_train.main(argv + ["--steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        check(len(lines) == 1 and lines[0].startswith(
            f"{cfg.name}: loss ") and lines[0].endswith(
            f"over {TRAIN_STEPS} steps"), f"launcher printed {lines}")
        # m and v in float32, in pages of 8 rows of 256 words, 8-row groups
        rows = -(-2 * n_params // (8 * 256 * 8)) * 8
        check(tr.moment_pool.num_rows == rows and
              tr.params["embed"]["table"].dtype == cfg.activation_dtype,
              f"moment pool of {tr.moment_pool.num_rows} rows, not {rows}")
        step_s = [r["wall_s"] for r in tr.metrics_log[1:]]
        losses = [r["loss"] for r in tr.metrics_log]
        pool_gib = tr.moment_pool.raw_bytes / 2**30
        check(all(np.isfinite(losses)), f"losses {losses}")
        scrub_log = [r["scrub"] for r in tr.metrics_log if "scrub" in r]
        check(all(r["corrected"] == 0 == r["uncorrectable"]
                  for r in scrub_log), f"scrubs {scrub_log}")
        del tr
        torch.cuda.empty_cache()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            tr = launch_train.main(argv + ["--steps",
                                           str(TRAIN_RESUME_STEPS)])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        lines2 = out.getvalue().splitlines()
        check(lines2[0] == f"resumed at step {TRAIN_STEPS}"
              and tr.step == TRAIN_STEPS + TRAIN_RESUME_STEPS,
              f"resumed launcher printed {lines2}")
        del tr
        torch.cuda.empty_cache()
        # the recovery ladder at full width
        tcfg = TrainConfig(total_steps=100, scrub_every=10,
                           checkpoint_every=10)
        tr = make_trainer(cfg, tcfg, ckpt_dir=str(ck), device=DEVICE)
        tr.run(2)
        tr.snapshot_moments()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # the 5.00 GiB pool's kernels against their plain versions: the
        # snapshot's encode, the rung-1 scrub and the warm restore's decode
        held = dict(encode_rows=hold_pool_codes(torch,
                                                tr.moment_pool.storage))
        rng = np.random.default_rng(SEED + 50)
        flipped, recs = injection.inject_flips(tr.moment_pool.storage, rng,
                                               TRAIN_FLIPS)
        tr.moment_pool = dataclasses.replace(tr.moment_pool, storage=flipped)
        ladder = [recover(tr, "sdc_single_bit")]
        check(ladder[0].rung == "scrub-repair"
              and ladder[0].details["corrected"] == TRAIN_FLIPS
              and ladder[0].details["uncorrectable"] == 0,
              f"rung 1: {ladder[0]}")
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated())
        held["scrub_status"] = hold_scrub(torch, flipped,
                                          tr.moment_pool.storage)
        held["decode_status"] = hold_decode(torch, flipped)
        check(held["scrub_status"] == held["decode_status"]
              and sum(held["scrub_status"][1:3]) == TRAIN_FLIPS
              and held["scrub_status"][3] == 0,
              f"flipped pool's beats: {held}")
        del flipped
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()    # the path's peak, not theirs
        before = (tree_map(torch.clone, tr.opt_state.m),
                  tree_map(torch.clone, tr.opt_state.v))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ladder.append(recover(tr, "process_crash"))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        check(ladder[1].rung == "warm-restart"
              and ladder[1].details["worst_status"] == 0
              and same_tree(torch, before[0], tr.opt_state.m)
              and same_tree(torch, before[1], tr.opt_state.v),
              f"rung 3: {ladder[1]}")
        del before
        torch.cuda.empty_cache()
        ladder.append(recover(tr, "sdc_multi_bit"))
        check(ladder[2].rung == "targeted-restore"
              and ladder[2].details["restored_at_step"]
              == TRAIN_STEPS + TRAIN_RESUME_STEPS, f"rung 2: {ladder[2]}")
        ladder.append(recover(tr, "host_loss"))
        check(ladder[3].rung == "cold-restart"
              and ladder[3].details["restored"], f"rung 4: {ladder[3]}")
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated())
        launches = dict(common.LAUNCHES)
        del tr
        torch.cuda.empty_cache()
    finally:
        (Checkpointer.save, Checkpointer.restore, Trainer.snapshot_moments,
         Trainer.scrub_pools) = orig
        shutil.rmtree(ck, ignore_errors=True)
    for k in ("secded_encode", "secded_decode", "scrub_rows"):
        check(launches.get(k, 0) > 0, f"train: no {k} launch")
    return dict(arch=TRAIN_ARCH, params=n_params, seq_len=128,
                global_batch=8, steps=TRAIN_STEPS, printed=lines + lines2,
                losses=losses,
                step_ms_median=statistics.median(step_s) * 1e3,
                step_ms=[x * 1e3 for x in step_s],
                # every timed step's tokens over their summed times
                tokens_per_s=len(step_s) * 8 * 128 / sum(step_s),
                first_run_s=first_s, resumed_run_s=resume_s,
                peak_gib=peak / 2**30, moment_pool_gib=pool_gib,
                snapshot_ms=[r["s"] * 1e3 for r in snaps],
                scrub_ms=[r["s"] * 1e3 for r in scrubs],
                saves=[dict(seconds=r["s"], gib=r["bytes"] / 2**30)
                       for r in saves],
                restores=[dict(seconds=r["s"], gib=r["bytes"] / 2**30)
                          for r in restores],
                warm_restore_s=warm_s, held_against_plain=held,
                ladder=[dict(rung=r.rung, **r.details) for r in ladder],
                launches=launches), launches


LM_STEPS, LM_SEQ, LM_BATCH = 10, 64, 4
#: examples/train_lm.py's model
LM_CFG = dict(name="lm-110m", family="dense", num_layers=14, d_model=640,
              num_heads=10, num_kv_heads=5, d_ff=2560, vocab_size=16384,
              head_dim=64, dtype="float32")


def phase_train_lm(torch, np) -> tuple[dict, dict]:
    """examples/train_lm.py's scenario on the card: the ~110M-parameter
    float32 LM (14 layers, d 640, vocab 16384) with --batch 4 (so the
    microbatch of 2 and remat="block" run), LM_STEPS steps of LM_SEQ
    tokens, a scrub every 5 and 5 bit flips injected into the moment pool
    at mid-run, which the scrub corrects exactly; the loss before and
    after."""
    import shutil

    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.core.injection import inject_flips
    from repro_torch.kernels import common
    from repro_torch.models import count_params
    from repro_torch.train.trainer import make_trainer
    cfg = ModelConfig(**LM_CFG)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=20,
                       total_steps=max(LM_STEPS, 100), microbatch=2,
                       scrub_every=5, checkpoint_every=20, remat="block")
    ck = common_build() / "train_lm_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.synchronize()
    common.LAUNCHES.clear()                 # counts of the main path only
    tr = make_trainer(cfg, tcfg, ckpt_dir=str(ck), seq_len=LM_SEQ,
                      global_batch=LM_BATCH, device=DEVICE)
    check(not tr.restore(), "a fresh directory restored a checkpoint")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    tr.run(LM_STEPS // 2)
    flipped, _ = inject_flips(tr.moment_pool.storage, rng, 5)
    tr.moment_pool = dataclasses.replace(tr.moment_pool, storage=flipped)
    repaired = tr.scrub_pools()
    scrub_status = hold_scrub(torch, flipped, tr.moment_pool.storage)
    del flipped
    log = tr.run(LM_STEPS - LM_STEPS // 2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    check(repaired["corrected"] == 5 == sum(scrub_status[1:3])
          and repaired["uncorrectable"] == 0 == scrub_status[3],
          f"scrub after 5 flips: {repaired}, plain sweep {scrub_status}")
    check(np.isfinite([r["loss"] for r in log]).all(), "non-finite loss")
    shutil.rmtree(ck, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    return dict(params=count_params(cfg), steps=LM_STEPS, seq_len=LM_SEQ,
                batch=LM_BATCH, microbatch=2, remat="block",
                injected=5, scrub_corrected=repaired["corrected"],
                scrub_status_held_against_plain=scrub_status,
                loss_first=log[0]["loss"], loss_last=log[-1]["loss"],
                tokens_per_s=LM_STEPS * LM_BATCH * LM_SEQ / dt,
                launches=launches), launches


# ---------------------------------------------------------------------------
# Phase 38: the rest of the reference's surface
# ---------------------------------------------------------------------------

SURFACE_BATCH = 4          # sequences of the functional decode
SURFACE_PROMPT = 32
SURFACE_DECODE = 8         # decode steps of the functional decode
SURFACE_KEYS = 512         # keys of lookup_pool's index
SURFACE_DAEC = 4 * 8       # global DAEC-tier rows of the second shard pool
EXAMPLES = ("quickstart", "vm_multitenant", "adaptive_reliability",
            "objcache_memcached", "serve_kv_cream", "observe_serving",
            "train_lm")
EXAMPLE_TIMEOUT_S = 600
#: the clock's numbers in what the examples print (tests/torch_examples.py
#: masks the same), and train_lm's loss values (each run's own weights)
EXAMPLE_CLOCK = [(r"tokens/s=\s*[0-9.]+", "tokens/s=<clock>"),
                 (r"p99=\s*[0-9.]+ms", "p99=<clock>ms"),
                 (r"\| \d+ tok/s \|", "| <clock> tok/s |")]
EXAMPLE_LOSS = re.compile(r"^loss (\S+) -> (\S+) \|")


def example_args(name: str) -> list:
    """An example's flags: train_lm takes 2 steps into an empty directory
    (no checkpoint is written before step 20), the others none."""
    if name != "train_lm":
        return []
    return ["--steps", "2", "--ckpt", str(common_build() / "surface_lm")]


def masked_lines(text: str) -> list:
    import math
    out = []
    for line in text.splitlines():
        for pattern, repl in EXAMPLE_CLOCK:
            line = re.sub(pattern, repl, line)
        m = EXAMPLE_LOSS.match(line)
        if m:
            check(all(math.isfinite(float(v)) for v in m.groups()),
                  f"non-finite loss: {line}")
            line = EXAMPLE_LOSS.sub("loss <loss> -> <loss> |", line)
        out.append(line)
    return out


def run_example(name: str) -> str:
    """``repro_torch.examples.<name>.main`` on the card, every plane reset
    around it -> what it printed."""
    import importlib
    import io
    module = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    reset_planes()
    try:
        with contextlib.redirect_stdout(buf):
            module.main(example_args(name), device=DEVICE)
    finally:
        reset_planes()
    return buf.getvalue()


def surface_pools(torch, np, device):
    """The serve pool's geometry written with seeded pages and planted
    single flips in two SECDED rows: a local PoolState, and the
    serve-shard geometry as a ShardedPool with and without a DAEC tier."""
    from repro_torch.core.layouts import Layout
    from repro_torch.core.pool import make_pool
    from repro_torch.kernels.common import to_words
    from repro_torch.shard import make_sharded_pool
    rng = np.random.default_rng(SEED + 38)
    local = make_pool(NUM_ROWS, Layout.INTERWRAP, boundary=SHARD_BOUNDARY,
                      row_words=W, device=device)
    sharded = [make_sharded_pool(NUM_ROWS, Layout.INTERWRAP, SHARD_BOUNDARY,
                                 num_shards=SHARDS, row_words=W,
                                 daec_rows=d, device=device)
               for d in (0, SURFACE_DAEC)]
    out = []
    for pool in [local, *sharded]:
        ids = np.arange(pool.num_pages)
        data = to_words(rng.integers(0, 2**32, (ids.size, 8 * W),
                                     dtype=np.uint32)).to(device)
        pool = pool.write(ids, data)
        # a data-bit and a code-bit flip in SECDED rows and one in the last
        # row (the DAEC tier's where there is one), each in its own bank
        if pool is local:
            rows = (SHARD_BOUNDARY + 4, SHARD_BOUNDARY + 9, NUM_ROWS - 1)
            sto = [pool.storage] * 3
        else:
            b, r = pool.boundary_local, pool.rows_local
            rows = (b + 4, b + 9, r - 1)
            sto = [pool.storage[s] for s in (1, 2, 3)]
        for st, row, (lane, bit) in zip(sto, rows, ((3, 7), (8, 12),
                                                     (5, 10))):
            st[row, lane, 17] ^= 1 << bit
        out.append(pool)
    return out


def to_cpu(pool):
    return dataclasses.replace(pool, storage=pool.storage.cpu())


def phase_surface(torch, np) -> tuple[dict, dict]:
    """The names that complete the reference's surface, on the card.

    (a) ``kernels.mixed.ops.read_pool`` and ``kernels.hash.ops.lookup_pool``
    on the serve pool's geometry (1600 rows of W = 2048, InterWrap,
    boundary 1280, planted flips) and ``repro_torch.shard``'s
    ``write_any`` / ``read_any`` / ``read_any_status`` /
    ``read_any_writeback`` on serve-shard's (4 banks), also with a DAEC
    tier: bit-exact against their plain versions on a CPU copy and against
    the pool's methods; (b) the functional ``init_params`` -> ``prefill``
    -> SURFACE_DECODE x ``decode_step`` of qwen3-0.6b (full width and
    depth, float32, SURFACE_BATCH sequences) beside the Transformer's
    methods on the same weights: equal tokens, each loop timed; (c) the
    seven examples' ``main(device="cuda")``, each printing the lines of
    the same example's CPU run, made in a subprocess started at the
    phase's start (clock numbers and train_lm's losses masked)."""
    import os
    import shutil

    from repro_torch import shard
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.kernels import common
    from repro_torch.kernels.hash import ops as hash_ops
    from repro_torch.kernels.mixed import ops as mixed_ops
    from repro_torch.models import build_model, transformer
    from repro_torch.objcache import hash_index as hix
    t0 = time.perf_counter()
    shutil.rmtree(common_build() / "surface_lm", ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # one thread each for the six small examples, so that train_lm's CPU
    # run, the phase's longest part, has the host's cores
    cpu = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu", *example_args(name)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env if name == "train_lm" else dict(env, OMP_NUM_THREADS="1"))
        for name in EXAMPLES}
    try:
        torch.cuda.synchronize()
        common.LAUNCHES.clear()             # counts of the main path only
        # (a) the pool-level names
        local, sharded, daec = surface_pools(torch, np, DEVICE)
        pages = torch.randperm(local.num_pages, device=DEVICE)
        got = mixed_ops.read_pool(local, pages)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 38)
        keys = torch.randperm(1 << 20, generator=gen,
                              device=DEVICE)[:SURFACE_KEYS].to(torch.int32)
        kpages = torch.randint(0, local.num_pages, (SURFACE_KEYS,),
                               generator=gen, device=DEVICE,
                               dtype=torch.int32)
        index, _, ok = hix.insert(
            hix.make_index(4 * SURFACE_KEYS, CACHE_PROBE, device=DEVICE),
            keys, kpages, torch.zeros_like(kpages),
            torch.full_like(kpages, 8 * W))
        queries = torch.cat([keys, keys[:7] + (1 << 21)])
        looked = hash_ops.lookup_pool(local, index, queries)
        ids = np.random.default_rng(SEED).permutation(sharded.num_pages)
        fns = {}
        for tag, pool in (("shard", sharded), ("shard_daec", daec)):
            wids = ids[:min(256, ids.size)]
            data = common.to_words(np.random.default_rng(SEED + 1).integers(
                0, 2**32, (wids.size, 8 * W), dtype=np.uint32)).to(DEVICE)
            new = shard.write_any(pool, wids, data)
            fns[tag] = dict(
                pool=pool, new=new, wids=wids, data=data,
                read=shard.read_any(pool, ids),
                status=shard.read_any_status(pool, ids),
                writeback=shard.read_any_writeback(pool, ids))
        torch.cuda.synchronize()
        launches_a = dict(common.LAUNCHES)
        # (b) the functional decode beside the methods
        cfg = dataclasses.replace(CONFIG, dtype="float32")
        params = transformer.init_params(cfg, seed=SEED, device=DEVICE)
        toks = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (SURFACE_BATCH, SURFACE_PROMPT)),
            device=DEVICE)
        max_len = SURFACE_PROMPT + SURFACE_DECODE

        def functional():
            logits, state = transformer.prefill(params, cfg, toks, max_len)
            tok, seq = logits[:, -1].argmax(-1), []
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(SURFACE_DECODE):
                seq.append(tok)
                logits, state = transformer.decode_step(params, cfg, state,
                                                        tok)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            return torch.stack(seq, 1), time.perf_counter() - t

        with torch.no_grad():
            f_tok, f_s = functional()
        del params
        model = build_model(cfg, seed=SEED, device=DEVICE)

        def methods():
            logits, state = model.prefill_state(toks, max_len)
            tok, seq = logits[:, -1].argmax(-1), []
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(SURFACE_DECODE):
                seq.append(tok)
                logits, state = model.decode_step(state, tok)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            return torch.stack(seq, 1), time.perf_counter() - t

        m_tok, m_s = methods()
        del model
        torch.cuda.empty_cache()
        check(torch.equal(f_tok, m_tok),
              "functional decode tokens differ from the methods'")
        # (c) the seven examples on the card
        card = {}
        for name in EXAMPLES:
            t = time.perf_counter()
            card[name] = (run_example(name), time.perf_counter() - t)
        torch.cuda.synchronize()
        launches = dict(common.LAUNCHES)
        # the checks: plain versions on CPU copies, the methods on the card
        with uncounted():
            check(words_err(got.cpu(), mixed_ops.read_pool(
                to_cpu(local), pages.cpu())) == 0,
                "read_pool disagrees with its plain version")
            check(torch.equal(got, local.read(pages)),
                  "read_pool disagrees with the pool's read")
            check(bool(ok.all()), "an index insert failed")
            cpu_index = hix.HashIndex(*(t.cpu() for t in (
                index.key, index.page, index.off, index.length)),
                index.probe)
            check(words_err(looked.cpu(), hash_ops.lookup_pool(
                to_cpu(local), cpu_index, queries.cpu())) == 0,
                "lookup_pool disagrees with its plain version")
            check(torch.equal(looked[:SURFACE_KEYS],
                              local.read(kpages.long())),
                  "lookup_pool's pages are not the pool's")
            statuses = {}
            for tag, f in fns.items():
                cpool = to_cpu(f["pool"])
                cnew = shard.write_any(cpool, f["wids"], f["data"].cpu())
                check(torch.equal(f["new"].storage.cpu(), cnew.storage),
                      f"{tag}: write_any disagrees with the plain version")
                twin = dataclasses.replace(
                    f["pool"], storage=f["pool"].storage.clone())
                check(torch.equal(f["new"].storage, twin.write(
                    f["wids"], f["data"]).storage),
                      f"{tag}: write_any disagrees with the pool's write")
                del twin
                check(torch.equal(f["read"].cpu(), shard.read_any(cpool,
                                                                  ids)),
                      f"{tag}: read_any disagrees with the plain version")
                check(torch.equal(f["read"], f["pool"].read(ids)),
                      f"{tag}: read_any disagrees with the pool's read")
                for g, w in zip(f["status"], shard.read_any_status(cpool,
                                                                   ids)):
                    check(torch.equal(g.cpu(), w),
                          f"{tag}: read_any_status disagrees")
                for g, w in zip(f["status"], f["pool"].read(ids,
                                                            status=True)):
                    check(torch.equal(g, w), f"{tag}: read_any_status "
                          "disagrees with the pool's status read")
                wd, ws, wp = f["writeback"]
                cd, cs, cp = shard.read_any_writeback(cpool, ids)
                check(torch.equal(wd.cpu(), cd) and torch.equal(ws.cpu(), cs)
                      and torch.equal(wp.storage.cpu(), cp.storage),
                      f"{tag}: read_any_writeback disagrees")
                md, ms, mp = f["pool"].read_writeback(ids)
                check(torch.equal(wd, md) and torch.equal(ws, ms)
                      and torch.equal(wp.storage, mp.storage),
                      f"{tag}: read_any_writeback disagrees with the "
                      "pool's read_writeback")
                statuses[tag] = sorted(set(f["status"][1].cpu().tolist()))
                check(statuses[tag] == [0, 1, 2],
                      f"{tag}: statuses {statuses[tag]}")
        del local, sharded, daec, fns
        torch.cuda.empty_cache()
        examples = {}
        for name in EXAMPLES:
            text, err = cpu[name].communicate(timeout=EXAMPLE_TIMEOUT_S)
            check(cpu[name].returncode == 0,
                  f"{name} on the CPU failed: {err[-2000:]}")
            got_lines, want = masked_lines(card[name][0]), masked_lines(text)
            diff = [(g, w) for g, w in zip(got_lines, want) if g != w]
            check(not diff and len(got_lines) == len(want),
                  f"{name}: the card printed other lines than the CPU: "
                  f"{diff[:3]}")
            examples[name] = dict(lines=len(want), card_s=card[name][1])
    finally:
        for proc in cpu.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(common_build() / "surface_lm", ignore_errors=True)
    for name in ("mixed_read_correct", "hash_lookup_read",
                 "mixed_read_correct_routed", "daec_decode",
                 "secded_encode"):
        check(launches_a.get(name, 0) > 0, f"surface: no {name} launch")
    return dict(
        seconds=time.perf_counter() - t0, launches=launches,
        pool=dict(rows=NUM_ROWS, row_words=W, boundary=SHARD_BOUNDARY,
                  shards=SHARDS, daec_rows=SURFACE_DAEC, keys=SURFACE_KEYS,
                  statuses=statuses),
        decode=dict(arch="qwen3-0.6b", dtype="float32", batch=SURFACE_BATCH,
                    prompt=SURFACE_PROMPT, steps=SURFACE_DECODE,
                    tokens_equal=True,
                    functional_ms_per_step=1e3 * f_s / SURFACE_DECODE,
                    method_ms_per_step=1e3 * m_s / SURFACE_DECODE),
        examples=examples), launches


# ---------------------------------------------------------------------------
# Phase 36: the roofline
# ---------------------------------------------------------------------------

DRYRUN_CELLS = ("decode_32k", "train_4k")    # qwen3-0.6b, the (16, 16) mesh
DRYRUN_TIMEOUT_S = 300
TRAIN_COUNT_ARGS = dict(seq_len=128, global_batch=8)   # launcher defaults
TRAIN_TIMED_STEPS = 3


def run_module(args: list, timeout: int) -> str:
    """``python -m <args>`` from the repository root in a process of its
    own (the dry-run's fake process group is the whole process's); its
    standard output, or an error with its tail."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT, env=env)
    check(r.returncode == 0, f"{' '.join(args[:1])} exited {r.returncode}: "
          f"{r.stdout[-1500:]} {r.stderr[-2500:]}")
    return r.stdout


def train_step_counts(torch, np) -> dict:
    """qwen3-0.6b's bfloat16 train step (the launcher's step function at
    its defaults, fresh seeded weights and batch): host-clock ms of
    TRAIN_TIMED_STEPS steps (median, after a warm-up), the device ms of
    one under torch.profiler, and one counted by CostCounter."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import build_model, params_tree
    from repro_torch.optim import adamw
    from repro_torch.roofline.hlo_parse import CostCounter
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(total_steps=100)
    params = params_tree(build_model(cfg, seed=SEED, device=DEVICE))
    opt = adamw.init(params)
    rng = np.random.default_rng(SEED + 36)
    b, s = TRAIN_COUNT_ARGS["global_batch"], TRAIN_COUNT_ARGS["seq_len"]
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s + 1)),
                        dtype=torch.int32, device=DEVICE)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, tcfg)

    def run():
        out = step(params, opt, batch)
        torch.cuda.synchronize()
        return out

    run()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    prof_ms = (time.perf_counter() - t0) * 1e3
    with CostCounter() as counter:
        _, _, metrics = run()
    check(bool(torch.isfinite(metrics["loss"])), "train step loss not finite")
    out = dict(batch=b, seq_len=s, step_ms=statistics.median(times),
               step_ms_all=times, count=counter.as_dict(),
               **device_breakdown(prof, prof_ms))
    del params, opt
    torch.cuda.empty_cache()
    return out


def card_floor(name: str, arch: str, kind: str, batch: int, seq_len: int,
               measured: dict) -> dict:
    """The card's floor of one measured step: its counted FLOPs and bytes
    (one rank, no collective) through roofline.analysis over the H100's
    rates, beside the step's device ms and host-clock ms."""
    from repro_torch.roofline.analysis import analyze_record
    cnt = measured["count"]
    rec = dict(arch=arch, shape=name, mesh="card", kind=kind, ok=True,
               chips=1, global_batch=batch, seq_len=seq_len,
               hlo_flops=cnt["flops"], hlo_bytes=cnt["bytes"],
               collectives=cnt["collectives"])
    r = analyze_record(rec)
    floor_ms = r.step_s * 1e3
    dev = measured.get("device_ms")
    return dict(arch=arch, kind=kind, batch=batch, seq_len=seq_len,
                flops=cnt["flops"], bytes=cnt["bytes"],
                model_flops=r.model_flops_per_dev,
                compute_ms=r.compute_s * 1e3, memory_ms=r.memory_s * 1e3,
                floor_ms=floor_ms, bound=r.bound,
                roofline_frac=r.roofline_frac, useful_ratio=r.useful_ratio,
                device_ms=dev if dev is not None else "not measured",
                step_ms=measured["step_ms"],
                floor_over_device=floor_ms / dev if dev else None,
                floor_over_step=floor_ms / measured["step_ms"])


def phase_roofline(torch, np, qwen_decode: dict, olmoe_decode: dict
                   ) -> dict:
    """(a) the qwen3-0.6b dry-run cells on the fake (16, 16) mesh, (b)
    roofline.analysis over their records, (c) the card's floors beside the
    qwen3-0.6b and olmoe-1b-7b decode steps and the qwen3-0.6b train
    step."""
    import shutil
    out_dir = common_build() / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    cells = {}
    for shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        stdout = run_module(["repro_torch.launch.dryrun", "--arch",
                             TRAIN_ARCH, "--shape", shape, "--mesh",
                             "single", "--out", str(out_dir)],
                            DRYRUN_TIMEOUT_S)
        rec = json.loads((out_dir / f"{TRAIN_ARCH}__{shape}__pod16x16.json")
                         .read_text())
        check(rec["ok"] and "[OK ]" in stdout, f"dry-run {shape}: "
              f"{rec.get('error')}")
        for key in ("hlo_flops", "hlo_bytes", "collective_wire_bytes_scaled"):
            check(rec[key] > 0, f"dry-run {shape}: {key} {rec[key]}")
        cells[shape] = dict(
            {k: rec[k] for k in ("hlo_flops", "hlo_bytes",
                                 "collective_wire_bytes_scaled",
                                 "argument_size_in_bytes", "lower_s",
                                 "compile_s")},
            collectives=rec["collectives"]["count_by_op"],
            seconds=time.perf_counter() - t0)
    table = out_dir / "roofline.json"
    printed = run_module(["repro_torch.roofline.analysis", "--dir",
                          str(out_dir), "--json-out", str(table)], 120)
    rows = json.loads(table.read_text())["cells"]
    check(len(rows) == len(DRYRUN_CELLS) and all(
        r["step_s"] > 0 for r in rows), f"roofline rows {rows}")
    train = train_step_counts(torch, np)
    floors = {
        "qwen3-0.6b decode": card_floor(
            "serve_decode", TRAIN_ARCH, "decode", qwen_decode["batch"], 1,
            qwen_decode),
        "olmoe-1b-7b decode": card_floor(
            "serve_decode", OLMOE, "decode", olmoe_decode["batch"], 1,
            olmoe_decode),
        "qwen3-0.6b train": card_floor(
            "train_step", TRAIN_ARCH, "train", train["batch"],
            train["seq_len"], train)}
    for name, f in floors.items():
        check(f["flops"] > 0 and f["bytes"] > 0 and f["floor_ms"] > 0,
              f"{name}: floor {f}")
    return dict(dryrun=cells, analysis=rows,
                analysis_table=printed.strip().splitlines(),
                card_floors=floors,
                train_step=dict((k, v) for k, v in train.items()
                                if k != "count"))


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
    prof_c = phase_profile(torch, np, eng)
    phase("profile", prof_c)
    del eng
    torch.cuda.empty_cache()

    eng, tok_s, st_s, l_s, _, wall_s = serve_phase(torch, np, "secded")
    check(tok_s == tok_c, "secded tokens differ from cream tokens")
    check(st_c["device_pages"] > st_s["device_pages"],
          "cream mode must offer more device pages")
    check(st_s["preemptions"] > 0, "secded pool should have preempted")
    check(l_s.get("secded_encode", 0) > 0, "no SECDED encode launched")
    check(l_s.get("secded_decode", 0) > 0, "no SECDED decode launched")
    check_rows_clean(eng.pool, "qwen3-0.6b")
    phase("serve-secded", dict(tokens_equal=True, rows_clean=True,
                               **summary(st_s, l_s, wall_s)))
    del eng
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
    tele, l_tm = phase_telemetry(torch, np, tok_c,
                                 prof_c.get("device_events"))
    phase("telemetry", tele)

    phase("shard-reference", phase_shard_reference(torch, np))
    shard, l_ss = phase_serve_shard(torch, np, tok_c)
    phase("serve-shard", shard)
    torch.cuda.empty_cache()
    mesh, l_ms = phase_mesh(torch, np)
    phase("mesh", mesh)

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
    phase("regions-reference", phase_regions_reference(torch, np))
    regions, l_rg = phase_regions(torch, np)
    phase("regions", regions)
    torch.cuda.empty_cache()
    wb, l_wb = phase_writeback(torch, np)
    phase("writeback", wb)
    widths, l_wd = phase_widths(torch, np)
    phase("widths", widths)
    torch.cuda.empty_cache()
    launch, l_ls = phase_launch_serve(torch)
    phase("launch-serve", launch)
    sc2, l_sc2 = phase_serve_starcoder2(torch, np)
    phase("serve-starcoder2", sc2)
    mg, l_mg = phase_serve_musicgen(torch, np)
    phase("serve-musicgen", mg)
    olmoe, l_ol = phase_serve_olmoe(torch, np)
    phase("serve-olmoe", olmoe)
    phase("olmoe-reference", phase_olmoe_reference(torch, np))
    xl, l_xl = phase_decode_xlstm(torch, np)
    phase("decode-xlstm", xl)
    fam, l_fs = phase_families_smoke(torch, np)
    phase("families-smoke", fam)

    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(CONFIG, dtype="float32"),
                        attn_impl="flash", seed=SEED, device=DEVICE)
    long_ctx, l_pl = phase_prefill_long(torch, np, model)
    phase("prefill-long", long_ctx)
    seq, l_sq = phase_seqcache(torch, np, model)
    phase("seqcache", seq)
    del model
    torch.cuda.empty_cache()
    soft, l_se = phase_softecc(torch, np)
    phase("softecc", soft)
    phase("train-reference", phase_train_reference(torch, np))
    train, l_tr = phase_train(torch, np)
    phase("train", train)
    lm, l_lm = phase_train_lm(torch, np)
    phase("train-lm", lm)
    surface, l_sf = phase_surface(torch, np)
    phase("surface", surface)
    phase("roofline", phase_roofline(torch, np, prof_c,
                                     olmoe["profile"]))
    main_paths = [l_c, l_s, l_r, l_tm, l_ss, *l_z.values(), *l_w.values(),
                  l_d, l_a, l_cs, l_cd, l_rg, l_wb, l_wd, l_ls, *l_sc2,
                  l_mg, *l_ol, l_xl, l_fs, l_pl, *l_sq, l_em, l_se, l_tr,
                  l_lm, l_ms, l_sf]
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
    if "--mesh-worker" in sys.argv:      # one rank of the mesh phase
        at = sys.argv.index("--mesh-worker")
        sys.exit(mesh_worker(Path(sys.argv[at + 1]), "--train" in sys.argv))
    sys.exit(main())
