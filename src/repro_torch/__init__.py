"""CREAM on PyTorch and CUDA — the H100 port of :mod:`repro`.

Mirrors ``src/repro/`` module for module at the same relative paths, so
every file names its reference. The JAX package stays the reference: the
tests feed both packages the same numpy inputs and hold the data plane to
bit-exact agreement and the model to float32 tolerance.

What this package holds today:

  * :mod:`repro_torch.core`    — layouts, protection ladder, the plain
    Hsiao SECDED(72,64), SEC-DAEC(144,128) and parity8 codecs, the
    ``(R, 9, W)`` pool with its boundary register (SEC-DAEC, SECDED,
    PARITY and unprotected regions), the scrubber, the health monitor and
    bit-flip fault injection;
  * :mod:`repro_torch.kernels` — hand-written CUDA kernels for Hopper
    (SECDED and SEC-DAEC encode/decode, the fused mixed-pool read, the
    migration gather/re-encode, parity8 encode/check, the fused hash probe
    + gather, the scrub sweep, the InterWrap page gather/scatter, flash
    attention, the router-fused sharded read, the SECDED decode-on-load
    matrix product), each beside its plain PyTorch version;
  * :mod:`repro_torch.shard`   — CREAM-Shard: the pool in rank-subset
    banks on one card, with the router and lockstep repartitioning;
  * :mod:`repro_torch.vm`      — CREAM-VM tenants, frames, host swap,
    zero-loss repartition and relocation, the scrub → monitor → adapt
    policy and the tenant reliability SLOs;
  * :mod:`repro_torch.faults`  — CREAM-Campaign: FIT-driven live
    injection, the shadow oracle and the closed SLO loop;
  * :mod:`repro_torch.obs`     — the reliability / capacity SLO tracker;
  * :mod:`repro_torch.objcache` — CREAM-Cache, the key-value object cache
    on pool pages (the paper's memcached and WebSearch workloads);
  * :mod:`repro_torch.models`  — the attention-only decoder: forward and
    loss, flash-attention prefill, dense and paged decode;
  * :mod:`repro_torch.serve`   — the CREAM-Serve continuous-batching engine
    and the ``SequenceCache`` park/resume tier.

Entry points (``Engine``, ``VirtualMemory``, ``make_pool``,
``make_sharded_pool``, ``make_index``, ``build_model``, ``SequenceCache``;
``ObjCache`` through its VM) run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without ``device="cpu"`` they raise. Nothing here imports ``jax`` or
:mod:`repro`.
"""
