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
  * :mod:`repro_torch.obs`     — the telemetry plane: metrics, span
    tracing, the reliability / capacity SLO tracker, the dashboard and
    the CREAM-Lens bank profiler (``python -m repro_torch.tools.creamtop``);
  * :mod:`repro_torch.objcache` — CREAM-Cache, the key-value object cache
    on pool pages (the paper's memcached and WebSearch workloads);
  * :mod:`repro_torch.models`  — the attention-only decoder: forward and
    loss, flash-attention prefill, dense and paged decode;
  * :mod:`repro_torch.serve`   — the CREAM-Serve continuous-batching engine
    and the ``SequenceCache`` park/resume tier;
  * :mod:`repro_torch.examples` — the reference's seven ``examples/``
    scripts (``python -m repro_torch.examples.<name> [--device cpu]``).

The reference's public surface is held name by name
(``tests/test_torch_surface.py``): every public name, class member and
defaulted parameter of ``src/repro/`` has its counterpart here, or a row
of that test's table of exceptions saying why not.

``use_kernel``: wherever the reference takes it (the kernel wrappers of
``kernels/*/ops.py``, ``make_sharded_pool`` and ``ShardedPool``, the
scrubbers, ``MigrationEngine``, ``RegionManager.scrub_all``,
``ObjCache``, ``VMPolicy``), the port accepts it and ignores it: the
tensor's device decides. A CUDA tensor always reaches the hand-written
kernel (or a wrapper raises); a CPU tensor always takes the plain
version. No value of ``use_kernel`` sends a CUDA tensor to a plain
version.

Entry points (``Engine``, ``VirtualMemory``, ``make_pool``,
``make_sharded_pool``, ``make_index``, ``build_model``, ``SequenceCache``,
the examples' ``main``; ``ObjCache`` through its VM) run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without ``device="cpu"`` they raise. Nothing here imports ``jax``,
:mod:`repro` or ``benchmarks``.
"""
