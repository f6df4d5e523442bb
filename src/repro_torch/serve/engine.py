"""CREAM-Serve: continuous batching with KV paged onto the CREAM pool.

Port of ``repro/serve/engine.py`` on local and CREAM-Shard pools. Every
(sequence, layer, KV block) lives in one pool page; the block table
(:class:`PagedKV`) maps them and the :class:`Scheduler` decides
residency. A decode step is:

  * ONE page gather — the fused mixed-pool read
    (:mod:`repro_torch.kernels.mixed`, one kernel launch on the card; on a
    sharded pool its router-fused form) with the flattened block tables
    as its index list;
  * one model step (:meth:`Transformer.decode_step_paged` over all slots);
  * ONE page scatter of the updated current blocks (``pool.write``).

A migration queued with :meth:`Engine.schedule_migration` runs in the
next step between the gather and the scatter. On the card its launches
go to a second CUDA stream, free to run beside the model step's (the
reference fuses its sharded pool's ``ppermute`` ring into the attend
program for that overlap), and a CUDA event makes the scatter wait for
them; id lists go to the card without blocking the host
(:func:`~repro_torch.kernels.common.upload`), so queuing the migration
never waits for the gather. On the CPU it runs in the same place,
serially.

On a pool whose banks lie on a banks mesh (``vm.add_pool(..., shards=S,
mesh=make_banks_mesh(S))``) every rank runs the same engine on the same
requests and decodes the same tokens: the gather is the mesh read (each
rank's shard-local read, one all-reduce), the scatter each rank's owned
write, and a migration the pool's ring of ``S - 1`` send/receive steps,
on the side stream beside the step.

Shapes are fixed by ``(max_batch, n_layers, max_blocks)``: unbound slots
read and write a scratch page and are masked by ``cache_len = 0``.

Telemetry (:mod:`repro_torch.obs`), at the reference's places: the
``serve.router.dispatch`` span around the block-table walk, blocking
``engine.step.gather`` / ``.compute`` (``.compute_ring`` beside a
sharded pool's migration) / ``.scatter`` spans, ``engine.prefill``, the
decode-step, prefill and tokens-by-tier counters, one CREAM-Lens step per
decode step. Beyond the reference's: ``engine.poll`` around a poll (the
scheduler's ``sched.tick`` inside it), ``engine.step`` around a step,
``engine.step.unpack`` (pages to K and V), ``.model`` (the model step)
and ``.insert`` (the write-back) inside ``.compute``,
``engine.step.readback`` (the step's one wait for the card, the next
tokens to the host), ``engine.prefill.model`` / ``.pack`` / ``.write``
inside ``engine.prefill``; the model's ``model.attn`` / ``.mlp`` /
``.moe`` per layer and ``model.head``. Spans are stamped on the torch
profiler's clock (``obs.tracing.now_us``) and are its ranges; under the
profiler the blocking ones wait for nothing. With metrics on, the gather
also yields each page's decode status — on a bare local pool from the
mixed read's own launch
(:func:`_gather_pages_counts`) — reduced on the device to the per-class
count matrix the registry folds after the step. With every plane off the
step launches what it launches without them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import secded
from repro_torch.core.layouts import Layout
from repro_torch.core.pool import PoolState
from repro_torch.kernels.common import resolve_device, upload
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.obs import memprof as obs_memprof
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.serve.paged_kv import PagedKV, token_words_for
from repro_torch.serve.scheduler import Scheduler, ServeRequest
from repro_torch.shard.pool import ShardedPool
from repro_torch.vm.address_space import VirtualMemory

# Re-export: the old engine's request type moved to the scheduler.
Request = ServeRequest


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _status_rows(pool, pages: np.ndarray) -> np.ndarray:
    """Each page's row of the read-status count matrix, times 4 (the
    statuses per row): the class rules of the reference's
    ``_status_counts``, on the host, where the ids are. Rows index
    :data:`repro_torch.obs.metrics.FOLD_CLASSES`, never a literal."""
    classes = obs_metrics.FOLD_CLASSES
    if pool.layout == Layout.BASELINE_ECC:
        cream = "secded"
    else:
        cream = "parity" if pool.layout == Layout.PARITY else "none"
    is_sec = (pages >= pool.boundary) & (pages < pool.num_rows)
    cls = np.where(is_sec, classes.index("secded"), classes.index(cream))
    cls = np.where(is_sec & (pages >= pool.daec_start),
                   classes.index("daec"), cls)
    return (4 * cls).astype(np.int32)


def _status_counts(rows4: torch.Tensor, status: torch.Tensor
                   ) -> torch.Tensor:
    """Per-class ``(corrected, uncorrectable)`` counts, ``(len(FOLD_CLASSES),
    2)`` int32 on the status's device: one histogram of ``row * 4 +
    status`` (``index_add_``), then statuses 1 and 2 summed as corrected,
    3 kept as uncorrectable."""
    hist = torch.zeros(4 * len(obs_metrics.FOLD_CLASSES), dtype=torch.int32,
                       device=status.device)
    hist.index_add_(0, rows4 + status, torch.ones_like(status))
    hist = hist.view(-1, 4)
    return torch.stack([hist[:, secded.CORRECTED_DATA]
                        + hist[:, secded.CORRECTED_CODE],
                        hist[:, secded.DETECTED_UNCORRECTABLE]], dim=1)


class Engine:
    """Paged-KV continuous-batching engine on a CREAM pool.

    ``mode='cream'`` runs the pool boundary-free (InterWrap, +12.5 % pages,
    except ``secded_rows`` kept SECDED for paid-tier requests); ``'secded'``
    pins ``boundary=0`` (all rows SECDED — the conventional-ECC baseline
    with the same arithmetic). Pass an existing ``vm`` (with pool ``pool``
    already added) to share the data plane with other tenants. Runs on
    ``device`` (``cuda`` unless asked otherwise; an existing ``vm`` decides).
    """

    def __init__(self, cfg: ModelConfig, max_batch: int, max_len: int,
                 vm: VirtualMemory | None = None, pool: str = "kv",
                 mode: str = "cream", num_rows: int = 64,
                 row_words: int = 64, max_sessions: int = 128,
                 secded_rows: int = 0, seed: int = 0, device=None):
        if mode not in ("cream", "secded"):
            raise ValueError(mode)
        if len(transformer.attn_pattern_positions(cfg)) != len(cfg.pattern):
            raise ValueError(f"{cfg.name}: CREAM-Serve pages KV only; "
                             "attention-only patterns required")
        if vm is None:
            vm = VirtualMemory(row_words=row_words, device=device)
            vm.add_pool(pool, num_rows, Layout.INTERWRAP,
                        boundary=num_rows - secded_rows
                        if mode == "cream" else 0)
        elif device is not None and resolve_device(device) != vm.device:
            raise ValueError(f"vm lives on {vm.device}, not {device}")
        self.cfg = cfg
        self.vm = vm
        self.device = vm.device
        self.pool_name = pool
        self.mode = mode
        self.max_batch = max_batch
        self.max_len = max_len
        # refuse a KV dtype the pool cannot page before building weights
        token_words = token_words_for(cfg.num_kv_heads, cfg.head_dim_,
                                      cfg.activation_dtype)
        self.model = build_model(cfg, seed=seed, device=self.device)
        self.n_layers = transformer.num_attn_layers(cfg)
        self.kv = PagedKV(
            vm, pool, n_layers=self.n_layers, token_words=token_words,
            max_seqs=max_sessions, max_tokens=max_len)
        self.sched = Scheduler(self.kv, max_batch, token_limit=max_len)
        # host-side per-slot decode registers
        self._lens = np.zeros(max_batch, np.int32)
        self._toks = np.zeros(max_batch, np.int32)
        self.steps = 0
        self._pending_migration: tuple[np.ndarray, np.ndarray] | None = None
        self._side_stream = None        # the migration's stream on the card
        if obs_metrics.enabled():
            # pre-create the acceptance-critical series at zero so every
            # snapshot carries the full per-class matrix, errors or not
            obs_metrics.touch_read_status()
            mig = obs_metrics.counter(
                obs_metrics.NAME_PAGES_MIGRATED,
                "pages relocated by the migration engine", labels=("cls",))
            for cls in obs_metrics.FOLD_CLASSES:
                mig.labels(cls=cls)
            obs_metrics.counter(
                obs_metrics.NAME_DECODE_STEPS,
                "batched decode steps executed")
            obs_metrics.counter(
                obs_metrics.NAME_TOKENS_DECODED,
                "tokens decoded, by request tier", labels=("tier",))
            obs_metrics.counter(
                obs_metrics.NAME_PREFILLS, "prompt prefills executed")
        obs_metrics.record_pool_capacity(pool, self.pool)

    # -- geometry shorthands -------------------------------------------------
    @property
    def pool(self):
        return self.vm.pools[self.pool_name]

    @property
    def _bt(self) -> int:
        return self.kv.block_tokens

    @property
    def _s_pad(self) -> int:
        return self.kv.max_blocks * self.kv.block_tokens

    def _ids(self, a: np.ndarray) -> torch.Tensor:
        return upload(np.asarray(a, np.int32), self.device)

    # -- the per-step compute -------------------------------------------------
    def _attend_fn(self, pages_i32: torch.Tensor, lens: torch.Tensor,
                   toks: torch.Tensor):
        """(B*L*maxB, page_words) gathered pages -> (logits, next token,
        updated current-block pages (B*L, page_words))."""
        cfg, kvw = self.cfg, self.kv.kv_words
        B, L, maxB, bt = (self.max_batch, self.n_layers,
                          self.kv.max_blocks, self._bt)
        hkv, hd = cfg.num_kv_heads, cfg.head_dim_
        with obs_tracing.span("engine.step.unpack", pages=pages_i32.shape[0]):
            pages = pages_i32.reshape(B, L, maxB, -1)
            used, tail = pages[..., :kvw], pages[..., kvw:]
            kvv = used.view(torch.float32).reshape(B, L, maxB, 2, bt, hkv,
                                                   hd)
            k = kvv[:, :, :, 0].permute(1, 0, 2, 3, 4, 5) \
                .reshape(L, B, maxB * bt, hkv, hd)
            v = kvv[:, :, :, 1].permute(1, 0, 2, 3, 4, 5) \
                .reshape(L, B, maxB * bt, hkv, hd)
        with obs_tracing.span("engine.step.model", batch=B):
            logits, _, (k_new, v_new) = self.model.decode_step_paged(
                {"cache_len": lens}, toks, (k, v))
        # write-back: insert the new token into each slot's current block
        with obs_tracing.span("engine.step.insert", pages=B * L):
            blk = lens.long() // bt
            off = lens.long() - blk * bt
            b_idx = torch.arange(B, device=self.device)
            curr = kvv[b_idx, :, blk]                    # (B, L, 2, bt, h, d)
            new_tok = torch.stack([k_new.permute(1, 0, 2, 3),
                                   v_new.permute(1, 0, 2, 3)], dim=2)
            onehot = torch.arange(bt, device=self.device) == off[:, None]
            curr = torch.where(onehot[:, None, None, :, None, None],
                               new_tok[:, :, :, None], curr)
            cur_used = curr.contiguous().view(torch.int32).reshape(B, L, kvw)
            cur_tail = tail[b_idx, :, blk]               # (B, L, tail)
            cur_pages = torch.cat([cur_used, cur_tail], dim=-1)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, nxt, cur_pages.reshape(B * L, -1)

    def _pack_fn(self, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Prefill KV (L, S, Hkv, D) pair -> (L*maxB, page_words) pages."""
        L, maxB, bt = self.n_layers, self.kv.max_blocks, self._bt
        pad = self._s_pad - k.shape[1]
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv = torch.stack([k.reshape(L, maxB, bt, *k.shape[2:]),
                          v.reshape(L, maxB, bt, *v.shape[2:])], dim=2)
        used = kv.contiguous().view(torch.int32).reshape(
            L, maxB, self.kv.kv_words)
        tail = torch.zeros((L, maxB, self.kv.page_words - self.kv.kv_words),
                           dtype=torch.int32, device=self.device)
        return torch.cat([used, tail], dim=-1).reshape(L * maxB,
                                                       self.kv.page_words)

    def _gather_pages(self, phys: np.ndarray) -> torch.Tensor:
        """The decode step's ONE page gather: the fused mixed-pool read.

        Only a bare local pool without a DAEC tier takes it. A DAEC tier
        falls through to ``pool.read`` — the mixed kernel corrects with
        SECDED only and would mis-decode those rows — and so does a wrapped
        pool (the fault campaign's shadow), whose ``read`` must see every
        page. A sharded pool's ``read`` is itself the router-fused read
        (one launch over all its banks) when it has no DAEC tier.
        """
        pool = self.pool
        if isinstance(pool, PoolState) and pool.daec_rows == 0:
            # the fused read bypasses the pool's verbs: record it here
            pool.memprof_record("gather", phys, stream="decode")
            return mixed_ops.read_correct(pool.storage, self._ids(phys),
                                          pool.layout, pool.num_rows,
                                          pool.boundary)
        return pool.read(phys)

    def _gather_pages_counts(self, phys: np.ndarray
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Metrics-on gather: the pages and the ``(len(FOLD_CLASSES), 2)``
        per-class status counts the registry folds after the step.

        A bare local pool with no DAEC tier and a layout other than PARITY
        takes the mixed read with its status output — one launch, as the
        plain gather — and its page ids and count rows go to the card in
        one upload. A PARITY pool (whose status is the parity check, which
        the mixed read does not run), a DAEC tier, a wrapped or a sharded
        pool reads through ``pool.read(phys, status=True)`` (a sharded pool
        of the first kind: one router-fused read with its status output).
        Either way one reduction (:func:`_status_counts`) makes the counts.
        """
        pool = self.pool
        rows4 = _status_rows(pool, phys)
        if not isinstance(pool, PoolState):
            data, status = pool.read(phys, status=True)
            return data, _status_counts(self._ids(rows4), status)
        pool.memprof_record("gather", phys, stream="decode")
        if pool.daec_rows or pool.layout == Layout.PARITY:
            with obs_memprof.suspended():
                data, status = pool.read(phys, status=True)
            return data, _status_counts(self._ids(rows4), status)
        both = self._ids(np.stack([phys, rows4]))
        data, status = mixed_ops.read_correct(
            pool.storage, both[0], pool.layout, pool.num_rows,
            pool.boundary, status=True)
        return data, _status_counts(both[1], status)

    def schedule_migration(self, src_pages, dst_pages) -> None:
        """Queue a page migration ``src -> dst`` to run beside the next
        decode step's model compute (see the module docstring); several
        calls before a step coalesce in order. The pages must not belong
        to bound decode sequences — relocating a bound page would race the
        step's gather and scatter; park or preempt the sequence first and
        call :meth:`refresh_translation` after the step."""
        src = np.asarray(src_pages, np.int32).reshape(-1)
        dst = np.asarray(dst_pages, np.int32).reshape(-1)
        if src.shape != dst.shape:
            raise ValueError("src/dst page lists must match")
        if self._pending_migration is not None:
            src = np.concatenate([self._pending_migration[0], src])
            dst = np.concatenate([self._pending_migration[1], dst])
        self._pending_migration = (src, dst)

    def _start_migration(self):
        """Run the queued migration, if any; returns the CUDA event the
        step's scatter must wait for (None on the CPU or with none
        queued). On the card the migration's launches go to a second
        stream that starts after the step's gather."""
        pending, self._pending_migration = self._pending_migration, None
        if pending is None:
            return None
        if self.device.type != "cuda":
            self.vm.pools[self.pool_name] = self.pool.migrate(*pending)
            return None
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.vm.pools[self.pool_name] = self.pool.migrate(*pending)
            done = torch.cuda.Event()
            done.record(side)
        return done

    # -- request intake ------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        self.sched.submit(req)

    def refresh_translation(self) -> list[int]:
        """Call after an external repartition/migration on the serve pool:
        refreshes the block tables' physical mirror and preempts bound
        sequences whose pages left the device. Returns the dropped slots."""
        return self.sched.sync_residency()

    # -- the serving loop ------------------------------------------------------
    def _do_prefill(self, slot: int, req: ServeRequest, sess) -> None:
        with obs_tracing.span("engine.prefill", slot=slot,
                              prompt=len(req.prompt), tier=req.tier):
            self._do_prefill_impl(slot, req, sess)
        if obs_metrics.enabled():
            obs_metrics.counter(obs_metrics.NAME_PREFILLS,
                                "prompt prefills executed").inc()

    def _do_prefill_impl(self, slot: int, req: ServeRequest, sess) -> None:
        toks = self._ids(np.asarray(req.prompt)[None, :])
        p = len(req.prompt)
        with obs_tracing.span("engine.prefill.model", prompt=p):
            logits, (ks, vs) = self.model.prefill(toks)
        nb = self.kv.blocks_for(p)
        with obs_tracing.span("engine.prefill.pack", blocks=nb):
            pages = self._pack_fn(ks[:, 0].float(), vs[:, 0].float())
        phys = self.kv.gather_phys(np.asarray([sess.row]))[0]   # (L, maxB)
        ids = phys[:, :nb].reshape(-1)
        data = pages.reshape(self.n_layers, self.kv.max_blocks, -1)[:, :nb] \
            .reshape(len(ids), -1)
        with obs_tracing.span("engine.prefill.write", pages=len(ids)):
            self.vm.pools[self.pool_name] = self.pool.write(ids, data)
        sess.cache_len = p
        sess.last_tok = int(torch.argmax(logits[0, -1]))
        req.generated.append(sess.last_tok)
        self._lens[slot] = sess.cache_len
        self._toks[slot] = sess.last_tok

    def step(self) -> list[ServeRequest]:
        """One decode step over every bound slot: one page gather, one
        model step (beside a queued migration), one page scatter. Returns
        requests that finished."""
        with obs_tracing.span("engine.step"):
            return self._step_impl()

    def _step_impl(self) -> list[ServeRequest]:
        self.sched.ensure_step()
        if obs_memprof.enabled():
            obs_memprof.next_step()     # one profiler step per decode step
        rows = np.asarray([s.row if s is not None else -1
                           for s in self.sched.slots])
        active = rows >= 0
        if not active.any():
            return []
        lens = np.where(active, self._lens, 0).astype(np.int32)
        toks = np.where(active, self._toks, 0).astype(np.int32)
        with obs_tracing.span("serve.router.dispatch",
                              slots=int(active.sum())):
            phys = self.kv.gather_phys(rows)                # (B, L, maxB)
        counts = None
        with obs_tracing.blocked_span("engine.step.gather",
                                      pages=int(phys.size)) as hold:
            if obs_metrics.enabled():
                pages, counts = self._gather_pages_counts(phys.reshape(-1))
            else:
                pages = self._gather_pages(phys.reshape(-1))  # ONE gather
            hold(pages)
        pending = self._pending_migration
        if pending is not None and isinstance(self.pool, ShardedPool):
            # the pool's migrate counts the pages it moves
            compute = obs_tracing.blocked_span(
                "engine.step.compute_ring", ring_pages=int(pending[0].size))
        else:
            compute = obs_tracing.blocked_span("engine.step.compute")
        with compute as hold:
            migrated = self._start_migration()
            _, nxt, cur_pages = self._attend_fn(pages, self._ids(lens),
                                                self._ids(toks))
            hold(nxt)
        if migrated is not None:
            torch.cuda.current_stream(self.device).wait_event(migrated)
        with obs_tracing.blocked_span("engine.step.scatter") as hold:
            cur_ids = self.kv.current_block_phys(rows, lens)  # (B, L)
            self.vm.pools[self.pool_name] = self.pool.write(
                cur_ids.reshape(-1), cur_pages)             # ONE scatter
            hold(self.pool.storage)
        with obs_tracing.span("engine.step.readback"):
            nxt = nxt.cpu().numpy()
        self.steps += 1
        if counts is not None:
            obs_metrics.fold_read_status(counts)
        finished = []
        tokens_by_tier: dict[str, int] = {}
        for slot in np.flatnonzero(active):
            sess = self.sched.slots[slot]
            sess.cache_len += 1
            sess.last_tok = int(nxt[slot])
            sess.req.generated.append(sess.last_tok)
            self._lens[slot] = sess.cache_len
            self._toks[slot] = sess.last_tok
            tier = sess.req.tier
            tokens_by_tier[tier] = tokens_by_tier.get(tier, 0) + 1
            if len(sess.req.generated) >= sess.req.max_new:
                finished.append(self.sched.finish(slot))
        if obs_metrics.enabled():
            obs_metrics.counter(obs_metrics.NAME_DECODE_STEPS,
                                "batched decode steps executed").inc()
            tok = obs_metrics.counter(
                obs_metrics.NAME_TOKENS_DECODED,
                "tokens decoded, by request tier", labels=("tier",))
            for tier, n in tokens_by_tier.items():
                tok.labels(tier=tier).inc(n)
        return finished

    def poll(self) -> list[ServeRequest]:
        """One serving-loop iteration: an admission pass (prefilling the
        newly admitted sessions) followed by one batched decode step."""
        with obs_tracing.span("engine.poll"):
            admitted = self.sched.tick()
            done: list[ServeRequest] = []
            for adm in admitted:
                if adm.is_prefill:
                    self._do_prefill(adm.slot, adm.req, adm.session)
                    if len(adm.req.generated) >= adm.req.max_new:
                        done.append(self.sched.finish(adm.slot))
                else:
                    self._lens[adm.slot] = adm.session.cache_len
                    self._toks[adm.slot] = adm.session.last_tok
            if self.sched.active_slots():
                done.extend(self.step())
            elif not admitted and self.sched.waiting:
                raise RuntimeError(
                    "deadlock: waiting requests cannot be admitted "
                    f"({self.sched.stats})")
            return done

    def serve(self, requests: list[ServeRequest]) -> dict:
        """Serve a request list to completion; returns the run's stats."""
        for req in requests:
            self.submit(req)
        done: list[ServeRequest] = []
        t0 = time.perf_counter()
        while self.sched.has_work():
            done.extend(self.poll())
        wall = time.perf_counter() - t0
        lats = [r.latency_s for r in done]
        tokens = sum(len(r.generated) for r in done)
        return {
            "wall_s": wall,
            "tokens": tokens,
            "tokens_per_s": tokens / wall if wall else 0.0,
            "requests": len(done),
            "p50_latency_ms": _percentile(lats, 50) * 1e3,
            "p99_latency_ms": _percentile(lats, 99) * 1e3,
            "decode_steps": self.steps,
            "device_pages": self.vm.device_capacity_pages(self.pool_name),
            "device_util": self.vm.utilisation(self.pool_name),
            "vm_fault_rate": self.vm.stats.fault_rate,
            "host_reads": self.vm.stats.host_reads,
            "mode": self.mode,
            **self.sched.stats,
        }
