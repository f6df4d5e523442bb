"""CREAM-Serve scheduler: admission, interleaving, preempt-to-host.

Port of ``repro/serve/scheduler.py`` (pure host-side policy, unchanged).

Paper anchor: §3.3's dynamic capacity adjustment and §6.1's capacity-vs-
fault-rate tradeoff, acted out as serving policy. The scheduler is the
"OS" of the serving tier: it decides which sequences' KV occupies the
CREAM pool (device), which are parked on it between turns, and which are
preempted to the host swap tier when the boundary register takes capacity
away — the same decision the paper's kernel makes for page frames, with
HRM-style tiers (paid → SECDED frames, batch → NONE frames) deciding who
gets evicted first.

Mechanics:

  * requests are admitted FIFO into a fixed number of decode slots; a
    request for a session whose earlier turn is still decoding waits
    (per-session ordering), others may overtake it;
  * a session keeps its KV pages *after* a request finishes (parked on
    device) so the next turn resumes without prefill — parked
    sessions are the eviction pool: when frames run out, parked batch-tier
    sessions are preempted to host LRU-first (paid admissions may also
    preempt parked paid sessions, never running ones);
  * mid-decode, a bound sequence whose block table cannot grow (or whose
    pages a repartition pushed off-device — :meth:`sync_residency`) is
    preempted: its request re-queues as a continuation and resumes later
    with bit-exact KV.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import tracing as obs_tracing
from repro_torch.serve.paged_kv import PagedKV


@dataclass
class ServeRequest:
    """One turn of one session: decode ``max_new`` tokens onto its KV.

    ``prompt`` seeds the session's KV on first contact (and on a reset
    after the session's block table fills); continuation turns reuse the
    session's parked KV and decode straight away.
    """
    seq_id: str
    prompt: np.ndarray
    max_new: int
    tier: str = "batch"
    generated: list[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclass
class Session:
    """A sequence with live KV (bound to a slot, parked, or on host)."""
    seq_id: str
    tier: str
    row: int                      # PagedKV block-table row
    cache_len: int = 0
    last_tok: int = 0
    slot: int | None = None
    req: ServeRequest | None = None
    last_use: int = 0


@dataclass
class Admission:
    slot: int
    req: ServeRequest
    session: Session
    is_prefill: bool


class Scheduler:
    """Continuous-batching admission control over a :class:`PagedKV`."""

    def __init__(self, kv: PagedKV, max_batch: int, token_limit: int):
        self.kv = kv
        self.max_batch = max_batch
        self.token_limit = min(token_limit,
                               kv.max_blocks * kv.block_tokens)
        self.waiting: list[ServeRequest] = []
        self.slots: list[Session | None] = [None] * max_batch
        self.sessions: dict[str, Session] = {}
        self.preemptions = 0
        self.restores = 0
        self.resets = 0
        self._clock = 0

    # -- public surface ------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        # a fresh (or reset) session prefills the prompt then decodes
        # max_new - 1 more tokens, so its cache peaks at P + max_new - 1
        if len(req.prompt) + req.max_new - 1 > self.token_limit:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new {req.max_new} tokens "
                f"exceed the {self.token_limit}-token block table")
        req.t_submit = time.perf_counter()
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def tick(self) -> list[Admission]:
        """One admission pass: bind as many waiting requests to free slots
        as device capacity allows. Returns the new bindings; the engine
        prefills the ``is_prefill`` ones."""
        with obs_tracing.span("sched.tick", waiting=len(self.waiting)):
            return self._tick()

    def _tick(self) -> list[Admission]:
        self._clock += 1
        out: list[Admission] = []
        i = 0
        while i < len(self.waiting) and None in self.slots:
            req = self.waiting[i]
            sess = self.sessions.get(req.seq_id)
            if sess is not None and sess.slot is not None:
                i += 1          # session busy: later sessions may overtake
                continue
            act = self._activate(req)
            if act is None:     # out of device frames: head-of-line waits
                break
            sess, is_prefill = act
            slot = self.slots.index(None)
            self.slots[slot] = sess
            sess.slot = slot
            sess.req = req
            sess.last_use = self._clock
            self.waiting.pop(i)
            out.append(Admission(slot, req, sess, is_prefill))
        return out

    def ensure_step(self) -> list[int]:
        """Grow every bound session's block table for one more token,
        preempting (to host) the ones that cannot fit. Returns the slots
        dropped from this step."""
        dropped = []
        for slot, sess in enumerate(self.slots):
            if sess is None:
                continue
            need = self.kv.frames_needed(sess.row, sess.cache_len + 1)
            if need and not self._with_room(sess.tier, need, lambda:
                                            self.kv.ensure(
                                                sess.row,
                                                sess.cache_len + 1)):
                self._preempt_bound(slot)
                dropped.append(slot)
        return dropped

    def finish(self, slot: int) -> ServeRequest:
        """Request done: park the session (KV stays device-resident)."""
        sess = self.slots[slot]
        req = sess.req
        req.t_done = time.perf_counter()
        sess.slot = None
        sess.req = None
        sess.last_use = self._clock
        self.slots[slot] = None
        return req

    def close_session(self, seq_id: str) -> None:
        sess = self.sessions.pop(seq_id)
        if sess.slot is not None:
            raise RuntimeError(f"{seq_id} still bound to slot {sess.slot}")
        self.kv.close(sess.row)

    def sync_residency(self) -> list[int]:
        """After an external repartition/migration: refresh translations and
        preempt every bound session whose pages left the device — the
        mid-decode capacity loss the preemption test exercises. Returns the
        dropped slots."""
        self.kv.refresh()
        dropped = []
        for slot, sess in enumerate(self.slots):
            if sess is not None and not self.kv.resident(sess.row):
                self._preempt_bound(slot)
                dropped.append(slot)
        return dropped

    @property
    def stats(self) -> dict:
        return {"preemptions": self.preemptions, "restores": self.restores,
                "resets": self.resets, "parked": sum(
                    1 for s in self.sessions.values() if s.slot is None),
                "waiting": len(self.waiting)}

    # -- internals -----------------------------------------------------------
    def _activate(self, req: ServeRequest) -> tuple[Session, bool] | None:
        sess = self.sessions.get(req.seq_id)
        # tokens this request still has to decode — a preempted-and-requeued
        # continuation carries its partial `generated` and must NOT be
        # measured (or reset!) as if it were starting from scratch
        remaining = req.max_new - len(req.generated)
        if sess is not None and \
                self.token_limit - sess.cache_len < remaining:
            # block table full: reset the session (conversation truncation)
            self.close_session(req.seq_id)
            self.resets += 1
            sess = None
        if sess is None:
            need_tokens = len(req.prompt) + 1
            frames = self.kv.blocks_for(need_tokens) * self.kv.n_layers
            row = self.kv.open(req.tier)
            if not self._with_room(req.tier, frames,
                                   lambda: self.kv.ensure(row, need_tokens),
                                   keep=row):
                self.kv.close(row)
                return None
            sess = Session(req.seq_id, req.tier, row)
            self.sessions[req.seq_id] = sess
            return sess, True
        # continuation: bring pages home, then room for one more token
        if not self.kv.resident(sess.row):
            frames = self.kv.host_pages(sess.row)
            if not self._with_room(sess.tier, frames,
                                   lambda: self.kv.restore(sess.row),
                                   keep=sess.row):
                return None
            self.restores += 1
        need = self.kv.frames_needed(sess.row, sess.cache_len + 1)
        if need and not self._with_room(sess.tier, need, lambda:
                                        self.kv.ensure(sess.row,
                                                       sess.cache_len + 1),
                                        keep=sess.row):
            return None
        return sess, False

    def _with_room(self, tier: str, frames: int, attempt,
                   keep: int | None = None) -> bool:
        """Run ``attempt`` (an allocation), preempting parked sessions to
        host until it succeeds or no victims remain. ``keep`` protects the
        row the allocation is *for* from being its own victim."""
        rel = self.kv.tiers[tier]
        while True:
            if self.kv.free_frames(rel) >= frames and attempt():
                return True
            if not self._preempt_one_parked(rel, requester_tier=tier,
                                            keep=keep):
                # no victims left — one last try (classes may overlap)
                return attempt()

    def _preempt_one_parked(self, rel, requester_tier: str,
                            keep: int | None = None) -> bool:
        """Preempt the LRU parked session to host: batch tier first; parked
        paid sessions fall only to paid requesters. Running sequences are
        never victims, nor is the ``keep`` row, nor sessions whose frames
        could not serve a class-``rel`` allocation anyway (evicting them
        would be pure host traffic with zero usable frames freed)."""
        parked = [s for s in self.sessions.values()
                  if s.slot is None and s.row != keep
                  and self.kv.row_frames_of_class(s.row, rel) > 0]
        victims = sorted((s for s in parked if s.tier == "batch"
                          or requester_tier == "paid"),
                         key=lambda s: (s.tier != "batch", s.last_use))
        if not victims:
            return False
        self.kv.preempt(victims[0].row)
        self.preemptions += 1
        return True

    def _preempt_bound(self, slot: int) -> None:
        """Preempt a running sequence: KV to host, request re-queued as a
        continuation (front of the queue, preserving per-session order)."""
        sess = self.slots[slot]
        req = sess.req
        self.kv.preempt(sess.row)
        sess.slot = None
        sess.req = None
        self.slots[slot] = None
        self.waiting.insert(0, req)
        self.preemptions += 1
