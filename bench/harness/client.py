"""The closed loop of clients around ``Engine.poll``, and what it saw.

Each client holds one turn at a time: it submits a ``ServeRequest``, and
when ``poll`` returns it finished, closes its session where the mix's
generator says so, and submits its next turn when the generator's
``ready`` lets it. A token is stamped when it reaches the host: a
prefill's token when ``_do_prefill`` returns (it reads the token back), a
decode step's when ``poll`` returns (``Engine.step`` copies the next
tokens to the host). The loop also notes which request prefilled each
session, so that the check can rebuild the session's KV from its tokens.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from harness import traffic


@dataclass
class TurnLog:
    client: int
    submit: float
    times: list[float] = field(default_factory=list)
    work: list[int] = field(default_factory=list)   # -prompt or keys
    done: float | None = None


class Loop:
    def __init__(self, engine, mix: dict, seed: int, vocab: int):
        from repro_torch.serve import ServeRequest
        self._req = ServeRequest
        self.eng = engine
        self.mix = mix
        self.gen = traffic.kind(mix["kind"])
        self.clients = mix["clients"]
        self.opened = self.gen.openings(mix, seed, vocab)
        self.pending = self.gen.turns(mix, seed, vocab)
        self.busy: set[int] = set()
        self.inflight: dict[int, tuple] = {}     # client -> (req, log, turn)
        self.idle: list[int] = []
        self.polls = 0
        self.logs: list[TurnLog] = []
        self.first: dict[int, float] = {}        # id(req) -> prefill stamp
        self.opened_by: dict[str, object] = {}   # session -> req prefilled
        self.steps = 0
        self.bound = 0                           # slot-steps decoded
        self.cont_admitted = 0
        self.counting = False
        orig_prefill = engine._do_prefill
        orig_ensure = engine.sched.ensure_step
        orig_tick = engine.sched.tick

        def prefill(slot, req, sess):
            orig_prefill(slot, req, sess)
            self.first[id(req)] = time.perf_counter()
            self.opened_by[req.seq_id] = req

        def ensure():
            dropped = orig_ensure()
            if self.counting:
                self.steps += 1
                self.bound += sum(s is not None for s in engine.sched.slots)
            return dropped

        def tick():
            adm = orig_tick()
            if self.counting:
                self.cont_admitted += sum(not a.is_prefill for a in adm)
            return adm

        engine._do_prefill = prefill
        engine.sched.ensure_step = ensure
        engine.sched.tick = tick

    # -- turns ---------------------------------------------------------------
    def _next(self):
        """The next turn of the list whose session is free."""
        for i, t in enumerate(self.pending):
            if t.session not in self.busy:
                return self.pending.pop(i)
        raise RuntimeError("the traffic list ran out: raise its 'turns'")

    def submit(self, client: int) -> None:
        t = self._next()
        sid, prompt, tier = self.gen.request(t, client, self.mix, self.opened)
        self.busy.add(t.session)
        req = self._req(sid, prompt, t.max_new, tier)
        log = TurnLog(client, time.perf_counter())
        self.eng.submit(req)
        self.logs.append(log)
        self.inflight[client] = (req, log, t)

    def open_sessions(self) -> None:
        """Set-up of a sessions mix: prefill every session's first prompt
        (one new token each), all parked when done."""
        for t in self.opened:
            self.eng.submit(self._req(f"s{t.session}", t.prompt, 1, t.tier))
        while self.eng.sched.has_work():
            self.eng.poll()

    def start(self) -> None:
        self.idle = list(range(self.clients))
        self._arrivals()

    def _arrivals(self) -> None:
        for c in self.gen.ready(list(self.idle), self.polls):
            self.idle.remove(c)
            self.submit(c)

    # -- one poll ------------------------------------------------------------
    def poll(self) -> float:
        done = self.eng.poll()
        now = time.perf_counter()
        finished = {id(r) for r in done}
        for client in list(self.inflight):
            req, log, t = self.inflight[client]
            new = len(req.generated) - len(log.times)
            if new > 0:
                sess = self.eng.sched.sessions.get(req.seq_id)
                stamp = self.first.pop(id(req), None)
                if stamp is not None:
                    log.times.append(stamp)
                    log.work.append(-len(req.prompt))
                    new -= 1
                log.times.extend([now] * new)
                log.work.extend([sess.cache_len if sess else 0] * new)
            if id(req) in finished:
                log.done = now
                self.busy.discard(t.session)
                del self.inflight[client]
                if self.gen.CLOSE_AFTER_TURN:
                    self.eng.sched.close_session(req.seq_id)
                    self.opened_by.pop(req.seq_id, None)
                self.idle.append(client)
        self.polls += 1
        self._arrivals()
        return now


def window_work(logs: list[TurnLog], t0: float, t1: float, cfg: dict
                ) -> float:
    """Model FLOPs of the tokens stamped in the window: a prefill's token
    carries its prompt, a decode step's its attention keys."""
    from harness import work
    total = 0.0
    for log in logs:
        for t, w in zip(log.times, log.work):
            if t0 <= t <= t1:
                total += work.prefill_flops(cfg, -w) if w < 0 else \
                    work.decode_flops(cfg, w)
    return total


def window_stats(logs: list[TurnLog], t0: float, t1: float) -> dict:
    """End-to-end numbers over the window [t0, t1]: every token stamped in
    it, every gap between two consecutive tokens of a turn stamped in it,
    and the first-token time of every turn submitted in it."""
    tokens, gaps, ttft, attempted, failed = 0, [], [], 0, 0
    for log in logs:
        ts = np.asarray(log.times)
        inside = (ts >= t0) & (ts <= t1)
        tokens += int(inside.sum())
        if len(ts) > 1:
            both = inside[1:] & inside[:-1]
            gaps.extend((ts[1:] - ts[:-1])[both].tolist())
        if t0 <= log.submit <= t1:
            attempted += 1
            if len(ts):
                ttft.append(ts[0] - log.submit)
            else:
                failed += 1
    return dict(tokens=tokens, seconds=t1 - t0, gaps=gaps, ttft=ttft,
                attempted=attempted, failed=failed)
