"""What the timed path produced, recorded for the reference to judge.

After the window closes the same engine serves on under the same load for
a few more polls (the audit), with this recorder hooked around the
program's own calls. While the window runs only the MoE router's choices
of each prefill are kept (:meth:`Recorder.watch`, by reference, so that
the reference can take the program's side of a rounding tie when it
rebuilds that prefill). It keeps:

* a copy of the pool's storage and of every session's block table when
  the audit starts (KV on the device by page id, KV parked in the host
  tier by the program's own host arrays), and the tokens that session's
  KV was made from, where the request that prefilled it is still bound;
* every pool read of a decode step (its page ids and a digest of the
  pages the mixed read returned) and every pool write (ids and data), in
  order, and the storage when the audit ends;
* every prefill (prompt, last-position logits, the token served) and
  every decode step (each slot's session, length and input token, the
  logits, the tokens served);
* the expert choices of every MoE call, so that the reference can take
  the program's side of a tie broken the other way by rounding.

:meth:`Recorder.openings` hooks only the prefills, for the sessions a
mix opens during set-up.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_DIGEST_CHUNK = 2048


def digest(pages: torch.Tensor) -> torch.Tensor:
    """A 64-bit digest of each page (n, words): a sum of its words times
    fixed odd multipliers, mod 2**64. Any change of one word changes it."""
    words = pages.shape[1]
    gen = torch.Generator(device="cpu").manual_seed(12345)
    mult = (torch.randint(0, 2**62, (words,), generator=gen) * 2 + 1).to(
        pages.device)
    out = torch.empty(pages.shape[0], dtype=torch.int64, device=pages.device)
    for s in range(0, pages.shape[0], _DIGEST_CHUNK):
        out[s:s + _DIGEST_CHUNK] = (pages[s:s + _DIGEST_CHUNK].long()
                                    * mult).sum(dim=1)
    return out


class Recorder:
    def __init__(self, engine, moe_module=None):
        self.eng = engine
        self.moe = moe_module
        self.routes: list[torch.Tensor] = []
        self.pool_ops: list[tuple] = []
        self.events: list[dict] = []
        self.snapshot = None
        self.sessions: dict[str, dict] = {}
        self.final = None
        self._undo: list = []
        self._logits = None
        self._step = None
        self._prefill_routes: list | None = None
        self.window_routes: dict[str, list] = {}   # session -> per layer

    # -- hooks -------------------------------------------------------------
    def _patch(self, obj, name: str, fn) -> None:
        orig = getattr(obj, name)
        setattr(obj, name, fn(orig))
        self._undo.append((obj, name, orig))

    def remove(self) -> None:
        """Undo every hook; what was recorded stays."""
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo.clear()

    def _hook_prefills(self) -> None:
        eng = self.eng

        def model_prefill(orig):
            def run(tokens):
                out = orig(tokens)
                self._logits = out[0][0, -1].detach().clone()
                return out
            return run

        def do_prefill(orig):
            def run(slot, req, sess):
                r0, w0 = len(self.routes), len(self.pool_ops)
                orig(slot, req, sess)
                self.events.append(dict(
                    kind="prefill", sid=req.seq_id,
                    tokens=np.asarray(req.prompt, np.int64),
                    token=int(req.generated[-1]), logits=self._logits,
                    routes=(r0, len(self.routes)),
                    writes=[op for op in self.pool_ops[w0:]
                            if op[0] == "write"],
                    phys=eng.kv.gather_phys(np.asarray([sess.row]))[0]))
            return run

        self._patch(eng.model, "prefill", model_prefill)
        self._patch(eng, "_do_prefill", do_prefill)
        if self.moe is not None:
            def route(orig):
                def run(p, cfg, xt):
                    out = orig(p, cfg, xt)
                    self.routes.append(out[1].detach().clone())
                    return out
                return run
            self._patch(self.moe, "route", route)

    def watch(self) -> None:
        """In the window: keep each prefill's expert choices per session
        (MoE only; the tensors the router returned, not copies)."""
        if self.moe is None:
            return
        eng = self.eng

        def route(orig):
            def run(p, cfg, xt):
                out = orig(p, cfg, xt)
                if self._prefill_routes is not None:
                    self._prefill_routes.append(out[1])
                return out
            return run

        def do_prefill(orig):
            def run(slot, req, sess):
                self._prefill_routes = []
                try:
                    orig(slot, req, sess)
                finally:
                    self.window_routes[req.seq_id] = self._prefill_routes
                    self._prefill_routes = None
                if len(self.window_routes) > 2 * eng.max_batch:
                    for sid in [s for s in self.window_routes
                                if s not in eng.sched.sessions]:
                        del self.window_routes[sid]
            return run

        self._patch(self.moe, "route", route)
        self._patch(eng, "_do_prefill", do_prefill)

    def openings(self) -> None:
        """Record the prefills of the sessions opened in set-up."""
        self._hook_prefills()

    def close_openings(self) -> list[dict]:
        """Unhook after set-up; the openings' prefill events."""
        self.remove()
        opened, self.events = self.events, []
        return opened

    def start(self, opened_by: dict | None = None) -> None:
        """Snapshot the pool, the block tables and (``opened_by``: session
        -> the request that prefilled it) the sessions' tokens; hook every
        call."""
        eng = self.eng
        self.remove()
        self._take_snapshot(opened_by or {})
        self._hook_prefills()

        def gather(orig):
            def run(phys):
                pages = orig(phys)
                self.pool_ops.append(("gather", np.array(phys), digest(pages)))
                return pages
            return run

        def attend(orig):
            def run(pages, lens, toks):
                out = orig(pages, lens, toks)
                slots = eng.sched.slots
                self._step.update(
                    lens=lens.cpu().numpy().astype(np.int64),
                    toks=toks.cpu().numpy().astype(np.int64),
                    logits=out[0].detach().clone(),
                    sids=[s.seq_id if s is not None else None for s in slots],
                    reqs=[(s.req, len(s.req.generated)) if s is not None
                          else None for s in slots])
                return out
            return run

        def step(orig):
            def run():
                r0, w0 = len(self.routes), len(self.pool_ops)
                self._step = dict(kind="decode")
                done = orig()
                ev = self._step
                if "logits" in ev:
                    ev["routes"] = (r0, len(self.routes))
                    ev["writes"] = [op for op in self.pool_ops[w0:]
                                    if op[0] == "write"]
                    ev["served"] = [req.generated[n] if req is not None
                                    and len(req.generated) > n else None
                                    for req, n in (r or (None, 0)
                                                   for r in ev.pop("reqs"))]
                    self.events.append(ev)
                self._step = None
                return done
            return run

        def write(orig):
            def run(pages, data, **kw):
                self.pool_ops.append(("write", np.array(pages, np.int64),
                                      data.detach().clone()))
                return orig(pages, data, **kw)
            return run

        self._patch(eng, "_gather_pages", gather)
        self._patch(eng, "_attend_fn", attend)
        self._patch(eng, "step", step)
        self._patch(eng.pool, "write", write)

    def finish(self) -> None:
        """Unhook and let go of the engine, so that the program's state can
        be freed before the reference runs; what was recorded stays."""
        self.final = self.eng.pool.storage
        self.remove()
        self._geo = self.geometry()
        self.eng = None

    def _take_snapshot(self, opened_by: dict) -> None:
        eng = self.eng
        kv = eng.kv
        self.snapshot = eng.pool.storage.clone()
        space = eng.vm.tenants[kv.tenant]
        bt = kv.block_tokens
        for sid, sess in eng.sched.sessions.items():
            nb = math.ceil(sess.cache_len / bt)
            vpns = kv._table[sess.row][:, :nb]
            phys = np.full(vpns.shape, -1, np.int64)
            host = {}
            for (l, j), vpn in np.ndenumerate(vpns):
                pte = space.entries[int(vpn)]
                if pte.pool is None:
                    host[(l, j)] = eng.vm.swap[pte.phys]
                else:
                    phys[l, j] = pte.phys
            self.sessions[sid] = dict(len=sess.cache_len, phys=phys,
                                      host=host)
            req = sess.req
            if req is not None and opened_by.get(sid) is req:
                hist = np.concatenate([np.asarray(req.prompt, np.int64),
                                       np.asarray(req.generated, np.int64)])
                if len(hist) > sess.cache_len:
                    self.sessions[sid].update(
                        history=hist[:sess.cache_len + 1],
                        prompt_len=len(req.prompt),
                        routes=self.window_routes.get(sid))
        self.window_routes = {}

    def geometry(self) -> dict:
        eng = self.eng
        if eng is None:
            return self._geo
        pool = eng.pool
        return dict(num_rows=pool.num_rows, boundary=pool.boundary,
                    block_tokens=eng.kv.block_tokens,
                    kv_words=eng.kv.kv_words, page_words=eng.kv.page_words,
                    n_layers=eng.n_layers, max_batch=eng.max_batch)

