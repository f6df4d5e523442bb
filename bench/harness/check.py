"""The comparison that decides ``correct``.

The reference follows the recorded audit (see :mod:`harness.audit`)
layer by layer: the weights of one layer are drawn again from the seed,
and every recorded prefill and decode step is computed at that layer in
the order the program ran them, each session's KV carried by the
reference itself. An MoE's output depends on who shares its call
(capacity, first come), so a decode step is computed for its whole batch,
unbound slots included, as the program ran it.

Where the audit starts from KV that was written before it (in the window),
the reference rebuilds it from tokens (:func:`base_sites`). In a dense
model a token does not depend on who shares its step, so every bound
session whose request the harness saw prefill it is rebuilt whole from
its prompt and the tokens it was served; the reference then decodes the
audit from its own KV, and every token served to those sessions in the
window is judged. In an MoE only a prefill can be run again as the
program ran it (it shares its call with no other request), so a seeded
sample of those sessions' prompts is rebuilt, with the program's side of
a rounding tie in the router, and the audit's decode starts from the
program's KV. The numbers:

* ``gather_mismatch`` — pages of a decode step's mixed read whose digest
  differs from the reference's read of the pool as the recorded writes
  left it (exact);
* ``store_mismatch`` — words of the pool at the end of the audit that
  differ from the start's storage with every recorded write applied by
  the reference's write (layout and SECDED codes; exact);
* ``kv_err`` — the largest error of a KV block the program wrote (a
  prefill's pages, a step's current block) or holds for a rebuilt session
  (through the host tier and back, where it went), against the
  reference's, over the reference's largest magnitude in that block;
* ``logit_err`` — the same for the logits of every prefill's last
  position and every bound slot of every step of the audit;
* ``token_gap`` — the widest gap by which a served token's reference
  logit lies below the reference's best (the audit's tokens and those
  served to the rebuilt sessions);
* ``len_mismatch`` — bound slots whose length differs from the KV the
  reference holds for the session (exact).

With ``control=True`` the same replay runs a second time with every
matrix product in TF32, and that replay is judged in the program's place
(its logits, the KV it computes, the tokens it would put first).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from reference import decoder, pool as rpool, weights
from harness.audit import digest

class _Kv:
    """Page words <-> KV of one layer: a page is (2, bt, hkv, hd) float32
    at the front of its words."""

    def __init__(self, geo: dict, cfg: dict):
        self.bt = geo["block_tokens"]
        self.kvw = geo["kv_words"]
        self.hkv = cfg["num_key_value_heads"]
        self.hd = weights.head_dim(cfg)

    def unpack(self, pages: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(n, words) pages -> K, V each (n * bt, hkv, hd)."""
        kv = pages[:, :self.kvw].contiguous().view(torch.float32).view(
            -1, 2, self.bt, self.hkv, self.hd)
        return (kv[:, 0].reshape(-1, self.hkv, self.hd),
                kv[:, 1].reshape(-1, self.hkv, self.hd))


def start_kv(rec, fmt: _Kv, sid: str, layer: int, device):
    """Session ``sid``'s KV at ``layer`` when the audit started: its pages
    on the device read from the storage copy by the reference, those in
    the host tier from the program's host arrays."""
    s = rec.sessions[sid]
    geo = rec.geometry()
    nb = s["phys"].shape[1]
    pages = torch.empty((nb, geo["page_words"]), dtype=torch.int32,
                        device=device)
    dev = np.flatnonzero(s["phys"][layer] >= 0)
    if len(dev):
        ids = torch.as_tensor(s["phys"][layer][dev], device=device)
        pages[torch.as_tensor(dev, device=device)] = rpool.read(
            rec.snapshot, ids, geo["num_rows"], geo["boundary"])
    for (l, j), words in s["host"].items():
        if l == layer:
            pages[j] = torch.from_numpy(words.view(np.int32)).to(device)
    k, v = fmt.unpack(pages)
    return k[:s["len"]], v[:s["len"]]


class Replay:
    """The reference's run over the audit, in float32 or in TF32."""

    def __init__(self, rec, cfg: dict, seed: int, device, tf32: bool,
                 base: list[dict]):
        self.rec, self.cfg, self.seed, self.dev = rec, cfg, seed, device
        self.tf32 = tf32
        self.base = base            # set-up prefills whose KV is compared
        self.geo = rec.geometry()
        self.kvfmt = _Kv(self.geo, cfg)
        self.fam = weights.family(cfg)
        self.out: dict = {}         # site -> reference tensor
        self.ties = 0
        self.all_positions = False  # every prompt position's logits too
        self.own: dict = {}         # session -> this layer's rebuilt KV

    def _load(self, sid: str, layer: int):
        if sid in self.own:
            return self.own[sid]
        return start_kv(self.rec, self.kvfmt, sid, layer, self.dev)

    def _routes(self, ev: dict, layer: int):
        r0, r1 = ev["routes"]
        return self.rec.routes[r0 + layer] if r1 > r0 else None

    # -- one layer of a prefill and of a decode step -------------------------
    def _prefill(self, w, x, theirs):
        cfg, tf32 = self.cfg, self.tf32
        pos = torch.arange(x.shape[0], device=self.dev)
        q, k, v = decoder.qkv(w, cfg, decoder.attn_in(w, cfg, x), pos, tf32)
        a = decoder.attend(q, k, v, pos, cfg.get("sliding_window"), tf32)
        x = x + decoder.mm(a, w["wo"], tf32)
        m, ties = self.fam.mixer(w, cfg, decoder.mixer_in(w, cfg, x), tf32,
                                 theirs)
        self.ties += ties
        return x + m, k, v

    def _decode(self, w, x, ev, kv, layer, e):
        cfg, tf32 = self.cfg, self.tf32
        lens = torch.as_tensor(ev["lens"], device=self.dev)
        q, k, v = decoder.qkv(w, cfg, decoder.attn_in(w, cfg, x), lens, tf32)
        outs = []
        for b, sid in enumerate(ev["sids"]):
            n = int(ev["lens"][b])
            if sid is None:
                kb, vb = k[b:b + 1], v[b:b + 1]
            else:
                if sid not in kv:
                    if sid not in self.rec.sessions:   # no KV to follow
                        self.out[("len", e, b)] = True
                        kv[sid] = (k[:0], v[:0])
                    else:
                        kv[sid] = self._load(sid, layer)
                kp, vp = kv[sid]
                if kp.shape[0] != n:
                    self.out[("len", e, b)] = True
                kb = torch.cat([kp[:n], k[b:b + 1]])
                vb = torch.cat([vp[:n], v[b:b + 1]])
                kv[sid] = (kb, vb)
                start = n // self.kvfmt.bt * self.kvfmt.bt
                self.out[("kv", e, layer, b)] = (kb[start:].clone(),
                                                 vb[start:].clone())
            outs.append(decoder.attend(q[b:b + 1], kb, vb,
                                       lens[b:b + 1], cfg.get(
                                           "sliding_window"), tf32))
        x = x + decoder.mm(torch.cat(outs), w["wo"], tf32)
        m, ties = self.fam.mixer(w, cfg, decoder.mixer_in(w, cfg, x), tf32,
                                 self._routes(ev, layer))
        self.ties += ties
        return x + m

    def run(self) -> dict:
        cfg, dev, tf32 = self.cfg, self.dev, self.tf32
        outer = weights.outer(cfg, self.seed, dev)
        emb = outer["embed"]
        events = self.rec.events
        hid = {}
        for e, ev in enumerate(events):
            t = ev["tokens"] if ev["kind"] == "prefill" else ev["toks"]
            hid[e] = emb[torch.as_tensor(t, device=dev)]
        bhid = {b["sid"]: emb[torch.as_tensor(b["tokens"], device=dev)]
                for b in self.base}
        for layer in range(cfg["num_hidden_layers"]):
            w = weights.layer(cfg, self.seed, layer, dev)
            self.own = {}
            for b in self.base:
                routes = b["routes"][layer] if b["routes"] else None
                x, k, v = self._prefill(w, bhid[b["sid"]], routes)
                bhid[b["sid"]] = x
                self.out[("kvbase", b["sid"], layer)] = (k, v)
                if b["full"]:
                    self.own[b["sid"]] = (k, v)
            kv: dict = {}
            for e, ev in enumerate(events):
                if ev["kind"] == "prefill":
                    x, k, v = self._prefill(w, hid[e], self._routes(ev, layer))
                    kv[ev["sid"]] = (k, v)
                    self.out[("kv", e, layer)] = (k, v)
                else:
                    x = self._decode(w, hid[e], ev, kv, layer, e)
                hid[e] = x
            del w
        for e, ev in enumerate(events):
            rows = hid[e][-1:] if ev["kind"] == "prefill" else hid[e]
            self.out[("logits", e)] = decoder.logits(outer, cfg, rows, tf32)
            if ev["kind"] == "prefill" and self.all_positions:
                self.out[("prompt", e)] = decoder.logits(outer, cfg,
                                                         hid[e][:-1], tf32)
        for b in self.base:
            p = b["prompt_len"]
            self.out[("logits", b["sid"])] = decoder.logits(
                outer, cfg, bhid[b["sid"]][p - 1:], tf32)
            if self.all_positions and not b["full"]:
                self.out[("prompt", b["sid"])] = decoder.logits(
                    outer, cfg, bhid[b["sid"]][:p - 1], tf32)
        self.own = {}
        return self.out


def _program_sites(rec, cfg: dict, base: list[dict]):
    """The program's side of every compared site: (KV it wrote or holds,
    logits, served tokens)."""
    geo = rec.geometry()
    fmt = _Kv(geo, cfg)
    L, bt = geo["n_layers"], geo["block_tokens"]
    kv, logits, tokens = {}, {}, {}
    for e, ev in enumerate(rec.events):
        if ev["kind"] == "prefill":
            logits[e] = ev["logits"][None]
            tokens[e] = [ev["token"]]
            if not ev["writes"]:
                continue
            ids, data = ev["writes"][0][1], ev["writes"][0][2]
            row_of = {int(p): i for i, p in enumerate(ids)}
            nb = math.ceil(len(ev["tokens"]) / bt)
            for layer in range(L):
                sel = [row_of[int(p)] for p in ev["phys"][layer][:nb]]
                k, v = fmt.unpack(data[torch.as_tensor(sel,
                                                       device=data.device)])
                kv[("kv", e, layer)] = (k[:len(ev["tokens"])],
                                        v[:len(ev["tokens"])])
        else:
            bound = [b for b, s in enumerate(ev["sids"]) if s is not None]
            logits[e] = ev["logits"]
            tokens[e] = ev["served"]
            data = ev["writes"][0][2] if ev["writes"] else None
            for b in bound:
                n = int(ev["lens"][b])
                for layer in range(L):
                    if data is None:
                        continue
                    k, v = fmt.unpack(data[b * L + layer][None])
                    kv[("kv", e, layer, b)] = (k[:n % bt + 1], v[:n % bt + 1])
    for b in base:
        sid, m = b["sid"], len(b["tokens"])
        s = rec.sessions.get(sid)
        logits[sid] = None if b["logits"] is None else b["logits"][None]
        tokens[sid] = list(b["served"])
        if s is None or s["len"] < m:
            continue
        for layer in range(L):
            k, v = start_kv(rec, fmt, sid, layer, rec.snapshot.device)
            kv[("kvbase", sid, layer)] = (k[:m], v[:m])
    return kv, logits, tokens


def base_sites(rec, opened: list[dict], n: int, seed: int, dense: bool
               ) -> list[dict]:
    """The sessions whose KV the reference rebuilds from their tokens and
    compares where it lies at the audit's start.

    * Sessions opened in set-up (``opened``: their prefill events), those
      parked in the host tier first, then a seeded draw: their prompts.
    * Sessions whose bound request prefilled them (their tokens are
      known): in a dense model every one, whole (prompt and every token
      served into its KV; the reference decodes the audit from this KV);
      in an MoE a seeded draw of their prompts, where the window kept the
      router's choices. An MoE's sample holds ``n`` sessions in all.
    """
    gen = np.random.default_rng([int(seed), 7])
    held = [ev for ev in opened if ev["sid"] in rec.sessions
            and rec.sessions[ev["sid"]]["len"] >= len(ev["tokens"])]
    host = [ev for ev in held if rec.sessions[ev["sid"]]["host"]]
    rest = [ev for ev in held if not rec.sessions[ev["sid"]]["host"]]
    gen.shuffle(host)
    gen.shuffle(rest)
    picked = (host[: n // 2] + rest)[:n] if host else rest[:n]
    out = [dict(sid=ev["sid"], tokens=ev["tokens"],
                prompt_len=len(ev["tokens"]), served=[ev["token"]],
                logits=ev["logits"], full=False,
                routes=[rec.routes[i] for i in range(*ev["routes"])] or None)
           for ev in picked]
    layers = rec.geometry()["n_layers"]
    known = sorted(sid for sid, s in rec.sessions.items()
                   if "history" in s and (dense or (
                       s["routes"] is not None
                       and len(s["routes"]) == layers)))
    gen.shuffle(known)
    for sid in known:
        if not dense and len(out) >= n:
            break
        s = rec.sessions[sid]
        p = s["prompt_len"]
        m = s["len"] if dense else p
        out.append(dict(sid=sid, tokens=s["history"][:m], prompt_len=p,
                        served=s["history"][p:m + 1].tolist(), logits=None,
                        full=dense, routes=None if dense else s["routes"]))
    return out


def _rows_compared(rec, key, served) -> list[int]:
    """The logit rows of a site that count: a step's bound slots, every
    served position of a rebuilt session."""
    if isinstance(key, int) and rec.events[key]["kind"] == "decode":
        return [b for b, s in enumerate(rec.events[key]["sids"])
                if s is not None]
    return list(range(len(served)))


def judge(rec, ref: dict, kv, logits, tokens) -> dict:
    """The numbers of one side (program or control) against ``ref``
    (``logits[key]`` is None where that side's logits were not kept)."""
    errs, gaps = [], []
    for key, (k, v) in kv.items():
        rk, rv = ref[key]
        errs.append(torch.stack([(k - rk).abs().max() / rk.abs().max(),
                                 (v - rv).abs().max() / rv.abs().max()]))
    lerrs = []
    n_tok = 0
    for key, served in tokens.items():
        r = ref[("logits", key)]
        rows = logits[key]
        bs = _rows_compared(rec, key, served)
        idx = torch.as_tensor(bs, device=r.device)
        b = r[idx]
        if rows is not None:
            a = rows[idx]
            lerrs.append(((a - b).abs().amax(dim=1)
                          / b.abs().amax(dim=1)).max()[None])
        toks = [(i, served[bb]) for i, bb in enumerate(bs)
                if served[bb] is not None]
        if toks:
            rows_i = torch.as_tensor([i for i, _ in toks], device=r.device)
            tok = torch.as_tensor([int(t) for _, t in toks], device=r.device)
            gaps.append((b[rows_i].amax(dim=1)
                         - b[rows_i].gather(1, tok[:, None])[:, 0]).max()[None])
            n_tok += len(toks)

    def top(parts):
        return float(torch.cat([p.reshape(-1) for p in parts]).max()) \
            if parts else 0.0
    return dict(kv_err=top(errs), logit_err=top(lerrs), token_gap=top(gaps),
                kv_blocks=len(errs), tokens=n_tok)


def pool_replay(rec) -> dict:
    """Exact pool numbers: the reference's read of every decode step's
    pages and the reference's write of every recorded write."""
    geo = rec.geometry()
    expected = rec.snapshot
    bad_pages = 0
    for op in rec.pool_ops:
        if op[0] == "gather":
            ids, where = np.unique(op[1].astype(np.int64), return_inverse=True)
            ids = torch.as_tensor(ids, device=expected.device)
            mine = torch.empty(len(ids), dtype=torch.int64,
                               device=expected.device)
            for s in range(0, len(ids), 4096):
                mine[s:s + 4096] = digest(rpool.read(
                    expected, ids[s:s + 4096], geo["num_rows"],
                    geo["boundary"]))
            where = torch.as_tensor(where.reshape(-1), device=expected.device)
            bad_pages += int((mine[where] != op[2]).sum())
        else:
            rpool.write(expected, torch.as_tensor(op[1], device=expected.device),
                        op[2], geo["num_rows"], geo["boundary"])
    store = int((expected != rec.final).sum())
    return dict(gather_mismatch=bad_pages, store_mismatch=store,
                gathers=sum(op[0] == "gather" for op in rec.pool_ops),
                writes=sum(op[0] == "write" for op in rec.pool_ops))


def compare(rec, cfg: dict, seed: int, base: list[dict],
            control: bool = False) -> dict:
    """Every number of the cell, the program's (and with ``control`` the
    TF32 control's under ``"control"``). Frees the recording's storage
    copies on the way."""
    dev = rec.snapshot.device
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]
    replay = Replay(rec, cfg, seed, dev, False, base)
    replay.all_positions = control
    ref = replay.run()
    times = {"reference": lap()}
    kv, logits, tokens = _program_sites(rec, cfg, base)
    out = judge(rec, ref, kv, logits, tokens)
    out["len_mismatch"] = sum(1 for k in ref if k[0] == "len")
    out["ties"] = replay.ties
    times["judge"] = lap()
    if control:
        low = Replay(rec, cfg, seed, dev, True, base)
        low.all_positions = True
        low_out = low.run()
        ckv = {k: low_out[k] for k in kv}
        clog = {k: low_out[("logits", k)] for k in logits}
        ctok = {k: clog[k].argmax(dim=1).tolist() for k in clog}
        out["control"] = judge(rec, ref, ckv, clog, ctok)
        # the control's token gap at every prompt position as well
        gaps = [out["control"]["token_gap"]]
        for key in (k for k in low_out if k[0] == "prompt"):
            r, c = ref[key], low_out[key]
            pick = c.argmax(dim=1, keepdim=True)
            gaps.append(float((r.amax(dim=1) - r.gather(1, pick)[:, 0]).max()))
        out["control"]["token_gap"] = max(gaps)
        times["control"] = lap()
    out.update(pool_replay(rec))
    times["pool"] = lap()
    out["times"] = times
    return out
