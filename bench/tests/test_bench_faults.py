"""The comparison catches a broken timed path: each fault a serving cell
can have is planted under a whole tiny run on the CPU, and ``correct``
comes out false. (One card: there is no exchange between chips to leave
out.) Faults that act only before the audit starts show that the KV the
window wrote is judged by the reference's own rebuild, not taken on
trust."""
import time

import pytest
import torch

from conftest import tiny_cell
from harness import audit, runner

SEED = 2**33 + 5


def _unchanged(orig):
    """A step that leaves the KV as it was: the new token's K/V are never
    put into the block the step writes back."""
    def attend(self, pages, lens, toks):
        logits, nxt, _ = orig(self, pages, lens, toks)
        B, L = self.max_batch, self.n_layers
        blk = (lens.long() // self.kv.block_tokens)
        old = pages.reshape(B, L, self.kv.max_blocks, -1)[
            torch.arange(B), :, blk]
        return logits, nxt, old.reshape(B * L, -1)
    return attend


def _half_batch(orig):
    """Half of the batch left out: its slots attend to nothing gathered."""
    def attend(self, pages, lens, toks):
        pages = pages.clone().reshape(self.max_batch, -1)
        pages[self.max_batch // 2:] = 0
        return orig(self, pages.reshape(-1, self.kv.page_words), lens, toks)
    return attend


def _token_altered(orig):
    """Every next token altered where it is produced."""
    def attend(self, pages, lens, toks):
        logits, nxt, cur = orig(self, pages, lens, toks)
        return logits, (nxt + 1) % self.cfg.vocab_size, cur
    return attend


@pytest.mark.parametrize("fault,caught", [
    (_unchanged, "kv_err"), (_half_batch, "logit_err"),
    (_token_altered, "token_gap")], ids=["unchanged", "half", "token"])
@pytest.mark.parametrize("family", ["olmoe", "starcoder2"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, caught, family):
    from repro_torch.serve.engine import Engine
    monkeypatch.setattr(Engine, "_attend_fn", fault(Engine._attend_fn))
    out = runner.run_cell(tiny_cell(family), SEED, 1.0, False, "cpu",
                          time.perf_counter())
    assert not out["correct"]
    c = out["checks"][caught]
    assert c["value"] > c["limit"], out["checks"]


def _before_the_audit(monkeypatch):
    """A switch that turns off when the audit starts."""
    on = {"fault": True}
    orig = audit.Recorder.start

    def start(self, *a, **k):
        on["fault"] = False
        return orig(self, *a, **k)
    monkeypatch.setattr(audit.Recorder, "start", start)
    return on


@pytest.mark.parametrize("family", ["olmoe", "starcoder2"])
def test_prefill_kv_written_wrong_in_the_window(monkeypatch, family):
    from repro_torch.serve.engine import Engine
    on = _before_the_audit(monkeypatch)
    orig = Engine._pack_fn

    def pack(self, k, v):
        return orig(self, k * 1.01 if on["fault"] else k, v)
    monkeypatch.setattr(Engine, "_pack_fn", pack)
    out = runner.run_cell(tiny_cell(family), SEED, 1.0, False, "cpu",
                          time.perf_counter())
    assert not out["correct"]
    c = out["checks"]["kv_err"]
    assert c["value"] > c["limit"], out["checks"]


def test_decode_kv_written_wrong_in_the_window(monkeypatch):
    """Dense: a step that stores its new K/V wrong in the window only."""
    from repro_torch.serve.engine import Engine
    on = _before_the_audit(monkeypatch)
    orig = Engine._attend_fn

    def attend(self, pages, lens, toks):
        logits, nxt, cur = orig(self, pages, lens, toks)
        if on["fault"]:
            cur = (cur.view(torch.float32) * 1.01).view(torch.int32)
        return logits, nxt, cur
    monkeypatch.setattr(Engine, "_attend_fn", attend)
    out = runner.run_cell(tiny_cell("starcoder2"), SEED, 1.0, False, "cpu",
                          time.perf_counter())
    assert not out["correct"]
    c = out["checks"]["kv_err"]
    assert c["value"] > c["limit"], out["checks"]
