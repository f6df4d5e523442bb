"""CREAM-Serve on PyTorch: paged-KV continuous batching on the CREAM data
plane, and the whole-state park/resume tier (port of :mod:`repro.serve`).

  * :mod:`repro_torch.serve.paged_kv`  — block tables mapping (seq, layer,
    block) to CREAM page ids;
  * :mod:`repro_torch.serve.scheduler` — admission control, parking,
    preempt-to-host;
  * :mod:`repro_torch.serve.engine`    — the continuous-batching engine:
    one pool gather and one pool scatter per decode step;
  * :mod:`repro_torch.serve.kv_cache`  — :class:`SequenceCache`, which
    parks whole dense decode states as VM pages (device pool, then host).
"""
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import (CacheStats, SequenceCache, pack_tree,
                                        unpack_tree)
from repro_torch.serve.paged_kv import PagedKV, token_words_for
from repro_torch.serve.scheduler import Scheduler, ServeRequest

__all__ = ["CacheStats", "Engine", "PagedKV", "Scheduler", "SequenceCache",
           "ServeRequest", "pack_tree", "token_words_for", "unpack_tree"]
