"""CREAM-Serve on PyTorch: paged-KV continuous batching on the CREAM data
plane (port of :mod:`repro.serve`; ``kv_cache.py`` is still to port)."""
from repro_torch.serve.engine import Engine
from repro_torch.serve.paged_kv import PagedKV, token_words_for
from repro_torch.serve.scheduler import Scheduler, ServeRequest

__all__ = ["Engine", "PagedKV", "Scheduler", "ServeRequest",
           "token_words_for"]
