"""Observability: the reliability / capacity SLO tracker (:mod:`.slo`).

The reference's metrics registry, span tracing, dashboard and memory
profiler are a later slice (ROADMAP, queue 1 item 5).
"""
