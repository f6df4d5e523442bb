"""The benchmark's harness: it reads ``BENCHMARK.json`` and the files it
names, drives the program under test, times it, traces it and judges what
it served against the plain references in ``bench/reference``."""
