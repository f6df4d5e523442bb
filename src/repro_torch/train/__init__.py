"""The training step and the fault-tolerant trainer (port of
:mod:`repro.train`)."""
