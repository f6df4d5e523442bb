"""SECDED-protected checkpoints (port of :mod:`repro.checkpoint`)."""
