"""The deterministic synthetic token pipeline (port of :mod:`repro.data`)."""
