"""AdamW with gradient compression (port of :mod:`repro.optim`)."""
