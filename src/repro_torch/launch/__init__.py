"""Launchers (port of :mod:`repro.launch`): ``python -m
repro_torch.launch.serve --arch <id>`` and ``python -m
repro_torch.launch.train --arch <id>``."""
