"""Launchers (port of :mod:`repro.launch`): ``python -m
repro_torch.launch.serve --arch <id>``, ``python -m
repro_torch.launch.train --arch <id>`` and the fake-mesh dry-run ``python
-m repro_torch.launch.dryrun``, with the meshes (:mod:`.mesh`) and the
per-cell shardings (:mod:`.shardings`) it uses."""
