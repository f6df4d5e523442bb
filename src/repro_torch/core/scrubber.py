"""Memory scrubbing — the sweep that repairs single-bit errors and feeds the
health monitor (paper §3.1).

Port of ``repro/core/scrubber.py``. The SECDED rows are swept by the scrub
kernel (:mod:`repro_torch.kernels.scrub`), the SEC-DAEC tier by the daec
decode kernel (its code lane holds one packed word per 8 data words, so
the block decode consumes the rows directly, as in the reference), and the
PARITY layout's CREAM rows are checked against their parity tables by the
parity8 kernel. All dispatch by the pool's device, like every op of the
port: a pool on the card launches the kernels, a pool on the CPU runs
their plain versions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import parity8, secded
from repro_torch.core.layouts import CODE_LANE, DATA_LANES
from repro_torch.core.pool import PoolState
from repro_torch.kernels.daec import ops as daec_ops
from repro_torch.kernels.parity8 import ops as parity8_ops
from repro_torch.kernels.scrub import ops as scrub_ops


@dataclass(frozen=True)
class ScrubStats:
    """Per-sweep error census (python ints; host-side control plane)."""
    beats_checked: int = 0
    corrected_data: int = 0
    corrected_code: int = 0
    detected_uncorrectable: int = 0
    parity_lines_checked: int = 0
    parity_corrupt_lines: int = 0
    corrupt_rows: tuple[int, ...] = ()
    #: Corrections persisted back to storage this sweep — latent errors that
    #: can no longer pair up with a future flip into an uncorrectable double.
    latent_errors_killed: int = 0

    @property
    def corrected(self) -> int:
        return self.corrected_data + self.corrected_code

    @property
    def error_rate(self) -> float:
        checked = self.beats_checked + self.parity_lines_checked
        errors = self.corrected + self.detected_uncorrectable + \
            self.parity_corrupt_lines
        return errors / checked if checked else 0.0


def _scrub_daec_rows(storage: torch.Tensor, start: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode + correct the DAEC tier rows ``[start, R)`` of a pool buffer
    -> ``(storage', status, row_bad)``. Functional: ``storage`` itself is
    left as it was."""
    n = storage.shape[0] - start
    data = storage[start:, :DATA_LANES, :].reshape(n, -1).contiguous()
    codes = storage[start:, CODE_LANE, :].contiguous()
    data2, codes2, status = daec_ops.decode(data, codes)
    storage = storage.clone()
    storage[start:, :DATA_LANES, :] = data2.reshape(n, DATA_LANES, -1)
    storage[start:, CODE_LANE, :] = codes2
    row_bad = status.amax(dim=-1) == secded.DETECTED_UNCORRECTABLE
    return storage, status, row_bad


def scrub(state: PoolState, use_kernel: bool = False
          ) -> tuple[PoolState, ScrubStats]:
    """One full scrub sweep -> ``(new_state, stats)``.

    SECDED rows and the DAEC tier are repaired (corrected data and code
    lane; a DAEC superbeat's status counts on both its beats); PARITY-layout
    CREAM rows are checked (detection only) and reported in
    ``corrupt_rows`` so the owner can restore them. Functional, as the
    reference: ``state`` is left valid.

    ``use_kernel`` is kept for the reference's signature and ignored: the
    sweep dispatches by the pool's device, so a pool on the card always
    takes the scrub kernel and a pool on the CPU its plain version, which
    is the reference's ``use_kernel=False`` path bit for bit.
    """
    del use_kernel
    from repro_torch.obs import tracing
    with tracing.span("scrub.sweep", rows=state.num_rows,
                      boundary=state.boundary, layout=state.layout.value):
        return _scrub_impl(state)


def _scrub_impl(state: PoolState) -> tuple[PoolState, ScrubStats]:
    storage = state.storage
    B, R = state.boundary, state.num_rows
    D = state.daec_start     # the SECDED span ends where the DAEC tier begins

    corrected_data = corrected_code = detected = beats = 0
    corrupt_rows: list[int] = []
    for start, stop, sweep in (
            (B, D, lambda s: scrub_ops.scrub_secded(s, B, D)),  # SECDED
            (D, R, lambda s: _scrub_daec_rows(s, D))):          # DAEC tier
        if start >= stop:
            continue
        storage, status, row_bad = sweep(storage)
        counts = torch.bincount(status.reshape(-1), minlength=4).tolist()
        beats += int(status.numel())
        corrected_data += counts[secded.CORRECTED_DATA]
        corrected_code += counts[secded.CORRECTED_CODE]
        detected += counts[secded.DETECTED_UNCORRECTABLE]
        corrupt_rows += (start + torch.nonzero(row_bad)[:, 0]).tolist()

    parity_lines = parity_corrupt = 0
    if state.has_parity:
        # regular CREAM pages against their parity tables: page p's entry is
        # word slot p of the code-lane rows [0, ceil(B / 8)), read in order
        W = state.row_words
        data = storage[:B, :DATA_LANES, :].reshape(B, -1).contiguous()
        table_rows = (B + 7) // 8
        packed = storage[:table_rows, CODE_LANE, :].reshape(-1)[
            : B * (W // 8)].reshape(B, W // 8).contiguous()
        st = parity8_ops.check(data, packed)
        parity_lines = int(st.numel())
        parity_corrupt = int(st.sum())
        bad = st.amax(dim=-1) == parity8.LINE_CORRUPT
        corrupt_rows += torch.nonzero(bad)[:, 0].tolist()

    new_state = dataclasses.replace(state, storage=storage)
    return new_state, ScrubStats(
        beats_checked=beats,
        corrected_data=corrected_data,
        corrected_code=corrected_code,
        detected_uncorrectable=detected,
        parity_lines_checked=parity_lines,
        parity_corrupt_lines=parity_corrupt,
        corrupt_rows=tuple(corrupt_rows),
        latent_errors_killed=corrected_data + corrected_code,
    )
