"""Quickstart: CREAM pools in five minutes.

Creates an ECC pool, reclaims the code lane for +12.5% capacity, survives a
bit-flip storm, and moves the protection boundary at runtime — the paper's
mechanism end to end. Port of ``examples/quickstart.py``.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import (Layout, make_pool, read_page, repartition,
                              scrub, write_page)
from repro_torch.core.injection import inject_flips
from repro_torch.examples import parser
from repro_torch.kernels.common import resolve_device, to_words


def main(argv=None, device=None) -> None:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    rng = np.random.default_rng(0)

    def rand_page(pool):
        return to_words(rng.integers(0, 2**32, size=(pool.page_words,),
                                     dtype=np.uint32)).to(device)

    # 1) A conventional ECC module: all rows SECDED-protected.
    pool = make_pool(num_rows=64, layout=Layout.INTERWRAP, boundary=0,
                     device=device)
    print(f"SECDED pool:  {pool.num_pages} pages "
          f"({pool.effective_bytes >> 10} KB effective, "
          f"{pool.raw_bytes >> 10} KB raw)")

    # 2) Store data, inject a cosmic ray, scrub it away.
    data = rand_page(pool)
    pool = write_page(pool, 12, data)
    pool = dataclasses.replace(
        pool, storage=inject_flips(pool.storage, rng, 3)[0])
    pool, stats = scrub(pool)
    print(f"scrub: corrected={stats.corrected} "
          f"uncorrectable={stats.detected_uncorrectable}")
    got, status = read_page(pool, 12)
    assert (got == data).all() and int(status) == 0

    # 3) This tenant doesn't need ECC -> flip the whole pool to Inter-Wrap.
    pool, info = repartition(pool, pool.num_rows)
    print(f"CREAM pool:   {pool.num_pages} pages "
          f"(+{pool.capacity_gain():.1%} capacity reclaimed from the code "
          f"lane)")
    got, _ = read_page(pool, 12)
    assert (got == data).all(), "contents survive the layout change"

    # 4) Use an extra page that physically lives in the old ECC chip.
    extra_id = pool.num_rows  # first reclaimed page
    extra = rand_page(pool)
    pool = write_page(pool, extra_id, extra)
    got, _ = read_page(pool, extra_id)
    assert (got == extra).all()
    print(f"extra page {extra_id} stored in reclaimed code-lane capacity")

    # 5) Health degrades? Move the boundary back: half the pool returns to
    #    SECDED.
    pool, info = repartition(pool, pool.num_rows // 2)
    print(f"boundary -> {pool.boundary}: {pool.num_pages} pages, "
          f"evicted extras: {info['evicted_extra_pages']}")
    got, _ = read_page(pool, 12)
    assert (got == data).all()
    print("OK — capacity and reliability traded at runtime.")


if __name__ == "__main__":
    main()
