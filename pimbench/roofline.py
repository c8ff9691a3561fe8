"""The table of peaks and the least time of a call or a kernel, from the
program's frozen work (``programs/<name>.json``), never from the schedule
the port compiles.

* INT32 logic peak: SMs x 32-bit logic lanes an SM a clock x the largest SM
  clock (one NOR, MAJ3 or NOT over a 32-bit word of rows is one operation).
* Kernel bound: the larger of ``gates x words`` at that peak and the
  kernel's boundary planes (``(planes_in + planes_out) x words x 4`` bytes,
  each read or written once) at the HBM bandwidth.
* Call bound: the larger of the same operations and the call's element
  bytes (``row_bytes x rows``: inputs read once, the result written once).

``words`` is ``ceil(rows / 32)``: what these rows need, without the
executor's padding.
"""

from __future__ import annotations

from .spec import PKG, load_json

WORD = 32


def peak_for(device_name: str) -> dict | None:
    """This card's peaks, or None for a card the table does not hold."""
    return load_json(PKG / "peaks.json").get(device_name)


def int32_ops_per_s(peak: dict) -> float:
    return peak["sms"] * peak["int32_lanes_per_sm"] * peak["max_sm_mhz"] * 1e6


def words(rows: int) -> int:
    return -(-rows // WORD)


def kernel_bound_s(work: dict, rows: int, peak: dict) -> tuple[float, str]:
    """Least seconds of the executor's kernels for one call, and its term."""
    ops = work["gates"] * words(rows) / int32_ops_per_s(peak)
    data = (work["planes_in"] + work["planes_out"]) * words(rows) * 4 / peak["hbm_bytes_per_s"]
    return (ops, "operations") if ops >= data else (data, "bytes")


def call_bound_s(work: dict, row_bytes: int, rows: int, peak: dict) -> tuple[float, str]:
    """Least seconds of a whole call, and its term."""
    ops = work["gates"] * words(rows) / int32_ops_per_s(peak)
    data = row_bytes * rows / peak["hbm_bytes_per_s"]
    return (ops, "operations") if ops >= data else (data, "bytes")


def kernel_share(run, is_kernel) -> float | None:
    """The kernel bound of the traced calls over the device time of the
    kernels ``is_kernel`` accepts, in %; None where the trace holds none of
    them or the card has no entry in the table."""
    t = run.trace
    if t is None or run.peak is None:
        return None
    busy = t.device_s(is_kernel)
    if busy <= 0:
        return None
    least = sum(kernel_bound_s(run.cell.work, c.rows, run.peak)[0] for c in t.calls)
    return least / busy * 100
