"""Bytes and bounds of the port's field kernels (csrc/field_kernels.cu),
and the card's peaks.

A field element is 20 limbs of 4 bytes, one lane per thread. A binary
kernel (mont_mul, add, sub) reads two elements and writes one: 240 bytes
a lane. A butterfly (bfly_dif, bfly) reads u, v and the twiddle and
writes two: 400 bytes a lane. Each input and output byte is counted once.
All five are bound by memory: a mont_mul lane's ~1,900 integer ops at
33.5 T/s take 57 ns per thousand lanes against 72 ns for its bytes.
"""
from __future__ import annotations

ELEMENT_BYTES = 20 * 4
BYTES_PER_LANE = {
    "mont_mul": 3 * ELEMENT_BYTES,
    "add": 3 * ELEMENT_BYTES,
    "sub": 3 * ELEMENT_BYTES,
    "bfly_dif": 5 * ELEMENT_BYTES,
    "bfly": 5 * ELEMENT_BYTES,
}

KERNEL_NAMES = tuple(BYTES_PER_LANE)

# published peaks (NVIDIA's data sheet, SXM part, at the 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def bound_s(kernel: str, lanes: int, peak: dict = DEFAULT_PEAK) -> float:
    """The least time one launch of ``kernel`` over ``lanes`` can take."""
    return lanes * BYTES_PER_LANE[kernel] / peak["hbm_bytes_per_s"]


def roofline_pct(lanes: dict, device_ns: dict,
                 peak: dict = DEFAULT_PEAK) -> float | None:
    """100 x (sum of bound times) / (sum of device times) over every
    launch of every kernel. ``lanes[k]`` are kernel k's launches' lane
    counts and ``device_ns[k]`` their device times, in launch order. None
    when there is no launch; ValueError when the two disagree in number
    for a kernel (a launch the trace lost, or one it holds from outside
    the window)."""
    bound = spent = 0.0
    for kern in sorted(set(lanes) | set(device_ns)):
        n, d = lanes.get(kern, []), device_ns.get(kern, [])
        if len(n) != len(d):
            raise ValueError(f"{kern}: lanes of {len(n)} launches recorded, "
                             f"{len(d)} launches in the trace")
        bound += sum(bound_s(kern, x, peak) for x in n)
        spent += sum(d) / 1e9
    if spent <= 0:
        return None
    return 100.0 * bound / spent
