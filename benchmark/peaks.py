"""Published peaks of the card and the byte bounds of the kernels whose
roofline the benchmark reports. Each bound counts what the work must move,
each byte once: a better tree or a better kernel cannot lower it."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12

# K1 (closest or any hit of a ray against the scene's triangles):
LANE_BYTES = 1 + 16      # every lane: its active byte read, its hit written
ACTIVE_BYTES = 28        # an active lane besides: origin, direction, tmax
FACE_BYTES = 36          # each triangle's p0, e1, e2, once a launch


def k1_bytes(lanes: int, active: int, faces: int) -> int:
    """Bytes one K1 launch must move; the tree is not counted, since its
    size is the implementation's choice."""
    return lanes * LANE_BYTES + active * ACTIVE_BYTES + faces * FACE_BYTES


def bound_seconds(n_bytes: float) -> float:
    """The least time the card could take to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S


def roofline_percent(n_bytes: float, seconds: float) -> float | None:
    """The share of its bound that work of ``n_bytes`` reached in
    ``seconds`` of device time; None where nothing was timed."""
    if seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * bound_seconds(n_bytes) / seconds
