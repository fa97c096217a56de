"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): f32
outside the tensor cores and HBM3 bandwidth, at the 700 W power limit.
A run reads the card's own power limit beside them."""

PEAK_F32 = 67e12  # FLOP/s
PEAK_BYTES = 3.35e12  # B/s


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (s) the card could take, and what sets it."""
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
