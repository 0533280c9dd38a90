"""Published peaks of the card, from NVIDIA's H100 SXM data sheet (dense
rates, at the full power limit of 700 W). The benchmark's own copy: a
share of a roofline is taken against these numbers."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # outside the tensor cores


def roofline_s(n_bytes: float, n_flop: float) -> float:
    """The least time the card can take to move ``n_bytes`` to and from
    HBM and do ``n_flop`` float32 operations outside the tensor cores."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S)
