"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  The fits run their products in
full float32 (TF32 off), so float32 outside the tensor cores is the
arithmetic peak that applies."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def roofline_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory peak and operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
