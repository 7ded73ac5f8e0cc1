"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity, at the card's 700 W power limit).  A copy kept with the
benchmark, so that the program cannot move its own yardstick."""

BF16_FLOPS = 989e12  # bf16 / fp16 tensor-core FLOP/s
HBM_BYTES_S = 3.35e12  # HBM3 bytes/s
HBM_BYTES = 80e9


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over the
    bf16 peak and bytes over the HBM peak."""
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_S)
