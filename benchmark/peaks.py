"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the card's full 700 W power limit)."""

BF16_FLOPS = 989e12          # tensor cores, bf16 and fp16
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12           # CUDA cores
HBM_BYTES_PER_S = 3.35e12


def flops_peak(itemsize: int) -> float:
    """The product peak of operands of ``itemsize`` bytes: bf16 on the
    tensor cores, float32 on the CUDA cores."""
    return BF16_FLOPS if itemsize <= 2 else FP32_FLOPS


def bound_s(flops: float, nbytes: float, itemsize: int) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over the memory's."""
    return max(flops / flops_peak(itemsize), nbytes / HBM_BYTES_PER_S)
