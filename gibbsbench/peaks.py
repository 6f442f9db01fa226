"""The yardstick of every roofline and utilisation share: one NVIDIA H100
SXM (NVIDIA's data sheet, dense rates at 700 W).

PEAK_FLOPS is the card's fastest arithmetic at or above the precision of
any mode the program runs (bf16 on the tensor cores), so that however a
later change computes a product, no share can pass 100%; shares of fp32
or 3xTF32 work therefore read low by design.
"""
PEAK_FLOPS = 989e12        # FLOP/s
PEAK_BYTES = 3.35e12       # HBM bytes/s


def least_seconds(launches) -> float:
    """The least time the card could take for [(flops, bytes), ...]: per
    launch the larger of its operations over PEAK_FLOPS and its bytes
    over PEAK_BYTES, summed."""
    return sum(max(f / PEAK_FLOPS, b / PEAK_BYTES) for f, b in launches)
