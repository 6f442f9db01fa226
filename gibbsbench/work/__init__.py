"""Work counters, one file a kernel: ``launches(s)`` gives the FLOPs and
bytes of each launch of the kernel in one step of the cell whose shapes
are `s` (T, N, B, group, lanes, precision, betas). FLOPs count the
algorithm's multiply-adds twice, once, whatever implements them; bytes
count each input read once and each output written once, at the width the
mode requires. Shapes of a kernel that a step does not launch give []."""


def omega_bytes(s) -> int:
    """Bytes of one omega element as K2 and K6 read it: a bf16 stream at
    "default" (and at "sr" in the fused loop), float32 otherwise."""
    return 2 if s["precision"] in ("default", "sr") else 4


def groups(s):
    GB = s["group"] * s["B"]
    return s["N"] // s["group"], GB, GB * (GB + 1) // 2
