"""K6 / K7 (the dense projected Gram K (n, m) = sum_j w_j k1d(u1[j, :, None]
- u2[j, None, :]) and its backward): one call's bytes and operations.

Forward: the coordinates u1 (J, n) and u2 (J, m) read once, K written
once; 6 operations a one-dimensional value (the difference, its square
and scale, the exp, the weighted sum's multiply-add). Backward: the
coordinates read, du1 and du2 written, the cotangent G read once; 6
operations a value (the cotangent times the value, its sum for the
component's weight, the product with the difference, the two sums over
rows and columns). Against counts/peaks.py's HBM rate and float32 rate
both bound at the exact cell's shape by the operations; the exp unit
(16 exps a clock an SM, one a value), which peaks.py does not hold, is
the tighter bound, about 2.7x the float32 one at 6 operations a value,
so the share reads low and never high."""


def work(J: int, n: int, m: int, direction: str) -> tuple:
    """(bytes, flops) of one call; direction "fwd" or "bwd"."""
    if direction == "fwd":
        nbytes = 4 * (J * (n + m) + n * m)
    elif direction == "bwd":
        nbytes = 4 * (2 * J * (n + m) + n * m)
    else:
        raise ValueError(f"unknown direction {direction!r}")
    return nbytes, 6 * J * n * m
