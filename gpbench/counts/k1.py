"""K1 (the Cholesky factor and inverse of B symmetric (b, b) blocks, A ->
L, L^{-1}): A read once, L and L^{-1} written once; b^3 / 3 operations
for the factor and b^3 / 3 for the triangular inverse, a block."""


def work(B: int, b: int) -> tuple:
    """(bytes, flops) of one call."""
    return 4 * 3 * B * b * b, B * 2 * b ** 3 / 3
