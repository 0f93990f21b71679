"""K2 (the SKI interpolation transpose U = W^T V, tfrac (J, n), V (n, t)
-> (J, t, m)): tfrac and V read once, U written once; a multiply-add for
each of the 4 taps of each point, component and column."""


def work(J: int, n: int, t: int, m: int) -> tuple:
    """(bytes, flops) of one call."""
    return 4 * (J * n + n * t + J * t * m), 2 * 4 * J * n * t
