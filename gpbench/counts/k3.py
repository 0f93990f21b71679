"""K3 (the SKI interpolation apply, out = sum_j W_j G_j, tfrac (J, n), G
(J, t, m) -> (n, t)): tfrac and G read once, out written once; a
multiply-add for each of the 4 taps of each point, component and
column."""


def work(J: int, n: int, t: int, m: int) -> tuple:
    """(bytes, flops) of one call."""
    return 4 * (J * n + J * t * m + n * t), 2 * 4 * J * n * t
