"""Operations of one dense exact training step (exact_mll's value and
gradient) at a configuration's shapes, at the least the mathematics
needs, whatever computes them.

The Gram: J n^2 one-dimensional kernel values, 6 operations each forward
(the difference, its square and scale, the exp, the weighted sum's
multiply-add) and 6 back (the cotangent times the value, its sum for the
component's weight, the product with the weight and the difference, the
two sums over rows and columns for the projected coordinates), and the
projection x P (2 n D J) with its lengthscale cotangent (2 n J). The
factor of n, not of the padded size the program factors: n^3 / 3. Its
VJP by blocked reverse mode (Murray 2016, arXiv:1602.07527): the adjoint
of each level-3 operation of the blocked factor (an update C -= A B^T, a
triangular solve X = B L^-T) is two operations of its own size, one a
cotangent of each input, so the VJP is 2 n^3 / 3; the leaves' own
adjoints are O(n b^2) and left out. The solves: y's two triangular
solves (2 n^2), again in the gradient, and the outer product alpha
alpha^T (n^2)."""


def flops(cfg, n: int) -> float:
    J, D = cfg["kernel"]["J"], cfg["data"]["d"]
    gram = 12 * J * n * n + 2 * n * D * J + 2 * n * J
    factor = n ** 3 / 3 + 2 * n ** 3 / 3
    solves = 5 * n * n
    return gram + factor + solves
