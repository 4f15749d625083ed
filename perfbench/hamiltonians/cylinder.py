"""The tight-binding cylinder of bench config 1 (``bench.py:262-288``,
``chip_smoke.cylinder``): width W, periodic around the circumference,
axis hoppings alternating between the two values of ``t_axis``, a
circumference hopping ``t_circ`` and a uniform on-site ``onsite``; a
seeded field adds an on-site potential per site."""

import numpy as np


def n_sites(params: dict, Lx: int) -> int:
    return params["W"] * Lx


def build(params: dict, Lx: int) -> np.ndarray:
    W = params["W"]
    L = W * Lx
    t_even, t_odd = params["t_axis"]
    H = np.zeros((L, L))

    def idx(x, y):
        return x * W + y % W

    for x in range(Lx):
        for y in range(W):
            if x + 1 < Lx:
                t = t_even if x % 2 == 0 else t_odd
                H[idx(x, y), idx(x + 1, y)] = H[idx(x + 1, y), idx(x, y)] = t
            if W > 1:
                H[idx(x, y), idx(x, y + 1)] = H[idx(x, y + 1), idx(x, y)] = params["t_circ"]
    return H + params["onsite"] * np.eye(L)


def with_field(H: np.ndarray, field: np.ndarray) -> np.ndarray:
    """H plus the on-site potential ``field`` (one value per site)."""
    return H + np.diag(field)
