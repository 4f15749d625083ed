"""The chiral p+ip superconductor on a W-leg cylinder of bench config 5
(``bench.py:105-154``), as a BdG Hamiltonian in the complex-fermion Nambu
layout (c^dag_i, c_i) per site; a seeded field shifts the chemical
potential site by site, in each site's particle and hole entries."""

import numpy as np


def n_sites(params: dict, Lx: int) -> int:
    return params["W"] * Lx


def build(params: dict, Lx: int) -> np.ndarray:
    W, t, delta, mu = params["W"], params["t"], params["delta"], params["mu"]
    L = W * Lx
    H = np.zeros((2 * L, 2 * L), complex)

    def idx(x, y):
        return x * W + (y % W)

    def add_hop(i, j, amp):
        H[2 * i, 2 * j] += -amp / 2
        H[2 * j, 2 * i] += -np.conj(amp) / 2
        H[2 * i + 1, 2 * j + 1] += np.conj(amp) / 2
        H[2 * j + 1, 2 * i + 1] += amp / 2

    def add_pair(i, j, amp):  # amp c_i^dag c_j^dag + h.c.
        H[2 * i, 2 * j + 1] += amp / 2
        H[2 * j + 1, 2 * i] += np.conj(amp) / 2
        H[2 * j, 2 * i + 1] += -amp / 2
        H[2 * i + 1, 2 * j] += -np.conj(amp) / 2

    for x in range(Lx):
        for y in range(W):
            i = idx(x, y)
            H[2 * i, 2 * i] = -mu / 2
            H[2 * i + 1, 2 * i + 1] = mu / 2
            if x + 1 < Lx:
                add_hop(i, idx(x + 1, y), t)
                add_pair(i, idx(x + 1, y), delta)  # p_x
            if W > 2:
                add_hop(i, idx(x, y + 1), t)
                add_pair(i, idx(x, y + 1), 1j * delta)  # i p_y
    return H + H.conj().T - np.diag(np.diag(H).real)


def with_field(H: np.ndarray, field: np.ndarray) -> np.ndarray:
    """H with the chemical potential of site i raised by ``field[i]``: the
    term -field[i] c^dag_i c_i, split over the particle and hole entries."""
    d = np.zeros(len(H))
    d[0::2] = -field / 2
    d[1::2] = field / 2
    return H + np.diag(d)
