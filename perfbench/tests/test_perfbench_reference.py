"""The plain references agree with the port at a test's size on the CPU,
and their control (the next lower precision in the program's place) does
not."""

import numpy as np
import pytest

import checks
import harness
from pb_helpers import tiny_cell

CELLS = ("slater_cyl8.L512_chi128", "pfaffian_pip8.Lx16_chi256")


def _readings(name, seed, sites=None):
    cell = tiny_cell(name)
    entry, ref = cell.module("entries"), cell.module("references")
    H = harness.inputs(cell, seed, [1])[0]
    chi = cell.spec["chi_max"]
    mps = entry.convert(H, chi, "cpu")
    L = len(mps._B)
    sites = list(range(L)) if sites is None else sites
    prog = entry.extract(mps, sites)
    exact = ref.state(H, chi, sites, "cpu")
    control = ref.state(H, chi, sites, "cpu", ref.CONTROL)
    return cell, checks.compare(prog, exact), checks.compare(control, exact)


@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_pfaffian_reference_agrees_with_the_port(seed):
    cell, prog, _ = _readings("pfaffian_pip8.Lx16_chi256", seed)
    assert prog["structure_errors"] == 0
    assert prog["spectrum_gap"] < 1e-12 and prog["tensor_gap"] < 1e-8


def _jordan_wigner(L):
    """c_0 .. c_{L-1} as dense matrices, site 0 the leading tensor factor."""
    Z, a, one = np.diag([1.0, -1.0]), np.array([[0.0, 1.0], [0.0, 0.0]]), np.eye(2)
    out = []
    for i in range(L):
        m = np.ones((1, 1))
        for j in range(L):
            m = np.kron(m, Z if j < i else (a if j == i else one))
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [7, 2**31 + 3])
def test_pfaffian_reference_is_the_ground_state(seed):
    """The reference's signed tensors, contracted at a size that nothing
    truncates, give the ground state of the many-body Hamiltonian
    sum_ab Psi_a^dag H_ab Psi_b, Psi = (c_0, c_0^dag, ...), found by brute
    force: the check needs neither the program nor its conventions."""
    cell = tiny_cell("pfaffian_pip8.Lx16_chi256", Lx=2, chi_max=64)
    ref = cell.module("references")
    H = harness.inputs(cell, seed, [1])[0]
    L = len(H) // 2
    c = _jordan_wigner(L)
    psi_ops = [m for ci in c for m in (ci, ci.T)]
    Hm = sum(H[x, y] * psi_ops[x].T @ psi_ops[y] for x, y in zip(*np.nonzero(H)))
    gs = np.linalg.eigh(Hm)[1][:, 0]
    r = ref.state(H, 64, range(L), "cpu")
    v = np.ones((1, 1), complex)
    for i in range(L):
        if i == L // 2:
            v = v * r["lam"][i][None, :]
        v = np.einsum("xa,anb->xnb", v, r["tensors"][i]).reshape(-1, r["tensors"][i].shape[2])
    assert abs(np.vdot(gs, v[:, 0])) / np.linalg.norm(v) > 1 - 1e-10


@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_slater_reference_agrees_with_the_port(seed):
    """Every bond and every site but the first right-canonical one (the
    centre L // 2), where the port's tensor is off on near-degenerate
    centre modes (PERF.md, Open questions; the reference is held against
    extended precision there below)."""
    L = 4 * tiny_cell("slater_cyl8.L512_chi128").spec["Lx"]
    cell, prog, _ = _readings("slater_cyl8.L512_chi128", seed,
                              [i for i in range(L) if i != L // 2])
    assert prog["structure_errors"] == 0
    assert prog["spectrum_gap"] < 1e-12 and prog["tensor_gap"] < 1e-8


def test_slater_reference_against_extended_precision():
    """The reference's centre-site tensor against a 40-digit evaluation of
    the same overlaps (mpmath), on the seed where the port's is off by
    2.1e-5."""
    mp = pytest.importorskip("mpmath")
    mp.mp.dps = 40
    cell = tiny_cell("slater_cyl8.L512_chi128")
    ref = cell.module("references")
    H = harness.inputs(cell, 3, [1])[0]
    L, chi, i = len(H), cell.spec["chi_max"], len(H) // 2
    cuts = ref.bond_spectra(H, chi, np.float64, [i])[1]
    E, V = mp.eigsy(mp.matrix(H.tolist()))
    occ = [k for k in range(L) if E[k] < 0]
    Vo = mp.matrix([[V[r, k] for k in occ] for r in range(L)])
    C = Vo * Vo.T

    def block(x):
        e, U = mp.eigsy(C[0:x, 0:x])
        return [e[k] for k in range(x)], U

    def lam(x, cut):
        e = block(x)[0]
        ent = [k for k in range(x) if 1e-12 < e[k] < 1 - 1e-12]
        return np.array([float(mp.fprod(mp.sqrt(e[k]) if o[k] else mp.sqrt(1 - e[k])
                                        for k in ent)) for o in cut.occ])

    a, b = cuts[i], cuts[i + 1]
    Ua, Ub = block(i)[1], block(i + 1)[1]
    Up = mp.matrix(i + 1, i + 1)
    for r in range(i):
        for c in range(i):
            Up[r, c] = Ua[r, c]
    Up[i, i] = 1
    O = Up.T * Ub
    T = np.zeros((len(a.q), 2, len(b.q)))
    for x in range(len(a.q)):
        for y in range(len(b.q)):
            n = int(b.q[y] - a.q[x])
            if n in (0, 1):
                rows = list(np.nonzero(a.occ[x])[0]) + [i] * n
                cols = list(np.nonzero(b.occ[y])[0])
                T[x, n, y] = float(mp.det(mp.matrix([[O[r, c] for c in cols] for r in rows])))
    T *= lam(i + 1, b)[None, None, :] / lam(i, a)[:, None, None]
    R = ref.site_tensor(cuts, i, "B", "cpu")
    assert checks.gauge_gap(R, T) < 1e-8


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell, prog, control = _readings(name, 11)
    limits = cell.spec["limits"]
    assert checks.verdict(prog, limits)
    assert not checks.verdict(control, limits)
    assert control["spectrum_gap"] > 1e3 * prog["spectrum_gap"]


def test_pfaffian_tensors_are_compared_signed():
    """The port's tensors pass, their moduli do not: the signs and phases
    that the Pfaffian fill computes are judged."""
    cell = tiny_cell("pfaffian_pip8.Lx16_chi256")
    entry, ref = cell.module("entries"), cell.module("references")
    H = harness.inputs(cell, 5, [1])[0]
    mps = entry.convert(H, cell.spec["chi_max"], "cpu")
    L = len(mps._B)
    prog = entry.extract(mps, range(L))
    r = ref.state(H, cell.spec["chi_max"], range(L), "cpu")
    assert checks.compare(prog, r)["tensor_gap"] < 1e-10
    moduli = {**prog, "tensors": {i: np.abs(T) for i, T in prog["tensors"].items()}}
    assert checks.compare(moduli, r)["tensor_gap"] > 0.1


def test_gauge_gap_ignores_state_signs_and_sees_an_altered_entry():
    rng = np.random.default_rng(0)
    R = rng.standard_normal((5, 2, 6))
    R[:, 1, :3] = 0.0  # a charge rule: one physical index per pair
    R[:, 0, 3:] = 0.0
    d, e = rng.choice([-1.0, 1.0], 5), rng.choice([-1.0, 1.0], 6)
    T = d[:, None, None] * R * e[None, None, :]
    assert checks.gauge_gap(T, R) < 1e-15
    phase_d = np.exp(1j * rng.uniform(0, 6, 5))
    Tc = phase_d[:, None, None] * R * e[None, None, :]
    assert checks.gauge_gap(Tc, R.astype(complex)) < 1e-14
    T[2, 0, 1] *= 1.5
    assert checks.gauge_gap(T, R) > 0.1 * abs(R[2, 0, 1]) / np.abs(R).max()


def test_match_bond_counts_missing_states_whole():
    lam_r, q_r = np.array([0.8, 0.5, 0.3]), np.array([0, 1, 1])
    gap, ip, ir = checks.match_bond(np.array([0.8, 0.5]), np.array([0, 1]), lam_r, q_r)
    assert gap == pytest.approx(0.3) and list(ip) == [0, 1] and list(ir) == [0, 1]
    gap, *_ = checks.match_bond(lam_r, np.array([0, 0, 1]), lam_r, q_r)
    assert gap == pytest.approx(0.5)
