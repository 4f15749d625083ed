"""MPS checkpoints of temfpy_torch (``mps.io.save_mps`` / ``load_mps``) in
the JAX package's ``.npz`` layout, across packages, and the small public
helpers ``setup_logging`` and ``profiling.trace``."""

import logging

import numpy as np
import pytest
import torch

import temfpy_torch
from temfpy_torch import gutzwiller, pfaffian, profiling, slater, testing
from temfpy_torch.mps.io import load_mps, mps_from_arrays, save_mps
from temfpy_torch.parallel import mesh as pmesh


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(L, dimer=0.3):
    H = np.zeros((L, L))
    for i in range(L - 1):
        H[i, i + 1] = H[i + 1, i] = -1.0 - dimer * (-1) ** i
    return H


@pytest.fixture(scope="module")
def states():
    """One state of each kind the checkpoints carry: a finite Slater state,
    a Pfaffian state, a Gutzwiller spin chain and a Slater iMPS cell."""
    testing.TEST_ACTION, prev = "pass", testing.TEST_ACTION
    try:
        out = {
            "slater": slater.H_to_MPS(_chain(12), {"chi_max": 16}, device="cpu"),
            "pfaffian": pfaffian.H_to_MPS(testing.pip_hamiltonian(2, 3), {"chi_max": 16},
                                          basis="C", device="cpu"),
            "spin": gutzwiller.abrikosov_ph(slater.H_to_MPS(
                _chain(8), {"chi_max": 32}, spinful="PH", device="cpu")),
            "imps": slater.H_to_iMPS(_chain(16), _chain(18), {"chi_max": 24}, 2, 8,
                                     device="cpu")[0],
        }
    finally:
        testing.TEST_ACTION = prev
    return out


def _same(a, b):
    """Every field a checkpoint carries, bit for bit."""
    assert (a.L, a.bc, a.unit_cell_width, a.norm) == (b.L, b.bc, b.unit_cell_width, b.norm)
    assert list(a.form) == list(b.form)
    assert [type(s) for s in a.sites] == [type(s) for s in b.sites]
    assert [s.chinfo for s in a.sites] == [s.chinfo for s in b.sites] and a.chinfo == b.chinfo
    for i in range(a.L):
        assert np.array_equal(np.asarray(a._tensor(i)) if hasattr(a, "_tensor")
                              else np.asarray(a._B[i]),
                              np.asarray(b._tensor(i)) if hasattr(b, "_tensor")
                              else np.asarray(b._B[i]))
    for sa, sb in zip(a._S, b._S):
        assert (sa is None and sb is None) or np.array_equal(sa, sb)
    for qa, qb in zip(a.q_bond, b.q_bond):
        assert np.array_equal(qa, qb)
    assert np.array_equal(a.qtotal, b.qtotal)


@pytest.mark.parametrize("kind", ["slater", "pfaffian", "spin", "imps"])
def test_round_trip(states, kind, tmp_path):
    m = states[kind]
    save_mps(tmp_path / "state.npz", m)
    back = load_mps(tmp_path / "state.npz", device="cpu")
    _same(m, back)
    assert back.device == torch.device("cpu")
    if m.finite:
        assert abs(abs(back.overlap(m)) / m.norm_squared() - 1) <= 1e-12


def test_grouped_sites_have_no_tag(states, tmp_path):
    grouped = states["slater"].group_sites(2)
    with pytest.raises(TypeError, match="grouped sites"):
        save_mps(tmp_path / "grouped.npz", grouped)


def test_bond_sharded_state_saves_gathered(states, tmp_path):
    m = states["slater"].copy()
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    m._B = [pmesh.bond_shard_put(B, mesh, min_dim=4) for B in m._B]
    assert any(pmesh.is_bond_sharded(B) for B in m._B)
    save_mps(tmp_path / "sharded.npz", m)
    _same(states["slater"], load_mps(tmp_path / "sharded.npz", device="cpu"))


def _jax_mps(m):
    """The temfpy_tpu MPS with the same fields (host arrays)."""
    from temfpy_tpu.mps import FermionSite as JFermion, MPS as JMPS, SpinHalfSite as JSpin

    sites = [JFermion(s.conserve) if type(s).__name__ == "FermionSite" else JSpin(s.conserve)
             for s in m.sites]
    d = m.to_numpy()
    out = JMPS(sites, d["tensors"], d["lams"], form=d["form"], bc=d["bc"],
               unit_cell_width=d["unit_cell_width"], q_bonds=d["q_bonds"], qtotals=d["qtotals"],
               norm=m.norm)
    return out


@pytest.mark.parametrize("kind", ["slater", "pfaffian", "spin", "imps"])
def test_files_cross_packages(states, kind, tmp_path):
    """A file saved by temfpy_tpu.mps.io.save_mps loads in the port, and a
    port file loads in the JAX package, with the same forms, charges,
    Schmidt values and tensors (fidelity 1 within 1e-12)."""
    from temfpy_tpu.mps import io as jio

    m = states[kind]
    jax_state = _jax_mps(m)
    jio.save_mps(str(tmp_path / "jax.npz"), jax_state)
    ours = load_mps(tmp_path / "jax.npz", device="cpu")
    _same(m, ours)
    save_mps(tmp_path / "port.npz", m)
    theirs = jio.load_mps(str(tmp_path / "port.npz"))
    _same(jax_state, theirs)
    if m.finite:
        back = mps_from_arrays([np.asarray(B) for B in theirs._B], theirs._S, theirs.q_bond,
                               theirs.qtotal, theirs.form, device="cpu", sites=m.sites)
        for got in (ours, back):
            fid = abs(got.overlap(m)) / np.sqrt(got.norm_squared() * m.norm_squared())
            assert abs(fid - 1) <= 1e-12


def test_setup_logging(monkeypatch):
    seen = {}
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: seen.update(kw))
    temfpy_torch.setup_logging(logging.DEBUG)
    assert seen == {"level": logging.DEBUG}


def test_profiling_trace_writes_a_trace(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        slater.H_to_MPS(_chain(6), {"chi_max": 8}, device="cpu")
    files = [p for p in (tmp_path / "trace").rglob("*") if p.is_file()]
    assert files and all(p.stat().st_size > 0 for p in files)
