"""temfpy_torch.parallel on an 8-shard CPU mesh (logical shards of the CPU),
the port of tests/test_parallel.py.

A conversion under ``use_mesh`` must equal the conversion without one, site
tensor by site tensor (within 1e-12; on the CPU the shards run the same
twins on the same inputs, so the bits agree), and agree with the JAX
package's conversion under its virtual 8-device mesh on the same C by the
parity rules (fidelity, squared Schmidt values, charges).  The sharded
kernels must match their dense counterparts, and the residency helpers
must keep the chain bond-sharded.
"""

import functools

import numpy as np
import pytest
import torch

from temfpy_torch import config, gutzwiller, pfaffian, slater, testing
from temfpy_torch.mps.io import mps_from_arrays
from temfpy_torch.ops import kernels, linalg
from temfpy_torch.ops import pfaffian as ops_pfaffian
from temfpy_torch.parallel import mesh as pmesh
from torch_parity import squared_spectra_diff

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small twin ops per shard: one intra-op thread keeps them from
    spinning the pool under a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return pmesh.make_mesh(devices=["cpu"] * 8)


def _gapped_C(L, seed=3):
    H = np.zeros((L, L))
    for i in range(L - 1):
        H[i, i + 1] = H[i + 1, i] = -1.0 - 0.3 * (-1) ** i
    rng = np.random.default_rng(seed)
    H += np.diag(0.05 * rng.standard_normal(L))
    e, v = np.linalg.eigh(H)
    occ = v[:, e < 0]
    return occ @ occ.T


def _chain(L, t=-1.0, dimer=0.0):
    H = np.zeros((L, L))
    for i in range(L - 1):
        H[i, i + 1] = H[i + 1, i] = t - dimer * (-1) ** i
    return H


def _dev(a, b):
    """Largest entry difference of two lists of site tensors (bond-sharded
    ones gathered)."""
    return max(float((pmesh.gather_replicated(x) - pmesh.gather_replicated(y)).abs().max())
               for x, y in zip(a, b))


def _same_state(ref, out):
    assert ref.L == out.L
    assert _dev(ref._B, out._B) <= TOL
    for sa, sb in zip(ref._S, out._S):
        np.testing.assert_array_equal(sa, sb)
    for qa, qb in zip(ref.q_bond, out.q_bond):
        np.testing.assert_array_equal(qa, qb)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_make_mesh_grids_and_refusals(mesh):
    assert mesh.shape == {"cuts": 2, "pairs": 4}
    assert mesh.distinct == [torch.device("cpu")] and mesh.first == torch.device("cpu")
    assert pmesh.make_mesh(devices=["cpu"] * 6).shape == {"cuts": 2, "pairs": 3}
    assert pmesh.make_mesh(3, devices=["cpu"] * 8).shape == {"cuts": 1, "pairs": 3}
    with pytest.raises(ValueError):
        pmesh.make_mesh(devices=[])
    with pytest.raises(ValueError):
        pmesh.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        pmesh.make_mesh(devices=["meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pmesh.make_mesh()  # no card: a mesh with no devices raises
        with pytest.raises(RuntimeError):
            pmesh.make_mesh(devices=["cuda:0"])
    with pytest.raises(TypeError):
        pmesh.use_mesh(["cpu"])
    assert pmesh.active_mesh() is None
    with pmesh.use_mesh(mesh):
        assert pmesh.active_mesh() is mesh and config.default_device() == mesh.first
    assert pmesh.active_mesh() is None


def test_shard_batch_and_replicate_roundtrip(mesh):
    x = torch.arange(32.0).reshape(16, 2)
    assert len(pmesh.shard_batch(x)) == 1 and pmesh.replicate(x) == {x.device: x}
    with pmesh.use_mesh(mesh):
        parts = pmesh.shard_batch(x)
        rep = pmesh.replicate(x)
        cuts = pmesh.shard_batch(x, "cuts")
    assert [p.shape[0] for p in parts] == [16 // mesh.shape["pairs"]] * mesh.shape["pairs"]
    torch.testing.assert_close(torch.cat(parts), x, rtol=0, atol=0)
    assert [p.shape[0] for p in cuts] == [8, 8]
    assert list(rep) == [torch.device("cpu")] and rep[torch.device("cpu")] is x


def test_gather_replicated_gathers_or_raises(mesh):
    x = torch.arange(2 * 64 * 3, dtype=torch.float64).reshape(64, 2, 3)
    with pmesh.use_mesh(mesh):
        s = pmesh.bond_shard_put(x)
    assert pmesh.is_bond_sharded(s) and s.shape == x.shape
    assert [hi - lo for lo, hi, _ in s.shards] == [8] * 8
    assert pmesh.gather_replicated(s).equal(x)
    assert pmesh.gather_replicated(x) is x
    assert pmesh.bond_shard_put(x) is x  # no mesh: a no-op
    small = x[:40]
    assert pmesh.bond_shard_put(small, mesh) is small  # below min_dim
    odd = torch.zeros((67, 2, 3), dtype=torch.float64)
    assert pmesh.bond_shard_put(odd, mesh) is odd  # gcd(67, 8) = 1
    holey = pmesh.BondSharded([(0, 8, x[:8]), (16, 64, x[16:])], x.shape, x.dtype)
    with pytest.raises(ValueError, match="missing"):
        pmesh.gather_replicated(holey)
    wrong = pmesh.BondSharded([(0, 32, x[:32]), (32, 64, x[32:, :1])], x.shape, x.dtype)
    with pytest.raises(ValueError, match="malformed"):
        pmesh.gather_replicated(wrong)
    with pytest.raises(TypeError):
        pmesh.gather_replicated([x])


# ---------------------------------------------------------------------------
# the sharded kernels
# ---------------------------------------------------------------------------


def test_sharded_schmidt_spectra_matches_dense(mesh):
    C = _gapped_C(12)
    sizes = np.arange(1, 12, dtype=np.int32)  # 11 cuts: 5 and 6 on the 2 "cuts" shards
    e_s, v_s = pmesh.sharded_schmidt_spectra(torch.as_tensor(C), sizes, "L", mesh)
    assert e_s.shape == (11, 12)
    for i, x in enumerate(sizes):
        np.testing.assert_allclose(e_s[i, :x].numpy(), np.linalg.eigvalsh(C[:x, :x]),
                                   atol=TOL)
    e_d, v_d = linalg.eigh_blocks(torch.as_tensor(C), sizes, "R")
    with pmesh.use_mesh(mesh):
        e_m, v_m = linalg.eigh_blocks(torch.as_tensor(C), sizes, "R", chunk=4)
    assert e_m.equal(e_d) and v_m.equal(v_d)


def test_sharded_det_pairs_matches_dense(mesh, monkeypatch):
    rng = np.random.default_rng(0)
    M = rng.standard_normal((10, 10))
    rows = rng.integers(0, 10, size=(22, 4)).astype(np.int32)
    cols = rng.integers(0, 10, size=(22, 4)).astype(np.int32)
    sizes = []
    monkeypatch.setattr(kernels, "det_rows", functools.partial(
        lambda f, M, r, c: (sizes.append(r.shape[1]), f(M, r, c))[1], kernels.det_rows))
    out = pmesh.sharded_det_pairs(torch.as_tensor(M), rows, cols, mesh)
    assert sizes == [5, 6, 5, 6]  # 22 pairs over 4 "pairs" shards, no padding
    expect = [np.linalg.det(M[np.ix_(r, c)]) for r, c in zip(rows, cols)]
    # duplicate random indices give exact-zero determinants, reproduced to
    # round-off only
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-10, atol=1e-10)


def test_index_row_ops_split_over_pairs(mesh, monkeypatch):
    """The public pair-batch ops under the mesh: one launch per "pairs"
    shard, each on its slice, and the dense result."""
    rng = np.random.default_rng(1)
    M = torch.as_tensor(rng.standard_normal((9, 9)))
    rows = rng.integers(0, 9, size=(30, 3))
    cols = rng.integers(0, 9, size=(30, 3))
    N = torch.as_tensor(rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8)))
    N = N - N.T
    bra, ket = rng.integers(0, 8, size=(10, 2)), rng.integers(0, 8, size=(6, 2))
    idx = torch.as_tensor(np.concatenate([rows[:, :2], cols[:, :2]], 1) % 8)
    dense = (linalg.batched_det_pairs(M, rows, cols), linalg.batched_det_gather(M, rows, cols),
             ops_pfaffian.batched_pfaffian_gather(N, bra, ket, 0),
             ops_pfaffian.batched_pfaffian_pairs(N, idx, 0))
    seen = []
    for name in ("det_rows", "pf_gather"):
        orig = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, functools.partial(
            lambda f, n, *a, **k: (seen.append((n, pmesh.current_shard())), f(*a, **k))[1],
            orig, name))
    with pmesh.use_mesh(mesh):
        split = (linalg.batched_det_pairs(M, rows, cols), linalg.batched_det_gather(M, rows, cols),
                 ops_pfaffian.batched_pfaffian_gather(N, bra, ket, 0),
                 ops_pfaffian.batched_pfaffian_pairs(N, idx, 0))
    for a, b in zip(dense, split):
        assert a.equal(b)
    shards = {("pairs", s) for s in range(mesh.shape["pairs"])}
    assert {sh for n, sh in seen if n == "det_rows"} == shards
    assert {sh for n, sh in seen if n == "pf_gather"} == shards


def test_flagship_forward_matches_jax():
    import jax.numpy as jnp
    from temfpy_tpu.parallel import mesh as jmesh

    C = _gapped_C(10)
    e, ent = pmesh.flagship_forward(torch.as_tensor(C))
    e_j, ent_j = jmesh.flagship_forward(jnp.asarray(C))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=1e-12)
    np.testing.assert_allclose(ent.numpy(), np.asarray(ent_j), atol=1e-12)


def test_multichip_conversion_step_runs(mesh):
    out = pmesh.multichip_conversion_step(mesh, L=12, width=4)
    assert np.isfinite(out)


# ---------------------------------------------------------------------------
# conversions under the mesh
# ---------------------------------------------------------------------------


def test_use_mesh_conversion_matches_one_device(mesh, monkeypatch):
    """C_to_MPS under use_mesh == without, tensor by tensor; K1 and K2
    launch on every "pairs" shard."""
    C = _gapped_C(16)
    ref = slater.C_to_MPS(C, {"chi_max": 16}, device="cpu")
    seen = {"det_fill": set(), "site_overlap_schur": set()}
    for name in seen:
        orig = getattr(slater, name)
        monkeypatch.setattr(slater, name, functools.partial(
            lambda f, n, *a, **k: (seen[n].add(pmesh.current_shard()), f(*a, **k))[1],
            orig, name))
    with pmesh.use_mesh(mesh):
        out = slater.C_to_MPS(C, {"chi_max": 16})
    _same_state(ref, out)
    assert seen["det_fill"] == {("pairs", s) for s in range(4)}
    # K2's groups here hold one site each (every site has its own frame
    # widths), which the first shard takes
    assert ("pairs", 0) in seen["site_overlap_schur"] <= {("pairs", s) for s in range(4)}


def test_rank_update_path_under_mesh(mesh, monkeypatch):
    """The rank-update fill under the mesh (the CPU's default): the probe's
    K6b values and K5 determinants and the K6b scatter split over the
    "pairs" shards; the state equals the one-device one."""
    W, L = 8, 32
    H = np.zeros((L, L))
    for i in range(L):
        j = (i // W) * W + (i + 1) % W
        H[i, j] = H[j, i] = -1.0
        if i + W < L:
            H[i, i + W] = H[i + W, i] = -1.0
    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "1")
    ref = slater.H_to_MPS(H, {"chi_max": 96}, device="cpu")
    assert slater._swap_stats()["classes"] > slater._swap_stats()["fallbacks"]
    seen = {"swap_fill": set(), "det_rows": set()}
    for name in seen:
        orig = getattr(slater, name)
        monkeypatch.setattr(slater, name, functools.partial(
            lambda f, n, *a, **k: (seen[n].add(pmesh.current_shard()), f(*a, **k))[1],
            orig, name))
    with pmesh.use_mesh(mesh):
        out = slater.H_to_MPS(H, {"chi_max": 96})
    _same_state(ref, out)
    assert seen == {n: {("pairs", s) for s in range(4)} for n in seen}


def test_copies_between_shard_devices(monkeypatch):
    """Shards on devices other than the inputs' take the copy paths: every
    argument copied to the shard's device, a fill into a zeroed buffer of
    the shard's own that is added into the slot buffer, and bond-sharded
    blocks on their shards' devices.  Indexed CPU devices stand in for
    distinct cards (a "cpu:k" shard is not the device of a CPU tensor, so
    torch copies to it), and the states equal the one-device ones."""
    mesh = pmesh.make_mesh(devices=[f"cpu:{k}" for k in range(4)])
    assert len(mesh.distinct) == 4
    monkeypatch.setattr(testing, "TEST_ACTION", "pass")
    H = _chain(24, dimer=0.2)
    for updates, gate in (("1", 2048), ("0", 32)):
        monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", updates)
        monkeypatch.setattr(config, "CHI_SHARD_MIN", gate)
        ref = slater.H_to_MPS(H, {"chi_max": 64}, device="cpu")
        with pmesh.use_mesh(mesh):
            out = slater.H_to_MPS(H, {"chi_max": 64})
        _same_state(ref, out)
    # the whole chain: split tensors and those held whole by every device
    n_sharded, per = pmesh.residency(out._B, mesh)
    assert n_sharded >= 8 and max(per) / min(per) < 1.01, (n_sharded, per)
    Hb = testing.pip_hamiltonian(2, 4)
    ref = pfaffian.H_to_MPS(Hb, {"chi_max": 64}, basis="C", device="cpu")
    with pmesh.use_mesh(mesh):
        _same_state(ref, pfaffian.H_to_MPS(Hb, {"chi_max": 64}, basis="C"))


@pytest.fixture(scope="module")
def jax_mesh_state():
    """The JAX package's conversion of _gapped_C(24) under its virtual
    8-device mesh (tests/conftest.py)."""
    import jax
    from temfpy_tpu import slater as jslater
    from temfpy_tpu.parallel import mesh as jmesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the JAX package's virtual multi-device mesh")
    with jmesh.use_mesh(jmesh.make_mesh()):
        m = jslater.C_to_MPS(_gapped_C(24), {"chi_max": 24})
    return m


def test_mesh_conversion_matches_jax_mesh(mesh, jax_mesh_state):
    j = jax_mesh_state
    theirs = mps_from_arrays([np.asarray(B) for B in j._B], [np.asarray(S) for S in j._S],
                             j.q_bond, j.qtotal, j.form, device="cpu")
    with pmesh.use_mesh(mesh):
        ours = slater.C_to_MPS(_gapped_C(24), {"chi_max": 24})
    fid = abs(ours.overlap(theirs)) / np.sqrt(ours.norm_squared() * theirs.norm_squared())
    assert fid >= 1 - 1e-10
    assert squared_spectra_diff(ours, theirs) <= 1e-12


def test_chi_sharded_fill_matches_one_device(mesh, monkeypatch):
    """With CHI_SHARD_MIN lowered to test scale, the fill's bond rows split
    over "cuts" (each shard fills the pairs whose rows it holds), the site
    tensors stay bond-sharded, and the state equals the one-device one."""
    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "0")  # all pairs direct
    C = slater.correlation_matrix(_chain(24), device="cpu")[0].numpy()
    ref = slater.C_to_MPS(C, {"chi_max": 64}, device="cpu")
    monkeypatch.setattr(config, "CHI_SHARD_MIN", 32)
    calls = []
    orig = slater._fill_group
    monkeypatch.setattr(slater, "_fill_group", lambda *a: (
        calls.append(isinstance(a[4], slater._ChiBuffer)), orig(*a))[1])
    shards = set()
    orig_fill = slater.det_fill
    monkeypatch.setattr(slater, "det_fill", lambda *a, **k: (
        shards.add(pmesh.current_shard()), orig_fill(*a, **k))[1])
    with pmesh.use_mesh(mesh):
        out = slater.C_to_MPS(C, {"chi_max": 64})
    assert any(calls), "no fill bucket took the chi-sharded path; lower the test threshold"
    assert {s for s in shards if s and s[0] == "chi"} == {
        ("chi", (k, j)) for k in range(2) for j in range(4)}
    _same_state(ref, out)
    n_sharded, per = pmesh.residency(out._B, mesh)
    assert n_sharded >= 8 and max(per) / min(per) < 1.01


def test_mesh_pfaffian_matches_one_device(mesh, monkeypatch):
    """The BdG conversion under the mesh (K4 sites and K3 pairs split over
    "pairs", the shards' fills summed) equals the one-device one."""
    monkeypatch.setattr(testing, "TEST_ACTION", "pass")
    H = testing.pip_hamiltonian(2, 4)
    ref = pfaffian.H_to_MPS(H, {"chi_max": 64}, basis="C", device="cpu")
    seen = set()
    orig = pfaffian.pf_fill
    monkeypatch.setattr(pfaffian, "pf_fill", lambda *a, **k: (
        seen.add(pmesh.current_shard()), orig(*a, **k))[1])
    with pmesh.use_mesh(mesh):
        out = pfaffian.H_to_MPS(H, {"chi_max": 64}, basis="C")
    _same_state(ref, out)
    assert seen == {("pairs", s) for s in range(4)}


def test_gutzwiller_flow_under_mesh(mesh):
    H = _chain(8)
    ref = gutzwiller.abrikosov_ph(slater.H_to_MPS(H, {"chi_max": 32}, spinful="PH",
                                                  device="cpu"))
    with pmesh.use_mesh(mesh):
        out = gutzwiller.abrikosov_ph(slater.H_to_MPS(H, {"chi_max": 32}, spinful="PH"))
    _same_state(ref, out)
    np.testing.assert_array_equal(ref.expectation_value("Sz"), out.expectation_value("Sz"))


@pytest.mark.parametrize("gate,chi", [(2048, 24), (8, 12)])
def test_imps_flow_under_mesh(mesh, monkeypatch, gate, chi):
    """The iMPS under the mesh; at gate 8 its cell's fills and the gauge
    overlap are chi-sharded (chi 12: even bonds, so they come back split),
    and the entry point gathers what it contracts."""
    monkeypatch.setattr(config, "CHI_SHARD_MIN", gate)
    H16, H18 = _chain(16, dimer=0.3), _chain(18, dimer=0.3)
    ref, ref_err = slater.H_to_iMPS(H16, H18, dict(chi_max=chi), 2, 8, device="cpu")
    with pmesh.use_mesh(mesh):
        out, out_err = slater.H_to_iMPS(H16, H18, dict(chi_max=chi), 2, 8)
    assert ref_err.total_error == out_err.total_error
    assert _dev(ref._B, out._B) <= TOL


def test_unsplit_tensors_replicated_on_distinct_devices():
    """Over distinct devices a tensor that is not split (a bond below
    min_dim, or sharing no factor with the shard count) is held whole by
    every device, so each shard holds the same bytes; over logical shards
    of one device it stays the plain tensor."""
    mesh = pmesh.make_mesh(devices=[f"cpu:{k}" for k in range(4)])
    x = torch.arange(67 * 6, dtype=torch.float64).reshape(67, 2, 3)
    small = x[:8]
    for t, src in ((pmesh.bond_shard_put(x, mesh), x), (pmesh.bond_shard_put(small, mesh), small),
                   (pmesh.replicate_site(x, mesh), x)):
        assert pmesh.is_bond_sharded(t) and not t.split and len(t.shards) == mesh.size
        assert all(b.equal(src) for _lo, _hi, b in t.shards)
        assert len(set(t.shard_bytes())) == 1
    assert pmesh.gather_replicated(pmesh.replicate_site(x, mesh)).equal(x)
    n_sharded, per = pmesh.residency([pmesh.bond_shard_put(x, mesh),
                                      pmesh.bond_shard_put(x[:64], mesh)], mesh)
    assert n_sharded == 1 and len(set(per)) == 1
    one = pmesh.make_mesh(devices=["cpu"] * 4)
    assert pmesh.replicate_site(x, one) is x and pmesh.bond_shard_put(small, one) is small
    assert pmesh.replicate_site(x) is x  # no mesh


@pytest.fixture
def small_shards(monkeypatch):
    """bond_shard_put from 8 bond rows on (the test chains' bonds are
    below the default 64)."""
    monkeypatch.setattr(pmesh, "bond_shard_put",
                        functools.partial(pmesh.bond_shard_put, min_dim=8))


def test_mesh_resident_canonical_sweep(mesh, small_shards):
    """canonical_form_finite under the mesh keeps its stored tensors
    bond-sharded, balanced over the shards, and equals the one-device
    sweep."""
    ref = slater.C_to_MPS(_gapped_C(24, seed=5), {"chi_max": 32}, device="cpu")
    out = ref.copy()
    ref.canonical_form_finite()
    with pmesh.use_mesh(mesh):
        out.canonical_form_finite()
    _same_state(ref, out)
    n_sharded, per = pmesh.residency(out._B, mesh)
    # every tensor of >= 8 bond rows whose bond shares a factor with the 8
    # shards is held split
    expect = sum(1 for B in out._B if B.shape[0] >= 8 and np.gcd(B.shape[0], 8) > 1)
    assert n_sharded == expect >= 8, f"sweep kept {n_sharded} tensors sharded, not {expect}"
    assert max(per) / min(per) < 1.01


def test_mesh_resident_gutzwiller(mesh, small_shards):
    """abrikosov_ph under the mesh leaves the projected, re-canonicalised
    chain bond-sharded."""
    H = _chain(12, dimer=0.2)
    ref = gutzwiller.abrikosov_ph(slater.H_to_MPS(H, {"chi_max": 48}, spinful="PH",
                                                  device="cpu"))
    with pmesh.use_mesh(mesh):
        out = gutzwiller.abrikosov_ph(slater.H_to_MPS(H, {"chi_max": 48}, spinful="PH"))
    _same_state(ref, out)
    n_sharded, _ = pmesh.residency(out._B, mesh)
    assert n_sharded >= 1, "projection dropped every tensor to whole"
