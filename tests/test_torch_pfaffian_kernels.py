"""The plain twins of the two Pfaffian-path CUDA kernels against the JAX
functions they replace, on seeded inputs and on site data captured from a
JAX conversion of a p+ip cylinder at L=16 (both sweep modes, all three fill
layouts), plus the CPU dispatch rules.

Tolerances:
- Pfaffians 1e-12 relative to the largest value: the twin runs the same
  Parlett-Reid elimination, pivot for pivot, and differs from the JAX code
  only in summation order; the sign and zero-pivot cases are exact;
- the overlap matrix N and the norm 1e-12 relative to the largest entry:
  the same products and Gauss-Jordan elimination in another summation
  order, on vacuum overlaps that are far from singular here;
- integer plans and index rows are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from temfpy_tpu import pfaffian as jpf
from temfpy_tpu.ops import pfaffian as jops
from temfpy_tpu.ops import splitc
from temfpy_torch import pfaffian, testing
from temfpy_torch.ops import kernels
from temfpy_torch.ops import pfaffian as ops

RTOL = 1e-12


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, np.abs(a - b).max() / scale


def antisym(rng, n, batch=()):
    A = rng.normal(size=batch + (n, n)) + 1j * rng.normal(size=batch + (n, n))
    return A - np.swapaxes(A, -1, -2)


@pytest.mark.parametrize("n", [2, 4, 6, 8, 12, 16])
def test_batched_pfaffian_matches_jax_and_numpy(n):
    rng = np.random.default_rng(n)
    A = antisym(rng, n, (5,))
    got = ops.batched_pfaffian(torch.as_tensor(A)).numpy()
    close(got, np.asarray(jops.batched_pfaffian(A)))
    close(got, [jops.pfaffian_numpy(a) for a in A])
    # Pf^2 = det, and the single-matrix entry point
    close(got**2, np.linalg.det(A), rtol=1e-10)
    close(ops.pfaffian_single(torch.as_tensor(A[0])).numpy(), got[0])


def test_pfaffian_sign_and_zero_pivots():
    """A row/column swap flips the sign exactly; a zero pivot column, and a
    rank-deficient matrix whose zero pivot appears mid-elimination, give 0."""
    J = np.array([[0, 1], [-1, 0]], complex)
    A = np.kron(np.eye(3), J) * np.array([1.0, 2.0, 3.0]).repeat(2)[:, None]
    A = A - A.T
    p = [0, 3, 2, 1, 4, 5]
    B = A[np.ix_(p, p)]
    vals = ops.batched_pfaffian(torch.as_tensor(np.stack([A, B]))).numpy()
    ref = [jops.pfaffian_numpy(A), jops.pfaffian_numpy(B)]
    np.testing.assert_array_equal(vals, ref)
    np.testing.assert_array_equal(vals, np.asarray(jops.batched_pfaffian(np.stack([A, B]))))
    Z = antisym(np.random.default_rng(1), 6)
    Z[:, 0] = Z[0, :] = 0
    R = antisym(np.random.default_rng(2), 6)
    R[2:4] = 0
    R[:, 2:4] = 0
    for M in (Z, R):
        assert ops.pfaffian_single(torch.as_tensor(M)).item() == 0
        assert complex(jops.batched_pfaffian(M[None])[0]) == 0


def test_symplectic_pad_and_index_rows_match_jax():
    rng = np.random.default_rng(3)
    N = antisym(rng, 6)
    np.testing.assert_array_equal(ops.symplectic_pad(torch.as_tensor(N), 4).numpy(),
                                  np.asarray(jops.symplectic_pad(N, 4)))
    args, kw = testing.random_pf_fill_case(0, G=1, w=8, m=16, P=200, n_rows=40)
    pos_b, pos_k, cnt_b, cnt_k, pr, pc = (a[0] for a in args[2:8])
    got = ops.derive_pair_indices(*(torch.as_tensor(a) for a in (pos_b, pos_k, cnt_b, cnt_k,
                                                                 pr, pc)), 8, 16)
    ref = jops._derive_pair_indices(*(jnp.asarray(a) for a in (pos_b, pos_k, cnt_b, cnt_k,
                                                               pr, pc)), 8, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("spec", ["rc", "rrc", "crr"])
@pytest.mark.parametrize("w", [4, 12, 16])
def test_pf_fill_twin_matches_jax_pairs(spec, w):
    """pf_fill_plain against the JAX pair batch on the same index rows,
    times the norm and scattered by the same tables (pad pairs to the
    trash row)."""
    args, kw = testing.random_pf_fill_case(w, G=2, w=w, m=2 * w, P=500, spec=spec, n_rows=64)
    got = kernels.pf_fill(*(torch.as_tensor(a) for a in args[:8]),
                          tuple(torch.as_tensor(t) for t in args[8]), **kw).numpy()
    N, norm, *tables, tabs = args
    for g in range(2):
        idx = jops._derive_pair_indices(*(jnp.asarray(t[g]) for t in tables), w, N.shape[1])
        vals = np.asarray(jops.batched_pfaffian_pairs(N[g], idx, pad_slots=w)) * norm[g]
        ids = {"r": tables[4][g], "c": tables[5][g]}
        ref = np.zeros((kw["shape"][0] + 1,) + kw["shape"][1:], complex)
        ref[tuple(tabs[i][g][ids[s]] for i, s in enumerate(spec))] = vals
        close(got[g], ref[: kw["shape"][0]])


@pytest.mark.parametrize("spec", ["rc", "crr"])
def test_pf_fill_twin_writes_into_slots(spec):
    """With ``out``/``slot`` the fill writes each site into its slot of a
    caller's buffer, the values of a fresh fill, and leaves other slots
    alone (as det_fill does)."""
    args, kw = testing.random_pf_fill_case(8, G=3, w=8, m=16, P=300, spec=spec, n_rows=32)
    a = [torch.as_tensor(x) for x in args[:8]] + [tuple(torch.as_tensor(t) for t in args[8])]
    got = kernels.pf_fill(*a, **kw)
    shape = kw["shape"]
    buf = torch.zeros((4, shape[0] + 1) + tuple(shape[1:]), dtype=got.dtype)
    out = kernels.pf_fill(*a, **kw, out=buf, slot=[3, 0, 1])
    assert torch.equal(buf[[3, 0, 1], : shape[0]], got) and not buf[2].any()
    assert out.data_ptr() == buf.data_ptr() and tuple(out.shape) == (4,) + tuple(shape)
    with pytest.raises(ValueError):
        kernels.pf_fill(*a, **kw, out=buf, slot=[0, 1])


@pytest.fixture(scope="module")
def captured():
    """Site plans of the port's planner on Schmidt vectors of a JAX
    conversion (p+ip, W=4, Lx=4, chi=32): right- and left-sweep sites with
    a physical leg and a same-cut overlap without one."""
    C = jpf.correlation_matrix(testing.pip_hamiltonian(4, 4), basis="C->M")
    tp = {"chi_max": 32}
    out = []
    for which, mode, cuts in (("R", "right", [8, 9, 10, 11]), ("L", "left", [8, 7, 6, 5])):
        svs = [jpf.SchmidtVectors.from_correlation_matrix(C, x, tp, basis="M", which=which,
                                                          total_parity=0) for x in cuts]
        pairs = [(svs[j + 1], svs[j], mode) for j in range(len(svs) - 1)]
        pairs.append((svs[1], svs[1], mode))
        for b, k, md in pairs:
            out.append((b, k, md, pfaffian._plan_site(b, k, md)))
    return out


def test_bdg_overlap_twin_matches_jax_kernels(captured):
    """On the same padded frames: bdg_overlap_plain (half frames), the JAX
    complex-path ``_assemble_N_complex`` and the split-plane
    ``splitc.pf_overlap_kernel``."""
    for *_, plan in captured:
        V1h, V2h = (torch.as_tensor(f)[None] for f in plan["frames"])
        j1, j2 = (torch.as_tensor(plan[k])[None] for k in ("j1", "j2"))
        N, norm = kernels.bdg_overlap(V1h, V2h, j1, j2,
                                      torch.tensor([plan["thresh"]], dtype=torch.float64))
        V1, V2 = (kernels.nambu_full(v)[0].numpy() for v in (V1h, V2h))
        nb = V1.shape[0] // 2
        Vr = V1.conj().T @ V2
        norm_j, N_j = jpf._assemble_N_complex(jnp.asarray(Vr), jnp.asarray(plan["j1"]),
                                              jnp.asarray(plan["j2"]), L=nb, min_SV=1e-6)
        close(N[0].numpy(), np.asarray(N_j))
        close(norm.numpy(), [float(norm_j)])
        Nr, Ni, det_embed, *_ = splitc.pf_overlap_kernel(
            V1.real, V1.imag, V2.real, V2.imag, jnp.asarray(plan["j1"]), jnp.asarray(plan["j2"]))
        close(N[0].numpy(), np.asarray(Nr) + 1j * np.asarray(Ni))
        close(norm.numpy() ** 4, [float(det_embed)])


def test_site_tensors_match_jax(captured):
    """The port's grouped site build (both twins) on the JAX Schmidt
    vectors gives the JAX package's dense site tensors and labels, and so
    does the single-site API (``from_schmidt_vectors`` + ``to_dense_tensor``,
    a group of one per kernel)."""
    pairs = [(b, k, md) for b, k, md, _ in captured]
    got = pfaffian.build_site_tensors(pairs, device="cpu")
    layouts = set()
    for (b, k, md), (T, ql, qr, qt) in zip(pairs, got):
        Tj, qlj, qrj, qtj = jpf.MPSTensorData.from_schmidt_vectors(b, k, md).to_dense_tensor()
        close(T.numpy(), np.asarray(Tj))
        np.testing.assert_array_equal(ql, qlj)
        np.testing.assert_array_equal(qr, qrj)
        assert qt == qtj
        single = pfaffian.MPSTensorData.from_schmidt_vectors(b, k, md, device="cpu")
        T1, ql1, qr1, qt1 = single.to_dense_tensor()
        close(T1.numpy(), T.numpy())
        np.testing.assert_array_equal(ql1, ql)
        assert qt1 == qt
        layouts.add(single._plan_fill()[3]["spec"])
    assert layouts == {"rc", "rrc", "crr"}


def test_cpu_calls_launch_no_kernel(captured):
    kernels.pf_fill.launches = kernels.bdg_overlap.launches = 0
    pfaffian.build_site_tensors([c[:3] for c in captured[:2]], device="cpu")
    assert kernels.pf_fill.launches == 0 and kernels.bdg_overlap.launches == 0


def test_wrappers_reject_bad_arguments():
    args, kw = testing.random_pf_fill_case(0, G=1, w=4, m=8, P=50, n_rows=16)
    a = [torch.as_tensor(x) for x in args[:8]] + [tuple(torch.as_tensor(t) for t in args[8])]
    with pytest.raises(ValueError, match="spec"):
        kernels.pf_fill(*a, **{**kw, "spec": "cc"})
    with pytest.raises(ValueError, match="even"):
        kernels.pf_fill(*a, **{**kw, "width": 5})
    with pytest.raises(ValueError, match="Pfaffian requires even"):
        ops.batched_pfaffian(torch.zeros(3, 3))


@pytest.mark.parametrize("nb, nc", [(8, 1), (32, 1), (48, 1), (64, 1), (65, 2), (96, 2),
                                    (97, 3), (128, 3), (129, 5), (256, 8), (257, 0)])
def test_bdg_overlap_shared_memory_limit(nb, nc):
    """The CUDA wrapper's checks accept any half size; the elimination's
    layout (kernels.bdg_overlap_layout) holds U* (nb x nb, complex128: the
    in-place inversion stores no identity half) in one block's registers
    up to nb = 64 (bench config 5's centre bucket), in a cluster of nc
    blocks up to nb = 256, and past that takes the global-memory
    elimination (nc = 0), chosen from the shape before any launch; a
    block's rows follow K2's layout at width nb, its shared memory holds
    two published rows, the pivot row and each step's pivot id."""
    G, k = 2, 24
    args = (torch.zeros(G, 2 * nb, nb, dtype=torch.complex128),
            torch.zeros(G, 2 * nb, nb, dtype=torch.complex128),
            torch.zeros(G, k, dtype=torch.int32), torch.zeros(G, k, dtype=torch.int32),
            torch.zeros(G, dtype=torch.float64))
    assert kernels.bdg_overlap_check(*args) == (G, nb, k, k)
    got, rows, smem = kernels.bdg_overlap_layout(nb)
    assert got == nc
    if nc:
        assert rows * nc >= nb > rows * (nc - 1) and smem == 3 * nb * 16 + 4 * nb
        assert (nc, rows) == kernels.schur_layout(nb, nb, torch.complex128)[:2]


@pytest.mark.parametrize("bad, err", [
    ("rows", ValueError), ("dtype", TypeError), ("thresh", TypeError), ("int64", TypeError),
    ("flat_j", ValueError), ("sites", ValueError)])
def test_bdg_overlap_rejects_bad_arguments(bad, err):
    """The wrapper's argument checks (kernels.bdg_overlap_check, run before
    any launch): frames (G, 2nb, nb) complex128 alike, thresh float64 (G,),
    j1/j2 int32 (G, k) tables."""
    G, nb, k = 2, 8, 4
    V = torch.zeros(G, 2 * nb, nb, dtype=torch.complex128)
    j = torch.zeros(G, k, dtype=torch.int32)
    args = {"V1h": V, "V2h": V.clone(), "j1": j, "j2": j.clone(),
            "thresh": torch.zeros(G, dtype=torch.float64)}
    args.update({
        "rows": {"V2h": torch.zeros(G, 2 * nb + 2, nb, dtype=torch.complex128)},
        "dtype": {"V1h": V.to(torch.complex64)},
        "thresh": {"thresh": torch.zeros(G, dtype=torch.float32)},
        "int64": {"j1": j.long()},
        "flat_j": {"j2": torch.zeros(G * k, dtype=torch.int32)},
        "sites": {"j1": torch.zeros(G + 1, k, dtype=torch.int32)}}[bad])
    with pytest.raises(err):
        kernels.bdg_overlap_check(*args.values())


def test_bdg_overlap_twin_matches_jax_past_64():
    """Past the buckets of bench config 5 (nb = 96, k1 != k2): the twin
    against the JAX ``_assemble_N_complex`` site by site, on seeded frames
    (thresh as the JAX function sets it from the padded half size)."""
    nb, k1, k2 = 96, 20, 12
    V1h, V2h, j1, j2, _ = testing.random_bdg_overlap_case(7, G=2, nb=nb, k1=k1, k2=k2, x=90)
    thresh = np.full(2, max(1e-6**nb, 1e-300))
    N, norm = kernels.bdg_overlap(*(torch.as_tensor(a) for a in (V1h, V2h, j1, j2, thresh)))
    assert N.shape == (2, k1 + k2, k1 + k2)
    for g in range(2):
        V1, V2 = (kernels.nambu_full(torch.as_tensor(v[g])[None])[0].numpy() for v in (V1h, V2h))
        norm_j, N_j = jpf._assemble_N_complex(jnp.asarray(V1.conj().T @ V2), jnp.asarray(j1[g]),
                                              jnp.asarray(j2[g]), L=nb, min_SV=1e-6)
        close(N[g].numpy(), np.asarray(N_j))
        close(norm[g:g + 1].numpy(), [float(norm_j)])
