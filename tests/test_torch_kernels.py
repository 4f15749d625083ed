"""The plain twins of the two CUDA kernels against the JAX kernels they
replace, on real plans and descriptors captured from JAX conversions at
L=24 and L=32 (both sweep modes, all three fill specs), the port's host
fill planning against the JAX planner on the same site data, plus the CPU
dispatch rules.  L=32 is the smallest size at which the planner buckets
the always block (``_plan_site``: widths round up only from L=32), so its
captured descriptors include the one-hot identity padding; L=24 has none.

Tolerance: 1e-12 relative to the largest entry of the compared output
(see test_torch_linalg.py); for the Schur step the compared quantity is
det(A) * S, the product that enters the tensors, because S alone carries
the 1/det(A) amplification of a near-singular always block, which no
implementation removes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from temfpy_tpu import slater as jslater
from temfpy_torch.ops import _build, kernels

RTOL = 1e-12


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, np.abs(a - b).max() / scale


def _cylinder(W, L):
    H = np.zeros((L, L))
    idx = lambda x, y: x * W + y % W  # noqa: E731
    for x in range(L // W):
        for y in range(W):
            if x + 1 < L // W:
                H[idx(x, y), idx(x + 1, y)] = H[idx(x + 1, y), idx(x, y)] = (
                    -1.0 if x % 2 == 0 else -1.3)
            H[idx(x, y), idx(x, y + 1)] = H[idx(x, y + 1), idx(x, y)] = -1.0
    return H - 0.05 * np.eye(L)


@pytest.fixture(scope="module", params=[24, 32])
def captured(request):
    """(site plan, det_always, sometimes, fill plans) of JAX sites at L:
    right-mode and left-mode sweep sites (physical leg, specs "crr" and
    "rrc") and a same-cut overlap without a physical leg (spec "rc")."""
    import os

    old = os.environ.get("TEMFPY_TPU_DET_UPDATES")
    os.environ["TEMFPY_TPU_DET_UPDATES"] = "0"  # direct fill plans only
    try:
        C, _ = jslater.correlation_matrix(_cylinder(4, request.param))
        C = np.asarray(C)
        tp = {"chi_max": 48}
        out = []
        for which, mode, cuts in (("R", "right", [16, 17, 18, 19]),
                                  ("L", "left", [16, 15, 14, 13])):
            svs = jslater._schmidt_vectors_batched(C, cuts, which, tp, 1e-8, 8)
            pairs = [(svs[j + 1], svs[j], mode) for j in range(len(svs) - 1)]
            pairs.append((svs[1], svs[1], mode))
            for b, k, md in pairs:
                plan = jslater._plan_site(b, k, md)
                det, som = jslater._site_overlap_kernel(
                    plan["frame_bra"], plan["frame_ket"],
                    *(jnp.asarray(d) for d in plan["desc"]), kb=plan["kb"], mode=md)
                data = jslater.MPSTensorData(det_always=det, sometimes_matrix=som,
                                             **plan["fields"])
                shape, _ql, _qr, fplans = data._plan_fill()
                out.append((plan, det, som, shape, fplans))
    finally:
        if old is None:
            os.environ.pop("TEMFPY_TPU_DET_UPDATES")
        else:
            os.environ["TEMFPY_TPU_DET_UPDATES"] = old
    specs = {p["spec"] for *_, fps in out for p in fps}
    assert specs == {"rc", "rrc", "crr"}
    return out


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def test_site_overlap_twin_matches_jax(captured):
    for plan, det, som, _shape, _fplans in captured:
        d = plan["desc"]
        args = [_t(plan["frame_bra"])[None], _t(plan["frame_ket"])[None]]
        args += [_t(d[i])[None] for i in range(8)]
        det_t, som_t = kernels.site_overlap_schur(*args, kb=plan["kb"],
                                                  mode=plan["fields"]["mode"])
        det_j = np.asarray(det)
        close(det_t[0].numpy(), det_j)
        close(det_t[0].numpy() * som_t[0].numpy(), det_j * np.asarray(som))


def test_det_fill_twin_matches_jax(captured):
    n_plans = 0
    for _plan, det, som, shape, fplans in captured:
        shape_b = jslater._bucket_shape(shape)
        for p in fplans:
            ref = jslater._det_fill_packed_kernel(
                som, det, jnp.asarray(p["occ_b"]), jnp.asarray(p["occ_k"]),
                jnp.asarray(p["pr"]), jnp.asarray(p["pc"]),
                *(jnp.asarray(t) for t in p["tabs"]), shape=shape_b, spec=p["spec"])
            got = kernels.det_fill(
                _t(som)[None], _t(det)[None], _t(p["occ_b"])[None], _t(p["occ_k"])[None],
                _t(p["pr"])[None], _t(p["pc"])[None], tuple(_t(t)[None] for t in p["tabs"]),
                spec=p["spec"], shape=shape_b)
            close(got[0].numpy(), np.asarray(ref))
            # a stacked group gives each site its own result
            got2 = kernels.det_fill(
                torch.stack([_t(som), 2 * _t(som)]), torch.stack([_t(det), _t(det)]),
                *(torch.stack([_t(p[k])] * 2) for k in ("occ_b", "occ_k", "pr", "pc")),
                tuple(torch.stack([_t(t)] * 2) for t in p["tabs"]),
                spec=p["spec"], shape=shape_b)
            close(got2[0].numpy(), np.asarray(ref))
            ref2 = jslater._det_fill_packed_kernel(
                2 * som, det, jnp.asarray(p["occ_b"]), jnp.asarray(p["occ_k"]),
                jnp.asarray(p["pr"]), jnp.asarray(p["pc"]),
                *(jnp.asarray(t) for t in p["tabs"]), shape=shape_b, spec=p["spec"])
            close(got2[1].numpy(), np.asarray(ref2))
            n_plans += 1
    assert n_plans >= 6


def _port_data(plan, det, som):
    from temfpy_torch import slater

    return slater.MPSTensorData(det_always=_t(det), sometimes_matrix=_t(som),
                                **plan["fields"])


def test_fill_plans_match_jax_planner(captured):
    """The port's host planning gives the JAX planner's packed plans, bit
    for bit, on the same site data (integer tables: compared exactly)."""
    for plan, det, som, shape, fplans in captured:
        shape_p, _ql, _qr, plans = _port_data(plan, det, som)._plan_fill()
        assert shape_p == shape and len(plans) == len(fplans)
        for p, q in zip(plans, fplans):
            assert p["spec"] == q["spec"]
            for key in ("occ_b", "occ_k", "pr", "pc"):
                np.testing.assert_array_equal(p[key], q[key])
            for t, u in zip(p["tabs"], q["tabs"]):
                np.testing.assert_array_equal(t, u)


def test_direct_arrays_unpack_the_packed_plan(captured):
    """The port's packed plan, expanded to one row per pair (each pair's
    occupation rows, and its scatter coordinates through ``spec``, pad
    pairs included), equals the JAX package's unpacked ``_direct_arrays``
    on the same pairs: what the kernel gathers and where it writes."""
    n = 0
    for plan, det, som, shape, _fplans in captured:
        data = _port_data(plan, det, som)
        jdata = jslater.MPSTensorData(det_always=det, sometimes_matrix=som, **plan["fields"])
        _shape, _ql, _qr, plans = data._plan_fill()
        m = data.sets_bra.shape[1]
        cnt_b, cnt_k = data.sets_bra.sum(axis=1), data.sets_ket.sum(axis=1)
        buckets: dict = {}
        for c in np.unique(cnt_b):
            rows, cols = np.nonzero(cnt_b == c)[0], np.nonzero(cnt_k == c)[0]
            if rows.size and cols.size:
                w_b = 4 if c <= 4 else -(-int(c) // 8) * 8
                r_l, c_l = buckets.setdefault(w_b, ([], []))
                r_l.append(np.repeat(rows, cols.size))
                c_l.append(np.tile(cols, rows.size))
        assert sorted(buckets) == [p["occ_b"].shape[1] for p in plans]
        for w_b, p in zip(sorted(buckets), plans):
            rows, cols = np.concatenate(buckets[w_b][0]), np.concatenate(buckets[w_b][1])
            idx_b, idx_k, scat = jdata._direct_arrays(rows, cols, w_b, m, shape)
            np.testing.assert_array_equal(p["occ_b"][p["pr"]], idx_b)
            np.testing.assert_array_equal(p["occ_k"][p["pc"]], idx_k)
            ids = {"r": p["pr"], "c": p["pc"]}
            for ax, s in enumerate(p["spec"]):
                np.testing.assert_array_equal(p["tabs"][ax][ids[s]], scat[ax])
            n += 1
    assert n >= 6


def test_cpu_calls_launch_no_kernel(captured):
    kernels.det_fill.launches = 0
    kernels.site_overlap_schur.launches = 0
    plan, det, som, shape, fplans = captured[0]
    d = plan["desc"]
    kernels.site_overlap_schur(_t(plan["frame_bra"])[None], _t(plan["frame_ket"])[None],
                               *(_t(d[i])[None] for i in range(8)), kb=plan["kb"],
                               mode=plan["fields"]["mode"])
    p = fplans[0]
    kernels.det_fill(_t(som)[None], _t(det)[None], _t(p["occ_b"])[None],
                     _t(p["occ_k"])[None], _t(p["pr"])[None], _t(p["pc"])[None],
                     tuple(_t(t)[None] for t in p["tabs"]), spec=p["spec"],
                     shape=jslater._bucket_shape(shape))
    assert kernels.det_fill.launches == 0
    assert kernels.site_overlap_schur.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_wrappers_reject_bad_arguments():
    M = torch.zeros((1, 4, 4), dtype=torch.float64)
    idx = torch.zeros((1, 2, 4), dtype=torch.int32)
    pr = torch.zeros((1, 8), dtype=torch.int32)
    tabs = (torch.zeros((1, 2), dtype=torch.int32),) * 3
    with pytest.raises(ValueError, match="spec"):
        kernels.det_fill(M, M[:, 0, 0], idx, idx, pr, pr, tabs, spec="xx", shape=(4, 4))
    with pytest.raises(ValueError, match="mode"):
        kernels.site_overlap_schur(M, M, *(idx[:, 0],) * 8, kb=0, mode="up")
