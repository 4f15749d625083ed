"""The BdG path as bench config 5 runs it: ``pfaffian.correlation_matrix(H,
basis="C->M")`` and ``pfaffian.C_to_MPS(C, {"chi_max": chi}, basis="M")``,
both inside the timed state, on a host numpy Hamiltonian."""

import numpy as np


def convert(H, chi: int, device=None):
    from temfpy_torch import pfaffian

    C = pfaffian.correlation_matrix(H, basis="C->M", device=device)
    return pfaffian.C_to_MPS(C, {"chi_max": chi}, basis="M", device=device)


def allowed(q_l, q_r, qtotal: int, d: int = 2) -> np.ndarray:
    """(chi_l, d, chi_r) mask of the entries fermion parity allows."""
    n = np.arange(d)
    return (q_l[:, None, None] + n[None, :, None] + qtotal) % 2 == q_r[None, None, :] % 2


def extract(mps, sites) -> dict:
    """The state's bond data, the tensors of ``sites`` (host numpy) and the
    count of structure errors over every site."""
    import torch

    lam = [np.asarray(s, float) for s in mps._S]
    q = [np.asarray(x) for x in mps.q_bond]
    errors = 0
    for i in range(len(mps._B)):
        T = mps._tensor(i)
        if tuple(T.shape) != (len(lam[i]), 2, len(lam[i + 1])):
            errors += 1
            continue
        mask = torch.as_tensor(allowed(q[i], q[i + 1], int(mps.qtotal[i])), device=T.device)
        errors += int(torch.count_nonzero(T * ~mask))
    return {"lam": lam, "q": q, "structure_errors": errors,
            "tensors": {i: mps._tensor(i).cpu().numpy() for i in sites}}
