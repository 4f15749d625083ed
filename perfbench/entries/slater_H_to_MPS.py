"""The Slater path as a user calls it: ``slater.H_to_MPS(H, {"chi_max": chi})``
on a host numpy Hamiltonian (the card by default)."""

import numpy as np


def convert(H, chi: int, device=None):
    from temfpy_torch import slater

    return slater.H_to_MPS(H, {"chi_max": chi}, device=device)


def allowed(q_l, q_r, d: int = 2) -> np.ndarray:
    """(chi_l, d, chi_r) mask of the entries particle number allows."""
    n = np.arange(d)
    return q_l[:, None, None] + n[None, :, None] == q_r[None, None, :]


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
        mask = torch.as_tensor(allowed(q[i], q[i + 1]), device=T.device)
        errors += int(torch.count_nonzero(T * ~mask))
    return {"lam": lam, "q": q, "structure_errors": errors,
            "tensors": {i: mps._tensor(i).cpu().numpy() for i in sites}}
