r"""Truncation policy and leading-Schmidt-state enumeration.

API parity with reference ``temfpy/schmidt_utils.py``: a
:class:`StoppingCondition` that bounds how many Schmidt states are kept, and
:func:`lowest_sums`, which enumerates subsets of a set of positive log-ratios
in increasing-sum order.

Host-side module (numpy), ported from ``temfpy_tpu.schmidt_utils``: the
enumeration has data-dependent control flow, so it stays on the CPU while
the device runs the batched eigh and the site kernels.  Only the vectorised
enumeration is ported; the JAX package's heap form (its ``_USE_BATCHED =
False``) is the reference the tests hold it against.  Its tolerance
defaults come from :mod:`temfpy_torch.config`, which, unlike the JAX
package's, imports no jax.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable
from dataclasses import dataclass
from numbers import Number

import numpy as np

from .config import DEFAULT_SVD_MIN, DEFAULT_DEG_TOL

_DEFAULT_SVD_MIN = DEFAULT_SVD_MIN  # reference schmidt_utils.py:14
_DEFAULT_DEG_TOL = DEFAULT_DEG_TOL  # reference schmidt_utils.py:15


@dataclass(frozen=True)
class StoppingCondition:
    """Stopping/truncation policy for enumerating Schmidt states
    (reference schmidt_utils.py:18-185).

    Fields
    ------
    sectors:
        Which charge sectors to keep: an int->bool predicate, an iterable of
        allowed charges, a single allowed charge, or None (keep all).
    chi_max:
        Maximum number of Schmidt states.
    svd_min:
        Smallest Schmidt value kept, relative to the largest (default 1e-6).
    degeneracy_tol:
        Never cut between Schmidt values whose log-ratio is below this
        (default 1e-12): degenerate multiplets are kept or dropped together.
    """

    sectors: Callable[[int], bool] | Iterable[int] | int | None = None
    chi_max: int | None = None
    svd_min: float | None = None
    degeneracy_tol: float | None = None

    def __post_init__(self):
        if self.svd_min is None:
            object.__setattr__(self, "svd_min", _DEFAULT_SVD_MIN)
        if self.degeneracy_tol is None:
            object.__setattr__(self, "degeneracy_tol", _DEFAULT_DEG_TOL)

        sectors = self.sectors
        if sectors is None:
            is_sector = lambda _q: True  # noqa: E731
        elif isinstance(sectors, Number):
            is_sector = lambda q, _s=sectors: q == _s  # noqa: E731
        elif isinstance(sectors, Iterable):
            allowed = frozenset(sectors)
            is_sector = lambda q, _a=allowed: q in _a  # noqa: E731
        elif isinstance(sectors, Callable):
            is_sector = sectors
        else:
            raise TypeError(f"Unexpected `sectors` parameter {sectors!r}")
        object.__setattr__(self, "is_sector", is_sector)

        if not (self.chi_max is None or self.chi_max > 0):
            raise ValueError(f"`chi_max` must be positive or None, got {self.chi_max!r}")
        if not (0 < self.svd_min < 1):
            raise ValueError(f"`svd_min` must be in (0, 1), got {self.svd_min!r}")
        if not self.degeneracy_tol > 0:
            raise ValueError(
                f"`degeneracy_tol` must be positive, got {self.degeneracy_tol!r}"
            )

        # stop enumerating once the log-range exceeds this (svd_min widened by
        # degeneracy_tol so borderline multiplets are fully generated)
        object.__setattr__(
            self, "max_logval", -np.log(self.svd_min) + self.degeneracy_tol
        )

    def __call__(self, logvals) -> bool:
        """Whether MORE subsets are needed (True) or enough were generated.

        `logvals` are negative log Schmidt values sorted increasingly; we
        over-generate slightly (chi_max + 1 states, values down to
        svd_min/exp(degeneracy_tol)) so that :meth:`truncate` can respect
        degeneracies.  An empty list always requests more states.
        """
        logvals = np.asarray(logvals, dtype=float)
        assert logvals.ndim == 1, "`logvals` must be 1D"
        if logvals.size == 0:
            return True
        if self.chi_max is not None and len(logvals) > self.chi_max:
            return False
        if logvals[-1] - logvals[0] > self.max_logval:
            return False
        return True

    def truncate(self, logvals) -> int:
        """Number of Schmidt states to keep, respecting every constraint
        including near-degeneracy (reference schmidt_utils.py:140-185)."""
        logvals = np.asarray(logvals, dtype=float)
        assert logvals.ndim == 1, "`logvals` must be 1D"
        n = len(logvals)
        if n == 0:
            return 0

        # ok_cut[i]: True if cutting between i and i+1 respects all constraints
        ok_cut = np.ones(n, dtype=bool)
        if self.chi_max is not None:
            ok_cut[self.chi_max :] = False
        ok_cut &= (logvals - logvals[0]) < -np.log(self.svd_min)
        # don't cut inside a near-degenerate multiplet
        deg = np.ones(n, dtype=bool)
        deg[:-1] = (logvals[1:] - logvals[:-1]) > self.degeneracy_tol
        ok_cut &= deg

        idx = np.nonzero(ok_cut)[0]
        if idx.size == 0:
            # pathological: even the first state cannot be legally separated;
            # keep the leading degenerate multiplet whole
            first_gap = np.nonzero(deg)[0]
            return int(first_gap[0]) + 1 if first_gap.size else n
        return int(idx[-1]) + 1


def to_stopping_condition(trunc_par) -> StoppingCondition:
    """Normalises a dict or StoppingCondition into a StoppingCondition
    (reference schmidt_utils.py:188-208)."""
    if isinstance(trunc_par, StoppingCondition):
        return trunc_par
    if isinstance(trunc_par, dict):
        return StoppingCondition(**trunc_par)
    raise TypeError(
        f"Expected a dict or StoppingCondition, got {trunc_par!r}"
    )


def _lowest_sums_batched(a, trunc_par, base_set, base_sum, charge_of=None):
    """Vectorised enumeration replacing the heap of :func:`lowest_sums`.

    The heap collects every sector-passing subset in increasing-sum order
    until ``len > chi_max`` or the log-range of the KEPT sums exceeds
    ``max_logval``; :meth:`StoppingCondition.truncate` then cuts.  Both
    stopping rules depend only on the MULTISET of kept sums, so the same
    result follows from generating all flip-subsets with cost-sum <= a sound
    bound, filtering by sector, capping at the chi_max+1 smallest kept (ties
    kept — truncate never cuts inside a tie group, so surplus tie members
    never change the cut), and sorting.  One rank-by-rank numpy merge
    replaces ~chi heap pops of Python: S' = [S, S + cost_k], pruned by
    bound and cap.

    Sector handling (``charge_of`` maps a subset's flip-charge delta to its
    charge; None = keep everything): the subset charge depends only on the
    net occupation change of the flips, so the merge tracks an int charge
    alongside each partial sum and looks the sector predicate up in a
    precomputed table over the <= 2m+1 reachable charges.  The sound bound
    on generated sums is ``S0_kept + max_logval`` where S0_kept is the
    smallest KEPT sum; it is found by restarting the merge with a doubled
    bound while no kept subset has appeared (the heap's analogue: it pops
    unfiltered candidates until the first sector match).  The cap prunes
    candidates (kept or not) above the chi_max+1-th smallest kept sum —
    children sums only grow, so nothing prunable can produce a needed
    descendant.

    Subsets that tie exactly may appear in a different relative order than
    the heap's insertion order; the enumerated set, the sums, and the
    truncation point are identical.

    Returns (sums, sets) already truncated.
    """
    m = a.size
    order = np.argsort(np.abs(a))
    costs = np.abs(a)[order]
    cap = None if trunc_par.chi_max is None else trunc_par.chi_max + 1

    if charge_of is None:
        kept_of = None
        delta = None
        q0 = 0
    else:
        # flip of rank k toggles occupation at position order[k]:
        # +1 particle if the base leaves it empty, -1 if filled
        delta = np.where(base_set[order], -1, 1).astype(np.int64)
        q0 = 0  # charge delta of the base subset
        lo = int(np.minimum(delta, 0).sum())
        hi = int(np.maximum(delta, 0).sum())
        qs = np.arange(lo, hi + 1)
        kept_lookup = np.asarray(
            [bool(trunc_par.is_sector(charge_of(int(q)))) for q in qs]
        )
        kept_of = lambda N: kept_lookup[N - lo]  # noqa: E731

    total = float(costs.sum())
    bound_ml = trunc_par.max_logval
    B = bound_ml  # iterative-deepening generation bound

    W = max(1, -(-m // 64))  # words per flip bitmask
    while True:
        S = np.zeros(1)
        F = np.zeros((1, W), np.uint64)  # flip bitmasks in rank space
        N = np.full(1, q0, np.int64)  # charge deltas (sector case only)
        s0_kept = None  # smallest kept sum (final once seen: sums of
        # candidates created later only grow within a rank, but a later
        # rank can create a smaller kept sum — hence the running min,
        # exact by the end of the merge)
        eff_bound = B
        for k in range(m):
            c = costs[k]
            if c > eff_bound:
                break  # costs ascend: no later single flip fits either
            S2 = S + c
            keep2 = S2 <= eff_bound
            if not keep2.any():
                continue
            S = np.concatenate([S, S2[keep2]])
            F2 = F[keep2].copy()
            F2[:, k >> 6] |= np.uint64(1 << (k & 63))
            F = np.concatenate([F, F2])
            if kept_of is not None:
                N = np.concatenate([N, N[keep2] + delta[k]])
                kept = kept_of(N)
                if kept.any():
                    s0 = S[kept].min()
                    if s0_kept is None or s0 < s0_kept:
                        s0_kept = s0
                        nb = min(eff_bound, s0_kept + bound_ml)
                        if nb < eff_bound:
                            eff_bound = nb
                            keep = S <= eff_bound
                            S, F, N = S[keep], F[keep], N[keep]
                            kept = kept_of(N)
                n_kept = int(kept.sum())
            else:
                kept = None
                n_kept = len(S)
            if cap is not None and n_kept > cap:
                # prune everything above the cap-th smallest KEPT sum
                # (+ exact ties of the cap-th); children sums only grow,
                # so nothing pruned can produce a needed descendant
                pool = S if kept is None else S[kept]
                kth = np.partition(pool, cap - 1)[cap - 1]
                keep = S <= kth
                S = S[keep]
                F = F[keep]
                if kept_of is not None:
                    N = N[keep]
        if kept_of is None:
            break
        kept = kept_of(N)
        n_kept = int(kept.sum())
        # the pass covered everything the stopping rules can need if the
        # kept set is complete up to min(kth kept, s0_kept + max_logval):
        complete = B >= total or (
            s0_kept is not None
            and (
                s0_kept + bound_ml <= B
                or (cap is not None and n_kept >= cap)
            )
        )
        if complete:
            S, F = S[kept], F[kept]
            break
        # not enough sector matches within the bound: widen and restart
        # (the heap's analogue pops unfiltered candidates until the
        # stopping rules fire on the kept list)
        B = min(max(2 * B, s0_kept + bound_ml if s0_kept is not None else B),
                total)

    # surplus tail entries beyond chi_max+1 cannot move the cut (ok_cut is
    # False past the chi_max / svd_min bounds in any case), so no final cap
    sel = np.argsort(S, kind="stable")
    S = S[sel]
    F = F[sel]
    # bitmasks -> bool flips in rank space -> original positions -> XOR base
    shifts = np.arange(64, dtype=np.uint64)
    bits = (F[:, :, None] >> shifts[None, None, :]) & np.uint64(1)
    flips = np.zeros((len(F), m), bool)
    flips[:, order] = bits.reshape(len(F), W * 64)[:, :m].astype(bool)
    sets = base_set[None, :] ^ flips
    sums = base_sum + S
    cut = trunc_par.truncate(sums)
    return sums[:cut], sets[:cut]


def lowest_sums(
    a,
    trunc_par: StoppingCondition,
    *,
    filled_left: int | None = None,
    filled_right: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    r"""Generates the subsets of `a` with the smallest sums, in order.

    Used to enumerate the leading Schmidt states: with
    ``a = log(lambda_R/lambda_L)`` per entangled orbital, subsets with the
    lowest sums are the Schmidt states with the largest Schmidt values.

    Gives the result of the reference's lazy best-first heap enumeration
    (reference schmidt_utils.py:211-324) through the vectorised merge of
    :func:`_lowest_sums_batched`: from the minimum-sum subset (all negative
    entries), flips over the entries sorted by absolute value, filtered by
    the charge-sector predicate of `trunc_par` and truncated by
    :meth:`StoppingCondition.truncate`.

    Parameters
    ----------
    a:
        1D array whose subsets are enumerated.
    trunc_par:
        When to stop generating, and how to truncate.
    filled_left, filled_right:
        Offsets converting a subset's cardinality into a left/right particle
        number for the sector filter.  ``filled_right`` is ignored if
        ``filled_left`` is given.

    Returns
    -------
    sums:
        The smallest subset sums, sorted increasingly, truncated.
    sets:
        Boolean (n, a.size) array: the subsets realising those sums.
    """
    a = np.asarray(a, dtype=float)
    assert a.ndim == 1, "`a` must be 1D"
    m = a.size

    base_set = a < 0  # subset with the smallest possible sum
    base_sum = float(a[base_set].sum())
    n_base = int(base_set.sum())

    def charge_of(d: int) -> int:
        """Charge of a subset whose occupation differs from the base's by d
        (the sector filter rides along the merge as this delta)."""
        n_occ = n_base + d
        if filled_left is not None:
            return filled_left + n_occ
        if filled_right is not None:
            return filled_right + (m - n_occ)
        return n_occ

    if m == 0:
        n_keep = int(bool(trunc_par.is_sector(charge_of(0))))
        return np.zeros(n_keep), np.zeros((n_keep, 0), bool)
    return _lowest_sums_batched(a, trunc_par, base_set, base_sum,
                                None if trunc_par.sectors is None else charge_of)
