"""Device meshes: one process over a grid of torch devices (counterpart of
:mod:`temfpy_tpu.parallel.mesh`).

The JAX package drives every device from one process through one
``jax.sharding.Mesh`` and lets GSPMD insert the collectives.  Here a
:class:`Mesh` is a 2-D grid of ``torch.device`` entries with the axes
("cuts", "pairs"); an entry may repeat, so one card can hold several
logical shards, and nothing is copied between shards that share a device.
Under :class:`use_mesh` the port's conversions split their batches:

- the cut batch of every all-cuts eigendecomposition over "cuts"
  (:func:`temfpy_torch.ops.linalg.eigh_blocks`, :func:`sharded_schmidt_spectra`);
- the site batches of the overlap kernels (K2, K4) and the pair batches of
  the fills and index-row kernels (K1, K3, K5, K6b, K7') over "pairs"
  (:func:`map_shards`, :func:`fill_into`);
- where a Slater fill's bucketed bond reaches ``config.CHI_SHARD_MIN``, the
  bond rows of its buffer over "cuts" (:func:`chi_shard_rows`): each shard
  fills only the pairs whose rows it holds, and the site tensor stays a
  :class:`BondSharded`;
- canonical sweeps and the Gutzwiller projection keep every stored tensor
  bond-sharded over all shards (:func:`bond_shard_put`) and gather one site
  at a time (:func:`gather_replicated`);
- over several cards, a site tensor that is not split is held whole by
  every card (:func:`replicate_site`), so the cards hold equal bytes.

Every shard launches the hand-written kernels itself (each launch counts in
its wrapper's ``launches``); the results come back to the device of the
call's input, in order.  Every route is a no-op without an active mesh.
"""

from __future__ import annotations

import math

import numpy as np
import torch

AXES = ("cuts", "pairs")


def _checked_device(d) -> torch.device:
    """``d`` as a torch device that torch can see: the CPU or a visible
    CUDA card (``cuda`` without an index is the current card)."""
    d = torch.device(d)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"a mesh holds CPU or CUDA devices, got {d}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {d}: torch sees no CUDA device")
    index = torch.cuda.current_device() if d.index is None else d.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"mesh device {d}: torch sees {torch.cuda.device_count()} "
                           "CUDA device(s)")
    return torch.device("cuda", index)


class Mesh:
    """A 2-D grid of torch devices with named axes (``jax.sharding.Mesh``
    for one process).  ``devices`` is a nested sequence (or object array)
    of devices or device names; a device may appear more than once."""

    def __init__(self, devices, axis_names=AXES):
        rows = [list(r) for r in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 2:
            raise ValueError(f"a mesh has two axes, got {self.axis_names}")
        grid = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, r in enumerate(rows):
            for j, d in enumerate(r):
                grid[i, j] = _checked_device(d)
        self.devices = grid

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The device results come back to."""
        return self.devices.flat[0]

    @property
    def flat(self) -> list:
        """The devices of every shard, row by row (the shard order)."""
        return list(self.devices.flat)

    @property
    def distinct(self) -> list:
        """The distinct devices, in shard order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def along(self, axis: str, at: int = 0) -> list:
        """The devices along ``axis``, at index ``at`` of the other axis."""
        ax = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, ax, 0)[:, at])

    def __repr__(self):
        grid = [[str(d) for d in r] for r in self.devices]
        return f"Mesh({grid}, axes={self.axis_names})"


def make_mesh(n_devices: int | None = None, axes=AXES, devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA card torch sees), factored into a near-square (a, n / a) grid.
    ``devices`` may repeat a device: ``["cpu"] * 8`` is an 8-shard CPU
    mesh, ``["cuda:0"] * 4`` four logical shards of one card.  Raises where
    no device is given and torch sees no card, or a named device is not
    visible."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * 8 for logical CPU shards)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    n = len(devices) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"make_mesh: {n} devices asked for, {len(devices)} given")
    devices = devices[:n]
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return Mesh([devices[i * (n // a):(i + 1) * (n // a)] for i in range(a)], axes)


# --------------------------------------------------------------------------
# mesh context
# --------------------------------------------------------------------------

_ACTIVE_MESH: Mesh | None = None


def active_mesh() -> Mesh | None:
    """The mesh installed by :class:`use_mesh` (None: one device)."""
    return _ACTIVE_MESH


class use_mesh:
    """Context manager: run conversions with their batches split over
    ``mesh`` (the module docstring lists the routes).

    >>> with use_mesh(make_mesh()):
    ...     mps = slater.C_to_MPS(C, {"chi_max": chi})
    """

    def __init__(self, mesh: Mesh):
        if not isinstance(mesh, Mesh):
            raise TypeError(f"use_mesh needs a Mesh, got {type(mesh).__name__}")
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


_CURRENT_SHARD: tuple | None = None


def current_shard() -> tuple | None:
    """(axis, index) of the shard whose work is being launched, or None
    outside a split: lets a caller count a kernel's launches per shard
    (``("chi", (k, j))`` in a chi-sharded fill, k along "cuts")."""
    return _CURRENT_SHARD


# --------------------------------------------------------------------------
# splitting batches
# --------------------------------------------------------------------------


def _slices(n: int, parts: int) -> list:
    """Contiguous slices of range(n) into ``parts`` pieces whose sizes
    differ by at most one; empty pieces are dropped."""
    bounds = [n * k // parts for k in range(parts + 1)]
    return [slice(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def _to(x, device, cache: dict):
    """``x`` (a tensor, or a tuple/list of them; anything else as it is) on
    ``device``, copied at most once per device through ``cache``."""
    if isinstance(x, torch.Tensor):
        if x.device == device:
            return x
        key = (id(x), device)
        if key not in cache:
            cache[key] = (x, x.to(device))  # keeps x alive: its id stays unique
        return cache[key][1]
    if isinstance(x, (tuple, list)):
        return type(x)(_to(t, device, cache) for t in x)
    return x


def _narrow(x, dim: int, sl: slice):
    return x.narrow(dim, sl.start, sl.stop - sl.start).contiguous()


def shard_batch(x, axis: str = "pairs"):
    """The per-shard slices of a batch tensor's leading axis over the active
    mesh's ``axis``, each on its shard's device (``[x]`` without a mesh)."""
    mesh = _ACTIVE_MESH
    x = torch.as_tensor(x)
    if mesh is None:
        return [x]
    devs = mesh.along(axis)
    return [_narrow(x, 0, sl).to(d) for d, sl in zip(devs, _slices(x.shape[0], len(devs)))]


def replicate(x) -> dict:
    """``x`` on every distinct device of the active mesh, keyed by device
    (one entry, ``x`` itself, without a mesh or where every shard shares
    its device)."""
    mesh = _ACTIVE_MESH
    x = torch.as_tensor(x)
    if mesh is None:
        return {x.device: x}
    return {d: x.to(d) for d in mesh.distinct}


def _combine(parts, dim: int, device):
    if isinstance(parts[0], tuple):
        return tuple(_combine([p[i] for p in parts], dim, device) for i in range(len(parts[0])))
    parts = [p.to(device) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def map_shards(fn, split, rest=(), *, axis: str = "pairs", dim: int = 0, at: int = 0,
               device=None, mesh: Mesh | None = None):
    """``fn(*split, *rest)`` with the batch split over ``axis`` of ``mesh``
    (default: the active one) at index ``at`` of the other axis: shard s gets dimension
    ``dim`` of every tensor in ``split`` narrowed to its contiguous slice,
    and every tensor argument on its device.  The per-shard results (a
    tensor or a tuple of them) come back to ``device`` (default: the device
    of ``split[0]``), concatenated along ``dim``.  A batch smaller than the
    axis leaves the last shards idle.  Without a mesh, or for an empty
    batch, one call on the inputs as they are."""
    global _CURRENT_SHARD
    mesh = _ACTIVE_MESH if mesh is None else mesh
    device = split[0].device if device is None else torch.device(device)
    n = split[0].shape[dim]
    devs = [] if mesh is None else mesh.along(axis, at)
    if not devs or not n:
        return _combine([fn(*split, *rest)], dim, device)
    cache, parts = {}, []
    for s, (d, sl) in enumerate(zip(devs, _slices(n, len(devs)))):
        args = [_to(_narrow(x, dim, sl), d, cache) for x in split] + [_to(x, d, cache)
                                                                      for x in rest]
        prev, _CURRENT_SHARD = _CURRENT_SHARD, (axis, s)
        try:
            parts.append(fn(*args))
        finally:
            _CURRENT_SHARD = prev
    return _combine(parts, dim, device)


def fill_into(kernel, args, pair_pos, out, slot, *, at: int = 0, chi: bool = False, **kw):
    """``kernel(*args, out=out, slot=slot, **kw)``, a fill that writes
    disjoint entries of the slots ``slot`` of the buffer ``out`` in place,
    with the pair axis (dimension 1) of the arguments at ``pair_pos`` split
    over the active mesh's "pairs" axis (at index ``at`` of "cuts"; ``chi``
    marks the shards of a chi-sharded fill).  A shard on ``out``'s device
    writes into it; a shard elsewhere fills a zeroed buffer of its own,
    which is added into ``out`` (each entry is written by one pair, so the
    sum is the fill)."""
    global _CURRENT_SHARD
    mesh = _ACTIVE_MESH
    n = args[pair_pos[0]].shape[1]
    devs = [] if mesh is None else mesh.along("pairs", at)
    if not devs or (len(devs) == 1 and not chi):
        return kernel(*args, out=out, slot=slot, **kw)
    cache = {}
    for s, (d, sl) in enumerate(zip(devs, _slices(n, len(devs)))):
        a = [_to(_narrow(x, 1, sl) if i in pair_pos else x, d, cache)
             for i, x in enumerate(args)]
        prev, _CURRENT_SHARD = _CURRENT_SHARD, ("chi", (at, s)) if chi else ("pairs", s)
        try:
            if d == out.device:
                kernel(*a, out=out, slot=slot, **kw)
            else:
                part = kernel(*a, **kw)
                idx = torch.as_tensor(list(slot), device=out.device)
                out[:, : part.shape[1]].index_add_(0, idx, part.to(out.device))
        finally:
            _CURRENT_SHARD = prev
    return out


# --------------------------------------------------------------------------
# bond-sharded residency
# --------------------------------------------------------------------------


class BondSharded:
    """A site tensor whose leading (bond) axis is split into row blocks over
    the shards of a mesh: torch has no single-process sharded tensor.

    ``shards`` holds one (first row, end row, tensor) per mesh shard, in the
    mesh's shard order; shards that share a device and rows share one
    tensor.  A tensor every shard holds whole (one row block) is
    replicated, as the JAX package holds an unsplit array under a mesh.
    Read it through :func:`gather_replicated` (the MPS engine's one
    accessor does)."""

    def __init__(self, shards, shape, dtype):
        self.shards = list(shards)
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0][2].device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def split(self) -> bool:
        """Whether the bond axis is split (not every shard holds it whole)."""
        return any(hi - lo < self.shape[0] for lo, hi, _t in self.shards)

    def shard_bytes(self) -> list:
        """Resident bytes of each shard, in shard order."""
        return [t.numel() * t.element_size() for _lo, _hi, t in self.shards]

    def device_bytes(self) -> dict:
        """Resident bytes on each distinct device (shared tensors once)."""
        out, seen = {}, set()
        for _lo, _hi, t in self.shards:
            if id(t) not in seen:
                seen.add(id(t))
                out[t.device] = out.get(t.device, 0) + t.numel() * t.element_size()
        return out

    def blocks(self) -> list:
        """One tensor per distinct row block, in row order; raises unless
        the blocks tile the bond axis and agree in trailing shape and
        dtype."""
        by_rows = {}
        for lo, hi, t in self.shards:
            if (not isinstance(t, torch.Tensor) or t.dtype != self.dtype
                    or tuple(t.shape) != (hi - lo,) + tuple(self.shape[1:])):
                raise ValueError(f"malformed bond-sharded tensor: shard rows {lo}:{hi} hold "
                                 f"{getattr(t, 'shape', t)!r}, expected "
                                 f"{(hi - lo,) + tuple(self.shape[1:])} {self.dtype}")
            by_rows.setdefault((lo, hi), t)
        end = 0
        for lo, hi in sorted(by_rows):
            if lo != end:
                raise ValueError(f"malformed bond-sharded tensor: rows {end}:{lo} missing "
                                 "or held twice")
            end = hi
        if end != self.shape[0]:
            raise ValueError(f"malformed bond-sharded tensor: rows cover {end} of "
                             f"{self.shape[0]}")
        return [by_rows[k] for k in sorted(by_rows)]

    def gather(self, device=None) -> torch.Tensor:
        device = self.device if device is None else torch.device(device)
        blocks = self.blocks()
        return blocks[0].to(device) if len(blocks) == 1 else torch.cat([b.to(device)
                                                                        for b in blocks])

    def __repr__(self):
        return (f"BondSharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"rows={[(lo, hi) for lo, hi, _ in self.shards]})")


def is_bond_sharded(x) -> bool:
    return isinstance(x, BondSharded)


def _split_rows(x: torch.Tensor, devices, groups: int) -> BondSharded:
    """``x`` split into ``groups`` even row blocks, block b held by the
    shards b * per .. (b + 1) * per - 1 of ``devices`` (per = len / groups):
    one copy per distinct (block, device); with one group, ``x`` itself on
    its own device."""
    per = len(devices) // groups
    rows = x.shape[0]
    shards, made = [], {}
    for s, d in enumerate(devices):
        b = s // per
        lo, hi = rows * b // groups, rows * (b + 1) // groups
        if (b, d) not in made:
            made[(b, d)] = x[lo:hi].to(d, copy=groups > 1)
        shards.append((lo, hi, made[(b, d)]))
    return BondSharded(shards, x.shape, x.dtype)


def gather_replicated(x):
    """The read side of :func:`bond_shard_put`: one site tensor as a plain
    tensor on its first shard's device (a plain tensor or a numpy array is
    returned as it is).  A canonical sweep gathers one site at a time, so
    the rest of the chain stays sharded.  Raises on a malformed
    :class:`BondSharded` (the JAX package's fall-through returned a still
    sharded array: here a read always gets a plain tensor)."""
    if isinstance(x, BondSharded):
        return x.gather()
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return x
    raise TypeError(f"gather_replicated reads tensors, got {type(x).__name__}")


def replicate_site(x, mesh: Mesh | None = None):
    """A site tensor held whole by every distinct device of ``mesh``
    (default: the active one), as the JAX package holds an array that a
    mesh run does not split: a replicated :class:`BondSharded`, so that
    every card holds the same bytes of it.  ``x`` itself without a mesh,
    where the shards share one device, or for a numpy array or a scalar."""
    mesh = mesh if mesh is not None else _ACTIVE_MESH
    if (mesh is None or len(mesh.distinct) <= 1 or not isinstance(x, torch.Tensor)
            or len(x.shape) == 0):
        return x
    return _split_rows(x, mesh.flat, 1)


def bond_shard_put(x, mesh: Mesh | None = None, min_dim: int = 64):
    """A site tensor with its leading (bond) axis split over ALL shards of
    ``mesh`` (default: the active one), so each shard holds 1/g of it: the
    bond splits g = gcd(bond, shards) ways and each block is held by
    shards / g shards.  Where g == 1 or the bond is below ``min_dim`` rows
    (small edge tensors), the tensor is not split but replicated
    (:func:`replicate_site`).  A no-op without a mesh and for a numpy
    array."""
    mesh = mesh if mesh is not None else _ACTIVE_MESH
    if mesh is None or not isinstance(x, (torch.Tensor, BondSharded)):
        return x
    n = mesh.size
    g = math.gcd(int(x.shape[0]), n) if len(x.shape) and x.shape[0] >= min_dim else 1
    if g <= 1 and len(mesh.distinct) <= 1:
        return x
    if isinstance(x, BondSharded):
        x = x.gather()
    return _split_rows(x, mesh.flat, g) if g > 1 else replicate_site(x, mesh)


def chi_shard_rows(bond_b: int) -> int:
    """The number of "cuts" shards a Slater fill's bucketed bond ``bond_b``
    splits over (JAX ``slater._chi_shard_mesh``): the axis size where a
    mesh is active, the axis has more than one shard and divides the
    bucket, and the bond reaches ``config.CHI_SHARD_MIN``; else 0."""
    from .. import config

    mesh = _ACTIVE_MESH
    if mesh is None:
        return 0
    n = mesh.shape.get("cuts", 1)
    if n > 1 and bond_b % n == 0 and bond_b >= config.CHI_SHARD_MIN:
        return n
    return 0


def chi_sharded_site(blocks, B: int, shape) -> BondSharded | torch.Tensor:
    """A site tensor of true ``shape`` from the "cuts" row blocks
    ``blocks`` of its bucketed fill (block k: bucketed rows k * B .. (k+1) *
    B - 1 on "cuts" shard k, then a trash row), split evenly over the
    "cuts" shards and held by every "pairs" shard of its row; where the
    true bond does not divide over the shards (small edge bonds), one plain
    tensor on the first shard's device."""
    mesh = _ACTIVE_MESH
    n = len(blocks)
    rows = shape[0]
    trail = tuple(slice(0, d) for d in shape[1:])
    home = mesh.along("cuts")

    def rows_of(lo, hi, device):
        """Rows lo .. hi - 1 of the site, copied from the blocks that hold
        them onto ``device`` (a new tensor: the site keeps no view of the
        fill buffer)."""
        parts = []
        for k in range(lo // B, -(-hi // B)):
            a, b = max(lo, k * B) - k * B, min(hi, (k + 1) * B) - k * B
            parts.append(blocks[k][(slice(a, b),) + trail].to(device))
        return torch.cat(parts)

    if rows % n:
        return rows_of(0, rows, home[0])
    shards, made = [], {}
    for s, d in enumerate(mesh.flat):
        k = s // mesh.shape["pairs"]
        lo, hi = rows * k // n, rows * (k + 1) // n
        if (k, d) not in made:
            made[(k, d)] = rows_of(lo, hi, d)
        shards.append((lo, hi, made[(k, d)]))
    return BondSharded(shards, shape, blocks[0].dtype)


def residency(tensors, mesh: Mesh):
    """(number of tensors whose bond axis is split, bytes resident on each
    of ``mesh``'s shards) of a list of site tensors: a replicated tensor
    counts whole on every shard, a plain tensor whole on the shards of its
    device."""
    per = [0] * mesh.size
    n_sharded = 0
    for t in tensors:
        if isinstance(t, BondSharded):
            n_sharded += t.split
            for s, b in enumerate(t.shard_bytes()):
                per[s] += b
        else:
            for s, d in enumerate(mesh.flat):
                if d == t.device:
                    per[s] += t.numel() * t.element_size()
    return n_sharded, per


# --------------------------------------------------------------------------
# single-device step and the sharded kernels
# --------------------------------------------------------------------------


def flagship_forward(C: torch.Tensor):
    """One device step of the Slater frontend: the eigendecompositions of
    the leading blocks of C for ALL cuts (one padded batch) reduced to
    per-cut entanglement data, on C's device.  Padding eigenvalues (2.0)
    and modes within 1e-12 of 0 or 1 are masked.  Returns (eigenvalues
    (L+1, L), entropies (L+1,))."""
    from ..ops.linalg import _eigh_blocks_impl

    L = C.shape[-1]
    sizes = torch.arange(L + 1, device=C.device)
    e, _v = _eigh_blocks_impl(C, sizes, "L")
    lam = e.clamp(1e-300, 1.0)
    valid = e < 1.5
    ent = -(lam * torch.log(lam) + (1 - lam) * torch.log1p(-lam))
    ent = torch.where(valid & (e > 1e-12) & (e < 1 - 1e-12), ent, torch.zeros_like(ent))
    return e, ent.sum(dim=-1)


def sharded_schmidt_spectra(C, sizes, side: str, mesh: Mesh, axis: str = "cuts",
                            chunk: int | None = None, device=None):
    """Batched block eigendecompositions (:func:`temfpy_torch.ops.linalg.
    eigh_blocks`' padded layout) with the cut batch split over ``mesh``'s
    ``axis`` (:func:`map_shards`: shards differ in size by at most one
    cut): C is copied to each shard's device, and (e, v) come back to
    ``device`` (default: the mesh's first device) in order."""
    from ..ops.linalg import _eigh_blocks_chunked

    sizes = torch.as_tensor(np.asarray(sizes, np.int64))
    device = mesh.first if device is None else torch.device(device)
    return map_shards(lambda s, C_d: _eigh_blocks_chunked(C_d, s.to(C_d.device), side, chunk),
                      (sizes,), (torch.as_tensor(C),), axis=axis, device=device, mesh=mesh)


def sharded_det_pairs(M, row_idx, col_idx, mesh: Mesh, device=None):
    """Paired index-row determinants ``det(M_aug[row_idx[p]][:,
    col_idx[p]])`` (``M_aug = block_diag(M, I_k)``) with the pair axis split
    over ``mesh``'s "pairs" axis: :func:`temfpy_torch.ops.linalg.
    batched_det_pairs` under ``mesh``, each shard launching K5
    (``det_rows``; its twin on the CPU) on its slice.  Returns (P,) on
    ``device`` (default: the mesh's first device)."""
    from ..ops.linalg import batched_det_pairs

    device = mesh.first if device is None else torch.device(device)
    with use_mesh(mesh):
        return batched_det_pairs(torch.as_tensor(M), row_idx, col_idx).to(device)


# --------------------------------------------------------------------------
# the mesh's smoke step
# --------------------------------------------------------------------------


def _max_dev(a, b) -> float:
    return max(float((gather_replicated(x).to(y.device) - gather_replicated(y)).abs().max())
               for x, y in zip(a, b))


def _projector(rng, L: int) -> np.ndarray:
    """The correlation matrix of half filling of a random symmetric
    hopping matrix drawn from ``rng``."""
    h = rng.normal(size=(L, L))
    _e, v = np.linalg.eigh(h + h.T)
    return (v[:, : L // 2] @ v[:, : L // 2].T).astype(np.float64)


def multichip_conversion_step(mesh: Mesh, L: int = 16, width: int = 4, n_pairs: int = 64):
    """The mesh's smoke step (JAX ``multichip_conversion_step``): runs the
    production ``slater.C_to_MPS`` under :class:`use_mesh` and checks, as the
    JAX package does,

    - the mesh conversion against the one-device conversion on the mesh's
      first device, tensor by tensor within 1e-12;
    - the chi-sharded fill (``config.CHI_SHARD_MIN`` lowered to 8) the same;
    - the resident conversion (L=48, a (shards, 1) grid of the mesh's
      devices, ``CHI_SHARD_MIN`` = 64): at least L/2 tensors bond-sharded,
      per-shard bytes within 1 %, the tensors within 1e-12;

    then the synthetic step: the entropies of a cut slab split over "cuts"
    and the |determinants| of a pair batch split over "pairs" (K5), whose
    per-shard partial sums are summed on the first device.  Returns that
    finite scalar."""
    from .. import config as _config
    from .. import slater
    from ..ops.kernels import det_rows
    from ..ops.linalg import _eigh_blocks_impl

    dev = mesh.first
    C0 = _projector(np.random.default_rng(7), L)
    ref = slater.C_to_MPS(C0, {"chi_max": 16}, device=dev)
    with use_mesh(mesh):
        out = slater.C_to_MPS(C0, {"chi_max": 16})
    d = _max_dev(ref._B, out._B)
    assert d < 1e-12, f"mesh-sharded conversion deviates: {d}"
    prev = _config.CHI_SHARD_MIN
    _config.CHI_SHARD_MIN = 8
    try:
        with use_mesh(mesh):
            chi = slater.C_to_MPS(C0, {"chi_max": 16})
    finally:
        _config.CHI_SHARD_MIN = prev
    d = _max_dev(ref._B, chi._B)
    assert d < 1e-12, f"chi-sharded conversion deviates: {d}"
    fid = abs(ref.overlap(out)) / max(ref.norm_squared(), 1e-30)
    assert np.isfinite(fid) and fid > 1 - 1e-10, f"mesh conversion fidelity {fid}"

    rmesh = Mesh([[d_] for d_ in mesh.flat])
    Lr = 48
    C2 = _projector(np.random.default_rng(11), Lr)
    ref2 = slater.C_to_MPS(C2, {"chi_max": 48}, device=dev)
    _config.CHI_SHARD_MIN = 64
    try:
        with use_mesh(rmesh):
            res = slater.C_to_MPS(C2, {"chi_max": 48})
    finally:
        _config.CHI_SHARD_MIN = prev
    n_sharded, per = residency(res._B, rmesh)
    assert n_sharded >= Lr // 2, (f"mesh-resident conversion produced only {n_sharded} "
                                  f"sharded tensors of {Lr}")
    assert max(per) / max(min(per), 1) < 1.01, f"per-shard residency imbalance {per}"
    d = _max_dev(ref2._B, res._B)
    assert d < 1e-12, f"mesh-resident conversion deviates: {d}"

    rng = np.random.default_rng(0)
    C = torch.as_tensor(_projector(rng, L), device=dev)
    n_cuts = mesh.shape["cuts"] * max(1, (L + 1) // mesh.shape["cuts"])
    sizes = torch.as_tensor((np.arange(n_cuts) % L + 1).astype(np.int64))
    M = rng.normal(size=(8, 8))
    n_p = mesh.shape["pairs"] * max(1, n_pairs // mesh.shape["pairs"])
    rows = torch.as_tensor(rng.integers(0, 8, size=(n_p, width)), dtype=torch.int32)
    cols = torch.as_tensor(rng.integers(0, 8, size=(n_p, width)), dtype=torch.int32)

    def entropy(s, C_d):
        e, _v = _eigh_blocks_impl(C_d, s.to(C_d.device), "L")
        lam = e.clamp(1e-30, 1.0)
        return torch.where(e < 1.5, -lam * torch.log(lam), torch.zeros_like(lam)).sum()[None]

    def dets(r, c, M_d):
        return det_rows(M_d[None], r.to(M_d.device)[None], c.to(M_d.device)[None])[0].abs() \
            .sum()[None]

    with use_mesh(mesh):
        ent = map_shards(entropy, (sizes,), (C,), axis="cuts", device=dev)
        det = map_shards(dets, (rows, cols), (torch.as_tensor(M, device=dev),), device=dev)
    # the cross-axis reduction: every shard's partial sum, summed on the
    # first device
    return float(ent.sum() + det.sum())

