"""temfpy_torch.profiling: stages, records, counters and profiler ranges.

On the CPU: what a stage costs and records with no collector and no
profiler; how records nest; the report's totals; the converters' stages
and kernel counters on tiny conversions; the records against their
profiler ranges.  On the card (marked ``cuda``, skipped where torch sees
none): the bytes an Lx=16 Pfaffian conversion downloads, against the count
worked out from its shapes.
"""

import time

import numpy as np
import pytest
import torch

from temfpy_torch import pfaffian, profiling, slater, testing
from temfpy_torch.ops import kernels

NEW_STAGES = {"correlation_matrix", "prepare", "centre_cut", "assembly"}
"""The stages of the converters' own work outside the streamed cuts."""
CHECK_STAGES = {"checks/overlap", "checks/nambu"}
"""The Pfaffian path's self-check stages."""


@pytest.fixture(autouse=True)
def _checks_on(monkeypatch):
    """The shipped checked mode, on one torch thread."""
    monkeypatch.setattr(testing, "TEST_ACTION", "warn")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_sync(monkeypatch):
    """A card that seems present and initialised, whose synchronisation
    raises."""
    def sync(*a, **k):
        raise AssertionError("torch.cuda.synchronize was called")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def kitaev(L, t=1.0, mu=3.0, delta=0.8):
    """The Kitaev chain's BdG Hamiltonian in the complex-fermion basis
    (interleaved c^dag_i, c_i), deep in the trivial phase at mu=3."""
    H = np.zeros((2 * L, 2 * L), complex)
    for i in range(L):
        H[2 * i, 2 * i], H[2 * i + 1, 2 * i + 1] = -mu / 2, mu / 2
    for i in range(L - 1):
        a, b = 2 * i, 2 * i + 2
        H[a, b] = H[b, a] = -t / 2
        H[a + 1, b + 1] = H[b + 1, a + 1] = t / 2
        H[a, b + 1] = H[b + 1, a] = delta / 2
        H[b, a + 1] = H[a + 1, b] = -delta / 2
    return H


def convert_pfaffian(L=10, chi=16, device="cpu"):
    C = pfaffian.correlation_matrix(kitaev(L), basis="C->M", device=device)
    return pfaffian.C_to_MPS(C, {"chi_max": chi}, basis="M", device=device)


def convert_slater(L=12, chi=16):
    A = np.random.default_rng(5).standard_normal((L, L))
    return slater.H_to_MPS(-(A + A.T), {"chi_max": chi}, device="cpu")


def names(prof):
    return {r.name for r in prof.records}


def test_without_a_collector_or_profiler_nothing_is_recorded_or_synchronised(no_sync,
                                                                            monkeypatch):
    def no_range(*a, **k):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    with profiling.stage("x"):
        profiling.count("n", 3)
    convert_pfaffian()
    assert profiling._open == []
    with profiling.collect() as prof:
        profiling.count("n")
    assert dict(prof.counts) == {("", "n"): 1} and prof.records == []
    with pytest.raises(AssertionError, match="synchronize"):  # the patch would see one
        with profiling.collect(), profiling.stage("x"):
            pass


def test_records_nest_and_self_times_sum_to_the_top_level():
    @profiling.entry_point
    def inner():
        with profiling.stage("c"):
            time.sleep(0.002)

    @profiling.entry_point
    def outer():
        with profiling.stage("a"):
            with profiling.stage("b"):
                inner()
            with profiling.stage("d"):
                profiling.count("k", 2)
        with profiling.stage("e"):
            pass

    with profiling.collect() as prof:
        outer()
        with profiling.stage("f"):
            pass
    by = {r.name: r for r in prof.records}
    assert [r.name for r in prof.records] == ["c", "b", "d", "a", "e", "f"]
    root = by["a"].root
    assert prof.roots[root] == "outer" and prof.roots[by["f"].id] == "f"
    assert {by[n].root for n in "abcde"} == {root} and by["f"].root == by["f"].id
    assert by["a"].parent is by["e"].parent is by["f"].parent is None
    assert by["b"].parent == by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id  # through inner's frame, which keeps no record
    assert prof.counts == {("d", "k"): 2} and prof.total("k") == 2
    for r in prof.records:
        assert r.start_ns <= r.end_ns
        if r.parent in {x.id for x in prof.records}:
            p = next(x for x in prof.records if x.id == r.parent)
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    own = prof.self_seconds()
    top = by["a"].seconds + by["e"].seconds + by["f"].seconds
    assert sum(own.values()) == pytest.approx(top, rel=1e-12)
    assert own["a"] == pytest.approx(by["a"].seconds - by["b"].seconds - by["d"].seconds)
    assert prof.calls == {n: 1 for n in "abcdef"}
    assert all(prof.seconds[r.name] == r.seconds for r in prof.records)  # one clock
    assert prof.seconds["c"] >= 0.002


def test_add_is_called_as_the_stage_ends(monkeypatch):
    """A subclass that reads the clock in ``add`` (the benchmark's interval
    profile) sees the stages nest strictly, however long keeping a record
    takes (here the outer stage's, as a garbage collection might)."""
    spans = []

    class Clocked(profiling.Profile):
        def add(self, name, dt):
            super().add(name, dt)
            end = time.perf_counter()
            spans.append((name, end - dt, end))

    class SlowRecord(profiling.Record):
        def __new__(cls, *args):
            if args[3] == "outer":
                time.sleep(0.003)
            return super().__new__(cls, *args)

    monkeypatch.setattr(profiling, "Profile", Clocked)
    monkeypatch.setattr(profiling, "Record", SlowRecord)
    with profiling.collect():
        with profiling.stage("outer"):
            time.sleep(0.001)
            with profiling.stage("inner"):
                pass
    (_, s_in, e_in), (_, s_out, e_out) = spans
    assert s_out <= s_in <= e_in <= e_out


def test_the_report_counts_nested_stages_once():
    with profiling.collect() as prof:
        with profiling.stage("outer"):
            with profiling.stage("inner"):
                time.sleep(0.05)
    lines = prof.report().splitlines()
    total = float(next(x for x in lines if x.startswith("TOTAL")).split()[1])
    outer = next(r for r in prof.records if r.name == "outer").seconds
    assert total == pytest.approx(outer, abs=1e-3) and total < 0.09
    row = next(x for x in lines if x.startswith("outer")).split()
    assert float(row[3]) == pytest.approx(0.0, abs=2e-3)  # self time


@pytest.mark.parametrize("family", ["pfaffian", "slater"])
def test_a_conversion_shows_the_new_stages_and_its_launches(family):
    wrappers = (kernels.det_fill, kernels.site_overlap_schur, kernels.pf_fill,
                kernels.bdg_overlap)
    before = [w.launches for w in wrappers]
    with profiling.collect() as prof:
        (convert_pfaffian if family == "pfaffian" else convert_slater)()
    assert profiling.last_profile() is prof
    by_id = {r.id: r for r in prof.records}
    if family == "pfaffian":
        assert NEW_STAGES | CHECK_STAGES <= names(prof)
        for r in prof.records:
            if r.name == "checks/overlap":
                assert by_id[r.parent].name == "fill/plan"
            if r.name == "checks/nambu":
                assert by_id[r.parent].name in NEW_STAGES
        conversion = [r for r in prof.records if prof.roots[r.root] == "C_to_MPS"]
        assert {"prepare", "centre_cut", "eigh_batch", "assembly"} <= {r.name for r in conversion}
        assert {r.name for r in prof.records if prof.roots[r.root] == "correlation_matrix"} == {
            "correlation_matrix", "checks/nambu"}
        launches = ("launch/bdg_overlap", "launch/pf_fill")
    else:
        assert NEW_STAGES <= names(prof) and not CHECK_STAGES & names(prof)
        assert {prof.roots[r.root] for r in prof.records} == {"H_to_MPS"}
        launches = ("launch/site_overlap_schur", "launch/det_fill")
    assert all(prof.total(n) > 0 for n in launches)
    assert [w.launches for w in wrappers] == before  # a twin call launches nothing
    # a copy that stays on one device counts nothing
    assert prof.total("d2h_bytes") == prof.total("h2d_bytes") == prof.total("syncs") == 0


def test_records_lie_on_their_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as trace, profiling.collect() as prof:
        convert_pfaffian()
    ranges = {}
    for ev in trace.profiler.kineto_results.events():
        if ev.name().startswith(profiling.STAGE_PREFIX):
            ranges.setdefault(ev.name()[len(profiling.STAGE_PREFIX):], []).append(
                (ev.start_ns(), ev.end_ns()))
    assert set(ranges) == names(prof)
    for name, spans in ranges.items():
        recs = sorted((r.start_ns, r.end_ns) for r in prof.records if r.name == name)
        assert len(recs) == len(spans), name
        for (rs, re), (s, e) in zip(recs, sorted(spans)):
            assert abs(rs - s) <= 1_000_000 and abs(re - e) <= 1_000_000, name


def test_under_the_profiler_alone_nothing_synchronises(no_sync):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as trace:
        convert_pfaffian()
    seen = {ev.name() for ev in trace.profiler.kineto_results.events()}
    assert {profiling.STAGE_PREFIX + n for n in NEW_STAGES | CHECK_STAGES} <= seen
    assert profiling._open == []


def pfaffian_d2h_bytes(L: int, eigh_chunk: int = 32) -> int:
    """The bytes a finite Pfaffian conversion of L sites downloads
    (complex128 16 B, float64 8 B, n = 2L Majoranas):
    ``correlation_matrix`` the eigenvalues (n) and the filled half of the
    eigenvectors (n x L); the centre cut c = L // 2 the Majorana C (n x n),
    then each side's block eigenvalues and eigenvectors (2c and 2(L - c));
    ``eigh_batch`` every cut's whole padded frame, (n,) and (n, n), L cuts
    in all."""
    n, c = 2 * L, L // 2
    corr = 8 * n + 16 * n * L
    centre = 16 * n * n + sum(8 * s + 16 * s * s for s in (2 * c, 2 * (L - c)))
    cuts = L * (8 * n + 16 * n * n)
    return corr + centre + cuts


@pytest.mark.cuda
def test_an_lx16_conversion_downloads_what_its_shapes_say(cuda):
    L = 128  # Lx=16 on the W=8 cylinder
    convert_pfaffian(L, 64, cuda)  # warm
    torch.cuda.synchronize()
    with profiling.collect() as prof:
        convert_pfaffian(L, 64, cuda)
    want = pfaffian_d2h_bytes(L)
    assert abs(prof.total("d2h_bytes") - want) <= 0.01 * want, (prof.total("d2h_bytes"), want)
    assert prof.total("syncs") > 0 and prof.total("h2d_bytes") > 0
    assert prof.total("launch/pf_fill") > 0 and prof.total("launch/bdg_overlap") > 0
