"""A run's flow on the CPU: the result line, a broken timed path that the
check catches, no card, no JAX."""

import json
import subprocess
import sys
import time

import pytest
import torch

import harness
import manifest
from pb_helpers import tiny_cell

RUN = [sys.executable, str(manifest.HERE / "run.py")]


def _run(cell, capsys, seconds=1.0, trace=False):
    out = harness.run(cell, 2**32 + 7, seconds, trace, time.perf_counter(), device="cpu",
                      require_card=False)
    printed = capsys.readouterr()
    return out, printed


@pytest.mark.parametrize("name", ["slater_cyl8.L512_chi128", "pfaffian_pip8.Lx16_chi256"])
def test_a_run_prints_the_result_last(name, capsys):
    out, printed = _run(tiny_cell(name, **({"check_sites": "all"} if "pfaffian" in name else {})),
                        capsys)
    last = json.loads(printed.out.strip().splitlines()[-1])
    assert last == out and last["correct"] is True
    assert list(last)[-1] == "checks"
    assert set(last["metrics"]) == {"time_per_state_s", "setup_s"}
    assert last["attempted"] >= 2 and last["failed"] == 0
    assert printed.err.strip().splitlines()[-1].startswith("check structure_errors 0 limit 0")


def test_a_traced_run_reports_the_stage_metrics(capsys):
    out, _ = _run(tiny_cell("pfaffian_pip8.Lx16_chi256"), capsys, seconds=1.0, trace=True)
    assert {"frontend.eigh_s", "schmidt.host_s", "plan.host_s", "fill.groups_s"} <= set(out["metrics"])
    assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
    assert out["correct"] is True


def _scaled(out):
    """The largest entry of the first tensor times 1.001."""
    T = out[0][0]
    T[torch.unravel_index(T.abs().argmax(), T.shape)] *= 1.001


def _negated(out):
    """The largest entry of the largest tensor with its sign flipped."""
    T = max((o[0] for o in out), key=lambda t: t.numel())
    T[torch.unravel_index(T.abs().argmax(), T.shape)] *= -1


def _moduli(out):
    """Every tensor replaced by its moduli (a fill that drops the sign)."""
    for o in out:
        o[0].copy_(o[0].abs())


@pytest.mark.parametrize("name,module,fault", [
    ("slater_cyl8.L512_chi128", "slater", _scaled),
    ("pfaffian_pip8.Lx16_chi256", "pfaffian", _scaled),
    ("pfaffian_pip8.Lx16_chi256", "pfaffian", _negated),
    ("pfaffian_pip8.Lx16_chi256", "pfaffian", _moduli)])
def test_an_answer_altered_where_it_is_produced_is_not_correct(name, module, fault, monkeypatch,
                                                               capsys):
    """Every fill's tensors altered as the fill hands them back: scaled by
    one part in a thousand, one entry's sign flipped, or moduli alone."""
    import importlib

    mod = importlib.import_module(f"temfpy_torch.{module}")
    build = mod.build_site_tensors

    def altered(*args, **kw):
        out = build(*args, **kw)
        fault(out)
        return out

    monkeypatch.setattr(mod, "build_site_tensors", altered)
    out, _ = _run(tiny_cell(name, check_sites="all"), capsys)
    assert out["correct"] is False
    assert out["checks"]["tensor_gap"]["value"] > out["checks"]["tensor_gap"]["limit"]


def test_a_state_that_fails_is_counted(monkeypatch, capsys):
    from temfpy_torch import pfaffian

    monkeypatch.setattr(pfaffian, "C_to_MPS", lambda *a, **k: 1 / 0)
    cell = tiny_cell("pfaffian_pip8.Lx16_chi256")
    entry = cell.module("entries")
    cell.module = lambda kind, _m=cell.module: entry if kind == "entries" else _m(kind)
    monkeypatch.setattr(entry, "convert", lambda H, chi, device=None: 1 / 0)
    monkeypatch.setattr(harness.Loop, "_sample", lambda self, j, out: None)
    cell.spec["check_states"] = 1
    with pytest.raises(ZeroDivisionError):
        _run(cell, capsys)  # the warm-up state fails in set-up


def test_no_card_exits_nonzero_without_a_result():
    p = subprocess.run(RUN + ["--workload", "slater_cyl8.L512_chi128", "--seed", "5",
                              "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                                          "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert "metrics" not in p.stdout and "memory_peak_bytes" not in p.stdout


def test_the_harness_loads_no_jax_and_the_references_nothing_of_the_port():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness, checks, manifest, spans, timeline, control\n"
        "from references import slater_det, pfaffian_pf\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "import temfpy_torch.slater, temfpy_torch.pfaffian\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(manifest.HERE), str(manifest.ROOT),
         ("jax", "jaxlib", "flax", "temfpy_tpu", "temfpy_torch"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
