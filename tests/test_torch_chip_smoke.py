"""chip_smoke.py's start on a host whose CUDA does not come up: with no card
it gives up at once (exit 2, no result printed); with a card it tries again
in fresh processes for a while and, once CUDA is up, runs itself again."""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.delenv(mod.CUDA_WAITED, raising=False)
    monkeypatch.setattr(mod, "CUDA_RETRY_S", 0)
    return mod


def _probes(monkeypatch, smoke, outcomes):
    """Replace the fresh-process probe with ``outcomes`` in turn (rc,
    stdout, stderr), the last one repeated; returns the calls made."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        rc, out, err = outcomes[min(len(calls), len(outcomes)) - 1]
        return subprocess.CompletedProcess(cmd, rc, out, err)

    monkeypatch.setattr(smoke.subprocess, "run", run)
    return calls


def test_no_card_gives_up_without_a_probe(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "card_present", lambda: False)
    calls = _probes(monkeypatch, smoke, [(0, "1\n", "")])
    assert smoke.wait_for_cuda() is False
    assert calls == []


def test_a_rerun_does_not_wait_again(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "card_present", lambda: True)
    monkeypatch.setenv(smoke.CUDA_WAITED, "1")
    calls = _probes(monkeypatch, smoke, [(0, "1\n", "")])
    assert smoke.wait_for_cuda() is False
    assert calls == []


@pytest.mark.parametrize("fails", [0, 1, 3])
def test_a_card_is_tried_until_cuda_is_up(smoke, monkeypatch, capsys, fails):
    monkeypatch.setattr(smoke, "card_present", lambda: True)
    monkeypatch.setattr(smoke, "CUDA_WAIT_S", 60)
    err = "RuntimeError: CUDA driver initialization failed"
    calls = _probes(monkeypatch, smoke, [(1, "", f"warning\n{err}\n")] * fails + [(0, "1\n", "")])
    assert smoke.wait_for_cuda() is True
    assert len(calls) == fails + 1
    assert all(c[0] == sys.executable and "torch.cuda.init()" in c[-1] for c in calls)
    assert capsys.readouterr().err.count(err) == fails


@pytest.mark.parametrize("outcome", [(1, "", "RuntimeError: no CUDA\n"), (0, "0\n", "")],
                         ids=["probe fails", "probe counts no card"])
def test_a_card_whose_cuda_stays_down_gives_up_at_the_deadline(smoke, monkeypatch, outcome):
    monkeypatch.setattr(smoke, "card_present", lambda: True)
    monkeypatch.setattr(smoke, "CUDA_WAIT_S", 0.2)
    calls = _probes(monkeypatch, smoke, [outcome])
    assert smoke.wait_for_cuda() is False
    assert len(calls) >= 1


def test_main_without_cuda_exits_2_and_prints_no_result(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(smoke, "card_present", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert smoke.main() == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "is_available() is False" in out.err


@pytest.mark.parametrize("args", [[], ["--parent", "."]], ids=["no arguments", "--parent"])
def test_main_runs_again_once_cuda_is_up(smoke, monkeypatch, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(smoke, "wait_for_cuda", lambda: True)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", *args])
    monkeypatch.chdir(ROOT)

    class Exec(Exception):
        pass

    def execv(path, argv):
        raise Exec(path, argv)

    monkeypatch.setattr(smoke.os, "execv", execv)
    with pytest.raises(Exec) as ran:
        smoke.main()
    path, argv = ran.value.args
    assert path == sys.executable
    assert argv == [sys.executable, str(ROOT / "chip_smoke.py"), *args]
    assert smoke.os.environ[smoke.CUDA_WAITED] == "1"


class _Ev:
    """A stand-in for one of Kineto's raw events."""

    def __init__(self, name, device, corr, start, us=1.0):
        self._n, self._d, self._c, self._s, self._us = name, device, corr, start, us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return int(self._us * 1e3)


def _prof(events):
    res = type("R", (), {"events": lambda self: events})()
    return type("P", (), {"profiler": type("K", (), {"kineto_results": res})()})()


def _launches(first_corr, n, start, kernel="k", lost=(), us=1.0):
    """``n`` eager launches with their device records but those in ``lost``."""
    out = []
    for i in range(n):
        c = first_corr + i
        out.append(_Ev("cudaLaunchKernel", False, c, start + i))
        if i not in lost:
            out.append(_Ev(kernel, True, c, start + i + 1, us))
    return out


@pytest.mark.parametrize("lost_in_head", [(), (0, 1, 2)])
def test_trace_leaves_out_its_head(smoke, lost_in_head):
    """The head's launches and records count nowhere, and records the head
    lost are not the body's loss."""
    ev = (_launches(1, 4, 0, "add", lost=lost_in_head, us=0.5)
          + _launches(100, 3, 100, "body", us=2.0) + [_Ev("cudaStreamSynchronize", False, 200, 300)])
    t = smoke.Trace(_prof(ev), head=4, wall=0.01)
    assert t.lost == 0
    assert t.device == [("body", 2.0)] * 3
    assert t.busy_us() == 6.0 and t.by_op() == {"body": 6.0}
    assert t.count(smoke.LAUNCH_OPS) == 3 and t.count(smoke.SYNC_OPS) == 1


def test_trace_counts_the_body_launches_without_records(smoke):
    ev = _launches(1, 2, 0, "add") + _launches(100, 5, 100, "body", lost=(0, 1))
    t = smoke.Trace(_prof(ev), head=2, wall=0.01)
    assert t.lost == 2 and len(t.device) == 3


def test_trace_holds_graph_replays_to_each_other(smoke):
    """A replay of the same graph that kept fewer of its kernels' records
    than another counts the difference as lost."""
    ev = _launches(1, 1, 0, "add")
    for r, kept in enumerate((3, 3, 1)):
        c = 50 + r
        ev.append(_Ev("cudaGraphLaunch", False, c, 10 + 10 * r))
        ev += [_Ev(f"g{j}", True, c, 11 + 10 * r + j) for j in range(kept)]
    t = smoke.Trace(_prof(ev), head=1, wall=0.01)
    assert t.lost == 2 and len(t.device) == 7
    assert t.top(1) == [("g0", 3e-3)]


def test_trace_sums_ops_that_share_a_name_prefix(smoke):
    long = "void k<" + "x" * 100
    ev = _launches(1, 2, 0, long + "A>", us=1.0) + _launches(10, 1, 10, long + "B>", us=2.0)
    t = smoke.Trace(_prof(ev), head=0, wall=0.01)
    assert t.by_op() == {long[:80]: 4.0}
