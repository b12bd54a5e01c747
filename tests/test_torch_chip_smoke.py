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
