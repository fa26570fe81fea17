"""chip_smoke.py's CPU-testable parts: it refuses a machine without a GPU
(and a directory without the package) with a non-zero exit and no result
line, --four-cards selects that phase alone, and the last line's format."""

import json
import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_refuses_cpu_with_nonzero_exit_and_no_result():
    out = _run(_REPO, os.path.join(_REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_refuses_in_a_directory_without_the_package(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


class _Dev:
    platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"


def _fake_card(monkeypatch, calls, n=1):
    monkeypatch.setattr(chip_smoke.jax, "devices", lambda: [_Dev()] * n)
    monkeypatch.setattr(
        chip_smoke.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", ""),
    )
    monkeypatch.setattr(chip_smoke.jax.monitoring, "register_event_duration_secs_listener", lambda cb: None)
    for name in ("phase_a", "phase_b", "phase_c", "phase_d", "phase_e", "four_cards"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, name=name: calls.append(name))


@pytest.mark.parametrize(
    "argv,n,want",
    [
        ([], 1, ["phase_a", "phase_b", "phase_c", "phase_d", "phase_e"]),
        (["--four-cards"], 4, ["four_cards"]),
    ],
    ids=["one-card", "four-cards"],
)
def test_phase_selection_and_last_line(monkeypatch, capsys, argv, n, want):
    calls = []
    _fake_card(monkeypatch, calls, n)
    assert chip_smoke.main(argv) == 0
    assert calls == want
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "NVIDIA H100 80GB HBM3, 700.00 W"
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": n}}


def test_check_raises_past_tolerance(capsys):
    chip_smoke.check("x", "thing", 1e-3, 1e-2, "default")
    assert "deviation 1.000e-03, tolerance 1.0e-02" in capsys.readouterr().out
    with pytest.raises(AssertionError):
        chip_smoke.check("x", "thing", 2e-2, 1e-2, "default")
    with pytest.raises(AssertionError):
        chip_smoke.check("x", "thing", float("nan"), 1e-2, "default")


def test_train_reports_rate_compile_and_memory(monkeypatch, capsys):
    """A phase trains through pde_inverse.main.run and prints the trainer's
    own post-warm-up rate, compile seconds and peak bytes."""
    monkeypatch.setattr(chip_smoke, "_peak_bytes", lambda: 123)
    cfg, params = chip_smoke.train(
        "t", "KOU",
        ["solver.train.sample_per_time=16", "solver.train.n_time_stamps=2",
         "solver.train.batch_size_init=16", "solver.train.batch_size_terminal=16"],
        steps=4, chunk=2,
    )
    assert cfg.train.number_of_iterations == 4 and cfg.logging.writer == "jsonl"
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[t] KOU")][0]
    assert "4 steps" in line and "steps/s after warm-up" in line
    assert "compile" in line and line.endswith("peak bytes in use 123")
    assert "params" in params
