"""Multi-host smoke test: 2 OS processes x 2 virtual CPU devices wired by
jax.distributed (Gloo collectives), through the production code path
(main.maybe_init_distributed -> parallel.mesh.build_mesh -> shard_map psum).

The reference has no multi-host story at all (SURVEY.md §2.2); on GPUs the
identical path rides NCCL instead of Gloo with zero code change.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_psum():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        # clean import path; force 2 virtual CPU devices/process
        env["PYTHONPATH"] = ""
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["PDE_INVERSE_MULTIHOST"] = "1"
        env["PDE_INVERSE_COORDINATOR"] = f"localhost:{port}"
        env["PDE_INVERSE_NUM_PROCESSES"] = "2"
        env["PDE_INVERSE_PROCESS_ID"] = str(pid)
        procs.append(
            subprocess.Popen(
                [sys.executable, _WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outputs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "psum over 4 devices OK: 10.0" in out, out
