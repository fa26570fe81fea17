"""Importing the package must never initialize a JAX backend.

Round-1 regression: a module-level ``jnp.log(2.0 * jnp.pi)`` in
``ops/gaussian.py`` initialized the backend at import time, which locked
in the wrong platform before ``dryrun_multichip`` could select CPU (the
driver's multichip contract failed on exactly this). This test imports
every package module in a clean subprocess and asserts no backend exists
afterwards, so the failure mode cannot silently return.
"""

import os
import pkgutil
import subprocess
import sys

import pde_inverse

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
mods = sys.argv[1:]
for m in mods:
    __import__(m)
import jax._src.xla_bridge as xb
# _backends is populated lazily on first backend use; imports alone must
# not have touched it.
assert not xb._backends, f"importing {mods} initialized backends: {list(xb._backends)}"
print("clean")
"""


def _all_modules():
    names = ["pde_inverse"]
    for info in pkgutil.walk_packages(
        pde_inverse.__path__, prefix="pde_inverse."
    ):
        names.append(info.name)
    return names


def test_package_import_initializes_no_backend():
    mods = _all_modules()
    # main imports argparse-side CLI glue; include it too — it must stay
    # import-clean for the driver entry points.
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    out = subprocess.run(
        [sys.executable, "-c", _PROBE] + mods,
        capture_output=True,
        text=True,
        env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout


_MAIN_PATH_PROBE = r"""
import sys
from pde_inverse.main import parse_args, run
cfg = parse_args(["preset=KOU", "solver.train.sample_per_time=32",
                  "solver.train.n_time_stamps=4", "solver.train.batch_size_init=32",
                  "solver.train.batch_size_terminal=32", "train.number_of_iterations=4",
                  "train.steps_per_chunk=2", "logging.writer=none"])
run(cfg)
optional = ("flax", "orbax", "yaml", "matplotlib", "wandb")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in optional)
assert not loaded, f"the main path imported optional packages: {loaded}"
print("clean")
"""


def test_kou_main_path_imports_no_optional_package():
    """The default training path (CLI -> ConsistencyBased -> Trainer) needs
    none of flax, orbax, yaml, matplotlib or wandb: they stay lazy
    imports behind their options."""
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _MAIN_PATH_PROBE],
        capture_output=True, text=True, env=env, timeout=300, cwd=_REPO,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout
