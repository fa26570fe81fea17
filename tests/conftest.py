"""Test harness: an 8-device virtual CPU platform unless told otherwise.

Every sharding test sees 8 devices in a mesh.  JAX_PLATFORMS, when set,
wins (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the
card-only tests on a GPU); tests marked ``gpu`` skip, with a reason, on
any other platform.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402


@pytest.fixture
def rng():
    return jax.random.PRNGKey(0)


# --- smoke / full tiers ------------------------------------------------------
# The full suite is ~30 min on a 1-core host, which erodes keep-green
# discipline.  tests/slow_tests.txt lists every test
# measured >= 6 s (regenerate from a `pytest --durations=0` log:
#   grep -E "^[0-9.]+s call" LOG | awk '{gsub("s","",$1); if ($1+0>=6) print $3}' | sort
# ); they get a `slow` marker here, so
#   pytest -m "not slow"   — smoke tier, ~5 min
#   pytest                 — full tier, unchanged
# Tests not in the list (including new ones) default to the smoke tier —
# additions are smoke until a durations run says otherwise.

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: measured >= 6 s on the 1-core host (tests/slow_tests.txt)"
    )
    config.addinivalue_line(
        "markers", "gpu: runs compiled GPU kernels; skips on other platforms"
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests off the card, decided per test at run time
    (never at import or collection, so every xdist worker collects the same
    tests)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; running on {jax.default_backend()}")


def _slow_ids():
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    try:
        with open(path) as f:
            return {line.strip() for line in f if line.strip()}
    except OSError:
        return set()


def pytest_collection_modifyitems(config, items):
    slow = _slow_ids()
    if not slow:
        return
    mark = pytest.mark.slow
    for item in items:
        # nodeid is tests/<file>::<class>::<test>; the list stores the same
        if item.nodeid in slow:
            item.add_marker(mark)
