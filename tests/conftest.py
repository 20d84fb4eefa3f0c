import os

# tests run on the single default host device -- the dry-run (and only the
# dry-run) forces 512 devices in its own subprocess.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys
import types

import numpy as np
import pytest


def _install_hypothesis_stub() -> None:
    """Let the suite collect and run without hypothesis installed.

    Six test modules import ``hypothesis`` at module scope, which used to
    abort collection of the whole module (taking every plain test in it
    down too).  This shim registers a stub ``hypothesis`` package whose
    ``@given`` replaces the test with a graceful skip -- the importorskip
    analogue, but per-test instead of per-module, so non-property tests in
    those modules still run.  Install the real thing via
    ``requirements-dev.txt`` (or ``scripts/tier1.sh``) to run the property
    tests.
    """

    class _Strategy:
        def __init__(self, name: str = "strategy"):
            self._name = name

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):  # .map/.filter/.flatmap chains
            return _Strategy(f"{self._name}.{name}")

        def __repr__(self):
            return f"<hypothesis-stub strategy {self._name}>"

    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.__getattr__ = lambda name: _Strategy(name)  # PEP 562

    def given(*_args, **_kwargs):
        def deco(fn):
            def skipper(request):
                pytest.skip("hypothesis is not installed "
                            "(pip install -r requirements-dev.txt)")
            skipper.__name__ = getattr(fn, "__name__", "test")
            skipper.__doc__ = getattr(fn, "__doc__", None)
            return skipper
        return deco

    class settings:  # used both as @settings(...) and settings(...) object
        def __init__(self, *_args, **_kwargs):
            pass

        def __call__(self, fn):
            return fn

    hyp = types.ModuleType("hypothesis")
    hyp.given = given
    hyp.settings = settings
    hyp.assume = lambda _cond=True: True
    hyp.note = lambda _msg: None
    hyp.HealthCheck = types.SimpleNamespace(
        too_slow=None, data_too_large=None, filter_too_much=None)
    hyp.strategies = st_mod
    hyp.__stub__ = True
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st_mod


try:
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover - exercised when dev deps missing
    _install_hypothesis_stub()
else:
    # CI-reproducible property testing: the "ci" profile disables deadlines
    # (CI boxes stall unpredictably) and derandomizes, so tier1.sh runs the
    # same example sequence every time; "dev" keeps randomized exploration.
    # Select with HYPOTHESIS_PROFILE (default: ci).
    from hypothesis import HealthCheck, settings as _hsettings

    _hsettings.register_profile(
        "ci", deadline=None, derandomize=True, max_examples=60,
        suppress_health_check=[HealthCheck.too_slow])
    _hsettings.register_profile("dev", deadline=None, max_examples=100)
    _hsettings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running stress tests (quick runs: -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips without one (on the card: "
        "python -m pytest -m gpu tests/test_torch_gpu.py)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def tmp_file(tmp_path):
    return str(tmp_path / "backing.bin")
