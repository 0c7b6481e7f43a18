"""Test configuration.

Tests run on a virtual 8-device CPU mesh (the reference's trick of testing
distributed paths with local multiprocess, SURVEY.md §4.5, maps to XLA's
host-platform device-count flag).  Set MXTPU_TEST_PLATFORM=tpu to run the
suite against the real chip instead (the check_consistency harness then
compares cpu↔tpu).
"""
import os
import sys

# Must happen before the first real jax backend use.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("MXTPU_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: strict/heavy variants excluded from the tier-1 "
        "`-m 'not slow'` run")
    config.addinivalue_line(
        "markers",
        "thread_leak_ok: opt out of the leaked-thread gate (tests "
        "that intentionally strand a worker, e.g. hang-fault soaks)")
    config.addinivalue_line(
        "markers",
        "mxrace_off: opt out of the MXTPU_RACE=1 sanitizer (tests "
        "that drive their own LocksetChecker, e.g. seeded races)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (mxtpu_torch's kernels run only "
        "there); skips inside the test when torch sees none")


@pytest.fixture(autouse=True)
def _seed_everything():
    """Per-test deterministic seeding — the reference's @with_seed()
    (tests/python/unittest/common.py†). MXTPU_TEST_SEED overrides."""
    import mxtpu
    seed = int(os.environ.get("MXTPU_TEST_SEED",
                              os.environ.get("MXNET_TEST_SEED", "42")))
    np.random.seed(seed)
    mxtpu.random.seed(seed)
    yield


# thread pools park non-daemon workers for reuse; those are pool
# lifecycle, not a test leaking its own worker
_LEAK_ALLOW = ("ThreadPoolExecutor-", "asyncio_", "pydevd.")
_LEAK_GRACE_S = 2.0


@pytest.fixture(autouse=True)
def _no_thread_leaks(request):
    """Fail any test that exits with live non-daemon threads it
    started (mxrace satellite: a leaked fleet/serving worker keeps the
    whole pytest process from exiting and poisons later tests'
    lockset state).  Opt out with ``@pytest.mark.thread_leak_ok``."""
    import threading
    before = set(threading.enumerate())
    yield
    if request.node.get_closest_marker("thread_leak_ok"):
        return
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive() and not t.daemon
              and not t.name.startswith(_LEAK_ALLOW)]
    for t in leaked:                      # shutdown race grace
        t.join(timeout=_LEAK_GRACE_S)
    leaked = [t for t in leaked if t.is_alive()]
    if leaked:
        names = ", ".join(sorted(t.name for t in leaked))
        pytest.fail(
            f"leaked non-daemon thread(s): {names} — join or close "
            f"them in the test, or mark it @pytest.mark.thread_leak_ok",
            pytrace=False)


_RACE_PLAN = None   # (cls, guarded) pairs, built once per session


@pytest.fixture(autouse=True)
def _race_sanitizer(request):
    """Opt-in deterministic race detection: ``MXTPU_RACE=1 pytest``
    reruns every test under the mxrace lockset sanitizer
    (mxtpu/analysis/lockset.py) with the serving/obs classes
    instrumented per their ``# guarded-by:`` annotations."""
    if os.environ.get("MXTPU_RACE", "0") not in ("1", "true", "on") \
            or request.node.get_closest_marker("mxrace_off"):
        yield
        return
    from mxtpu.analysis import lockset
    global _RACE_PLAN
    if _RACE_PLAN is None:
        probe = lockset.LocksetChecker()
        lockset.install_default(probe)
        _RACE_PLAN = list(probe._instrumented)
    checker = lockset.LocksetChecker()
    for cls, attrs, guarded in _RACE_PLAN:
        checker.instrument(cls, attrs=attrs, guarded=guarded)
    with checker.activate():
        yield
    if checker.reports:
        msgs = "\n  ".join(r.format() for r in checker.reports)
        pytest.fail(f"mxrace lockset sanitizer:\n  {msgs}",
                    pytrace=False)
