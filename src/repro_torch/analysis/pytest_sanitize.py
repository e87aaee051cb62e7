"""pytest plugin: the port's suites under the port's runtime sanitizer.

    REPRO_SANITIZE=1 PYTHONPATH=src python -m pytest \
        -p repro_torch.analysis.pytest_sanitize tests/test_torch_net_protocol.py

With ``REPRO_SANITIZE=1`` the plugin calls the port's
:func:`repro_torch.analysis.sanitizer.install` when pytest loads it, so
every ``KVStore`` / ``FileKVStore`` / ``NetKVStore`` / ``ObjectStore`` /
backend / ``Scheduler`` of the port built during the run is instrumented,
and a test that leaves any invariant report (unfenced ``sched/`` write,
lock-order inversion, blocking op under a lock, torn multi-key read)
**fails** with the report list, even if its own assertions passed.  It
is the twin of the ``REPRO_SANITIZE=1`` hook in ``tests/conftest.py``,
which goes on sanitizing the JAX package's classes beside it.  Without
the variable it does nothing.
"""

from __future__ import annotations

import os

import pytest

_SANITIZE = os.environ.get("REPRO_SANITIZE") == "1"

if _SANITIZE:
    from repro_torch.analysis import sanitizer

    sanitizer.install()


@pytest.fixture(autouse=True)
def _torch_sanitizer_guard():
    if not _SANITIZE:
        yield
        return
    from repro_torch.analysis import sanitizer

    sanitizer.state.clear()
    yield
    reports = sanitizer.state.snapshot()
    if reports:
        lines = "\n".join(f"  {r}" for r in reports)
        sanitizer.state.clear()
        pytest.fail(
            f"runtime sanitizer (repro_torch): {len(reports)} invariant report(s):\n{lines}",
            pytrace=False,
        )
