"""Test harness: run everything on a virtual 8-device CPU mesh.

The reference validated multi-GPU DDP only by launching real jobs
(SURVEY §4); here an 8-device CPU mesh exercises the sharding and collective
code paths without a GPU. Tests that need a card carry the ``gpu`` marker
and skip here (``chip_smoke.py`` runs the main paths on the card).

The platform is forced with ``jax.config.update`` before any backend starts,
and in the environment for any subprocess a test spawns. The persistent
compilation cache stays off, so entry points that enable it
(`core/runtime.py`) write nothing from the test run.
"""

import os

# MIS_TEST_ON_GPU=1 leaves the platform alone, for the ``gpu``-marked tests
# that chip_smoke.py runs on the card
if os.environ.get("MIS_TEST_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses we spawn
    os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_compilation_cache", False)


# --- CI wall-clock budget enforcement -------------------------------------
# The quick suite must fit its CI step with real margin, not 87% utilization.
# Opt-in: set MIS_SUITE_BUDGET_S (the CI config exports it; local runs are
# unaffected). Implemented as a session-finish check so one glance at the
# red X says "the suite outgrew its envelope" instead of a silent creep
# toward the step's kill-timer.
import time as _time

_SESSION_T0 = _time.monotonic()


def pytest_sessionfinish(session, exitstatus):
    budget = os.environ.get("MIS_SUITE_BUDGET_S")
    if not budget:
        return
    wall = _time.monotonic() - _SESSION_T0
    if wall > float(budget):
        reporter = session.config.pluginmanager.get_plugin("terminalreporter")
        msg = (f"suite wall time {wall:.0f}s exceeded MIS_SUITE_BUDGET_S="
               f"{budget}s — move new heavy tests to @pytest.mark.slow or "
               "split them (README 'Test suite' section)")
        if reporter:
            reporter.write_line(f"\nBUDGET EXCEEDED: {msg}", red=True)
        # mutating session.exitstatus here is ignored by pytest's main();
        # registering a config cleanup is the supported way to force the
        # process exit code after all plugins have reported
        import pytest as _pytest

        def _fail():
            raise _pytest.exit.Exception(msg, returncode=3)

        session.config.add_cleanup(_fail)
