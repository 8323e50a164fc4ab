"""Contention tripwire in bench.py (`_dispersion_fields`).

A contended card (another process computing on it during capture) makes a
throughput loop silently average in someone else's work. The tripwire
compares a short FENCED per-step probe against the unfenced throughput loop's mean and flags the two
contention signatures: probe-internal p99/p50 dispersion, and a loop mean far
above the fenced p50. These tests replay one such contaminated capture.
"""

import importlib.util
import os

import numpy as np

_BENCH = os.path.join(os.path.dirname(__file__), "..", "bench.py")


def _load_bench():
    spec = importlib.util.spec_from_file_location("bench", _BENCH)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


class TestDispersionFields:
    def test_quiet_chip_passes(self):
        b = _load_bench()
        # fenced probe slightly above pipelined loop mean = healthy
        f = b._dispersion_fields(np.full(12, 0.080), 78.0, "byol")
        assert f["step_ms_p50"] == 80.0
        assert f["step_ms_loop_mean"] == 78.0
        assert "contention_suspected" not in f

    def test_r04_signature_loop_mean_above_fenced_p50(self, capsys):
        """The actual round-4 contamination: loop averaged 100.9 ms/step while
        the chip's clean fenced latency was ~78 ms — must warn loudly."""
        b = _load_bench()
        f = b._dispersion_fields(np.full(12, 0.078), 100.9, "byol")
        assert f["contention_suspected"] is True
        err = capsys.readouterr().err
        assert "CONTENDED" in err and "NOT a clean capture" in err

    def test_probe_internal_dispersion_flags(self):
        b = _load_bench()
        lat = np.array([0.078] * 11 + [0.155])  # one stolen timeslice
        f = b._dispersion_fields(lat, 80.0, "byol")
        assert f["step_ms_p99"] > 1.4 * f["step_ms_p50"]
        assert f["contention_suspected"] is True

    def test_fields_always_present(self):
        b = _load_bench()
        f = b._dispersion_fields(np.full(5, 0.010), 10.0, "seg")
        assert set(f) >= {"step_ms_p50", "step_ms_p99", "step_ms_loop_mean"}
