"""True multi-process multi-host test: two JAX processes + coordinator.

This exercises what the virtual 8-device mesh cannot: real
`jax.distributed.initialize`, `make_array_from_process_local_data` over
host-local shards, cross-host collectives, and per-host Loader sharding —
the multi-process path (SURVEY §5.8) on two CPU processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed(tmp_path):
    from medical_image_segmentation_tpu.data.store import StoreWriter

    store = str(tmp_path / "mh.mis")
    with StoreWriter(store, channels=1, with_labels=True) as w:
        for i in range(16):
            w.add(np.full((8, 8, 1), i, np.uint8), label=i)

    port = _free_port()
    runner = os.path.join(os.path.dirname(__file__), "_multihost_runner.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # runner sets its own device count
    # the runner is invoked as a script (sys.path[0] = tests/), so the repo
    # root must be on PYTHONPATH — don't depend on an editable install
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep * bool(env.get("PYTHONPATH", "")) + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, runner, str(i), str(port), store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=560)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"PROC {i} OK" in out
