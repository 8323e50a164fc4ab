"""Shared preemption / lockstep-stop machinery for the trainer entry points.

Cluster jobs get preempted; the reference relied on PyTorch Lightning defaults
for checkpoint/resume (per-epoch ModelCheckpoint + ``ckpt_path``, reference
`train_segmentation.py:51-61`, SURVEY §5.4). Here both trainers share one
implementation: on SIGTERM/SIGINT the current step finishes, every host
*agrees* to stop at a lockstep collective boundary, a checkpoint is written
by all hosts (the save gathers the state collectively), and the process exits 0 so the
scheduler can resume it with ``--resume``.

The agreement protocol is the delicate part — see ``PreemptionGuard.stop_agreed``.
"""

from __future__ import annotations

import os
import signal
import sys

import numpy as np


class PreemptionGuard:
    """SIGTERM/SIGINT → lockstep stop agreement across hosts.

    CRITICAL invariant: every host must enter the agreement collective at the
    SAME points, or a signaled host's allgather pairs against its peers'
    train-step psums and the pod deadlocks. So the local signal flag never
    changes whether a host enters the collective — all hosts sync at fixed
    step boundaries (every ``sync_every`` steps, giving ≤``sync_every``-step
    stop latency) and at epoch end, both of which are lockstep across hosts
    (loader shards are equalized). Any-host signal wins.

    ``sync_every`` is env-overridable via ``MIS_STOP_SYNC_EVERY`` so
    slow-host tests can use a short interval; the lockstep property is
    interval-independent.
    """

    def __init__(self, nproc: int, sync_every: int | None = None):
        self.nproc = nproc
        self.sync_every = (
            sync_every
            if sync_every is not None
            else int(os.environ.get("MIS_STOP_SYNC_EVERY", "20"))
        )
        self._stop = False
        signal.signal(signal.SIGTERM, self._request_stop)
        signal.signal(signal.SIGINT, self._request_stop)

    def _request_stop(self, signum, frame):
        self._stop = True
        print(f"signal {signum}: will checkpoint and exit after this step", file=sys.stderr)

    @property
    def stop_requested(self) -> bool:
        """This host's local flag (NOT agreement — use only for logging)."""
        return self._stop

    def stop_agreed(self, step_idx: int = -1, at_epoch_end: bool = False) -> bool:
        """True iff any host requested a stop, evaluated only at lockstep
        boundaries. Single-process runs short-circuit on the local flag."""
        if self.nproc == 1:
            return self._stop
        if not at_epoch_end and step_idx % self.sync_every != self.sync_every - 1:
            return False
        from jax.experimental import multihost_utils

        flags = np.asarray(
            multihost_utils.process_allgather(np.array([self._stop], np.int32))
        )
        return bool(flags.sum() > 0)
