"""Device mesh construction and sharding helpers.

This replaces the reference's entire distributed stack (PyTorch-Lightning
DDP + NCCL + sync_batchnorm, `medical_image_segmentation/train/train_ssl.py:77-89`;
SURVEY §5.8):

- ``initialize_distributed``: per-process `jax.distributed.initialize` from
  SLURM env auto-detection or an explicit coordinator (the reference derives
  world layout from SLURM env vars, `train_ssl.py:30,56`). With one process
  per card, each process opens only its own card (``local_device_ids``).
- ``make_mesh``: one mesh, default a single ``("data",)`` axis over all
  devices. ResNet/U-Net-scale models need only data parallelism
  (SURVEY §2.4); the mesh accepts extra axes for spatial sharding of
  full-res CT slices if desired.
- Parameters/opt-state are replicated; batches are sharded on ``data``.
  Under ``jit``, XLA inserts the gradient all-reduce (replacing DDP) and
  makes BatchNorm statistics global (replacing sync_batchnorm) because the
  batch-dim reductions cross the sharded axis. XLA hands the collectives to
  NCCL: NVLink within a host, the network across hosts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


_DISTRIBUTED_DONE = False


def local_device_ids() -> Optional[list]:
    """The card a process opens in a one-process-per-card launch: its local
    rank (``LOCAL_RANK``, else ``SLURM_LOCALID``), or None — every local card
    — when neither is set. A JAX process reserves most of each card it opens,
    so two processes must not share one."""
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        value = os.environ.get(var, "")
        if value != "":
            return [int(value)]
    return None


def initialize_distributed() -> None:
    """Initialize multi-process JAX if running under a multi-process launcher.

    No-op for a single process. Honors the SLURM env contract the reference
    uses (SLURM_NTASKS/SLURM_PROCID/SLURM_NODELIST) and an explicit
    coordinator (below).

    IMPORTANT: decides from env vars only — touching any jax API that
    initializes the XLA backend (jax.devices, jax.process_count, …) before
    ``jax.distributed.initialize`` makes the init raise, so this must run
    first thing in the entry points.
    """
    global _DISTRIBUTED_DONE
    if _DISTRIBUTED_DONE:
        return
    # MIS_FORCE_CPU_DEVICES=N: an N-device virtual CPU backend, set by config
    # before the backend starts — how the multi-process CLI tests get a REAL
    # multi-process CPU mesh.
    n_force = int(os.environ.get("MIS_FORCE_CPU_DEVICES", "0"))
    if n_force:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", n_force)
    ntasks = int(os.environ.get("SLURM_NTASKS", "1"))
    in_slurm = ntasks > 1 and "SLURM_PROCID" in os.environ
    # explicit manual launch (also how tests run the CLIs multi-process):
    #   JAX_COORDINATOR_ADDRESS=host:port JAX_NUM_PROCESSES=N JAX_PROCESS_ID=i
    # plus LOCAL_RANK=<card> when each process drives one card
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    n_explicit = int(os.environ.get("JAX_NUM_PROCESSES", "0"))
    pid = os.environ.get("JAX_PROCESS_ID")
    if addr and n_explicit > 1 and pid is not None:
        jax.distributed.initialize(addr, n_explicit, int(pid), local_device_ids=local_device_ids())
    elif in_slurm:
        # jax reads the SLURM env, one card per task from SLURM_LOCALID
        jax.distributed.initialize(local_device_ids=local_device_ids())
    _DISTRIBUTED_DONE = True


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    axis_names: Sequence[str] = ("data",),
    axis_sizes: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a Mesh. Default: all devices on one ``data`` axis.

    ``axis_sizes`` lets callers split devices over multiple axes, e.g.
    ``axis_names=("data","space")`` with ``axis_sizes=(4,2)`` for spatial
    sharding of large slices (SURVEY §5.7).
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if axis_sizes is None:
        axis_sizes = (len(devices),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != devices.size:
        raise ValueError(f"axis_sizes {axis_sizes} != #devices {devices.size}")
    return Mesh(devices.reshape(axis_sizes), axis_names)


def data_sharding(mesh: Mesh, ndim: int = 1, axis: str = "data") -> NamedSharding:
    """Shard dim 0 over ``axis``, replicate the rest."""
    spec = P(axis, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def spatial_sharding(mesh: Mesh, ndim: int = 4, batch_axis: str = "data", space_axis: str = "space") -> NamedSharding:
    """Shard images (B, H, W, C) over batch AND height — for full-res CT
    slices that exceed one card's comfortable activation footprint
    (SURVEY §5.7). XLA GSPMD inserts the conv halo exchanges automatically;
    no manual ppermute needed."""
    spec = P(batch_axis, space_axis, *([None] * (ndim - 2)))
    return NamedSharding(mesh, spec)


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Place host batches onto the mesh, batch-dim sharded.

    Single-process: plain ``device_put`` with a NamedSharding. Multi-host:
    each process holds only its own shard, so the global array must be
    assembled with ``jax.make_array_from_process_local_data`` (``device_put``
    would treat the local shard as the whole global array — and asserts the
    input is identical across processes).

    A remainder batch whose leading dim does not divide the mesh is
    replicated instead (correct, redundant compute) — this only happens for
    the final partial eval batch when ``drop_last=False``, and is a
    single-process-only affordance (multi-host eval loaders must drop the
    remainder; distinct per-host data cannot be "replicated")."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    multi = jax.process_count() > 1

    def put(x):
        if np.ndim(x) >= 1 and (np.shape(x)[0] * (jax.process_count() if multi else 1)) % n_dev == 0:
            sharding = data_sharding(mesh, np.ndim(x), axis)
            if multi:
                return jax.make_array_from_process_local_data(sharding, np.asarray(x))
            return jax.device_put(x, sharding)
        if multi:
            raise ValueError(
                f"multi-host batch dim {np.shape(x)[0]} x {jax.process_count()} processes "
                f"does not divide the {n_dev}-device mesh; use drop_last=True"
            )
        return jax.device_put(x, replicated(mesh))

    return jax.tree.map(put, batch)
