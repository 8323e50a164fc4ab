"""Projected-memory guard: predict a step's device-memory footprint BEFORE running it.

XLA plans a compiled program's whole memory up front, and
``compiled.memory_analysis()`` exposes that plan. On the GPU a program that
does not fit fails to allocate when it runs — after the data pipeline has
started, possibly mid-epoch. Comparing the plan with the device's allocator
limit (``memory_stats()["bytes_limit"]``) refuses such a run at start-up
with a diagnosis and the levers that fix it (smaller batch, ``--remat``,
wider sharding). The reference cannot express this check at all (PyTorch
allocates lazily and fails mid-step).

Usage:
    report = hbm_report(jitted_fn, *args)        # AOT lower+compile
    check_hbm(report, force=..., label="train step")

Trainers run the analysis up front on the step they are about to run (the
one-off compile is the price of the guard; the persistent compilation cache
makes the step's own first compile a hit).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import jax


def device_hbm_capacity(device=None) -> Optional[int]:
    """Bytes the device's allocator may use, from its ``memory_stats()``
    (``bytes_limit``), or None when the backend reports no limit (CPU
    backends and the virtual test mesh)."""
    dev = jax.devices()[0] if device is None else device
    if dev.platform == "cpu":
        return None
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    return int(limit) if limit else None


def memory_analysis_of(compiled) -> Optional[Dict[str, int]]:
    """Extract XLA's static memory plan from a compiled executable.

    Returns sizes in bytes: ``temp`` (XLA scratch — activations, workspaces),
    ``arguments``, ``outputs``, ``aliased`` (donated-input bytes reused for
    outputs), and ``projected_peak`` = arguments + outputs + temp - aliased,
    the executable's whole-program live-set bound. The projected peak is what
    must fit in HBM alongside nothing else (jit programs own the chip).
    """
    try:
        ma = compiled.memory_analysis()
    except Exception:
        return None
    if ma is None:
        return None

    def g(name: str) -> int:
        return int(getattr(ma, name, 0) or 0)

    temp = g("temp_size_in_bytes")
    args_b = g("argument_size_in_bytes")
    out = g("output_size_in_bytes")
    alias = g("alias_size_in_bytes")
    peak = args_b + out + temp - alias
    return {
        "temp": temp,
        "arguments": args_b,
        "outputs": out,
        "aliased": alias,
        "projected_peak": peak,
    }


def hbm_report(jitted_fn, *args, **kwargs) -> Optional[Dict[str, Any]]:
    """AOT-compile ``jitted_fn`` for ``args`` and report projected peak device
    memory vs. capacity.

    Returns None when the backend exposes neither memory analysis nor a
    capacity (e.g. some CPU configurations); otherwise a dict with byte
    counts, ``capacity`` (None when unknown), and ``oversubscribed``
    (False when capacity is unknown).
    """
    try:
        compiled = jitted_fn.lower(*args, **kwargs).compile()
    except Exception:
        return None
    mem = memory_analysis_of(compiled)
    if mem is None:
        return None
    cap = device_hbm_capacity()
    mem["capacity"] = cap
    mem["oversubscribed"] = bool(cap is not None and mem["projected_peak"] > cap)
    return mem


def format_hbm_report(mem: Dict[str, Any], label: str = "step") -> str:
    gb = 1024.0**3
    cap = mem.get("capacity")
    cap_s = f"{cap / gb:.2f} GiB" if cap else "unknown"
    return (
        f"projected HBM for {label}: {mem['projected_peak'] / gb:.2f} GiB "
        f"(args {mem['arguments'] / gb:.2f} + outputs {mem['outputs'] / gb:.2f} "
        f"+ temps {mem['temp'] / gb:.2f} - donated {mem['aliased'] / gb:.2f}) "
        f"vs capacity {cap_s}"
    )


def guard_step(
    jitted_step,
    example_args,
    label: str = "train step",
    skip: bool = False,
    force: bool = False,
) -> Optional[Dict[str, Any]]:
    """One-call trainer guard: AOT-compile ``jitted_step`` at the given arg
    specs (``jax.ShapeDtypeStruct`` or concrete values) and refuse if XLA's
    static memory plan oversubscribes the device (``check_hbm`` semantics).

    No-op (returns None) when ``skip`` is set or when the backend has no
    known capacity — CPU backends and the virtual test mesh — so tests and
    CPU dry-runs never pay the compile. All four trainers share this exact
    sequence.
    """
    if skip or device_hbm_capacity() is None:
        return None
    mem = hbm_report(jitted_step, *example_args)
    check_hbm(mem, label=label, force=force)
    return mem


def check_hbm(
    mem: Optional[Dict[str, Any]],
    label: str = "step",
    force: bool = False,
    file=sys.stderr,
) -> None:
    """Print the projection; if it oversubscribes the device, refuse (raise
    SystemExit with the diagnosis) unless ``force``.

    The diagnosis names the fix levers: smaller batch, ``--remat``, wider
    sharding — the things a user can actually turn. A None report (backend
    without the analysis) is silently accepted.
    """
    if mem is None:
        return
    msg = format_hbm_report(mem, label)
    print(msg, file=file)
    if mem.get("oversubscribed"):
        advice = (
            f"{label}: projected peak exceeds device memory — the step would "
            "fail to allocate on the GPU. Lower --batch_size, enable --remat, "
            "or shard wider (--space_shards); pass --force_hbm to run anyway."
        )
        if force:
            print(f"WARNING (forced): {advice}", file=file)
        else:
            raise SystemExit(f"REFUSING: {advice}")
