"""Checkpointing + the SSL→segmentation encoder handoff.

A checkpoint is ``<dir>/<step>/state.npz``: the state's leaves, each keyed by
its pytree key path (``.params['encoder']['conv1']['kernel']``), written to
a temporary file and renamed into place. Restoring onto a target puts every
leaf on the target leaf's sharding; restoring without one gives nested dicts.

The reference delegates checkpointing to Lightning defaults (SURVEY §5.4)
and — notably — never loads the BYOL encoder into the U-Net
(`medical_image_segmentation/train/model/segmentation.py:54` builds with
``encoder_weights=None`` and nothing restores it). Here the handoff is a
first-class feature: ``load_byol_encoder_into_unet`` grafts the pretrained
backbone subtree (params + batch_stats) into the U-Net's ``encoder``
collection, with optional channel adaptation when the SSL backbone saw RGB
but the U-Net takes 1-channel CT slices.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

_STATE_FILE = "state.npz"
_PATH_TOKEN = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _flatten(state: Any) -> Dict[str, np.ndarray]:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


def _load(path: str) -> Dict[str, np.ndarray]:
    """{key path: leaf} of a checkpoint."""
    with np.load(os.path.join(os.path.abspath(path), _STATE_FILE)) as z:
        return {k: z[k] for k in z.files}


def save_checkpoint(ckpt_dir: str, state: Any, step: int) -> str:
    """Save a pytree checkpoint at ``<ckpt_dir>/<step>``.

    COLLECTIVE in multiprocess runs: every process must call this at the
    same program point with the global ``jax.Array`` state. The state is
    gathered onto every process, process 0 writes it, and all processes
    leave together."""
    path = os.path.join(os.path.abspath(ckpt_dir), str(step))
    multi = jax.process_count() > 1
    if multi:
        from jax.experimental import multihost_utils

        state = multihost_utils.process_allgather(state, tiled=True)
    if jax.process_index() == 0:
        arrays = _flatten(jax.device_get(state))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f".{_STATE_FILE}.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(path, _STATE_FILE))
    if multi:
        multihost_utils.sync_global_devices(f"save_checkpoint {path}")
    return path


def _nest(leaves: Dict[str, Any]) -> Dict[Any, Any]:
    """Key-path strings back to nested dicts (attribute names and dict keys
    become string keys, sequence indices int keys)."""
    root: Dict[Any, Any] = {}
    for name, value in leaves.items():
        keys = [a or b or int(c) for a, b, c in _PATH_TOKEN.findall(name)]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return root


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Restore a pytree checkpoint. With ``target`` (a pytree of arrays or
    ``jax.ShapeDtypeStruct``s), the result has its structure, dtypes and
    shardings; without one, nested dicts of host arrays."""
    leaves = _load(path)
    if target is None:
        return _nest(leaves)
    flat, treedef = jax.tree_util.tree_flatten_with_path(target)
    out = []
    for p, ref in flat:
        name = jax.tree_util.keystr(p)
        if name not in leaves:
            raise KeyError(f"checkpoint {path} has no leaf {name}")
        value = leaves[name]
        if value.shape != ref.shape:
            raise ValueError(f"{name}: checkpoint shape {value.shape} != target {ref.shape}")
        value = value.astype(ref.dtype)
        sharding = getattr(ref, "sharding", None)
        out.append(jax.device_put(value, sharding) if sharding is not None else jnp.asarray(value))
    return jax.tree_util.tree_unflatten(treedef, out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step under ``ckpt_dir`` whose ``state.npz`` is complete. A
    save cut short (the process killed mid-write) leaves a step directory
    without one, and the step before it is the one to resume from."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, _STATE_FILE))]
    return max(steps, default=None)


def resolve_checkpoint_path(path: str) -> str:
    """CLI convention shared by every predict/export entry point: ``path``
    is either a specific step directory (``…/ckpt/5``) or a checkpoint root,
    in which case the latest numeric step is picked. Normalizes first so a
    trailing slash on a step path doesn't mis-classify it as a root.
    Raises SystemExit with a clear message when the root holds no steps."""
    path = os.path.normpath(path)
    if os.path.isdir(path) and not os.path.basename(path).isdigit():
        step = latest_step(path)
        if step is None:
            raise SystemExit(f"no checkpoint steps under {path}")
        return os.path.join(path, str(step))
    return path


def _adapt_conv1(kernel: jax.Array, target_in: int, how: str = "sum") -> jax.Array:
    """Adapt a (kh, kw, cin, cout) stem kernel to ``target_in`` channels.

    ``sum`` collapses RGB→1 by summing input channels (preserves response to
    grayscale inputs replicated across RGB); ``tile`` broadcasts 1→N."""
    cin = kernel.shape[2]
    if cin == target_in:
        return kernel
    if target_in == 1:
        if how != "sum":
            raise ValueError(f"unsupported conv1 adaptation {how!r} for {cin}->1")
        return jnp.sum(kernel, axis=2, keepdims=True)
    if cin == 1:
        return jnp.tile(kernel, (1, 1, target_in, 1)) / target_in
    raise ValueError(f"cannot adapt conv1 from {cin} to {target_in} channels")


def extract_byol_backbone(byol_variables: Dict[str, Any]) -> Dict[str, Any]:
    """Pull the backbone subtree out of BYOLNet variables.

    BYOLNet params layout: ``params['encoder']['ResNet_0']`` is the backbone
    (`models/byol.py` — Encoder creates the ResNet as its first anonymous
    submodule), with matching ``batch_stats`` subtree."""
    out = {}
    for coll in ("params", "batch_stats"):
        if coll in byol_variables:
            out[coll] = byol_variables[coll]["encoder"]["ResNet_0"]
    return out


def load_byol3d_encoder_into_unet3d(
    unet_variables: Dict[str, Any],
    byol_variables: Dict[str, Any],
) -> Dict[str, Any]:
    """3D analogue of `load_byol_encoder_into_unet`: graft a volumetric-BYOL
    backbone (``Encoder(volumetric=True)`` → ``UNet3DEncoder``) into a
    ``UNet3D``'s parameter tree.

    ``UNet3DEncoder`` names its blocks exactly like UNet3D's encoder half
    (``enc{i}``/``down{i}``), so the graft is a per-block subtree copy at
    the top level (UNet3D has no nested "encoder" scope). Both sides must
    use the same norm (GroupNorm by default — shape mismatches raise)."""
    enc_key = "UNet3DEncoder_0"  # Encoder's first (auto-named) submodule
    new_vars = jax.tree.map(lambda x: x, unet_variables)  # shallow-copy tree
    for coll in ("params", "batch_stats"):
        if coll not in byol_variables or not byol_variables[coll]:
            continue
        src = byol_variables[coll].get("encoder", {}).get(enc_key, {})
        if not src:
            continue
        tgt_coll = dict(new_vars.get(coll, {}))
        mismatches = []
        for block, sub in src.items():
            if block not in tgt_coll:
                raise ValueError(f"UNet3D has no {coll} block {block!r} to graft into")

            def _check(path, a, b):
                if a.shape != b.shape:
                    mismatches.append((block + jax.tree_util.keystr(path), a.shape, b.shape))
                return b

            tgt_coll[block] = jax.tree_util.tree_map_with_path(_check, tgt_coll[block], sub)
        if mismatches:
            raise ValueError(f"3D encoder shape mismatches in {coll}: {mismatches}")
        new_vars[coll] = tgt_coll
    return new_vars


def load_byol_encoder_into_unet(
    unet_variables: Dict[str, Any],
    byol_variables: Dict[str, Any],
    adapt_channels: bool = True,
) -> Dict[str, Any]:
    """Return U-Net variables with the encoder subtree replaced by the
    pretrained BYOL backbone. Raises on any shape mismatch other than the
    stem's input-channel count (adapted when ``adapt_channels``)."""
    backbone = extract_byol_backbone(byol_variables)
    new_vars = jax.tree.map(lambda x: x, unet_variables)  # shallow-copy tree

    for coll, sub in backbone.items():
        tgt = new_vars[coll]["encoder"]
        if adapt_channels and coll == "params":
            tgt_kernel = tgt["conv1"]["kernel"]
            src_kernel = sub["conv1"]["kernel"]
            if src_kernel.shape != tgt_kernel.shape:
                sub = dict(sub)
                sub["conv1"] = {"kernel": _adapt_conv1(src_kernel, tgt_kernel.shape[2])}
        mismatches = []

        def _check(path, a, b):
            if a.shape != b.shape:
                mismatches.append((jax.tree_util.keystr(path), a.shape, b.shape))
            return b

        merged = jax.tree_util.tree_map_with_path(_check, tgt, sub)
        if mismatches:
            raise ValueError(f"encoder shape mismatches in {coll}: {mismatches}")
        new_vars[coll] = dict(new_vars[coll])
        new_vars[coll]["encoder"] = merged
    return new_vars
