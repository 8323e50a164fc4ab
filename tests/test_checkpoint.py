"""npz checkpoints (`core/checkpoint.py`): round trip, step layout, and
restore onto a sharded target."""

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from medical_image_segmentation_tpu.core.checkpoint import (
    latest_step,
    resolve_checkpoint_path,
    restore_checkpoint,
    save_checkpoint,
)
from medical_image_segmentation_tpu.core.struct import PyTreeNode
from medical_image_segmentation_tpu.parallel import make_mesh


class _State(PyTreeNode):
    step: jax.Array
    params: dict
    opt_state: tuple


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return _State(
        step=jnp.asarray(7, jnp.int32),
        params={"encoder": {"conv1": {"kernel": jnp.asarray(rng.normal(size=(3, 3, 1, 8)), jnp.float32)}},
                "head": {"bias": jnp.asarray(rng.normal(size=(16,)), jnp.float32)}},
        opt_state=(jnp.zeros((16,), jnp.float32), {"count": jnp.asarray(3, jnp.int32)}),
    )


def test_round_trip_with_and_without_target(tmp_path):
    state = _state()
    path = save_checkpoint(str(tmp_path / "ck"), state, 7)
    assert os.listdir(path) == ["state.npz"]  # the temporary file was renamed
    restored = restore_checkpoint(path, _state(seed=1))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tree = restore_checkpoint(path)
    assert int(tree["step"]) == 7
    assert tree["params"]["head"]["bias"].dtype == np.float32
    np.testing.assert_array_equal(tree["params"]["encoder"]["conv1"]["kernel"],
                                  np.asarray(state.params["encoder"]["conv1"]["kernel"]))
    assert int(tree["opt_state"][1]["count"]) == 3


def test_latest_step_and_resolve(tmp_path):
    root = str(tmp_path / "ck")
    assert latest_step(root) is None
    for step in (1, 3, 2):
        save_checkpoint(root, _state(), step)
    assert latest_step(root) == 3
    assert resolve_checkpoint_path(root) == os.path.join(root, "3")
    assert resolve_checkpoint_path(os.path.join(root, "2") + "/") == os.path.join(root, "2")


def test_restore_onto_mesh_shardings(tmp_path):
    mesh = make_mesh()  # the 8-device CPU test mesh
    assert mesh.size == 8
    rows = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    big = {"w": jnp.arange(64.0).reshape(16, 4), "b": jnp.ones((4,))}
    path = save_checkpoint(str(tmp_path / "ck"), jax.device_put(big, {"w": rows, "b": rep}), 1)
    target = {"w": jax.ShapeDtypeStruct((16, 4), jnp.float32, sharding=rows),
              "b": jax.ShapeDtypeStruct((4,), jnp.float32, sharding=rep)}
    restored = restore_checkpoint(path, target)
    assert restored["w"].sharding == rows and restored["b"].sharding == rep
    assert len(restored["w"].addressable_shards) == 8
    assert restored["w"].addressable_shards[1].data.shape == (2, 4)
    np.testing.assert_array_equal(np.asarray(restored["w"]), np.asarray(big["w"]))


def test_resume_skips_a_save_cut_short(tmp_path):
    """A process killed while writing step 3 leaves ``3/.state.npz.tmp`` and
    no ``state.npz``: resuming picks step 2, and saving step 3 again works."""
    root = str(tmp_path / "ck")
    for step in (1, 2):
        save_checkpoint(root, _state(), step)
    os.makedirs(os.path.join(root, "3"))
    with open(os.path.join(root, "3", ".state.npz.tmp"), "wb") as f:
        f.write(b"PK\x03\x04 cut short")
    assert latest_step(root) == 2
    assert resolve_checkpoint_path(root) == os.path.join(root, "2")
    save_checkpoint(root, _state(), 3)
    assert latest_step(root) == 3
    assert int(restore_checkpoint(os.path.join(root, "3"))["step"]) == 7
