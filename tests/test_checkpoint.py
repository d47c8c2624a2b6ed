"""Checkpoint/resume round-trip for optimization state (diff/checkpoint.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from clpathtracer_tpu.diff.checkpoint import (
    restore_train_state, save_train_state)


def test_roundtrip(tmp_path):
    params = {"verts": jnp.arange(12.0).reshape(4, 3),
              "albedo": jnp.full((2, 3), 0.5)}
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    path = str(tmp_path / "ckpt")
    save_train_state(path, step=7, params=params, opt_state=opt_state)

    template = {"params": params, "opt_state": opt_state}
    step, restored = restore_train_state(path, template=template)
    assert step == 7
    np.testing.assert_array_equal(np.asarray(restored["params"]["verts"]),
                                  np.asarray(params["verts"]))
    leaves_a = jax.tree.leaves(restored["opt_state"])
    leaves_b = jax.tree.leaves(opt_state)
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_max_to_keep(tmp_path):
    params = {"w": jnp.zeros((2,))}
    opt_state = optax.sgd(0.1).init(params)
    path = str(tmp_path / "ckpt")
    for s in range(5):
        save_train_state(path, step=s, params=params, opt_state=opt_state,
                         max_to_keep=2)
    step, _ = restore_train_state(
        path, template={"params": params, "opt_state": opt_state})
    assert step == 4


def test_restore_without_template_and_by_step(tmp_path):
    params = {"w": jnp.arange(4.0)}
    opt_state = optax.adam(1e-2).init(params)
    path = str(tmp_path / "ckpt")
    for s in (1, 2):
        save_train_state(path, step=s, params={"w": params["w"] * s},
                         opt_state=opt_state)
    step, restored = restore_train_state(path)  # latest, saved treedef
    assert step == 2
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]),
                                  np.arange(4.0) * 2)
    assert (jax.tree.structure(restored["opt_state"])
            == jax.tree.structure(opt_state))
    step, restored = restore_train_state(path, step=1)
    assert step == 1
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]),
                                  np.arange(4.0))


def test_old_steps_are_deleted(tmp_path):
    import os
    params = {"w": jnp.zeros((2,))}
    opt_state = optax.sgd(0.1).init(params)
    path = tmp_path / "ckpt"
    for s in range(4):
        save_train_state(str(path), step=s, params=params,
                         opt_state=opt_state, max_to_keep=2)
    assert sorted(os.listdir(path)) == ["step_2.npz", "step_3.npz"]


def test_missing_and_mismatched(tmp_path):
    import pytest
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "none"))
    params = {"w": jnp.zeros((2,))}
    opt_state = optax.sgd(0.1).init(params)
    path = str(tmp_path / "ckpt")
    save_train_state(path, step=0, params=params, opt_state=opt_state)
    with pytest.raises(ValueError):
        restore_train_state(path, template={
            "params": {"w": jnp.zeros((3,))}, "opt_state": opt_state})
    with pytest.raises(ValueError):
        restore_train_state(path, template={
            "params": {"w": jnp.zeros((2,)), "b": jnp.zeros(1)},
            "opt_state": opt_state})


def test_restore_onto_template_sharding(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from clpathtracer_tpu.parallel import default_mesh
    mesh = default_mesh()
    sh = NamedSharding(mesh, P("rows"))
    params = {"w": jax.device_put(jnp.arange(8.0), sh)}
    opt_state = optax.sgd(0.1).init(params)
    path = str(tmp_path / "ckpt")
    save_train_state(path, step=3, params=params, opt_state=opt_state)
    _, restored = restore_train_state(
        path, template={"params": params, "opt_state": opt_state})
    assert restored["params"]["w"].sharding == sh
