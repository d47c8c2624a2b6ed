"""Checkpoint/resume for inverse-rendering optimization runs.

The reference checkpoints exactly one artifact — the built kd-tree, as raw
structs next to the OBJ (src/kd_tree.c:239-274; our portable analogue is
scene/cache.py). Optimization runs add mutable state worth persisting:
scene parameters + optimizer state + step counter.

Layout: one `step_<N>.npz` per step under the checkpoint directory,
holding the flattened pytree leaves (`leaf_<i>`) and the pickled treedef
(`treedef`). Restoring onto a template unflattens with the template's own
structure and places each leaf like the template's leaf, so the treedef
is only unpickled when no template is given — and only from files this
module wrote.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

_STEP_FILE = re.compile(r"^step_(\d+)\.npz$")


def _steps(path: str) -> list:
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                os.listdir(path)) if m)


def _step_path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.npz")


def save_train_state(path: str, step: int, params: Any, opt_state: Any,
                     max_to_keep: int = 3) -> None:
    """Persist {params, opt_state} at `step` under `path`, keeping the
    newest `max_to_keep` steps."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves, treedef = jax.tree.flatten(
        {"params": params, "opt_state": opt_state})
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["treedef"] = np.frombuffer(pickle.dumps(treedef), np.uint8)
    final = _step_path(path, step)
    tmp = final + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, final)  # a crash mid-write leaves no partial step
    for old in _steps(path)[:-max_to_keep]:
        os.remove(_step_path(path, old))


def restore_train_state(path: str, step: Optional[int] = None,
                        template: Any = None):
    """Restore (step, {params, opt_state}); latest step when unspecified.

    template: matching pytree of arrays (structure, shapes, shardings) —
    pass the freshly-initialized state to restore onto the right devices.
    """
    path = os.path.abspath(path)
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    with np.load(_step_path(path, step)) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        saved_def = pickle.loads(z["treedef"].tobytes()) \
            if template is None else None
    if template is None:
        return step, jax.tree.unflatten(saved_def, leaves)
    t_leaves, t_def = jax.tree.flatten(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"{len(t_leaves)}")
    placed = []
    for x, t in zip(leaves, t_leaves):
        if x.shape != np.shape(t):
            raise ValueError(f"leaf shape {x.shape} != template "
                             f"{np.shape(t)}")
        sharding = getattr(t, "sharding", None)
        placed.append(jax.device_put(x, sharding) if sharding is not None
                      else jnp.asarray(x))
    return step, jax.tree.unflatten(t_def, placed)
