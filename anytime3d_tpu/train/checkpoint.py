"""Checkpointing on NumPy, with per-submodule composability.

The reference checkpoints each Keras submodel separately and loses optimizer
state on resume (nolbo.py:261-324, SURVEY.md §5). Here the FULL train state
(params + Adam moments + step) is saved as one checkpoint, while the
reference's cross-experiment composability (pull an ImageNet-pretrained
backbone or a 3D-AE-pretrained decoder into NOLBO, train_pascal.py:222-225)
is preserved by grafting named param subtrees between checkpoints —
submodule names are the param-tree keys (``backbone``, ``head``,
``encoder3d``, ``decoder``, ``prior_category``, ``prior_inst``).

Format: a checkpoint is a directory holding ``arrays.npz`` (every leaf,
keyed by its tree path, e.g. ``params/decoder/Conv_0/kernel``,
``opt_state/0/mu/...``) and ``meta.json`` (the step). A save writes a fresh
temporary directory and renames it into place, so a reader never sees a
half-written checkpoint.

Saves snapshot the state to host memory before they return; ``wait=False``
leaves the file writing to one background thread, which ``wait_for_saves``
(and the next save or restore) joins.

Several processes: every save and restore is collective. Arrays that no
process holds whole are gathered with ``process_allgather``, process 0
writes, and all processes meet at a barrier once the write is done. Restore
reads the shared file on every process and places each leaf with the
template's sharding.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Callable, Optional

import jax
import numpy as np
from jax.experimental import multihost_utils

from anytime3d_tpu.train.state import TrainState

_ARRAYS, _META = "arrays.npz", "meta.json"


def _key(path) -> str:
    return jax.tree_util.keystr(path, simple=True, separator="/")


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf``, whole on every process (never a view of a
    device buffer that a later donated step may reuse)."""
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        if leaf.is_fully_replicated:
            return np.array(leaf.addressable_data(0))
        return np.array(multihost_utils.process_allgather(leaf, tiled=True))
    return np.array(leaf)


def _snapshot(tree) -> dict:
    return {
        _key(path): _to_host(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _write(path: str, arrays: dict, meta: dict) -> None:
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp-{uuid.uuid4().hex}")
    os.makedirs(tmp)
    with open(os.path.join(tmp, _ARRAYS), "wb") as fh:
        np.savez(fh, **arrays)
    with open(os.path.join(tmp, _META), "w") as fh:
        json.dump(meta, fh)
    old = None
    if os.path.exists(path):
        old = os.path.join(parent, f".{os.path.basename(path)}.old-{uuid.uuid4().hex}")
        os.rename(path, old)
    os.rename(tmp, path)
    if old is not None:
        shutil.rmtree(old)


class _Writer:
    """One background writer; ``join`` re-raises a failed write."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._barrier_pending = False

    def start(self, fn: Optional[Callable[[], None]], barrier: bool) -> None:
        """Run ``fn`` (None on processes that do not write) in the
        background; with ``barrier`` the next ``join`` meets the other
        processes once the write is done."""
        self._barrier_pending = barrier
        if fn is None:
            return

        def run():
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — re-raised by join()
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-writer", daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_pending:
            self._barrier_pending = False
            multihost_utils.sync_global_devices("anytime3d_checkpoint_saved")
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from error


_WRITER = _Writer()


def wait_for_saves() -> None:
    """Block until every pending async save has committed to disk."""
    _WRITER.join()


def _save(path: str, tree: Any, meta: dict, wait: bool) -> None:
    wait_for_saves()  # saves serialize: one write in flight at a time
    arrays = _snapshot(tree)
    _WRITER.start(
        (lambda: _write(path, arrays, meta)) if jax.process_index() == 0 else None,
        barrier=jax.process_count() > 1,
    )
    if wait:
        wait_for_saves()


def save_state(path: str, state: TrainState, *, wait: bool = True) -> None:
    """Save the full train state (params + optimizer + step).

    ``wait=False`` returns after the device->host snapshot; the write and
    rename finish on a background thread (fence with ``wait_for_saves``).
    Collective when several processes run."""
    tree = {"params": state.params, "opt_state": state.opt_state}
    _save(path, tree, {"step": int(_to_host(state.step))}, wait)


def _read(path: str):
    wait_for_saves()  # the checkpoint may still be committing in background
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as fh:
        meta = json.load(fh)
    with np.load(os.path.join(path, _ARRAYS)) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, meta


def _place(value: np.ndarray, like):
    """``value`` as ``like`` holds its data: a jax.Array with the same
    sharding, or a host array."""
    if isinstance(like, jax.Array):
        value = np.asarray(value, like.dtype)
        return jax.make_array_from_callback(value.shape, like.sharding, lambda i: value[i])
    return np.asarray(value, getattr(like, "dtype", None))


def _restore_tree(arrays: dict, template, prefix: str = ""):
    def leaf(path, like):
        key = prefix + _key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint has no array {key!r}")
        value = arrays[key]
        if value.shape != tuple(np.shape(like)):
            raise ValueError(
                f"shape mismatch at {key}: checkpoint {value.shape} vs model {np.shape(like)}"
            )
        return _place(value, like)

    return jax.tree_util.tree_map_with_path(leaf, template)


def restore_state(path: str, state: TrainState) -> TrainState:
    """Restore a full train state; ``state`` provides the pytree structure
    (and shardings, when its leaves are sharded arrays)."""
    arrays, meta = _read(path)
    restored = _restore_tree(arrays, {"params": state.params, "opt_state": state.opt_state})
    return state.replace(
        params=restored["params"],
        opt_state=restored["opt_state"],
        step=_place(np.asarray(meta["step"]), state.step),
    )


def save_params(path: str, params: Any) -> None:
    """Save bare params (inference export)."""
    _save(path, {"params": params}, {"step": None}, wait=True)


def restore_params(path: str, params_template: Any) -> Any:
    arrays, _ = _read(path)
    return _restore_tree(arrays, params_template, prefix="params/")


def graft_submodule(
    state: TrainState,
    donor_path: str,
    submodule: str,
    donor_submodule: Optional[str] = None,
    reset_opt_state: bool = True,
) -> TrainState:
    """Load one submodule's params from another experiment's checkpoint.

    ``submodule``: top-level key in this model's param tree (e.g. 'backbone',
    'decoder'). ``donor_submodule``: key in the donor checkpoint (defaults to
    the same name) — e.g. graft a Classifier's 'backbone' into a NOLBO model.
    Shapes must match; a mismatch raises with the offending path. Optimizer
    moments are reset by default (they refer to the old params).
    """
    donor_submodule = donor_submodule or submodule
    if submodule not in state.params:
        raise KeyError(f"model has no submodule {submodule!r}; has {list(state.params)}")
    arrays, _ = _read(donor_path)
    donor_names = sorted({k.split("/")[1] for k in arrays if k.startswith("params/")})
    if donor_submodule not in donor_names:
        raise KeyError(
            f"donor checkpoint has no submodule {donor_submodule!r}; has {donor_names}"
        )
    grafted = _restore_tree(
        arrays, state.params[submodule], prefix=f"params/{donor_submodule}/"
    )
    new_params = dict(state.params)
    new_params[submodule] = grafted
    state = state.replace(params=new_params)
    if reset_opt_state:
        state = state.replace(opt_state=state.tx.init(state.params))
    return state
