"""Model checkpoints in the JAX package's pickle layout.

The JAX package's ``utils/checkpoint.py`` saves ``(params, p, round,
...)`` with orbax when it can and as ``{path}/state.pkl`` otherwise. This
port writes the pickle layout only, with the same keys and host numpy
values, so a checkpoint moves both ways: the JAX package's
``load_checkpoint`` reads one saved here, and a JAX checkpoint saved in
its pickle layout loads here. There is no orbax on the card: a
directory holding an orbax layout is refused with ``CheckpointError``,
never read around.

Keys: ``params`` (``{name: array}``), ``p``, ``round``, ``rff_W`` and
``rff_b`` (the setup's feature-map draw, for serving raw inputs), and
what ``extra`` adds — the round loop's resume state ``p_opt``,
``server_opt`` (tuples of arrays) and ``server_opt_kind`` — and
``feature_dtype``, the name of the features' storage dtype
(``"bfloat16"``; the JAX package's marker, ``utils/checkpoint.py:87-91``)
when the setup stored them narrow. A defended run's cross-round state
goes in the JAX package's layout (``utils/checkpoint.py:50-83``):
``reputation`` (the final per-client trust vector, float32) and
``defense_state`` (``{"zq": ...}``, ``quarantine:auto``'s threshold
estimate, float32). ``load_checkpoint`` returns them under those keys,
which is what the round loop's ``resume_from`` reads.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint exists at ``path`` but cannot be restored here: a
    truncated or corrupt ``state.pkl``, or an orbax layout. A missing
    checkpoint stays ``FileNotFoundError``."""

    def __init__(self, path: str, detail: str):
        self.path = path
        super().__init__(
            f"checkpoint at {path} could not be loaded: {detail}")


def _to_host(tree):
    """Tensors and arrays to numpy, through dicts, lists and tuples;
    Python scalars and strings kept as they are."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, (str, bool, int, float)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, params, p=None, round_idx: int | None = None,
                    extra: dict | None = None, rff=None,
                    feature_dtype=None, reputation=None,
                    defense_state: dict | None = None) -> str:
    """Save a model's state under the directory ``path`` as
    ``state.pkl``; returns that file's path. ``feature_dtype`` (a torch
    dtype or its name) is stored as its name, ``"bfloat16"``,
    ``"float16"`` or ``"float32"``, as the JAX package stores it.
    ``reputation`` (a rep-defended run's ``res["reputation"]``) and
    ``defense_state`` (``{"zq": res["zq"]}`` under ``quarantine:auto``)
    are stored as float32 arrays; without them a resumed run restarts
    every client at full trust and the threshold at its start. An orbax
    layout an earlier save left under ``path`` is removed first, since
    the JAX package's loader would prefer it to the fresh pickle."""
    state: dict[str, Any] = {"params": _to_host(params)}
    if p is not None:
        state["p"] = _to_host(p)
    if round_idx is not None:
        state["round"] = int(round_idx)
    if reputation is not None:
        state["reputation"] = np.asarray(_to_host(reputation), np.float32)
    if defense_state:
        state["defense_state"] = {k: np.asarray(_to_host(v), np.float32)
                                  for k, v in defense_state.items()}
    if rff is not None:
        state["rff_W"], state["rff_b"] = _to_host(rff[0]), _to_host(rff[1])
    if feature_dtype is not None:
        state["feature_dtype"] = str(feature_dtype).removeprefix("torch.")
    if extra:
        state.update({k: _to_host(v) for k, v in extra.items()})
    os.makedirs(path, exist_ok=True)
    stale = os.path.join(os.path.abspath(path), "orbax")
    shutil.rmtree(stale, ignore_errors=True)
    if os.path.isdir(stale):
        raise RuntimeError(
            f"stale orbax layout at {stale} could not be removed and would "
            "shadow the pickle in the JAX package's loader; remove it")
    out = os.path.join(path, "state.pkl")
    with open(out, "wb") as f:
        pickle.dump(state, f)
    return out


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint saved in the pickle layout (here or by the JAX
    package): the saved dict, ``reputation`` and ``defense_state``
    included where they were saved. ``CheckpointError`` names the file
    for a corrupt pickle and the layout for an orbax one; a missing
    checkpoint raises ``FileNotFoundError``."""
    orbax_dir = os.path.join(path, "orbax")
    if os.path.isdir(orbax_dir) or os.path.exists(
            os.path.join(path, "_CHECKPOINT_METADATA")):
        raise CheckpointError(
            path, "it holds an orbax layout, which this package does not "
            "read; save it again in the pickle layout (state.pkl)")
    pkl = os.path.join(path, "state.pkl")
    if not os.path.exists(pkl):
        raise FileNotFoundError(f"no checkpoint under {path}")
    try:
        with open(pkl, "rb") as f:
            return pickle.load(f)
    except Exception as e:  # truncated write, corrupt bytes, ...
        raise CheckpointError(pkl, f"{type(e).__name__}: {e}") from e
