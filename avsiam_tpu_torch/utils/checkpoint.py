"""Checkpoint save and restore of the port.

Counterpart of ``avsiam_tpu/utils/checkpoint.py`` (``save_params``,
``restore_params``, ``restore_params_from_path``, ``save_train_state``,
``restore_train_state``, ``prune_train_states``), with the same names under
``{exp_dir}/models/``: ``audio_model.{e}``, ``best_audio_model`` and
``train_state.{e}``. Where the JAX package writes an orbax directory, the
port writes one file with ``torch.save``: a params file holds the model's
``state_dict``; a train state the model's, ``opt1``'s and ``opt2``'s
``state_dict``s and the step count. Each file is written under a hidden
temporary name in the same directory and moved to its name with
``os.replace``, so a crash never leaves a half-written checkpoint under a
real name (orbax gives the JAX package the same guarantee).

Reading an orbax directory needs JAX, which the port does not import: a
directory where a file is expected is refused with an error that says so.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import torch

_TRAIN_STATE = re.compile(r"train_state\.(\d+)")


def _path(exp_dir: str, name) -> str:
    return os.path.join(os.path.abspath(exp_dir), "models", str(name))


def _save(obj, path: str) -> str:
    """``torch.save`` to a hidden temporary name beside ``path``, then
    ``os.replace`` onto it."""
    head, tail = os.path.split(path)
    os.makedirs(head, exist_ok=True)
    tmp = os.path.join(head, f".{tail}.tmp{os.getpid()}")
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load(path: str, map_location=None):
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package. "
            f"The port reads the files it writes with torch.save; reading "
            f"orbax needs JAX, which the port does not import")
    return torch.load(path, map_location=map_location, weights_only=True)


def save_params(exp_dir: str, name, model: torch.nn.Module) -> str:
    """Save the model's ``state_dict`` (e.g. 'audio_model.3' for epoch 3,
    'best_audio_model')."""
    return _save(model.state_dict(), _path(exp_dir, name))


def restore_params(exp_dir: str, name, map_location=None
                   ) -> Dict[str, torch.Tensor]:
    """A params file's ``state_dict``."""
    return _load(_path(exp_dir, name), map_location)


def restore_params_from_path(path: str, map_location=None
                             ) -> Dict[str, torch.Tensor]:
    """A params file's ``state_dict`` from its full path
    (``<exp>/models/<name>``)."""
    return _load(path, map_location)


def save_train_state(exp_dir: str, name, state) -> str:
    """Save a ``PretrainState`` for resume: the model's, ``opt1``'s and
    ``opt2``'s ``state_dict``s and ``step``."""
    return _save({"model": state.model.state_dict(),
                  "opt1": state.opt1.state_dict(),
                  "opt2": state.opt2.state_dict(),
                  "step": int(state.step)}, _path(exp_dir, name))


def restore_train_state(exp_dir: str, name, state):
    """Load a train state into ``state`` in place and return it.

    The parameters are copied into the model's own tensors, so their
    addresses stay. Both Adams keep reading one learning-rate tensor:
    ``Optimizer.load_state_dict`` replaces each group with the saved one,
    its ``lr`` included, so after the loads both groups are pointed back at
    ``state.lr``'s tensor, which takes the saved rate. Restore before a
    graphed step's first call: the capture binds the state's tensors."""
    device = next(state.model.parameters()).device
    saved = _load(_path(exp_dir, name), map_location=device)
    lr = state.lr
    state.model.load_state_dict(saved["model"])
    for key in ("opt1", "opt2"):
        opt = getattr(state, key)
        opt.load_state_dict(saved[key])
        for group in opt.param_groups:
            group["lr"] = lr
    lr.fill_(float(saved["opt1"]["param_groups"][0]["lr"]))
    state.step = int(saved["step"])
    return state


def train_state_epochs(exp_dir: str) -> List[int]:
    """The epochs of the ``train_state.{e}`` files under ``exp_dir/models``,
    in order."""
    mdir = os.path.join(exp_dir, "models")
    if not os.path.isdir(mdir):
        return []
    return sorted(int(m.group(1)) for n in os.listdir(mdir)
                  if (m := _TRAIN_STATE.fullmatch(n)))


def prune_train_states(exp_dir: str, keep: int) -> None:
    """Delete all but the ``keep`` newest ``train_state.{epoch}`` files
    under ``exp_dir/models``: resume reads only the newest. ``keep <= 0``
    keeps everything. Call from the main process only, after the epoch's
    save has completed."""
    if keep <= 0:
        return
    epochs = train_state_epochs(exp_dir)
    for e in epochs[:-keep] if keep < len(epochs) else []:
        path = _path(exp_dir, f"train_state.{e}")
        if os.path.isdir(path):  # an orbax directory is not the port's
            continue
        os.remove(path)

