"""Checkpoint save and restore of the port.

Counterpart of ``avsiam_tpu/utils/checkpoint.py`` (``save_params``,
``restore_params``, ``restore_params_from_path``, ``average_checkpoints``,
``save_train_state``, ``restore_train_state``, ``prune_train_states``,
``transfer_pretrain_to_ft``), with the same names under
``{exp_dir}/models/``: ``audio_model.{e}``, ``best_audio_model`` and
``train_state.{e}``. Where the JAX package writes an orbax directory, the
port writes one file with ``torch.save``: a params file holds the model's
``state_dict``; a train state the model's ``state_dict``, each optimizer's
(``opt1`` and ``opt2`` of a pretrain state, ``opt`` of a finetune state)
and the step count. Each file is written under a hidden
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


def average_checkpoints(exp_dir: str, start_epoch: int, end_epoch: int
                        ) -> Dict[str, torch.Tensor]:
    """The uniform average of the ``audio_model.{e}`` params files for e in
    [start, end], accumulated in float64 in epoch order and returned in
    float32 on the CPU (wa_model, run_cavmae_ft_base.py:169-180)."""
    acc, n = None, 0
    for e in range(start_epoch, end_epoch + 1):
        sd = restore_params(exp_dir, f"audio_model.{e}", map_location="cpu")
        if acc is None:
            acc = {k: v.to(torch.float64) for k, v in sd.items()}
        else:
            for k in acc:
                acc[k] += sd[k].to(torch.float64)
        n += 1
    if n == 0:
        raise ValueError(f"no checkpoints in [{start_epoch}, {end_epoch}]")
    return {k: (v / n).to(torch.float32) for k, v in acc.items()}


def save_train_state(exp_dir: str, name, state) -> str:
    """Save a train state for resume: the model's ``state_dict``, each of
    ``state.optimizers()``'s under its name, and ``step``."""
    return _save({"model": state.model.state_dict(),
                  **{k: o.state_dict() for k, o in state.optimizers().items()},
                  "step": int(state.step)}, _path(exp_dir, name))


def restore_train_state(exp_dir: str, name, state):
    """Load a train state into ``state`` in place and return it.

    The parameters are copied into the model's own tensors, so their
    addresses stay. Each group keeps reading its own learning-rate tensor
    (the pretrain state's two Adams share one): ``Optimizer.
    load_state_dict`` replaces each group with the saved one, its ``lr``
    included, so after the load each group is pointed back at the tensor
    it read before, which takes the saved rate. Restore before a graphed
    step's first call: the capture binds the state's tensors."""
    device = next(state.model.parameters()).device
    saved = _load(_path(exp_dir, name), map_location=device)
    state.model.load_state_dict(saved["model"])
    for key, opt in state.optimizers().items():
        lrs = [group["lr"] for group in opt.param_groups]
        opt.load_state_dict(saved[key])
        for group, lr, was in zip(opt.param_groups, lrs,
                                  saved[key]["param_groups"], strict=True):
            group["lr"] = lr
            lr.fill_(float(was["lr"]))
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



def transfer_pretrain_to_ft(pretrain: Dict[str, torch.Tensor],
                            ft: Dict[str, torch.Tensor],
                            refresh_fusion: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """A finetune model's state_dict with a pretrain state_dict's weights.

    The ``vit`` trunk comes from ``pretrain``; ``mm_layer_1/2`` too where it
    has them (the reference's non-strict load, run_cavmae_ft_base.py:
    248-257), or with ``refresh_fusion`` as copies of the transferred
    trunk's last two blocks (``__create_fusion__``, cav_mae_base.py:
    823-825). Everything else keeps ``ft``'s values."""
    out = {k: v for k, v in ft.items() if not k.startswith("vit.")}
    out.update({k: v for k, v in pretrain.items() if k.startswith("vit.")})
    if refresh_fusion:
        depth = 1 + max(int(k.split(".")[2]) for k in out
                        if k.startswith("vit.blocks."))
        for i, name in ((depth - 2, "mm_layer_1"), (depth - 1, "mm_layer_2")):
            src = f"vit.blocks.{i}."
            out.update({f"{name}.{k[len(src):]}": v.clone()
                        for k, v in out.items() if k.startswith(src)})
    elif any(k.startswith("mm_layer_1.") for k in pretrain):
        out.update({k: v for k, v in pretrain.items()
                    if k.startswith(("mm_layer_1.", "mm_layer_2."))})
    return {k: out[k] for k in ft}
