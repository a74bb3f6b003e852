"""The pretrain loop: epochs, validation, checkpoints, resume, result.csv.

Counterpart of ``avsiam_tpu/train/loops.py``'s ``_MetricWindow``,
``_epoch_loader``, ``run_pretrain``, ``validate_pretrain``,
``_latest_train_state_epoch``, ``_write_csv``, ``_read_csv`` and
``_resume_history``, with the same semantics (traintest_cavmae_base.py:
29-264): the per-step two-pass update, loss meters and per-sample timing,
the NaN abort, validation every ``val_interval`` epochs and at the last,
``best_audio_model``, the ``save_model`` gate, ``train_state.{e}`` every
``train_state_every`` epochs pruned to ``keep_train_states``,
``result.csv``, ``progress.pkl``, and resume with its history and the
plateau scheduler replayed.

On the card the step is ``make_graphed_pretrain_step`` (one CUDA graph a
step; the restore of ``--resume`` comes before its first call, which binds
the state), on the CPU ``make_pretrain_step``. Step n's masks come from
``step_generator(cfg.seed, n)``, keyed on the state's step count, so a
resumed run takes the masks the straight run takes; epoch e's loader draws
from a seed keyed on (seed, e), the counterpart of ``fold_in(rng,
epoch)``. Validation runs the same model eagerly between the graph's
replays. The per-epoch linear probe needs the finetune model, which the
port does not have yet: ``run_pretrain`` refuses probe datasets.
"""

from __future__ import annotations

import csv
import json
import math
import os
import pickle
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from avsiam_tpu_torch.configs import PretrainConfig
from avsiam_tpu_torch.data.dataset import (AVDataset, make_eval_transform,
                                           make_train_transform)
from avsiam_tpu_torch.data.pipeline import batch_generator_seed, device_loader
from avsiam_tpu_torch.data.samplers import (batched, eval_shard_indices,
                                            shuffled_epoch_indices,
                                            weighted_indices)
from avsiam_tpu_torch.device import resolve_device
from avsiam_tpu_torch.eval.metrics import AverageMeter
from avsiam_tpu_torch.train import pretrain as pt
from avsiam_tpu_torch.utils.checkpoint import (prune_train_states,
                                               restore_train_state,
                                               save_params, save_train_state,
                                               train_state_epochs)
from avsiam_tpu_torch.utils.logging import MetricsLogger

_METER_KEYS = ("loss", "loss_mae_a", "loss_mae_v", "loss_c")


def _fetch(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as floats, with one device sync."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


class _MetricWindow:
    """Per-step metric sums kept on the device between print points.

    The reference updates its loss meters and checks for NaN at every step
    (traintest_cavmae_base.py:160-186). Fetching each step would stall the
    host on the device every step; the sums stay on the device (one small
    add a metric a step) and are fetched at the print cadence, so the
    meters still cover every step, and a NaN, which poisons its sum, aborts
    within one print window."""

    def __init__(self):
        self._sums: Optional[Dict[str, torch.Tensor]] = None
        self.steps = 0
        self.samples = 0
        self.data_time = 0.0
        self._start = time.time()

    def push(self, metrics: Dict[str, torch.Tensor], batch_size: int,
             data_t: float):
        m = {k: v.detach().float() for k, v in metrics.items()}
        self._sums = m if self._sums is None else {
            k: self._sums[k] + m[k] for k in self._sums}
        self.steps += 1
        self.samples += batch_size
        self.data_time += data_t

    def flush(self):
        """Fetch the window: (per-step averages, timing dict) or (None, {})."""
        if self.steps == 0:
            return None, {}
        sums = _fetch(self._sums)
        elapsed = time.time() - self._start
        avg = {k: v / self.steps for k, v in sums.items()}
        timing = {"elapsed": elapsed, "data": self.data_time,
                  "samples": self.samples}
        self._sums, self.steps, self.samples, self.data_time = None, 0, 0, 0.0
        self._start = time.time()
        return avg, timing


def _epoch_loader(ds: AVDataset, cfg_batch: int, epoch: int, seed: int,
                  transform, draw_seed: int, weights=None,
                  frames_per_sample: int = 1, device="cuda",
                  train: bool = True):
    """Epoch ``epoch``'s batches of ``ds`` through ``device_loader``.

    Train: the epoch's shuffled (or, with ``weights``, balanced) indices in
    batches of ``cfg_batch``, the last partial batch dropped, with their
    epoch positions, which key each sample's host stream; batch i's draws
    come from a generator keyed on (``draw_seed``, i). Eval: the indices in
    order, padded to a batch multiple by repeating the last one (every
    batch one shape, and the averages those of the JAX loop). One process:
    ranks come with the multi-card module."""
    n = len(ds)
    if train:
        if weights is not None:
            idx, pos = weighted_indices(weights, n, epoch, seed,
                                        global_batch=cfg_batch,
                                        with_positions=True)
        else:
            idx, pos = shuffled_epoch_indices(n, epoch, seed,
                                              global_batch=cfg_batch,
                                              with_positions=True)
        return device_loader(ds, batched(idx, cfg_batch, drop_last=True),
                             transform, draw_seed, seed=seed + epoch,
                             frames_per_sample=frames_per_sample,
                             device=device, train=True,
                             position_batches=batched(pos, cfg_batch,
                                                      drop_last=True))
    idx = eval_shard_indices(n)
    rem = len(idx) % cfg_batch
    if rem:
        idx = np.concatenate([idx, np.full(cfg_batch - rem, idx[-1])])
    return device_loader(ds, batched(idx, cfg_batch, drop_last=False),
                         transform, draw_seed, seed=seed + epoch,
                         frames_per_sample=frames_per_sample, device=device,
                         train=False)


def _latest_train_state_epoch(exp_dir: str) -> Optional[int]:
    epochs = train_state_epochs(exp_dir)
    return epochs[-1] if epochs else None


def run_pretrain(cfg: PretrainConfig, train_ds: AVDataset,
                 val_ds: Optional[AVDataset] = None,
                 probe_train_ds: Optional[AVDataset] = None,
                 probe_val_ds: Optional[AVDataset] = None,
                 probe_n_class: int = 527, init_params=None,
                 balance_weights=None,
                 max_steps_per_epoch: Optional[int] = None,
                 resume: bool = False, log: Callable = print,
                 device="cuda") -> Dict:
    """Pretrain for ``cfg.n_epochs`` epochs on ``device`` (the card unless
    the caller passes 'cpu'). ``init_params``: a state_dict to start from
    (a ``--resume`` restore still overrides it). Returns {"state",
    "best_epoch", "rows", "model", "timing"}, or {"diverged": True,
    "epoch"} after a NaN; "timing" holds the restore's seconds and, per
    epoch, its steps, the meters' per-sample times, the seconds spent
    validating and its batches, and each checkpoint save's seconds."""
    if probe_train_ds is not None or probe_val_ds is not None:
        raise NotImplementedError(
            "the per-epoch linear probe needs the finetune model, which the "
            "port does not have yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = pt.init_state(cfg, gen, dev)
    if init_params is not None:
        state.model.load_state_dict(init_params)
    timing = {"restore_s": None, "epochs": []}
    start_epoch = 1
    if resume:
        latest = _latest_train_state_epoch(cfg.exp_dir)
        if latest is not None:
            t0 = time.time()
            restore_train_state(cfg.exp_dir, f"train_state.{latest}", state)
            timing["restore_s"] = time.time() - t0
            start_epoch = latest + 1
            log(f"resumed from epoch {latest}")
    # the graph binds the state at its first call: after the restore
    step_fn = (pt.make_graphed_pretrain_step(cfg) if dev.type == "cuda"
               else pt.make_pretrain_step(cfg))
    eval_fn = pt.make_eval_step(cfg)
    transform = make_train_transform(cfg.audio,
                                     im_res=cfg.model.vit.img_size)

    os.makedirs(os.path.join(cfg.exp_dir, "models"), exist_ok=True)
    mlog = MetricsLogger(cfg.exp_dir)
    try:
        result_rows, progress = _resume_history(cfg.exp_dir, start_epoch)
        start_time = time.time()
        best_loss, best_epoch = np.inf, 0
        for r in result_rows:  # the best-ckpt decision state on resume
            if r.get("eval_loss", np.inf) < best_loss:
                best_loss, best_epoch = r["eval_loss"], int(r["epoch"])
        sched = None
        if cfg.opt.lr_adapt:
            # ReduceLROnPlateau stepped on -eval_loss after each epoch's
            # validation (traintest_cavmae_base.py:69-71,236-237), in place
            # of MultiStepLR; resume replays the restored epochs' metrics
            from avsiam_tpu_torch.train.optim import plateau_scheduler
            sched = plateau_scheduler(cfg.opt)
            for r in result_rows:
                if "eval_loss" in r:
                    sched.step(-r["eval_loss"])
            if val_ds is None:
                log("warning: --lr_adapt True without --data-val: the "
                    "plateau scheduler never sees a metric, so lr stays "
                    f"constant at {cfg.opt.lr} (MultiStepLR would still "
                    "decay on schedule)")
        meters = {k: AverageMeter() for k in
                  (*_METER_KEYS, "per_sample_time", "per_sample_data_time",
                   "per_sample_dnn_time")}
        global_step = state.step

        for epoch in range(start_epoch, cfg.n_epochs + 1):
            for meter in meters.values():  # per-epoch reset (ref. :256-264)
                meter.reset()
            lr = (sched.lr if sched is not None
                  else pt.lr_for_epoch(cfg, epoch))
            loader = _epoch_loader(train_ds, cfg.batch_size, epoch, cfg.seed,
                                   transform,
                                   batch_generator_seed(cfg.seed, epoch),
                                   weights=balance_weights, device=dev)

            def flush_window(win) -> Optional[Dict[str, float]]:
                avg, t = win.flush()
                if avg is None:
                    return None
                for k in _METER_KEYS:
                    meters[k].update(avg[k], t["samples"])
                meters["per_sample_time"].update(
                    t["elapsed"] / t["samples"], t["samples"])
                meters["per_sample_data_time"].update(
                    t["data"] / t["samples"], t["samples"])
                meters["per_sample_dnn_time"].update(
                    (t["elapsed"] - t["data"]) / t["samples"], t["samples"])
                return avg

            window = _MetricWindow()
            end_time = time.time()
            n_steps = 0
            try:
                for i, (a, v, _) in enumerate(loader):
                    if max_steps_per_epoch and i >= max_steps_per_epoch:
                        break
                    data_t = time.time() - end_time
                    state, metrics = step_fn(
                        state, (a, v), pt.step_generator(cfg.seed, state.step,
                                                         dev), lr)
                    window.push(metrics, a.shape[0], data_t)
                    n_steps += 1
                    if (global_step % cfg.n_print_steps == 0) or i == 0:
                        m = flush_window(window)
                        log(f"Epoch [{epoch}][{i}] loss {m['loss']:.4f} "
                            f"mae_a {m['loss_mae_a']:.4f} "
                            f"mae_v {m['loss_mae_v']:.4f} c {m['loss_c']:.4f} "
                            f"c_acc {m['c_acc']:.3f} t/sample "
                            f"{meters['per_sample_time'].avg * 1000:.1f}ms")
                        mlog.log({"epoch": epoch, **m}, step=global_step)
                        if math.isnan(meters["loss"].avg):
                            log("training diverged...")
                            return {"diverged": True, "epoch": epoch}
                    global_step += 1
                    end_time = time.time()
            finally:
                loader.close()
            # tail flush: epoch meters (and result.csv below) cover EVERY step
            flush_window(window)
            if math.isnan(meters["loss"].avg):
                log("training diverged...")
                return {"diverged": True, "epoch": epoch}

            row = {"epoch": epoch, "lr": lr,
                   **{k: meters[k].avg for k in _METER_KEYS}}
            saves = {}
            t_epoch = {"epoch": epoch, "steps": n_steps,
                       **{k: meters[k].avg for k in
                          ("per_sample_time", "per_sample_data_time",
                           "per_sample_dnn_time")},
                       "eval_s": 0.0, "eval_batches": 0, "saves": saves}
            # --val_interval: skipped epochs omit the eval_* columns entirely;
            # the final epoch always validates
            if val_ds is not None and (
                    epoch % max(cfg.val_interval, 1) == 0
                    or epoch == cfg.n_epochs):
                t0 = time.time()
                ev = validate_pretrain(eval_fn, state.model, val_ds, cfg,
                                       max_steps=max_steps_per_epoch,
                                       device=dev)
                t_epoch.update(eval_s=time.time() - t0,
                               eval_batches=ev.pop("batches"))
                row.update(ev)
                log(f"Eval epoch {epoch}: " + json.dumps(
                    {k: round(v, 5) for k, v in row.items()}))
                if row.get("eval_loss", np.inf) < best_loss:
                    best_loss, best_epoch = row["eval_loss"], epoch
                    _timed(saves, save_params, cfg.exp_dir,
                           "best_audio_model", state.model)
                if sched is not None and "eval_loss" in row:
                    sched.step(-row["eval_loss"])  # cavmae_base.py:236-237
            if cfg.save_model:  # traintest_cavmae_base.py:232
                _timed(saves, save_params, cfg.exp_dir,
                       f"audio_model.{epoch}", state.model)
            if (epoch % max(cfg.train_state_every, 1) == 0
                    or epoch == cfg.n_epochs):
                _timed(saves, save_train_state, cfg.exp_dir,
                       f"train_state.{epoch}", state)
                prune_train_states(cfg.exp_dir, cfg.keep_train_states)
            timing["epochs"].append(t_epoch)
            result_rows.append(row)
            mlog.log(row, step=global_step)
            _write_csv(os.path.join(cfg.exp_dir, "result.csv"), result_rows)
            # progress.pkl parity (traintest_cavmae_base.py:47-51)
            progress.append([epoch, global_step, best_epoch, best_loss,
                             time.time() - start_time])
            with open(os.path.join(cfg.exp_dir, "progress.pkl"), "wb") as f:
                pickle.dump(progress, f)
        return {"state": state, "best_epoch": best_epoch,
                "rows": result_rows, "model": state.model, "timing": timing}
    finally:
        mlog.close()


def _timed(saves: Dict[str, float], save, exp_dir: str, name: str, obj):
    """``save(exp_dir, name, obj)``, its seconds kept under ``name``."""
    t0 = time.time()
    save(exp_dir, name, obj)
    saves[name] = time.time() - t0


def validate_pretrain(eval_fn, model, val_ds: AVDataset, cfg: PretrainConfig,
                      max_steps: Optional[int] = None,
                      device="cuda") -> Dict:
    """The eval step over ``val_ds`` (padded to a batch multiple), batch i
    drawing from ``step_generator(None, i)``, the counterpart of
    ``PRNGKey(i)``: each metric's mean over the batches as ``eval_*``, and
    the number of batches as ``batches``."""
    transform = make_eval_transform(cfg.audio, im_res=cfg.model.vit.img_size,
                                    single_frame=True)
    loader = _epoch_loader(val_ds, cfg.batch_size, 0, cfg.seed, transform, 0,
                           device=device, train=False)
    sums, n = {}, 0
    try:
        for i, (a, v, _) in enumerate(loader):
            if max_steps and i >= max_steps:
                break
            m = _fetch(eval_fn(model, (a, v),
                               pt.step_generator(None, i, a.device)))
            for k, val in m.items():
                sums[k] = sums.get(k, 0.0) + val
            n += 1
    finally:
        loader.close()
    out = {f"eval_{k}": v / max(n, 1) for k, v in sums.items()}
    out["batches"] = n
    return out


def _write_csv(path: str, rows: List[Dict]):
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def _read_csv(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            row = {}
            for k, v in r.items():
                if v is None or v == "":
                    continue
                try:
                    fv = float(v)
                    row[k] = int(fv) if k == "epoch" else fv
                except ValueError:
                    row[k] = v
            out.append(row)
    return out


def _resume_history(exp_dir: str, start_epoch: int):
    """Reload prior epochs' result rows and progress so a resumed run
    appends to its history instead of rewriting result.csv/progress.pkl
    from empty (which would erase pre-crash epochs)."""
    if start_epoch <= 1:
        return [], []
    rows = [r for r in _read_csv(os.path.join(exp_dir, "result.csv"))
            if r.get("epoch", 0) < start_epoch]
    progress = []
    ppath = os.path.join(exp_dir, "progress.pkl")
    if os.path.exists(ppath):
        with open(ppath, "rb") as f:
            progress = [p for p in pickle.load(f) if p[0] < start_epoch]
    return rows, progress
