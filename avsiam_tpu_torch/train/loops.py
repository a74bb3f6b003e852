"""The pretrain and finetune loops: epochs, validation, checkpoints,
resume, result.csv, the linear probe.

Counterpart of ``avsiam_tpu/train/loops.py``'s ``_MetricWindow``,
``_epoch_loader``, ``run_pretrain``, ``validate_pretrain``,
``run_finetune``, ``validate_ft``, ``linear_probe``, ``_np_sigmoid``,
``_np_bce``, ``_np_ce_soft``, ``_latest_train_state_epoch``,
``_write_csv``, ``_read_csv`` and ``_resume_history``, with the same
semantics. Pretraining (traintest_cavmae_base.py:29-264): the per-step
two-pass update, loss meters and per-sample timing, the NaN abort,
validation every ``val_interval`` epochs and at the last,
``best_audio_model``, the per-epoch linear probe, the ``save_model`` gate,
``train_state.{e}`` every ``train_state_every`` epochs pruned to
``keep_train_states``, ``result.csv``, ``progress.pkl``, and resume with
its history and the plateau scheduler replayed. Finetuning
(traintest_ft_base.py:29-290): the routed step, validation each epoch on
the 10-frame eval (sigmoid and frame mean on the host, then the
classification statistics), ``best_audio_model`` by mAP or accuracy, the
early stop after three epochs without a gain, ``stats_{e}.pickle``, the
checkpoint average (``wa``), and the same checkpoints, resume and
scheduler.

On the card the step is ``make_graphed_pretrain_step`` (one CUDA graph a
step; the restore of ``--resume`` comes before its first call, which binds
the state), on the CPU ``make_pretrain_step``. Step n's masks come from
``step_generator(cfg.seed, n)``, keyed on the state's step count, so a
resumed run takes the masks the straight run takes; epoch e's loader draws
from a seed keyed on (seed, e), the counterpart of ``fold_in(rng,
epoch)``. Validation runs the same model eagerly between the graph's
replays. The finetune step runs eagerly on either device
(``train/finetune.py``); step n's routing draw is keyed on (seed, n).

Under a process group (``parallel/dist.py``; the JAX loop's multi-process
parts, avsiam_tpu/train/loops.py:97-200,232-244,402-403,441-454,641-646,
684-689): each process loads its contiguous block of every global batch
(the samplers' ``world``/``rank``) and steps on it (the steps average the
gradients); rank 0's initial parameters are broadcast, and a resume
restores the same checkpoint on every process; validation runs each
process's contiguous slab of the set, the pretrain metrics averaged over
the processes and the finetune predictions gathered in rank order before
the statistics, so every checkpoint decision is the same on every process;
rank 0 alone writes the files (checkpoints, ``result.csv``,
``progress.pkl``, the stats pickles, the metrics log), and a barrier
follows each epoch's writes. The graphed pretrain step over more than one
process takes the 'padded' form; the other forms step eagerly there.
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

from avsiam_tpu_torch.configs import (CAVMAEFTConfig, FinetuneConfig,
                                      PretrainConfig, replace)
from avsiam_tpu_torch.data.dataset import (AVDataset, make_eval_transform,
                                           make_train_transform)
from avsiam_tpu_torch.data.pipeline import batch_generator_seed, device_loader
from avsiam_tpu_torch.data.samplers import (batched, eval_shard_indices,
                                            shuffled_epoch_indices,
                                            weighted_indices)
from avsiam_tpu_torch.device import resolve_device
from avsiam_tpu_torch.eval.metrics import (AverageMeter, calculate_stats,
                                           mean_ap, mean_auc)
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.parallel.mesh import local_batch
from avsiam_tpu_torch.train import finetune as ft
from avsiam_tpu_torch.train import pretrain as pt
from avsiam_tpu_torch.utils.checkpoint import (average_checkpoints,
                                               prune_train_states,
                                               restore_train_state,
                                               save_params, save_train_state,
                                               train_state_epochs,
                                               transfer_pretrain_to_ft)
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
    batch one shape, and the averages those of the JAX loop). Under a
    process group: train, this process's contiguous block of each global
    batch of ``cfg_batch``; eval, its contiguous slab of the set, in
    batches of ``cfg_batch``."""
    n = len(ds)
    world, rank = pdist.world_size(), pdist.rank()
    if train:
        local = local_batch(cfg_batch, world)
        if weights is not None:
            idx, pos = weighted_indices(weights, n, epoch, seed, world=world,
                                        rank=rank, global_batch=cfg_batch,
                                        with_positions=True)
        else:
            idx, pos = shuffled_epoch_indices(n, epoch, seed, world=world,
                                              rank=rank,
                                              global_batch=cfg_batch,
                                              with_positions=True)
        return device_loader(ds, batched(idx, local, drop_last=True),
                             transform, draw_seed, seed=seed + epoch,
                             frames_per_sample=frames_per_sample,
                             device=device, train=True,
                             position_batches=batched(pos, local,
                                                      drop_last=True))
    idx = eval_shard_indices(n, world, rank)
    rem = len(idx) % cfg_batch
    if rem:
        idx = np.concatenate([idx, np.full(cfg_batch - rem, idx[-1])])
    return device_loader(ds, batched(idx, cfg_batch, drop_last=False),
                         transform, draw_seed, seed=seed + epoch,
                         frames_per_sample=frames_per_sample, device=device,
                         train=False)


def _replicate(model: torch.nn.Module) -> None:
    """Under a process group, rank 0's parameters and buffers on every
    process."""
    if pdist.active():
        pdist.broadcast_from_main_([*model.parameters(), *model.buffers()])


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
    validating and its batches, and each checkpoint save's seconds. With
    both probe datasets each epoch ends with ``linear_probe`` of the
    epoch's parameters (traintest_cavmae_base.py:250-252), its results in
    the row as ``probe_*``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = pt.init_state(cfg, gen, dev)
    if init_params is not None:
        state.model.load_state_dict(init_params)
    _replicate(state.model)
    main = pdist.is_main_process()
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
    # the graph binds the state at its first call: after the restore; over
    # more than one process it holds the 'padded' form only, whose shapes
    # do not change from step to step
    graphed = dev.type == "cuda" and (pdist.world_size() == 1 or
                                      cfg.model.mmixed_impl == "padded")
    step_fn = (pt.make_graphed_pretrain_step(cfg) if graphed
               else pt.make_pretrain_step(cfg))
    eval_fn = pt.make_eval_step(cfg)
    transform = make_train_transform(cfg.audio,
                                     im_res=cfg.model.vit.img_size)

    if main:
        os.makedirs(os.path.join(cfg.exp_dir, "models"), exist_ok=True)
    mlog = MetricsLogger(cfg.exp_dir, main_process=main)
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
                    if main:
                        _timed(saves, save_params, cfg.exp_dir,
                               "best_audio_model", state.model)
                if sched is not None and "eval_loss" in row:
                    sched.step(-row["eval_loss"])  # cavmae_base.py:236-237
            if probe_train_ds is not None and probe_val_ds is not None:
                probe = linear_probe(state.model.state_dict(), cfg,
                                     probe_train_ds, probe_val_ds,
                                     n_class=probe_n_class,
                                     max_steps_per_epoch=max_steps_per_epoch,
                                     log=log, device=dev)
                row.update({f"probe_{k}": v for k, v in probe.items()})
            if main and cfg.save_model:  # traintest_cavmae_base.py:232
                _timed(saves, save_params, cfg.exp_dir,
                       f"audio_model.{epoch}", state.model)
            if main and (epoch % max(cfg.train_state_every, 1) == 0
                         or epoch == cfg.n_epochs):
                _timed(saves, save_train_state, cfg.exp_dir,
                       f"train_state.{epoch}", state)
                prune_train_states(cfg.exp_dir, cfg.keep_train_states)
            timing["epochs"].append(t_epoch)
            result_rows.append(row)
            mlog.log(row, step=global_step)
            # progress.pkl parity (traintest_cavmae_base.py:47-51)
            progress.append([epoch, global_step, best_epoch, best_loss,
                             time.time() - start_time])
            if main:
                _write_csv(os.path.join(cfg.exp_dir, "result.csv"),
                           result_rows)
                with open(os.path.join(cfg.exp_dir, "progress.pkl"),
                          "wb") as f:
                    pickle.dump(progress, f)
            pdist.barrier("pretrain-epoch")
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
    ``PRNGKey(i)``: each metric's mean over the batches as ``eval_*``
    (under a process group, each process's over its slab, averaged over
    the processes), and the number of batches as ``batches``."""
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
    out = pdist.average_across_processes(
        {f"eval_{k}": v / max(n, 1) for k, v in sums.items()})
    out["batches"] = n
    return out


# ---------------------------------------------------------------------------
# Finetuning
# ---------------------------------------------------------------------------

def run_finetune(cfg: FinetuneConfig, train_ds: AVDataset,
                 val_ds: Optional[AVDataset] = None, init_params=None,
                 balance_weights=None,
                 max_steps_per_epoch: Optional[int] = None, wa: bool = False,
                 wa_start: int = 1, wa_end: int = 5, resume: bool = False,
                 log: Callable = print, device="cuda") -> Dict:
    """Finetune for ``cfg.n_epochs`` epochs on ``device`` (the card unless
    the caller passes 'cpu'). ``init_params``: a state_dict to start from
    (a ``--resume`` restore still overrides it). Returns {"state",
    "best_epoch", "best", "rows", "model", "timing"} and, with ``wa``,
    "wa_params", the average of the epochs' ``audio_model.{e}`` in
    [wa_start, min(wa_end, last epoch)]; or {"diverged": True, "epoch"}
    after a NaN. "timing" holds the restore's seconds, the average's, and
    per epoch its steps, each branch's steps, the meters' per-sample
    times, the seconds spent validating and its batches, and each
    checkpoint save's seconds."""
    if wa and not cfg.save_model:
        # before training: averaging reads the per-epoch audio_model.{e}
        # checkpoints (run_cavmae_ft_base.py:169-180) that --save_model
        # False never writes
        raise ValueError("--wa True requires --save_model True (weight "
                         "averaging reads the per-epoch checkpoints)")
    dev = resolve_device(device)
    state = ft.init_state(cfg, torch.Generator(device=dev).manual_seed(
        cfg.seed), dev)
    if init_params is not None:
        state.model.load_state_dict(init_params)
    _replicate(state.model)
    main = pdist.is_main_process()
    timing = {"restore_s": None, "wa_s": None, "epochs": []}
    start_epoch = 1
    if resume:
        latest = _latest_train_state_epoch(cfg.exp_dir)
        if latest is not None:
            t0 = time.time()
            restore_train_state(cfg.exp_dir, f"train_state.{latest}", state)
            timing["restore_s"] = time.time() - t0
            start_epoch = latest + 1
            log(f"resumed from epoch {latest}")
    step_fn = ft.make_finetune_step(cfg)
    eval_fn = ft.make_ft_eval_step(cfg)
    transform = make_train_transform(cfg.audio,
                                     im_res=cfg.model.vit.img_size)

    if main:
        os.makedirs(os.path.join(cfg.exp_dir, "models"), exist_ok=True)
    mlog = MetricsLogger(cfg.exp_dir, main_process=main)
    try:
        best_metric, best_epoch, non_improving = -np.inf, 0, 0
        rows, _ = _resume_history(cfg.exp_dir, start_epoch)
        metric_key = "mAP" if cfg.metrics == "mAP" else "acc"
        for r in rows:  # the best-ckpt decision state on resume
            if r.get(metric_key, -np.inf) > best_metric:
                best_metric, best_epoch = r[metric_key], int(r["epoch"])
        sched = None
        if cfg.opt.lr_adapt:
            # ReduceLROnPlateau(mode='max') stepped on the eval metric after
            # each epoch (traintest_ft_base.py:99-100,266-270); resume
            # replays the restored epochs' metrics
            from avsiam_tpu_torch.train.optim import plateau_scheduler
            sched = plateau_scheduler(cfg.opt)
            for r in rows:
                if metric_key in r:
                    sched.step(r[metric_key])
            if val_ds is None:
                log("warning: --lr_adapt True without --data-val: the "
                    "plateau scheduler never sees a metric, so lr stays "
                    f"constant at {cfg.opt.lr} (MultiStepLR would still "
                    "decay on schedule)")
        global_step = state.step
        meters = {k: AverageMeter() for k in
                  ("loss", "per_sample_time", "per_sample_data_time",
                   "per_sample_dnn_time")}

        for epoch in range(start_epoch, cfg.n_epochs + 1):
            for meter in meters.values():  # per-epoch reset (reference)
                meter.reset()
            lr = (sched.lr if sched is not None
                  else ft.lr_for_epoch(cfg, epoch))
            loader = _epoch_loader(train_ds, cfg.batch_size, epoch, cfg.seed,
                                   transform,
                                   batch_generator_seed(cfg.seed, epoch),
                                   weights=balance_weights, device=dev)

            def flush_window(win) -> Optional[Dict[str, float]]:
                avg, t = win.flush()
                if avg is None:
                    return None
                meters["loss"].update(avg["loss"], t["samples"])
                meters["per_sample_time"].update(
                    t["elapsed"] / t["samples"], t["samples"])
                meters["per_sample_data_time"].update(
                    t["data"] / t["samples"], t["samples"])
                meters["per_sample_dnn_time"].update(
                    (t["elapsed"] - t["data"]) / t["samples"], t["samples"])
                return avg

            window = _MetricWindow()
            branches = dict(state.branches)
            end_time = time.time()
            n_steps = 0
            try:
                for i, (a, v, y) in enumerate(loader):
                    if max_steps_per_epoch and i >= max_steps_per_epoch:
                        break
                    data_t = time.time() - end_time
                    if v.dim() == 4:
                        v = v[:, None]
                    state, metrics = step_fn(state, (a, v, y), lr)
                    window.push(metrics, a.shape[0], data_t)
                    n_steps += 1
                    if global_step % cfg.n_print_steps == 0:
                        m = flush_window(window)
                        log(f"FT epoch [{epoch}][{i}] loss {m['loss']:.4f} "
                            f"t/sample "
                            f"{meters['per_sample_time'].avg * 1000:.1f}ms")
                        if math.isnan(meters["loss"].avg):
                            log("training diverged...")
                            return {"diverged": True, "epoch": epoch}
                    global_step += 1
                    end_time = time.time()
            finally:
                loader.close()
            flush_window(window)  # tail: the epoch's meters cover every step
            if math.isnan(meters["loss"].avg):
                log("training diverged...")
                return {"diverged": True, "epoch": epoch}

            row = {"epoch": epoch, "lr": lr, "train_loss": meters["loss"].avg,
                   **{k: meters[k].avg for k in
                      ("per_sample_time", "per_sample_data_time",
                       "per_sample_dnn_time")}}
            saves = {}
            t_epoch = {"epoch": epoch, "steps": n_steps,
                       "branches": {k: n - branches[k]
                                    for k, n in state.branches.items()},
                       **{k: meters[k].avg for k in
                          ("per_sample_time", "per_sample_data_time",
                           "per_sample_dnn_time")},
                       "eval_s": 0.0, "eval_batches": 0, "saves": saves}
            if val_ds is not None:
                t0 = time.time()
                stats, val_loss, n_eval = validate_ft(
                    eval_fn, state.model, val_ds, cfg,
                    max_steps=max_steps_per_epoch, device=dev)
                t_epoch.update(eval_s=time.time() - t0, eval_batches=n_eval)
                mAP, mAUC = mean_ap(stats), mean_auc(stats)
                acc = stats[0]["acc"]
                row.update({"mAP": mAP, "mAUC": mAUC, "acc": acc,
                            "val_loss": val_loss})
                metric = mAP if cfg.metrics == "mAP" else acc
                log(f"FT eval epoch {epoch}: mAP {mAP:.4f} AUC {mAUC:.4f} "
                    f"acc {acc:.4f}")
                if main:
                    with open(os.path.join(cfg.exp_dir,
                                           f"stats_{epoch}.pickle"),
                              "wb") as f:
                        pickle.dump(stats, f)
                if metric > best_metric:
                    best_metric, best_epoch, non_improving = metric, epoch, 0
                    if main:
                        _timed(saves, save_params, cfg.exp_dir,
                               "best_audio_model", state.model)
                else:
                    non_improving += 1
                if sched is not None:
                    sched.step(metric)  # traintest_ft_base.py:266-270
            if main and cfg.save_model:  # traintest_ft_base.py:262
                _timed(saves, save_params, cfg.exp_dir,
                       f"audio_model.{epoch}", state.model)
            if main and (epoch % max(cfg.train_state_every, 1) == 0
                         or epoch == cfg.n_epochs):
                _timed(saves, save_train_state, cfg.exp_dir,
                       f"train_state.{epoch}", state)
                prune_train_states(cfg.exp_dir, cfg.keep_train_states)
            timing["epochs"].append(t_epoch)
            rows.append(row)
            mlog.log(row, step=global_step)
            if main:
                _write_csv(os.path.join(cfg.exp_dir, "result.csv"), rows)
            stop = non_improving >= 3  # traintest_ft_base.py:249-251
            if stop:
                log("early stop")
                if main and epoch % max(cfg.train_state_every, 1) != 0:
                    # the last epoch run always has a train state to resume
                    # from, early stop or not
                    _timed(saves, save_train_state, cfg.exp_dir,
                           f"train_state.{epoch}", state)
                    prune_train_states(cfg.exp_dir, cfg.keep_train_states)
            pdist.barrier("finetune-epoch")
            if stop:
                break

        out = {"state": state, "best_epoch": best_epoch, "best": best_metric,
               "rows": rows, "model": state.model, "timing": timing}
        if wa:
            # the last epoch that has a checkpoint: rows carry their epochs
            # (a resumed run that had finished adds no rows)
            last = max((int(r["epoch"]) for r in rows), default=0)
            end = min(wa_end, last)
            if end >= wa_start:
                t0 = time.time()
                out["wa_params"] = average_checkpoints(cfg.exp_dir, wa_start,
                                                       end)
                timing["wa_s"] = time.time() - t0
            else:
                log(f"wa skipped: no checkpoints in [{wa_start}, {end}]")
        return out
    finally:
        mlog.close()


def _np_sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _np_bce(logits: np.ndarray, y: np.ndarray) -> float:
    """The numpy twin of ``finetune.bce_with_logits`` (the eval loss)."""
    x = logits.astype(np.float32)
    return float(np.mean(np.maximum(x, 0) - x * y
                         + np.log1p(np.exp(-np.abs(x)))))


def _np_ce_soft(logits: np.ndarray, y: np.ndarray) -> float:
    """The numpy twin of ``finetune.ce_with_soft_targets``."""
    x = logits.astype(np.float32)
    z = x - x.max(axis=-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
    return float(-np.mean((y * logp).sum(axis=-1)))


def validate_ft(eval_fn, model, val_ds: AVDataset, cfg: FinetuneConfig,
                max_steps: Optional[int] = None, device="cuda"):
    """The eval loop (traintest_ft_base.py:292-352): the multi-frame
    forward of ``eval_fn`` over ``val_ds`` (``cfg.model.num_eval_frames``
    frames a clip, padded to a batch multiple), then on the host the
    sigmoid, the frame mean and ``calculate_stats`` over the clips without
    the padding. Returns (stats, the mean of the batches' losses on the
    frame-mean logits, the number of batches). Under a process group each
    process runs its slab of the set, and the predictions and targets are
    gathered in rank order before the statistics, which are then the whole
    set's on every process; the loss stays the process's own batch mean,
    as in the JAX loop."""
    transform = make_eval_transform(cfg.audio, im_res=cfg.model.vit.img_size)
    loader = _epoch_loader(val_ds, cfg.batch_size, 0, cfg.seed, transform, 0,
                           frames_per_sample=cfg.model.num_eval_frames,
                           device=device, train=False)
    preds, targets, losses = [], [], []
    np_loss = _np_bce if cfg.loss == "BCE" else _np_ce_soft
    try:
        for i, (a, v, y) in enumerate(loader):
            if max_steps and i >= max_steps:
                break
            logits = eval_fn(model, (a, v, y)).float().cpu().numpy()
            y = y.float().cpu().numpy()
            if logits.ndim == 3:  # [B, T, C]: the frames
                p = _np_sigmoid(logits).mean(axis=1)
                losses.append(np_loss(logits.mean(axis=1), y))
            else:
                p = _np_sigmoid(logits)
                losses.append(np_loss(logits, y))
            preds.append(p)
            targets.append(y)
    finally:
        loader.close()
    n = len(val_ds)
    # this process's batch-alignment padding goes before the ordered gather
    slab = len(eval_shard_indices(n, pdist.world_size(), pdist.rank()))
    stats = calculate_stats(
        pdist.gather_eval_outputs(np.concatenate(preds)[:slab], n),
        pdist.gather_eval_outputs(np.concatenate(targets)[:slab], n))
    return stats, float(np.mean(losses)), len(losses)


# ---------------------------------------------------------------------------
# Linear probe (a pretraining-time quality signal)
# ---------------------------------------------------------------------------

def linear_probe(pretrain_params: Dict[str, torch.Tensor],
                 pre_cfg: PretrainConfig, probe_train_ds: AVDataset,
                 probe_val_ds: AVDataset, n_class: int = 527,
                 epochs: int = 5, max_steps_per_epoch: Optional[int] = None,
                 log: Callable = print, device="cuda") -> Dict:
    """traintest_cavmae_base.py:266-378: a fresh finetune model (seed
    ``pre_cfg.seed``) with the pretrain state_dict's trunk and fusion
    layers, base frozen, heads and fusion layers at 5e-5 x 100, trained
    ``epochs`` epochs in 'joint_av' without augmentation, then evaluated
    in 'joint_av', 'audioonly' and 'videoonly': {mode_mAP, mode_AUC}.
    Under a process group it runs over the same group, as the loops do."""
    dev = resolve_device(device)
    ft_cfg = FinetuneConfig(
        model=CAVMAEFTConfig(vit=pre_cfg.model.vit, label_dim=n_class,
                             dtype=pre_cfg.model.dtype),
        audio=replace(pre_cfg.audio, freqm=0, timem=0, mixup=0.0,
                      noise=False),
        opt=replace(pre_cfg.opt, lr=5e-5), head_lr=100.0, mm_lr=100.0,
        freeze_base=True, ftmode="joint_av", batch_size=pre_cfg.batch_size,
        n_epochs=epochs, exp_dir=os.path.join(pre_cfg.exp_dir, "probe"),
        seed=pre_cfg.seed)
    state = ft.init_state(ft_cfg, torch.Generator(device=dev).manual_seed(
        ft_cfg.seed), dev)
    state.model.load_state_dict(transfer_pretrain_to_ft(
        pretrain_params, state.model.state_dict()))
    step_fn = ft.make_finetune_step(ft_cfg)
    transform = make_train_transform(ft_cfg.audio,
                                     im_res=ft_cfg.model.vit.img_size)
    for epoch in range(1, epochs + 1):
        loader = _epoch_loader(probe_train_ds, ft_cfg.batch_size, epoch,
                               ft_cfg.seed, transform,
                               batch_generator_seed(ft_cfg.seed, epoch),
                               device=dev)
        try:
            for i, (a, v, y) in enumerate(loader):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                if v.dim() == 4:
                    v = v[:, None]
                state, _ = step_fn(state, (a, v, y), ft_cfg.opt.lr)
        finally:
            loader.close()
    results = {}
    # the reference's probe evaluates these three modes
    # (traintest_cavmae_base.py:343-354)
    for mode in ("joint_av", "audioonly", "videoonly"):
        mode_cfg = replace(ft_cfg, ftmode=mode)
        stats, _, _ = validate_ft(ft.make_ft_eval_step(mode_cfg), state.model,
                                  probe_val_ds, mode_cfg,
                                  max_steps=max_steps_per_epoch, device=dev)
        results[f"{mode}_mAP"] = mean_ap(stats)
        results[f"{mode}_AUC"] = mean_auc(stats)
        log(f"linear probe {mode}: mAP {results[f'{mode}_mAP']:.4f}")
    return results


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
