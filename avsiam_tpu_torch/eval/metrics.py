"""Evaluation metrics of the port.

Counterpart of ``avsiam_tpu/eval/metrics.py``; so far its ``AverageMeter``,
which the pretrain loop's meters use. ``calculate_stats``, ``mean_ap`` and
``mean_auc`` serve finetuning and the linear probe.
"""

from __future__ import annotations


class AverageMeter:
    """Parity: src/utilities/util.py AverageMeter (val/avg/sum/count)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
