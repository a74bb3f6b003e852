"""Dataset index readers: JSON, sqlite, npy, their concatenation, and the
label-CSV map.

The port's own copy of ``avsiam_tpu/data/indices.py`` (which imports no
JAX; the port imports nothing of that package). Parity surfaces (paths injectable instead of hard-coded, fixing the
reference's anti-pattern of baked-in cluster paths):
* label CSV with (index, mid, display_name) columns -> mid->index map
  (src/dataloader.py:43-51 ``make_index_dict``).
* sqlite DB with an ``annos`` table, rows (id, wav, labels); row id == sample
  index (src/dataloader.py:174-191, 364-368).
* JSON {'data': [{'wav', 'labels', ...}]} (src/dataloader.py:204-210).
* npy flat string arrays [[wav, labels], ...] (src/dataloader_val.py:171-180).
"""

from __future__ import annotations

import csv
import json
import sqlite3
import threading
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np


def make_index_dict(label_csv: str) -> Dict[str, int]:
    """mid -> class index. Parity: src/dataloader.py:43-51."""
    lookup = {}
    with open(label_csv, "r") as f:
        for row in csv.DictReader(f):
            lookup[row["mid"]] = int(row["index"])
    return lookup


@dataclass
class Record:
    wav: str
    labels: str  # comma-separated mid strings ('' for unlabeled)
    video_id: str = ""
    video_path: str = ""


class SampleIndex:
    """Abstract random-access index of Records."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i: int) -> Record:
        raise NotImplementedError


class JsonIndex(SampleIndex):
    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)["data"]
        self._rows = [Record(d["wav"], d.get("labels", ""),
                             d.get("video_id", ""), d.get("video_path", ""))
                      for d in data]

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, i):
        return self._rows[i]


class SqliteIndex(SampleIndex):
    """Read-only sqlite index; row schema (id, wav, labels) in table 'annos'.
    Parity: src/dataloader.py:174-191 + decode_data (:213-217).

    Connections are per-thread: sqlite cursors are not thread-safe, and two
    concurrent loaders (e.g. the train Prefetcher thread plus a probe loader
    on the main thread) read the same index."""

    def __init__(self, path: str):
        self._path = path
        self._local = threading.local()
        cur = self._cursor()
        self._n = cur.execute("SELECT COUNT(*) FROM annos").fetchone()[0]
        # lookups are WHERE id = i over i in [0, n) (the reference's
        # contract, dataloader.py:366-368) — verify ids are 0-based and
        # gap-free up front, or every missing id would silently become a
        # fault-tolerance dummy sample (0.01-filled) instead of a loud error
        if self._n:
            lo, hi = cur.execute(
                "SELECT MIN(id), MAX(id) FROM annos").fetchone()
            if lo != 0 or hi != self._n - 1:
                raise ValueError(
                    f"{path}: annos ids must be contiguous 0..N-1 "
                    f"(got min={lo}, max={hi}, count={self._n}); re-index "
                    "the table (e.g. AUTOINCREMENT starts at 1)")

    def _cursor(self):
        if not hasattr(self._local, "cur"):
            con = sqlite3.connect(f"file:{self._path}?mode=ro", uri=True)
            self._local.cur = con.cursor()
        return self._local.cur

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        row = self._cursor().execute(
            "SELECT * FROM annos WHERE id = ?", (i,)).fetchone()
        if row is None:
            raise IndexError(f"annos id {i} missing from {self._path}")
        return Record(wav=row[1], labels=row[2] if len(row) > 2 else "")


class NpyIndex(SampleIndex):
    """npy array of [wav, labels(, video_id, video_path)] string rows.
    Parity: src/dataloader_val.py:171-180 + decode_data_bk."""

    def __init__(self, path: str):
        self._rows = np.load(path, allow_pickle=True)

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, i):
        r = self._rows[i]
        return Record(wav=str(r[0]), labels=str(r[1]) if len(r) > 1 else "",
                      video_id=str(r[2]) if len(r) > 2 else "",
                      video_path=str(r[3]) if len(r) > 3 else "")


class ConcatIndex(SampleIndex):
    """Concatenation of several indices — the Base+ pretraining corpus
    (AS-2M + VGGSound + ACAV-2.4M, the reference's combined sqlite DB
    ``train_pt_as+vgg+acav2.4m.sqlite.db``, dataloader.py:176)."""

    def __init__(self, indices: Sequence[SampleIndex]):
        self._indices = list(indices)
        self._offsets = []
        total = 0
        for idx in self._indices:
            self._offsets.append(total)
            total += len(idx)
        self._n = total

    def __len__(self):
        return self._n

    def __getitem__(self, i: int) -> Record:
        for idx, off in zip(reversed(self._indices),
                            reversed(self._offsets)):
            if i >= off:
                return idx[i - off]
        raise IndexError(i)


def open_index(path: str) -> SampleIndex:
    """Open one index, or a ','-joined list of paths as a ConcatIndex."""
    if "," in path:
        return ConcatIndex([open_index(p) for p in path.split(",")])
    if path.endswith(".json"):
        return JsonIndex(path)
    if path.endswith(".npy"):
        return NpyIndex(path)
    if path.endswith(".db") or path.endswith(".sqlite") or ".sqlite" in path:
        return SqliteIndex(path)
    raise ValueError(f"unknown index format: {path}")


def multihot_labels(labels: str, index_dict: Dict[str, int], n_class: int,
                    label_smooth: float = 0.0):
    """Comma-separated mids -> smoothed multi-hot vector.
    Parity: src/dataloader.py:443-489, src/dataloader_ft.py:470-525."""
    y = np.zeros(n_class, dtype=np.float32) + label_smooth / n_class
    if labels:
        for mid in labels.split(","):
            if mid in index_dict:
                y[index_dict[mid]] = 1.0 - label_smooth
    return y
