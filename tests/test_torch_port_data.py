"""Port parity of the data layer's host side: the index readers (JSON,
sqlite, npy, their concatenation), labels, samplers, media helpers,
``AVDataset`` and ``Prefetcher``.

Every result here is integers, strings or bytes from NumPy's seeded streams,
so each must equal the JAX package's exactly: the same indices and
positions, and ``AVDataset.batch`` bit for bit for the same seed and
positions.
"""

import json
import sqlite3
import time
import wave

import numpy as np
import pytest

from avsiam_tpu import configs as jc
from avsiam_tpu.data import dataset as jds
from avsiam_tpu.data import indices as jidx
from avsiam_tpu.data import media as jmedia
from avsiam_tpu.data import samplers as jsmp
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.data import dataset as pds
from avsiam_tpu_torch.data import indices as pidx
from avsiam_tpu_torch.data import media as pmedia
from avsiam_tpu_torch.data import samplers as psmp
from avsiam_tpu_torch.data.pipeline import Prefetcher


@pytest.fixture
def label_csv(tmp_path):
    p = tmp_path / "labels.csv"
    p.write_text("index,mid,display_name\n0,/m/0,zero\n1,/m/1,one\n"
                 "2,/m/2,two\n")
    return str(p)


def _rows(n, stem="/fake"):
    return [{"wav": f"{stem}/{i}.wav", "labels": f"/m/{i % 3},/m/{(i + 1) % 3}"
             if i % 4 == 0 else f"/m/{i % 3}", "video_id": f"v{i}",
             "video_path": stem} for i in range(n)]


@pytest.fixture
def json_index(tmp_path):
    p = tmp_path / "idx.json"
    p.write_text(json.dumps({"data": _rows(10)}))
    return str(p)


def _records(index):
    return [(r.wav, r.labels, r.video_id, r.video_path)
            for r in (index[i] for i in range(len(index)))]


def test_indices_match_jax(tmp_path, json_index):
    """JSON, sqlite, npy and ','-joined indices open to the same records,
    and an sqlite table whose ids are not 0..N-1 raises in both."""
    db = tmp_path / "idx.sqlite"
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE annos (id INTEGER, wav TEXT, labels TEXT)")
    con.executemany("INSERT INTO annos VALUES (?, ?, ?)",
                    [(i, f"/db/{i}.wav", f"/m/{i % 3}") for i in range(7)])
    con.commit()
    con.close()
    npy = tmp_path / "idx.npy"
    np.save(npy, np.asarray([[f"/n/{i}.wav", "/m/1", f"n{i}", "/n"]
                             for i in range(4)]))
    paths = [json_index, str(db), str(npy),
             ",".join([json_index, str(db), str(npy)])]
    for path in paths:
        want = _records(jidx.open_index(path))
        assert _records(pidx.open_index(path)) == want, path
    assert len(pidx.open_index(paths[-1])) == 10 + 7 + 4
    bad = tmp_path / "bad.sqlite"
    con = sqlite3.connect(bad)
    con.execute("CREATE TABLE annos (id INTEGER, wav TEXT, labels TEXT)")
    con.executemany("INSERT INTO annos VALUES (?, ?, ?)",
                    [(i + 1, "w", "") for i in range(3)])
    con.commit()
    con.close()
    for mod in (jidx, pidx):
        with pytest.raises(ValueError, match="contiguous"):
            mod.open_index(str(bad))


def test_labels_match_jax(label_csv):
    """The label map and the smoothed multi-hot vectors."""
    assert pidx.make_index_dict(label_csv) == jidx.make_index_dict(label_csv)
    d = pidx.make_index_dict(label_csv)
    for labels in ("", "/m/0", "/m/1,/m/2", "/m/9,/m/2"):
        for smooth in (0.0, 0.1):
            np.testing.assert_array_equal(
                pidx.multihot_labels(labels, d, 5, smooth),
                jidx.multihot_labels(labels, d, 5, smooth))


@pytest.mark.parametrize("world,rank,global_batch", [
    (1, 0, None), (3, 1, None), (4, 2, 8), (2, 1, 6)])
def test_samplers_match_jax(world, rank, global_batch):
    """Shuffled (strided and contiguous-block) and weighted epoch indices
    with their positions, the eval shards and the batching."""
    n = 37
    for epoch in (0, 3):
        got = psmp.shuffled_epoch_indices(n, epoch, 5, world, rank,
                                          global_batch, with_positions=True)
        want = jsmp.shuffled_epoch_indices(n, epoch, 5, world, rank,
                                           global_batch, with_positions=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        weights = np.random.RandomState(epoch).rand(n)
        got = psmp.weighted_indices(weights, n, epoch, 5, world, rank,
                                    global_batch, with_positions=True)
        want = jsmp.weighted_indices(weights, n, epoch, 5, world, rank,
                                     global_batch, with_positions=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(psmp.eval_shard_indices(n, world, rank),
                                  jsmp.eval_shard_indices(n, world, rank))
    idx = np.arange(n)
    for drop in (True, False):
        for g, w in zip(psmp.batched(idx, 8, drop), jsmp.batched(idx, 8, drop),
                        strict=True):
            np.testing.assert_array_equal(g, w)


def test_media_helpers_match_jax(tmp_path):
    """WAV read (PCM16 stereo, through the native parser where it builds,
    and PCM32 through the stdlib), mono, resampling, length fitting and the
    frame walk-down."""
    sr = 8000
    x = (0.4 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)).astype(np.float32)
    stereo = np.stack([x, x * 0.5], axis=1)
    for width, dtype, full in ((2, "<i2", 32767), (4, "<i4", 2 ** 31 - 1)):
        p = tmp_path / f"s{width}.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(width)
            w.setframerate(sr)
            w.writeframes((stereo * full).astype(dtype).tobytes())
        got, got_sr = pmedia.read_wav(str(p))
        want, want_sr = jmedia.read_wav(str(p))
        assert got_sr == want_sr == sr
        np.testing.assert_array_equal(pmedia.to_mono(got),
                                      jmedia.to_mono(want))
    w = np.random.RandomState(0).randn(1000).astype(np.float32)
    np.testing.assert_array_equal(pmedia.resample(w, 8000, 16000),
                                  jmedia.resample(w, 8000, 16000))
    for n in (600, 1000, 1500):
        np.testing.assert_array_equal(pmedia.fit_length(w, n),
                                      jmedia.fit_length(w, n))
    np.testing.assert_array_equal(pmedia.mean_center(w), jmedia.mean_center(w))
    (tmp_path / "frame_2").mkdir()
    (tmp_path / "frame_2" / "v.jpg").write_bytes(b"")
    for t in (0, 2, 5):
        assert (pmedia.select_frame_with_walkdown(str(tmp_path), "v", t)
                == jmedia.select_frame_with_walkdown(str(tmp_path), "v", t))
    for path in ("a.mp4", "b.WAV", "c.webm"):
        assert (pmedia.is_video_container(path)
                == jmedia.is_video_container(path))


def _datasets(index, label_csv, source, **kw):
    args = dict(label_csv=label_csv, mode="train", frame_source=source,
                im_res=32, num_frames=4, **kw)
    jaudio = jc.AudioConfig(target_length=128)
    paudio = pc.AudioConfig(target_length=128)
    return (pds.AVDataset(index, paudio, **args),
            jds.AVDataset(index, jaudio, **args))


@pytest.mark.parametrize("frames_per_sample", [1, 4])
@pytest.mark.parametrize("source", ["synthetic", "synthetic_paired"])
def test_dataset_batch_is_jax_bit_for_bit(json_index, label_csv, source,
                                          frames_per_sample):
    """``AVDataset.batch`` (wav, frames u8, labels, wav_len) equals the JAX
    package's bit for bit for an int seed with and without positions, and
    for a RandomState, in train and eval mode."""
    for mode in ("train", "eval"):
        port, jax_ds = _datasets(json_index, label_csv, source)
        port.mode = jax_ds.mode = mode
        assert len(port) == len(jax_ds) == 10
        for rng, positions in ((7, None), (7, [40, 3, 17]),
                               (np.random.RandomState(3), None)):
            state = rng.get_state() if not isinstance(rng, int) else None
            got = port.batch([2, 9, 2], rng, frames_per_sample, positions)
            if state is not None:
                rng.set_state(state)
            want = jax_ds.batch([2, 9, 2], rng, frames_per_sample, positions)
            for g, w in zip(got, want, strict=True):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def test_dataset_fault_tolerance_fills_match_jax(tmp_path, label_csv):
    """Missing media substitute the reference's fills in both packages: a
    0.01 waveform of full length and frames of 3."""
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"data": [
        {"wav": "/definitely/missing.wav", "labels": "/m/0",
         "video_id": "x", "video_path": "/missing"}]}))
    port, jax_ds = _datasets(str(p), label_csv, "frames")
    got = port.batch([0], np.random.RandomState(0))
    want = jax_ds.batch([0], np.random.RandomState(0))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    wav, frames, labels, wav_len = got
    assert np.allclose(wav, 0.01) and (frames == 3).all()
    assert labels[0, 0] == 1.0 and wav_len[0] == port.num_samples_audio


def test_prefetcher_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = Prefetcher(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetcher_done_arrives_when_queue_full():
    """The end marker reaches a slow consumer even when the bounded queue
    is full when the producer ends."""
    it = Prefetcher(iter([1, 2, 3, 4]), depth=2)
    time.sleep(0.3)  # the worker fills the queue and blocks on the marker
    assert list(it) == [1, 2, 3, 4]


def test_prefetcher_close_unblocks_worker_on_early_break():
    """A consumer that stops early stops the worker with ``close()``."""
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    it = Prefetcher(gen(), depth=2)
    assert next(it) == 0
    it.close()
    it._t.join(timeout=5.0)
    assert not it._t.is_alive(), "prefetch thread left running after close()"
    assert len(produced) < 100
