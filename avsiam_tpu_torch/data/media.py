"""Host-side media IO: WAV reading, resampling, frame loading, video decode.

The port's own copy of ``avsiam_tpu/data/media.py`` (the port imports
nothing of that package). PIL and scipy are imported where they are used:
the card's host may lack them, and only the JPEG frames and resampling
need them. ffmpeg is looked up on the PATH at first use.

The reference leans on two vendored native surfaces here — torchaudio's
libsox/Kaldi loaders (src/dataloader.py:308-310) and ffmpeg via
torchvision.io.VideoReader (src/dataloader.py:392-419). This module provides
dependency-light equivalents: stdlib ``wave`` + NumPy for PCM WAVs, a
polyphase resampler (scipy), PIL for pre-extracted frame JPEGs (the
frame_{i}/{video_id}.jpg layout of src/dataloader_val.py:347-362), and an
ffmpeg-subprocess video decoder that is gated on the binary existing.

The native C++ DSP library (native/) accelerates the WAV->fbank path when
built; see avsiam_tpu_torch/data/native_dsp.py.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """PCM WAV -> (float32 mono-ish [C, n] scaled to [-1, 1], sample_rate).

    Uses the native C++ parser (native/dsp.cpp) when built — the fast path
    for the 1-core host loader — falling back to stdlib ``wave`` for
    non-PCM16 widths or when the library is absent. Matches torchaudio.load's
    scaling for PCM16/PCM32/PCM8.
    """
    from avsiam_tpu_torch.data import native_dsp
    if native_dsp.available():
        try:
            mono, sr = native_dsp.read_wav_mono(path)
            return mono[None, :], sr
        except ValueError:
            pass  # non-PCM16 -> stdlib path below
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    x = x.reshape(-1, ch).T  # [C, n]
    return x, sr


def mean_center(waveform: np.ndarray) -> np.ndarray:
    """waveform - waveform.mean() (src/dataloader.py:311-312)."""
    return waveform - waveform.mean()


def resample(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling (torchaudio.functional.resample equivalent
    surface; used by the FT loader's mp4-audio path, dataloader_ft.py:272-278).
    """
    if orig_sr == new_sr:
        return waveform
    from math import gcd

    from scipy.signal import resample_poly
    g = gcd(orig_sr, new_sr)
    return resample_poly(waveform, new_sr // g, orig_sr // g,
                         axis=-1).astype(np.float32)


def to_mono(waveform: np.ndarray) -> np.ndarray:
    """Channel-mean downmix (dataloader_ft.py:276-278)."""
    return waveform.mean(axis=0) if waveform.ndim == 2 else waveform


def fit_length(waveform: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad or head-crop a [n_samples] waveform to exactly n samples
    (the reference pads/crops at the fbank stage; doing it on the waveform
    keeps batch shapes static for the device fbank)."""
    if len(waveform) >= n:
        return waveform[:n]
    out = np.zeros(n, dtype=waveform.dtype)
    out[: len(waveform)] = waveform
    return out


def load_image(path: str) -> np.ndarray:
    """JPEG/PNG -> uint8 [H, W, 3]."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def frame_path(video_path: str, video_id: str, frame_idx: int) -> str:
    """Pre-extracted frame layout: {video_path}/frame_{i}/{video_id}.jpg
    (src/dataloader_val.py:347-362)."""
    return os.path.join(video_path, f"frame_{frame_idx}", f"{video_id}.jpg")


def select_frame_with_walkdown(video_path: str, video_id: str,
                               frame_idx: int) -> str:
    """Walk down to the nearest existing earlier frame
    (src/dataloader.py:357-359 randselect_img retry)."""
    while frame_idx >= 1 and not os.path.exists(
            frame_path(video_path, video_id, frame_idx)):
        frame_idx -= 1
    return frame_path(video_path, video_id, frame_idx)


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


def have_ffmpeg() -> bool:
    return _ffmpeg() is not None


_VIDEO_EXTS = {".mp4", ".mkv", ".avi", ".mov", ".webm", ".m4v"}


def is_video_container(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in _VIDEO_EXTS


def decode_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """Extract a media container's audio track as mono float32 at
    ``sample_rate`` (ffmpeg ``-vn -f f32le -ac 1 -ar N``).

    Parity: the reference finetune loader reads the waveform directly out of
    the .mp4 (src/dataloader_ft.py:272-278: torchaudio.load on the video
    file, resample to 16 kHz, channel-mean downmix). Requires ffmpeg; callers
    must gate on ``have_ffmpeg()``.
    """
    ffmpeg = _ffmpeg()
    if ffmpeg is None:
        raise RuntimeError("ffmpeg not available for audio decode")
    out = subprocess.run(
        [ffmpeg, "-v", "error", "-i", path, "-vn", "-f", "f32le",
         "-ac", "1", "-ar", str(sample_rate), "-"],
        capture_output=True, check=True)
    return np.frombuffer(out.stdout, dtype=np.float32).copy()


def decode_video_frames(path: str, num_frames: int = 10,
                        start_jitter: int = 0,
                        size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode a video and linspace-sample num_frames (uint8 [T, H, W, 3]).

    Parity: src/dataloader.py:392-419 (full decode -> linspace from a random
    start in [0, 5] to the last frame). Requires ffmpeg; callers must gate on
    ``have_ffmpeg()``.
    """
    ffmpeg = _ffmpeg()
    if ffmpeg is None:
        raise RuntimeError("ffmpeg not available for video decode")
    scale = [] if size is None else ["-vf", f"scale={size[1]}:{size[0]}"]
    if size is not None:
        # output geometry is forced by the scale filter — skip the ffprobe
        # subprocess entirely (a fork+exec plus stream scan per sample on
        # the 1-core data plane, only needed to learn the native W x H)
        h, w = size
    else:
        probe = subprocess.run(
            [ffmpeg.replace("ffmpeg", "ffprobe"), "-v", "error",
             "-select_streams", "v:0", "-show_entries",
             "stream=width,height", "-of", "csv=p=0", path],
            capture_output=True, text=True, check=True)
        w, h = (int(v) for v in probe.stdout.strip().split(","))
    out = subprocess.run(
        [ffmpeg, "-v", "error", "-i", path, *scale, "-f", "rawvideo",
         "-pix_fmt", "rgb24", "-"],
        capture_output=True, check=True)
    frames = np.frombuffer(out.stdout, dtype=np.uint8)
    frames = frames.reshape(-1, h, w, 3)
    idx = np.linspace(start_jitter, len(frames) - 1, num=num_frames,
                      dtype=int)
    return frames[idx]
