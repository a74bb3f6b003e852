"""Kaldi-compatible log-mel filterbank, on the tensor's device.

Counterpart of ``avsiam_tpu/ops/fbank.py``: the reference's
``torchaudio.compliance.kaldi.fbank(waveform, htk_compat=True,
sample_frequency=sr, use_energy=False, window_type='hanning',
num_mel_bins=128, dither=0.0, frame_shift=10)`` (src/dataloader.py:328).
``kaldi_fbank`` runs the whole chain in torch ops on the waveform's device:
snip-edges framing, DC removal, pre-emphasis 0.97 with the first sample
replicated, the symmetric Hann window, zero padding to the next power of
two, the rFFT power spectrum, the mel projection ([frames, 257] x [257,
128]) and log(max(x, float32 eps)). The JAX version is plain XLA (no
Pallas kernel), so this one is plain torch too: ``torch.fft.rfft`` and one
matrix product. The mel projection runs in float32 with TF32 off for that
product alone (set per call, not process-wide).

``kaldi_fbank_np`` is the port's own float64 NumPy mirror (a test oracle).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_EPSILON = float(np.finfo(np.float32).eps)  # 1.1920929e-07
_MEL_HIGH_FREQ_Q = 1127.0
_MEL_BREAK_FREQ = 700.0


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def mel_scale(freq):
    return _MEL_HIGH_FREQ_Q * np.log(1.0 + freq / _MEL_BREAK_FREQ)


def mel_banks(num_bins: int, padded_window_size: int, sample_freq: float,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi triangular mel filterbank matrix [num_bins, padded/2 + 1]
    (float32), its last (Nyquist) column zero, as torchaudio pads the
    [num_bins, padded/2] Kaldi matrix."""
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not 0.0 <= low_freq < high_freq <= nyquist:
        raise ValueError(f"mel band [{low_freq}, {high_freq}] outside "
                         f"[0, {nyquist}]")
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_freq / padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_fft_bins, dtype=np.float64)
    mel = mel_scale(fft_bin_width * bin_idx)[None, :]  # [1, F]
    left = (mel_low + np.arange(num_bins, dtype=np.float64)
            * mel_delta)[:, None]
    center = left + mel_delta
    right = center + mel_delta
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down))
    out = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float32)
    out[:, :num_fft_bins] = weights
    return out


def _hann_window(n: int) -> np.ndarray:
    """``torch.hann_window(n, periodic=False)`` in float32."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * i / (n - 1))).astype(
        np.float32)


def _window_and_shift(sample_freq: float, frame_length_ms: float,
                      frame_shift_ms: float):
    return (int(sample_freq * frame_length_ms / 1000.0),
            int(sample_freq * frame_shift_ms / 1000.0))


def num_frames_for(num_samples: int, sample_freq: float,
                   frame_length_ms: float = 25.0,
                   frame_shift_ms: float = 10.0) -> int:
    """Snip-edges frame count of ``num_samples`` samples."""
    ws, sh = _window_and_shift(sample_freq, frame_length_ms, frame_shift_ms)
    return max(0, 1 + (num_samples - ws) // sh)


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products on the card in full float32 (TF32 off) within
    the block, the setting restored after it."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def kaldi_fbank(waveform: torch.Tensor, sample_freq: float = 16000.0,
                num_mel_bins: int = 128, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, preemph: float = 0.97,
                remove_dc: bool = True) -> torch.Tensor:
    """[B, n] (or [n]) waveform -> [B, num_frames, num_mel_bins] log-mel in
    float32, on the waveform's device."""
    squeeze = waveform.dim() == 1
    if squeeze:
        waveform = waveform[None]
    waveform = waveform.to(torch.float32)
    ws, sh = _window_and_shift(sample_freq, frame_length_ms, frame_shift_ms)
    padded = _next_pow2(ws)
    frames = waveform.unfold(-1, ws, sh)  # [B, m, ws], snip edges
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemph != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemph * prev
    window = torch.from_numpy(_hann_window(ws)).to(frames.device)
    frames = torch.nn.functional.pad(frames * window, (0, padded - ws))
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real.square() + spec.imag.square()
    banks = torch.from_numpy(mel_banks(num_mel_bins, padded, sample_freq))
    banks = banks.to(power.device)
    with full_f32_matmul():
        mel = torch.matmul(power, banks.T)
    out = torch.log(torch.clamp(mel, min=_EPSILON))
    return out[0] if squeeze else out


def kaldi_fbank_np(waveform: np.ndarray, sample_freq: float = 16000.0,
                   num_mel_bins: int = 128, frame_length_ms: float = 25.0,
                   frame_shift_ms: float = 10.0, preemph: float = 0.97,
                   remove_dc: bool = True) -> np.ndarray:
    """Independent float64 NumPy version of ``kaldi_fbank`` for one [n]
    waveform (test oracle)."""
    x = np.asarray(waveform, dtype=np.float64)
    ws, sh = _window_and_shift(sample_freq, frame_length_ms, frame_shift_ms)
    padded = _next_pow2(ws)
    m = 1 + (len(x) - ws) // sh
    window = _hann_window(ws).astype(np.float64)
    banks = mel_banks(num_mel_bins, padded, sample_freq).astype(np.float64)
    out = np.empty((m, num_mel_bins), dtype=np.float64)
    for i in range(m):
        f = x[i * sh: i * sh + ws].copy()
        if remove_dc:
            f -= f.mean()
        if preemph != 0.0:
            f = f - preemph * np.concatenate([[f[0]], f[:-1]])
        fp = np.zeros(padded)
        fp[:ws] = f * window
        spec = np.fft.rfft(fp)
        out[i] = banks @ (spec.real ** 2 + spec.imag ** 2)
    return np.log(np.maximum(out, _EPSILON)).astype(np.float32)


def pad_or_crop_frames(fbank: torch.Tensor, target_length: int
                       ) -> torch.Tensor:
    """Pad (zeros at the end) or crop [..., m, F] to ``target_length``
    frames (src/dataloader.py:333-343)."""
    m = fbank.shape[-2]
    if m < target_length:
        return torch.nn.functional.pad(fbank, (0, 0, 0, target_length - m))
    return fbank[..., :target_length, :]
