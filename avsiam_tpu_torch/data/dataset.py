"""Audio-visual dataset: host raw loading and the batch transforms on the
device.

Counterpart of ``avsiam_tpu/data/dataset.py``, split the same way:

* HOST (``AVDataset``): index lookup, WAV read + mean-centre + length-fit,
  frame bytes (pre-extracted JPEG, ffmpeg decode, synthetic), multi-hot
  labels, as fixed-shape NumPy arrays. Byte for byte the JAX package's
  (the stable hash, per-sample streams keyed on (seed, position), the
  fault-tolerance fills).
* DEVICE (``make_train_transform``, ``make_eval_transform``): Kaldi fbank,
  pad-to-1024, SpecAugment, normalisation, noise and roll, in-batch mixup,
  image [0, 1] scaling, bicubic resize and ImageNet normalisation, as torch
  ops on the batch's device. They take their random draws as a
  ``TransformDraws`` (``ops/augment.py:draw_transform``), so that a test
  can hand them JAX's.

The bicubic resize is the JAX package's ``jax.image.resize(...,
"bicubic")``: Keys' cubic with a = -0.5, half-pixel centres, the kernel
widened when shrinking (antialiasing). ``F.interpolate(mode="bicubic")`` is
a = -0.75 without antialiasing, so the port builds the two separable weight
matrices with its own NumPy code (``resize_weights``) and applies them as
two products.

Mixup note: the reference mixes each sample with a uniformly-random OTHER
dataset sample (src/dataloader.py:373-437); the device fast path mixes with a
random in-batch permutation — the standard approximation with the same
marginal distribution over partners when batches are shuffled. Audio mixes
with lam ~ Beta(10,10); images mix with an independent U[0,1) weight; labels
mix with the audio lam (dataloader.py:417-418,429-434).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from avsiam_tpu_torch.configs import AudioConfig
from avsiam_tpu_torch.data import media
from avsiam_tpu_torch.data.indices import (SampleIndex, make_index_dict,
                                           multihot_labels, open_index)
from avsiam_tpu_torch.ops import augment as aug
from avsiam_tpu_torch.ops.fbank import (full_f32_matmul, kaldi_fbank,
                                        pad_or_crop_frames)


def _stable_hash(s: str) -> int:
    """Process-stable string hash (zlib.crc32); Python's built-in hash() is
    salted per interpreter, so synthetic data keyed on it would differ
    between the ranks of a multi-process run."""
    import zlib
    return zlib.crc32(s.encode("utf-8")) % (2 ** 31)


@dataclass
class AVSample:
    waveform: np.ndarray  # [num_samples] float32, mean-centered, zero-padded
    frames: np.ndarray  # uint8 [T, H, W, 3]
    labels: np.ndarray  # [n_class] float32
    wav_len: int = 0  # true sample count before padding


class AVDataset:
    """Host-side dataset over a SampleIndex.

    frame_source: 'frames' (pre-extracted frame_{i}/{id}.jpg layout),
    'video' (ffmpeg decode), 'synthetic' (deterministic independent-noise
    pseudo-data for tests/benches without media files), or
    'synthetic_paired' (audio and frames expose a shared per-clip latent —
    contrastive-learnability probes; see _load_waveform).
    """

    def __init__(self, index_path: str, audio_conf: AudioConfig,
                 label_csv: Optional[str] = None, n_class: int = 527,
                 mode: str = "train", frame_source: str = "synthetic",
                 num_frames: int = 10, im_res: int = 224,
                 label_smooth: float = 0.0, frame_use: int = -1):
        self.index: SampleIndex = open_index(index_path)
        self.audio_conf = audio_conf
        self.index_dict = make_index_dict(label_csv) if label_csv else {}
        self.n_class = len(self.index_dict) or n_class
        self.mode = mode
        self.frame_source = frame_source
        self.num_frames = num_frames
        self.im_res = im_res
        self.label_smooth = label_smooth
        self.frame_use = frame_use
        self.num_samples_audio = int(
            audio_conf.sample_rate *
            (audio_conf.target_length + 2) * audio_conf.frame_shift_ms / 1000.0)
        # target_length frames need (target_length-1)*shift + window samples;
        # 10.26 s covers 1024 frames at 10 ms shift / 25 ms window.

    def __len__(self):
        return len(self.index)

    # ------------------------------------------------------------------
    def _paired_latent(self, rec, d: int = 8) -> np.ndarray:
        """Per-clip latent shared by audio and frames in 'synthetic_paired'
        mode: sigmoid(z) in (0,1)^d, deterministic per path."""
        z = np.random.RandomState(_stable_hash(rec.wav + "z")).randn(d)
        return 1.0 / (1.0 + np.exp(-z))

    def _load_waveform(self, rec):
        if self.frame_source == "synthetic_paired":
            # Tone bank amplitude-modulated by the shared latent: audio and
            # frames expose the SAME d-dim signal, so the contrastive head
            # has learnable, GENERALIZING audio<->visual structure. Plain
            # 'synthetic' clips are independent noise — training on them
            # collapses the contrastive head to the uniform ln(B) solution
            # (the known property scripts/soak.py works around by overfitting
            # from fresh init); this mode exists for end-to-end probes of
            # contrastive learning through the real pipeline.
            amps = self._paired_latent(rec)
            rng = np.random.RandomState(_stable_hash(rec.wav))
            t = np.arange(self.num_samples_audio, dtype=np.float32)
            sr = float(self.audio_conf.sample_rate)
            freqs = np.geomspace(200.0, 4000.0, num=len(amps))
            w = sum(0.03 * a * np.sin(2 * np.pi * f * t / sr)
                    for a, f in zip(amps, freqs))
            w = (w + rng.randn(self.num_samples_audio) * 0.005).astype(
                np.float32)
        elif self.frame_source == "synthetic":
            # stable hash: Python's hash() is salted PER PROCESS, which would
            # give every rank of a multi-process run different synthetic data
            rng = np.random.RandomState(_stable_hash(rec.wav))
            w = rng.randn(self.num_samples_audio).astype(np.float32) * 0.05
        elif media.is_video_container(rec.wav):
            # audio read straight out of the video container (the reference
            # FT loader's path, dataloader_ft.py:272-278)
            w = media.decode_audio(rec.wav, self.audio_conf.sample_rate)
        else:
            x, sr = media.read_wav(rec.wav)
            x = media.to_mono(x)
            if sr != self.audio_conf.sample_rate:
                x = media.resample(x, sr, self.audio_conf.sample_rate)
            w = x.astype(np.float32)
        w = media.mean_center(w)
        wav_len = min(len(w), self.num_samples_audio)
        return media.fit_length(w, self.num_samples_audio), wav_len

    def _load_frames(self, rec, rng: np.random.RandomState) -> np.ndarray:
        T = self.num_frames
        if self.frame_source == "synthetic_paired":
            # Vertical bands whose intensities are the same latent the tone
            # bank modulates (see _load_waveform); mild per-frame noise keeps
            # multi-frame paths (frame aggregation, random frame draw)
            # meaningful without hiding the signal.
            amps = self._paired_latent(rec)
            r = np.random.RandomState(_stable_hash(rec.wav + "v"))
            cols = np.repeat((40 + 170 * amps),
                             -(-self.im_res // len(amps)))[:self.im_res]
            img = np.broadcast_to(cols[None, :, None],
                                  (self.im_res, self.im_res, 3))
            noise = r.randint(-20, 21, (T, self.im_res, self.im_res, 3))
            return np.clip(img[None] + noise, 0, 255).astype(np.uint8)
        if self.frame_source == "synthetic":
            r = np.random.RandomState(_stable_hash(rec.wav + "v"))
            return r.randint(0, 255, (T, self.im_res, self.im_res, 3),
                             dtype=np.uint8)
        if self.frame_source == "video":
            return media.decode_video_frames(
                rec.video_path or rec.wav, num_frames=T,
                start_jitter=rng.randint(0, 6),
                size=(self.im_res, self.im_res))
        # 'frames': pre-extracted JPEG layout
        frames = []
        for t in range(T):
            p = media.select_frame_with_walkdown(rec.video_path, rec.video_id, t)
            img = media.load_image(p)
            if img.shape[:2] != (self.im_res, self.im_res):
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize(
                    (self.im_res, self.im_res), Image.BICUBIC))
            frames.append(img)
        return np.stack(frames)

    def get(self, i: int, rng: np.random.RandomState) -> AVSample:
        """Load one sample with the reference's data-level fault tolerance:
        decode errors substitute constant tensors instead of failing the run
        (src/dataloader.py:330,385,424,447,475 return 0.01-filled tensors)."""
        rec = self.index[i]
        try:
            wav, wav_len = self._load_waveform(rec)
        except Exception as e:  # noqa: BLE001 — any decode failure
            print(f"there is an error in loading audio {rec.wav}: {e}")
            wav = np.full(self.num_samples_audio, 0.01, dtype=np.float32)
            wav_len = self.num_samples_audio
        try:
            frames = self._load_frames(rec, rng)
        except Exception as e:  # noqa: BLE001
            print(f"there is an error in loading image {rec.video_path}: {e}")
            frames = np.full((self.num_frames, self.im_res, self.im_res, 3),
                             3, dtype=np.uint8)  # ~0.01 after /255
        labels = multihot_labels(rec.labels, self.index_dict, self.n_class,
                                 self.label_smooth)
        return AVSample(wav, frames, labels, wav_len)

    @staticmethod
    def _sample_rng(rng, i: int) -> np.random.RandomState:
        """Per-sample RandomState. When ``rng`` is an int seed, the stream is
        derived from (seed, key) — ORDER-INDEPENDENT, so any rank
        sharding / batch order reassembles bit-identical batches (torch's
        sequential per-worker streams make runs differ across world sizes;
        keyed derivation is the design of JAX's fold_in applied host-side).
        The key is the sample's global epoch POSITION when the caller
        provides one (``batch(..., positions=)``): weighted class-balanced
        sampling draws the same dataset index several times per epoch, and
        position keying gives each occurrence an independent augmentation
        stream (frame pick, decode aug) like torch's sequential stream does
        — index keying would train oversampled clips on one frozen draw.
        A RandomState is passed through unchanged (legacy sequential mode)."""
        if isinstance(rng, (int, np.integer)):
            return np.random.RandomState(
                (int(rng) * 1000003 + int(i) * 97 + 7) % (2 ** 31))
        return rng

    def batch(self, indices, rng, frames_per_sample: int = 1,
              positions=None):
        """Assemble a host batch. frames_per_sample: 1 (random train frame) or
        num_frames (eval). ``rng``: an int seed (per-sample derived streams,
        see _sample_rng) or a RandomState (sequential). ``positions``: the
        samples' global epoch positions — when given, they key the per-sample
        streams instead of the dataset indices (see _sample_rng). Returns
        (wav [B,n], frames u8 [B,T,H,W,3], labels [B,C]).

        Waveforms are zero-padded to a fixed sample count and the true sample
        counts are returned so the device transform can zero fbank rows
        beyond each clip's frame count — matching the reference's 0.0 fbank
        padding (dataloader.py:333-343) instead of log-eps rows from padded
        silence. Returns (wav, frames, labels, wav_len[B] int32)."""
        wavs, frames, labels = [], [], []
        lens = []
        for j, i in enumerate(indices):
            key = int(positions[j]) if positions is not None else int(i)
            srng = self._sample_rng(rng, key)
            s = self.get(int(i), srng)
            lens.append(s.wav_len)
            if frames_per_sample == 1:
                # random frame of 10 in train; middle/frame_use in eval
                # (src/dataloader.py:347-356,468-471). An explicit
                # frame_use >= 0 pins the frame in train mode too (opt-in
                # determinism for probes/debugging; the reference always
                # randomizes -1-style in train)
                if self.mode == "train":
                    t = (srng.randint(0, self.num_frames)
                         if self.frame_use < 0 else self.frame_use)
                else:
                    t = (self.num_frames // 2 if self.frame_use < 0
                         else self.frame_use)
                f = s.frames[t: t + 1]
            else:
                f = s.frames[:frames_per_sample]
            wavs.append(s.waveform)
            frames.append(f)
            labels.append(s.labels)
        return (np.stack(wavs), np.stack(frames), np.stack(labels),
                np.asarray(lens, dtype=np.int32))


# ----------------------------------------------------------------------
# Device-side transforms
# ----------------------------------------------------------------------

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of a bicubic resize along one
    axis, as ``jax.image.resize(method="bicubic")`` computes them (its
    ``compute_weight_mat`` with antialiasing): half-pixel sample centres,
    the kernel widened by in/out when shrinking, each output's weights
    normalised to sum 1."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[..., H, W, C] float32 -> [..., out_h, out_w, C]: the H and W
    weight matrices of ``resize_weights`` applied as two float32 products
    (TF32 off)."""
    H, W = x.shape[-3], x.shape[-2]
    wh = torch.from_numpy(resize_weights(H, out_h)).to(x.device)
    ww = torch.from_numpy(resize_weights(W, out_w)).to(x.device)
    with full_f32_matmul():
        x = torch.einsum("...hwc,ho->...owc", x, wh)
        return torch.einsum("...owc,wp->...opc", x, ww)


def _images_from_u8(frames_u8: torch.Tensor, im_res: int) -> torch.Tensor:
    """uint8 [B, T, H, W, 3] -> normalised float32 [B, T, 3, im_res,
    im_res]."""
    x = frames_u8.to(torch.float32) / 255.0
    H, W = x.shape[2], x.shape[3]
    if (H, W) != (im_res, im_res):
        x = bicubic_resize(x, im_res, im_res)
    return aug.normalize_image(x.permute(0, 1, 4, 2, 3))


def _fbank_with_ref_padding(cfg: AudioConfig, wav: torch.Tensor,
                            wav_len: Optional[torch.Tensor]) -> torch.Tensor:
    """The fbank of the fixed-size padded waveform [B, n], padded or cut to
    ``cfg.target_length`` frames, with the rows past each clip's true
    frame count zeroed: the reference computes the fbank on the real clip
    and zero-pads the rows (dataloader.py:333-343)."""
    fb = kaldi_fbank(wav, sample_freq=float(cfg.sample_rate),
                     num_mel_bins=cfg.num_mel_bins,
                     frame_length_ms=cfg.frame_length_ms,
                     frame_shift_ms=cfg.frame_shift_ms)
    fb = pad_or_crop_frames(fb, cfg.target_length)
    if wav_len is not None:
        ws = int(cfg.sample_rate * cfg.frame_length_ms / 1000.0)
        sh = int(cfg.sample_rate * cfg.frame_shift_ms / 1000.0)
        n_valid = 1 + torch.clamp(wav_len.to(torch.int64) - ws, min=0) // sh
        rows = torch.arange(cfg.target_length, device=fb.device)[None, :]
        fb = fb.masked_fill(~(rows < n_valid[:, None])[..., None], 0.0)
    return fb


def make_train_transform(cfg: AudioConfig, im_res: int = 224,
                         single_frame: bool = True):
    """fn(draws, wav [B, n], frames_u8 [B, T, H, W, 3], labels [B, C],
    wav_len [B]) -> (fbank [B, target_length, mel bins], image, labels), on
    the inputs' device: mixup (where ``cfg.mixup`` > 0), fbank, SpecAugment,
    normalisation, noise and roll. ``draws`` is the batch's
    ``TransformDraws`` (``ops/augment.py:draw_transform``). The mixup
    partners are the batch's rows at ``draws.perm``, or else ``partners``,
    the partners' (wav, frames_u8, labels) row by row (a process's block
    of a global batch, whose partners may lie in other blocks)."""

    def images(frames):
        img = _images_from_u8(frames, im_res)
        return img[:, 0] if single_frame else img

    def f(draws: aug.TransformDraws, wav, frames_u8, labels, wav_len=None,
          partners=None):
        B = wav.shape[0]
        img = images(frames_u8)
        if cfg.mixup > 0:
            if partners is None:
                perm = draws.perm
                wav2, img2, labels2 = wav[perm], img[perm], labels[perm]
            else:
                wav2, frames2, labels2 = partners
                img2 = images(frames2)
            coin = draws.coin < cfg.mixup
            one = torch.ones_like(draws.lam)
            lam = torch.where(coin, draws.lam, one)
            wav = aug.mixup_waveform(lam, wav, wav2)
            # the mixed clip keeps the FIRST clip's length (the reference
            # pads or crops the partner to waveform1's, dataloader.py:314-325)
            w_img = torch.where(coin, draws.img_w, one)
            bshape = (B,) + (1,) * (img.dim() - 1)
            img = (w_img.reshape(bshape) * img
                   + (1.0 - w_img.reshape(bshape)) * img2)
            lam_l = lam[:, None]
            labels = lam_l * labels + (1.0 - lam_l) * labels2
        fb = _fbank_with_ref_padding(cfg, wav, wav_len)
        fb = aug.spec_augment(fb, cfg.freqm, cfg.timem, draws.freq_u,
                              draws.time_u)
        if not cfg.skip_norm:
            fb = aug.normalize_fbank(fb, cfg.norm_mean, cfg.norm_std)
        if cfg.noise:
            fb = aug.noise_and_roll(fb, draws.noise, draws.noise_u,
                                    draws.shift)
        return fb, img, labels

    return f


def make_eval_transform(cfg: AudioConfig, im_res: int = 224,
                        single_frame: bool = False):
    """Eval: fn(wav, frames_u8, labels, wav_len) -> (fbank, image, labels),
    fbank and normalisation only; all frames kept (the multi-frame
    ensemble)."""

    def f(wav, frames_u8, labels, wav_len=None):
        img = _images_from_u8(frames_u8, im_res)
        if single_frame:
            img = img[:, 0]
        fb = _fbank_with_ref_padding(cfg, wav, wav_len)
        if not cfg.skip_norm:
            fb = aug.normalize_fbank(fb, cfg.norm_mean, cfg.norm_std)
        return fb, img, labels

    return f
