"""Audio and image augmentations on the batch's device, taking their random
draws as tensors.

Counterpart of ``avsiam_tpu/ops/augment.py`` and of the draws of
``avsiam_tpu/data/dataset.py:make_train_transform``:

* SpecAugment frequency and time masking (torchaudio's
  ``mask_along_axis``: width ~ U[0, param), start ~ U[0, size - width) from
  the continuous width, start and width floored separately), filling with 0;
* dataset normalisation (fbank - mean) / std;
* noise and time roll: U[0, 1) noise times a per-sample U[0, 1) / 10, then
  a roll of the time axis by a shift in [-target_length, target_length);
* waveform mixup with re-centring, lam ~ Beta(10, 10);
* ImageNet image normalisation.

Each op takes its draws as arguments, so a test can hand it JAX's.
``draw_transform`` makes one batch's bundle (``TransformDraws``) on the
device from an explicit ``torch.Generator``. The draws are torch's, not
threefry's: the port equals the JAX package only when it is handed JAX's
draws.

Beta(10, 10) has no generator-taking sampler in torch (``Beta`` and
``_standard_gamma`` take none), so ``mixup_lambda`` samples it as X / (X
+ Y) with X, Y ~ Gamma(10) by Marsaglia and Tsang's method, from the
explicit generator's normal and uniform draws: ``GAMMA_ROUNDS`` proposals a value,
the first accepted kept. A proposal is accepted with probability about
0.99 at shape 10, so all rounds reject with probability about 1e-16 a
value; the last proposal is kept then.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MIXUP_ALPHA = 10.0
GAMMA_ROUNDS = 8


def axis_mask(u_value: torch.Tensor, u_start: torch.Tensor, size: int,
              mask_param: int) -> torch.Tensor:
    """bool [B, size], True where masked, from two U[0, 1) draws [B] a row:
    value = u_value * param, start = floor(u_start * (size - value)), the
    interval [start, start + floor(value))."""
    value = u_value.to(torch.float32)[:, None] * mask_param
    start = torch.floor(u_start.to(torch.float32)[:, None] * (size - value))
    width = torch.floor(value)
    pos = torch.arange(size, dtype=torch.float32,
                       device=u_value.device)[None, :]
    return (pos >= start) & (pos < start + width)


def spec_augment(fbank: torch.Tensor, freqm: int, timem: int,
                 freq_u: Optional[torch.Tensor] = None,
                 time_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fbank [B, T, F] log-mel: one frequency mask, then one time mask,
    each where its param is > 0, filled with 0. ``freq_u`` and ``time_u``
    are [B, 2] U[0, 1) draws (value, start) of each mask."""
    B, T, F = fbank.shape
    if freqm > 0:
        fmask = axis_mask(freq_u[:, 0], freq_u[:, 1], F, freqm)[:, None, :]
        fbank = fbank.masked_fill(fmask, 0.0)
    if timem > 0:
        tmask = axis_mask(time_u[:, 0], time_u[:, 1], T, timem)[:, :, None]
        fbank = fbank.masked_fill(tmask, 0.0)
    return fbank


def normalize_fbank(fbank: torch.Tensor, mean: float, std: float
                    ) -> torch.Tensor:
    """(fbank - mean) / std (src/dataloader.py:505-506)."""
    return (fbank - mean) / std


def noise_and_roll(fbank: torch.Tensor, noise: torch.Tensor,
                   noise_u: torch.Tensor, shift: torch.Tensor
                   ) -> torch.Tensor:
    """fbank [B, T, F] + noise [B, T, F] (U[0, 1)) times noise_u [B] /
    10, then each sample's time axis rolled by shift [B] (an integer in
    [-target_length, target_length)): out[b, t] = in[b, (t - shift) % T]."""
    B, T, F = fbank.shape
    scale = noise_u.to(torch.float32).reshape(B, 1, 1) / 10.0
    fbank = fbank + noise * scale
    idx = torch.remainder(
        torch.arange(T, device=fbank.device)[None, :] - shift[:, None], T)
    return torch.gather(fbank, 1, idx[:, :, None].expand(B, T, F))


def _gamma_draw(shape: float, n: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """Gamma(shape, 1) [n] for shape >= 1 by Marsaglia and Tsang, from the
    generator's normal and uniform draws, ``GAMMA_ROUNDS`` proposals each."""
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn((GAMMA_ROUNDS, n), generator=generator, device=device)
    u = torch.rand((GAMMA_ROUNDS, n), generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp(min=1e-30)))
    first = torch.where(ok.any(dim=0), ok.float().argmax(dim=0),
                        torch.full((n,), GAMMA_ROUNDS - 1, device=device))
    pick = v.gather(0, first[None])[0].clamp(min=1e-30)
    return d * pick


def mixup_lambda(generator: torch.Generator, batch: int,
                 alpha: float = MIXUP_ALPHA, device=None) -> torch.Tensor:
    """lam ~ Beta(alpha, alpha) [batch] (src/dataloader.py:380) as X / (X +
    Y), X, Y ~ Gamma(alpha), on ``device`` (the generator's unless
    given)."""
    device = generator.device if device is None else torch.device(device)
    x = _gamma_draw(alpha, batch, generator, device)
    y = _gamma_draw(alpha, batch, generator, device)
    return x / (x + y)


def mixup_waveform(lam: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
                   ) -> torch.Tensor:
    """lam w1 + (1 - lam) w2, re-centred (src/dataloader.py:316-326);
    w1, w2 [B, n], lam [B]."""
    lam = lam[:, None]
    mix = lam * w1 + (1.0 - lam) * w2
    return mix - mix.mean(dim=-1, keepdim=True)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] in [0, 1] -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device).reshape(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=img.device).reshape(3, 1, 1)
    return (img - mean) / std


class TransformDraws(NamedTuple):
    """One batch's random draws of the train transform (the counterparts
    of ``make_train_transform``'s six key splits)."""

    perm: torch.Tensor       # [B] int64, the mixup partners
    coin: torch.Tensor       # [B] U[0, 1): mixed where < cfg.mixup
    lam: torch.Tensor        # [B] Beta(10, 10), the audio and label weight
    img_w: torch.Tensor      # [B] U[0, 1), the image weight
    freq_u: torch.Tensor     # [B, 2] U[0, 1): the frequency mask
    time_u: torch.Tensor     # [B, 2] U[0, 1): the time mask
    noise: torch.Tensor      # [B, T, F] U[0, 1)
    noise_u: torch.Tensor    # [B] U[0, 1): the noise scale, times 1/10
    shift: torch.Tensor      # [B] int64 in [-T, T): the time roll


def draw_transform(cfg, batch: int, generator: torch.Generator,
                   device=None) -> TransformDraws:
    """A batch's ``TransformDraws`` for audio config ``cfg`` (T =
    ``cfg.target_length``, F = ``cfg.num_mel_bins``), on ``device``
    (the generator's device unless given), from ``generator`` alone."""
    device = generator.device if device is None else torch.device(device)
    B, T, F = batch, cfg.target_length, cfg.num_mel_bins

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return TransformDraws(
        perm=torch.randperm(B, generator=generator, device=device),
        coin=uniform(B),
        lam=mixup_lambda(generator, B, device=device),
        img_w=uniform(B), freq_u=uniform(B, 2), time_u=uniform(B, 2),
        noise=uniform(B, T, F), noise_u=uniform(B),
        shift=torch.randint(-T, T, (B,), generator=generator, device=device))
