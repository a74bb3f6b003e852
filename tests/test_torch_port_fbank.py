"""Port parity of the data layer's device side: the Kaldi fbank, the
augmentations, the bicubic resize, the train and eval transforms, the
loader, and a pretrain step fed by each package's loader.

The port's ops take their random draws as tensors; here they are handed the
JAX package's own draws, recomputed from the same key splits as
``avsiam_tpu/data/dataset.py:make_train_transform`` and
``avsiam_tpu/ops/augment.py``. Masks, rolls and mixup partners then match
exactly. Values: the fbank to atol 5e-3, rtol 5e-4 (``tests/test_fbank.py``'s
limits: two FFTs part near the log floor), the resize to 1e-5, the
transforms to 5e-3 (their fbank), the data-fed step to
``test_torch_port_step.py``'s tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from avsiam_tpu import configs as jc
from avsiam_tpu.data import dataset as jds
from avsiam_tpu.data import pipeline as jpipe
from avsiam_tpu.ops import augment as jaug
from avsiam_tpu.ops import fbank as jfb
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.data import dataset as pds
from avsiam_tpu_torch.data import pipeline as ppipe
from avsiam_tpu_torch.ops import augment as paug
from avsiam_tpu_torch.ops import fbank as pfb
from scripts.gen_goldens import golden_waveforms
from test_torch_port_step import CHECKS, _check_first_step, _run

T = torch.from_numpy
FB_TOL = dict(atol=5e-3, rtol=5e-4)


# ------------------------------------------------------------------ fbank
def test_kaldi_fbank_matches_jax_and_golden():
    """Over the golden waveforms (``scripts/gen_goldens.py``): the port's
    ``kaldi_fbank`` and ``kaldi_fbank_np`` against the committed native
    golden and the JAX ``kaldi_fbank``, one clip at a time and as a batch."""
    golden = dict(np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                       "fbank_golden.npz")))
    for name, wav in golden_waveforms().items():
        got = pfb.kaldi_fbank(T(wav)).numpy()
        np.testing.assert_allclose(got, golden[name], **FB_TOL, err_msg=name)
        np.testing.assert_allclose(pfb.kaldi_fbank_np(wav), golden[name],
                                   **FB_TOL, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(jfb.kaldi_fbank(wav)),
                                   **FB_TOL, err_msg=name)
    rs = np.random.RandomState(2)
    wavs = (rs.randn(3, 8000) * 0.1).astype(np.float32)
    np.testing.assert_allclose(pfb.kaldi_fbank(T(wavs)).numpy(),
                               np.asarray(jfb.kaldi_fbank(wavs)), **FB_TOL)


def test_fbank_helpers_match_jax():
    """The mel banks, the window, the frame count and pad-or-crop."""
    for bins, padded, sr in ((128, 512, 16000.0), (32, 256, 8000.0)):
        np.testing.assert_array_equal(pfb.mel_banks(bins, padded, sr),
                                      jfb.mel_banks(bins, padded, sr))
    np.testing.assert_array_equal(pfb._hann_window(400),
                                  jfb._hann_window(400))
    for n in (0, 399, 400, 16000, 164480):
        assert pfb.num_frames_for(n, 16000.0) == jfb.num_frames_for(n, 16000.0)
    fb = np.random.RandomState(0).randn(2, 50, 8).astype(np.float32)
    for target in (40, 50, 64):
        np.testing.assert_array_equal(
            pfb.pad_or_crop_frames(T(fb), target).numpy(),
            np.asarray(jfb.pad_or_crop_frames(fb, target)))


# ------------------------------------------------------- the JAX draws
def _axis_draws(key, B):
    """(value, start) uniforms [B, 2] of one ``_axis_mask`` from its key."""
    k1, k2 = jax.random.split(key)
    u = [jax.random.uniform(k, (B, 1)) for k in (k1, k2)]
    return T(np.concatenate([np.asarray(x) for x in u], axis=1))


def _noise_draws(key, B, T_, F):
    """(noise, scale uniform, shift) of ``noise_and_roll`` from its key."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (T(np.array(jax.random.uniform(k1, (B, T_, F)))),
            T(np.array(jax.random.uniform(k2, (B, 1, 1))).reshape(B)),
            T(np.array(jax.random.randint(k3, (B,), -T_, T_))).long())


def jax_transform_draws(key, B, cfg) -> paug.TransformDraws:
    """``make_train_transform``'s draws from ``key`` (its six splits), as
    the port's ``TransformDraws``."""
    k_mix, k_coin, k_lam, k_imgw, k_spec, k_noise = jax.random.split(key, 6)
    kf, kt = jax.random.split(k_spec)
    noise, noise_u, shift = _noise_draws(k_noise, B, cfg.target_length,
                                         cfg.num_mel_bins)
    return paug.TransformDraws(
        perm=T(np.array(jax.random.permutation(k_mix, B))).long(),
        coin=T(np.array(jax.random.uniform(k_coin, (B,)))),
        lam=T(np.array(jaug.mixup_lambda(k_lam, B))),
        img_w=T(np.array(jax.random.uniform(k_imgw, (B,)))),
        freq_u=_axis_draws(kf, B), time_u=_axis_draws(kt, B),
        noise=noise, noise_u=noise_u, shift=shift)


# ---------------------------------------------------------- augmentations
@pytest.mark.parametrize("freqm,timem", [(12, 24), (0, 24), (12, 0)])
def test_spec_augment_matches_jax_exactly(freqm, timem):
    """From JAX's draws the same frequency and time strips are masked: the
    outputs are equal bit for bit."""
    fb = np.random.RandomState(1).randn(5, 96, 32).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kf, kt = jax.random.split(key)
    want = np.asarray(jaug.spec_augment(key, fb, freqm, timem))
    got = paug.spec_augment(T(fb), freqm, timem, _axis_draws(kf, 5),
                            _axis_draws(kt, 5)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() == (freqm + timem > 0)


def test_noise_roll_normalize_mixup_match_jax():
    """``noise_and_roll`` from JAX's draws (the same roll exactly; the
    values to 1e-6), ``normalize_fbank``, ``mixup_waveform`` and
    ``normalize_image`` to 1e-6."""
    rs = np.random.RandomState(4)
    fb = rs.randn(4, 64, 16).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jaug.noise_and_roll(key, fb, 64))
    noise, noise_u, shift = _noise_draws(key, 4, 64, 16)
    got = paug.noise_and_roll(T(fb), noise, noise_u, shift).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    zero = paug.noise_and_roll(T(fb), torch.zeros_like(noise), noise_u, shift)
    for b in range(4):  # a pure roll by each sample's shift
        np.testing.assert_array_equal(zero[b].numpy(),
                                      np.roll(fb[b], int(shift[b]), axis=0))
    np.testing.assert_allclose(
        paug.normalize_fbank(T(fb), -5.081, 4.4849).numpy(),
        np.asarray(jaug.normalize_fbank(fb, -5.081, 4.4849)), atol=1e-6)
    w1, w2 = rs.randn(2, 4, 300).astype(np.float32)
    lam = rs.rand(4).astype(np.float32)
    np.testing.assert_allclose(
        paug.mixup_waveform(T(lam), T(w1), T(w2)).numpy(),
        np.asarray(jaug.mixup_waveform(lam, w1, w2)), atol=1e-6)
    img = rs.rand(2, 3, 5, 7).astype(np.float32)
    np.testing.assert_allclose(paug.normalize_image(T(img)).numpy(),
                               np.asarray(jaug.normalize_image(img)),
                               atol=1e-6)


def test_mixup_lambda_is_beta_10_10():
    """The port's mixup lambda (Marsaglia-Tsang from an explicit generator)
    against Beta(10, 10): a Kolmogorov-Smirnov test over 20000 draws and
    the JAX package's own draws' two-sample test, each at p > 1e-3; the
    same generator seed gives the same draws."""
    draw = paug.mixup_lambda(torch.Generator().manual_seed(0), 20000).numpy()
    assert np.isfinite(draw).all() and ((draw > 0) & (draw < 1)).all()
    assert scipy.stats.kstest(draw, scipy.stats.beta(10, 10).cdf).pvalue > 1e-3
    jdraw = np.asarray(jaug.mixup_lambda(jax.random.PRNGKey(1), 20000))
    assert scipy.stats.ks_2samp(draw, jdraw).pvalue > 1e-3
    again = paug.mixup_lambda(torch.Generator().manual_seed(0),
                              20000).numpy()
    np.testing.assert_array_equal(draw, again)


def test_draw_transform_shapes_and_ranges():
    """One batch's bundle from an explicit generator: shapes, ranges, and
    the same bundle again from the same seed."""
    cfg = pc.AudioConfig(target_length=96, num_mel_bins=16)
    d = paug.draw_transform(cfg, 7, torch.Generator().manual_seed(3))
    assert sorted(d.perm.tolist()) == list(range(7))
    assert d.noise.shape == (7, 96, 16) and d.freq_u.shape == (7, 2)
    for u in (d.coin, d.img_w, d.freq_u, d.time_u, d.noise, d.noise_u,
              d.lam):
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert int(d.shift.min()) >= -96 and int(d.shift.max()) < 96
    again = paug.draw_transform(cfg, 7, torch.Generator().manual_seed(3))
    for a, b in zip(d, again):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- resize
@pytest.mark.parametrize("src,dst", [((24, 20), (48, 48)),
                                     ((48, 40), (32, 32)),
                                     ((37, 53), (37, 29))],
                         ids=["up", "down", "mixed"])
def test_bicubic_resize_matches_jax(src, dst):
    """``bicubic_resize`` against ``jax.image.resize(..., 'bicubic')``
    (Keys a = -0.5, antialiased when shrinking), to 1e-5."""
    x = np.random.RandomState(6).rand(2, 3, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 3, *dst, 3), method="bicubic"))
    got = pds.bicubic_resize(T(x), *dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------------- transforms
AUDIO = dict(num_mel_bins=32, target_length=128)
FINETUNE = dict(AUDIO, freqm=12, timem=24, mixup=0.5, noise=True)
PRETRAIN = dict(AUDIO, noise=True)


@pytest.fixture
def json_index(tmp_path):
    import json
    p = tmp_path / "idx.json"
    p.write_text(json.dumps({"data": [
        {"wav": f"/fake/{i}.wav", "labels": f"/m/{i % 3}", "video_id": f"v{i}",
         "video_path": "/fake"} for i in range(12)]}))
    return str(p)


def _host_batch(index, audio, im_res=48, n=6, seed=4):
    ds = jds.AVDataset(index, jc.AudioConfig(**audio), n_class=3,
                       frame_source="synthetic", num_frames=3, im_res=im_res)
    return ds.batch(list(range(n)), seed)


@pytest.mark.parametrize("single_frame", [True, False])
def test_train_transform_matches_jax(json_index, single_frame):
    """The train transform under the finetune recipes' augmentations
    (SpecAugment, mixup 0.5, noise; scaled to the tiny fbank), with a
    bicubic resize of the frames 48 -> 32, from JAX's draws: fbank to 5e-3,
    image and labels to 1e-5."""
    wav, frames, labels, wav_len = _host_batch(json_index, FINETUNE)
    frames = frames if single_frame else np.concatenate([frames] * 2, 1)
    key = jax.random.PRNGKey(9)
    jt = jds.make_train_transform(jc.AudioConfig(**FINETUNE), im_res=32,
                                  single_frame=single_frame)
    want = [np.asarray(x) for x in jt(key, wav, frames, labels, wav_len)]
    cfg = pc.AudioConfig(**FINETUNE)
    draws = jax_transform_draws(key, len(wav), cfg)
    assert bool((draws.coin < 0.5).any()) and bool((draws.coin >= 0.5).any())
    pt = pds.make_train_transform(cfg, im_res=32, single_frame=single_frame)
    got = [x.numpy() for x in pt(draws, T(wav), T(frames), T(labels),
                                 T(wav_len))]
    np.testing.assert_allclose(got[0], want[0], **FB_TOL)
    np.testing.assert_array_equal(got[0] == 0, want[0] == 0)  # the masks
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)


def test_eval_transform_matches_jax(json_index):
    """The eval transform (fbank, normalisation; every frame) on a batch
    whose clips are cut short by ``wav_len`` (their rows past the clip
    zeroed before the normalisation): fbank to 5e-3, image to 1e-5."""
    wav, frames, labels, wav_len = _host_batch(json_index, AUDIO)
    wav_len = (wav_len * np.linspace(0.3, 1.0, len(wav_len))).astype(np.int32)
    jt = jds.make_eval_transform(jc.AudioConfig(**AUDIO), im_res=48)
    want = [np.asarray(x) for x in jt(wav, frames, labels, wav_len)]
    pt = pds.make_eval_transform(pc.AudioConfig(**AUDIO), im_res=48)
    got = [x.numpy() for x in pt(T(wav), T(frames), T(labels), T(wav_len))]
    np.testing.assert_allclose(got[0], want[0], **FB_TOL)
    np.testing.assert_allclose(got[0][0, -10:], 5.081 / 4.4849, rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])


def test_device_loader_on_the_cpu(json_index):
    """The port's ``device_loader`` on the CPU yields, batch by batch, the
    transform of the host batch under the draws of the generator keyed on
    (draw seed, batch index); another draw seed gives other draws."""
    cfg = pc.AudioConfig(**PRETRAIN)
    ds = pds.AVDataset(json_index, cfg, n_class=3, frame_source="synthetic",
                       num_frames=3, im_res=48)
    tr = pds.make_train_transform(cfg, im_res=48)
    idx = [np.arange(0, 4), np.arange(4, 8), np.arange(8, 12)]
    out = list(ppipe.device_loader(ds, idx, tr, draw_seed=5, seed=2,
                                   device="cpu"))
    assert len(out) == 3
    for i, (fb, img, y) in enumerate(out):
        host = ds.batch(idx[i], 2)
        gen = torch.Generator().manual_seed(ppipe.batch_generator_seed(5, i))
        want = tr(paug.draw_transform(cfg, 4, gen), *(T(h) for h in host))
        for g, w in zip((fb, img, y), want):
            assert torch.equal(g, w)
    seeds = {ppipe.batch_generator_seed(s, i) for s in (5, 6)
             for i in range(3)}
    assert len(seeds) == 6
    other = next(iter(ppipe.device_loader(ds, idx, tr, draw_seed=6, seed=2,
                                          device="cpu")))
    assert not torch.equal(other[0], out[0][0])


# ------------------------------------------------------ a data-fed step
@pytest.fixture(scope="module")
def data_fed_run(tmp_path_factory):
    """One step of each package, each fed by its own loader and transform
    (pretrain recipe: noise and roll, no SpecAugment or mixup) over the
    same synthetic clips, the port handed the JAX transform's draws: the
    JAX package's dense MLP against the port's 'lnfres', as
    ``test_torch_port_step``'s first fixture."""
    import json
    p = tmp_path_factory.mktemp("data") / "idx.json"
    p.write_text(json.dumps({"data": [
        {"wav": f"/fake/{i}.wav", "labels": ""} for i in range(6)]}))
    jcfg, pcfg = jc.AudioConfig(**PRETRAIN), pc.AudioConfig(**PRETRAIN)
    args = dict(frame_source="synthetic", im_res=48)
    jds_, pds_ = jds.AVDataset(str(p), jcfg, **args), pds.AVDataset(
        str(p), pcfg, **args)
    idx = [np.arange(6)]
    key = jax.random.PRNGKey(21)
    jbatch = next(iter(jpipe.device_loader(
        jds_, idx, jds.make_train_transform(jcfg, im_res=48), key, seed=3)))
    # the loader's draws for batch 0: fold_in(key, 0)
    draws = jax_transform_draws(jax.random.fold_in(key, 0), 6, pcfg)
    ptr = pds.make_train_transform(pcfg, im_res=48)
    host = next(ppipe.host_batches(pds_, idx, 3))
    pbatch = ptr(draws, *(T(h) for h in host))
    ja, jv = (np.asarray(x, np.float32) for x in jbatch[:2])
    pa, pv = (x.numpy() for x in pbatch[:2])
    np.testing.assert_allclose(pa, ja, **FB_TOL)
    np.testing.assert_allclose(pv, jv, atol=1e-5, rtol=0)
    return _run(dict(mlp_impl="dense"), {}, n_steps=1,
                batches=((ja, jv), (pa, pv)))


@pytest.mark.parametrize("check", CHECKS)
def test_data_fed_step_matches_jax(data_fed_run, check):
    """The step's checks of ``test_torch_port_step`` (metrics, both passes'
    gradients, parameters, both Adams' moments), with its tolerances, on a
    batch from each package's own loader and transform."""
    _check_first_step(data_fed_run, check)
