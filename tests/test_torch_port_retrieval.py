"""Port parity of retrieval (``eval/retrieval.py``, ``cli/retrieval.py``).

- ``compute_metrics`` and ``retrieval_metrics`` against the JAX package's
  on random similarities and features, with ties in the rows (the rank
  rule counts every position that holds the diagonal's value): equal.
- ``extract_features``: the port's 'retrieval' forward, mean-pooled, over
  the eval transform, against the JAX function on the JAX model at the
  tiny geometry (ViT dim 128, 2 heads, depth 1, float32; the JAX model on
  its XLA attention and dense MLP), from the same parameters
  (``params_from_jax``) and clips: within 1e-5 relative.
- Both runners on one reference-format ``.pth`` (the 'tiny' preset,
  'synthetic' clips), the JAX ``main`` run as its own tests run it on the
  CPU: the same ``retrieval_result.csv``.
"""

import argparse
import csv
import os

import jax
import numpy as np
import pytest
import torch

from avsiam_tpu import configs as jc
from avsiam_tpu.cli import retrieval as jcli
from avsiam_tpu.data.dataset import AVDataset as JaxDataset
from avsiam_tpu.eval import retrieval as jret
from avsiam_tpu.models.cavmae_ft import CAVMAEFinetune as JaxModel
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.cli import retrieval as cli
from avsiam_tpu_torch.data.dataset import AVDataset
from avsiam_tpu_torch.eval import retrieval as ret
from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
from avsiam_tpu_torch.models.variants import finetune_config
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import VIT
from test_torch_port_ft_loops import _reference_sd


def _similarities(seed, n, ties):
    """[n, n] similarities; with ``ties`` drawn from a few levels, so rows
    hold repeated values, the diagonal's among them."""
    rs = np.random.RandomState(seed)
    if ties:
        return rs.randint(0, 3, size=(n, n)).astype(np.float64) / 2
    return rs.randn(n, n)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("seed,n", [(0, 7), (1, 16), (2, 33)])
def test_compute_metrics_matches_jax(seed, n, ties):
    sim = _similarities(seed, n, ties)
    assert ret.compute_metrics(sim) == jret.compute_metrics(sim)


@pytest.mark.parametrize("direction", ["audio", "video"])
def test_retrieval_metrics_match_jax(direction):
    rs = np.random.RandomState(4)
    a, v = rs.randn(20, 8), rs.randn(20, 8)
    v[:5] = a[:5]  # a few exact matches
    assert (ret.retrieval_metrics(a, v, direction)
            == jret.retrieval_metrics(a, v, direction))
    tok_a, tok_v = rs.randn(3, 5, 4), rs.randn(3, 6, 4)
    for got, want in zip(ret.pooled_features(tok_a, tok_v),
                         jret.pooled_features(tok_a, tok_v)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def index_json(tmp_path):
    p = tmp_path / "idx.json"
    p.write_text('{"data": [%s]}' % ", ".join(
        '{"wav": "/fake/%d.wav", "labels": "/m/%d"}' % (i, i % 3)
        for i in range(10)))
    csvp = tmp_path / "labels.csv"
    csvp.write_text("index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n2,/m/2,c\n")
    return str(p), str(csvp)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_extract_features_matches_jax(index_json):
    """The port's ``extract_features`` against the JAX function: the same
    clips (batches of 4 from one ``RandomState(0)`` stream), the same
    parameters; both modalities within 1e-5 relative."""
    path, csvp = index_json
    args = argparse.Namespace(
        batch_size=4, target_length=VIT["audio_length"], dataset_mean=-5.081,
        dataset_std=4.4849, freqm=0, timem=0, mixup=0.0, noise=False)
    jcfg = jc.CAVMAEFTConfig(vit=jc.ViTConfig(**VIT), label_dim=3,
                             attn_impl="xla", mlp_impl="dense")
    pcfg = pc.CAVMAEFTConfig(vit=pc.ViTConfig(**VIT), label_dim=3)
    kw = dict(label_csv=csvp, mode="eval", frame_source="synthetic",
              im_res=VIT["img_size"], frame_use=5)
    jds = JaxDataset(path, jc.AudioConfig(
        target_length=VIT["audio_length"], num_mel_bins=VIT["mel_bins"]),
        **kw)
    pds = AVDataset(path, pc.AudioConfig(
        target_length=VIT["audio_length"], num_mel_bins=VIT["mel_bins"]),
        **kw)
    a = np.zeros((1, VIT["audio_length"], VIT["mel_bins"]), np.float32)
    v = np.zeros((1, 10, 3, VIT["img_size"], VIT["img_size"]), np.float32)
    params = jax.device_get(jax.jit(lambda r: JaxModel(jcfg).init(
        r, a, v, "retrieval"))(jax.random.PRNGKey(0))["params"])
    want = jcli.extract_features(args, jcfg, params, jds)
    model = CAVMAEFinetune(pcfg, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    got = cli.extract_features(args, model, pds)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (10, VIT["dim"])
        assert _rel(g, w) <= 1e-5


def _rows(path):
    with open(os.path.join(path, "retrieval_result.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_runners_write_the_same_result_from_one_pth(tmp_path, index_json,
                                                    monkeypatch):
    """Both runners on one reference-format ``.pth`` over the same 10
    clips: the same ``retrieval_result.csv``."""
    path, csvp = index_json
    fresh = CAVMAEFinetune(finetune_config("tiny", 3), "cpu").state_dict()
    torch.save(_reference_sd(fresh, 2), tmp_path / "ref.pth")

    def argv(exp):
        return ["--data-eval", path, "--label-csv", csvp, "--n_class", "3",
                "--model", "tiny", "--batch-size", "4", "--frame_source",
                "synthetic", "--exp-dir", str(tmp_path / exp), "--dtype",
                "float32", "--target_length", "128", "--directions",
                "audio,video", "--pretrain_path", str(tmp_path / "ref.pth")]

    monkeypatch.setenv("AVSIAM_PLATFORM", "cpu")
    want = jcli.main(argv("jax"))
    got = cli.main(argv("port"))
    assert [r["direction"] for r in got] == ["audio", "video"]
    assert got == want
    assert _rows(tmp_path / "port") == _rows(tmp_path / "jax")
