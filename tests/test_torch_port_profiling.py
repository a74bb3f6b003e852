"""The port's profiling helpers (``utils/profiling.py``) and memory probe
(``cli/memory_probe.py``) against the JAX package's.

- ``device_memory_stats``: None on the CPU.
- ``trace`` writes a Chrome trace holding an ``annotate`` span.
- The memory probe's ``main`` at the tiny preset, B 2, one float32 step
  on the CPU (``AVSIAM_PLATFORM=cpu``): ``params_million`` 0.167 and
  ``optimizer_state_million`` 0.382, the JAX probe's printed values, and
  the unrounded counts equal to the JAX probe's own count of its initial
  state (``jax.eval_shape``: the parameters, and optax's state of the two
  masked Adams, both moments of each stepped parameter and one count
  each).
"""

import json

import jax
import jax.numpy as jnp
import torch

from avsiam_tpu.cli import memory_probe as jprobe
from avsiam_tpu_torch.cli import memory_probe as probe
from avsiam_tpu_torch.utils import profiling as prof

TINY = ["--model", "tiny", "--batch-size", "2", "--steps", "1", "--dtype",
        "float32"]


def test_device_memory_stats_is_none_on_the_cpu():
    assert prof.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert prof.device_memory_stats() is None


def test_trace_writes_a_chrome_trace_with_its_spans(tmp_path):
    with prof.trace(str(tmp_path)):
        with prof.annotate("probe_span"):
            torch.ones(4).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "probe_span" in names


def _jax_counts():
    """(parameters, optimizer state) the JAX probe counts at the tiny
    preset, from the shapes of its initial state."""
    from avsiam_tpu.configs import OptimizerConfig, PretrainConfig
    from avsiam_tpu.models import CAVMAEPretrain
    from avsiam_tpu.models.variants import pretrain_config
    from avsiam_tpu.train.pretrain import init_state
    mc = pretrain_config("tiny", dtype=jnp.float32)
    cfg = PretrainConfig(model=mc, opt=OptimizerConfig(), batch_size=2)
    v = mc.vit
    a = jnp.ones((2, v.audio_length, v.mel_bins))
    f = jnp.ones((2, 3, v.img_size, v.img_size))
    state = jax.eval_shape(lambda: init_state(
        jax.random.PRNGKey(0), CAVMAEPretrain(mc), cfg, (a, f)))
    return (jprobe.count_params(state.params),
            jprobe.count_params((state.opt1, state.opt2)))


def test_memory_probe_counts_match_jax(monkeypatch, capsys):
    monkeypatch.setenv("AVSIAM_PLATFORM", "cpu")
    out = probe.main(TINY)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert (out["params_million"], out["optimizer_state_million"]) == (
        0.167, 0.382)
    assert out["batch_size"] == 2 and out["memory"] is None
    n_params, n_opt = _jax_counts()
    assert (round(n_params / 1e6, 3), round(n_opt / 1e6, 3)) == (0.167,
                                                                 0.382)
    from avsiam_tpu_torch.configs import OptimizerConfig, PretrainConfig
    from avsiam_tpu_torch.models.variants import pretrain_config
    from avsiam_tpu_torch.train.pretrain import init_state
    state = init_state(PretrainConfig(
        model=pretrain_config("tiny"), opt=OptimizerConfig(), batch_size=2),
        torch.Generator().manual_seed(0), "cpu")
    assert probe.count_params(state.model.parameters()) == n_params
    assert sum(probe.optimizer_state_size(o)
               for o in (state.opt1, state.opt2)) == n_opt


def test_memory_probe_flags_match_jax():
    """The same flags and defaults as the JAX probe's parser (which it
    builds inside ``main``)."""
    got = vars(probe.build_parser().parse_args([]))
    assert got == dict(model="cav-mae-base", batch_size=8, steps=3,
                       dtype="bfloat16")
    assert vars(probe.build_parser().parse_args(TINY)) == dict(
        model="tiny", batch_size=2, steps=1, dtype="float32")
