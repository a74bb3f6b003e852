"""What the two job modules share: the inputs made from the seed, the
program's weights, and the readings taken from the program's state.

Every random stream of a run comes from the run's seed through
``pb_weights.chunk_seed`` with an index of its own: the weights (chunks
0, 1, ...), the input ring (``DATA``), the masking draws (``DRAWS``), the
route order (``ROUTES``). The program is handed the same inputs the
reference gets, and nothing the program computes is handed back to the
reference.
"""

from __future__ import annotations

from typing import Dict, List

import torch

import pb_weights

DATA, DRAWS, ROUTES = 1 << 40, 1 << 41, 1 << 42


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        pb_weights.chunk_seed(seed, stream))


def ring(cfg: dict, traffic: dict, seed: int, device, frames_dim: bool
         ) -> List[tuple]:
    """``traffic['ring']`` distinct batches of ``traffic['batch']`` clips
    on the device, made in two large calls: (fbank [B, T, F], frames [B,
    3, H, W], or [B, 1, 3, H, W] with ``frames_dim``). The fbank is normal
    at ``traffic['fbank_std']``, the frames unit normal (normalised
    images)."""
    v = cfg["vit"]
    n, B = traffic["ring"], traffic["batch"]
    gen = generator(seed, DATA, device)
    fb = torch.randn((n * B, v["audio_length"], v["mel_bins"]), generator=gen,
                     device=device).mul_(traffic["fbank_std"])
    fr = torch.randn((n * B, 3, v["img_size"], v["img_size"]), generator=gen,
                     device=device)
    if frames_dim:
        fr = fr[:, None]
    return [(fb[i * B:(i + 1) * B], fr[i * B:(i + 1) * B]) for i in range(n)]


def load_weights(model, spec, seed: int) -> Dict[str, torch.Tensor]:
    """Write the seed's weights into the program's model, whose parameters
    must be exactly the spec's names and shapes."""
    params = dict(model.named_parameters())
    want = {name: tuple(shape) for name, shape, _ in spec}
    have = {name: tuple(p.shape) for name, p in params.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:8]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: {diff}")
    pb_weights.fill_(spec, seed, params)
    return params


def first_grads(model, opts: Dict[str, torch.optim.Optimizer], b1: float,
                seen: Dict[str, float]) -> None:
    """Add to ``seen`` the first gradient's norm, as Adam took it, of every
    leaf (``pb_weights.parts``) whose Adam state has taken one step and
    that ``seen`` lacks: exp_avg / (1 - b1), Adam's first moment after one
    step."""
    names = {id(p): n for n, p in model.named_parameters()}
    for tag, opt in opts.items():
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p)
                key = f"{tag}:{names[id(p)]}"
                if (not st or pb_weights.parts(key, p.numel())[0][0] in seen
                        or int(st["step"]) != 1):
                    continue
                norms = pb_weights.part_norms(key, st["exp_avg"].reshape(-1))
                seen.update({k: v / (1 - b1) for k, v in norms.items()})


def _stepped(opt: torch.optim.Optimizer) -> tuple:
    """The leaves with Adam state, and each one's step count (read in one
    transfer)."""
    leaves = [p for group in opt.param_groups for p in group["params"]
              if opt.state.get(p)]
    steps = (torch.stack([torch.as_tensor(opt.state[p]["step"]).float()
                          .to(leaves[0].device) for p in leaves])
             .tolist() if leaves else [])
    return leaves, [int(k) for k in steps]


def adam_moments(opts: Dict[str, torch.optim.Optimizer]) -> dict:
    """{(tag, id(p)): (step, exp_avg)} of every leaf with Adam state, the
    first moments copied into one pinned host buffer an optimizer (a copy
    on the card would raise the run's memory peak)."""
    out = {}
    for tag, opt in opts.items():
        leaves, steps = _stepped(opt)
        host = torch.empty(sum(p.numel() for p in leaves), dtype=torch.float32,
                           pin_memory=torch.cuda.is_available())
        off = 0
        for p, k in zip(leaves, steps):
            n = p.numel()
            host[off:off + n].copy_(opt.state[p]["exp_avg"].detach().reshape(-1),
                                    non_blocking=True)
            out[(tag, id(p))] = (k, host[off:off + n])
            off += n
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def step_grads(model, opts: Dict[str, torch.optim.Optimizer], b1: float,
               before: dict, prefix: str, seen: Dict[str, float]) -> None:
    """Add to ``seen``, under ``prefix`` + ``tag:name`` (``pb_weights.parts``),
    the norm of the gradient that Adam took in the one step since
    ``before`` (``adam_moments``), of every leaf whose state stepped once
    in it: (exp_avg - b1 * exp_avg before) / (1 - b1)."""
    names = {id(p): n for n, p in model.named_parameters()}
    keys, norms = [], []
    for tag, opt in opts.items():
        leaves, steps = _stepped(opt)
        for p, k in zip(leaves, steps):
            k0, m0 = before.get((tag, id(p)), (0, None))
            if k != k0 + 1:
                continue
            m = opt.state[p]["exp_avg"].detach().reshape(-1).float()
            if m0 is not None:
                m = m - b1 * m0.to(m.device, non_blocking=True)
            for key, lo, hi in pb_weights.parts(f"{prefix}{tag}:{names[id(p)]}",
                                                m.numel()):
                keys.append(key)
                norms.append(torch.linalg.vector_norm(m[lo:hi]))
    if norms:
        seen.update({k: v / (1 - b1)
                     for k, v in zip(keys, torch.stack(norms).tolist())})


def free_cuda() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
