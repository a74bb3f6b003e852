"""The weights, made on the device from the seed.

Every parameter of a ``param_spec`` is a segment of one long stream of
standard normals, drawn in chunks of ``CHUNK`` values, each chunk from a
generator on the device seeded from (seed, chunk index): a few large calls,
and any chunk can be drawn again alone. A leaf is ``base + scale * z`` by
its kind: a dense weight N(0, 1/fan_in) (lecun-normal, untruncated), a bias
0.02 z, a LayerNorm scale 1 + 0.1 z and its bias 0.02 z (so that the 'a',
'v' and shared norm sets differ), an embedding or token 0.02 z.

``change_norms`` draws the chunks again to read how far each parameter has
moved from where it started, without keeping a copy of the start.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 26
_KIND = {"matrix": None, "bias": (0.0, 0.02), "ln_weight": (1.0, 0.1),
         "ln_bias": (0.0, 0.02), "embed": (0.0, 0.02)}


def chunk_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed from a run's seed (any size) and a stream
    index."""
    return (int(seed) * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9
            + 0x94D049BB133111EB) % (1 << 63)


def base_scale(shape, kind: str) -> Tuple[float, float]:
    if kind == "matrix":
        return 0.0, float(shape[-1]) ** -0.5
    return _KIND[kind]


def parts(name: str, numel: int) -> List[Tuple[str, int, int]]:
    """The leaves the correctness check compares within a parameter, as
    (key, flat lo, hi): the fused qkv projection's weight and bias are
    three projections, q, k and v, each a leaf of its own (their thirds
    along the output rows are contiguous); any other parameter is one
    leaf. The key's bias has no gradient but round-off under softmax, so
    only the split lets the check leave it out by its gradient."""
    if ".qkv." in name:
        third = numel // 3
        return [(f"{name}[{p}]", i * third, (i + 1) * third)
                for i, p in enumerate("qkv")]
    return [(name, 0, numel)]


def part_norms(name: str, flat: torch.Tensor) -> Dict[str, float]:
    """{key: L2 norm} of a parameter-shaped tensor's leaves (``parts``)."""
    return {key: float(torch.linalg.vector_norm(flat[lo:hi]))
            for key, lo, hi in parts(name, flat.numel())}


def _layout(spec) -> List[Tuple[str, tuple, str, int, int]]:
    out, off = [], 0
    for name, shape, kind in spec:
        n = 1
        for s in shape:
            n *= s
        out.append((name, tuple(shape), kind, off, off + n))
        off += n
    return out


def _segments(spec, seed: int, device) -> Iterator[tuple]:
    """(name, shape, kind, leaf slice lo, hi, values) for every piece of a
    leaf inside one chunk, chunk by chunk."""
    layout = _layout(spec)
    total = layout[-1][4] if layout else 0
    for c, lo in enumerate(range(0, total, CHUNK)):
        hi = min(lo + CHUNK, total)
        gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, c))
        z = torch.randn(hi - lo, generator=gen, device=device)
        for name, shape, kind, a, b in layout:
            if b <= lo or a >= hi:
                continue
            s, e = max(a, lo), min(b, hi)
            yield name, shape, kind, s - a, e - a, z[s - lo:e - lo]
        del z


def fill_(spec, seed: int, params: Dict[str, torch.Tensor]) -> None:
    """Write the seed's weights into ``params`` (name -> float32 tensor of
    the spec's shape, on one device), in place."""
    device = next(iter(params.values())).device
    with torch.no_grad():
        for name, shape, kind, a, b, z in _segments(spec, seed, device):
            base, scale = base_scale(shape, kind)
            params[name].view(-1)[a:b] = z * scale + base


def make(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights as new float32 tensors on ``device``."""
    params = {name: torch.empty(shape, dtype=torch.float32, device=device)
              for name, shape, _ in spec}
    fill_(spec, seed, params)
    return params


def change_norms(spec, seed: int, params: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """leaf key (``parts``) -> the L2 norm of how far ``params`` have moved
    from the seed's weights."""
    device = next(iter(params.values())).device
    sq: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for name, shape, kind, a, b, z in _segments(spec, seed, device):
            base, scale = base_scale(shape, kind)
            d = params[name].reshape(-1)[a:b].float() - (z * scale + base)
            for key, lo, hi in parts(name, params[name].numel()):
                s, e = max(lo, a), min(hi, b)
                if s < e:
                    piece = d[s - a:e - a]
                    sq[key] = sq.get(key, 0.0) + torch.dot(piece, piece).double()
    return {k: float(torch.as_tensor(v).sqrt()) for k, v in sq.items()}
