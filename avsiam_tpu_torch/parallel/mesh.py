"""The data axis of the device mesh.

Counterpart of the data part of ``avsiam_tpu/parallel/mesh.py``
(``make_mesh``, lines 29-52) and of the global-batch check of
``avsiam_tpu/train/loops.py:234-237``. The port's mesh is the process
group: one process a card, the batch split over the processes in
contiguous rank blocks, the parameters replicated. The 'model' axis (tensor
parallelism: ``_TP_RULES``, ``param_pspec``, ``param_shardings``) is not
ported (ROADMAP A10b): a mesh that asks for it is refused.
"""

from __future__ import annotations

from typing import NamedTuple

from avsiam_tpu_torch.configs import MeshConfig
from avsiam_tpu_torch.parallel.dist import world_size

class Mesh(NamedTuple):
    """The processes along the data axis, and the model axis (1)."""

    data: int
    model: int = 1


def make_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """``cfg`` resolved against the world: ``data`` is -1 (every process)
    or the world size, ``model`` is 1. Anything else raises SystemExit."""
    world = world_size()
    if cfg.model != 1:
        raise SystemExit(
            f"--mesh_model {cfg.model}: the port has no tensor parallelism "
            f"yet (the mesh's 'model' axis is ROADMAP A10b); only 1 is "
            f"taken")
    if cfg.data not in (-1, world):
        raise SystemExit(
            f"--mesh_data {cfg.data} does not match the world of {world} "
            f"process(es): the data axis is the world (-1 takes it)")
    return Mesh(data=world)


def local_batch(global_batch: int, data: int) -> int:
    """This process's rows of a global batch over ``data`` processes,
    which must divide it."""
    if global_batch % data:
        raise SystemExit(f"global batch {global_batch} not divisible by "
                         f"mesh data axis {data}")
    return global_batch // data
