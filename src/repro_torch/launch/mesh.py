"""Production mesh construction + rollout/train pool partitioning: the port
of the JAX package's ``launch/mesh.py``.

The meshes are ``torch.distributed.device_mesh.DeviceMesh``es with the
reference's shapes and axis names, over the ranks of the default process
group, which the caller creates (and destroys).  One card holds no
256-rank mesh: ``fake_process_group`` gives one process every rank of a
world of torch's fake backend (``FakeStore``, backend ``"fake"``), whose
collectives move no data — enough to build meshes and plans over them and
to issue DTensor redistributions for their shapes.  Importing this module
touches no process group.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` ranks on torch's fake
    backend, this process rank 0, destroyed on exit.  Refuses to replace a
    group that already exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], first_rank: int = 0) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a default process group of at "
                           f"least {first_rank + n} ranks (fake_process_group)")
    if dist.get_world_size() < first_rank + n:
        raise RuntimeError(f"need {first_rank + n} ranks, have {dist.get_world_size()}")
    ranks = torch.arange(first_rank, first_rank + n).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """One pod = 16x16 = 256 devices (data, model); two pods add a leading
    `pod` axis (pure DP across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh() -> DeviceMesh:
    """Degenerate 1x1 mesh over rank 0 (tests / examples)."""
    return _mesh((1, 1), ("data", "model"))


def split_rollout_train_pools(*, train_chips: int, infer_chips: int,
                              model_parallel: int = 16) -> Tuple[DeviceMesh, DeviceMesh]:
    """Rollout-train decoupling at the resource level (paper Fig 3a: e.g.
    16Train24Infer): partition the ranks into two disjoint meshes.

    The trainer mesh is (train_chips/model, model) over the first
    ``train_chips`` ranks; the rollout mesh is (infer_chips/model, model)
    over the next ``infer_chips``.
    """
    assert train_chips % model_parallel == 0 and infer_chips % model_parallel == 0
    if dist.is_initialized() and dist.get_world_size() < train_chips + infer_chips:
        raise RuntimeError(f"need {train_chips + infer_chips} devices, "
                           f"have {dist.get_world_size()}")
    train = _mesh((train_chips // model_parallel, model_parallel), ("data", "model"))
    infer = _mesh((infer_chips // model_parallel, model_parallel), ("data", "model"),
                  first_rank=train_chips)
    return train, infer
