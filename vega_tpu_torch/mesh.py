"""The shard model on one device: n virtual shards held as the leading
dimension of every column tensor ([n_shards, capacity]) on one torch
device. Counterpart of vega_tpu/tpu/mesh.py (make_mesh, shard_spec): where
the reference places shard s on mesh device s, the port places it in row s
of each tensor, so both packages place rows shard for shard."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from vega_tpu_torch.errors import VegaError


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device a Context runs on: the one given, else the first CUDA
    card. With no card and no device given this raises: the port never
    runs on the CPU unless the caller asks for it."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise VegaError(f"device {dev} requested but CUDA is not "
                            "available")
        return dev
    if not torch.cuda.is_available():
        raise VegaError("no CUDA device available; pass device='cpu' to "
                        "run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """n_shards virtual shards on one device."""

    n_shards: int
    device: torch.device

    def __post_init__(self):
        if self.n_shards < 1:
            raise VegaError(f"n_shards must be >= 1, got {self.n_shards}")


def make_mesh(n_shards: int, device=None) -> ShardMesh:
    return ShardMesh(n_shards, resolve_device(device))
