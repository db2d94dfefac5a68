"""Shard layouts of a training state: the numpy part of the mesh module.

Counterpart of ``ShardSpec``, ``padded_len`` and ``repad_flat`` in
``distributed_machine_learning_tpu/runtime/mesh.py``: the metadata a
checkpoint carries so it can be restored onto another world size.  The
device mesh itself (``make_mesh``, ``shard_map``) has no counterpart: the
port's ranks are ``torch.distributed`` processes (``runtime/distributed.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

BATCH_AXIS = "batch"

# The state layouts a checkpoint can be saved under: replicated data
# parallelism, ZeRO-1 (params replicated, momentum sharded) and ZeRO-3/FSDP
# (both sharded).  The flat-shard layouts pad their vectors to a multiple
# of the world size, which is what a world-size change must redo.
SHARD_LAYOUTS = ("dp", "zero1", "fsdp")


def padded_len(n_elems: int, world: int) -> int:
    """Length of a flat param/momentum vector after padding to a multiple
    of ``world``: the one definition the flat-shard schemes and the
    checkpoint resharder share, so partition boundaries agree."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    return -(-n_elems // world) * world


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a training state is laid out across a data-parallel world.

    ``layout``: one of :data:`SHARD_LAYOUTS`.  ``world``: the data-axis
    size the state was built for.  ``n_elems``: the unpadded length of the
    flat param/momentum vectors (zero1/fsdp: the logical array a reshard
    keeps bit for bit; None for dp, whose leaves carry no padding).
    """

    layout: str
    world: int
    n_elems: int | None = None

    def __post_init__(self):
        if self.layout not in SHARD_LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; known: {SHARD_LAYOUTS}")
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        if self.layout != "dp" and self.n_elems is None:
            raise ValueError(f"layout {self.layout!r} needs n_elems (the unpadded "
                             "flat length) to recompute partition boundaries")

    @property
    def padded(self) -> int | None:
        """The padded flat length under this spec, or None for dp."""
        return None if self.n_elems is None else padded_len(self.n_elems, self.world)

    def with_world(self, world: int) -> "ShardSpec":
        """The same layout laid out for another world size."""
        return dataclasses.replace(self, world=world)

    def as_dict(self) -> dict:
        return {"layout": self.layout, "world": self.world, "n_elems": self.n_elems}

    @classmethod
    def from_dict(cls, payload: dict) -> "ShardSpec":
        return cls(layout=str(payload["layout"]), world=int(payload["world"]),
                   n_elems=(None if payload.get("n_elems") is None
                            else int(payload["n_elems"])))


def repad_flat(flat: np.ndarray, n_elems: int, world: int) -> np.ndarray:
    """One flat padded vector laid out for a new world size: the logical
    prefix ``flat[:n_elems]`` kept bit for bit, the padded length
    recomputed for ``world``, the new tail zero."""
    flat = np.asarray(flat)
    if flat.ndim != 1:
        raise ValueError(f"expected a flat vector, got shape {flat.shape}")
    if flat.shape[0] < n_elems:
        raise ValueError(f"flat vector of {flat.shape[0]} elements cannot hold "
                         f"n_elems={n_elems} logical values")
    out = np.zeros((padded_len(n_elems, world),), dtype=flat.dtype)
    out[:n_elems] = flat[:n_elems]
    return out
