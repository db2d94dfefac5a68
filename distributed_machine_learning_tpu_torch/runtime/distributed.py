"""Multi-process bootstrap and the transport the gradient sync runs over.

Counterpart of ``distributed_machine_learning_tpu/runtime/distributed.py``.
The reference rendezvouses over raw TCP,
``dist.init_process_group("gloo", init_method="tcp://" + master_ip,
world_size=num_nodes, rank=rank)`` (``part2/2a/main.py:197``), with the
flags ``--master-ip`` (default ``127.0.1.1:8000``), ``--rank`` and
``--num-nodes``.  The JAX package maps them onto its coordination service
and runs every rank of a host in one process; the port goes back to the
reference's shape: one process per rank, through ``torch.distributed``.
``num_nodes == 1`` initializes nothing, as the reference's part1 never
calls ``init_process_group``.

The ranks rendezvous first (``torch.distributed.rendezvous``: a store,
for ``tcp://`` and ``file://`` alike) and publish their placement there:
the host name and the UUIDs of the cards the process sees (none under
``--device cpu``).  Every rank reads all of them and computes the same
plan (:func:`plan_placement`): its local rank is its index among the
ranks of its host, its device ``cuda:{local_rank % visible}``, and the
backend follows where the ranks really are:

- ``nccl`` when every rank is on a card and no two ranks share one (the
  (host, card UUID) pairs are pairwise distinct): one host with a card
  per rank, many hosts with a card each, or a launcher that gives each
  process one visible card;
- ``gloo`` when ranks share a card or run on the CPU: NCCL refuses two
  ranks on one device.

gloo's ``send``/``recv``/``all_gather`` take CPU tensors only, so under
gloo with CUDA tensors :class:`Comm` stages every payload through host
buffers itself (the "host" wire).  That is a choice of wire, stated in the
run's banner, not a fallback: compute and the codec kernels stay on the
card, and a failure under the chosen backend raises.
"""

from __future__ import annotations

import datetime
import itertools
import json
import math
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from distributed_machine_learning_tpu_torch import resolve_device

# Reference defaults (part2/2a/main.py:213-215).
DEFAULT_MASTER_IP = "127.0.1.1:8000"
# Rendezvous and collective timeout: a rank that never arrives (or dies)
# fails the run instead of hanging it.
TIMEOUT_S = 300.0


# A rank's placement as it publishes it: (host name, UUIDs of the cards
# the process sees, or None on the CPU).
Placement = tuple[str, tuple[str, ...] | None]


def plan_placement(peers: list, rank: int) -> tuple[str, int, int | None]:
    """``(backend, local_rank, device_index)`` of ``rank`` from every rank's
    :data:`Placement` (``peers[r]`` is rank r's).  Pure, so every rank
    computes the same plan from the same exchanged placements.

    The local rank is the rank's index among the ranks of its host (in rank
    order); its device is ``local_rank % visible`` (None on the CPU).  The
    backend is ``nccl`` iff every rank is on CUDA and the (host, card UUID)
    pairs of all ranks are pairwise distinct, else ``gloo``."""
    cards = []
    for r, (host, uuids) in enumerate(peers):
        if not uuids:
            cards.append(None)
            continue
        local = sum(1 for h, _ in peers[:r] if h == host)
        cards.append((host, uuids[local % len(uuids)]))
    host, uuids = peers[rank]
    local_rank = sum(1 for h, _ in peers[:rank] if h == host)
    device_index = local_rank % len(uuids) if uuids else None
    own_card = None not in cards and len(set(cards)) == len(cards)
    return ("nccl" if own_card else "gloo"), local_rank, device_index


def local_placement(device: torch.device) -> Placement:
    """This process's :data:`Placement`: its host name and the UUIDs of the
    cards it sees (None when it runs on the CPU)."""
    if device.type != "cuda":
        return socket.gethostname(), None
    return socket.gethostname(), tuple(
        str(torch.cuda.get_device_properties(i).uuid)
        for i in range(torch.cuda.device_count()))


def exchange_placements(store, rank: int, world: int, mine: Placement) -> list:
    """Publish ``mine`` in ``store`` and read every rank's, in rank order
    (each read waits for its rank, up to the store's timeout)."""
    store.set(f"placement/{rank}", json.dumps(mine))
    peers = []
    for r in range(world):
        host, uuids = json.loads(store.get(f"placement/{r}"))
        peers.append((host, None if uuids is None else tuple(uuids)))
    return peers


class Comm:
    """The point-to-point and collective calls the sync strategies use,
    for this rank of a ``world``-rank group (the default process group, or
    one axis of a mesh: :func:`mesh_comms`).

    ``wire`` says how payloads travel: ``"nccl"``, ``"gloo"`` (CPU tensors)
    or ``"host"`` (gloo with CUDA tensors: each payload is copied to a host
    buffer, sent, and copied back to the card).  At world 1 every call is
    the identity."""

    def __init__(self, rank: int = 0, world: int = 1, backend: str | None = None,
                 device: torch.device | None = None, group=None, ranks=None):
        self.rank, self.world, self.backend = rank, world, backend
        self.device = device or torch.device("cpu")
        # A subgroup (``mesh_comms``): its process group and the global ranks
        # of its members in group-rank order; None and 0..W-1 for the default
        # group.  Every call takes group ranks.
        self.group = group
        self.ranks = tuple(range(world)) if ranks is None else tuple(ranks)
        self.host = backend == "gloo" and self.device.type == "cuda"
        # Set by the flat-shard overlap step from a gather's dispatch on its
        # background thread to its join: no other collective may run then.
        self.gather_in_flight = False

    @property
    def wire(self) -> str:
        if self.world == 1:
            return "none"
        return "host" if self.host else self.backend

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host else t

    def send_recv(self, payload: tuple, dst: int, src: int) -> tuple:
        """One ring hop, as one ``batch_isend_irecv``: send each tensor of
        ``payload`` to ``dst`` and return the same-shaped tensors received
        from ``src`` (every rank's payloads share shapes and dtypes)."""
        if self.world == 1:
            return tuple(payload)
        outs = [self._out(t.contiguous()) for t in payload]
        ins = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in outs]
        g, peer = self.group, self.ranks
        ops = [dist.P2POp(dist.isend, t, peer[dst], g, tag=i) for i, t in enumerate(outs)]
        ops += [dist.P2POp(dist.irecv, t, peer[src], g, tag=i) for i, t in enumerate(ins)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(t.to(p.device) for t, p in zip(ins, payload)) if self.host else tuple(ins)

    def shift(self, payload: tuple, offset: int = 1) -> tuple:
        """One ring hop: send ``payload`` to rank + ``offset`` and receive
        rank − ``offset``'s (the reference's ``lax.ppermute`` over the
        ring; ``offset=-1`` is its transpose)."""
        n = self.world
        return self.send_recv(payload, (self.rank + offset) % n, (self.rank - offset) % n)

    def exchange(self, sends: list, recvs: list) -> list:
        """One batch of point-to-point messages, posted together (one
        ``batch_isend_irecv``, so two ranks that send each other never wait
        on each other): ``sends`` holds ``(tensor, dst, tag)``, ``recvs``
        ``(shape, dtype, src, tag)``; returns the received tensors on this
        rank's device, in ``recvs``' order.  Both sides must list the
        messages between two ranks in one order (the tags ascending)."""
        if not sends and not recvs:
            return []
        g, peer = self.group, self.ranks
        outs = [(self._out(t.contiguous()), dst, tag) for t, dst, tag in sends]
        dev = torch.device("cpu") if self.host else self.device
        ins = [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype, _, _ in recvs]
        ops = [dist.P2POp(dist.isend, t, peer[dst], g, tag=tag) for t, dst, tag in outs]
        ops += [dist.P2POp(dist.irecv, t, peer[src], g, tag=tag)
                for t, (_, _, src, tag) in zip(ins, recvs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [t.to(self.device) for t in ins] if self.host else ins

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t``, in rank order, on this rank's device."""
        if self.world == 1:
            return [t]
        src = self._out(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        return [p.to(t.device) for p in parts] if self.host else parts

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (``op="max"``: the maximum of) ``t`` over the ranks, in place;
        returns ``t``."""
        if self.world == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if not self.host:
            dist.all_reduce(t, red, group=self.group)
            return t
        host = t.cpu()
        dist.all_reduce(host, red, group=self.group)
        return t.copy_(host)

    def _back(self, out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return out.to(like.device) if self.host else out

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """Split ``t`` into W blocks along ``split_dim``, send block r to rank
        r, and concatenate the blocks that arrive along ``concat_dim`` in
        rank order: the reference's ``lax.all_to_all(..., tiled=True)``.
        One ``all_to_all_single`` on every wire (gloo takes it on CPU
        tensors, so the host wire stages through host buffers)."""
        n = self.world
        if n == 1:
            return t
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} is not "
                             f"divisible by {n} ranks")
        split_dim %= t.dim()
        concat_dim %= t.dim()
        # Blocks leading: [n, ...t's dims with split_dim cut to 1/n...].
        shape = list(t.shape)
        shape[split_dim] //= n
        blocks = t.unflatten(split_dim, (n, shape[split_dim])).movedim(split_dim, 0)
        src = self._out(blocks.contiguous())
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        out = self._back(out, t)  # out[s]: rank s's block for this rank
        return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1).contiguous()

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a flat tensor, of which this rank keeps
        block ``rank`` of W equal blocks: the reference's
        ``lax.psum_scatter(tiled=True)``.  ``reduce_scatter_tensor`` on
        every wire (the host wire through host buffers)."""
        n = self.world
        if n == 1:
            return flat
        if flat.dim() != 1 or flat.numel() % n:
            raise ValueError(f"reduce_scatter takes a flat tensor of a multiple of {n} "
                             f"elements, got {tuple(flat.shape)}")
        src = self._out(flat.contiguous())
        out = torch.empty(flat.numel() // n, dtype=flat.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return self._back(out, flat)

    def all_gather_flat(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's flat ``shard``, concatenated in rank order into one
        flat tensor (``lax.all_gather(tiled=True)``):
        ``all_gather_into_tensor`` on every wire."""
        n = self.world
        if n == 1:
            return shard
        src = self._out(shard.contiguous().reshape(-1))
        out = torch.empty(n * src.numel(), dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.group)
        return self._back(out, shard)


# The gradient mean packs its f32 tensors, in order, into buffers of at most
# this many bytes (a larger tensor takes a buffer of its own): one
# all-reduce per buffer instead of one per leaf.
MEAN_BUCKET_BYTES = 256 * 2**20


def mean_over_ranks_(comm: Comm, tensors) -> None:
    """Replace each f32 tensor of ``tensors`` by its mean over the ranks, in
    place: the reference's ``lax.pmean`` (sum, then divide by W), so every
    rank ends with the same bits.  The tensors are packed into a few
    coalesced buffers, one ``all_reduce_`` each: on the host wire every
    call is a D2H copy, a TCP all-reduce and an H2D copy, which 117 leaves
    would each pay.  Every rank must call it with the same tensor shapes."""
    _reduce_over_ranks_(comm, tensors, mean=True)


def sum_over_ranks_(comm: Comm, tensors) -> None:
    """:func:`mean_over_ranks_` without the division: the reference's
    ``lax.psum`` of each f32 tensor, coalesced alike."""
    _reduce_over_ranks_(comm, tensors, mean=False)


def _reduce_over_ranks_(comm: Comm, tensors, mean: bool) -> None:
    if comm.world == 1:
        return
    bucket: list = []
    size = 0
    for t in [*tensors, None]:
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"mean_over_ranks_ takes f32 tensors, got {t.dtype}")
        if bucket and (t is None or size + 4 * t.numel() > MEAN_BUCKET_BYTES):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            comm.all_reduce_(flat)
            if mean:
                flat.div_(comm.world)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, size = [], 0
        if t is not None:
            bucket.append(t)
            size += 4 * t.numel()


def mesh_comms(comm: Comm, axes: dict) -> dict:
    """One :class:`Comm` per axis of a mesh over ``comm``'s ranks: ``axes``
    maps each axis name to its size, the last axis innermost (rank =
    row-major index of its coordinates, the reference's ``make_mesh``
    order), their product ``comm.world``.  An axis's Comm spans the ranks
    whose other coordinates equal this rank's.  Every rank creates every
    group (``dist.new_group``), in one order, as the backend requires; an
    axis of size 1 gets a one-rank Comm, one of the whole world ``comm``'s
    group.  Under nccl each group this rank belongs to is started with one
    all-reduce, in creation order, so its first point-to-point call needs
    no collective start."""
    names, sizes = list(axes), [int(axes[a]) for a in axes]
    if math.prod(sizes) != comm.world:
        raise ValueError(f"mesh {dict(axes)} needs {math.prod(sizes)} ranks, the group "
                         f"has {comm.world}")
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    coords = [comm.rank // st % n for st, n in zip(strides, sizes)]
    out, started = {}, []
    for i, name in enumerate(names):
        n = sizes[i]
        others = [range(sz) if j != i else [0] for j, sz in enumerate(sizes)]
        mine = None
        for base in itertools.product(*others):
            members = [sum((k if j == i else c) * st for j, (c, st) in enumerate(zip(base, strides)))
                       for k in range(n)]
            group = comm.group
            if 1 < n < comm.world:
                group = dist.new_group([comm.ranks[m] for m in members])
            if comm.rank in members:
                mine = (members, group)
        members, group = mine
        if n == 1:
            out[name] = Comm(0, 1, comm.backend, comm.device, None, [comm.ranks[comm.rank]])
            continue
        out[name] = Comm(coords[i], n, comm.backend, comm.device, group,
                         [comm.ranks[m] for m in members])
        if n < comm.world:
            started.append(out[name])
    if comm.backend == "nccl":
        for c in started:
            c.all_reduce_(torch.zeros(1, device=comm.device))
    return out


@dataclass
class DistributedContext:
    num_nodes: int
    rank: int
    master_ip: str
    initialized: bool
    device: torch.device
    backend: str | None = None
    local_rank: int = 0
    placements: list | None = None  # every rank's Placement, as exchanged

    @property
    def comm(self) -> Comm:
        return Comm(self.rank, self.num_nodes, self.backend, self.device)

    def shutdown(self) -> None:
        """Counterpart of ``dist.destroy_process_group()`` (part2/2a/main.py:207)."""
        if self.initialized and dist.is_initialized():
            dist.destroy_process_group()


def initialize_from_flags(master_ip: str = DEFAULT_MASTER_IP, rank: int = 0,
                          num_nodes: int = 1, device=None, init_method: str | None = None,
                          timeout_s: float = TIMEOUT_S) -> DistributedContext:
    """Join the ``num_nodes``-process group as ``rank`` (tcp rendezvous at
    ``master_ip`` unless ``init_method`` names another, e.g. ``file://``);
    nothing at ``num_nodes == 1``.  The ranks exchange their placements
    through the rendezvous store before the group exists, and the backend
    and this rank's card come from :func:`plan_placement`."""
    if num_nodes < 1 or not 0 <= rank < num_nodes:
        raise ValueError(f"rank {rank} out of range for --num-nodes {num_nodes}")
    dev = resolve_device(device)
    if num_nodes == 1:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        return DistributedContext(1, 0, master_ip, False, dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, _, _ = next(dist.rendezvous(init_method or f"tcp://{master_ip}", rank,
                                       num_nodes, timeout=timeout))
    store.set_timeout(timeout)
    peers = exchange_placements(store, rank, num_nodes, local_placement(dev))
    backend, local_rank, index = plan_placement(peers, rank)
    if dev.type == "cuda":
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, world_size=num_nodes, rank=rank,
                            timeout=timeout, **kwargs)
    return DistributedContext(num_nodes, rank, master_ip, True, dev, backend,
                              local_rank, peers)
