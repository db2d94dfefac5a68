"""Hand-rolled bucketed ring all-reduce, one process per rank.

Counterpart of ``distributed_machine_learning_tpu/ops/ring.py``: part3's
DDP ring (``bucket_cap_mb=25``, ``part3/main.py:137``) written out as an
explicit ring.  The JAX package runs every rank of a host in one program
over ``lax.ppermute``; here each rank is a process and each hop is one
``batch_isend_irecv`` (send right, receive left) through
:class:`~distributed_machine_learning_tpu_torch.runtime.distributed.Comm`.

The arithmetic is the reference's, so the two agree bit for bit (the
tests hold them to it):

- the flat vector is zero-padded to ``n`` chunks of ``ceil(L/n)``;
- reduce-scatter step ``s``: rank ``r`` sends chunk ``(r−s) mod n`` and
  adds the arrival into chunk ``(r−s−1) mod n``, so it ends owning the full
  sum of chunk ``(r+1) mod n`` (divided by ``n`` under mean);
- all-gather: the owned chunks circulate; with a lossy codec the owner
  encodes its chunk once, stores decode(encode(own)) like every receiver,
  and the *encoded* payload is relayed bit-exactly, so every rank ends
  with identical bits (the replication invariant); the W payloads are
  kept and decoded after the last hop, in one ``decode_rows`` call that
  writes each straight into its row of the output;
- the error-feedback residual is this rank's send errors plus, on its own
  chunk, the broadcast encode's loss (× n under mean).

Wire codecs (``WireScheme``): ``none``, ``bf16`` (cast), ``int8`` (per
chunk symmetric int8 + one f32 scale; ``impl="pallas"`` routes to the
hand-written kernels K8-K10 of ``ops/ring_codec.py`` (the all-gather's W
decodes are one K10 launch), ``"xla"`` to their plain versions — the
names are the reference's ``--ring-codec-impl`` values, so a JAX command
line runs unchanged) and ``topk``.  Each rank's chunk rows start on
16-element boundaries so every chunk view is 16-byte aligned for the
kernels.  :func:`ring_all_gather_flat` is the ring's all-gather alone,
bucketed, for the overlapped FSDP update (``parallel/overlap.py``).
``topology=`` is not ported (ROADMAP A5c).
"""

from __future__ import annotations

import torch

from distributed_machine_learning_tpu_torch.ops import ring_codec

DEFAULT_BUCKET_BYTES = 25 * 2**20  # part3/main.py:137 (bucket_cap_mb=25)
_ROW_ALIGN = 16  # elements: chunk rows start 64-byte aligned


class WireScheme:
    """Codec of one hop's payload over a flat f32 chunk; the base class is
    the exact (identity) scheme.  ``encode(v)`` gives the tensors that go on
    the wire, ``decode(payload, length)`` a dense f32 chunk,
    ``decode_add(payload, acc)`` adds the decode into ``acc`` in place,
    ``decode_rows(payloads, out, rows, length)`` decodes each payload into
    its row of ``out``, ``payload_bytes(length)`` the static byte
    accounting."""

    name = "none"

    def encode(self, v: torch.Tensor) -> tuple:
        return (v,)

    def decode(self, payload: tuple, length: int) -> torch.Tensor:
        return payload[0]

    def payload_bytes(self, length: int, itemsize: int = 4) -> int:
        return length * itemsize

    def encode_with_residual(self, v: torch.Tensor):
        """``(payload, v − decode(encode(v)))``: the send error."""
        enc = self.encode(v)
        return enc, v - self.decode(enc, v.shape[0]).to(v.dtype)

    def decode_add(self, payload: tuple, acc: torch.Tensor) -> torch.Tensor:
        """One arrival: ``acc += decode(payload)``, in place."""
        return acc.add_(self.decode(payload, acc.shape[0]).to(acc.dtype))

    def decode_rows(self, payloads: list, out: torch.Tensor, rows: list, length: int) -> None:
        """The all-gather's decodes: ``out[rows[k], :length] =
        decode(payloads[k])``; the rest of ``out`` is left alone."""
        for payload, i in zip(payloads, rows):
            out[i, :length] = self.decode(payload, length)


class CastScheme(WireScheme):
    """A dtype cast on the wire (``bf16``): half the f32 bytes, no metadata."""

    name = "bf16"

    def __init__(self, dtype=torch.bfloat16):
        self.dtype = dtype

    def encode(self, v):
        return (v.to(self.dtype),)

    def decode(self, payload, length):
        return payload[0].float()

    def payload_bytes(self, length, itemsize=4):
        return length * torch.finfo(self.dtype).bits // 8


class Int8Scheme(WireScheme):
    """Per-chunk symmetric int8 + one f32 scale (``ops/ring_codec.py``'s
    recipe).  ``impl="pallas"`` runs the hand-written kernels K8-K10 on CUDA
    tensors (their plain versions on CPU tensors); ``"xla"`` the plain
    versions on either device.  The kernels engage on f32 chunks only, as
    the reference's do; the two impls agree bit for bit."""

    name = "int8"

    def __init__(self, impl: str = "xla"):
        if impl not in CODEC_IMPLS:
            raise ValueError(f"unknown int8 codec impl {impl!r}; choose from {CODEC_IMPLS}")
        self.impl = impl

    def _kernels(self, t: torch.Tensor) -> bool:
        return self.impl == "pallas" and t.dtype == torch.float32

    def encode(self, v):
        if self._kernels(v):
            return ring_codec.encode_int8(v)
        return ring_codec.quantize_chunk_int8(v)

    def encode_with_residual(self, v):
        if not self._kernels(v):
            return super().encode_with_residual(v)
        q, scale, err = ring_codec.encode_int8_residual(v)
        return (q, scale), err

    def decode(self, payload, length):
        q, scale = payload
        if self.impl == "pallas":
            return ring_codec.decode_int8(q, scale, length)
        return ring_codec.decode_int8_reference(q, scale, length)

    def decode_add(self, payload, acc):
        if not self._kernels(acc):
            return super().decode_add(payload, acc)
        q, scale = payload
        return ring_codec.decode_add_int8(q, scale, acc)

    def decode_rows(self, payloads, out, rows, length):
        if not self._kernels(out):
            return super().decode_rows(payloads, out, rows, length)
        ring_codec.decode_rows_int8(payloads, out, rows, length)

    def payload_bytes(self, length, itemsize=4):
        return length + 4  # int8 chunk + one f32 scale


class TopKScheme(WireScheme):
    """Magnitude top-k: ``k = max(1, round(frac·L))`` (f32 values + int32
    indices, 8 bytes per kept element); decode scatters into zeros."""

    name = "topk"

    def __init__(self, frac: float = 0.125):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk frac must be in (0, 1], got {frac}")
        self.frac = float(frac)

    def k_for(self, length: int) -> int:
        return min(length, max(1, int(round(self.frac * length))))

    def encode(self, v):
        _, idx = torch.topk(v.abs(), self.k_for(v.shape[0]))
        return v[idx], idx.to(torch.int32)

    def decode(self, payload, length):
        vals, idx = payload
        out = torch.zeros(length, dtype=torch.float32, device=vals.device)
        out[idx.long()] = vals.float()
        return out

    def payload_bytes(self, length, itemsize=4):
        return self.k_for(length) * (itemsize + 4)


WIRE_SCHEMES = ("none", "bf16", "int8", "topk")
CODEC_IMPLS = ("xla", "pallas")


def get_wire_scheme(name: str, topk_frac: float = 0.125, codec_impl: str = "xla") -> WireScheme:
    """A ``--ring-compress`` name as a codec; ``codec_impl`` matters for
    int8 only (the others have no kernel)."""
    if codec_impl not in CODEC_IMPLS:
        raise ValueError(f"unknown codec impl {codec_impl!r}; choose from {CODEC_IMPLS}")
    if name == "none":
        return WireScheme()
    if name == "bf16":
        return CastScheme(torch.bfloat16)
    if name == "int8":
        return Int8Scheme(impl=codec_impl)
    if name == "topk":
        return TopKScheme(topk_frac)
    raise ValueError(f"unknown wire scheme {name!r}; choose from {WIRE_SCHEMES}")


def ring_all_reduce_flat(x: torch.Tensor, comm, mean: bool = False,
                         scheme: WireScheme | None = None, return_residual: bool = False):
    """All-reduce the flat vector ``x`` (this rank's contribution) over
    ``comm``'s ranks by the explicit ring; returns the reduced vector (and,
    with ``return_residual``, this rank's error-feedback residual)."""
    n = comm.world
    if n == 1:
        return (x, torch.zeros_like(x)) if return_residual else x
    if scheme is not None and scheme.name == "none":
        scheme = None
    length = x.shape[0]
    chunk = -(-length // n)
    stride = -(-chunk // _ROW_ALIGN) * _ROW_ALIGN
    rows = x.new_zeros(n, stride)
    padded = torch.zeros(n * chunk, dtype=x.dtype, device=x.device)
    padded[:length] = x
    rows[:, :chunk] = padded.view(n, chunk)
    r = comm.rank
    right, left = (r + 1) % n, (r - 1) % n
    account = scheme is not None and return_residual
    res = torch.zeros_like(rows) if account else None
    for s in range(n - 1):  # reduce-scatter
        send_i, recv_i = (r - s) % n, (r - s - 1) % n
        v = rows[send_i, :chunk]
        if scheme is None:
            (got,) = comm.send_recv((v,), right, left)
            rows[recv_i, :chunk] += got
            continue
        if account:
            enc, err = scheme.encode_with_residual(v)
            res[send_i, :chunk] += err
        else:
            enc = scheme.encode(v)
        scheme.decode_add(comm.send_recv(enc, right, left), rows[recv_i, :chunk])
    own_i = (r + 1) % n
    own = rows[own_i, :chunk]
    if mean:
        own = own / n
    out = torch.empty_like(rows)  # every [:chunk] of it is written below
    if scheme is None:
        out[own_i, :chunk] = own
        cur = (own,)
        for s in range(n - 1):  # all-gather
            cur = comm.send_recv(cur, right, left)
            out[(r - s) % n, :chunk] = cur[0]
    else:
        payloads = [scheme.encode(own)]
        for s in range(n - 1):  # relay each payload as it came; decode after the last hop
            payloads.append(comm.send_recv(payloads[-1], right, left))
        scheme.decode_rows(payloads, out, [own_i] + [(r - s) % n for s in range(n - 1)], chunk)
        own_dec = out[own_i, :chunk]
    result = out[:, :chunk].reshape(-1)[:length]
    if not return_residual:
        return result
    if scheme is None:
        return result, torch.zeros_like(x)
    factor = float(n) if mean else 1.0
    res[own_i, :chunk] += factor * (own - own_dec)
    return result, res[:, :chunk].reshape(-1)[:length]


def ring_all_gather_flat(shard: torch.Tensor, comm, n_buckets: int = 1) -> torch.Tensor:
    """All-gather a flat shard by the ring's phase-2 structure: rank r holds
    global chunk r; after n − 1 hops (send right, receive left) every rank
    holds the whole [n·L] vector, in rank order.  Pure data movement, so
    bit for bit ``comm.all_gather_flat(shard)``.  ``n_buckets > 1`` splits
    the shard into that many rings whose hops travel together, one
    ``send_recv`` a hop carrying every bucket (the reference's bucket
    pipelining: each hop's payloads in flight at once)."""
    n = comm.world
    if n == 1:
        return shard
    L = shard.numel()
    k = max(1, min(n_buckets, L))
    bounds = [(i * L // k, (i + 1) * L // k) for i in range(k)]
    out = torch.empty((n, L), dtype=shard.dtype, device=shard.device)
    r = comm.rank
    out[r] = shard
    cur = tuple(shard[a:b] for a, b in bounds)
    for s in range(n - 1):
        # The chunk that arrives after hop s + 1 was sent by rank r − s − 1.
        cur = comm.shift(cur)
        row = out[(r - s - 1) % n]
        for (a, b), part in zip(bounds, cur):
            row[a:b] = part
    return out.reshape(-1)


def _bucket_bounds(n_elems: int, bucket_bytes: int, itemsize: int):
    """(start, stop) element ranges of the ring buckets: one definition for
    the all-reduce and the byte accounting."""
    bucket_elems = max(1, int(bucket_bytes) // itemsize)
    return [(i, min(i + bucket_elems, n_elems)) for i in range(0, n_elems, bucket_elems)]


def ring_all_reduce(flat: torch.Tensor, comm, mean: bool = True,
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    scheme: WireScheme | None = None, return_residual: bool = False):
    """Bucketed ring all-reduce of a flat f32 vector (the raveled gradient):
    each ``bucket_bytes`` slice is its own ring.  ``mean=True`` is part3's
    DDP averaging, ``False`` the SUM of parts 2a/2b."""
    if comm.world == 1 or flat.shape[0] == 0:
        return (flat, torch.zeros_like(flat)) if return_residual else flat
    outs = [ring_all_reduce_flat(flat[a:b], comm, mean=mean, scheme=scheme,
                                 return_residual=return_residual)
            for a, b in _bucket_bounds(flat.shape[0], bucket_bytes, flat.element_size())]
    if not return_residual:
        return torch.cat(outs)
    return torch.cat([o for o, _ in outs]), torch.cat([e for _, e in outs])


def ring_wire_bytes(n_elems: int, axis_size: int, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    scheme: WireScheme | None = None, itemsize: int = 4) -> int:
    """Static per-rank wire bytes of one bucketed ring all-reduce:
    ``sum over buckets of 2·(N−1) hops × payload_bytes(chunk)``."""
    if axis_size <= 1 or n_elems <= 0:
        return 0
    scheme = scheme or WireScheme()
    total = 0
    for start, stop in _bucket_bounds(n_elems, bucket_bytes, itemsize):
        chunk = -(-(stop - start) // axis_size)
        total += 2 * (axis_size - 1) * scheme.payload_bytes(chunk, itemsize)
    return total


def ring_wire_bytes_by_axis(n_elems: int, axis_size: int,
                            bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                            scheme: WireScheme | None = None, itemsize: int = 4) -> dict:
    """Per-axis split of :func:`ring_wire_bytes`: the flat ring only
    (``{"flat": total}``); topologies are ROADMAP A5c."""
    return {"flat": ring_wire_bytes(n_elems, axis_size, bucket_bytes, scheme, itemsize)}
