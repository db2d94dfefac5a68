"""Block/paged KV-cache allocator for the continuous-batching engine.

Counterpart of ``distributed_machine_learning_tpu/inference/kv_blocks.py``
(``CacheExhausted``, ``blocks_needed``, ``BlockAllocator``), copied so the
port imports nothing of the JAX package.  One shared cache budget is cut
into fixed-size **token blocks** with a per-sequence **block table**
mapping logical block index -> physical block id:

* **reserve-on-admit**: admission pledges the sequence's worst case
  (``ceil((prompt_len + max_new) / block_size)`` blocks), so an admitted
  sequence never fails mid-decode, and raises :class:`CacheExhausted`
  when the pledge would exceed the free pool: the caller queues and
  retries, which is the admission control;
* **alloc-on-append**: prefill blocks bind at admission, one more each
  time decode crosses a block boundary;
* **free-on-finish**: retiring a sequence returns its blocks and its
  unused pledge the same step, so the engine can backfill at once.

Every public op is one critical section under a single lock (the router
thread admits while the engine thread appends and frees).  The reference
puts a schedule point of its interleaving explorer before each acquire;
:func:`_sched_point` keeps that seam here as a no-op (the explorer is not
ported: ROADMAP A7).
"""

from __future__ import annotations

import threading


def _sched_point(label: str) -> None:
    """Schedule-point hook of the reference's interleaving explorer; a
    no-op in the port."""


class CacheExhausted(RuntimeError):
    """Admission would overcommit the block pool — queue and retry."""


def blocks_needed(tokens: int, block_size: int) -> int:
    """Blocks covering ``tokens`` cache slots (ceil division)."""
    return -(-tokens // block_size)


class BlockAllocator:
    """Fixed-pool block allocator with per-sequence block tables.

    ``num_blocks`` physical blocks of ``block_size`` token slots each.
    Sequences are any hashable id (the engine uses request rids).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # LIFO free stack: blocks freed by a retired sequence are reused first.
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: dict = {}    # seq -> [physical block id, ...]
        self._lengths: dict = {}   # seq -> tokens written (cache slots)
        self._reserved: dict = {}  # seq -> total blocks pledged
        # Blocks pledged but not yet bound (sum of reserved - len(table)).
        self._pledged = 0

    def free_blocks(self) -> int:
        """Physically unbound blocks (includes pledged-not-yet-bound)."""
        with self._lock:
            return len(self._free)

    def table(self, seq) -> list[int]:
        with self._lock:
            return list(self._tables[seq])

    def admit(self, seq, prompt_len: int, max_new: int) -> list[int]:
        """Admit one sequence: pledge its worst case, bind its prefill
        blocks, return the (prefill) block table.  Raises
        :class:`CacheExhausted` when the pledge exceeds the free blocks and
        ``ValueError`` on a duplicate or invalid sequence.  The capacity
        check and the binding are one critical section."""
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        if max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {max_new}")
        _sched_point("kvb:admit")
        with self._lock:
            if seq in self._tables:
                raise ValueError(f"sequence {seq!r} already admitted")
            need = blocks_needed(prompt_len + max_new, self.block_size)
            if need > len(self._free) - self._pledged:
                raise CacheExhausted(
                    f"need {need} blocks, "
                    f"{len(self._free) - self._pledged} available "
                    f"({len(self._free)} free, {self._pledged} pledged)")
            now = blocks_needed(prompt_len, self.block_size)
            table = [self._free.pop() for _ in range(now)]
            self._tables[seq] = table
            self._lengths[seq] = prompt_len
            self._reserved[seq] = need
            self._pledged += need - now
            return list(table)

    def append(self, seq) -> int:
        """Claim the next cache slot of ``seq`` (the decode step is about to
        write position ``length``), binding a block from the pledge at a
        block boundary.  Returns the slot's absolute position."""
        _sched_point("kvb:append")
        with self._lock:
            pos = self._lengths[seq]
            table = self._tables[seq]
            bidx = pos // self.block_size
            if bidx >= self._reserved[seq]:
                raise ValueError(f"sequence {seq!r} exceeded its reservation "
                                 f"({self._reserved[seq]} blocks)")
            if bidx == len(table):
                table.append(self._free.pop())
                self._pledged -= 1
            self._lengths[seq] = pos + 1
            return pos

    def free(self, seq) -> list[int]:
        """Retire ``seq``: return its bound blocks and its unused pledge to
        the pool.  Returns the freed physical ids."""
        _sched_point("kvb:free")
        with self._lock:
            table = self._tables.pop(seq)
            self._lengths.pop(seq)
            reserved = self._reserved.pop(seq)
            self._pledged -= reserved - len(table)
            self._free.extend(reversed(table))
            return list(table)

    def stats(self) -> dict:
        """Pool occupancy snapshot for telemetry gauges."""
        with self._lock:
            bound = self.num_blocks - len(self._free)
            tokens = sum(self._lengths.values())
            return {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free": len(self._free),
                "pledged": self._pledged,
                "available": len(self._free) - self._pledged,
                "bound": bound,
                "sequences": len(self._tables),
                "tokens": tokens,
                # Slots bound but unwritten (tail-of-block waste).
                "waste_slots": bound * self.block_size - tokens,
                "utilization": bound / self.num_blocks,
            }

    def check_invariants(self) -> None:
        """Raise AssertionError if an accounting identity is broken."""
        with self._lock:
            bound = [b for t in self._tables.values() for b in t]
            assert len(bound) == len(set(bound)), (
                "physical block double-booked across tables")
            assert not set(bound) & set(self._free), (
                "block simultaneously bound and free")
            assert len(bound) + len(self._free) == self.num_blocks, (
                f"block leak: {len(bound)} bound + {len(self._free)} free "
                f"!= {self.num_blocks}")
            assert self._pledged == sum(
                self._reserved[s] - len(self._tables[s]) for s in self._tables
            ), "pledge accounting drifted"
            assert 0 <= self._pledged <= len(self._free), (
                f"pledged {self._pledged} outside [0, {len(self._free)}]"
                " — admission overcommitted the pool")
            for s, t in self._tables.items():
                need = blocks_needed(self._lengths[s], self.block_size)
                assert len(t) == max(need, 1), (
                    f"sequence {s!r}: {len(t)} blocks bound, {need} covered "
                    f"by length {self._lengths[s]}")
                assert len(t) <= self._reserved[s]
