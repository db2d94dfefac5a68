"""The port's backend choice (runtime/distributed.py): nccl iff every rank
has a card of its own, decided from the placements the ranks exchange
through the rendezvous store.

``plan_placement`` is pure, so stated placements (host name, the UUIDs of
the cards a process sees) stand in for hosts and cards that this machine
does not have; one spawned run at world 2 on the CPU shows the exchange
itself.
"""

import pytest

from distributed_machine_learning_tpu_torch.runtime.distributed import plan_placement


def _plans(peers):
    return [plan_placement(peers, r) for r in range(len(peers))]


def test_four_hosts_one_card_each_take_nccl():
    peers = [(f"host{h}", (f"GPU-{h}",)) for h in range(4)]
    assert _plans(peers) == [("nccl", 0, 0)] * 4


def test_one_host_four_cards_four_ranks_take_nccl():
    cards = tuple(f"GPU-{i}" for i in range(4))
    peers = [("host", cards)] * 4
    assert _plans(peers) == [("nccl", r, r) for r in range(4)]


def test_four_ranks_sharing_one_card_take_gloo():
    peers = [("host", ("GPU-0",))] * 4
    assert _plans(peers) == [("gloo", r, 0) for r in range(4)]


def test_one_visible_card_per_process_takes_nccl():
    """A launcher that sets each process's visible cards to one of its own:
    every process sees device 0, and every device 0 is another card."""
    peers = [("host", (f"GPU-{r}",)) for r in range(4)]
    assert _plans(peers) == [("nccl", r, 0) for r in range(4)]


def test_two_hosts_two_cards_six_ranks_take_gloo():
    """Three ranks on each host of two cards: local rank 2 lands on card 0
    again, which local rank 0 holds."""
    peers = [("a", ("GPU-a0", "GPU-a1"))] * 3 + [("b", ("GPU-b0", "GPU-b1"))] * 3
    plans = _plans(peers)
    assert {backend for backend, _, _ in plans} == {"gloo"}
    assert [(lr, dev) for _, lr, dev in plans] == [(0, 0), (1, 1), (2, 0)] * 2


@pytest.mark.parametrize("world", [1, 2, 4])
def test_cpu_ranks_take_gloo(world):
    peers = [("host", None)] * world
    assert _plans(peers) == [("gloo", r, None) for r in range(world)]


def test_one_rank_on_the_cpu_makes_the_group_gloo():
    peers = [("a", ("GPU-a0",)), ("b", None)]
    assert [p[0] for p in _plans(peers)] == ["gloo", "gloo"]


def _rank(rank, world, init_method):
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=60)
    try:
        return (ctx.backend, ctx.local_rank, ctx.placements, ctx.comm.wire,
                str(ctx.device))
    finally:
        ctx.shutdown()


def test_spawned_ranks_exchange_placements_through_the_store():
    import socket

    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    out = spawn(_rank, 2, timeout_s=120)
    host = socket.gethostname()
    for rank, (backend, local_rank, placements, wire, device) in enumerate(out):
        assert backend == "gloo" and wire == "gloo" and device == "cpu"
        assert local_rank == rank  # both ranks on this host
        assert placements == [(host, None), (host, None)]
