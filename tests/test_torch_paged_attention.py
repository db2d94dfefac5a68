"""Port of the paged decode kernel K5 (ops/decode_attention.py) vs the JAX one.

The port's wrapper runs the kernel's plain version on CPU tensors; the
reference runs its gather formulation (``paged_attention_reference``) and
its Pallas kernel in interpret mode, as tests/test_decode_attention.py
does.  Each lane's pages are a shuffled, interleaved set of pool blocks;
entries past a lane's frontier hold other lanes' blocks; the last lane is
idle (every entry on the scratch block, position 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.ops.pallas import decode_attention as ref
from distributed_machine_learning_tpu_torch.ops import decode_attention as port

# f32: the same page-wise recurrence as the reference kernel, in log2 space
# and summed in another order than the reference's one-shot softmax.
F32_TOL = 1e-5
# bf16 pools: the port rounds P to bf16 before P·V (as the kernel does) and
# the reference does not; outputs are bf16 (spacing 2^-8 near 1): two bf16
# steps, as for K4.
BF16_TOL = 1e-2


def _case(bs, H, Hkv, D=32, seed=0):
    rng = np.random.default_rng(seed)
    positions = [0, bs - 1, bs, 3 * bs + 2, 0]  # the last lane is idle
    W, mb = len(positions), 4
    n_pool = 24
    perm = rng.permutation(n_pool)
    tables = rng.integers(0, n_pool, (W, mb)).astype(np.int32)  # garbage past frontiers
    take = 0
    for w, p in enumerate(positions[:-1]):
        n = p // bs + 1
        tables[w, :n] = perm[take:take + n]
        take += n
    tables[-1] = n_pool  # the scratch block
    pools = [rng.standard_normal((n_pool + 1, Hkv, bs, D)).astype(np.float32)
             for _ in range(2)]
    q = rng.standard_normal((W, 1, H, D)).astype(np.float32)
    return q, pools[0], pools[1], tables, np.asarray(positions, np.int32)


def _port(q, k, v, tables, positions, dtype=torch.float32):
    out = port.paged_flash_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.from_numpy(tables),
        torch.from_numpy(positions))
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("H,Hkv", [(2, 2), (8, 2)], ids=["rep1", "rep4"])
def test_plain_paged_matches_jax_reference_and_kernel(bs, H, Hkv):
    q, k, v, tables, positions = _case(bs, H, Hkv, seed=bs + H)
    got = _port(q, k, v, tables, positions)
    args = [jnp.asarray(a) for a in (q, k, v, tables, positions)]
    for fn in (ref.paged_attention_reference, ref.paged_flash_attention):
        np.testing.assert_allclose(got, np.asarray(fn(*args)),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("bs", [4, 16])
def test_plain_paged_bf16_matches_jax_reference(bs):
    q, k, v, tables, positions = _case(bs, 8, 2, seed=3)
    got = _port(q, k, v, tables, positions, torch.bfloat16)
    want = ref.paged_attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(tables), jnp.asarray(positions))
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


# K5's plan (paged_plan, paged_units): the engine's step (8 lanes over 260
# blocks of 16 slots, 4 kv heads), lanes at 0 and at the table's last slot,
# one lane, 16 lanes, block sizes 4 and 128, groups of 1-8 kv heads, and
# positions on page and chunk edges (15/16, 63/64, 127/128).
PLAN_CASES = [
    ([255, 4159, 1000, 4095, 2047, 16, 0, 3000], 4, 260, 16),
    ([0, 0, 0, 0, 0, 0, 0, 0], 4, 260, 16),
    ([4159] * 8, 4, 260, 16),
    ([4159], 1, 260, 16),
    ([32767], 8, 2048, 16),
    ([15, 16, 63, 64, 127, 128, 129, 0, 1, 2, 511, 512, 4000, 4100, 2, 7], 2, 260, 16),
    ([3, 4, 5, 63, 64, 1000, 0], 8, 300, 4),
    ([127, 128, 1500, 0, 4000], 2, 40, 128),
    ([-5, 10 ** 6, 17], 4, 8, 16),  # clamped into the table
]


@pytest.mark.parametrize("positions,Hkv,MB,bs", PLAN_CASES)
def test_paged_units_cover_each_live_slot_once(positions, Hkv, MB, bs):
    """Every (lane, kv head, slot <= pos) in exactly one unit; no unit
    reaches past its lane's frontier or is empty; units start on a tile;
    a unit's pages fit the staged table; the count fits the workspace."""
    grid, target, max_units = port.paged_plan(len(positions), Hkv, MB, bs, 132)
    units = port.paged_units(positions, Hkv, MB, bs, 132)
    seen = {}
    for w, hk, lo, hi in units:
        pos = min(max(positions[w], 0), MB * bs - 1)
        assert 0 <= lo <= hi <= pos
        assert lo % port.PAGED_TILE == 0
        assert hi // bs - lo // bs + 1 <= port.PAGED_TABLE
        for s in range(lo, hi + 1):
            assert (w, hk, s) not in seen
            seen[(w, hk, s)] = True
    want = sum(Hkv * (min(max(p, 0), MB * bs - 1) + 1) for p in positions)
    assert len(seen) == want
    assert 1 <= target <= grid <= 2 * 132
    assert len(units) <= max_units


def test_paged_units_balance_the_engine_step():
    """At the engine's step the units about fill one wave of blocks, the
    long lanes take proportionally more of them, and no unit holds more
    than the next multiple of a tile over the even share."""
    positions = [255, 4159, 1000, 4095, 2047, 16, 0, 3000]
    grid, target, max_units = port.paged_plan(8, 4, 260, 16, 132)
    assert (grid, target, max_units) == (264, 232, 264)
    units = port.paged_units(positions, 4, 260, 16, 132)
    assert target <= len(units) <= grid
    live = 4 * sum(p + 1 for p in positions)
    share = -(-live // target)
    assert max(hi - lo + 1 for _, _, lo, hi in units) <= -(-share // 16) * 16
    per_lane = [sum(1 for w, *_ in units if w == lane) for lane in range(8)]
    assert per_lane[1] > per_lane[2] > per_lane[0] >= per_lane[5] == per_lane[6] == 4


@pytest.mark.parametrize("W,Hkv,MB,bs", [(8, 4, 260, 16), (1, 1, 1, 1), (64, 8, 2048, 16),
                                         (16, 2, 300, 4), (3, 8, 40, 128)])
def test_paged_plan_bounds_any_positions(W, Hkv, MB, bs):
    """max_units holds for positions at the table's end, at 0, and mixed."""
    _, _, max_units = port.paged_plan(W, Hkv, MB, bs, 132)
    rng = np.random.default_rng(W + MB)
    for positions in ([MB * bs - 1] * W, [0] * W,
                      list(rng.integers(0, MB * bs, W)), [MB * bs - 1] + [0] * (W - 1)):
        assert len(port.paged_units(positions, Hkv, MB, bs, 132)) <= max_units


def _units_merge(q, k, v, tables, positions):
    """K5's plan and merge in plain PyTorch arithmetic: each unit's f32
    partial (m, l, unnormalised acc) in log2 space over its slots through
    the lane's table (q in the pool dtype, p rounded to it), the lane's
    units merged in unit order, out = acc / max(l, 1e-30)."""
    W, _, H, D = q.shape
    Hkv, bs = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = (1.0 / np.sqrt(D)) * port.LOG2E
    qg = q.to(k.dtype).float().reshape(W, Hkv, rep, D)
    parts: dict = {}
    for w, hk, lo, hi in port.paged_units(positions.tolist(), Hkv, tables.shape[1], bs, 132):
        slots = torch.arange(lo, hi + 1)
        rows = tables[w, slots // bs].long()
        kf = k[rows, hk, slots % bs].float()
        vf = v[rows, hk, slots % bs].float()
        s = qg[w, hk] @ kf.T * scale
        m = s.amax(-1)
        p = torch.exp2(s - m[:, None])
        parts.setdefault((w, hk), []).append((m, p.sum(-1), p.to(k.dtype).float() @ vf))
    out = torch.zeros(W, Hkv, rep, D)
    for (w, hk), ps in parts.items():
        m = torch.stack([pm for pm, _, _ in ps]).amax(0)
        l = sum(pl * torch.exp2(pm - m) for pm, pl, _ in ps)
        acc = sum(pa * torch.exp2(pm - m)[:, None] for pm, _, pa in ps)
        out[w, hk] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.reshape(W, 1, H, D).to(q.dtype), max(len(ps) for ps in parts.values())


@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_units_merge_matches_jax(dtype, bs):
    """The plan and its fixed-order merge, held against JAX's Pallas kernel
    in interpret mode on the same numpy inputs, at positions that split
    lanes into several units (chunks of 64 slots) on page and chunk edges."""
    rng = np.random.default_rng(bs)
    positions = np.asarray([0, 63, 64, 200, bs * 40 - 1, 129], np.int32)
    W, H, Hkv, D, mb = len(positions), 8, 2, 32, 40
    n_pool = W * mb
    tables = rng.permutation(n_pool).astype(np.int32).reshape(W, mb)
    k, v = (rng.standard_normal((n_pool, Hkv, bs, D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((W, 1, H, D)).astype(np.float32)
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got, most = _units_merge(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                             torch.from_numpy(tables), torch.from_numpy(positions))
    assert most > 1  # some lane is split
    want = ref.paged_flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                     jnp.asarray(tables), jnp.asarray(positions))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_paged_wrapper_rejects_bad_inputs():
    q, k, v, tables, positions = (torch.from_numpy(a) for a in _case(4, 2, 2))
    with pytest.raises(ValueError, match="single-token"):
        port.paged_flash_attention(q.expand(-1, 2, -1, -1), k, v, tables, positions)
    with pytest.raises(ValueError, match="one shape"):
        port.paged_flash_attention(q, k, v[:-1], tables, positions)
    with pytest.raises(ValueError, match="int32"):
        port.paged_flash_attention(q, k, v, tables.long(), positions)
    with pytest.raises(ValueError, match="positions"):
        port.paged_flash_attention(q, k, v, tables, positions[:-1])
    with pytest.raises(ValueError, match="outside the tables"):
        port.paged_flash_attention(q, k, v, tables, positions + 16)
    with pytest.raises(ValueError, match="outside the pool"):
        port.paged_flash_attention(q, k, v, tables + 1, positions)


def test_paged_counters_are_per_stream_and_never_freed(monkeypatch):
    """The kernel's arrival counters: one zeroed buffer a (device, stream),
    reused while it is large enough; an outgrown one is kept alive (a graph
    captured earlier holds its address)."""
    monkeypatch.setattr(port, "_counters", {})
    monkeypatch.setattr(port, "_outgrown", [])
    cpu = torch.device("cpu")
    a = port._paged_counters(cpu, 1, 8)
    assert a.dtype == torch.int32 and a.numel() >= 8 and not a.any()
    assert port._paged_counters(cpu, 1, 8) is a
    assert port._paged_counters(cpu, 2, 8) is not a
    big = port._paged_counters(cpu, 1, 10_000)
    assert big.numel() >= 10_000 and not big.any()
    assert port._paged_counters(cpu, 1, 8) is big
    assert port._outgrown == [a]
