// The Hopper flash-attention backward mainloops.  dq_kernel: K2
// (flash_bwd.cu: dQ of causal attention over the whole sequence) and K12
// (ring_flash.cu: dQ of one ring chunk step), a query-tile walk over the
// keys.  dkv_kernel: K3 (flash_bwd.cu: dK and dV over the whole sequence)
// and K13 (ring_flash.cu: the traveling dK and dV of one ring chunk step),
// a key-tile walk over the query tiles of the KV head's query group.  bf16
// inputs only; the f32 modes keep their CUDA-core kernels.  The kind
// (sm90_common.cuh's Kind) sets the walk, the mask and the ends: FLASH
// (K2/K3) and RING_DIAGONAL are causal (the same walk and mask; for the
// ring on local indices), RING_FULL masks only past the chunk's end.  The
// ring kinds read and write f32 accumulators (contiguous); FLASH starts
// from zero and stores bf16 dq, dk and dv through the caller's strides,
// each rounded once.
//
// What bounds them on the H100: operations.  Per query-key pair dQ does 3
// products of depth D (S = Q K^T, dP = dO V^T, dQ += dS K) and dK/dV 4
// (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q), against
// O(L * D) bytes; neither score matrix reaches device memory.
//
// Design (after FlashAttention-3's backward, split in two kernels as the
//   TPU kernels are): blocks of 3 warpgroups.  Warpgroup 0 is the producer:
//   it drops to 24 registers (setmaxnreg) and issues TMA loads
//   (cp.async.bulk.tensor through sm90_common.cuh's 4-D maps over the
//   strided [B, L, heads, D] views) into rings of shared-memory stages
//   with transaction-counted full barriers and empty barriers the
//   consumers release.  Warpgroups 1 and 2 are the consumers (240
//   registers); every product is a wgmma with the f32 sum in registers.
//   Tiles are stored as TMA writes them (sm90_common.cuh's TileGeom), so
//   one shared tile serves as a K-major operand of one product and an
//   MN-major one (the transpose bit) of another.
//
//   dQ: a block owns 128 query rows of one (b, query head), 64 a
//   consumer.  The producer loads the Q and dO tiles once, then 64-key K
//   and V tiles (K12: of the visiting chunk) into a 3-stage ring, K and V
//   with their own barriers.  Each consumer keeps its rows' lse and delta
//   in registers and its rows of the f32 dq accumulator in the accumulator
//   layout (K12 loads them before the first key tile, K2 starts from zero;
//   stored after the last, K2's rounded to bf16).  Per
//   key tile j it issues S_j and dP_j (SS, m64n64, K-major) and dQ_{j-1}
//   += dS_{j-1} K_{j-1} (RS: dS from registers, K MN-major); P_j's exps
//   overlap dP_j and dQ_{j-1}; V_j is released once dP_j is in, K_{j-1}
//   once dQ_{j-1} is.  Query tiles are issued heaviest first (the grid's
//   slow axis walks them from the last).
//
//   dK/dV: a block owns 64 keys of one (b, KV head) and every query head of
//   its group.  The producer loads the block's K and V once; its warps 0
//   and 1 feed one consumer each, with the (group head, 64-query tile)
//   iterations split between the consumers by parity: per iteration the Q
//   and dO tiles (TMA) and the tile's 64 lse and delta values (the warp's
//   lanes, plain loads, each lane an arrival on the stage's full barrier)
//   into that consumer's 2-stage ring.  Per iteration a consumer issues
//   S^T and dP^T (SS, m64n64: K or V as A, Q or dO K-major as B), forms
//   P^T while dP^T runs, then dS^T, and issues dV += P^T dO and dK +=
//   dS^T Q together (RS, dO and Q MN-major); the other consumer's products
//   cover its elementwise work.  Consumer 0 starts from the traveling
//   dK/dV rows (K3: from zero), consumer 1 from zero; at the end consumer
//   1 hands its sums through its own (drained) stages in shared memory and
//   consumer 0 adds them and stores the rows once (K3's rounded to bf16).
//   Each block owns the rows it writes: no atomics, deterministic.  Key
//   blocks are issued heaviest first (key block 0 sees every query tile on
//   the diagonal).
//
// Numerics, as the plain versions: scores in base 2 (scale * log2(e),
//   exp2, the lse in log2 space); a masked score's probability is 0 (the
//   -1e30 of the plain versions); keys and queries at or past L are
//   masked (TMA's zero fill is no mask); P is rounded to bf16 before
//   P^T dO, dS = P (dP - delta) * scale to bf16 before dS K and dS^T Q;
//   the KV head of query head h is h / (H / Hkv), read in place; dK/dV
//   sum a group's query heads in f32 into the narrow dK/dV (FLASH rounds
//   the sum to bf16 once); rows at or past L are never stored.  The lse
//   is m + log2(l) in the scaled log2 space, as K1 writes it (with l
//   clamped at 1e-30) and the ring's forward forms it.

#pragma once

#include "sm90_common.cuh"

namespace sm90 {
namespace bwd {

constexpr int THREADS = 384;
constexpr int BQ = 128;         // dQ: query rows per block (64 per consumer)
constexpr int BKV = 64;         // dQ: keys per tile
constexpr int DQ_STAGES = 3;    // dQ: K/V stages
constexpr int BK = 64;          // dK/dV: keys per block
constexpr int BQT = 64;         // dK/dV: queries per tile
constexpr int DKV_STAGES = 2;   // dK/dV: Q/dO stages per consumer

struct BwdParams {
  int L, H, Hkv;  // L: K2/K3's sequence length or K12/K13's chunk length Lc
  float scale_log2, scale;
  const float *lse, *delta;  // [B, H, L], contiguous
  float* dq;                 // K12: [B, L, H, D], contiguous
  float *dk, *dv;            // K13: [B, L, Hkv, D], contiguous
  // K2: dq [B, L, H, D]; K3: dk, dv [B, L, Hkv, D]; bf16 through their
  // (b, l, h) element strides.
  __nv_bfloat16 *dq_out, *dk_out, *dv_out;
  long long dq_sb, dq_sl, dq_sh, dk_sb, dk_sl, dk_sh, dv_sb, dv_sl, dv_sh;
};

// Whether the score of (query row, key) is masked: above the diagonal
// (causal; for the ring, local indices) or past the end.
template <bool CAUSAL>
__device__ __forceinline__ bool masked(int row, int key, int L) {
  return (CAUSAL && key > row) || key >= L || row >= L;
}

template <int D>
struct DqSmem {
  using TQ = TileGeom<D, BQ>;
  using TK = TileGeom<D, BKV>;
  // Q and dO, the K and V stages, the barriers, and room to align to 1024.
  static constexpr int BYTES =
      2 * TQ::BYTES + 2 * DQ_STAGES * TK::BYTES + 8 * (1 + 4 * DQ_STAGES) + 1024;
};

template <int D>
struct DkvSmem {
  using TT = TileGeom<D, 64>;
  static_assert(BK == 64 && BQT == 64, "dK/dV's tiles are 64 rows");
  static constexpr int ROWS = 2 * BQT * 4;  // a stage's lse and delta
  // K and V, two consumers' Q/dO stages, their lse/delta, the barriers,
  // and room to align to 1024.
  static constexpr int BYTES = 2 * TT::BYTES + 2 * DKV_STAGES * 2 * TT::BYTES +
                               2 * DKV_STAGES * ROWS + 8 * (1 + 4 * DKV_STAGES) + 1024;
  // Consumer 1's stages hold its dK and dV (D / 2 f32 each a thread).
  static_assert(DKV_STAGES * 2 * TT::BYTES == 128 * D * 4, "the hand-over buffer");
};

// ------------------------------------------------------- dQ: K2, K12
template <int D, int KIND>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const BwdParams p) {
  using TQ = TileGeom<D, BQ>;
  using TK = TileGeom<D, BKV>;
  constexpr bool CAUSAL = KIND != RING_FULL;
  constexpr int S = DQ_STAGES;
  extern __shared__ unsigned char sm90_smem[];
  const uint32_t base = (smem_u32(sm90_smem) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t sQ = base, sO = sQ + TQ::BYTES, sK = sO + TQ::BYTES, sV = sK + S * TK::BYTES;
  const uint32_t bars = sV + S * TK::BYTES;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + S + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + 2 * S + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * S + s); };

  const int L = p.L, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / p.Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (latest) query tiles first
  const int q0 = qt * BQ;
  const int n_tiles = (min(CAUSAL ? q0 + BQ : L, L) + BKV - 1) / BKV;  // dQ's key-tile walk

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * TQ::BYTES);
      TQ::load(sQ, &tq, full_q, h, q0, b);
      TQ::load(sO, &tdo, full_q, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        // V of tile j - S is free once both consumers have its dP; K once
        // they have its dQ, during tile j - S + 1.
        if (j >= S) mbar_wait(empty_v(s), (j / S - 1) & 1);
        mbar_expect_tx(full_v(s), TK::BYTES);
        TK::load(sV + s * TK::BYTES, &tv, full_v(s), hk, j * BKV, b);
        if (j >= S) mbar_wait(empty_k(s), (j / S - 1) & 1);
        mbar_expect_tx(full_k(s), TK::BYTES);
        TK::load(sK + s * TK::BYTES, &tk, full_k(s), hk, j * BKV, b);
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;  // this consumer's 64 rows: c * 64 .. c * 64 + 63 of the tile
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = c * 64 + warp * 16;  // this warp's first row inside the tile
  const float scale_log2 = p.scale_log2, scale = p.scale;

  // Accumulator layout (m64nN f32): element i is row g + 8 * ((i >> 1) & 1)
  // of the warp's 16 and column (i >> 2) * 8 + 2t + (i & 1).
  float dq[D / 2], s[BKV / 2], dp[BKV / 2];
  uint32_t dsf[BKV / 16][4];
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    const bool live = row < L;  // padded rows: zero q and dO, never stored
    const long long r = static_cast<long long>(bh) * L + row;
    lse_r[half] = live ? p.lse[r] : 0.f;
    dl_r[half] = live ? p.delta[r] : 0.f;
    if constexpr (KIND == FLASH) {
      acc_load_row<D>(dq, half, nullptr, t);  // K2 has no f32 dq to read
    } else {
      const long long off = ((static_cast<long long>(b) * L + row) * H + h) * D;
      acc_load_row<D>(dq, half, live ? p.dq + off : nullptr, t);
    }
  }

  const uint64_t q_desc = smem_desc(sQ + c * 64 * TQ::ROW_BYTES, 16, TQ::GROUP, TQ::SWIZZLE);
  const uint64_t o_desc = smem_desc(sO + c * 64 * TQ::ROW_BYTES, 16, TQ::GROUP, TQ::SWIZZLE);
  const uint64_t k_desc = smem_desc(sK, 16, TK::GROUP, TK::SWIZZLE);
  const uint64_t kt_desc = smem_desc(sK, TK::ATOM_BYTES, TK::GROUP, TK::SWIZZLE);  // MN-major
  const uint64_t v_desc = smem_desc(sV, 16, TK::GROUP, TK::SWIZZLE);
  // acc = A B^T over the head dim: S (A = Q, B = K) or dP (A = dO, B = V).
  auto gemm_nt = [&](float* acc, uint64_t da, uint64_t db) {
    asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(acc, da + TQ::kstep(kk), db + TK::kstep(kk), kk > 0);
  };
  // dQ += bf16(dS) K over the 64 keys of stage st.
  auto gemm_dq = [&](int st) {
    uint64_t db = kt_desc + st * (TK::BYTES >> 4);
    asm volatile("" : "+l"(db));
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<D>(dq, dsf[kk], db + TK::mnstep(kk));
  };
  // S of key tile j becomes P = exp2(S * scale_log2 - lse) in place; only a
  // tile on the diagonal (causal) or reaching past L takes the masked path.
  auto probs = [&](int j) {
    const bool edge = (CAUSAL && (j + 1) * BKV > q0 + c * 64) || (j + 1) * BKV > L;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int key = j * BKV + (i >> 2) * 8 + 2 * t + (i & 1);
        const int row = q0 + wr + g + ((i >> 1) & 1) * 8;
        s[i] = masked<CAUSAL>(row, key, L) ? 0.f
                                           : fast_exp2(s[i] * scale_log2 - lse_r[(i >> 1) & 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -lse_r[(i >> 1) & 1]));
    }
  };
  // dS = P (dP - delta) * scale, rounded to bf16 A fragments.
  auto dscores = [&]() {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) dp[i] = s[i] * (dp[i] - dl_r[(i >> 1) & 1]) * scale;
    pack_a<BKV / 16>(dsf, dp);
  };

  // Tile 0: S and dP only.
  mbar_wait(full_q, 0);
  mbar_wait(full_k(0), 0);
  mbar_wait(full_v(0), 0);
  wgmma_fence();
  gemm_nt(s, q_desc, k_desc);
  wgmma_commit();
  gemm_nt(dp, o_desc, v_desc);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs<BKV / 2>(s);
  probs(0);
  wgmma_wait<0>();
  fence_regs<BKV / 2>(dp);
  if (lane == 0) mbar_arrive(empty_v(0));
  dscores();
  // Tile j: S_j and dP_j, and dQ_{j-1} behind them.
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % S, sp = (j - 1) % S, ph = (j / S) & 1;
    mbar_wait(full_k(st), ph);
    mbar_wait(full_v(st), ph);
    fence_regs<D / 2>(dq);
    fence_regs<BKV / 4>(&dsf[0][0]);
    wgmma_fence();
    gemm_nt(s, q_desc, k_desc + st * (TK::BYTES >> 4));
    wgmma_commit();
    gemm_nt(dp, o_desc, v_desc + st * (TK::BYTES >> 4));
    wgmma_commit();
    gemm_dq(sp);
    wgmma_commit();
    wgmma_wait<2>();  // S_j is in; dP_j and dQ_{j-1} may still run
    fence_regs<BKV / 2>(s);
    probs(j);
    wgmma_wait<1>();
    fence_regs<BKV / 2>(dp);
    if (lane == 0) mbar_arrive(empty_v(st));  // this warp is done with V of tile j
    wgmma_wait<0>();
    fence_regs<D / 2>(dq);
    fence_regs<BKV / 4>(&dsf[0][0]);
    if (lane == 0) mbar_arrive(empty_k(sp));  // and with K of tile j - 1
    dscores();
  }
  fence_regs<D / 2>(dq);
  fence_regs<BKV / 4>(&dsf[0][0]);
  wgmma_fence();
  gemm_dq((n_tiles - 1) % S);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(dq);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    if (row < L) {
      if constexpr (KIND == FLASH)
        acc_store_row_bf16<D>(dq, half, p.dq_out + b * p.dq_sb + h * p.dq_sh + row * p.dq_sl, t);
      else
        acc_store_row<D>(dq, half, p.dq + ((static_cast<long long>(b) * L + row) * H + h) * D, t);
    }
  }
}

// ---------------------------------------------------- dK/dV: K3, K13
template <int D, int KIND>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const BwdParams p) {
  using TT = TileGeom<D, 64>;
  using SM = DkvSmem<D>;
  constexpr bool CAUSAL = KIND != RING_FULL;
  constexpr int S = DKV_STAGES;
  extern __shared__ unsigned char sm90_smem[];
  const uint32_t raw = smem_u32(sm90_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t sK = base, sV = sK + TT::BYTES;
  // Consumer c's stage s: its Q tile, then its dO tile.
  auto stage_q = [&](int c, int s) { return sV + TT::BYTES + (c * S + s) * 2 * TT::BYTES; };
  const uint32_t rows = sV + TT::BYTES + 2 * S * 2 * TT::BYTES;
  auto lse_at = [&](int c, int s) {  // the stage's lse, then its delta (BQT f32 each)
    return reinterpret_cast<float*>(sm90_smem + (rows + (c * S + s) * SM::ROWS - raw));
  };
  const uint32_t bars = rows + 2 * S * SM::ROWS;
  const uint32_t full_kv = bars;
  auto full = [&](int c, int s) { return bars + 8u * (1 + c * S + s); };
  auto empty = [&](int c, int s) { return bars + 8u * (1 + 2 * S + c * S + s); };

  const int L = p.L, H = p.H, Hkv = p.Hkv, rep = H / Hkv;
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int k0 = blockIdx.y * BK;  // key block 0 (the most work) first
  const int first_qt = CAUSAL ? k0 / BQT : 0;  // the first query tile that sees key k0
  const int nq = (L + BQT - 1) / BQT - first_qt;
  const int n_iters = rep * nq;  // (query head of the group, query tile)

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int c = 0; c < 2; ++c)
      for (int s = 0; s < S; ++s) {
        mbar_init(full(c, s), 32);  // the feeding warp's lanes (lane 0 with the bytes)
        mbar_init(empty(c, s), 4);  // one arrival per warp of the consumer
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * TT::BYTES);
      TT::load(sK, &tk, full_kv, hk, k0, b);
      TT::load(sV, &tv, full_kv, hk, k0, b);
    }
    if (warp < 2) {  // warp c feeds consumer c: iterations c, c + 2, ...
      const int c = warp;
      for (int i = c, n = 0; i < n_iters; i += 2, ++n) {
        const int st = n % S;
        if (n >= S) mbar_wait(empty(c, st), (n / S - 1) & 1);
        const int h = hk * rep + i / nq;
        const int q0 = (first_qt + i % nq) * BQT;
        const long long r0 = (static_cast<long long>(b) * H + h) * L + q0;
        float* lse_s = lse_at(c, st);
        for (int r = lane; r < BQT; r += 32) {
          const bool ok = q0 + r < L;
          lse_s[r] = ok ? p.lse[r0 + r] : 0.f;
          lse_s[BQT + r] = ok ? p.delta[r0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(c, st), 2 * TT::BYTES);
          TT::load(stage_q(c, st), &tq, full(c, st), h, q0, b);
          TT::load(stage_q(c, st) + TT::BYTES, &tdo, full(c, st), h, q0, b);
        } else {
          mbar_arrive(full(c, st));
        }
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp * 16;  // this warp's first key inside the block
  const float scale_log2 = p.scale_log2, scale = p.scale;

  // Rows are keys, columns head dims (dK, dV) or queries (S^T, dP^T).
  float dk[D / 2], dv[D / 2], s[BQT / 2], dp[BQT / 2];
  uint32_t pf[BQT / 16][4], dsf[BQT / 16][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if constexpr (KIND == FLASH) {  // K3 starts from zero
      acc_load_row<D>(dk, half, nullptr, t);
      acc_load_row<D>(dv, half, nullptr, t);
    } else {
      const int key = k0 + wk + g + half * 8;
      const long long off = ((static_cast<long long>(b) * L + key) * Hkv + hk) * D;
      const bool in = c == 0 && key < L;  // consumer 0 carries the traveling rows
      acc_load_row<D>(dk, half, in ? p.dk + off : nullptr, t);
      acc_load_row<D>(dv, half, in ? p.dv + off : nullptr, t);
    }
  }

  const uint64_t k_desc = smem_desc(sK, 16, TT::GROUP, TT::SWIZZLE);
  const uint64_t v_desc = smem_desc(sV, 16, TT::GROUP, TT::SWIZZLE);
  // acc = A B^T over the head dim: S^T (A = K, B = Q) or dP^T (A = V, B = dO).
  auto gemm_nt = [&](float* acc, uint64_t da, uint32_t sb) {
    uint64_t db = smem_desc(sb, 16, TT::GROUP, TT::SWIZZLE);
    asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(acc, da + TT::kstep(kk), db + TT::kstep(kk), kk > 0);
  };
  // acc += A B over the 64 queries: dV (A = P^T, B = dO) or dK (A = dS^T, B = Q).
  auto gemm_nn = [&](float* acc, uint32_t (*a)[4], uint32_t sb) {
    uint64_t db = smem_desc(sb, TT::ATOM_BYTES, TT::GROUP, TT::SWIZZLE);  // MN-major
    asm volatile("" : "+l"(db));
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) wgmma_rs<D>(acc, a[kk], db + TT::mnstep(kk));
  };

  mbar_wait(full_kv, 0);
  for (int i = c, n = 0; i < n_iters; i += 2, ++n) {
    const int st = n % S;
    mbar_wait(full(c, st), (n / S) & 1);
    const int q0 = (first_qt + i % nq) * BQT;
    const uint32_t sq = stage_q(c, st), so = sq + TT::BYTES;
    const float* lse_s = lse_at(c, st);
    fence_regs<D / 2>(dk);
    fence_regs<D / 2>(dv);
    wgmma_fence();
    gemm_nt(s, k_desc, sq);
    wgmma_commit();
    gemm_nt(dp, v_desc, so);
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; dP^T may still run
    fence_regs<BQT / 2>(s);
    // P^T = exp2(S^T * scale_log2 - lse[query]); element 4 nd + e is key
    // row g + 8 (e >> 1) of the warp's 16, query nd * 8 + 2t + (e & 1).
    const bool edge = (CAUSAL && q0 < k0 + BK) || q0 + BQT > L || k0 + BK > L;
#pragma unroll
    for (int nd = 0; nd < BQT / 8; ++nd) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + nd * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = e & 1 ? l2.y : l2.x;
        float& x = s[4 * nd + e];
        if (edge) {
          const int key = k0 + wk + g + (e >> 1) * 8;
          const int qrow = q0 + nd * 8 + 2 * t + (e & 1);
          x = masked<CAUSAL>(qrow, key, L) ? 0.f : fast_exp2(x * scale_log2 - lv);
        } else {
          x = fast_exp2(fmaf(x, scale_log2, -lv));
        }
      }
    }
    wgmma_wait<0>();  // dP^T is in
    fence_regs<BQT / 2>(dp);
    // dS^T = P^T (dP^T - delta[query]) * scale.
#pragma unroll
    for (int nd = 0; nd < BQT / 8; ++nd) {
      const float2 d2 = *reinterpret_cast<const float2*>(lse_s + BQT + nd * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * nd + e] = s[4 * nd + e] * (dp[4 * nd + e] - (e & 1 ? d2.y : d2.x)) * scale;
    }
    pack_a<BQT / 16>(pf, s);
    pack_a<BQT / 16>(dsf, dp);
    wgmma_fence();
    gemm_nn(dv, pf, so);   // dV += bf16(P^T) dO
    gemm_nn(dk, dsf, sq);  // dK += bf16(dS^T) Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dk);
    fence_regs<D / 2>(dv);
    fence_regs<BQT / 4>(&pf[0][0]);
    fence_regs<BQT / 4>(&dsf[0][0]);
    if (lane == 0) mbar_arrive(empty(c, st));  // this warp is done with the stage
  }

  // Consumer 1 hands its sums to consumer 0 through its own stages (every
  // load into them has landed and been read), thread by thread.
  float* hand = reinterpret_cast<float*>(sm90_smem + (stage_q(1, 0) - raw));
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      hand[i * 128 + tw] = dk[i];
      hand[(D / 2 + i) * 128 + tw] = dv[i];
    }
    named_arrive(1);
    return;
  }
  named_sync(1);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] += hand[i * 128 + tw];
    dv[i] += hand[(D / 2 + i) * 128 + tw];
  }
  // The rows' addresses are formed anew here: held across the loop, they
  // are what spills at D 128.
  int key0 = k0 + wk + g;
  asm volatile("" : "+r"(key0));
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + half * 8;
    if (key >= L) continue;
    if constexpr (KIND == FLASH) {
      acc_store_row_bf16<D>(dk, half, p.dk_out + b * p.dk_sb + hk * p.dk_sh + key * p.dk_sl, t);
      acc_store_row_bf16<D>(dv, half, p.dv_out + b * p.dv_sb + hk * p.dv_sh + key * p.dv_sl, t);
    } else {
      const long long off = ((static_cast<long long>(b) * L + key) * Hkv + hk) * D;
      acc_store_row<D>(dk, half, p.dk + off, t);
      acc_store_row<D>(dv, half, p.dv + off, t);
    }
  }
}

// ------------------------------------------------------------------ host
// The maps of q, k, v and dout ([B, L, H or Hkv, D] with element strides
// st = (q: b, l, h; k; v; dout)), q and dout in boxes of q_rows rows, k
// and v of kv_rows.
template <int D>
bool make_maps(CUtensorMap* m, const void* q, const void* k, const void* v, const void* dout,
               const long long* st, int B, const BwdParams& p, int q_rows, int kv_rows) {
  return make_map<D>(&m[0], q, B, p.L, p.H, st[0], st[1], st[2], q_rows) &&
         make_map<D>(&m[1], k, B, p.L, p.Hkv, st[3], st[4], st[5], kv_rows) &&
         make_map<D>(&m[2], v, B, p.L, p.Hkv, st[6], st[7], st[8], kv_rows) &&
         make_map<D>(&m[3], dout, B, p.L, p.H, st[9], st[10], st[11], q_rows);
}

// dQ of kind KIND: K2 (FLASH) writes p.dq_out; K12 adds this chunk pair's
// dQ into p.dq.
template <int D, int KIND>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const long long* st,
              int B, const BwdParams& p, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!make_maps<D>(m, q, k, v, dout, st, B, p, BQ, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = DqSmem<D>::BYTES;
  static bool configured = false;
  if (int err = set_smem_once(dq_kernel<D, KIND>, smem, configured)) return err;
  dim3 grid(B * p.H, (p.L + BQ - 1) / BQ);
  dq_kernel<D, KIND><<<grid, THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV of kind KIND: K3 (FLASH) writes p.dk_out, p.dv_out; K13 adds this
// chunk pair's contribution into p.dk, p.dv.
template <int D, int KIND>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const long long* st,
               int B, const BwdParams& p, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!make_maps<D>(m, q, k, v, dout, st, B, p, BQT, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = DkvSmem<D>::BYTES;
  static bool configured = false;
  if (int err = set_smem_once(dkv_kernel<D, KIND>, smem, configured)) return err;
  dim3 grid(B * p.Hkv, (p.L + BK - 1) / BK);
  dkv_kernel<D, KIND><<<grid, THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace sm90
