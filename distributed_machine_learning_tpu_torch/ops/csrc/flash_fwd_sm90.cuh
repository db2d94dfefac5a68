// The Hopper flash-attention forward mainloop shared by K1 (flash_fwd.cu:
// causal self-attention, normalized output and lse) and K11 (ring_flash.cu:
// one ring chunk step, the f32 (m, l, acc) carry in and out, causal on the
// diagonal step, unmasked on a full one).  bf16 inputs only; the f32 modes
// keep their CUDA-core kernels.  The Hopper helpers (mbarriers, TMA, wgmma,
// tile geometry, tensor maps) live in sm90_common.cuh, shared with the
// backward mainloops of flash_bwd_sm90.cuh.
//
// What bounds it on the H100: operations (two products of depth D per
//   query-key pair at the bf16 tensor-core rate); the score matrix never
//   reaches device memory.
//
// Design (a simplified FlashAttention-3 forward): one block of 3
//   warpgroups owns a 128-row query tile of one (batch, query head).
//   Warpgroup 0 is the producer: it drops to 24 registers (setmaxnreg) and
//   one of its threads issues TMA loads (cp.async.bulk.tensor, 4-D maps
//   over the [B, L, heads, D] views with their byte strides) of the Q tile
//   once and of 128-key K and V tiles into a 2-stage ring in shared memory,
//   each stage with transaction-counted full barriers and empty barriers
//   the consumers release, K and V apart: K of a tile is free once its S
//   is in, a turn before its V, so the next K streams in a turn earlier.
//   Warpgroups 1 and 2 are the consumers (240 registers), 64 query rows
//   each.  S = Q K^T runs on wgmma m64n128k16 with both operands in shared
//   memory (K-major); O += P V on wgmma m64nDk16 with P from registers
//   and V MN-major in shared memory (the transpose bit).  Tiles are stored
//   as TMA writes them, rows of min(D, 64) bf16 in 128-byte (D 64, 128) or
//   64-byte (D 32) swizzle atoms, so a D-128 tile is two [128][64] atoms
//   side by side; the wgmma descriptors carry the same swizzle.  The softmax runs in f32 on
//   the accumulator layout in base 2 (scores times scale * log2(e), exp2).
//   The two consumers take turns on the tensor cores through two named
//   barriers ("ping-pong"): a turn issues S of tile j and P V of tile j - 1
//   together, so one warpgroup's softmax overlaps the other's products, and
//   within a warpgroup the row max and exps of tile j overlap its P V of
//   tile j - 1.  Query tiles are issued heaviest first (the diagonal makes
//   late tiles the heaviest): the tile index is the grid's slow axis.
//
// Numerics, as the plain versions: masked scores are -1e30 and their p is
//   forced to 0; keys at or past L are masked in the score (TMA's zero fill
//   is no mask: a zero key scores 0); P is rounded to bf16 before P V while
//   the row sum l uses the f32 P; the KV head of query head h is
//   h / (H / Hkv), read in place; rows at or past L are never stored.

#pragma once

#include "sm90_common.cuh"

namespace sm90 {

constexpr int BQ = 128;   // query rows per block (64 per consumer warpgroup)
constexpr int BKV = 128;  // keys per tile
constexpr int STAGES = 2;  // 3 fit at D 128 (225 KB) and measured no faster
constexpr int THREADS = 384;

struct FwdParams {
  int L, H, Hkv;        // L: K1's length or K11's chunk length Lc
  float scale_log2;
  __nv_bfloat16* out;   // K1: [B, L, H, D] through o_sb, o_sl, o_sh
  long long o_sb, o_sl, o_sh;
  float* lse;           // K1: [B, H, L]
  float *m, *l, *acc;   // K11: the contiguous f32 carry, [B, H, Lc] and [B, Lc, H, D]
};

// The geometry of a 128-row tile (sm90_common.cuh's TileGeom) and the
// shared memory of a block: Q, K and V stages, the barriers, and room to
// align the base to 1024.
template <int D>
struct Tile : TileGeom<D, BKV> {
  static constexpr int SMEM =
      TileGeom<D, BKV>::BYTES * (1 + 2 * STAGES) + 8 * (1 + 4 * STAGES) + 1024;
};

template <int D, int KIND>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  using T = Tile<D>;
  constexpr bool CAUSAL = KIND != RING_FULL;
  extern __shared__ unsigned char sm90_smem[];
  const uint32_t base = (smem_u32(sm90_smem) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t sQ = base, sK = base + T::BYTES, sV = sK + STAGES * T::BYTES;
  const uint32_t bars = sV + STAGES * T::BYTES;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * STAGES + s); };

  const int L = p.L, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / p.Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (latest) query tiles first
  const int q0 = qt * BQ;
  // The diagonal walks key tiles 0..qt (BQ == BKV); a full step all of them.
  const int n_tiles = CAUSAL ? qt + 1 : (L + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
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
      mbar_expect_tx(full_q, T::BYTES);
      T::load(sQ, &tq, full_q, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        // K of tile j - STAGES is free once both consumers have its S; V once
        // they have its P V, a turn later.
        if (j >= STAGES) mbar_wait(empty_k(s), (j / STAGES - 1) & 1);
        mbar_expect_tx(full_k(s), T::BYTES);
        T::load(sK + s * T::BYTES, &tk, full_k(s), hk, j * BKV, b);
        if (j >= STAGES) mbar_wait(empty_v(s), (j / STAGES - 1) & 1);
        mbar_expect_tx(full_v(s), T::BYTES);
        T::load(sV + s * T::BYTES, &tv, full_v(s), hk, j * BKV, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;  // this consumer's 64 rows: c * 64 .. c * 64 + 63 of the tile
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wr = c * 64 + warp * 16;  // this warp's first row inside the tile
    const float scale_log2 = p.scale_log2;
    // Ping-pong: consumer c issues its products after bar.sync on barrier
    // 1 + c, then lets the other one go (bar.arrive on 2 - c).  Consumer 1
    // opens the first turn to consumer 0 and skips its last arrival, so
    // every arrival is matched.
    if (c == 1) named_arrive(1);
    auto turn_begin = [&]() { named_sync(1 + c); };
    auto turn_end = [&](bool last) {
      if (!(last && c == 1)) named_arrive(2 - c);
    };

    // The accumulator layout (wgmma m64nN, f32): element i of a thread is
    // row g + 8 * ((i >> 1) & 1) of its warp's 16 and column
    // (i >> 2) * 8 + 2t + (i & 1).
    float s[BKV / 2];
    float o[D / 2];
    uint32_t pf[BKV / 16][4];
    float m_run[2], l_run[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wr + g + half * 8;
      if constexpr (KIND == FLASH) {
        m_run[half] = NEG_INF;
        l_run[half] = 0.f;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) o[4 * nd + 2 * half] = o[4 * nd + 2 * half + 1] = 0.f;
      } else {
        const bool has_carry = row < L;  // padded rows start empty
        const long long r = static_cast<long long>(bh) * L + row;
        m_run[half] = has_carry ? p.m[r] : NEG_INF;
        l_run[half] = has_carry && t == 0 ? p.l[r] : 0.f;  // the quad's shares of l
        acc_load_row<D>(o, half,
                        has_carry ? p.acc + ((static_cast<long long>(b) * L + row) * H + h) * D
                                  : nullptr,
                        t);
      }
    }

    // Descriptor bases; a k-step adds its byte offset / 16 to the start
    // address field.  The bases pass through an empty asm in every turn, so
    // the compiler rebuilds the step descriptors there (two adds each)
    // instead of holding them all in registers across the loop.
    const uint64_t q_desc = smem_desc(sQ + c * 64 * T::ROW_BYTES, 16, T::GROUP, T::SWIZZLE);
    const uint64_t k_desc = smem_desc(sK, 16, T::GROUP, T::SWIZZLE);
    const uint64_t v_desc = smem_desc(sV, T::ATOM_BYTES, T::GROUP, T::SWIZZLE);
    // S = Q K^T of this consumer's 64 rows and the 128 keys of stage st.
    auto gemm_s = [&](int st) {
      uint64_t dq = q_desc, dk = k_desc + st * (T::BYTES >> 4);
      asm volatile("" : "+l"(dq), "+l"(dk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / T::KSTEPS) * T::ATOM_BYTES + (kk % T::KSTEPS) * 32) >> 4;
        wgmma_ss_n128(s, dq + off, dk + off, kk > 0);
      }
    };
    // O += P V over the 128 keys of stage st (V MN-major: the leading
    // offset steps between atom columns, the stride offset between 8 keys).
    auto gemm_pv = [&](int st) {
      uint64_t dv = v_desc + st * (T::BYTES >> 4);
      asm volatile("" : "+l"(dv));
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<D>(o, pf[kk], dv + ((kk * 16 * T::ROW_BYTES) >> 4));
    };
    // Turn tile j's scores into f32 probabilities in place, in log2 space
    // (score * scale * log2(e)); updates m and this thread's share of l
    // (the quad's four shares are summed once, after the last tile) and
    // returns each row's alpha.  Only the diagonal tile (causal) and a tile
    // reaching past L hold masked keys: they take the path that masks and
    // forces a masked p to 0; every other tile takes one FFMA and one exp2
    // a score.
    auto softmax = [&](int j, float* alpha) {
      const bool edge = (CAUSAL && j == qt) || ((j + 1) * BKV > L);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          float val = s[i] * scale_log2;
          const int key = j * BKV + (i >> 2) * 8 + 2 * t + (i & 1);
          const int row = q0 + wr + g + ((i >> 1) & 1) * 8;
          if ((CAUSAL && key > row) || key >= L) val = NEG_INF;
          s[i] = val;
        }
      }
      const float sc = edge ? 1.f : scale_log2;  // the scale still to apply
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = NEG_INF;
#pragma unroll
        for (int i = 2 * half; i < BKV / 2; i += 4) mx = fmaxf(mx, fmaxf(s[i], s[i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[half], mx * sc);
        alpha[half] = fast_exp2(m_run[half] - m_new);
        m_run[half] = m_new;
        float rowsum = 0.f;
        if (edge) {
#pragma unroll
          for (int i = 2 * half; i < BKV / 2; i += 4)
#pragma unroll
            for (int e = i; e < i + 2; ++e) {
              const float pv = s[e] > 0.5f * NEG_INF ? fast_exp2(s[e] - m_new) : 0.f;
              s[e] = pv;
              rowsum += pv;
            }
        } else {
#pragma unroll
          for (int i = 2 * half; i < BKV / 2; i += 4)
#pragma unroll
            for (int e = i; e < i + 2; ++e) {
              const float pv = fast_exp2(fmaf(s[e], scale_log2, -m_new));
              s[e] = pv;
              rowsum += pv;
            }
        }
        l_run[half] = l_run[half] * alpha[half] + rowsum;
      }
    };
    // O *= alpha, then P = bf16(p): the S accumulator layout of 16 keys is
    // the A-fragment layout of one k-step of P V.
    auto rescale_and_pack = [&](const float* alpha) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_a<BKV / 16>(pf, s);
    };

    float alpha[2];
    mbar_wait(full_q, 0);
    mbar_wait(full_k(0), 0);
    turn_begin();
    wgmma_fence();
    gemm_s(0);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<0>();
    fence_regs<BKV / 2>(s);
    if (lane == 0) mbar_arrive(empty_k(0));  // this warp is done with K of tile 0
    softmax(0, alpha);
    rescale_and_pack(alpha);

    for (int j = 1; j < n_tiles; ++j) {
      const int sj = j % STAGES, sp = (j - 1) % STAGES;
      mbar_wait(full_k(sj), (j / STAGES) & 1);
      mbar_wait(full_v(sp), ((j - 1) / STAGES) & 1);
      turn_begin();
      fence_regs<D / 2>(o);
      fence_regs<BKV / 4>(&pf[0][0]);
      wgmma_fence();
      gemm_s(sj);
      wgmma_commit();
      gemm_pv(sp);
      wgmma_commit();
      turn_end(false);
      wgmma_wait<1>();  // S of tile j is in; P V of tile j - 1 may still run
      fence_regs<BKV / 2>(s);
      if (lane == 0) mbar_arrive(empty_k(sj));
      softmax(j, alpha);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      fence_regs<BKV / 4>(&pf[0][0]);
      if (lane == 0) mbar_arrive(empty_v(sp));
      rescale_and_pack(alpha);
    }
    const int last = n_tiles - 1;
    mbar_wait(full_v(last % STAGES), (last / STAGES) & 1);
    turn_begin();
    fence_regs<D / 2>(o);
    fence_regs<BKV / 4>(&pf[0][0]);
    wgmma_fence();
    gemm_pv(last % STAGES);
    wgmma_commit();
    turn_end(true);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 1);
      l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 2);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wr + g + half * 8;
      if (row >= L) continue;
      const long long r = static_cast<long long>(bh) * L + row;
      if constexpr (KIND == FLASH) {
        // out = acc / max(l, 1e-30) in bf16; lse = m + log2(max(l, 1e-30)).
        const float l_safe = fmaxf(l_run[half], 1e-30f);
        const float inv = 1.f / l_safe;
        if (t == 0) p.lse[r] = m_run[half] + log2f(l_safe);
        __nv_bfloat16* orow = p.out + b * p.o_sb + h * p.o_sh + row * p.o_sl;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
          *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t) = __floats2bfloat162_rn(
              o[4 * nd + 2 * half] * inv, o[4 * nd + 2 * half + 1] * inv);
      } else {
        // The carry out: m, l and the unnormalized acc.
        if (t == 0) {
          p.m[r] = m_run[half];
          p.l[r] = l_run[half];
        }
        acc_store_row<D>(o, half, p.acc + ((static_cast<long long>(b) * L + row) * H + h) * D, t);
      }
    }
  }
}

// Launch the forward of kind KIND: q [B, L, H, D], k and v [B, L, Hkv, D]
// with element strides st = (q: b, l, h; k: b, l, h; v: b, l, h).
template <int D, int KIND>
int launch_fwd(const void* q, const void* k, const void* v, const long long* st, int B,
               const FwdParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, B, p.L, p.H, st[0], st[1], st[2], BKV) ||
      !make_map<D>(&tk, k, B, p.L, p.Hkv, st[3], st[4], st[5], BKV) ||
      !make_map<D>(&tv, v, B, p.L, p.Hkv, st[6], st[7], st[8], BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Tile<D>::SMEM;
  static std::atomic<unsigned long long> configured{0};
  if (int err = set_smem_once(fwd_kernel<D, KIND>, smem, configured)) return err;
  dim3 grid(B * p.H, (p.L + BQ - 1) / BQ);
  fwd_kernel<D, KIND><<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
