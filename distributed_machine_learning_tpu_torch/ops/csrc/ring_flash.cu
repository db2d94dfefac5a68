// Ring flash-attention chunk steps, bf16 or f32, GQA-native: K11 (forward
// carry update), K12 (dQ) and K13 (the traveling dK, dV).
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/ring_flash_attention.py,
//   _chunk_fwd (_chunk_fwd_kernel, K11), _chunk_dq (_chunk_dq_kernel, K12)
//   and _chunk_dkv (_chunk_dkv_kernel, K13): one ring step of context-
//   parallel training, one visiting K/V chunk against this rank's query
//   chunk of Lc rows.
//
// What bounds them on the H100: operations.  A full step (an earlier
//   chunk) covers Lc^2 query-key pairs per (batch, query head); K11 does
//   2 products of depth D per pair (S = Q K^T, P V), K12 3 (S, dP = dO V^T,
//   dS K) and K13 4 (S, dP, P^T dO, dS^T Q).  At B 1, H 16, Lc 4096, D 128
//   that is 137, 206 and 275 GFLOP: 0.139, 0.208 and 0.278 ms at 989
//   TFLOP/s, against O(Lc * D) bytes (q, k, v, dO, the f32 carry or
//   accumulators).  A diagonal step does half the pairs.
//
// Design: K11 (bf16) is the Hopper forward mainloop of flash_fwd_sm90.cuh
//   (kinds RING_DIAGONAL and RING_FULL): 128-row query tiles of one
//   (b, h), a TMA-fed producer warpgroup and two ping-ponging consumer
//   warpgroups on wgmma.  It loads its rows' (m, l, acc) from the f32 carry
//   into the accumulator layout before the first key tile and writes them
//   back after the last, without normalizing (acc / l and the lse happen
//   once, after the ring's last step).  K12 and K13 keep the tiles of K2
//   and K3 (flash_bwd.cu) on mma.sync with a carry: K12 owns a 64-row query
//   tile (4 warps, 16 rows a warp), walks 64-key tiles of the visiting
//   chunk, double-buffered in shared memory by cp.async, reads its dq rows
//   from the f32 accumulator, adds this pair's dS K and writes them back.
//   K13 owns a 64-key tile of one (b, kv head), loops over the group's
//   H/Hkv query heads and their 32-query tiles, sums dK and dV of the whole
//   group in f32 registers and adds them into the NARROW traveling f32
//   dK/dV: no per-query-head buffers and no group-sum pass (the TPU path
//   sums the group in f32 too).  Each block owns the rows it writes: no
//   atomics, and the result is deterministic.  CAUSAL (the diagonal step:
//   both chunks at one global offset) walks tiles up to the diagonal with
//   local indices and masks the diagonal tile; a full step (an earlier
//   chunk) walks every tile with no mask but the chunk's end.  Query (key,
//   for K13) tiles are issued heaviest first.  Scores run in base 2
//   (scale * log2(e), exp2); masked scores are -1e30 and their probability
//   is forced to 0; P is rounded to bf16 before P V (the row sum uses the
//   f32 P), dS before dS K and dS^T Q, P before P^T dO, where the TPU
//   kernels cast to the input dtype.  The KV head of query head h is
//   h / (H / Hkv), read in place.  Inputs are read through their strides;
//   the carry, lse, delta and the f32 accumulators are contiguous.  Any
//   chunk length works: rows and keys past Lc are masked.
//
// f32 inputs take CUDA-core kernels (no TF32), as K1-K3's f32 modes: 64
//   rows a block (query rows for K11/K12, key rows for K13), 4 threads a
//   row, each owning every 4th of the row's D dims, dot products as 4-lane
//   shuffle sums; 32-row tiles of the other side in shared memory.  Same
//   carry, masking and tile walk as the bf16 kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 4;
constexpr int BQ = 64;   // K12: query rows per block (16 per warp)
constexpr int BKV = 64;  // K12: keys per tile; K13: keys per block (16 per warp)
constexpr int BQ3 = 32;  // K13: queries per tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int nbytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(nbytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment (m16n8k16, row-major) of rows r0..r0+15, columns
// c0..c0+15 of a [rows][P] bf16 tile in shared memory.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile, int P, int r0,
                                       int c0, int g, int t) {
  const __nv_bfloat16* p0 = tile + (r0 + g) * P + c0 + 2 * t;
  const __nv_bfloat16* p8 = p0 + 8 * P;
  a[0] = ld32(p0);
  a[1] = ld32(p8);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p8 + 8);
}

// The A fragment of a 16 x 16 slice held in m16n8 accumulators c0 (columns
// 0-7) and c1 (8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

struct Strides {  // element strides of a [B, Lc, heads, D] view (last dim contiguous)
  long long b, l, h;
};

// Offset of element (b, row, head, 0) of a contiguous f32 [B, Lc, heads, D].
__device__ __forceinline__ long long acc_off(int b, int row, int head, int Lc, int heads, int D) {
  return ((static_cast<long long>(b) * Lc + row) * heads + head) * D;
}

// --------------------------------------------------------------- K12, bf16
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NWARPS * 32)
    ring_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, Strides qs, Strides ks, Strides vs, Strides dos,
                   int Lc, int H, int Hkv, float scale_log2, float scale) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][P]
  __nv_bfloat16* dOs = Qs + BQ * P;                                 // [BQ][P]
  __nv_bfloat16* Ks = dOs + BQ * P;                                 // [2][BKV][P]
  __nv_bfloat16* Vs = Ks + 2 * BKV * P;                             // [2][BKV][P]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (latest) query tiles first
  const int q0 = qt * BQ;
  const int n_key_tiles = CAUSAL ? qt + 1 : (Lc + BKV - 1) / BKV;  // dQ's key-tile walk

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* ob = dout + b * dos.b + h * dos.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  constexpr int CPR = D / 8;
  for (int c = tid; c < BQ * CPR; c += NWARPS * 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = q0 + r < Lc;
    cp_async16(Qs + r * P + cc, ok ? qb + (q0 + r) * qs.l + cc : qb, ok);
    cp_async16(dOs + r * P + cc, ok ? ob + (q0 + r) * dos.l + cc : ob, ok);
  }
  auto load_kv = [&](int buf, int j) {
    const int k0 = j * BKV;
    for (int c = tid; c < BKV * CPR; c += NWARPS * 32) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      const bool ok = k0 + r < Lc;
      cp_async16(Ks + (buf * BKV + r) * P + cc, ok ? kb + (k0 + r) * ks.l + cc : kb, ok);
      cp_async16(Vs + (buf * BKV + r) * P + cc, ok ? vb + (k0 + r) * vs.l + cc : vb, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q, dO and the first K/V tile

  const int wr = warp * 16;
  float lse_r[2], dl_r[2];
  float acc[D / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    const bool ok = row < Lc;
    lse_r[half] = ok ? lse[static_cast<long long>(bh) * Lc + row] : 0.f;
    dl_r[half] = ok ? delta[static_cast<long long>(bh) * Lc + row] : 0.f;
    const float* dr = dq + acc_off(b, ok ? row : 0, h, Lc, H, D);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const float2 a = ok ? *reinterpret_cast<const float2*>(dr + nd * 8 + 2 * t)
                          : make_float2(0.f, 0.f);
      acc[nd][2 * half] = a.x;
      acc[nd][2 * half + 1] = a.y;
    }
  }

  for (int j = 0; j < n_key_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_key_tiles) {
      load_kv(buf ^ 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BKV * P;
    const __nv_bfloat16* Vt = Vs + buf * BKV * P;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys.
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, Qs, P, wr, kk * 16, g, t);
      load_a(da, dOs, P, wr, kk * 16, g, t);
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const __nv_bfloat16* kr = Kt + (ni * 8 + g) * P + kk * 16 + 2 * t;
        const __nv_bfloat16* vr = Vt + (ni * 8 + g) * P + kk * 16 + 2 * t;
        mma_bf16_16816(s[ni], qa, ld32(kr), ld32(kr + 8));
        mma_bf16_16816(dp[ni], da, ld32(vr), ld32(vr + 8));
      }
    }
    // dS = P (dP - delta) * scale, P from the lse; masked above the
    // diagonal (causal) and past Lc.
    const bool edge = (CAUSAL && j == qt) || ((j + 1) * BKV > Lc);
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = s[ni][e] * scale_log2;
        if (edge) {
          const int key = j * BKV + ni * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          if ((CAUSAL && key > row) || key >= Lc) sv = NEG_INF;
        }
        const float p = sv > 0.5f * NEG_INF ? exp2f(sv - lse_r[e >> 1]) : 0.f;
        s[ni][e] = p * (dp[ni][e] - dl_r[e >> 1]) * scale;
      }
    // dQ += bf16(dS) K.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, Kt + krow * P + nd * 16 + (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * nd], a, bfrag[0], bfrag[1]);
        mma_bf16_16816(acc[2 * nd + 1], a, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    if (row >= Lc) continue;
    float* dr = dq + acc_off(b, row, h, Lc, H, D);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(dr + nd * 8 + 2 * t) =
          make_float2(acc[nd][2 * half], acc[nd][2 * half + 1]);
  }
}

// --------------------------------------------------------------- K13, bf16
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NWARPS * 32)
    ring_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, Strides qs, Strides ks,
                    Strides vs, Strides dos, int Lc, int H, int Hkv, float scale_log2,
                    float scale) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BKV][P]
  __nv_bfloat16* Vs = Ks + BKV * P;                                 // [BKV][P]
  __nv_bfloat16* Qs = Vs + BKV * P;                                 // [2][BQ3][P]
  __nv_bfloat16* dOs = Qs + 2 * BQ3 * P;                            // [2][BQ3][P]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ3 * P);       // [2][BQ3]
  float* dl_s = lse_s + 2 * BQ3;                                    // [2][BQ3]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * BKV;  // key tile 0 (the most work) first
  const int first_qt = CAUSAL ? k0 / BQ3 : 0;  // the first query tile that sees key k0
  const int nq = (Lc + BQ3 - 1) / BQ3 - first_qt;
  const int n_iters = rep * nq;  // (query head of the group, query tile)

  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  constexpr int CPR = D / 8;
  for (int c = tid; c < BKV * CPR; c += NWARPS * 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = k0 + r < Lc;
    cp_async16(Ks + r * P + cc, ok ? kb + (k0 + r) * ks.l + cc : kb, ok);
    cp_async16(Vs + r * P + cc, ok ? vb + (k0 + r) * vs.l + cc : vb, ok);
  }
  auto load_q = [&](int buf, int i) {
    const int h = hk * rep + i / nq;
    const int q0 = (first_qt + i % nq) * BQ3;
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* ob = dout + b * dos.b + h * dos.h;
    for (int c = tid; c < BQ3 * CPR; c += NWARPS * 32) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      const bool ok = q0 + r < Lc;
      cp_async16(Qs + (buf * BQ3 + r) * P + cc, ok ? qb + (q0 + r) * qs.l + cc : qb, ok);
      cp_async16(dOs + (buf * BQ3 + r) * P + cc, ok ? ob + (q0 + r) * dos.l + cc : ob, ok);
    }
    if (tid < BQ3) {
      const int row = q0 + tid;
      const long long off = (static_cast<long long>(b) * H + h) * Lc + row;
      lse_s[buf * BQ3 + tid] = row < Lc ? lse[off] : 0.f;
      dl_s[buf * BQ3 + tid] = row < Lc ? delta[off] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();  // group 0: K, V and the first Q/dO tile

  // The traveling accumulators in: rows (keys) wk + g (half 0) and + 8.
  const int wk = warp * 16;  // this warp's first key inside the tile
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + wk + g + half * 8;
    const bool ok = key < Lc;
    const long long off = acc_off(b, ok ? key : 0, hk, Lc, Hkv, D);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const float2 a = ok ? *reinterpret_cast<const float2*>(dk + off + nd * 8 + 2 * t)
                          : make_float2(0.f, 0.f);
      const float2 c = ok ? *reinterpret_cast<const float2*>(dv + off + nd * 8 + 2 * t)
                          : make_float2(0.f, 0.f);
      dk_acc[nd][2 * half] = a.x;
      dk_acc[nd][2 * half + 1] = a.y;
      dv_acc[nd][2 * half] = c.x;
      dv_acc[nd][2 * half + 1] = c.y;
    }
  }

  for (int i = 0; i < n_iters; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_iters) {
      load_q(buf ^ 1, i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (first_qt + i % nq) * BQ3;
    const __nv_bfloat16* Qt = Qs + buf * BQ3 * P;
    const __nv_bfloat16* Ot = dOs + buf * BQ3 * P;
    const float* lse_t = lse_s + buf * BQ3;
    const float* dl_t = dl_s + buf * BQ3;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 queries.
    float s[BQ3 / 8][4], dp[BQ3 / 8][4];
#pragma unroll
    for (int ni = 0; ni < BQ3 / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, P, wk, kk * 16, g, t);
      load_a(va, Vs, P, wk, kk * 16, g, t);
#pragma unroll
      for (int ni = 0; ni < BQ3 / 8; ++ni) {
        const __nv_bfloat16* qr = Qt + (ni * 8 + g) * P + kk * 16 + 2 * t;
        const __nv_bfloat16* orow = Ot + (ni * 8 + g) * P + kk * 16 + 2 * t;
        mma_bf16_16816(s[ni], ka, ld32(qr), ld32(qr + 8));
        mma_bf16_16816(dp[ni], va, ld32(orow), ld32(orow + 8));
      }
    }
    // P^T and dS^T; element (key, query): key = k0 + wk + g (+8), query =
    // q0 + ni * 8 + 2t (+1).  s becomes P^T, dp becomes dS^T.
    const bool edge = (CAUSAL && q0 < k0 + BKV) || q0 + BQ3 > Lc || k0 + BKV > Lc;
#pragma unroll
    for (int ni = 0; ni < BQ3 / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ni * 8 + 2 * t + (e & 1);
        float sv = s[ni][e] * scale_log2;
        if (edge) {
          const int key = k0 + wk + g + (e >> 1) * 8;
          const int qrow = q0 + col;
          if ((CAUSAL && key > qrow) || qrow >= Lc || key >= Lc) sv = NEG_INF;
        }
        const float p = sv > 0.5f * NEG_INF ? exp2f(sv - lse_t[col]) : 0.f;
        s[ni][e] = p;
        dp[ni][e] = p * (dp[ni][e] - dl_t[col]) * scale;
      }
    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q.
#pragma unroll
    for (int kk = 0; kk < BQ3 / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
      const int qrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, Ot + qrow * P + nd * 16 + (lane >> 4) * 8);
        mma_bf16_16816(dv_acc[2 * nd], pa, bfrag[0], bfrag[1]);
        mma_bf16_16816(dv_acc[2 * nd + 1], pa, bfrag[2], bfrag[3]);
        ldmatrix_x4_trans(bfrag, Qt + qrow * P + nd * 16 + (lane >> 4) * 8);
        mma_bf16_16816(dk_acc[2 * nd], sa, bfrag[0], bfrag[1]);
        mma_bf16_16816(dk_acc[2 * nd + 1], sa, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + wk + g + half * 8;
    if (key >= Lc) continue;
    const long long off = acc_off(b, key, hk, Lc, Hkv, D);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<float2*>(dk + off + nd * 8 + 2 * t) =
          make_float2(dk_acc[nd][2 * half], dk_acc[nd][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + off + nd * 8 + 2 * t) =
          make_float2(dv_acc[nd][2 * half], dv_acc[nd][2 * half + 1]);
    }
  }
}

// ------------------------------------------------------ f32 (CUDA cores)
constexpr int F32_ROWS = 64, F32_TILE = 32, F32_TPR = 4;  // rows, tile, threads a row

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// K11, f32.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(F32_ROWS* F32_TPR)
    ring_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ m_c,
                        float* __restrict__ l_c, float* __restrict__ acc, Strides qs,
                        Strides ks, Strides vs, int Lc, int H, int Hkv, float scale_log2) {
  constexpr int NT = F32_ROWS * F32_TPR;
  constexpr int DPT = D / F32_TPR;  // dims per thread: d = i * F32_TPR + t
  __shared__ float Ks[F32_TILE][D];
  __shared__ float Vs[F32_TILE][D];

  const int tid = threadIdx.x, t = tid % F32_TPR;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F32_ROWS;  // heaviest tiles first
  const int row = q0 + tid / F32_TPR;
  const bool live = row < Lc;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float qv[DPT], o[DPT];
  const float* qr = q + b * qs.b + h * qs.h + static_cast<long long>(live ? row : 0) * qs.l;
  const float* ar = acc + acc_off(b, live ? row : 0, h, Lc, H, D);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qv[i] = live ? qr[i * F32_TPR + t] : 0.f;
    o[i] = live ? ar[i * F32_TPR + t] : 0.f;
  }
  const long long row_off = static_cast<long long>(bh) * Lc + row;
  float m = live ? m_c[row_off] : NEG_INF;
  float l = live ? l_c[row_off] : 0.f;
  const int n_keys = CAUSAL ? min(q0 + F32_ROWS, Lc) : Lc;
  for (int k0 = 0; k0 < n_keys; k0 += F32_TILE) {
    __syncthreads();  // every thread is done with the previous tile
    for (int c = tid; c < F32_TILE * D; c += NT) {
      const int r = c / D, d = c % D;
      const bool ok = k0 + r < Lc;
      Ks[r][d] = ok ? kb[static_cast<long long>(k0 + r) * ks.l + d] : 0.f;
      Vs[r][d] = ok ? vb[static_cast<long long>(k0 + r) * vs.l + d] : 0.f;
    }
    __syncthreads();
    float s[F32_TILE];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qv[i], Ks[j][i * F32_TPR + t], part);
      part = quad_sum(part);
      const int key = k0 + j;
      s[j] = (CAUSAL && key > row) || key >= Lc ? NEG_INF : part * scale_log2;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[i] *= alpha;
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      const float p = s[j] > 0.5f * NEG_INF ? exp2f(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) o[i] = fmaf(p, Vs[j][i * F32_TPR + t], o[i]);
    }
    m = m_new;
  }
  if (!live) return;
  if (t == 0) {
    m_c[row_off] = m;
    l_c[row_off] = l;
  }
  float* aw = acc + acc_off(b, row, h, Lc, H, D);
#pragma unroll
  for (int i = 0; i < DPT; ++i) aw[i * F32_TPR + t] = o[i];
}

// K12, f32.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(F32_ROWS* F32_TPR)
    ring_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, Strides qs, Strides ks, Strides vs, Strides dos,
                       int Lc, int H, int Hkv, float scale_log2, float scale) {
  constexpr int NT = F32_ROWS * F32_TPR;
  constexpr int DPT = D / F32_TPR;
  __shared__ float Ks[F32_TILE][D];
  __shared__ float Vs[F32_TILE][D];

  const int tid = threadIdx.x, t = tid % F32_TPR;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F32_ROWS;
  const int row = q0 + tid / F32_TPR;
  const bool live = row < Lc;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float qv[DPT], ov[DPT], a[DPT];
  const long long rl = live ? row : 0;
  const float* qr = q + b * qs.b + h * qs.h + rl * qs.l;
  const float* orow = dout + b * dos.b + h * dos.h + rl * dos.l;
  const float* dr = dq + acc_off(b, live ? row : 0, h, Lc, H, D);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qv[i] = live ? qr[i * F32_TPR + t] : 0.f;
    ov[i] = live ? orow[i * F32_TPR + t] : 0.f;
    a[i] = live ? dr[i * F32_TPR + t] : 0.f;
  }
  const float lse_r = live ? lse[static_cast<long long>(bh) * Lc + row] : 0.f;
  const float dl_r = live ? delta[static_cast<long long>(bh) * Lc + row] : 0.f;
  const int n_keys = CAUSAL ? min(q0 + F32_ROWS, Lc) : Lc;
  for (int k0 = 0; k0 < n_keys; k0 += F32_TILE) {
    __syncthreads();
    for (int c = tid; c < F32_TILE * D; c += NT) {
      const int r = c / D, d = c % D;
      const bool ok = k0 + r < Lc;
      Ks[r][d] = ok ? kb[static_cast<long long>(k0 + r) * ks.l + d] : 0.f;
      Vs[r][d] = ok ? vb[static_cast<long long>(k0 + r) * vs.l + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < F32_TILE; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        sp = fmaf(qv[i], Ks[j][i * F32_TPR + t], sp);
        dpp = fmaf(ov[i], Vs[j][i * F32_TPR + t], dpp);
      }
      sp = quad_sum(sp);
      dpp = quad_sum(dpp);
      const int key = k0 + j;
      const float sv = (CAUSAL && key > row) || key >= Lc ? NEG_INF : sp * scale_log2;
      const float p = sv > 0.5f * NEG_INF ? exp2f(sv - lse_r) : 0.f;
      const float ds = p * (dpp - dl_r) * scale;
#pragma unroll
      for (int i = 0; i < DPT; ++i) a[i] = fmaf(ds, Ks[j][i * F32_TPR + t], a[i]);
    }
  }
  if (!live) return;
  float* dw = dq + acc_off(b, row, h, Lc, H, D);
#pragma unroll
  for (int i = 0; i < DPT; ++i) dw[i * F32_TPR + t] = a[i];
}

// K13, f32.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(F32_ROWS* F32_TPR)
    ring_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, Strides qs, Strides ks,
                        Strides vs, Strides dos, int Lc, int H, int Hkv, float scale_log2,
                        float scale) {
  constexpr int NT = F32_ROWS * F32_TPR;
  constexpr int DPT = D / F32_TPR;
  __shared__ float Qs[F32_TILE][D];
  __shared__ float Os[F32_TILE][D];
  __shared__ float lse_s[F32_TILE], dl_s[F32_TILE];

  const int tid = threadIdx.x, t = tid % F32_TPR;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * F32_ROWS;
  const int key = k0 + tid / F32_TPR;
  const bool live = key < Lc;

  float kv[DPT], vv[DPT], dka[DPT], dva[DPT];
  const long long kl = live ? key : 0;
  const float* kr = k + b * ks.b + hk * ks.h + kl * ks.l;
  const float* vr = v + b * vs.b + hk * vs.h + kl * vs.l;
  const long long off = acc_off(b, live ? key : 0, hk, Lc, Hkv, D);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kv[i] = live ? kr[i * F32_TPR + t] : 0.f;
    vv[i] = live ? vr[i * F32_TPR + t] : 0.f;
    dka[i] = live ? dk[off + i * F32_TPR + t] : 0.f;
    dva[i] = live ? dv[off + i * F32_TPR + t] : 0.f;
  }
  const int q_first = CAUSAL ? (k0 / F32_TILE) * F32_TILE : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* ob = dout + b * dos.b + h * dos.h;
    const long long row_off = (static_cast<long long>(b) * H + h) * Lc;
    for (int q0 = q_first; q0 < Lc; q0 += F32_TILE) {
      __syncthreads();
      for (int c = tid; c < F32_TILE * D; c += NT) {
        const int rr = c / D, d = c % D;
        const bool ok = q0 + rr < Lc;
        Qs[rr][d] = ok ? qb[static_cast<long long>(q0 + rr) * qs.l + d] : 0.f;
        Os[rr][d] = ok ? ob[static_cast<long long>(q0 + rr) * dos.l + d] : 0.f;
      }
      if (tid < F32_TILE) {
        const bool ok = q0 + tid < Lc;
        lse_s[tid] = ok ? lse[row_off + q0 + tid] : 0.f;
        dl_s[tid] = ok ? delta[row_off + q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < F32_TILE; ++j) {
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          sp = fmaf(kv[i], Qs[j][i * F32_TPR + t], sp);
          dpp = fmaf(vv[i], Os[j][i * F32_TPR + t], dpp);
        }
        sp = quad_sum(sp);
        dpp = quad_sum(dpp);
        const int qrow = q0 + j;
        const float sv =
            (CAUSAL && key > qrow) || qrow >= Lc || key >= Lc ? NEG_INF : sp * scale_log2;
        const float p = sv > 0.5f * NEG_INF ? exp2f(sv - lse_s[j]) : 0.f;
        const float ds = p * (dpp - dl_s[j]) * scale;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          dva[i] = fmaf(p, Os[j][i * F32_TPR + t], dva[i]);
          dka[i] = fmaf(ds, Qs[j][i * F32_TPR + t], dka[i]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dk[off + i * F32_TPR + t] = dka[i];
    dv[off + i * F32_TPR + t] = dva[i];
  }
}

// ---------------------------------------------------------------- launches
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *o1, *o2, *o3;  // K11: m, l, acc; K12: dq; K13: dk, dv
  Strides qs, ks, vs, dos;
  int B, Lc, H, Hkv;
  float scale_log2, scale;
};

template <typename Kernel>
int set_smem(Kernel kernel, int smem, bool& configured) {
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

const __nv_bfloat16* bf(const void* p) { return static_cast<const __nv_bfloat16*>(p); }
const float* f32(const void* p) { return static_cast<const float*>(p); }

template <int D, bool CAUSAL>
int launch_fwd(const Args& a, bool bf16, cudaStream_t stream) {
  if (!bf16) {
    dim3 grid((a.Lc + F32_ROWS - 1) / F32_ROWS, a.B * a.H);
    ring_fwd_f32_kernel<D, CAUSAL><<<grid, F32_ROWS * F32_TPR, 0, stream>>>(
        f32(a.q), f32(a.k), f32(a.v), a.o1, a.o2, a.o3, a.qs, a.ks, a.vs, a.Lc, a.H, a.Hkv,
        a.scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  const long long st[9] = {a.qs.b, a.qs.l, a.qs.h, a.ks.b, a.ks.l, a.ks.h, a.vs.b, a.vs.l, a.vs.h};
  sm90::FwdParams p{};
  p.L = a.Lc;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.scale_log2 = a.scale_log2;
  p.m = a.o1;
  p.l = a.o2;
  p.acc = a.o3;
  return sm90::launch_fwd<D, CAUSAL ? sm90::RING_DIAGONAL : sm90::RING_FULL>(a.q, a.k, a.v, st,
                                                                            a.B, p, stream);
}

template <int D, bool CAUSAL>
int launch_dq(const Args& a, bool bf16, cudaStream_t stream) {
  if (!bf16) {
    dim3 grid((a.Lc + F32_ROWS - 1) / F32_ROWS, a.B * a.H);
    ring_dq_f32_kernel<D, CAUSAL><<<grid, F32_ROWS * F32_TPR, 0, stream>>>(
        f32(a.q), f32(a.k), f32(a.v), f32(a.dout), a.lse, a.delta, a.o1, a.qs, a.ks, a.vs,
        a.dos, a.Lc, a.H, a.Hkv, a.scale_log2, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int smem = (2 * BQ + 4 * BKV) * (D + 8) * 2;
  static bool configured = false;
  if (int err = set_smem(ring_dq_kernel<D, CAUSAL>, smem, configured)) return err;
  dim3 grid((a.Lc + BQ - 1) / BQ, a.B * a.H);
  ring_dq_kernel<D, CAUSAL><<<grid, NWARPS * 32, smem, stream>>>(
      bf(a.q), bf(a.k), bf(a.v), bf(a.dout), a.lse, a.delta, a.o1, a.qs, a.ks, a.vs, a.dos,
      a.Lc, a.H, a.Hkv, a.scale_log2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL>
int launch_dkv(const Args& a, bool bf16, cudaStream_t stream) {
  if (!bf16) {
    dim3 grid((a.Lc + F32_ROWS - 1) / F32_ROWS, a.B * a.Hkv);
    ring_dkv_f32_kernel<D, CAUSAL><<<grid, F32_ROWS * F32_TPR, 0, stream>>>(
        f32(a.q), f32(a.k), f32(a.v), f32(a.dout), a.lse, a.delta, a.o1, a.o2, a.qs, a.ks,
        a.vs, a.dos, a.Lc, a.H, a.Hkv, a.scale_log2, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int smem = (2 * BKV + 4 * BQ3) * (D + 8) * 2 + 4 * BQ3 * 4;
  static bool configured = false;
  if (int err = set_smem(ring_dkv_kernel<D, CAUSAL>, smem, configured)) return err;
  dim3 grid((a.Lc + BKV - 1) / BKV, a.B * a.Hkv);
  ring_dkv_kernel<D, CAUSAL><<<grid, NWARPS * 32, smem, stream>>>(
      bf(a.q), bf(a.k), bf(a.v), bf(a.dout), a.lse, a.delta, a.o1, a.o2, a.qs, a.ks, a.vs,
      a.dos, a.Lc, a.H, a.Hkv, a.scale_log2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of LAUNCH for head dim D and the step's kind, run on
// ``a``; cudaErrorInvalidValue for an unsupported head dim.
#define RING_DISPATCH(LAUNCH)                                                              \
  switch (D) {                                                                             \
    case 32: return causal ? LAUNCH<32, true>(a, bf16, s) : LAUNCH<32, false>(a, bf16, s);   \
    case 64: return causal ? LAUNCH<64, true>(a, bf16, s) : LAUNCH<64, false>(a, bf16, s);   \
    case 128: return causal ? LAUNCH<128, true>(a, bf16, s) : LAUNCH<128, false>(a, bf16, s); \
    default: return static_cast<int>(cudaErrorInvalidValue);                               \
  }

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* o1, void* o2, void* o3, const long long* st, int B,
               int Lc, int H, int Hkv, float scale_log2, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.o1 = static_cast<float*>(o1);
  a.o2 = static_cast<float*>(o2);
  a.o3 = static_cast<float*>(o3);
  a.qs = Strides{st[0], st[1], st[2]};
  a.ks = Strides{st[3], st[4], st[5]};
  a.vs = Strides{st[6], st[7], st[8]};
  a.dos = dout ? Strides{st[9], st[10], st[11]} : Strides{0, 0, 0};
  a.B = B;
  a.Lc = Lc;
  a.H = H;
  a.Hkv = Hkv;
  a.scale_log2 = scale_log2;
  a.scale = scale;
  return a;
}

}  // namespace

// Every entry takes q [B, Lc, H, D] and k, v [B, Lc, Hkv, D] (and dout
// [B, Lc, H, D]): views of one dtype (is_bf16 ? bf16 : f32) whose last dim
// is contiguous, with element strides (batch, seq, head) given in that
// order; causal = 1 for the diagonal step, 0 for a full one.  The f32
// operands are contiguous: m, l, lse, delta [B, H, Lc]; acc, dq
// [B, Lc, H, D]; dk, dv [B, Lc, Hkv, D].  Each updates its accumulators in
// place and returns the cudaError_t of its launch (cudaErrorInvalidValue
// for an unsupported head dim).
extern "C" int ring_flash_fwd(const void* q, const void* k, const void* v, void* m, void* l,
                              void* acc, long long q_sb, long long q_sl, long long q_sh,
                              long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                              long long v_sl, long long v_sh, int B, int Lc, int H, int Hkv,
                              int D, int is_bf16, int causal, float scale_log2, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  const Args a =
      make_args(q, k, v, nullptr, nullptr, nullptr, m, l, acc, st, B, Lc, H, Hkv, scale_log2, 0.f);
  const bool bf16 = is_bf16 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RING_DISPATCH(launch_fwd)
}

extern "C" int ring_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, long long q_sb,
                             long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                             long long k_sh, long long v_sb, long long v_sl, long long v_sh,
                             long long o_sb, long long o_sl, long long o_sh, int B, int Lc, int H,
                             int Hkv, int D, int is_bf16, int causal, float scale_log2,
                             float scale, void* stream) {
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, st, B, Lc, H, Hkv,
                           scale_log2, scale);
  const bool bf16 = is_bf16 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RING_DISPATCH(launch_dq)
}

extern "C" int ring_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv,
                              long long q_sb, long long q_sl, long long q_sh, long long k_sb,
                              long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                              long long v_sh, long long o_sb, long long o_sl, long long o_sh,
                              int B, int Lc, int H, int Hkv, int D, int is_bf16, int causal,
                              float scale_log2, float scale, void* stream) {
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, nullptr, st, B, Lc, H, Hkv,
                           scale_log2, scale);
  const bool bf16 = is_bf16 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RING_DISPATCH(launch_dkv)
}
