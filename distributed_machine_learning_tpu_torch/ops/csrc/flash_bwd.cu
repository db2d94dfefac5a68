// Causal flash-attention backward, bf16 or f32, GQA-native: K2 (dQ) and
// K3 (dK, dV).
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/flash_attention.py,
//   _flash_bwd: _flash_bwd_dq_kernel (K2) and _flash_bwd_dkv_kernel (K3),
//   the backward of flash_self_attention on the training path.
//
// What bounds them on the H100: operations.  Per (batch, query head) and
//   causal pair (L(L+1)/2 of them), K2 recomputes S = Q K^T and dP = dO V^T
//   and accumulates dQ = dS K (3 matmuls of depth D), K3 recomputes S and
//   dP and accumulates dV = P^T dO and dK = dS^T Q (4); the bytes (q, k, v,
//   dO, the f32 lse and delta rows, the outputs) are O(L * D).  At B 4,
//   L 4096, H 16, D 128 that is ~412 GFLOP (K2) and ~550 GFLOP (K3): 0.417
//   and 0.556 ms at 989 TFLOP/s.  The L x L matrices never reach memory.
//
// Design: two kernels, as the TPU splits them, so each owns its
//   accumulator: no atomics, and the result is deterministic.  Both
//   recompute P from the forward's lse in log2 space,
//   p = exp2(s * scale * log2(e) - lse), masked scores -1e30 with p forced
//   to 0, and dS = P (dP - delta) * scale with delta = rowsum(dO o O)
//   computed outside (f32).  dS is rounded to bf16 before dS K and dS^T Q,
//   and P before P^T dO, where the TPU kernels cast them to the input dtype.
//   A block loop takes the place of the TPU's sequential third grid axis.
//   - K2: a block of 4 warps owns a 64-row query tile of one (b, h) (16 rows
//     a warp) and walks the 64-key tiles up to the diagonal, K/V tiles
//     double-buffered in shared memory by cp.async (K1's pieces); S and dP
//     on mma.sync m16n8k16 bf16 with f32 accumulators, Q and dO fragments
//     read from shared memory; the accumulator layout of dS is the A
//     fragment of dS K, and K is read through ldmatrix.trans.  Query tiles
//     are issued longest first.
//   - K3: a block of 4 warps owns a 64-key tile of one (b, kv head) (16 keys
//     a warp) and loops over the H/Hkv query heads of the group and, for
//     each, over 32-query tiles from the diagonal to L (Q, dO, lse and
//     delta double-buffered).  It computes S^T = K Q^T and dP^T = V dO^T, so
//     the accumulators of P^T and dS^T are the A fragments of P^T dO and
//     dS^T Q.  dK and dV of the whole KV group sum in f32 registers and are
//     written once per KV head: no [B, L, H, D] temporary and no group-sum
//     pass (one bf16 rounding fewer than the TPU path, which writes per
//     query head and sums in the input dtype).  At D 128 the dK and dV
//     accumulators take 128 registers a thread; the 32-query tile keeps the
//     S^T / dP^T tiles at 32 more, below the 255 limit (ptxas' report is in
//     build/kernels/flash_bwd.log).  Key tile 0 (the most work) goes first.
//   Inputs are read through their strides (q, k, v can be slices of a fused
//   projection).  No wgmma/TMA yet.
//
// f32 inputs take CUDA-core kernels (no TF32), as K1's f32 mode: 64 rows a
//   block (query rows for K2, key rows for K3), 4 threads a row, each thread
//   owning every 4th of the row's D dims, dot products as 4-lane shuffle
//   sums; 32-row tiles of the other side in shared memory.  Same masking,
//   log2-space P and tile walk as the bf16 kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 4;
constexpr int BQ = 64;    // K2: query rows per block (16 per warp)
constexpr int BKV = 64;   // K2: keys per tile; K3: keys per block (16 per warp)
constexpr int BQ3 = 32;   // K3: queries per tile

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

struct Strides {  // element strides of a [B, L, heads, D] view (last dim contiguous)
  long long b, l, h;
};

// ---------------------------------------------------------------- K2, bf16
template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, Strides qs, Strides ks, Strides vs,
                        Strides dos, Strides dqs, int L, int H, int Hkv, float scale_log2,
                        float scale) {
  constexpr int P = D + 8;  // smem row pitch (bf16): conflict-free fragment loads
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
  const int n_tiles = qt + 1;  // causal: key tiles 0..qt (BQ == BKV)

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* ob = dout + b * dos.b + h * dos.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < BQ * CPR; c += NWARPS * 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = q0 + r < L;
    cp_async16(Qs + r * P + cc, ok ? qb + (q0 + r) * qs.l + cc : qb, ok);
    cp_async16(dOs + r * P + cc, ok ? ob + (q0 + r) * dos.l + cc : ob, ok);
  }
  auto load_kv = [&](int buf, int j) {
    const int k0 = j * BKV;
    for (int c = tid; c < BKV * CPR; c += NWARPS * 32) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      const bool ok = k0 + r < L;
      cp_async16(Ks + (buf * BKV + r) * P + cc, ok ? kb + (k0 + r) * ks.l + cc : kb, ok);
      cp_async16(Vs + (buf * BKV + r) * P + cc, ok ? vb + (k0 + r) * vs.l + cc : vb, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q, dO and the first K/V tile

  const int wr = warp * 16;  // this warp's first row inside the tile
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    lse_r[half] = row < L ? lse[static_cast<long long>(bh) * L + row] : 0.f;
    dl_r[half] = row < L ? delta[static_cast<long long>(bh) * L + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
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
    // diagonal and past L.
    const bool edge = (j == qt) || ((j + 1) * BKV > L);
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = s[ni][e] * scale_log2;
        if (edge) {
          const int key = j * BKV + ni * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          if (key > row || key >= L) sv = NEG_INF;
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

  __nv_bfloat16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    if (row >= L) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * dqs.l + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2 * half], acc[nd][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------- K3, bf16
template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                         Strides dos, Strides dks, Strides dvs, int L, int H, int Hkv,
                         float scale_log2, float scale) {
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
  const int first_qt = k0 / BQ3;   // the first query tile that sees key k0
  const int nq = (L + BQ3 - 1) / BQ3 - first_qt;
  const int n_iters = rep * nq;  // (query head of the group, query tile)

  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  constexpr int CPR = D / 8;
  for (int c = tid; c < BKV * CPR; c += NWARPS * 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = k0 + r < L;
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
      const bool ok = q0 + r < L;
      cp_async16(Qs + (buf * BQ3 + r) * P + cc, ok ? qb + (q0 + r) * qs.l + cc : qb, ok);
      cp_async16(dOs + (buf * BQ3 + r) * P + cc, ok ? ob + (q0 + r) * dos.l + cc : ob, ok);
    }
    if (tid < BQ3) {
      const int row = q0 + tid;
      const long long off = (static_cast<long long>(b) * H + h) * L + row;
      lse_s[buf * BQ3 + tid] = row < L ? lse[off] : 0.f;
      dl_s[buf * BQ3 + tid] = row < L ? delta[off] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();  // group 0: K, V and the first Q/dO tile

  const int wk = warp * 16;  // this warp's first key inside the tile
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

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
    const bool edge = q0 < k0 + BKV || q0 + BQ3 > L || k0 + BKV > L;
#pragma unroll
    for (int ni = 0; ni < BQ3 / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ni * 8 + 2 * t + (e & 1);
        float sv = s[ni][e] * scale_log2;
        if (edge) {
          const int key = k0 + wk + g + (e >> 1) * 8;
          const int qrow = q0 + col;
          if (key > qrow || qrow >= L || key >= L) sv = NEG_INF;
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

  __nv_bfloat16* dkb = dk + b * dks.b + hk * dks.h;
  __nv_bfloat16* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + wk + g + half * 8;
    if (key >= L) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * dks.l + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[nd][2 * half], dk_acc[nd][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * dvs.l + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[nd][2 * half], dv_acc[nd][2 * half + 1]);
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

template <int D>
__global__ void __launch_bounds__(F32_ROWS* F32_TPR)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, Strides qs, Strides ks, Strides vs,
                            Strides dos, Strides dqs, int L, int H, int Hkv, float scale_log2,
                            float scale) {
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
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float qv[DPT], ov[DPT], acc[DPT];
  const float* qr = q + b * qs.b + h * qs.h + static_cast<long long>(row) * qs.l;
  const float* orow = dout + b * dos.b + h * dos.h + static_cast<long long>(row) * dos.l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qv[i] = row < L ? qr[i * F32_TPR + t] : 0.f;
    ov[i] = row < L ? orow[i * F32_TPR + t] : 0.f;
    acc[i] = 0.f;
  }
  const float lse_r = row < L ? lse[static_cast<long long>(bh) * L + row] : 0.f;
  const float dl_r = row < L ? delta[static_cast<long long>(bh) * L + row] : 0.f;
  const int n_keys = min(q0 + F32_ROWS, L);  // causal: keys up to this tile's last row
  for (int k0 = 0; k0 < n_keys; k0 += F32_TILE) {
    __syncthreads();  // every thread is done with the previous tile
    for (int c = tid; c < F32_TILE * D; c += NT) {
      const int r = c / D, d = c % D;
      const bool ok = k0 + r < L;
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
      const float sv = key > row || key >= L ? NEG_INF : sp * scale_log2;
      const float p = sv > 0.5f * NEG_INF ? exp2f(sv - lse_r) : 0.f;
      const float ds = p * (dpp - dl_r) * scale;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(ds, Ks[j][i * F32_TPR + t], acc[i]);
    }
  }
  if (row >= L) return;
  float* dqr = dq + b * dqs.b + h * dqs.h + static_cast<long long>(row) * dqs.l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) dqr[i * F32_TPR + t] = acc[i];
}

template <int D>
__global__ void __launch_bounds__(F32_ROWS* F32_TPR)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, Strides qs,
                             Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                             int L, int H, int Hkv, float scale_log2, float scale) {
  constexpr int NT = F32_ROWS * F32_TPR;
  constexpr int DPT = D / F32_TPR;
  __shared__ float Qs[F32_TILE][D];
  __shared__ float Os[F32_TILE][D];
  __shared__ float lse_s[F32_TILE], dl_s[F32_TILE];

  const int tid = threadIdx.x, t = tid % F32_TPR;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * F32_ROWS;  // key tile 0 (the most work) first
  const int key = k0 + tid / F32_TPR;

  float kv[DPT], vv[DPT], dka[DPT], dva[DPT];
  const float* kr = k + b * ks.b + hk * ks.h + static_cast<long long>(key) * ks.l;
  const float* vr = v + b * vs.b + hk * vs.h + static_cast<long long>(key) * vs.l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kv[i] = key < L ? kr[i * F32_TPR + t] : 0.f;
    vv[i] = key < L ? vr[i * F32_TPR + t] : 0.f;
    dka[i] = dva[i] = 0.f;
  }
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* ob = dout + b * dos.b + h * dos.h;
    const long long row_off = (static_cast<long long>(b) * H + h) * L;
    for (int q0 = (k0 / F32_TILE) * F32_TILE; q0 < L; q0 += F32_TILE) {
      __syncthreads();  // every thread is done with the previous tile
      for (int c = tid; c < F32_TILE * D; c += NT) {
        const int rr = c / D, d = c % D;
        const bool ok = q0 + rr < L;
        Qs[rr][d] = ok ? qb[static_cast<long long>(q0 + rr) * qs.l + d] : 0.f;
        Os[rr][d] = ok ? ob[static_cast<long long>(q0 + rr) * dos.l + d] : 0.f;
      }
      if (tid < F32_TILE) {
        const bool ok = q0 + tid < L;
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
        const float sv = key > qrow || qrow >= L || key >= L ? NEG_INF : sp * scale_log2;
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
  if (key >= L) return;
  float* dkr = dk + b * dks.b + hk * dks.h + static_cast<long long>(key) * dks.l;
  float* dvr = dv + b * dvs.b + hk * dvs.h + static_cast<long long>(key) * dvs.l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dkr[i * F32_TPR + t] = dka[i];
    dvr[i * F32_TPR + t] = dva[i];
  }
}

// ---------------------------------------------------------------- launches
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o1, *o2;  // dq; or dk, dv
  Strides qs, ks, vs, dos, s1, s2;
  int B, L, H, Hkv;
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

template <int D>
int launch_dq(const Args& a, bool bf16, cudaStream_t stream) {
  if (!bf16) {
    dim3 grid((a.L + F32_ROWS - 1) / F32_ROWS, a.B * a.H);
    flash_bwd_dq_f32_kernel<D><<<grid, F32_ROWS * F32_TPR, 0, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.o1), a.qs, a.ks, a.vs, a.dos, a.s1, a.L, a.H, a.Hkv, a.scale_log2,
        a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int smem = (2 * BQ + 4 * BKV) * (D + 8) * 2;
  static bool configured = false;
  if (int err = set_smem(flash_bwd_dq_kernel<D>, smem, configured)) return err;
  dim3 grid((a.L + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
      a.delta, static_cast<__nv_bfloat16*>(a.o1), a.qs, a.ks, a.vs, a.dos, a.s1, a.L, a.H, a.Hkv,
      a.scale_log2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a, bool bf16, cudaStream_t stream) {
  if (!bf16) {
    dim3 grid((a.L + F32_ROWS - 1) / F32_ROWS, a.B * a.Hkv);
    flash_bwd_dkv_f32_kernel<D><<<grid, F32_ROWS * F32_TPR, 0, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.o1), static_cast<float*>(a.o2), a.qs, a.ks, a.vs, a.dos, a.s1,
        a.s2, a.L, a.H, a.Hkv, a.scale_log2, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int smem = (2 * BKV + 4 * BQ3) * (D + 8) * 2 + 4 * BQ3 * 4;
  static bool configured = false;
  if (int err = set_smem(flash_bwd_dkv_kernel<D>, smem, configured)) return err;
  dim3 grid((a.L + BKV - 1) / BKV, a.B * a.Hkv);
  flash_bwd_dkv_kernel<D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
      a.delta, static_cast<__nv_bfloat16*>(a.o1), static_cast<__nv_bfloat16*>(a.o2), a.qs, a.ks,
      a.vs, a.dos, a.s1, a.s2, a.L, a.H, a.Hkv, a.scale_log2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* o1, void* o2, const long long* st, int B, int L, int H,
               int Hkv, float scale_log2, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.o1 = o1;
  a.o2 = o2;
  Strides* all[6] = {&a.qs, &a.ks, &a.vs, &a.dos, &a.s1, &a.s2};
  for (int i = 0; i < (o2 ? 6 : 5); ++i)
    *all[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  if (!o2) a.s2 = Strides{0, 0, 0};
  a.B = B;
  a.L = L;
  a.H = H;
  a.Hkv = Hkv;
  a.scale_log2 = scale_log2;
  a.scale = scale;
  return a;
}

}  // namespace

// q, dout [B, L, H, D] and k, v [B, L, Hkv, D]: views of one dtype
// (is_bf16 ? bf16 : f32) whose last dim is contiguous, with element strides
// (batch, seq, head) given (st: q, k, v, dout, then the outputs); lse and
// delta: contiguous f32 [B, H, L].  flash_bwd_dq writes dq [B, L, H, D];
// flash_bwd_dkv writes dk, dv [B, L, Hkv, D] (summed over each KV group).
// Each returns the cudaError_t of its launch; cudaErrorInvalidValue for an
// unsupported head dim.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, const long long* st,
                            int B, int L, int H, int Hkv, int D, int is_bf16, float scale_log2,
                            float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, st, B, L, H, Hkv,
                           scale_log2, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dq<32>(a, is_bf16, s);
    case 64: return launch_dq<64>(a, is_bf16, s);
    case 128: return launch_dq<128>(a, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             const long long* st, int B, int L, int H, int Hkv, int D,
                             int is_bf16, float scale_log2, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, st, B, L, H, Hkv, scale_log2,
                           scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dkv<32>(a, is_bf16, s);
    case 64: return launch_dkv<64>(a, is_bf16, s);
    case 128: return launch_dkv<128>(a, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
