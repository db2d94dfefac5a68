// Causal flash-attention forward, bf16 or f32 in and out, GQA-native.
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/flash_attention.py,
//   _flash_fwd (_flash_fwd_kernel) behind flash_self_attention: the
//   prefill attention of the serving path.
//
// What bounds it on the H100: operations.  Causal attention over L tokens
//   does about 2 * 2 * L^2/2 * D multiply-adds per (batch, head), which at
//   L = 4096 is far above the bytes of q, k, v and out (O(L * D)): the
//   bound is the bf16 tensor-core rate.  The L x L score matrix must never
//   reach device memory.
//
// Design: one block of 4 warps owns a 64-row query tile of one
//   (batch, head); each warp owns 16 of those rows.  A loop over 64-key
//   tiles up to the causal diagonal takes the place of the TPU kernel's
//   sequential third grid axis; tiles wholly above the diagonal are never
//   loaded.  K/V tiles are double-buffered in shared memory by cp.async so
//   the next tile streams in while the current one is used.  Q stays in
//   registers as mma fragments.  S = Q K^T and O += P V run on mma.sync
//   m16n8k16 bf16 with f32 accumulators; the softmax state (m, l, acc)
//   stays in f32 registers and runs in base 2 (scores pre-scaled by
//   scale * log2(e), exp2).  Masked scores are -1e30, and the probability
//   of a masked entry is forced to 0 (a fully masked row would otherwise
//   get p = 1).  P is rounded to bf16 before P V, as the TPU kernel casts
//   P to V's dtype; the row sum l uses the unrounded f32 P.  The K/V head
//   of query head h is h / (H / Hkv), read in place: repeated K/V are
//   never materialised.  Inputs are read through their strides, so q, k, v
//   can be slices of a fused projection.  Query tiles are issued longest
//   first (the diagonal makes late tiles the heaviest).  Each row's
//   logsumexp is written in log2 space, m + log2(max(l, 1e-30)) as f32
//   [B, H, L] (the TPU kernel's lse output, the one O(L) residual the
//   backward kernels need; serving drops it).  No wgmma/TMA yet.
//
// f32 inputs (a float32 compute dtype) take a second, plain kernel on the
//   CUDA cores, so the scores stay true f32 products as in the TPU
//   kernel's f32 mode (the tensor cores' TF32 would round the inputs):
//   64 query rows per block, 4 threads per row, each thread owning every
//   4th of the row's D dims (conflict-free shared-memory reads); 32-key
//   K/V tiles in shared memory; per tile, the 32 scores (a 4-lane shuffle
//   sum each), one max/rescale, then P V.  Same causal tile loop, masking
//   and base-2 softmax as the bf16 kernel; P needs no rounding.  Same lse
//   output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // query rows per block (16 per warp)
constexpr int BKV = 64;  // keys per tile
constexpr int NWARPS = 4;

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

struct Strides {  // element strides of a [B, L, heads, D] view (last dim contiguous)
  long long b, l, h;
};

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
                     int L, int H, int Hkv, float scale_log2) {
  constexpr int P = D + 8;  // smem row pitch (bf16): conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][P]
  __nv_bfloat16* Ks = Qs + BQ * P;                                  // [2][BKV][P]
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
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < BQ * CPR; c += NWARPS * 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = q0 + r < L;
    cp_async16(Qs + r * P + cc, ok ? qb + (q0 + r) * qs.l + cc : qb, ok);
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
  cp_async_commit();  // group 0: Q and the first K/V tile

  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  uint32_t qf[D / 16][4];
  const int wr = warp * 16;  // this warp's first row inside the tile

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
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* r0 = Qs + (wr + g) * P + kk * 16 + 2 * t;
        const __nv_bfloat16* r8 = r0 + 8 * P;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(r8);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
    }
    const __nv_bfloat16* Kt = Ks + buf * BKV * P;
    const __nv_bfloat16* Vt = Vs + buf * BKV * P;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = Kt + (ni * 8 + g) * P + kk * 16 + 2 * t;
        mma_bf16_16816(s[ni], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // Scale into log2 space; mask above the diagonal and past L.
    const bool edge = (j == qt) || ((j + 1) * BKV > L);
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[ni][e] * scale_log2;
        if (edge) {
          const int key = j * BKV + ni * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          if (key > row || key >= L) val = NEG_INF;
        }
        s[ni][e] = val;
      }
    // Online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = NEG_INF;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
        mx = fmaxf(mx, fmaxf(s[ni][2 * half], s[ni][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float alpha = exp2f(m_run[half] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float sv = s[ni][e];
          const float p = sv > 0.5f * NEG_INF ? exp2f(sv - m_new) : 0.f;
          s[ni][e] = p;
          rowsum += p;
        }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
      l_run[half] = l_run[half] * alpha + rowsum;
      m_run[half] = m_new;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd][2 * half] *= alpha;
        o[nd][2 * half + 1] *= alpha;
      }
    }
    // O += bf16(P) V.  The S accumulator layout is the A-fragment layout.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, Vt + vrow * P + nd * 16 + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * nd], a, bfrag[0], bfrag[1]);
        mma_bf16_16816(o[2 * nd + 1], a, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // out = acc / max(l, 1e-30), bf16.
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    if (row >= L) continue;
    const float l_safe = fmaxf(l_run[half], 1e-30f);
    const float inv = 1.f / l_safe;
    if (t == 0) lse[static_cast<long long>(bh) * L + row] = m_run[half] + log2f(l_safe);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row * os.l + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(o[nd][2 * half] * inv, o[nd][2 * half + 1] * inv);
    }
  }
}

// f32 variant (see the note at the top).
constexpr int F32_BQ = 64, F32_BKV = 32, F32_TPR = 4;  // rows, keys, threads per row

template <int D>
__global__ void __launch_bounds__(F32_BQ* F32_TPR)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
                         int L, int H, int Hkv, float scale_log2) {
  constexpr int NT = F32_BQ * F32_TPR;
  constexpr int DPT = D / F32_TPR;  // dims per thread: d = i * F32_TPR + t
  __shared__ float Ks[F32_BKV][D];
  __shared__ float Vs[F32_BKV][D];

  const int tid = threadIdx.x, t = tid % F32_TPR;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F32_BQ;  // heaviest tiles first
  const int row = q0 + tid / F32_TPR;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float qv[DPT], acc[DPT];
  const float* qr = q + b * qs.b + h * qs.h + static_cast<long long>(row) * qs.l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qv[i] = row < L ? qr[i * F32_TPR + t] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const int n_keys = min(q0 + F32_BQ, L);  // causal: keys up to this tile's last row
  for (int k0 = 0; k0 < n_keys; k0 += F32_BKV) {
    __syncthreads();  // every thread is done with the previous tile
    for (int c = tid; c < F32_BKV * D; c += NT) {
      const int r = c / D, d = c % D;
      const bool ok = k0 + r < L;
      Ks[r][d] = ok ? kb[static_cast<long long>(k0 + r) * ks.l + d] : 0.f;
      Vs[r][d] = ok ? vb[static_cast<long long>(k0 + r) * vs.l + d] : 0.f;
    }
    __syncthreads();
    float s[F32_BKV];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qv[i], Ks[j][i * F32_TPR + t], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      s[j] = key > row || key >= L ? NEG_INF : part * scale_log2;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) {
      const float p = s[j] > 0.5f * NEG_INF ? exp2f(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, Vs[j][i * F32_TPR + t], acc[i]);
    }
    m = m_new;
  }
  if (row >= L) return;
  const float l_safe = fmaxf(l, 1e-30f);
  const float inv = 1.f / l_safe;
  if (t == 0) lse[static_cast<long long>(bh) * L + row] = m + log2f(l_safe);
  float* orow = out + b * os.b + h * os.h + static_cast<long long>(row) * os.l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) orow[i * F32_TPR + t] = acc[i] * inv;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, Strides qs,
               Strides ks, Strides vs, Strides os, int B, int L, int H, int Hkv,
               float scale_log2, cudaStream_t stream) {
  dim3 grid((L + F32_BQ - 1) / F32_BQ, B * H);
  flash_fwd_f32_kernel<D><<<grid, F32_BQ * F32_TPR, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, qs, ks, vs, os, L, H, Hkv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int L, int H, int Hkv, float scale_log2,
           cudaStream_t stream) {
  constexpr int smem = (BQ + 4 * BKV) * (D + 8) * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, qs, ks, vs, os,
      L, H, Hkv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, L, H, D], k/v [B, L, Hkv, D], out [B, L, H, D]: views of one
// dtype (is_bf16 ? bf16 : f32) whose last dim is contiguous, with element
// strides (batch, seq, head) given; lse: a contiguous f32 [B, H, L].
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for an
// unsupported head dim.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         long long q_sb, long long q_sl, long long q_sh, long long k_sb,
                         long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                         long long v_sh, long long o_sb, long long o_sl, long long o_sh, int B,
                         int L, int H, int Hkv, int D, int is_bf16, float scale_log2,
                         void* stream) {
  const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh}, vs{v_sb, v_sl, v_sh},
      os{o_sb, o_sl, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
#define FLASH_CASE(DIM)                                                                      \
  case DIM:                                                                                  \
    return is_bf16 ? launch<DIM>(q, k, v, out, lse_f, qs, ks, vs, os, B, L, H, Hkv, scale_log2, s) \
                   : launch_f32<DIM>(q, k, v, out, lse_f, qs, ks, vs, os, B, L, H, Hkv, scale_log2,  \
                                     s);
  switch (D) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}
