// Causal flash-attention forward, bf16 or f32 in and out, GQA-native: K1.
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/flash_attention.py,
//   _flash_fwd (_flash_fwd_kernel) behind flash_self_attention: the
//   prefill attention of the serving path and the trainer's forward.
//
// What bounds it on the H100: operations.  Causal attention over L tokens
//   does about 2 * 2 * L^2/2 * D multiply-adds per (batch, head), which at
//   L = 4096 is far above the bytes of q, k, v and out (O(L * D)): the
//   bound is the bf16 tensor-core rate.  The L x L score matrix must never
//   reach device memory.
//
// Design, bf16: the Hopper forward mainloop of flash_fwd_sm90.cuh (kind
//   FLASH): 128-row query tiles of one (batch, head), a TMA-fed producer
//   warpgroup and two ping-ponging consumer warpgroups on wgmma; key tiles
//   up to the causal diagonal only (tiles wholly above it are never
//   loaded), the diagonal tile masked.  Each row's logsumexp is written in
//   log2 space, m + log2(max(l, 1e-30)) as f32 [B, H, L] (the TPU kernel's
//   lse output, the one O(L) residual the backward kernels need; serving
//   drops it), and out = acc / max(l, 1e-30) in bf16.
//
// f32 inputs (a float32 compute dtype) take a second, plain kernel on the
//   CUDA cores, so the scores stay true f32 products as in the TPU
//   kernel's f32 mode (the tensor cores' TF32 would round the inputs):
//   64 query rows per block, 4 threads per row, each thread owning every
//   4th of the row's D dims (conflict-free shared-memory reads); 32-key
//   K/V tiles in shared memory; per tile, the 32 scores (a 4-lane shuffle
//   sum each), one max/rescale, then P V.  Same causal tile walk, masking
//   and base-2 softmax as the bf16 kernel (masked scores -1e30, their p
//   forced to 0); P needs no rounding.  Same lse output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of a [B, L, heads, D] view (last dim contiguous)
  long long b, l, h;
};

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
  const long long st[9] = {qs.b, qs.l, qs.h, ks.b, ks.l, ks.h, vs.b, vs.l, vs.h};
  sm90::FwdParams p{};
  p.L = L;
  p.H = H;
  p.Hkv = Hkv;
  p.scale_log2 = scale_log2;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_sb = os.b;
  p.o_sl = os.l;
  p.o_sh = os.h;
  p.lse = lse;
  return sm90::launch_fwd<D, sm90::FLASH>(q, k, v, st, B, p, stream);
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
