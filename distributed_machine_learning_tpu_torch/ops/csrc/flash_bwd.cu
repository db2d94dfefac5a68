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
// Design, bf16: the Hopper backward mainloops of flash_bwd_sm90.cuh (kind
//   FLASH), the ones the ring's K12/K13 run on, with the causal diagonal's
//   walk and mask over the whole sequence.  Two kernels, as the TPU splits
//   them, so each owns its accumulator: no atomics, and the result is
//   deterministic.  K2: 128 query rows of one (b, h) a block, a TMA
//   producer warpgroup streaming 64-key K/V tiles up to the diagonal to two
//   wgmma consumer warpgroups of 64 rows; dq starts from zero in registers
//   and is stored once in bf16.  K3: 64 keys of one (b, kv head) a block,
//   walking the 64-query tiles from the diagonal to L of every query head
//   of the group, alternate tiles to the two consumers; dK and dV of the
//   whole KV group sum in f32 registers and are stored once per KV head in
//   bf16: no [B, L, H, D] temporary and no group-sum pass (one bf16
//   rounding fewer than the TPU path, which writes per query head and sums
//   in the input dtype).  Both recompute P from the forward's lse in log2
//   space, p = exp2(s * scale * log2(e) - lse), masked probabilities 0,
//   and dS = P (dP - delta) * scale with delta = rowsum(dO o O) computed
//   outside (f32); P is rounded to bf16 before P^T dO and dS before dS K
//   and dS^T Q, where the TPU kernels cast them to the input dtype.  Inputs
//   are read through their strides by TMA (q, k, v can be slices of a
//   fused projection; 16-byte aligned, strides multiples of 8 elements);
//   outputs are written through theirs.  Any length works: rows and keys
//   at or past L are masked and never stored.
//
// f32 inputs take CUDA-core kernels (no TF32), as K1's f32 mode: 64 rows a
//   block (query rows for K2, key rows for K3), 4 threads a row, each thread
//   owning every 4th of the row's D dims, dot products as 4-lane shuffle
//   sums; 32-row tiles of the other side in shared memory.  Same masking,
//   log2-space P and causal walk as the bf16 kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of a [B, L, heads, D] view (last dim contiguous)
  long long b, l, h;
};

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
  const long long* st;  // the strides in order: q, k, v, dout (the maps), then the outputs
  int B, L, H, Hkv;
  float scale_log2, scale;
};

sm90::bwd::BwdParams bwd_params(const Args& a) {
  sm90::bwd::BwdParams p{};
  p.L = a.L;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.scale_log2 = a.scale_log2;
  p.scale = a.scale;
  p.lse = a.lse;
  p.delta = a.delta;
  return p;
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
  sm90::bwd::BwdParams p = bwd_params(a);
  p.dq_out = static_cast<__nv_bfloat16*>(a.o1);
  p.dq_sb = a.s1.b;
  p.dq_sl = a.s1.l;
  p.dq_sh = a.s1.h;
  return sm90::bwd::launch_dq<D, sm90::FLASH>(a.q, a.k, a.v, a.dout, a.st, a.B, p, stream);
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
  sm90::bwd::BwdParams p = bwd_params(a);
  p.dk_out = static_cast<__nv_bfloat16*>(a.o1);
  p.dk_sb = a.s1.b;
  p.dk_sl = a.s1.l;
  p.dk_sh = a.s1.h;
  p.dv_out = static_cast<__nv_bfloat16*>(a.o2);
  p.dv_sb = a.s2.b;
  p.dv_sl = a.s2.l;
  p.dv_sh = a.s2.h;
  return sm90::bwd::launch_dkv<D, sm90::FLASH>(a.q, a.k, a.v, a.dout, a.st, a.B, p, stream);
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
  a.st = st;
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
