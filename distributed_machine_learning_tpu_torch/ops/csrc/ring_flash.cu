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
//   once, after the ring's last step).  K12 and K13 (bf16) are the Hopper
//   backward mainloops of flash_bwd_sm90.cuh (the same kinds): K12 owns
//   128 query rows of one (b, h) and walks 64-key tiles of the visiting
//   chunk, reading its rows of the f32 dq before the first tile and
//   writing them back after the last; K13 owns 64 keys of one (b, kv head)
//   and walks the 64-query tiles of every query head of its group, its two
//   consumer warpgroups taking alternate tiles, and adds the group's sum,
//   in f32, into the NARROW traveling f32 dK/dV: no per-query-head buffers
//   and no group-sum pass (the TPU path sums the group in f32 too).  Each
//   block owns the rows it writes: no atomics, and the result is
//   deterministic.  The diagonal step (both chunks at one global offset)
//   walks tiles up to the diagonal with local indices and masks the
//   diagonal tiles; a full step (an earlier chunk) walks every tile with no
//   mask but the chunk's end.  Query (key, for K13) tiles are issued
//   heaviest first.  Scores run in base 2 (scale * log2(e), exp2); masked
//   scores' probabilities are 0; P is rounded to bf16 before P V (the row
//   sum uses the f32 P), dS before dS K and dS^T Q, P before P^T dO, where
//   the TPU kernels cast to the input dtype.  The KV head of query head h
//   is h / (H / Hkv), read in place.  Inputs are read through their
//   strides; the carry, lse, delta and the f32 accumulators are
//   contiguous.  Any chunk length works: rows and keys past Lc are masked.
//
// f32 inputs take CUDA-core kernels (no TF32), as K1-K3's f32 modes: 64
//   rows a block (query rows for K11/K12, key rows for K13), 4 threads a
//   row, each owning every 4th of the row's D dims, dot products as 4-lane
//   shuffle sums; 32-row tiles of the other side in shared memory.  Same
//   carry, masking and tile walk as the bf16 kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
struct Strides {  // element strides of a [B, Lc, heads, D] view (last dim contiguous)
  long long b, l, h;
};

// Offset of element (b, row, head, 0) of a contiguous f32 [B, Lc, heads, D].
__device__ __forceinline__ long long acc_off(int b, int row, int head, int Lc, int heads, int D) {
  return ((static_cast<long long>(b) * Lc + row) * heads + head) * D;
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
  long long st[12];  // the same strides in order, for the bf16 launchers
  int B, Lc, H, Hkv;
  float scale_log2, scale;
};

const float* f32(const void* p) { return static_cast<const float*>(p); }

sm90::bwd::BwdParams bwd_params(const Args& a) {
  sm90::bwd::BwdParams p{};
  p.L = a.Lc;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.scale_log2 = a.scale_log2;
  p.scale = a.scale;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dq = a.o1;
  p.dk = a.o1;
  p.dv = a.o2;
  return p;
}

template <int D, bool CAUSAL>
int launch_fwd(const Args& a, bool bf16, cudaStream_t stream) {
  if (!bf16) {
    dim3 grid((a.Lc + F32_ROWS - 1) / F32_ROWS, a.B * a.H);
    ring_fwd_f32_kernel<D, CAUSAL><<<grid, F32_ROWS * F32_TPR, 0, stream>>>(
        f32(a.q), f32(a.k), f32(a.v), a.o1, a.o2, a.o3, a.qs, a.ks, a.vs, a.Lc, a.H, a.Hkv,
        a.scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  sm90::FwdParams p{};
  p.L = a.Lc;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.scale_log2 = a.scale_log2;
  p.m = a.o1;
  p.l = a.o2;
  p.acc = a.o3;
  return sm90::launch_fwd<D, CAUSAL ? sm90::RING_DIAGONAL : sm90::RING_FULL>(a.q, a.k, a.v, a.st,
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
  return sm90::bwd::launch_dq<D, CAUSAL ? sm90::RING_DIAGONAL : sm90::RING_FULL>(
      a.q, a.k, a.v, a.dout, a.st, a.B, bwd_params(a), stream);
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
  return sm90::bwd::launch_dkv<D, CAUSAL ? sm90::RING_DIAGONAL : sm90::RING_FULL>(
      a.q, a.k, a.v, a.dout, a.st, a.B, bwd_params(a), stream);
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
  for (int i = 0; i < 12; ++i) a.st[i] = i < 9 || dout ? st[i] : 0;
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
