// Single-token decode attention against a head-major KV cache.
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/decode_attention.py,
//   cached_flash_attention (_decode_kernel), in its bf16/f32-cache mode:
//   the decode-step attention of the serving path for caches of 4096 slots
//   and more.
//
// What bounds it on the H100: bytes.  Each call reads the K and V cache of
//   every (batch row, kv head) up to the current position, 2 * B * Hkv *
//   (pos + 1) * D * sizeof(T) bytes, and does about two multiply-adds per
//   byte: far below the card's operations-per-byte balance.  The time is
//   those bytes at the memory rate, so reads must stop at the frontier and
//   be wide.
//
// Design: one block of 8 warps per (batch row, kv head); the block serves
//   the kv head's whole group of query heads, so each K/V byte is read
//   once for all of them and repeated K/V never exist.  Slots are walked
//   only up to pos (the frontier clamp of the TPU kernel: O(pos) reads, not
//   O(allocated cache)); nothing past pos is loaded, so no mask is needed.
//   One slot's D values are read by a group of lanes with 16-byte vector
//   loads (D=128: 16 lanes for bf16, 32 for f32), the dot with each query
//   head is reduced across the group by warp shuffles, and each lane
//   carries an online-softmax state (m, l, acc) in f32, in base 2.  Each
//   warp keeps 8 slots per lane group in flight per step; their scores are
//   computed side by side and the running max moves once per step.  q is cast to the
//   cache dtype before the dot, as the TPU kernel does; p is rounded to the
//   cache dtype before it weights V, as the TPU kernel's P V dot does.  At
//   the end the per-group and per-warp states are merged (through shared
//   memory across warps) and out = acc / max(l, 1e-30) is written in the
//   cache dtype.  No split of the slots across blocks yet: at B = 8 and
//   Hkv = 4 only 32 blocks run, on a card of 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 8;
constexpr int UNROLL = 8;

template <typename T>
struct Vec;  // 16 raw bytes of T per lane, widened to float when used

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static uint4 load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void widen(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static __nv_bfloat16 cast(float x) { return __float2bfloat16_rn(x); }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static uint4 load(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void widen(const uint4& raw, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static float cast(float x) { return x; }
};

template <typename T, int D, int REP>
__global__ void __launch_bounds__(NWARPS * 32)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                  T* __restrict__ out, int H, int Hkv, int S, int pos, float scale_log2) {
  using V = Vec<T>;
  constexpr int VEC = V::N;
  constexpr int LPS = D / VEC;   // lanes per slot
  constexpr int SPW = 32 / LPS;  // slots per warp per load
  static_assert(D % VEC == 0 && LPS <= 32 && 32 % LPS == 0, "head dim");

  __shared__ float sm_m[NWARPS][REP];
  __shared__ float sm_l[NWARPS][REP];
  __shared__ float sm_acc[NWARPS][REP][D];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int li = lane % LPS, sub = lane / LPS;
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t cache_off = (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* kb = kc + cache_off + li * VEC;
  const T* vb = vc + cache_off + li * VEC;

  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    V::widen(V::load(q + (static_cast<size_t>(b) * H + hk * REP + r) * D + li * VEC), qv[r]);

  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  constexpr int STEP = NWARPS * SPW * UNROLL;
  // The loop bound is uniform across the warp (every lane must reach the
  // shuffles below); a lane group whose slot is past pos skips its update.
  for (int base = warp * SPW; base <= pos; base += STEP) {
    uint4 kraw[UNROLL], vraw[UNROLL];  // all loads of the step issued before any use
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int slot = base + sub + u * NWARPS * SPW;
      if (slot <= pos) {
        kraw[u] = V::load(kb + static_cast<size_t>(slot) * D);
        vraw[u] = V::load(vb + static_cast<size_t>(slot) * D);
      } else {
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // Scores of the step's UNROLL slots for every query head: independent
    // dots and shuffle reductions, so they overlap instead of forming one
    // dependent chain per slot.
    float sc[UNROLL][REP];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      V::widen(kraw[u], kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(qv[r][i], kf[i], part);
        sc[u][r] = part;
      }
    }
#pragma unroll
    for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int r = 0; r < REP; ++r) sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
    // One online-softmax update per step: the running max moves once over
    // the step's valid slots (validity is uniform across a lane group).
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        sc[u][r] = base + sub + u * NWARPS * SPW <= pos ? sc[u][r] * scale_log2 : NEG_INF;
        mx = fmaxf(mx, sc[u][r]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + sub + u * NWARPS * SPW > pos) continue;
      float vf[VEC];
      V::widen(vraw[u], vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = exp2f(sc[u][r] - m[r]);
        l[r] += p;
        const float pr = V::round(p);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(pr, vf[i], acc[r][i]);
      }
    }
  }

  // Merge the lane groups of this warp (lanes li of every group hold the
  // same D slice), then the warps through shared memory.
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float m_new = fmaxf(m[r], m_o);
      const float a_s = exp2f(m[r] - m_new), a_o = exp2f(m_o - m_new);
      l[r] = l[r] * a_s + l_o * a_o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * a_s + acc_o * a_o;
      }
      m[r] = m_new;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (li == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][r][li * VEC + i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < REP * D; idx += NWARPS * 32) {
    const int r = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float a = exp2f(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * a;
      asum += sm_acc[w][r][d] * a;
    }
    out[(static_cast<size_t>(b) * H + hk * REP + r) * D + d] = V::cast(asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
int launch_rep(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
               int S, int pos, float scale_log2, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  switch (H / Hkv) {
    case 1:
      decode_kernel<T, D, 1><<<grid, NWARPS * 32, 0, stream>>>(qp, kp, vp, op, H, Hkv, S, pos, scale_log2);
      break;
    case 2:
      decode_kernel<T, D, 2><<<grid, NWARPS * 32, 0, stream>>>(qp, kp, vp, op, H, Hkv, S, pos, scale_log2);
      break;
    case 4:
      decode_kernel<T, D, 4><<<grid, NWARPS * 32, 0, stream>>>(qp, kp, vp, op, H, Hkv, S, pos, scale_log2);
      break;
    case 8:
      decode_kernel<T, D, 8><<<grid, NWARPS * 32, 0, stream>>>(qp, kp, vp, op, H, Hkv, S, pos, scale_log2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, 1, H, D], caches [B, Hkv, S, D], out [B, 1, H, D], all contiguous
// and of one dtype (is_bf16 ? bf16 : f32); attends slots 0..pos.
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for an
// unsupported head dim or group size.
extern "C" int decode_attention(const void* q, const void* k, const void* v, void* out, int B,
                                int H, int Hkv, int S, int D, int pos, int is_bf16,
                                float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 32) return launch_rep<__nv_bfloat16, 32>(q, k, v, out, B, H, Hkv, S, pos, scale_log2, s);
    if (D == 64) return launch_rep<__nv_bfloat16, 64>(q, k, v, out, B, H, Hkv, S, pos, scale_log2, s);
    if (D == 128) return launch_rep<__nv_bfloat16, 128>(q, k, v, out, B, H, Hkv, S, pos, scale_log2, s);
  } else {
    if (D == 32) return launch_rep<float, 32>(q, k, v, out, B, H, Hkv, S, pos, scale_log2, s);
    if (D == 64) return launch_rep<float, 64>(q, k, v, out, B, H, Hkv, S, pos, scale_log2, s);
    if (D == 128) return launch_rep<float, 128>(q, k, v, out, B, H, Hkv, S, pos, scale_log2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
