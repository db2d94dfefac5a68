// Single-token decode attention against a head-major KV cache (K4), in
// both of the TPU kernel's modes.
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/decode_attention.py,
//   cached_flash_attention (_decode_kernel):
//   - bf16/f32 caches (entry point decode_attention): the decode-step
//     attention of the serving path for caches of 4096 slots and more;
//   - int8 caches with one f32 scale per (kv head, slot) (entry point
//     decode_attention_int8; the TPU kernel's quant=True): the int8-KV
//     serving path's decode step while the cache is filled below the
//     tiered switch's break-even.
//
// What bounds it on the H100: bytes.  Each call reads the K and V cache of
//   every (batch row, kv head) up to the current position, 2 * B * Hkv *
//   (pos + 1) * D * sizeof(T) bytes for bf16/f32, 2 * B * Hkv * (pos + 1) *
//   (D + 4) for int8 (one byte a value and a 4-byte scale a slot: about
//   half the bf16 mode's), and does about two multiply-adds per value: far
//   below the card's operations-per-byte balance.  The time is those bytes
//   at the memory rate, so reads must stop at the frontier and be wide.
//
// Design (flash-decoding): the TPU kernel walks the slots in a sequential
//   grid; here the slots 0..pos of each (batch row, kv head) are cut into
//   `splits` contiguous chunks of `chunk` slots, one block of 8 warps each:
//   grid (split, kv head, batch row).  The wrapper sizes the split from
//   pos + 1 (ops/decode_attention.py, decode_split): about two blocks per SM,
//   each chunk at least 128 slots, so B = 8 x Hkv = 4 runs 256 blocks, not
//   32, and B = 1 up to 132, not 4.  A block serves the kv head's whole
//   group of query heads, so each K/V byte is read once for all of them and
//   repeated K/V never exist.  Slots are walked only up to pos (the
//   frontier clamp of the TPU kernel: O(pos) reads, not O(allocated
//   cache)); nothing past pos is loaded, so no mask is needed.
//   One slot's D values are read by a group of lanes with 16-byte vector
//   loads (D=128: 16 lanes for bf16, 32 for f32, 8 for int8), the dot with
//   each query head is reduced across the group by warp shuffles, and each
//   lane carries an online-softmax state (m, l, acc) in f32, in base 2.
//   Each warp keeps UNROLL slots per lane group in flight per step (8; 4
//   for int8, whose lanes hold twice the values; half that for a group of
//   8 query heads); their scores are computed side by side and the
//   running max moves once per step.
//   bf16/f32: q is cast to the cache dtype before the dot (by the wrapper),
//   as the TPU kernel does; p is rounded to the cache dtype before it
//   weights V, as the TPU kernel's P V dot does.  int8: every lane loads
//   its slot's f32 K and V scales and dequantizes each value in f32
//   (value * scale) before the dot, as the TPU kernel does, so the mode
//   adds no rounding beyond the int8 storage; q is widened to f32 and p
//   stays f32 (the TPU kernel's dequantized V is f32).  At the end the
//   per-group and per-warp states are merged (through shared memory across
//   warps).  With one split the block writes out = acc / max(l, 1e-30) in
//   the output dtype; with more, it writes its f32 (m, l, unnormalised acc)
//   to a workspace, a block whose chunk is empty writes m = -1e30, l = 0,
//   and a small combine kernel merges the splits in split order (so the
//   result does not depend on which block ran first) and writes out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 raw bytes of cache per lane (N values), widened to f32 when used.
template <typename T>
struct Cache;

template <>
struct Cache<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr int UNROLL = 8;
  static constexpr bool QUANT = false;
  __device__ __forceinline__ static void widen(const uint4& raw, float, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  // p in the cache dtype before it weights V.
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Cache<float> {
  static constexpr int N = 4;
  static constexpr int UNROLL = 8;
  static constexpr bool QUANT = false;
  __device__ __forceinline__ static void widen(const uint4& raw, float, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
  __device__ __forceinline__ static float round(float x) { return x; }
};

template <>
struct Cache<int8_t> {
  static constexpr int N = 16;
  static constexpr int UNROLL = 4;
  static constexpr bool QUANT = true;
  // Dequantize in f32: value * the slot's scale (both exact in f32).  The
  // value is made without the quarter-rate int-to-float conversion: byte
  // b, biased to u = b + 128, goes under the exponent of 2^23 (the f32
  // 2^23 + u, one byte permute), and one exact subtraction of 2^23 + 128
  // leaves b.
  __device__ __forceinline__ static void widen(const uint4& raw, float scale, float* out) {
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                           raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float biased = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440 + i % 4));
      out[i] = (biased - 8388736.f) * scale;
    }
  }
  __device__ __forceinline__ static float round(float x) { return x; }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// TC: cache element; TQ: query element (TC itself for bf16/f32 caches: the
// wrapper casts q; bf16 or f32 for int8 caches); TO: output element.
// ks/vs: the int8 mode's [B, Hkv, S] f32 scales (unused otherwise).
// part (more than one split): acc [splits, B*H, D], then m [splits, B*H],
// then l [splits, B*H], all f32; null: write out directly.
template <typename TC, typename TQ, typename TO, int D, int REP>
__global__ void __launch_bounds__(NWARPS * 32)
    decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  TO* __restrict__ out, float* __restrict__ part, int H, int Hkv, int S, int pos,
                  int chunk, float scale_log2) {
  using C = Cache<TC>;
  constexpr int VEC = C::N;
  // A group of 8 query heads holds 8 q and 8 acc slices a lane: half the
  // slots in flight keep the step's loads and scores in registers.
  constexpr int UNROLL = REP == 8 ? C::UNROLL / 2 : C::UNROLL;
  constexpr int LPS = D / VEC;   // lanes per slot
  constexpr int SPW = 32 / LPS;  // slots per warp per load
  static_assert(D % VEC == 0 && LPS <= 32 && 32 % LPS == 0, "head dim");

  __shared__ float sm_m[NWARPS][REP];
  __shared__ float sm_l[NWARPS][REP];
  __shared__ float sm_acc[NWARPS][REP][D];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int li = lane % LPS, sub = lane / LPS;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lo = split * chunk;
  const int hi = min(pos, lo + chunk - 1);  // the last slot this block reads
  const size_t row_off = (static_cast<size_t>(b) * Hkv + hk) * S;
  const TC* kb = kc + row_off * D + li * VEC;
  const TC* vb = vc + row_off * D + li * VEC;
  const float* ksb = C::QUANT ? ks + row_off : nullptr;
  const float* vsb = C::QUANT ? vs + row_off : nullptr;

  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const TQ* qr = q + (static_cast<size_t>(b) * H + hk * REP + r) * D + li * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) qv[r][i] = to_float(qr[i]);
  }

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
  // shuffles below); a lane group whose slot is past hi skips its update.
  for (int base = lo + warp * SPW; base <= hi; base += STEP) {
    uint4 kraw[UNROLL], vraw[UNROLL];  // all loads of the step issued before any use
    float ksc[UNROLL], vsc[UNROLL];    // the slots' scales (int8 mode; else unused)
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int slot = base + sub + u * NWARPS * SPW;
      if (slot <= hi) {
        kraw[u] = load16(kb + static_cast<size_t>(slot) * D);
        vraw[u] = load16(vb + static_cast<size_t>(slot) * D);
        ksc[u] = C::QUANT ? __ldg(ksb + slot) : 1.f;
        vsc[u] = C::QUANT ? __ldg(vsb + slot) : 1.f;
      } else {
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
        ksc[u] = vsc[u] = 0.f;
      }
    }
    // Scores of the step's UNROLL slots for every query head: independent
    // dots and shuffle reductions, so they overlap instead of forming one
    // dependent chain per slot.
    float sc[UNROLL][REP];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      C::widen(kraw[u], ksc[u], kf);
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
        sc[u][r] = base + sub + u * NWARPS * SPW <= hi ? sc[u][r] * scale_log2 : NEG_INF;
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
      if (base + sub + u * NWARPS * SPW > hi) continue;
      float vf[VEC];
      C::widen(vraw[u], vsc[u], vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = exp2f(sc[u][r] - m[r]);
        l[r] += p;
        const float pr = C::round(p);
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
  const size_t rows = static_cast<size_t>(gridDim.z) * H;
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
    const size_t row = static_cast<size_t>(b) * H + hk * REP + r;
    if (part == nullptr) {
      out[row * D + d] = from_float<TO>(asum / fmaxf(lsum, 1e-30f));
    } else {
      const size_t prow = split * rows + row;
      part[prow * D + d] = asum;
      if (d == 0) {
        float* part_m = part + gridDim.x * rows * D;
        part_m[prow] = mx;
        part_m[gridDim.x * rows + prow] = lsum;
      }
    }
  }
}

// One block per output row (batch row, query head): merge the splits'
// partials in split order and write acc / max(l, 1e-30).
template <typename TO>
__global__ void combine_kernel(const float* __restrict__ part, TO* __restrict__ out, int rows,
                               int splits) {
  const int row = blockIdx.x, D = blockDim.x, d = threadIdx.x;
  const float* part_m = part + static_cast<size_t>(splits) * rows * D;
  const float* part_l = part_m + static_cast<size_t>(splits) * rows;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[s * rows + row]);
  float lsum = 0.f, asum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float a = exp2f(part_m[s * rows + row] - mx);
    lsum += part_l[s * rows + row] * a;
    asum += part[(static_cast<size_t>(s) * rows + row) * D + d] * a;
  }
  out[static_cast<size_t>(row) * D + d] = from_float<TO>(asum / fmaxf(lsum, 1e-30f));
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  void* out;
  float* part;
  int B, H, Hkv, S, D, pos, chunk, splits;
  float scale_log2;
  cudaStream_t stream;
};

template <typename TC, typename TQ, typename TO, int D, int REP>
void launch(const Args& a) {
  decode_kernel<TC, TQ, TO, D, REP><<<dim3(a.splits, a.Hkv, a.B), NWARPS * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
      a.ks, a.vs, static_cast<TO*>(a.out), a.splits > 1 ? a.part : nullptr, a.H, a.Hkv, a.S,
      a.pos, a.chunk, a.scale_log2);
}

template <typename TC, typename TQ, typename TO, int D>
int launch_rep(const Args& a) {
  switch (a.H / a.Hkv) {
    case 1: launch<TC, TQ, TO, D, 1>(a); break;
    case 2: launch<TC, TQ, TO, D, 2>(a); break;
    case 4: launch<TC, TQ, TO, D, 4>(a); break;
    case 8: launch<TC, TQ, TO, D, 8>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  combine_kernel<TO><<<a.B * a.H, D, 0, a.stream>>>(a.part, static_cast<TO*>(a.out), a.B * a.H,
                                                     a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, typename TQ, typename TO>
int launch_d(const Args& a) {
  if (a.splits < 1 || a.chunk < 1 ||
      static_cast<long long>(a.chunk) * a.splits < static_cast<long long>(a.pos) + 1 ||
      (a.splits > 1 && a.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.D == 32) return launch_rep<TC, TQ, TO, 32>(a);
  if (a.D == 64) return launch_rep<TC, TQ, TO, 64>(a);
  if (a.D == 128) return launch_rep<TC, TQ, TO, 128>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16/f32 mode.  q [B, 1, H, D] in the cache dtype, caches [B, Hkv, S, D],
// out [B, 1, H, D], all contiguous; the caches bf16 if is_bf16 else f32;
// out f32 if out_f32 (or the cache is f32), else bf16.  Attends slots
// 0..pos, cut into `splits` chunks of `chunk` slots (chunk * splits > pos);
// with splits > 1, `workspace` is f32 scratch of splits * B * H * (D + 2)
// values.  Returns the cudaError_t of the launches; cudaErrorInvalidValue
// for an unsupported head dim or group size, or a split that does not
// cover the slots.
extern "C" int decode_attention(const void* q, const void* k, const void* v, void* out,
                                void* workspace, int B, int H, int Hkv, int S, int D, int pos,
                                int chunk, int splits, int is_bf16, int out_f32,
                                float scale_log2, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, out, static_cast<float*>(workspace), B, H, Hkv, S, D,
               pos, chunk, splits, scale_log2, static_cast<cudaStream_t>(stream)};
  if (!is_bf16) return launch_d<float, float, float>(a);
  if (out_f32) return launch_d<__nv_bfloat16, __nv_bfloat16, float>(a);
  return launch_d<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(a);
}

// int8 mode.  q [B, 1, H, D] bf16 if q_bf16 else f32, int8 caches
// [B, Hkv, S, D], f32 scales k_scale/v_scale [B, Hkv, S], out [B, 1, H, D]
// in q's dtype, all contiguous.  Attends slots 0..pos, split as the
// bf16/f32 mode's.
extern "C" int decode_attention_int8(const void* q, const void* k, const void* v,
                                     const float* k_scale, const float* v_scale, void* out,
                                     void* workspace, int B, int H, int Hkv, int S, int D,
                                     int pos, int chunk, int splits, int q_bf16,
                                     float scale_log2, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, out, static_cast<float*>(workspace), B, H, Hkv, S, D,
               pos, chunk, splits, scale_log2, static_cast<cudaStream_t>(stream)};
  if (q_bf16) return launch_d<int8_t, __nv_bfloat16, __nv_bfloat16>(a);
  return launch_d<int8_t, float, float>(a);
}
