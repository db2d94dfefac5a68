// Single-token decode attention for W lanes at ragged frontiers, through
// per-lane block tables over a shared paged KV pool.
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/decode_attention.py,
//   paged_flash_attention (_paged_kernel): the decode-step attention of the
//   continuous-batching engine.
//
// What bounds it on the H100: bytes.  A call reads the K and V rows of every
//   (lane, kv head) up to that lane's position, sum_w (pos_w + 1) * Hkv * D *
//   2 * sizeof(T) bytes, at about two multiply-adds per byte: far below the
//   card's operations-per-byte balance.  The time is those bytes at the
//   memory rate, so each lane must read its own O(pos) slots only, with wide
//   loads, on enough blocks to keep the memory busy.
//
// Design: the TPU kernel walks a sequential grid over pages with the tables
//   and positions in scalar prefetch; here each block loads its own lane's
//   position and walks the physical pages itself through the lane's table
//   row (logical slot s lives in pool row table[w][s / bs], slot s % bs).
//   Grid (kv head, lane, split): a lane's slots are cut into chunks of
//   `chunk` slots, one block each, so a batch of 8 lanes x 4 kv heads fills
//   the card instead of running 32 blocks; a block whose chunk starts past
//   its lane's frontier writes an empty partial and exits.  Inside a block,
//   K4's scheme (decode_attention.cu): 8 warps, one slot's D values read by
//   a group of lanes with 16-byte loads (D=128: 16 lanes for bf16, 32 for
//   f32; a slot's row is contiguous in the pool, neighbouring lanes on
//   neighbouring addresses), scores reduced by warp shuffles, an f32
//   online-softmax state (m, l, acc) in base 2 per lane group, 8 slots per
//   lane group in flight per step; the block serves the kv head's whole
//   group of query heads, so each K/V byte is read once for all of them.
//   q is cast to the pool dtype before the dot and p rounded to it before it
//   weights V, as the TPU kernel does.  With more than one split, each block
//   writes its f32 (m, l, unnormalised acc) and a small combine kernel
//   merges the splits and writes out = acc / max(l, 1e-30) in the pool
//   dtype; with one split the block writes out itself.  Idle lanes point
//   every table entry at the scratch block with position 0, so they read
//   one slot.  Entries past a lane's frontier are never read; a position is
//   clamped into its table and a table entry into the pool, so no read
//   leaves either whatever the inputs hold.

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

// part (splits > 1): acc [splits, W*H, D], then m [splits, W*H], then
// l [splits, W*H], all f32.  part == nullptr: write out directly.
template <typename T, int D, int REP>
__global__ void __launch_bounds__(NWARPS * 32)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ kpool, const T* __restrict__ vpool,
                 const int* __restrict__ tables, const int* __restrict__ positions,
                 T* __restrict__ out, float* __restrict__ part, int W, int H, int Hkv, int bs,
                 int MB, int nblocks, int chunk, float scale_log2) {
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
  const int hk = blockIdx.x, w = blockIdx.y, split = blockIdx.z;
  const int pos = min(max(positions[w], 0), MB * bs - 1);
  const int lo = split * chunk;
  const int hi = min(pos, lo + chunk - 1);  // the last slot this block reads
  const int* table = tables + static_cast<size_t>(w) * MB;
  const size_t page_elems = static_cast<size_t>(Hkv) * bs * D;
  const size_t head_off = static_cast<size_t>(hk) * bs * D + li * VEC;

  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    V::widen(V::load(q + (static_cast<size_t>(w) * H + hk * REP + r) * D + li * VEC), qv[r]);

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
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int slot = base + sub + u * NWARPS * SPW;
      if (slot <= hi) {
        const int page = slot / bs;
        const int phys = min(max(__ldg(table + page), 0), nblocks - 1);
        const size_t off = static_cast<size_t>(phys) * page_elems + head_off +
                           static_cast<size_t>(slot - page * bs) * D;
        kraw[u] = V::load(kpool + off);
        vraw[u] = V::load(vpool + off);
      } else {
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float sc[UNROLL][REP];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      V::widen(kraw[u], kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float p = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) p = fmaf(qv[r][i], kf[i], p);
        sc[u][r] = p;
      }
    }
#pragma unroll
    for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int r = 0; r < REP; ++r) sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
    // One online-softmax update per step (validity is uniform across a
    // lane group).
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

  // Merge the lane groups of this warp, then the warps through shared memory.
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
  const size_t rows = static_cast<size_t>(W) * H;
  for (int idx = threadIdx.x; idx < REP * D; idx += NWARPS * 32) {
    const int r = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int wi = 0; wi < NWARPS; ++wi) mx = fmaxf(mx, sm_m[wi][r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int wi = 0; wi < NWARPS; ++wi) {
      const float a = exp2f(sm_m[wi][r] - mx);
      lsum += sm_l[wi][r] * a;
      asum += sm_acc[wi][r][d] * a;
    }
    const size_t row = static_cast<size_t>(w) * H + hk * REP + r;
    if (part == nullptr) {
      out[row * D + d] = V::cast(asum / fmaxf(lsum, 1e-30f));
    } else {
      const size_t prow = split * rows + row;
      part[prow * D + d] = asum;
      if (d == 0) {
        float* part_m = part + gridDim.z * rows * D;
        part_m[prow] = mx;
        part_m[gridDim.z * rows + prow] = lsum;
      }
    }
  }
}

// One block per output row (lane, query head): merge the splits' partials.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part, T* __restrict__ out, int rows,
                               int D, int splits) {
  const int row = blockIdx.x;
  const float* part_m = part + static_cast<size_t>(splits) * rows * D;
  const float* part_l = part_m + static_cast<size_t>(splits) * rows;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[s * rows + row]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float lsum = 0.f, asum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float a = exp2f(part_m[s * rows + row] - mx);
      lsum += part_l[s * rows + row] * a;
      asum += part[(static_cast<size_t>(s) * rows + row) * D + d] * a;
    }
    out[static_cast<size_t>(row) * D + d] = Vec<T>::cast(asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
int launch_rep(const void* q, const void* k, const void* v, const int* tables,
               const int* positions, void* out, float* part, int W, int H, int Hkv, int bs,
               int MB, int nblocks, int chunk, int splits, float scale_log2,
               cudaStream_t stream) {
  dim3 grid(Hkv, W, splits);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  float* pp = splits > 1 ? part : nullptr;
  switch (H / Hkv) {
    case 1:
      paged_kernel<T, D, 1><<<grid, NWARPS * 32, 0, stream>>>(
          qp, kp, vp, tables, positions, op, pp, W, H, Hkv, bs, MB, nblocks, chunk, scale_log2);
      break;
    case 2:
      paged_kernel<T, D, 2><<<grid, NWARPS * 32, 0, stream>>>(
          qp, kp, vp, tables, positions, op, pp, W, H, Hkv, bs, MB, nblocks, chunk, scale_log2);
      break;
    case 4:
      paged_kernel<T, D, 4><<<grid, NWARPS * 32, 0, stream>>>(
          qp, kp, vp, tables, positions, op, pp, W, H, Hkv, bs, MB, nblocks, chunk, scale_log2);
      break;
    case 8:
      paged_kernel<T, D, 8><<<grid, NWARPS * 32, 0, stream>>>(
          qp, kp, vp, tables, positions, op, pp, W, H, Hkv, bs, MB, nblocks, chunk, scale_log2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  combine_kernel<T><<<W * H, D, 0, stream>>>(part, op, W * H, D, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [W, 1, H, D], pools [nblocks, Hkv, bs, D], tables [W, MB] int32,
// positions [W] int32, out [W, 1, H, D]; q, pools and out contiguous and of
// one dtype (is_bf16 ? bf16 : f32).  Lane w attends slots 0..positions[w]
// through its table.  Each lane's slots are cut into chunks of `chunk`
// slots over `splits` blocks; with splits > 1, `part` is f32 scratch of
// splits * W * H * (D + 2) values.  Returns the cudaError_t of the launches;
// cudaErrorInvalidValue for an unsupported shape.
extern "C" int paged_attention(const void* q, const void* k, const void* v, const void* tables,
                               const void* positions, void* out, void* part, int W, int H,
                               int Hkv, int D, int bs, int MB, int chunk, int splits, int is_bf16,
                               int nblocks, float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W < 1 || bs < 1 || MB < 1 || nblocks < 1 || chunk < 1 || splits < 1 ||
      static_cast<long long>(chunk) * splits < static_cast<long long>(MB) * bs ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(tables);
  const int* pp = static_cast<const int*>(positions);
  float* wp = static_cast<float*>(part);
  if (is_bf16) {
    if (D == 32)
      return launch_rep<__nv_bfloat16, 32>(q, k, v, tp, pp, out, wp, W, H, Hkv, bs, MB, nblocks,
                                           chunk, splits, scale_log2, s);
    if (D == 64)
      return launch_rep<__nv_bfloat16, 64>(q, k, v, tp, pp, out, wp, W, H, Hkv, bs, MB, nblocks,
                                           chunk, splits, scale_log2, s);
    if (D == 128)
      return launch_rep<__nv_bfloat16, 128>(q, k, v, tp, pp, out, wp, W, H, Hkv, bs, MB, nblocks,
                                            chunk, splits, scale_log2, s);
  } else {
    if (D == 32)
      return launch_rep<float, 32>(q, k, v, tp, pp, out, wp, W, H, Hkv, bs, MB, nblocks, chunk,
                                   splits, scale_log2, s);
    if (D == 64)
      return launch_rep<float, 64>(q, k, v, tp, pp, out, wp, W, H, Hkv, bs, MB, nblocks, chunk,
                                   splits, scale_log2, s);
    if (D == 128)
      return launch_rep<float, 128>(q, k, v, tp, pp, out, wp, W, H, Hkv, bs, MB, nblocks, chunk,
                                    splits, scale_log2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
