// W8A16 GEMM: out[R, K] = (bf16(x) @ bf16(q)) * scale, f32 accumulation.
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/quant_matmul.py,
//   int8_matmul (_kernel), the weight-only int8 projection of int8 serving.
//
// What bounds it on the H100: two regimes of one function.  Decode has
//   R = batch (8): the product is a matrix-vector sweep whose cost is the
//   int8 weight bytes, D*K, at the card's memory rate; the int8 storage is
//   the point (half the bytes of bf16).  Prefill has R = batch * prompt
//   (32k): 2*R*D*K operations at the bf16 tensor-core rate.
//
// Design: one templated tiled kernel, two tile shapes picked by R.  Tiles
//   of x (bf16) and of q (int8, still int8 in shared memory: the smem and
//   global traffic stay at one byte per weight) are staged by cp.async in
//   a multi-stage ring.  Each warp widens its int8 B fragments to bf16 in
//   registers (exact: every int8 is a bf16) and runs mma.sync
//   m16n8k16 bf16 with f32 accumulators.  The per-column f32 scale is
//   applied once in the epilogue, as in the TPU kernel.  Ragged R and K
//   are masked in the kernel (cp.async zero-fill on loads, guarded
//   stores), so no operand is padded in device memory.  A K that is not a
//   multiple of 16 (a byte-level vocabulary of 257 in the LM head) leaves
//   q's rows unaligned for 16-byte copies: that variant stages q byte by
//   byte and stores column by column.  Decode (R <= 16)
//   takes a skinny 16 x 64 tile and, where the columns alone give too few
//   blocks to keep enough weight bytes in flight, also splits the
//   contraction D across blocks: each writes an f32 partial and a second,
//   small kernel sums the partials, scales and casts.  Prefill takes a
//   wide 128 x 128 tile for operand reuse.  No wgmma/TMA yet.
//
// Requires: D % 8 == 0 (16-byte x rows), 16-byte aligned base pointers,
//   row-major contiguous operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int nbytes = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(nbytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two int8 weights -> one bf16x2 register (lo in the low half): exact.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool VEC_Q>
__global__ void __launch_bounds__(WM* WN * 32)
    w8a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, void* __restrict__ out,
                 float* __restrict__ partial, int R, int D, int K, int out_bf16,
                 int ktiles_per_split) {
  constexpr int NTHREADS = WM * WN * 32;
  constexpr int WTM = BM / WM;  // warp tile rows
  constexpr int WTN = BN / WN;  // warp tile cols
  constexpr int MT = WTM / 16;
  constexpr int NT = WTN / 8;
  constexpr int AS = BK + 8;   // bf16 row pitch: conflict-free 32-bit fragment loads
  constexpr int BS = BN + 16;  // int8 row pitch, keeps 16-byte rows
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % 16 == 0, "tile shape");

  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM][AS];
  __shared__ __align__(16) int8_t Bs[STAGES][BK][BS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // This block's slice of the contraction (blockIdx.z: split of D).
  const int kt_begin = blockIdx.z * ktiles_per_split;
  const int ktiles = min((D + BK - 1) / BK - kt_begin, ktiles_per_split);

  auto load_tile = [&](int stage, int kt) {
    const int k0 = (kt_begin + kt) * BK;
    constexpr int ACH = BM * BK / 8;  // 16-byte chunks of x
    for (int c = tid; c < ACH; c += NTHREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + cc;
      const bool ok = gr < R && gk < D;
      cp_async16(&As[stage][r][cc], ok ? x + static_cast<size_t>(gr) * D + gk : x, ok);
    }
    if (VEC_Q) {
      constexpr int BCH = BK * BN / 16;  // 16-byte chunks of q
      for (int c = tid; c < BCH; c += NTHREADS) {
        const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
        const int gk = k0 + r, gn = col0 + cc;
        const bool ok = gk < D && gn < K;
        cp_async16(&Bs[stage][r][cc], ok ? q + static_cast<size_t>(gk) * K + gn : q, ok);
      }
    } else {  // plain stores: visible after the __syncthreads that precedes this stage's use
      for (int c = tid; c < BK * BN; c += NTHREADS) {
        const int r = c / BN, cc = c % BN;
        const int gk = k0 + r, gn = col0 + cc;
        Bs[stage][r][cc] = gk < D && gn < K ? q[static_cast<size_t>(gk) * K + gn] : int8_t(0);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt visible; every warp is done with tile kt-1
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_tile(nk % STAGES, nk);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
      uint32_t b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r = wm * WTM + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][kk + 2 * t]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][kk + 2 * t]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][kk + 2 * t + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = wn * WTN + ni * 8 + g;
        b[ni][0] = i8x2_to_bf16x2(Bs[st][kk + 2 * t][n], Bs[st][kk + 2 * t + 1][n]);
        b[ni][1] = i8x2_to_bf16x2(Bs[st][kk + 2 * t + 8][n], Bs[st][kk + 2 * t + 9][n]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: per-column scale, cast, guarded store.  A split block
  // stores its unscaled f32 partial sum instead; w8a16_reduce finishes the
  // product.  With VEC_Q, K is a multiple of 16, so a thread's column pair
  // is in range together and its offset is even (one paired store);
  // otherwise each column is guarded and stored alone.
  float* part = partial ? partial + static_cast<size_t>(blockIdx.z) * R * K : nullptr;
  auto store1 = [&](size_t off, float v) {
    if (part) {
      part[off] = v;
    } else if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(out)[off] = v;
    }
  };
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int n = col0 + wn * WTN + ni * 8 + 2 * t;
      if (n >= K) continue;
      const bool pair = VEC_Q || n + 1 < K;
      const float s0 = part ? 1.f : scale[n];
      const float s1 = part || !pair ? 1.f : scale[n + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wm * WTM + mi * 16 + g + half * 8;
        if (r >= R) continue;
        const float v0 = acc[mi][ni][2 * half] * s0;
        const float v1 = acc[mi][ni][2 * half + 1] * s1;
        const size_t off = static_cast<size_t>(r) * K + n;
        if (!VEC_Q) {
          store1(off, v0);
          if (pair) store1(off + 1, v1);
        } else if (part) {
          *reinterpret_cast<float2*>(part + off) = make_float2(v0, v1);
        } else if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
        }
      }
    }
  }
}

// out[r, n] = scale[n] * sum over splits of partial[s, r, n], cast.
__global__ void w8a16_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
                             void* __restrict__ out, int R, int K, int splits, int out_bf16) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t n_out = static_cast<size_t>(R) * K;
  if (idx >= n_out) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[s * n_out + idx];
  acc *= scale[idx % K];
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(acc);
  } else {
    static_cast<float*>(out)[idx] = acc;
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
void launch(const void* x, const void* q, const void* scale, void* out, float* partial, int R,
            int D, int K, int out_bf16, int splits, cudaStream_t stream) {
  const int ktiles = (D + BK - 1) / BK;
  const int per_split = (ktiles + splits - 1) / splits;
  dim3 grid((K + BN - 1) / BN, (R + BM - 1) / BM, (ktiles + per_split - 1) / per_split);
  auto kernel = K % 16 == 0 ? w8a16_kernel<BM, BN, BK, WM, WN, STAGES, true>
                            : w8a16_kernel<BM, BN, BK, WM, WN, STAGES, false>;
  kernel<<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), out, splits > 1 ? partial : nullptr, R, D, K, out_bf16,
      per_split);
  if (splits > 1) {
    const size_t n_out = static_cast<size_t>(R) * K;
    w8a16_reduce<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
        partial, static_cast<const float*>(scale), out, R, K, static_cast<int>(grid.z), out_bf16);
  }
}

}  // namespace

// x [R, D] bf16, q [D, K] int8, scale [K] f32 -> out [R, K] (bf16 when
// out_bf16, else f32).  R <= 16 takes the skinny tile, and with splits > 1
// its contraction is cut into that many slices (more blocks in flight for
// the weight stream), each writing f32 partials to `workspace`
// ([splits, R, K], allocated by the caller) that a second kernel sums,
// scales and casts.  Larger R takes the wide tile, unsplit.  Returns the
// cudaError_t of the launches.
extern "C" int w8a16_matmul(const void* x, const void* q, const void* scale, void* out,
                            void* workspace, int R, int D, int K, int out_bf16, int splits,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (R <= 16) {
    launch<16, 64, 64, 1, 4, 4>(x, q, scale, out, ws, R, D, K, out_bf16, splits, s);
  } else {
    launch<128, 128, 32, 2, 4, 3>(x, q, scale, out, nullptr, R, D, K, out_bf16, 1, s);
  }
  return static_cast<int>(cudaGetLastError());
}
