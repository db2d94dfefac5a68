// Fused AdamW update of one parameter leaf, in place: K7.
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/fused_adamw.py,
//   fused_adamw_leaf (_adamw_kernel): the optimizer update of the trainer
//   with --fused-update.
//
// What bounds it on the H100: bytes.  Per parameter it reads p, m, v and g
//   and writes p, m and v (28 bytes for an f32 leaf) and does ~15 flops:
//   at 3.35 TB/s the 483,650,048 parameters of the d2048 / 8-layer LM take
//   4.04 ms a step.  Nothing between the read and the write may reach
//   memory.
//
// Design: one pass, each element read once, updated in registers and
//   written once, in the TPU kernel's expression order:
//     m = b1 m + (1 - b1) g
//     v = b2 v + (1 - b2) g^2
//     p = p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)
//   with the update in f32 and p written back in its own dtype (f32 or
//   bf16, round to nearest even); m and v stay f32.  lr, bc1 = 1 - b1^t and
//   bc2 = 1 - b2^t are kernel arguments, so the step counter needs no
//   recompile; 1 - b1 and 1 - b2 are rounded to f32 on the host, as the
//   reference's Python constants are.  IEEE division and sqrtf (no fast
//   math); FMA contraction is the one freedom against the plain version
//   (the reference's bound: 8 ulp per update).  A grid-stride loop moves 16
//   bytes a load (4 f32 or 8 bf16 parameters, their f32 moments in one or
//   two 16-byte loads); the ragged tail (length not a multiple of the
//   vector) is finished by the first threads of the grid, no padding.  One
//   launch per leaf, as the reference; a multi-tensor launch is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float lr, bc1, bc2, b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float adamw(float p, float& m, float& v, float g, const Hyper& h) {
  m = h.b1 * m + h.c1 * g;
  v = h.b2 * v + h.c2 * (g * g);
  const float adam_term = (m / h.bc1) / (sqrtf(v / h.bc2) + h.eps);
  return p - h.lr * (adam_term + h.wd * p);
}

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(T* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                 const T* __restrict__ g, long long n, Hyper h) {
  constexpr int VEC = 16 / sizeof(T);  // parameters a 16-byte load
  const long long nvec = n / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    uint4 praw = reinterpret_cast<const uint4*>(p)[i];
    const uint4 graw = reinterpret_cast<const uint4*>(g)[i];
    T* pe = reinterpret_cast<T*>(&praw);
    const T* ge = reinterpret_cast<const T*>(&graw);
    float4 mv[VEC / 4], vv[VEC / 4];
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c) {
      mv[c] = reinterpret_cast<const float4*>(m)[i * (VEC / 4) + c];
      vv[c] = reinterpret_cast<const float4*>(v)[i * (VEC / 4) + c];
    }
    float* mf = reinterpret_cast<float*>(mv);
    float* vf = reinterpret_cast<float*>(vv);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      from_f32(adamw(to_f32(pe[e]), mf[e], vf[e], to_f32(ge[e]), h), &pe[e]);
    reinterpret_cast<uint4*>(p)[i] = praw;
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c) {
      reinterpret_cast<float4*>(m)[i * (VEC / 4) + c] = mv[c];
      reinterpret_cast<float4*>(v)[i * (VEC / 4) + c] = vv[c];
    }
  }
  const long long tail = n - nvec * VEC;  // fewer than VEC elements
  if (first < tail) {
    const long long j = nvec * VEC + first;
    float mj = m[j], vj = v[j];
    from_f32(adamw(to_f32(p[j]), mj, vj, to_f32(g[j]), h), &p[j]);
    m[j] = mj;
    v[j] = vj;
  }
}

}  // namespace

// p, g: n contiguous parameters and gradients of one dtype (is_bf16 ? bf16 :
// f32); m, v: n contiguous f32 moments; all four 16-byte aligned.  Updates
// p, m and v in place.  c1, c2: 1 - b1 and 1 - b2 rounded to f32.  Returns
// the cudaError_t of the launch.
extern "C" int fused_adamw(void* p, void* m, void* v, const void* g, long long n, int is_bf16,
                           float lr, float bc1, float bc2, float b1, float c1, float b2,
                           float c2, float eps, float wd, int max_blocks, void* stream) {
  if (n <= 0) return 0;
  const Hyper h{lr, bc1, bc2, b1, c1, b2, c2, eps, wd};
  const int vec = is_bf16 ? 8 : 4;
  const long long work = n / vec > 0 ? n / vec : 1;
  const int blocks = static_cast<int>(
      (work + THREADS - 1) / THREADS < max_blocks ? (work + THREADS - 1) / THREADS : max_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    adamw_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), static_cast<float*>(m), static_cast<float*>(v),
        static_cast<const __nv_bfloat16*>(g), n, h);
  } else {
    adamw_kernel<float><<<blocks, THREADS, 0, s>>>(static_cast<float*>(p), static_cast<float*>(m),
                                                   static_cast<float*>(v),
                                                   static_cast<const float*>(g), n, h);
  }
  return static_cast<int>(cudaGetLastError());
}
