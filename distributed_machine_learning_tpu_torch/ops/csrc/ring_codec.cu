// The int8 ring-hop codec: K8 (encode, with or without the error-feedback
// residual), K9 (decode-add, in place) and K10 (decode).
//
// Replaces: distributed_machine_learning_tpu/ops/pallas/ring_codec.py,
//   _encode_call (_encode_kernel), decode_add_int8 (_decode_add_kernel) and
//   decode_int8 (_decode_kernel): every local piece of one hop of part3's
//   compressed ring all-reduce (--ring-compress int8 --ring-codec-impl
//   pallas).
//
// What bounds them on the H100: bytes.  Per element K8 reads v (4 bytes) and
//   writes q (1) and, with the residual, err (4): 9 bytes, ~8.8 us for a
//   3.28 M-element chunk at 3.35 TB/s; K9 reads q and acc and writes acc (9
//   bytes); K10 reads q and writes out (5 bytes).  A few operations per
//   element: far below the card's rate.
//
// Design.  The contract is BITWISE equality with the plain version and with
//   the reference (its scale is mantissa-truncated so that every q * scale is
//   exact in f32, and FMA contraction cannot move a bit):
//     amax  = max |v|                       (NaN propagates, as jnp.max)
//     scale = amax > 0 ? amax / 127 : 1     (IEEE division; NaN amax -> 1)
//     scale = bits(scale) & 0xFFFFFF00      (16 significand bits)
//     q     = NaN ? 0 : clamp(rint(v / scale), -127, 127)   (half to even)
//     err   = v - q * scale                 (exact product)
//   so no fast math, no reciprocal multiply.  The TPU kernel needs the whole
//   chunk's amax before any tile can quantize and runs a grid of (2, blocks)
//   on one core; blocks run in no order here, so K8 is two launches: a max
//   pass in which every block folds |v| into one unsigned word with
//   atomicMax (non-negative floats order as their bits, and every NaN's
//   |bits| lie above inf's 0x7F800000, so the integer max propagates NaN
//   where fmaxf would drop it), then a quantize pass that every block starts
//   by reading that word.  The chunk fits the 50 MB L2, so the second read
//   of v mostly hits.  The scale stays on the device (a one-element tensor):
//   no host sync per hop.  Every kernel is a grid-stride loop of 16-byte f32
//   loads (4 elements, their 4 int8 codes in one 4-byte word); the ragged
//   tail (length not a multiple of 4) is finished by the first threads of
//   the grid.  Pointers are 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned ABS_MASK = 0x7FFFFFFFu;
constexpr unsigned SCALE_MASK = 0xFFFFFF00u;

__device__ __forceinline__ float chunk_scale(unsigned amax_bits) {
  const float amax = __uint_as_float(amax_bits);
  const float s = amax > 0.f ? amax / 127.f : 1.f;
  return __uint_as_float(__float_as_uint(s) & SCALE_MASK);
}

__device__ __forceinline__ signed char quantize(float v, float s) {
  const float r = rintf(v / s);
  if (r != r) return 0;  // NaN converts to 0, as the reference's convert does
  return static_cast<signed char>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

__device__ __forceinline__ unsigned warp_max(unsigned x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

// Max pass of K8: *amax = max over v of (bits(v) & 0x7FFFFFFF); *amax must be
// zero on entry.
__global__ void __launch_bounds__(THREADS)
    amax_kernel(const float* __restrict__ v, long long n, unsigned* __restrict__ amax) {
  const long long nvec = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  unsigned m = 0;
  for (long long i = first; i < nvec; i += stride) {
    const uint4 x = reinterpret_cast<const uint4*>(v)[i];
    m = max(m, max(max(x.x & ABS_MASK, x.y & ABS_MASK), max(x.z & ABS_MASK, x.w & ABS_MASK)));
  }
  if (first < n - nvec * 4) m = max(m, __float_as_uint(v[nvec * 4 + first]) & ABS_MASK);
  // Reduce outside the loop: every lane of every warp reaches the shuffles.
  __shared__ unsigned warps[THREADS / 32];
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? warps[threadIdx.x] : 0u;
    m = warp_max(m);
    if (threadIdx.x == 0) atomicMax(amax, m);
  }
}

// Quantize pass of K8.  err may be null (no residual).
template <bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const float* __restrict__ v, long long n, const unsigned* __restrict__ amax,
                    signed char* __restrict__ q, float* __restrict__ scale,
                    float* __restrict__ err) {
  const float s = chunk_scale(*amax);
  const long long nvec = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (first == 0) *scale = s;
  for (long long i = first; i < nvec; i += stride) {
    const float4 x = reinterpret_cast<const float4*>(v)[i];
    char4 c;
    c.x = quantize(x.x, s);
    c.y = quantize(x.y, s);
    c.z = quantize(x.z, s);
    c.w = quantize(x.w, s);
    reinterpret_cast<char4*>(q)[i] = c;
    if (RESIDUAL) {
      float4 e;
      e.x = x.x - static_cast<float>(c.x) * s;
      e.y = x.y - static_cast<float>(c.y) * s;
      e.z = x.z - static_cast<float>(c.z) * s;
      e.w = x.w - static_cast<float>(c.w) * s;
      reinterpret_cast<float4*>(err)[i] = e;
    }
  }
  if (first < n - nvec * 4) {
    const long long j = nvec * 4 + first;
    const signed char c = quantize(v[j], s);
    q[j] = c;
    if (RESIDUAL) err[j] = v[j] - static_cast<float>(c) * s;
  }
}

// K9: acc += q * scale, in place.
__global__ void __launch_bounds__(THREADS)
    decode_add_kernel(const signed char* __restrict__ q, const float* __restrict__ scale,
                      float* __restrict__ acc, long long n) {
  const float s = *scale;
  const long long nvec = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    const char4 c = reinterpret_cast<const char4*>(q)[i];
    float4 a = reinterpret_cast<const float4*>(acc)[i];
    a.x = a.x + static_cast<float>(c.x) * s;
    a.y = a.y + static_cast<float>(c.y) * s;
    a.z = a.z + static_cast<float>(c.z) * s;
    a.w = a.w + static_cast<float>(c.w) * s;
    reinterpret_cast<float4*>(acc)[i] = a;
  }
  if (first < n - nvec * 4) {
    const long long j = nvec * 4 + first;
    acc[j] = acc[j] + static_cast<float>(q[j]) * s;
  }
}

// K10: out = q * scale.
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const signed char* __restrict__ q, const float* __restrict__ scale,
                  float* __restrict__ out, long long n) {
  const float s = *scale;
  const long long nvec = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    const char4 c = reinterpret_cast<const char4*>(q)[i];
    float4 o;
    o.x = static_cast<float>(c.x) * s;
    o.y = static_cast<float>(c.y) * s;
    o.z = static_cast<float>(c.z) * s;
    o.w = static_cast<float>(c.w) * s;
    reinterpret_cast<float4*>(out)[i] = o;
  }
  if (first < n - nvec * 4) {
    const long long j = nvec * 4 + first;
    out[j] = static_cast<float>(q[j]) * s;
  }
}

int grid_for(long long n, int max_blocks) {
  const long long work = n / 4 > 0 ? n / 4 : 1;
  const long long blocks = (work + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < max_blocks ? blocks : max_blocks);
}

}  // namespace

// K8.  v: n contiguous f32; q: n int8; scale: one f32; err: n f32 or null
// (no residual); amax: one 4-byte scratch word.  All 16-byte aligned.
// Returns the cudaError_t of the launches.
extern "C" int ring_encode_int8(const void* v, long long n, void* q, void* scale, void* err,
                                void* amax, int max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t status = cudaMemsetAsync(amax, 0, sizeof(unsigned), s);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = grid_for(n, max_blocks);
  amax_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const float*>(v), n,
                                         static_cast<unsigned*>(amax));
  status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  if (err != nullptr) {
    quantize_kernel<true><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(v), n, static_cast<const unsigned*>(amax),
        static_cast<signed char*>(q), static_cast<float*>(scale), static_cast<float*>(err));
  } else {
    quantize_kernel<false><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(v), n, static_cast<const unsigned*>(amax),
        static_cast<signed char*>(q), static_cast<float*>(scale), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9.  q: n int8; scale: one f32; acc: n f32, updated in place.
extern "C" int ring_decode_add_int8(const void* q, const void* scale, void* acc, long long n,
                                    int max_blocks, void* stream) {
  if (n <= 0) return 0;
  decode_add_kernel<<<grid_for(n, max_blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scale),
      static_cast<float*>(acc), n);
  return static_cast<int>(cudaGetLastError());
}

// K10.  q: n int8; scale: one f32; out: n f32.
extern "C" int ring_decode_int8(const void* q, const void* scale, void* out, long long n,
                                int max_blocks, void* stream) {
  if (n <= 0) return 0;
  decode_kernel<<<grid_for(n, max_blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
