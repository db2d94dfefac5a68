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
// The contract is BITWISE equality with the plain version and with the
//   reference (its scale is mantissa-truncated so that every q * scale is
//   exact in f32, and FMA contraction cannot move a bit):
//     amax  = max |v|                       (NaN propagates, as jnp.max)
//     scale = amax > 0 ? amax / 127 : 1     (IEEE division; NaN amax -> 1)
//     scale = bits(scale) & 0xFFFFFF00      (16 significand bits)
//     q     = NaN ? 0 : clamp(rint(v / scale), -127, 127)   (half to even)
//     err   = v - q * scale                 (exact product)
//   so no fast math, no reciprocal multiply.  The max is taken over |bits| as
//   unsigned integers: non-negative floats order as their bits, and every
//   NaN's |bits| lie above inf's 0x7F800000, so the integer max propagates
//   NaN where fmaxf would drop it.  The scale stays on the device (a
//   one-element tensor): no host sync per hop.
//
// K8's design.  The TPU kernel runs a grid of (2, blocks) on one core: a max
//   pass, then a quantize pass over the same tiles, the running amax in SMEM
//   scratch.  Here blocks run in parallel and the quantize pass needs the
//   whole chunk's amax, so a barrier across the grid takes the place of the
//   grid's first axis, inside ONE cooperative launch (cudaLaunchKernelEx with
//   cudaLaunchAttributeCooperative; the launch guarantees that every block is
//   resident, so the barrier cannot wait on a block that never starts, with
//   nccl kernels or a backward holding SMs; a refused launch is an error the
//   wrapper raises, never a quiet fall-back):
//     1. Block b owns vectors (4 elements, 16 bytes) [b * slice, (b + 1) *
//        slice) of the chunk; the last block also owns the n % 4 tail.  One
//        thread brings the first `staged` vectors of the slice into dynamic
//        shared memory by ENC_STAGES 1-D bulk copies (cp.async.bulk,
//        complete_tx on one mbarrier a copy), all issued at once;
//        meanwhile the block folds |bits| of the excess of a slice too long
//        for shared memory (read from HBM) and of the tail (scalar loads),
//        then of each stage as it lands.  The chunk crosses HBM once.
//     2. The block's max (warp shuffles on warp-uniform paths, then shared
//        memory) goes to its own slot of a partials buffer, then
//        cooperative_groups' grid barrier.  Every block then folds all the
//        slots itself: the order of the writes does not matter, and no slot
//        is read before its block wrote it in this launch, so the buffer
//        needs no zeroing (no memset node); one buffer per stream (the
//        wrapper's).  The launch, and so the barrier, is kept when a CUDA
//        graph captures it: one cooperative kernel node (chip_smoke's
//        codec_trace reads the graph's nodes).
//     3. Every block quantizes its staged vectors from shared memory (q as
//        four int8 in one 4-byte word, err as 16-byte stores), then the
//        excess (read again, mostly from L2) and the tail; block 0 writes the
//        scale.  RESIDUAL is a template flag: the all-gather encode writes 5
//        bytes an element, not 9.
//   The grid, slice and staged part come from the wrapper's
//   ring_codec.encode_plan; the launch refuses a grid larger than the
//   occupancy calculator's blocks per SM x SMs at the plan's shared memory.
//   The rule, from tools/codec_sweep.py --sweep on an H100 (PERF.md gives
//   the readings): as many blocks as can be resident, since more, shorter
//   slices won at every path length; one block an SM up to 16,384 elements
//   a block, two past it; two bulk copies a slice.  Staging the slice beat
//   reading v twice (a plan with nothing staged) at every path length.
//
// K9 and K10 stream: per element K9 reads 1 + 4 bytes and writes 4, K10
//   reads 1 and writes 4 (9 and 5 bytes: 1.80 and 1.00 us at 669,379
//   elements at 3.35 TB/s), a few operations each.  At the path's lengths
//   a whole row is about one latency-bandwidth product of HBM, so what a
//   call costs beyond its bytes is the launch, the dispatch of its blocks
//   and one round trip; the designs cut launches and keep every load of a
//   thread in flight at once.  A lane takes 16 elements: one 16-byte load
//   of codes, which its warp transposes through shared memory (512 bytes a
//   warp) so that each of the lane's four 16-byte f32 accesses is part of
//   512 contiguous bytes of the warp; codes widen to f32 exactly by a byte
//   permute under 2^23 and one subtraction (not the quarter-rate
//   int-to-float conversion).
//   K10 decodes a table of up to DEC_MAX_ROWS rows in ONE launch: (codes,
//     scale, destination) a row, passed by value as a kernel parameter, every
//     row of one length n.  The ring's all-gather hands it its W payloads
//     after the last hop and each row lands straight in the ring's output:
//     no per-row launch, no intermediate tensor, no row copy (5n bytes a
//     row).  The grid is (blocks of THREADS x 16 elements, rows); each row's
//     last block finishes that row's n % 16 tail.
//   K9 (acc += q * scale, in place) is one wave: the grid is the occupancy
//     calculator's blocks per SM x SMs, or fewer when the row needs fewer,
//     with a grid-stride loop past it.  A lane issues its four acc loads and
//     its code load before the first use; the scale is loaded once, beside
//     them.  The last block finishes the n % 16 tail.  tools/codec_sweep.py
//     --k9 times the variants PERF.md reports (L2 eviction policies, staging
//     by bulk copies) against this one.
//   Pointers are 16-byte aligned (the wrappers check).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;     // K9, K10
constexpr int ENC_THREADS = 512;  // K8: one or two blocks an SM
constexpr int ENC_STAGES = 2;      // K8: bulk copies (and mbarriers) a slice
constexpr int ENC_MAX_GRID = 1024;  // slots of the partials buffer (ENCODE_MAX_GRID)
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

__device__ __forceinline__ unsigned abs_max4(const float4& x) {
  return max(max(__float_as_uint(x.x) & ABS_MASK, __float_as_uint(x.y) & ABS_MASK),
             max(__float_as_uint(x.z) & ABS_MASK, __float_as_uint(x.w) & ABS_MASK));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ``bytes`` (a multiple of 16) from global to shared memory, completion
// counted on ``bar``.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The block's max of m, returned to every thread; every thread calls it.
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* scratch) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0;
#pragma unroll
  for (int w = 0; w < ENC_THREADS / 32; ++w) m = max(m, scratch[w]);
  return m;
}

// Quantize vector i (4 elements) and store its codes and, with the
// residual, its error.
template <bool RESIDUAL>
__device__ __forceinline__ void emit4(const float4& x, float s, long long i,
                                      signed char* __restrict__ q, float* __restrict__ err) {
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

// K8, launched cooperatively (see the note above).  slice and staged count
// vectors; err is null without the residual; partials: a max slot a block.
template <bool RESIDUAL>
__global__ void __launch_bounds__(ENC_THREADS)
    encode_kernel(const float* __restrict__ v, long long n, long long slice, int staged,
                  signed char* __restrict__ q, float* __restrict__ scale,
                  float* __restrict__ err, unsigned* partials) {
  extern __shared__ __align__(128) float4 buf[];
  __shared__ __align__(8) uint64_t bars[ENC_STAGES];
  __shared__ unsigned red[2][ENC_THREADS / 32];
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int tid = threadIdx.x;
  const long long nvec = n / 4;
  const long long lo = static_cast<long long>(blockIdx.x) * slice;
  const long long hi = min(lo + slice, nvec);
  const int on_chip = static_cast<int>(min(max(hi - lo, 0LL), static_cast<long long>(staged)));
  const int per = (on_chip + ENC_STAGES - 1) / ENC_STAGES;  // vectors a stage
  const long long end = hi;  // [lo + on_chip, end): the excess, read from HBM/L2 twice
  const int tail = blockIdx.x == gridDim.x - 1 ? static_cast<int>(n - nvec * 4) : 0;

  if (tid == 0) {
    for (int s = 0; s < ENC_STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s * per < on_chip; ++s) {
      const int s0 = s * per, s1 = min(s0 + per, on_chip);
      const uint32_t bytes = static_cast<uint32_t>(s1 - s0) * 16u;
      mbar_expect_tx(smem_u32(&bars[s]), bytes);
      bulk_copy(smem_u32(buf + s0), v4 + lo + s0, bytes, smem_u32(&bars[s]));
    }
  }
  // 1. max |bits|: the excess and the tail while the stages land, then each
  // stage as it arrives (one phase per barrier: parity 0).
  unsigned m = 0;
  for (long long i = lo + on_chip + tid; i < end; i += ENC_THREADS) m = max(m, abs_max4(v4[i]));
  if (tid < tail) m = max(m, __float_as_uint(v[nvec * 4 + tid]) & ABS_MASK);
  for (int s = 0; s * per < on_chip; ++s) {
    const int s0 = s * per, s1 = min(s0 + per, on_chip);
    mbar_wait(smem_u32(&bars[s]), 0);
    for (int i = s0 + tid; i < s1; i += ENC_THREADS) m = max(m, abs_max4(buf[i]));
  }
  m = block_max(m, red[0]);
  if (tid == 0) __stcg(partials + blockIdx.x, m);
  // 2. The grid barrier (every block is resident: the launch is
  // cooperative), then every block folds every block's max.
  cg::this_grid().sync();
  unsigned amax = 0;
  for (int b = tid; b < static_cast<int>(gridDim.x); b += ENC_THREADS)
    amax = max(amax, __ldcg(partials + b));
  amax = block_max(amax, red[1]);
  const float s = chunk_scale(amax);
  if (blockIdx.x == 0 && tid == 0) *scale = s;
  // 3. Quantize: the staged vectors from shared memory, the excess again
  // from L2/HBM, the tail.
  for (int i = tid; i < on_chip; i += ENC_THREADS) emit4<RESIDUAL>(buf[i], s, lo + i, q, err);
  for (long long i = lo + on_chip + tid; i < end; i += ENC_THREADS)
    emit4<RESIDUAL>(v4[i], s, i, q, err);
  if (tid < tail) {
    const long long j = nvec * 4 + tid;
    const signed char c = quantize(v[j], s);
    q[j] = c;
    if (RESIDUAL) err[j] = v[j] - static_cast<float>(c) * s;
  }
}

constexpr int MAX_DEVICES = 64;

// The largest dynamic shared memory a K8 block may take on the current
// device, after raising the kernel's limit to it there (the attribute is
// per device: once per instance and device).
template <bool RESIDUAL>
cudaError_t encode_smem_limit(int* bytes) {
  static int limits[MAX_DEVICES] = {};  // 0: not raised yet
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (limits[dev] == 0) {
    int optin;
    cudaFuncAttributes attr;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, encode_kernel<RESIDUAL>);
    if (e != cudaSuccess) return e;
    const int most = static_cast<int>(optin - attr.sharedSizeBytes) & ~15;
    e = cudaFuncSetAttribute(encode_kernel<RESIDUAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    limits[dev] = most;
  }
  *bytes = limits[dev];
  return cudaSuccess;
}

// Blocks of K8 one SM holds at `smem` bytes of dynamic shared memory, in the
// lesser of the two instances.
cudaError_t encode_occupancy(size_t smem, int* blocks) {
  int with, without;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&with, encode_kernel<true>,
                                                                ENC_THREADS, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&without, encode_kernel<false>,
                                                      ENC_THREADS, smem);
  *blocks = e != cudaSuccess ? 0 : with < without ? with : without;
  return e;
}

// Four int8 codes (one 32-bit word) as exact f32: each code's byte, sign
// bit flipped (b + 128 in [0, 255]), becomes the low mantissa byte of 2^23,
// and 2^23 + 128 is subtracted.  Equal to static_cast<float>(code).
__device__ __forceinline__ float4 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float BIAS = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - BIAS);
}

__device__ __forceinline__ float4 scaled(const float4& c, float s) {
  return make_float4(c.x * s, c.y * s, c.z * s, c.w * s);
}

// The 16-byte accesses of K9 and K10 (i counts 16-byte vectors):
// tools/codec_sweep.py --k9 builds a variant of these with L2 policies.
__device__ __forceinline__ uint4 load_codes(const signed char* q, long long i) {
  return reinterpret_cast<const uint4*>(q)[i];
}
__device__ __forceinline__ float4 k9_load_acc(const float* acc, long long i) {
  return reinterpret_cast<const float4*>(acc)[i];
}
__device__ __forceinline__ void k9_store_acc(float* acc, long long i, const float4& a) {
  reinterpret_cast<float4*>(acc)[i] = a;
}

// K9's and K10's warp-level layout.  Lane l loads the 16 codes of vector
// v0 + l (one 16-byte load: the warp reads 512 contiguous bytes) and puts
// them in its warp's slot of shared memory; after __syncwarp, for k = 0..3,
// lane l takes code word 32k + l (4 codes) back and accesses f32 vector
// 32k + l of the warp's 512 elements, so each of the four 16-byte f32
// accesses of a warp covers 512 contiguous bytes (a thread's own 16 codes
// would put its four f32 vectors 64 bytes apart: four times the requests).
constexpr int WARPS = THREADS / 32;
constexpr int WARP_VECS = 32;  // 16-code vectors a warp iteration (512 elements)

// This lane's code words, transposed through the warp's slot `words` (128
// words): returns words[32k + lane] in w[k].  `valid` vectors of the warp's
// 32 exist; a lane past them contributes zero codes.  Every lane calls it.
__device__ __forceinline__ void warp_codes(const signed char* __restrict__ q, long long v0,
                                           int valid, int lane, uint32_t* words, uint32_t w[4]) {
  const uint4 c = lane < valid ? load_codes(q, v0 + lane) : make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();  // the slot's last readers are done
  reinterpret_cast<uint4*>(words)[lane] = c;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = words[32 * k + lane];
}

// K9: acc += q * scale, in place (see the note above).  Each warp walks
// 512-element stretches of the row, a grid-stride loop (warp-uniform
// bounds); the last block finishes the n % 16 tail.
__global__ void __launch_bounds__(THREADS)
    decode_add_kernel(const signed char* __restrict__ q, const float* __restrict__ scale,
                      float* __restrict__ acc, long long n) {
  __shared__ uint32_t words[WARPS][4 * WARP_VECS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float s = __ldg(scale);
  const long long nvec = n / 16;
  const long long step = static_cast<long long>(gridDim.x) * WARPS * WARP_VECS;
  for (long long v0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * WARP_VECS; v0 < nvec;
       v0 += step) {
    const int valid = static_cast<int>(min(static_cast<long long>(WARP_VECS), nvec - v0));
    float4 a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (32 * k + lane < 4 * valid) a[k] = k9_load_acc(acc, 4 * v0 + 32 * k + lane);
    uint32_t w[4];
    warp_codes(q, v0, valid, lane, words[warp], w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (32 * k + lane >= 4 * valid) continue;
      const float4 d = widen4(w[k]);
      a[k].x = a[k].x + d.x * s;
      a[k].y = a[k].y + d.y * s;
      a[k].z = a[k].z + d.z * s;
      a[k].w = a[k].w + d.w * s;
      k9_store_acc(acc, 4 * v0 + 32 * k + lane, a[k]);
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - nvec * 16) {
    const long long j = nvec * 16 + threadIdx.x;
    acc[j] = acc[j] + static_cast<float>(q[j]) * s;
  }
}

// K10's row table, passed by value (DEC_MAX_ROWS x 24 bytes of the kernel
// parameter space).
constexpr int DEC_MAX_ROWS = 32;  // ring_codec.DECODE_ROWS_MAX
struct DecodeRows {
  const signed char* q[DEC_MAX_ROWS];
  const float* scale[DEC_MAX_ROWS];
  float* dst[DEC_MAX_ROWS];
};

// K10: dst_r = q_r * scale_r for row r = blockIdx.y; each warp one
// 512-element stretch (the layout above); the row's last block finishes
// its n % 16 tail.
__global__ void __launch_bounds__(THREADS)
    decode_rows_kernel(const __grid_constant__ DecodeRows rows, long long n) {
  __shared__ uint32_t words[WARPS][4 * WARP_VECS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const signed char* __restrict__ q = rows.q[blockIdx.y];
  float* __restrict__ dst = rows.dst[blockIdx.y];
  const float s = __ldg(rows.scale[blockIdx.y]);
  const long long nvec = n / 16;
  const long long v0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * WARP_VECS;
  if (v0 < nvec) {
    const int valid = static_cast<int>(min(static_cast<long long>(WARP_VECS), nvec - v0));
    uint32_t w[4];
    warp_codes(q, v0, valid, lane, words[warp], w);
    float4* out = reinterpret_cast<float4*>(dst) + 4 * v0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (32 * k + lane < 4 * valid) out[32 * k + lane] = scaled(widen4(w[k]), s);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - nvec * 16) {
    const long long j = nvec * 16 + threadIdx.x;
    dst[j] = static_cast<float>(q[j]) * s;
  }
}

// Blocks of THREADS that cover n elements at 16 a thread (at least one).
long long tiles_for(long long n) {
  const long long tiles = (n / 16 + THREADS - 1) / THREADS;
  return tiles > 0 ? tiles : 1;
}

// K9's grid on the current device: one wave (the occupancy calculator's
// blocks per SM x SMs, cached per device), or fewer if n needs fewer.
cudaError_t decode_add_grid(long long n, int* grid) {
  static int waves[MAX_DEVICES] = {};  // 0: not asked yet
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (waves[dev] == 0) {
    int sms, fit;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, decode_add_kernel, THREADS, 0);
    if (e != cudaSuccess) return e;
    waves[dev] = fit * sms;
  }
  const long long tiles = tiles_for(n);
  *grid = static_cast<int>(tiles < waves[dev] ? tiles : waves[dev]);
  return cudaSuccess;
}

}  // namespace

// K8's shared-memory budget on the current device: the most dynamic shared
// memory (a multiple of 16 bytes) at which `blocks_per_sm` blocks fit on one
// SM, by the occupancy calculator (the wrapper's encode_plan stages at most
// this much a block).
extern "C" int ring_encode_stage_budget(int blocks_per_sm, int* bytes) {
  int with, without;
  cudaError_t e = encode_smem_limit<true>(&with);
  if (e == cudaSuccess) e = encode_smem_limit<false>(&without);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int b = with < without ? with : without; b >= 0; b -= 128) {
    int fit;
    e = encode_occupancy(static_cast<size_t>(b), &fit);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fit >= blocks_per_sm) {
      *bytes = b;
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8 on the current device (the stream's).  v: n contiguous f32; q: n int8;
// scale: one f32; err: n f32 or null (no residual); partials: ENC_MAX_GRID
// 4-byte words, used by one stream.  grid, slice and staged (vectors of 4
// elements): the wrapper's encode_plan.  All 16-byte aligned.  Returns the
// cudaError_t of the launch: cudaErrorCooperativeLaunchTooLarge if the grid
// cannot be resident at once.
extern "C" int ring_encode_int8(const void* v, long long n, void* q, void* scale, void* err,
                                void* partials, int grid, long long slice, long long staged,
                                void* stream) {
  if (grid < 1 || grid > ENC_MAX_GRID || slice < 0 || staged < 0 || staged > slice ||
      grid * slice < n / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool residual = err != nullptr;
  auto kernel = residual ? encode_kernel<true> : encode_kernel<false>;
  int limit, dev, sms, fit;
  cudaError_t e = residual ? encode_smem_limit<true>(&limit) : encode_smem_limit<false>(&limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (staged * 16 > limit) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(staged) * 16;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, ENC_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid > fit * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(ENC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(v), n, slice, static_cast<int>(staged),
      static_cast<signed char*>(q), static_cast<float*>(scale), static_cast<float*>(err),
      static_cast<unsigned*>(partials)));
}

// The nodes of a captured CUDA graph (at most 64): kernel nodes, those of
// them launched cooperatively, and memset nodes.  For the check that one K8
// call captures as one cooperative kernel node and no memset.
extern "C" int ring_codec_graph_census(void* graph, int* kernels, int* cooperative,
                                       int* memsets) {
  cudaGraphNode_t nodes[64];
  size_t count = 64;
  cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nodes, &count);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (count > 64) return static_cast<int>(cudaErrorInvalidValue);
  *kernels = *cooperative = *memsets = 0;
  for (size_t i = 0; i < count; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) return static_cast<int>(e);
    *memsets += type == cudaGraphNodeTypeMemset;
    if (type != cudaGraphNodeTypeKernel) continue;
    ++*kernels;
    cudaLaunchAttributeValue value = {};
    e = cudaGraphKernelNodeGetAttribute(nodes[i], cudaLaunchAttributeCooperative, &value);
    if (e != cudaSuccess) return static_cast<int>(e);
    *cooperative += value.cooperative != 0;
  }
  return 0;
}

// K9 on the current device.  q: n int8; scale: one f32; acc: n f32,
// updated in place.
extern "C" int ring_decode_add_int8(const void* q, const void* scale, void* acc, long long n,
                                    void* stream) {
  if (n <= 0) return 0;
  int grid;
  cudaError_t e = decode_add_grid(n, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_add_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scale),
      static_cast<float*>(acc), n);
  return static_cast<int>(cudaGetLastError());
}

// K10, one launch for `rows` (1..DEC_MAX_ROWS) rows of n elements: row r
// decodes q[r] (n int8) by scale[r] (one f32) into dst[r] (n f32).
extern "C" int ring_decode_rows_int8(const void* const* q, const void* const* scale,
                                     void* const* dst, int rows, long long n, void* stream) {
  if (rows < 1 || rows > DEC_MAX_ROWS || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  DecodeRows table = {};
  for (int r = 0; r < rows; ++r) {
    table.q[r] = static_cast<const signed char*>(q[r]);
    table.scale[r] = static_cast<const float*>(scale[r]);
    table.dst[r] = static_cast<float*>(dst[r]);
  }
  const dim3 grid(static_cast<unsigned>(tiles_for(n)), static_cast<unsigned>(rows));
  decode_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(table, n);
  return static_cast<int>(cudaGetLastError());
}
