// Hopper building blocks shared by the flash mainloops: the forward
// (flash_fwd_sm90.cuh: K1, K11) and the backward (flash_bwd_sm90.cuh: K2,
// K3, K12, K13).  mbarriers, TMA loads through 4-D tensor maps over strided
// [B, L, heads, D] bf16 views, named barriers, wgmma instructions and their
// shared-memory descriptors, the geometry of a tile as TMA writes it, and
// the load and store of f32 rows in the wgmma accumulator layout (the
// store also rounded to bf16).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace sm90 {

constexpr float NEG_INF = -1e30f;

// What a mainloop computes around its tiles: K1/K2/K3's causal attention
// over the whole sequence (FLASH), or one ring chunk step with f32
// accumulators in and out: the diagonal (causal on local indices) or a
// full step (every pair, masked only past the chunk's end).
enum Kind { FLASH = 0, RING_DIAGONAL = 1, RING_FULL = 2 };

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``.
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

// One TMA box of a 4-D map, coordinates (d, head, row, batch), into shared
// memory; completion is counted on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// Named barriers over the two consumer warpgroups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma reads or writes across the fences and waits around it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of the k-steps of a wgmma RS product, from a 64 x (16 *
// KS) f32 accumulator rounded to bf16: the accumulator layout of 16
// columns is the A-fragment layout of one k-step.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* acc) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16x2(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// f32 rows in the accumulator layout (wgmma m64nN, f32): element i of a
// thread is row g + 8 * ((i >> 1) & 1) of its warp's 16 and column
// (i >> 2) * 8 + 2t + (i & 1).  ``half`` picks the thread's row (g or
// g + 8); ``row`` points at that row's N contiguous f32, or is null for a
// row that starts at zero.
template <int N>
__device__ __forceinline__ void acc_load_row(float* a, int half, const float* row, int t) {
#pragma unroll
  for (int nd = 0; nd < N / 8; ++nd) {
    const float2 v =
        row ? *reinterpret_cast<const float2*>(row + nd * 8 + 2 * t) : make_float2(0.f, 0.f);
    a[4 * nd + 2 * half] = v.x;
    a[4 * nd + 2 * half + 1] = v.y;
  }
}

template <int N>
__device__ __forceinline__ void acc_store_row(const float* a, int half, float* row, int t) {
#pragma unroll
  for (int nd = 0; nd < N / 8; ++nd)
    *reinterpret_cast<float2*>(row + nd * 8 + 2 * t) =
        make_float2(a[4 * nd + 2 * half], a[4 * nd + 2 * half + 1]);
}

// The same row rounded to bf16 (once) into N contiguous bf16.
template <int N>
__device__ __forceinline__ void acc_store_row_bf16(const float* a, int half, __nv_bfloat16* row,
                                                   int t) {
#pragma unroll
  for (int nd = 0; nd < N / 8; ++nd)
    *reinterpret_cast<__nv_bfloat162*>(row + nd * 8 + 2 * t) =
        __floats2bfloat162_rn(a[4 * nd + 2 * half], a[4 * nd + 2 * half + 1]);
}

// ------------------------------------------------------- wgmma wrappers
// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n32(d, a, db);
  }
}

// Shared-memory geometry of a ROWS-row tile of head dim D as TMA writes
// it: rows of min(D, 64) bf16 in 128-byte (D 64, 128) or 64-byte (D 32)
// swizzle atoms, so a D-128 tile is two [ROWS][64] atoms side by side.
// K-major operands step a k-slice of 16 by 32 bytes inside an atom row
// and jump atoms by ATOM_BYTES; MN-major operands take ATOM_BYTES as the
// leading offset and step 16 rows by 16 * ROW_BYTES; the stride offset is
// 8 rows (GROUP) either way.
template <int D, int ROWS>
struct TileGeom {
  static constexpr int ATOM = D < 64 ? D : 64;  // bf16 a swizzle-atom row
  static constexpr int ROW_BYTES = ATOM * 2;     // 128 (D 64, 128) or 64 (D 32)
  static constexpr int ATOMS = D / ATOM;         // atom columns side by side
  static constexpr int ATOM_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = ATOMS * ATOM_BYTES;
  static constexpr uint32_t SWIZZLE = ROW_BYTES == 128 ? 1 : 2;  // descriptor layout type
  static constexpr uint32_t GROUP = 8 * ROW_BYTES;  // 8 rows: the descriptors' stride offset
  static constexpr int KSTEPS = ATOM / 16;           // k-steps of 16 inside an atom row

  // The descriptor offset (16-byte units) of k-step kk of a K-major operand.
  __host__ __device__ static constexpr uint32_t kstep(int kk) {
    return ((kk / KSTEPS) * ATOM_BYTES + (kk % KSTEPS) * 32) >> 4;
  }
  // The descriptor offset of k-step kk (16 rows) of an MN-major operand.
  __host__ __device__ static constexpr uint32_t mnstep(int kk) {
    return (kk * 16 * ROW_BYTES) >> 4;
  }
  // Load the whole tile (rows row0.., one head) through a 4-D map.
  __device__ static void load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int head,
                              int row0, int batch) {
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      tma_load(dst + a * ATOM_BYTES, map, bar, a * ATOM, head, row0, batch);
  }
};

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D map of a bf16 [B, L, heads, D] view with element strides (sb,
// sl, sh), boxes of ``rows`` rows of one head and min(D, 64) dims.  The
// stride of a dim of extent 1 is never used; it is replaced by a legal one.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int heads, long long sb,
              long long sl, long long sh, int rows) {
  using T = TileGeom<D, 64>;
  EncodeTiled encode = encoder();
  if (!encode) return false;
  if (heads == 1) sh = D;
  if (L == 1) sl = heads * sh;
  if (B == 1) sb = L * sl;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::ATOM), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel into ``smem`` bytes of dynamic shared memory on the current
// card, once a card: the attribute belongs to a card, and one process may
// launch on several cards (a serving replica a card) from several threads.
// ``configured`` holds a bit a card; cards past 63 are set every call.
template <typename Kernel>
int set_smem_once(Kernel kernel, int smem, std::atomic<unsigned long long>& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!bit || !(configured.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured.fetch_or(bit);
  }
  return 0;
}

}  // namespace sm90
