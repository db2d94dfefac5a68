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
// Three routes, chosen by the caller (ops/quant_matmul.py, int8_route) and
// passed in:
//
// - WGMMA (R > 16 and K % 16 == 0: prefill; every projection of the
//   repo's LM).  A Hopper mainloop: one block of 3 warpgroups owns a
//   128 x 256 output tile.  Warpgroup 0 is the producer: it drops to 24
//   registers (setmaxnreg) and one thread issues TMA loads (2-D tensor
//   maps) of the x tile (bf16 [128 rows][64], K-major, 128-byte swizzle)
//   and of the q tile (int8 [64 d-rows][256 columns] as two 128-byte-wide
//   swizzled boxes) into a 4-stage ring, one transaction-counted full
//   barrier and one empty barrier (released by the 8 consumer warps) a
//   stage.  TMA zero-fills rows past R, columns past K and depth past D,
//   so no operand is padded in memory.  Warpgroups 1 and 2 are the
//   consumers (240 registers), 64 rows each.  They also widen: tensor
//   cores read bf16 operands only, so the int8 tile is rewritten in shared
//   memory as bf16 (exact: every int8 is a bf16), as the MN-major B
//   operand of wgmma (the transpose bit: [64 d-rows][64 columns] atoms of
//   128-byte rows with the 128-byte swizzle, four atoms side by side), into
//   one of 3 widened buffers.  The consumers widen tile j + 1 while their
//   wgmma of tile j runs (wgmma is asynchronous), each thread four
//   16-byte pieces a tile with two permutes, four logic ops and two bf16
//   adds per 4 values.  Why the consumers: their 8 warps share the work,
//   where the producer warpgroup has 3 spare warps, too few to keep pace
//   with the tensor cores (the block cannot grow past 384 threads: an
//   m64n256 accumulator needs 154 registers a thread when ptxas compiles
//   the kernel).  The widening stores are made visible to the async proxy
//   (fence.proxy.async) and a named barrier over the 256 consumer threads
//   hands the widened tile to both warpgroups; the same barrier tells the
//   widening of tile j + 2 that both warpgroups' wgmma of tile j - 1 are
//   done with that buffer.  Each consumer runs wgmma m64n256k16 (bf16 ->
//   f32) from shared memory, one commit group a tile with one in flight.
//   What holds it back is shared memory: a k-tile moves 160 KB through it
//   (TMA's 32 KB in, wgmma's 80 KB of operand reads, the widening's 16 KB
//   read and 32 KB written) against 112 KB for a bf16-weight GEMM.
//   Epilogue: the per-column f32 scale once, the cast, the tile staged in
//   shared memory over the drained x and int8 stages and written by TMA
//   stores, which clip rows past R and columns past K.  The grid's fast
//   axis walks the column tiles, so the blocks in flight share x's row
//   tiles in L2.
// - SKINNY (R <= 16: decode; K % 16 == 0, every projection of the
//   repo's LM).  The product is a sweep of the int8 weights, D*K bytes,
//   at the memory rate (0.126 ms for one decode step's 41 GEMMs at R 8 on
//   the H100); tensor throughput, 2*R*D*K operations, is 1/20 of that.
//   So the design keeps weight bytes in flight and spends few
//   instructions a weight.  The product is computed transposed, out^T =
//   q^T x^T, on mma.sync m16n8k16: the int8 weights are the 16-row A
//   operand and x (R <= 8 rows, or two n-tiles for R <= 16) the 8-column
//   B operand, so no tile row is padding at R 8.  A warp owns 128 output
//   columns and a slice of the contraction; its lane 0 streams the slice
//   in k16 blocks ([16 rows][128 bytes], one TMA box of a 2-D map, 128-byte
//   swizzle, rows past D and columns past K zero-filled) into the warp's
//   own ring of 5 stages on mbarriers, and x's piece of each block comes
//   by cp.async; no block barrier in the mainloop.  (Per-thread 16-byte
//   cp.async of the weights kept too few bytes in flight; one TMA box a
//   stage keeps more.)  Thread (g =
//   lane / 4, t = lane % 4) reads whole 16-byte words of rows 2t, 2t + 1,
//   2t + 8 and 2t + 9 (columns 16g .. 16g + 15); the mma's k-pairs are
//   built from the words of rows k and k + 1 by byte permutes
//   (__byte_perm(w_k, w_k1, 0x5140) and 0x7362) and widened to bf16 by
//   biased_to_bf16x2 (exact; no byte loads, no int-to-float conversion).
//   So a thread's word feeds eight m-tiles: m-tile j's A row g is physical
//   column 16g + 2j and row g + 8 column 16g + 2j + 1, and its accumulator
//   holds those two columns for x rows 2t and 2t + 1: the fixed column
//   permutation is undone when the thread writes 16 consecutive columns a
//   row to shared memory.  The contraction is split over the 8 warps of a
//   block and over the blocks of a thread-block cluster (splits <= 8,
//   ops/quant_matmul.py skinny_splits): each warp writes its f32 partial
//   over its drained ring, the block sums its warps in order, every block
//   pushes each share of the tile into the share's owner in the cluster
//   through distributed shared memory, and after one cluster barrier each
//   owner sums its shares in rank order, scales, casts and stores them.
//   One launch a GEMM, no workspace, no atomics, and the sum's order is
//   fixed.  A relaxed cluster arrive after the set-up and its wait before
//   the pushes make sure every block of the cluster runs before any
//   writes into its shared memory; the wait costs nothing by then.
//   (Two to eight warps side by side over a block's columns, or k32 boxes
//   of 3 stages, measured slower; PERF.md.)
//   With K % 16 != 0 (a byte-level head of 257) the 16-byte words do not
//   exist: R <= 16 then takes the byte-staged mma.sync tile (16 x 64, no
//   split), an instance of the TILE kernel.
// - TILE (R > 16 and K % 16 != 0: a byte-level vocabulary of 257 in an LM
//   head): q's rows are not 16-byte aligned, so neither TMA nor 16-byte
//   copies can stage them; a 128 x 128 mma.sync tile stages q byte by
//   byte, widens it through float and stores column by column.
//
// Requires: D % 8 == 0 (16-byte x rows), 16-byte aligned base pointers,
//   row-major contiguous operands.

#include <cooperative_groups.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;
namespace cg = cooperative_groups;

// ------------------------------------------------------------ mma.sync tiles

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

// 4 int8 weights (one word) -> two bf16x2 words, exactly.  A byte b goes
// under a 0x43 high byte (bf16 0x43bb); its low 7 bits m give the bf16
// 128 + m, its sign bit s the bf16 -128 - 128 s, and one bf16 add gives
// m - 128 s = b.
__device__ __forceinline__ uint32_t biased_to_bf16x2(uint32_t t) {
  const uint32_t mag = t & 0xFF7FFF7Fu;
  const uint32_t off = (t & 0x00800080u) | 0xC300C300u;
  const __nv_bfloat162 v = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                                   *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = biased_to_bf16x2(__byte_perm(w, 0x43434343u, 0x4140));
  hi = biased_to_bf16x2(__byte_perm(w, 0x43434343u, 0x4342));
}

// The byte-staged tile (TILE route; SKINNY with K % 16 != 0): q is staged
// byte by byte (its rows are not 16-byte aligned) and widened through
// float; every column is guarded and stored alone.
template <int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM* WN * 32)
    w8a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, void* __restrict__ out, int R, int D, int K,
                 int out_bf16) {
  constexpr int NTHREADS = WM * WN * 32;
  constexpr int WTM = BM / WM;  // warp tile rows
  constexpr int WTN = BN / WN;  // warp tile cols
  constexpr int MT = WTM / 16;
  constexpr int NT = WTN / 8;
  constexpr int AS = BK + 8;   // bf16 row pitch: conflict-free 32-bit fragment loads
  constexpr int BS = BN + 16;  // int8 row pitch
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % 16 == 0, "tile shape");

  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM][AS];
  __shared__ __align__(16) int8_t Bs[STAGES][BK][BS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int ktiles = (D + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    constexpr int ACH = BM * BK / 8;  // 16-byte chunks of x
    for (int c = tid; c < ACH; c += NTHREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + cc;
      const bool ok = gr < R && gk < D;
      cp_async16(&As[stage][r][cc], ok ? x + static_cast<size_t>(gr) * D + gk : x, ok);
    }
    // Plain stores: visible after the __syncthreads that precedes this stage's use.
    for (int c = tid; c < BK * BN; c += NTHREADS) {
      const int r = c / BN, cc = c % BN;
      const int gk = k0 + r, gn = col0 + cc;
      Bs[stage][r][cc] = gk < D && gn < K ? q[static_cast<size_t>(gk) * K + gn] : int8_t(0);
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

  // Epilogue: per-column scale, cast, guarded store.
  auto store1 = [&](size_t off, float v) {
    if (out_bf16) {
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
      const bool pair = n + 1 < K;
      const float s0 = scale[n];
      const float s1 = pair ? scale[n + 1] : 1.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wm * WTM + mi * 16 + g + half * 8;
        if (r >= R) continue;
        const size_t off = static_cast<size_t>(r) * K + n;
        store1(off, acc[mi][ni][2 * half] * s0);
        if (pair) store1(off + 1, acc[mi][ni][2 * half + 1] * s1);
      }
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
void launch(const void* x, const void* q, const void* scale, void* out, int R, int D, int K,
            int out_bf16, cudaStream_t stream) {
  dim3 grid((K + BN - 1) / BN, (R + BM - 1) / BM);
  w8a16_kernel<BM, BN, BK, WM, WN, STAGES><<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), out, R, D, K, out_bf16);
}

// ------------------------------------------------------------ skinny route

// One TMA box of a 2-D map, coordinates (inner, outer), completion counted
// on ``bar``.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}


constexpr int SK_COLS = 128;   // output columns a block and each warp: 8 threads x 16 bytes
constexpr int SK_WARPS = 8;    // warps a block, each on its own slice of the depth
constexpr int SK_STAGES = 5;   // stages in each warp's ring
constexpr int SK_MAX_SPLITS = 8;  // blocks a cluster (the portable limit)
constexpr int SK_Q = 16 * SK_COLS;  // a stage of q: one k16 block, [16 rows][128 bytes]

// NT n-tiles of 8 x rows (R <= 8 NT).  Shared memory: every warp's ring
// of q stages (TMA boxes, 128-byte swizzle, 1024-byte aligned), then of x
// stages ([8 NT rows][16 bf16], cp.async), then the buffer the cluster's
// blocks push their shares of the tile into, then the rings' mbarriers.
template <int NT>
struct Skinny {
  static constexpr int XROWS = 8 * NT;
  static constexpr int X_BYTES = XROWS * 32;
  static constexpr int Q_RING = SK_STAGES * SK_Q;
  static constexpr int X_OFF = SK_WARPS * Q_RING;
  static constexpr int RECV_OFF = X_OFF + SK_WARPS * SK_STAGES * X_BYTES;
  static constexpr int RECV = (XROWS * SK_COLS / 4 + SK_MAX_SPLITS) * 16;  // float4 shares
  static constexpr int BAR_OFF = RECV_OFF + RECV;
  static constexpr int SMEM = BAR_OFF + SK_WARPS * SK_STAGES * 8 + 1024;  // + alignment slack
  // A warp's f32 partial [XROWS][128] is written over its drained q ring.
  static_assert(XROWS * SK_COLS * 4 <= Q_RING, "partial tile");
};

// grid (splits, column tiles), cluster (splits, 1, 1), SK_WARPS warps; tq
// is q's 2-D map, boxes of [16 rows][128 columns].
template <int NT, bool OUT_BF16>
__global__ void __launch_bounds__(SK_WARPS * 32, 3 - NT)
    w8a16_skinny_kernel(const __grid_constant__ CUtensorMap tq,
                        const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                        void* __restrict__ out, int R, int D, int K) {
  using G = Skinny<NT>;
  extern __shared__ unsigned char sk_raw[];
  unsigned char* const sk_smem = sk_raw + ((1024u - (smem_u32(sk_raw) & 1023u)) & 1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int splits = gridDim.x, rank = static_cast<int>(cluster.block_rank());
  const int col0 = blockIdx.y * SK_COLS;  // the block's 128 columns
  unsigned char* const qring = sk_smem + warp * G::Q_RING;
  unsigned char* const xring = sk_smem + G::X_OFF + warp * SK_STAGES * G::X_BYTES;
  const uint32_t bars = smem_u32(sk_smem + G::BAR_OFF) + warp * SK_STAGES * 8;

  // This warp's slice of the contraction: k16 blocks [kb0, kb0 + nk), the
  // (split, warp) slices of the column tile in order.
  const int nkb = (D + 15) / 16;
  const int per = (nkb + splits * SK_WARPS - 1) / (splits * SK_WARPS);
  const int kb0 = (rank * SK_WARPS + warp) * per;
  const int nk = max(0, min(nkb - kb0, per));

  if (lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
    for (int s = 0; s < SK_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // Distributed shared memory may be written only once every block of the
  // cluster runs: arrive now, wait just before the pushes.
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Stage kb0 + i into ring slot i % SK_STAGES: q's box by TMA (rows past D
  // and columns past K zero-filled), x's rows by cp.async (16-byte piece c:
  // row c / 2, depth k0 + 8 (c % 2) .. + 7).
  auto load = [&](int i) {
    const int st = i % SK_STAGES, k0 = (kb0 + i) * 16;
    if (lane == 0) {
      mbar_expect_tx(bars + 8 * st, SK_Q);
      tma_load_2d(smem_u32(qring + st * SK_Q), &tq, bars + 8 * st, col0, k0);
    }
    for (int c = lane; c < 2 * G::XROWS; c += 32) {
      const int r = c / 2, k = k0 + 8 * (c % 2);
      const bool ok = r < R && k < D;
      cp_async16(xring + st * G::X_BYTES + c * 16, ok ? x + static_cast<size_t>(r) * D + k : x,
                 ok);
    }
  };

  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int st = i % SK_STAGES;
    cp_async_wait<SK_STAGES - 2>();
    mbar_wait(bars + 8 * st, (i / SK_STAGES) & 1);
    __syncwarp();  // stage i's x visible to the warp; every lane done with stage i - 1
    if (i + SK_STAGES - 1 < nk) load(i + SK_STAGES - 1);
    cp_async_commit();
    // Thread (g, t): columns 16g .. 16g + 15 of rows 2t, 2t + 1, 2t + 8,
    // 2t + 9 of the k16 block; 16-byte piece g of row r sits at piece
    // g ^ (r % 8).
    const unsigned char* qs = qring + st * SK_Q;
    uint4 w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 2 * t + (r & 1) + 8 * (r >> 1);
      w[r] = *reinterpret_cast<const uint4*>(qs + row * 128 + ((g ^ (row & 7)) << 4));
    }
    uint32_t b[NT][2];  // B = x^T: column g of n-tile n is x row 8n + g, k-pairs 2t and 2t + 8
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const unsigned char* xr = xring + st * G::X_BYTES + (8 * n + g) * 32 + 4 * t;
      b[n][0] = *reinterpret_cast<const uint32_t*>(xr);
      b[n][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // the 32-bit words of columns 4c .. 4c + 3
      const uint32_t w0 = (&w[0].x)[c], w1 = (&w[1].x)[c];
      const uint32_t w2 = (&w[2].x)[c], w3 = (&w[3].x)[c];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // m-tile 2c + h: columns 4c + 2h (row g), + 1 (row g + 8)
        const uint32_t sel = h ? 0x7362u : 0x5140u;
        uint32_t a[4];
        widen4(__byte_perm(w0, w1, sel), a[0], a[1]);
        widen4(__byte_perm(w2, w3, sel), a[2], a[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[2 * c + h][n], a, b[n]);
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // every lane of the warp is done with its ring

  // The warp's partial over its q ring, row-major [XROWS][128]: m-tile j
  // holds columns 16g + 2j (c0, c1) and 16g + 2j + 1 (c2, c3) of x rows
  // 8n + 2t (c0, c2) and 8n + 2t + 1 (c1, c3).
  float* const part = reinterpret_cast<float*>(qring);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = part + (8 * n + 2 * t + h) * SK_COLS + 16 * g;
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        *reinterpret_cast<float4*>(row + 2 * j) =
            make_float4(acc[j][n][h], acc[j][n][2 + h], acc[j + 1][n][h], acc[j + 1][n][2 + h]);
    }
  __syncthreads();

  // The block's tile [R][SK_COLS]: one float4 a thread, the sum over the
  // warps in order.  Unsplit, it is stored; split,
  // rank s of the cluster owns float4s [s * share, (s + 1) * share) of the
  // tile: every block pushes each sum into its owner's buffer (slot rank)
  // through distributed shared memory, and after one cluster barrier each
  // owner sums its slots in rank order.  Scale, cast and store.
  constexpr int C4 = SK_COLS / 4;  // float4s a tile row
  const int n4 = R * C4;
  auto store = [&](int f, float4 v) {
    const int r = f / C4, col = col0 + (f % C4) * 4;
    if (col >= K) return;
    const float4 s = *reinterpret_cast<const float4*>(scale + col);
    const size_t off = static_cast<size_t>(r) * K + col;
    if constexpr (OUT_BF16) {
      __nv_bfloat162 v2[2] = {__floats2bfloat162_rn(v.x * s.x, v.y * s.y),
                              __floats2bfloat162_rn(v.z * s.z, v.w * s.w)};
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + off) =
          *reinterpret_cast<const uint2*>(v2);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
          make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
    }
  };
  const int share = (n4 + splits - 1) / splits;
  float4* const recv = reinterpret_cast<float4*>(sk_smem + G::RECV_OFF);  // [splits][share]
  if (splits > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int f = threadIdx.x; f < n4; f += SK_WARPS * 32) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < SK_WARPS; ++k) {
      const float4 o = reinterpret_cast<const float4*>(sk_smem + k * G::Q_RING)[f];
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    if (splits == 1) {
      store(f, v);
    } else {
      const int owner = f / share;
      cluster.map_shared_rank(recv, owner)[rank * share + f - owner * share] = v;
    }
  }
  if (splits == 1) return;
  cluster.sync();  // every push has landed; no block reads another's memory after this
  for (int j = threadIdx.x; j < share && rank * share + j < n4; j += SK_WARPS * 32) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 o = recv[s * share + j];
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    store(rank * share + j, v);
  }
}

// ------------------------------------------------------------ wgmma route

constexpr int WG_BM = 128;                    // output rows a block (64 a consumer)
constexpr int WG_BN = 256;                    // output columns a block
constexpr int WG_BK = 64;                     // depth a k-tile: one 128-byte bf16 row of x
constexpr int WG_RAW = 4;                     // stages of (x, int8 q) tiles
constexpr int WG_WIDE = 3;                    // widened bf16 q buffers
constexpr int WG_THREADS = 384;              // a producer warpgroup, 2 consumers
constexpr int X_BYTES = WG_BM * WG_BK * 2;    // [128 rows][64 bf16], 128-byte swizzle
constexpr int Q8_BOX = WG_BK * 128;           // [64 d-rows][128 int8], 128-byte swizzle
constexpr int Q8_BYTES = WG_BN / 128 * Q8_BOX;
constexpr int QB_ATOM = WG_BK * 128;          // [64 d-rows][64 bf16], 128-byte swizzle
constexpr int QB_BYTES = WG_BN / 64 * QB_ATOM;
constexpr int OUT_BOX = WG_BM * 128;          // [128 rows][128 bytes] of output, 128-byte swizzle
constexpr int WG_SMEM = WG_RAW * (X_BYTES + Q8_BYTES) + WG_WIDE * QB_BYTES + 16 * WG_RAW + 1024;
static_assert(WG_SMEM <= 232448, "shared memory of one block");
// The output tile (f32: 128 KB) is staged in the x and int8 stages.
static_assert(WG_BN / 32 * OUT_BOX <= WG_RAW * (X_BYTES + Q8_BYTES), "output staging");

// One TMA box from shared memory to a 2-D map at (inner, outer); the
// out-of-range part of the box is not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int inner,
                                             int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(inner), "r"(outer)
      : "memory");
}

// Wait for the barrier's phase of parity ``parity``, the retry loop inside
// the asm.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// Generic-proxy stores to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 256] += A[64 x 16] B[16 x 256]: A K-major, B MN-major (the
// transpose bit), both from shared memory.
__device__ __forceinline__ void wgmma_n256_tb(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// OUT_BF16: the output (and its map ``to``) is bf16, else f32.
template <bool OUT_BF16>
__global__ void __launch_bounds__(WG_THREADS, 1)
    w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap to, const float* __restrict__ scale,
                       int D, int K) {
  extern __shared__ unsigned char w8_smem[];
  const uint32_t base = (smem_u32(w8_smem) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  unsigned char* const gbase = w8_smem + (base - smem_u32(w8_smem));
  const uint32_t sX = base, sQ8 = sX + WG_RAW * X_BYTES, sQB = sQ8 + WG_RAW * Q8_BYTES;
  const uint32_t bars = sQB + WG_WIDE * QB_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (WG_RAW + s); };
  const int row0 = blockIdx.y * WG_BM, col0 = blockIdx.x * WG_BN;
  const int nk = (D + WG_BK - 1) / WG_BK;  // k-tiles of the contraction

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_RAW; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int j = 0; j < nk; ++j) {
        const int s = j % WG_RAW;
        if (j >= WG_RAW) bar_wait(empty(s), (j / WG_RAW - 1) & 1);
        mbar_expect_tx(full(s), X_BYTES + Q8_BYTES);
        tma_load_2d(sX + s * X_BYTES, &tx, full(s), j * WG_BK, row0);
#pragma unroll
        for (int b = 0; b < WG_BN / 128; ++b)
          tma_load_2d(sQ8 + s * Q8_BYTES + b * Q8_BOX, &tq, full(s), col0 + b * 128, j * WG_BK);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;              // this consumer's 64 rows: c * 64 .. c * 64 + 63 of the tile
    const int ct = threadIdx.x - 128;  // 0..255 over both consumers
    const int warp = (ct % 128) / 32, lane = ct % 32;

    // Widen k-tile j's int8 q (raw stage j % WG_RAW) into the bf16 buffer
    // j % WG_WIDE, the 256 consumer threads together.  A unit is one d-row
    // and 16 columns: 16 bytes in, 32 out; four units a thread, loads
    // issued together.  Lanes 0-7 of a warp take 8 consecutive d-rows of
    // one column group, so under the 128-byte swizzle (16-byte piece p of
    // row r at p ^ (r % 8)) their loads and stores hit 8 distinct bank
    // groups.
    auto widen = [&](int j) {
      const unsigned char* src = gbase + (sQ8 - base) + (j % WG_RAW) * Q8_BYTES;
      unsigned char* dst = gbase + (sQB - base) + (j % WG_WIDE) * QB_BYTES;
      uint4 raw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = ct + i * 256;
        const int r = (u & 7) | ((u >> 7) << 3), c16 = (u >> 3) & 15;
        raw[i] = *reinterpret_cast<const uint4*>(src + (c16 >> 3) * Q8_BOX + r * 128 +
                                                 (((c16 & 7) ^ (r & 7)) << 4));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = ct + i * 256;
        const int r = (u & 7) | ((u >> 7) << 3), c16 = (u >> 3) & 15;
        uint4 lo, hi;
        widen4(raw[i].x, lo.x, lo.y);
        widen4(raw[i].y, lo.z, lo.w);
        widen4(raw[i].z, hi.x, hi.y);
        widen4(raw[i].w, hi.z, hi.w);
        unsigned char* row = dst + (c16 >> 2) * QB_ATOM + r * 128;
        const int p = (c16 & 3) * 2;  // the two 16-byte pieces of these 16 columns
        *reinterpret_cast<uint4*>(row + ((p ^ (r & 7)) << 4)) = lo;
        *reinterpret_cast<uint4*>(row + (((p + 1) ^ (r & 7)) << 4)) = hi;
      }
    };

    // Descriptors: x K-major (a k-step of 16 adds 32 bytes inside the
    // swizzled row), the widened q MN-major (the leading offset steps
    // between 64-column atoms, a k-step adds 16 rows of 128 bytes); the
    // stride offset is 8 rows of 128 bytes for both.
    const uint64_t x_desc = smem_desc(sX + c * 64 * 128, 16, 1024, 1);
    const uint64_t q_desc = smem_desc(sQB, QB_ATOM, 1024, 1);

    float acc[WG_BN / 2];
#pragma unroll
    for (int i = 0; i < WG_BN / 2; ++i) acc[i] = 0.f;

    bar_wait(full(0), 0);
    widen(0);
    fence_async_smem();
    named_sync(1);
    for (int j = 0; j < nk; ++j) {
      uint64_t dx = x_desc + (((j % WG_RAW) * X_BYTES) >> 4);
      uint64_t dq = q_desc + (((j % WG_WIDE) * QB_BYTES) >> 4);
      fence_regs<WG_BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_n256_tb(acc, dx + ((kk * 32) >> 4), dq + ((kk * 16 * 128) >> 4));
      wgmma_commit();
      if (j + 1 < nk) {  // tile j + 1 is widened while tile j's products run
        bar_wait(full((j + 1) % WG_RAW), ((j + 1) / WG_RAW) & 1);
        widen(j + 1);
        fence_async_smem();  // the stores, visible to wgmma's reads
      }
      wgmma_wait<1>();  // tile j - 1's products are done: release its x and int8 stage
      fence_regs<WG_BN / 2>(acc);
      if (j > 0 && lane == 0) mbar_arrive(empty((j - 1) % WG_RAW));
      named_sync(1);  // tile j + 1 widened by all; both consumers done with tile j - 1
    }
    wgmma_wait<0>();
    fence_regs<WG_BN / 2>(acc);

    // Epilogue: the per-column scale, the cast, and the tile staged in
    // shared memory as TMA-store boxes of [128 rows][128 bytes] in 128-byte
    // swizzle atoms (64 bf16 or 32 f32 columns a box), over the x and int8
    // stages: every load has landed, and after this barrier both
    // consumers' products are done.  The accumulator layout (wgmma m64nN,
    // f32): element i of a thread is row g + 8 * ((i >> 1) & 1) of its
    // warp's 16 and column (i >> 2) * 8 + 2t + (i & 1); under the swizzle
    // a warp's 8 rows hit 8 distinct bank groups.  TMA clips the rows past
    // R and the columns past K.
    named_sync(1);
    const int g = lane >> 2, t = lane & 3;
    const int r_top = c * 64 + warp * 16 + g;  // the tile row of the thread's first element
#pragma unroll
    for (int nd = 0; nd < WG_BN / 8; ++nd) {
      const int n = col0 + nd * 8 + 2 * t;
      const float2 s = n < K ? *reinterpret_cast<const float2*>(scale + n) : make_float2(0.f, 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r_top + half * 8;
        const float v0 = acc[4 * nd + 2 * half] * s.x;
        const float v1 = acc[4 * nd + 2 * half + 1] * s.y;
        if constexpr (OUT_BF16) {  // box nd / 8, 16-byte piece nd % 8, bytes 4t
          *reinterpret_cast<__nv_bfloat162*>(gbase + (nd >> 3) * OUT_BOX + r * 128 +
                                              (((nd & 7) ^ (r & 7)) << 4) + 4 * t) =
              __floats2bfloat162_rn(v0, v1);
        } else {  // box nd / 4, piece 2 (nd % 4) + t / 2, bytes 8 (t % 2)
          *reinterpret_cast<float2*>(gbase + (nd >> 2) * OUT_BOX + r * 128 +
                                     (((2 * (nd & 3) + (t >> 1)) ^ (r & 7)) << 4) +
                                     8 * (t & 1)) = make_float2(v0, v1);
        }
      }
    }
    fence_async_smem();
    named_sync(1);
    if (ct == 0) {
      constexpr int COLS = OUT_BF16 ? 64 : 32;  // columns a box
#pragma unroll
      for (int b = 0; b < WG_BN / COLS; ++b)
        if (col0 + b * COLS < K) tma_store_2d(&to, base + b * OUT_BOX, col0 + b * COLS, row0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // smem read out
    }
  }
}

// The 2-D map of a row-major [outer, inner] matrix with ``row_bytes``
// between rows, boxes of [box_outer][box_inner] in 128-byte swizzle atoms
// (box_inner elements make 128 bytes); out-of-range elements read as zero
// and are not written.
bool make_map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int inner,
                 int outer, long long row_bytes, int box_inner, int box_outer) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT, bool OUT_BF16>
int launch_skinny(const void* x, const void* q, const void* scale, void* out, int R, int D,
                  int K, int splits, cudaStream_t stream) {
  CUtensorMap tq;
  if (!make_map_2d(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, D, K, SK_COLS, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = w8a16_skinny_kernel<NT, OUT_BF16>;
  static std::atomic<unsigned long long> configured{0};
  if (int err = set_smem_once(kernel, Skinny<NT>::SMEM, configured)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (K + SK_COLS - 1) / SK_COLS);
  cfg.blockDim = dim3(SK_WARPS * 32);
  cfg.dynamicSmemBytes = Skinny<NT>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, tq,
                                             static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const float*>(scale), out, R, D, K));
}

template <bool OUT_BF16>
int launch_wgmma(const void* x, const void* q, const void* scale, void* out, int R, int D, int K,
                 cudaStream_t stream) {
  CUtensorMap tx, tq, to;
  if (!make_map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, D, R, 2LL * D, WG_BK, WG_BM) ||
      !make_map_2d(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, D, K, 128, WG_BK) ||
      !make_map_2d(&to, out,
                   OUT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   K, R, (OUT_BF16 ? 2LL : 4LL) * K, OUT_BF16 ? 64 : 32, WG_BM))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> configured{0};
  if (int err = set_smem_once(w8a16_wgmma_kernel<OUT_BF16>, WG_SMEM, configured)) return err;
  dim3 grid((K + WG_BN - 1) / WG_BN, (R + WG_BM - 1) / WG_BM);
  w8a16_wgmma_kernel<OUT_BF16><<<grid, WG_THREADS, WG_SMEM, stream>>>(
      tx, tq, to, static_cast<const float*>(scale), D, K);
  return static_cast<int>(cudaGetLastError());
}

enum Route { SKINNY = 0, TILE = 1, WGMMA = 2 };

}  // namespace

// x [R, D] bf16, q [D, K] int8, scale [K] f32 -> out [R, K] (bf16 when
// out_bf16, else f32), on the route ``route`` (0 skinny, 1 tile, 2 wgmma;
// see the header).  On the skinny route with K % 16 == 0, ``splits``
// (1..8) blocks of one cluster share a column tile's contraction.  Returns
// the cudaError_t of the launch; cudaErrorInvalidValue for an unknown
// route, R > 16 on the skinny route, splits outside 1..8, a wgmma route
// with K % 16 != 0, or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int w8a16_matmul(const void* x, const void* q, const void* scale, void* out, int R,
                            int D, int K, int out_bf16, int splits, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case SKINNY:
      if (R > 16 || splits < 1 || splits > SK_MAX_SPLITS)
        return static_cast<int>(cudaErrorInvalidValue);
      if (K % 16) {
        launch<16, 64, 64, 1, 4, 4>(x, q, scale, out, R, D, K, out_bf16, s);
        break;
      }
      if (R <= 8)
        return out_bf16 ? launch_skinny<1, true>(x, q, scale, out, R, D, K, splits, s)
                        : launch_skinny<1, false>(x, q, scale, out, R, D, K, splits, s);
      return out_bf16 ? launch_skinny<2, true>(x, q, scale, out, R, D, K, splits, s)
                      : launch_skinny<2, false>(x, q, scale, out, R, D, K, splits, s);
    case TILE:
      launch<128, 128, 32, 2, 4, 3>(x, q, scale, out, R, D, K, out_bf16, s);
      break;
    case WGMMA:
      if (K % 16) return static_cast<int>(cudaErrorInvalidValue);
      return out_bf16 ? launch_wgmma<true>(x, q, scale, out, R, D, K, s)
                      : launch_wgmma<false>(x, q, scale, out, R, D, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
