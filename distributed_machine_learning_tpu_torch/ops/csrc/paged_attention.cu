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
//   memory rate (0.0118 ms at the engine's step: 8 lanes at positions up to
//   4159, 4 kv heads, D 128, bf16), so each lane reads its own O(pos) slots
//   only, in large copies, with enough bytes in flight on every SM.
//
// Design: the TPU kernel walks a sequential grid over pages with the tables
//   and positions in scalar prefetch.  Here the work is planned on the card
//   from the positions (no host sync, so a decode step stays capturable).
//   Every block of a fixed grid (ops/decode_attention.py, paged_plan)
//   reads the W positions and computes the same plan in shared memory: the
//   chunk, a multiple of 16 slots sized so the live slots of all lanes
//   and heads make about `target` units, and a prefix sum over the lanes of
//   ceil((pos_w + 1) / chunk).  A work unit is (lane, kv head, chunk); the
//   units are numbered lane by lane, and block b takes units b, b + grid,
//   ...  So no block is planned past a frontier and a long lane gets
//   proportionally more blocks.  A unit first reads its table entries
//   once, coalesced, into shared memory (clamped into the pool).  Its
//   slots are cut into tiles of 16; each of the 4 warps takes every 4th
//   tile and stages it through its own ring of 3 (f32 D 128: 2) stages:
//   lane j issues two bulk copies (cp.async.bulk: slot j's K row and V
//   row, 256 bytes each at D 128 in bf16) completing on the stage's
//   mbarrier, so several tiles are in flight per warp while earlier ones
//   are consumed.  Rows land 16 bytes further apart than their length, so
//   the 8 rows an ldmatrix reads fall in distinct bank groups.
//   The products: on the CUDA cores the dot products cost few flops but
//   many instructions (widening, a shuffle reduction per slot and head, p
//   computed by every lane of a slot): about 1,200 a 16-slot tile and
//   warp, which held a first version of this design to 0.032 ms at the
//   engine's step on an H100.  So bf16 pools run both products on mma.sync m16n8k16
//   (bf16 in, f32 accumulate): S = Q K^T with the kv head's query group
//   as the 16-row A operand (REP rows live), K's rows by ldmatrix; the f32
//   scores masked and scaled, their row max over the tile by two shuffles;
//   then O += P V with P, rounded to bf16, taken from the score
//   accumulators as the A operand and V's rows by ldmatrix.trans: about
//   130 instructions a tile.  f32 pools keep K4's scheme on the CUDA cores
//   (one slot's D values read by a group of lanes with 16-byte loads,
//   scores reduced by warp shuffles).  Either way the online softmax is f32
//   in base 2, q is cast to the pool dtype before the dot and p rounded to
//   it before it weights V, as the TPU kernel does.  The warps merge through
//   shared memory.  A lane with one unit writes out = acc / l directly;
//   a split lane's units write f32 partials (m, l, acc), and the last of
//   them to arrive (a per-(lane, kv head) counter that it resets to zero)
//   merges that lane's partials in unit order and writes out: one launch,
//   a fixed order of summation, and only live partials are read.  Idle
//   lanes point every table entry at the scratch block with position 0,
//   so they read one slot.  Entries past a lane's frontier are never read;
//   a position is clamped into its table and a table entry into the pool,
//   so no read leaves either whatever the inputs hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 4;
constexpr int TS = 16;          // slots a tile (one ring stage)
constexpr int TBL = 512;        // table entries a unit can stage
constexpr int MIN_CHUNK = 64;   // fewest slots a unit: one tile a warp
constexpr int MAX_LANES = 1024;

template <typename T>
struct Vec;  // 16 raw bytes of T per lane (f32 pools widen them on the CUDA cores)

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static __nv_bfloat16 cast(float x) { return __float2bfloat16_rn(x); }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& raw, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
  __device__ __forceinline__ static float cast(float x) { return x; }
};

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

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 b16 matrices from shared memory, lane 8j + i giving row i's
// address of matrix j; TRANS delivers them transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shapes a (dtype, head dim, group size) instance fixes.
template <typename T, int D, int REP>
struct Geom {
  // bf16 pools: both products on mma.sync m16n8k16 (the query group as
  // 16 rows, REP of them live); f32 pools: the CUDA cores, a group of LPS
  // lanes per slot with 16-byte loads.
  static constexpr bool MMA = sizeof(T) == 2;
  static constexpr int VEC = Vec<T>::N;
  static constexpr int LPS = D / VEC;   // lanes per slot
  static constexpr int SPW = 32 / LPS;  // slots per warp per load
  static_assert(D % 16 == 0 && LPS <= 32 && 32 % LPS == 0 && REP <= 8, "head dim, group");
  // Slots a step: the scores of IT slots a lane group are held at once.
  static constexpr int IT = (TS / SPW) * REP <= 32 ? TS / SPW : 32 / REP;
  static constexpr int STEP = IT * SPW;
  static_assert(TS % STEP == 0, "tile steps");
  static constexpr int ROW = D * static_cast<int>(sizeof(T));  // bytes of one slot's row
  // Rows are staged 16 bytes apart beyond their length, so that the 8 rows
  // an ldmatrix reads fall in 8 distinct bank groups.
  static constexpr int PITCH = ROW + 16;
  static constexpr int STAGE = 2 * TS * PITCH;                 // K rows, then V rows
  static constexpr int NST = STAGE <= 9216 ? 3 : 2;            // stages a warp
  static constexpr int RINGS = NWARPS * NST * STAGE;
  static_assert(NWARPS * REP * (D + 2) * 4 <= RINGS, "warp merge over the rings");
  static constexpr int BARS = RINGS;                           // mbarriers, then
  static constexpr int TABLE = BARS + NWARPS * NST * 8;        // table entries, then
  static constexpr int LANES = TABLE + TBL * 4;                // n and prefix per lane
  static constexpr int smem(int W) { return LANES + (2 * W + 1) * 4; }
  // The merge of a split lane: weights of up to MERGE_UNITS units at once
  // (m, then l, per row) over the rings; elements of the output a thread.
  static constexpr int MERGE_UNITS = RINGS / (8 * REP);
  static constexpr int E = (REP * D + NWARPS * 32 - 1) / (NWARPS * 32);
};

// One warp's online-softmax state over its tiles of a unit.
template <typename T, int D, int REP, bool MMA = Geom<T, D, REP>::MMA>
struct WarpState;

// bf16: S = Q K^T with the query group as mma's 16-row A operand (row g of
// the thread's quad; rows g >= REP and every row g + 8 are zero), K's rows
// as B by ldmatrix; the f32 scores masked, scaled, their row max over the
// tile by two shuffles; P rounded to bf16 is the A operand of O += P V
// straight from the score accumulators, V's rows by ldmatrix.trans.  A
// thread holds row g's running max, its share of the row sum (columns 2t,
// 2t + 1 of each 8-slot half), and O's columns 8n + 2t, + 1.
template <typename T, int D, int REP>
struct WarpState<T, D, REP, true> {
  using G = Geom<T, D, REP>;
  uint32_t qa[D / 16][2];
  float m, l, o[D / 8][4];

  __device__ void init(const T* q, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* row = q + g * D + kk * 16 + 2 * t;
      qa[kk][0] = g < REP ? *reinterpret_cast<const uint32_t*>(row) : 0u;
      qa[kk][1] = g < REP ? *reinterpret_cast<const uint32_t*>(row + 8) : 0u;
    }
    m = NEG_INF;
    l = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // The tile in the stage at shared address ``ks`` (K rows, then V rows),
  // its first n_live slots live.
  __device__ void tile(uint32_t ks, unsigned char* ks_gen, int n_live, int lane, float scale_log2) {
    const int t = lane & 3, mat = lane >> 3, row = lane & 7;
    const uint32_t vs = ks + TS * G::PITCH;
    if (n_live < TS) {  // V rows past the live slots: zeros, not stale bits (P is 0 there)
      unsigned char* vrows = ks_gen + TS * G::PITCH;
      for (int c = lane; c < (TS - n_live) * (G::ROW / 16); c += 32)
        *reinterpret_cast<uint4*>(vrows + (n_live + c / (G::ROW / 16)) * G::PITCH +
                                  (c % (G::ROW / 16)) * 16) = make_uint4(0u, 0u, 0u, 0u);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
    }
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];  // slots 0-7 (depth lo, hi), slots 8-15 (lo, hi)
      ldsm_x4<false>(ks + ((mat >> 1) * 8 + row) * G::PITCH + (kk * 16 + (mat & 1) * 8) * 2, b);
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      mma_bf16_16816(s[0], a, b);
      mma_bf16_16816(s[1], a, b + 2);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[h][e] = h * 8 + 2 * t + e < n_live ? s[h][e] * scale_log2 : NEG_INF;
        mx = fmaxf(mx, s[h][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    float p[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[h][e] = exp2f(s[h][e] - m_new);
        l += p[h][e];
      }
    const uint32_t a[4] = {pack_bf16x2(p[0][0], p[0][1]), 0u, pack_bf16x2(p[1][0], p[1][1]), 0u};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];  // dims dn*16 + 0-7 (slots 0-7, 8-15), dims + 8-15 (slots 0-7, 8-15)
      ldsm_x4<true>(vs + ((mat & 1) * 8 + row) * G::PITCH + (dn * 16 + (mat >> 1) * 8) * 2, b);
      mma_bf16_16816(o[2 * dn], a, b);
      mma_bf16_16816(o[2 * dn + 1], a, b + 2);
    }
  }

  // This warp's (m, l, O) rows into the warp-merge buffers.
  __device__ void store(float* sm_m, float* sm_l, float* sm_acc, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float lt = l + __shfl_xor_sync(0xffffffffu, l, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (g >= REP) return;
    if (t == 0) {
      sm_m[g] = m;
      sm_l[g] = lt;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(sm_acc + g * D + 8 * n + 2 * t) = make_float2(o[n][0], o[n][1]);
  }
};

// f32: K4's scheme on the CUDA cores.  One slot's D values read by a group
// of LPS lanes with 16-byte loads, scores reduced by warp shuffles, the
// online-softmax state kept per lane group and merged over the groups at
// the end.
template <typename T, int D, int REP>
struct WarpState<T, D, REP, false> {
  using G = Geom<T, D, REP>;
  using V = Vec<T>;
  static constexpr int VEC = G::VEC, LPS = G::LPS, SPW = G::SPW, IT = G::IT;
  float qv[REP][VEC], m[REP], l[REP], acc[REP][VEC];

  __device__ void init(const T* q, int lane) {
    const int li = lane % LPS;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      V::widen(*reinterpret_cast<const uint4*>(q + r * D + li * VEC), qv[r]);
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
    }
  }

  __device__ void tile(uint32_t, unsigned char* ks_gen, int n_live, int lane, float scale_log2) {
    const int li = lane % LPS, sub = lane / LPS;
    const unsigned char* vs_gen = ks_gen + TS * G::PITCH;
    // The step bound is uniform across the warp (every lane reaches the
    // shuffles); a lane group whose slot is past the live slots skips its
    // update.
    for (int base = 0; base < n_live; base += G::STEP) {
      float sc[IT][REP];
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        float kf[VEC];
        V::widen(*reinterpret_cast<const uint4*>(ks_gen + (base + it * SPW + sub) * G::PITCH +
                                                 li * 16),
                 kf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float p = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) p = fmaf(qv[r][e], kf[e], p);
          sc[it][r] = p;
        }
      }
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
        for (int it = 0; it < IT; ++it)
#pragma unroll
          for (int r = 0; r < REP; ++r) sc[it][r] += __shfl_xor_sync(0xffffffffu, sc[it][r], off);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int it = 0; it < IT; ++it) {
          sc[it][r] = base + it * SPW + sub < n_live ? sc[it][r] * scale_log2 : NEG_INF;
          mx = fmaxf(mx, sc[it][r]);
        }
        const float m_new = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - m_new);
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int slot = base + it * SPW + sub;
        if (slot >= n_live) continue;
        float vf[VEC];
        V::widen(*reinterpret_cast<const uint4*>(vs_gen + slot * G::PITCH + li * 16), vf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float p = exp2f(sc[it][r] - m[r]);  // already in the pool dtype, f32
          l[r] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
  }

  __device__ void store(float* sm_m, float* sm_l, float* sm_acc, int lane) {
    const int li = lane % LPS, sub = lane / LPS;
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) {  // merge the lane groups
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float m_new = fmaxf(m[r], m_o);
        const float a_s = exp2f(m[r] - m_new), a_o = exp2f(m_o - m_new);
        l[r] = l[r] * a_s + l_o * a_o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float acc_o = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
          acc[r][e] = acc[r][e] * a_s + acc_o * a_o;
        }
        m[r] = m_new;
      }
    }
    if (sub != 0) return;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (li == 0) {
        sm_m[r] = m[r];
        sm_l[r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[r * D + li * VEC + e] = acc[r][e];
    }
  }
};

// part: acc [units, REP, D], then m [units, REP], then l [units, REP], f32,
// for the units of lanes with more than one.  counters: W * Hkv ints, zero
// between calls.
template <typename T, int D, int REP>
__global__ void __launch_bounds__(NWARPS * 32)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ kpool, const T* __restrict__ vpool,
                 const int* __restrict__ tables, const int* __restrict__ positions,
                 T* __restrict__ out, float* __restrict__ part, int* __restrict__ counters, int W,
                 int H, int Hkv, int bs, int MB, int nblocks, int target, int max_units,
                 float scale_log2) {
  using V = Vec<T>;
  using G = Geom<T, D, REP>;
  constexpr int NST = G::NST, E = G::E;
  extern __shared__ __align__(128) unsigned char smem[];
  int* const s_tbl = reinterpret_cast<int*>(smem + G::TABLE);
  int* const s_n = reinterpret_cast<int*>(smem + G::LANES);  // slots of lane w (pos + 1)
  int* const s_pref = s_n + W;                              // units before lane w, per head
  __shared__ int s_chunk, s_last;
  __shared__ float s_mx[REP], s_ls[REP], s_alpha[REP];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slots = MB * bs;
  const uint32_t bars = smem_u32(smem + G::BARS);
  auto bar = [&](int s) { return bars + 8u * (warp * NST + s); };
  unsigned char* const ring_gen = smem + warp * NST * G::STAGE;
  const uint32_t ring = smem_u32(ring_gen);

  if (lane == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The plan, the same in every block: slots per lane, the chunk, and the
  // prefix sum of units over the lanes.
  for (int w = threadIdx.x; w < W; w += NWARPS * 32)
    s_n[w] = min(max(positions[w], 0), slots - 1) + 1;
  __syncthreads();
  if (warp == 0) {
    long long total = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      int n = w0 + lane < W ? s_n[w0 + lane] : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(0xffffffffu, n, off);
      total += n;
    }
    const long long want = (static_cast<long long>(Hkv) * total + target - 1) / target;
    const int cap = ((TBL - 2) * bs + 1) / TS * TS;  // a unit's pages fit the staged table
    const int chunk = static_cast<int>(
        min(static_cast<long long>(cap),
            max(static_cast<long long>(MIN_CHUNK), (want + TS - 1) / TS * TS)));
    int run = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int c = w0 + lane < W ? (s_n[w0 + lane] + chunk - 1) / chunk : 0;
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      if (w0 + lane < W) s_pref[w0 + lane] = run + incl - c;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      s_pref[W] = run;
      s_chunk = chunk;
    }
  }
  __syncthreads();
  const int chunk = s_chunk;
  const int n_units = min(Hkv * s_pref[W], max_units);
  float* const part_m = part + static_cast<size_t>(max_units) * REP * D;
  float* const part_l = part_m + static_cast<size_t>(max_units) * REP;

  WarpState<T, D, REP> ws;
  uint32_t used = 0;  // tiles this warp has consumed, over all its units (ring phases)
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    // Unit u: lane w (the last with Hkv * s_pref[w] <= u), kv head hk, chunk ci.
    int a = 0, b = W;
    while (b - a > 1) {
      const int mid = (a + b) / 2;
      if (Hkv * s_pref[mid] <= u) a = mid; else b = mid;
    }
    const int w = a, cw = s_pref[w + 1] - s_pref[w];
    const int first = Hkv * s_pref[w];  // the lane's first unit
    const int hk = (u - first) / cw, ci = (u - first) % cw;
    const int lo = ci * chunk;
    const int hi = min(s_n[w] - 1, lo + chunk - 1);  // the last slot this unit reads
    const int p0 = lo / bs, np = hi / bs - p0 + 1;
    // The previous unit is done with the table and the rings; its merge's
    // stores there are ordered before the copies that refill them.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    for (int i = threadIdx.x; i < np; i += NWARPS * 32)
      s_tbl[i] = min(max(tables[static_cast<size_t>(w) * MB + p0 + i], 0), nblocks - 1);
    __syncthreads();

    const int n_tiles = (hi - lo) / TS + 1;
    const int mine = warp < n_tiles ? (n_tiles - warp + NWARPS - 1) / NWARPS : 0;
    // Tile i of this warp (unit tile warp + i * NWARPS) into its stage: lane
    // j copies slot j's K row and V row.
    auto issue = [&](int i) {
      const int s0 = lo + (warp + i * NWARPS) * TS, s1 = min(hi, s0 + TS - 1);
      const int st = (used + i) % NST;
      if (lane == 0) mbar_expect_tx(bar(st), (s1 - s0 + 1) * 2 * G::ROW);
      __syncwarp();
      const int s = s0 + lane;
      if (lane < TS && s <= s1) {
        const int page = s / bs;
        const size_t off = ((static_cast<size_t>(s_tbl[page - p0]) * Hkv + hk) * bs +
                            (s - page * bs)) * D;
        const uint32_t dst = ring + st * G::STAGE + lane * G::PITCH;
        bulk_copy(dst, kpool + off, G::ROW, bar(st));
        bulk_copy(dst + TS * G::PITCH, vpool + off, G::ROW, bar(st));
      }
    };
    for (int i = 0; i < min(NST, mine); ++i) issue(i);
    ws.init(q + (static_cast<size_t>(w) * H + hk * REP) * D, lane);
    for (int i = 0; i < mine; ++i) {
      const int st = (used + i) % NST;
      mbar_wait(bar(st), ((used + i) / NST) & 1);
      const int s0 = lo + (warp + i * NWARPS) * TS;
      ws.tile(ring + st * G::STAGE, ring_gen + st * G::STAGE, min(hi - s0 + 1, TS), lane,
              scale_log2);
      __syncwarp();  // every lane is done with the stage
      if (i + NST < mine) issue(i + NST);
    }
    used += mine;

    // The warps merge through shared memory over the drained rings.
    __syncthreads();
    float* const sm_acc = reinterpret_cast<float*>(smem);  // [NWARPS][REP][D]
    float* const sm_m = sm_acc + NWARPS * REP * D;          // [NWARPS][REP]
    float* const sm_l = sm_m + NWARPS * REP;
    ws.store(sm_m + warp * REP, sm_l + warp * REP, sm_acc + warp * REP * D, lane);
    __syncthreads();
    for (int idx = threadIdx.x; idx < REP * D; idx += NWARPS * 32) {
      const int r = idx / D, d = idx % D;
      float mx = NEG_INF;
#pragma unroll
      for (int wi = 0; wi < NWARPS; ++wi) mx = fmaxf(mx, sm_m[wi * REP + r]);
      float lsum = 0.f, asum = 0.f;
#pragma unroll
      for (int wi = 0; wi < NWARPS; ++wi) {
        const float a_w = exp2f(sm_m[wi * REP + r] - mx);
        lsum += sm_l[wi * REP + r] * a_w;
        asum += sm_acc[(wi * REP + r) * D + d] * a_w;
      }
      if (cw == 1) {
        out[(static_cast<size_t>(w) * H + hk * REP + r) * D + d] =
            V::cast(asum / fmaxf(lsum, 1e-30f));
      } else {
        part[(static_cast<size_t>(u) * REP + r) * D + d] = asum;
        if (d == 0) {
          part_m[static_cast<size_t>(u) * REP + r] = mx;
          part_l[static_cast<size_t>(u) * REP + r] = lsum;
        }
      }
    }
    if (cw == 1) continue;
    // The last of the lane's units (for this kv head) to arrive merges its
    // partials in unit order.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      int* const cnt = counters + static_cast<size_t>(w) * Hkv + hk;
      s_last = atomicAdd(cnt, 1) == cw - 1;
      if (s_last) atomicExch(cnt, 0);  // zero again for the next call
    }
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    // In batches of units: their (m, l) read once into shared memory, each
    // row's running max and sum and the units' weights, then each thread's
    // E output elements summed over the batch with the loads of 8 units in
    // flight.
    const int u0 = first + hk * cw;
    float* const sw = reinterpret_cast<float*>(smem);  // [batch][REP] m -> weight, then l
    float asum[E];
#pragma unroll
    for (int e = 0; e < E; ++e) asum[e] = 0.f;
    if (threadIdx.x < REP) {
      s_mx[threadIdx.x] = NEG_INF;
      s_ls[threadIdx.x] = 0.f;
    }
    for (int b0 = 0; b0 < cw; b0 += G::MERGE_UNITS) {
      const int nb = min(G::MERGE_UNITS, cw - b0);
      __syncthreads();  // the previous batch's weights are used
      for (int j = threadIdx.x; j < nb * REP; j += NWARPS * 32) {
        sw[j] = __ldcg(part_m + static_cast<size_t>(u0 + b0) * REP + j);
        sw[nb * REP + j] = __ldcg(part_l + static_cast<size_t>(u0 + b0) * REP + j);
      }
      __syncthreads();
      if (threadIdx.x < REP) {
        const int r = threadIdx.x;
        float bm = s_mx[r];
        for (int i = 0; i < nb; ++i) bm = fmaxf(bm, sw[i * REP + r]);
        const float alpha = exp2f(s_mx[r] - bm);
        float ls = s_ls[r] * alpha;
        for (int i = 0; i < nb; ++i) {
          const float wt = exp2f(sw[i * REP + r] - bm);
          ls += sw[nb * REP + i * REP + r] * wt;
          sw[i * REP + r] = wt;
        }
        s_mx[r] = bm;
        s_ls[r] = ls;
        s_alpha[r] = alpha;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = threadIdx.x + e * NWARPS * 32;
        if (idx < REP * D) asum[e] *= s_alpha[idx / D];
      }
      for (int i0 = 0; i0 < nb; i0 += 8) {
        float v[8][E];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int idx = threadIdx.x + e * NWARPS * 32;
            v[i][e] = i0 + i < nb && idx < REP * D
                          ? __ldcg(part + static_cast<size_t>(u0 + b0 + i0 + i) * REP * D + idx)
                          : 0.f;
          }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int idx = threadIdx.x + e * NWARPS * 32;
            if (i0 + i < nb && idx < REP * D) asum[e] += v[i][e] * sw[(i0 + i) * REP + idx / D];
          }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = threadIdx.x + e * NWARPS * 32;
      if (idx < REP * D)
        out[(static_cast<size_t>(w) * H + hk * REP) * D + idx] =
            V::cast(asum[e] / fmaxf(s_ls[idx / D], 1e-30f));
    }
  }
}

template <typename T, int D, int REP>
int launch_one(const void* q, const void* k, const void* v, const int* tables,
               const int* positions, void* out, float* part, int* counters, int W, int H,
               int Hkv, int bs, int MB, int nblocks, int grid, int target, int max_units,
               float scale_log2, cudaStream_t stream) {
  using G = Geom<T, D, REP>;
  auto kernel = paged_kernel<T, D, REP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           G::smem(MAX_LANES));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kernel<<<grid, NWARPS * 32, G::smem(W), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      positions, static_cast<T*>(out), part, counters, W, H, Hkv, bs, MB, nblocks, target,
      max_units, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_rep(const void* q, const void* k, const void* v, const int* tables,
               const int* positions, void* out, float* part, int* counters, int W, int H,
               int Hkv, int bs, int MB, int nblocks, int grid, int target, int max_units,
               float scale_log2, cudaStream_t stream) {
#define PAGED_LAUNCH(REP)                                                                      \
  return launch_one<T, D, REP>(q, k, v, tables, positions, out, part, counters, W, H, Hkv, bs, \
                               MB, nblocks, grid, target, max_units, scale_log2, stream)
  switch (H / Hkv) {
    case 1:
      PAGED_LAUNCH(1);
    case 2:
      PAGED_LAUNCH(2);
    case 4:
      PAGED_LAUNCH(4);
    case 8:
      PAGED_LAUNCH(8);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_LAUNCH
}

}  // namespace

// q [W, 1, H, D], pools [nblocks, Hkv, bs, D], tables [W, MB] int32,
// positions [W] int32, out [W, 1, H, D]; q, pools and out contiguous,
// 16-byte aligned and of one dtype (is_bf16 ? bf16 : f32).  Lane w attends
// slots 0..positions[w] through its table.  ``grid`` blocks plan about
// ``target`` units of work from the positions (see the header); ``part`` is
// f32 scratch of max_units * (H / Hkv) * (D + 2) values, where max_units
// bounds the units any positions can give (ops/decode_attention.py,
// paged_plan); ``counters`` holds W * Hkv ints that are zero on entry and
// are zero again on return.  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for an unsupported shape.
extern "C" int paged_attention(const void* q, const void* k, const void* v, const void* tables,
                               const void* positions, void* out, void* part, void* counters,
                               int W, int H, int Hkv, int D, int bs, int MB, int nblocks,
                               int grid, int target, int max_units, int is_bf16,
                               float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W < 1 || W > MAX_LANES || Hkv < 1 || H % Hkv || bs < 1 || MB < 1 || nblocks < 1 ||
      grid < 1 || target < 1 || max_units < 1 || part == nullptr || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(tables);
  const int* pp = static_cast<const int*>(positions);
  float* wp = static_cast<float*>(part);
  int* cp = static_cast<int*>(counters);
#define PAGED_D(T, DIM)                                                                     \
  if (D == DIM)                                                                             \
  return launch_rep<T, DIM>(q, k, v, tp, pp, out, wp, cp, W, H, Hkv, bs, MB, nblocks, grid, \
                            target, max_units, scale_log2, s)
  if (is_bf16) {
    PAGED_D(__nv_bfloat16, 32);
    PAGED_D(__nv_bfloat16, 64);
    PAGED_D(__nv_bfloat16, 128);
  } else {
    PAGED_D(float, 32);
    PAGED_D(float, 64);
    PAGED_D(float, 128);
  }
#undef PAGED_D
  return static_cast<int>(cudaErrorInvalidValue);
}
