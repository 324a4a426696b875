// Blocked online-softmax GQA attention (prefill) on Hopper's tensor cores, sm_90a.
//
// Replaces the TPU kernel `_attn_kernel` in
// src/repro/kernels/flash_attention/kernel.py (reached through
// `flash_attention_raw`) for bf16 q/k/v at d_head 64 and 128, the serve
// paths' case. Same function: q (B,S,H,dh), k/v (B,S,K,dh), kv head h / (H/K),
// causal and sliding-window masks, f32 softmax statistics and accumulation,
// fully masked rows give 0, alpha guarded at -inf. It normalizes in-kernel and
// writes (B,S,H,dh) bf16, and takes any S >= 1. (flash_attention.cu, the SIMT
// kernel, serves f32 and d_head 32.)
//
// What bounds it: prefill attention does 4*dh FLOPs per visible (query, key)
// pair against 2*dh*2 bytes per key row, so at S >= 1k it is bound by the
// tensor cores' bf16 rate, reached on Hopper only through `wgmma`. Design:
// * one CTA per (128 query rows, head, batch): two consumer warpgroups of 64
//   rows each and a producer warpgroup whose one thread issues every copy;
// * copies by TMA (4-D tensor maps over (dh, heads, S, B)) into 128-byte
//   swizzled shared memory, the layout the wgmma descriptors read: Q once,
//   K and V tiles of 128 rows into a 2-stage ring, K and V each guarded by
//   their own mbarriers ("full": the copy landed; "empty": both consumers
//   are done with it), so a K tile is released as soon as its scores are.
//   TMA fills rows past S with zeros; the ragged last tile is masked;
// * S = Q K^T: wgmma m64n128k16, both operands in shared memory (K-major),
//   f32 accumulators in registers. The online softmax runs on that fragment
//   in registers (each thread holds 2 rows; row max / sum are quad
//   shuffles). P is rounded to bf16 in registers, where the accumulator
//   layout already is wgmma's register A layout, and O += P V runs as
//   wgmma m64n{dh}k16 with V read from shared memory as an MN-major B
//   (the transpose bit), so V is never transposed;
// * each consumer runs S = Q K^T, its softmax and O += P V in turn; the two
//   consumers' warps interleave on the SM, so one's softmax can run under
//   the other's products (nothing forces it: the softmax is what holds the
//   kernel below the tensor cores' rate, see PERF.md);
// * kv tiles that the causal or window mask hides from every row of the CTA
//   are never loaded, and only tiles that cross the diagonal, the window's
//   edge or S are masked element by element. The heaviest q tiles launch
//   first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;     // threads of a warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();  // a lost arrival: fail the launch, never hang the card
  }
}

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle. For a K-major operand
// the start steps 32 bytes per k16 slice inside a 128-byte row and `sbo` is
// the stride of 8-row groups (1024 bytes); for an MN-major one `lbo` is the
// stride between 64-element blocks along MN and `sbo` that of 8-row groups
// along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving register reads or writes across an async
// wgmma that owns these registers.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 128, f32) {+}= A (64 x 16, smem) * B (16 x 128, smem); both K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) {+}= A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {+}= A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n128k16_rs(o, a, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n64k16_rs(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0; tiny results flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ kernel

template <int DH>
struct Cfg {
  static constexpr int BK = 128;              // key rows per kv tile
  static constexpr int STAGES = 2;            // depth of the K/V ring
  static constexpr int NCONS = 2;             // consumer warpgroups
  static constexpr int BQ = 64 * NCONS;       // query rows per CTA
  static constexpr int Q_REGION = BQ * 128;   // 64 columns of Q, 128 bytes a row
  static constexpr int KV_REGION = BK * 128;  // 64 columns of a K or V tile
  static constexpr int Q_BYTES = (DH / 64) * Q_REGION;
  static constexpr int TILE_BYTES = (DH / 64) * KV_REGION;
  static constexpr int THREADS = WG + NCONS * WG;  // the producer warpgroup, then the consumers
  // 1024 bytes of alignment slack, Q, the K and V rings, the mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * TILE_BYTES + 8 * (1 + 4 * STAGES);
  static_assert(SMEM <= 232448, "over the 227 KB a block can use");
  static_assert(DH == 64 || DH == 128, "d_head 64 or 128");
};

struct Tiles {
  int h, kh, b, q0, kv_begin, n_tiles;
};

// Shared memory of a CTA: Q, the K and V rings, and their mbarriers ("full":
// the copy landed; "empty": every consumer warp is done with the stage).
struct Smem {
  uint8_t* q;
  uint8_t* k;
  uint8_t* v;
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* k_empty;
  uint64_t* v_empty;
};

// Issued by one thread: Q of the CTA (one box per 64 columns).
template <int DH>
__device__ __forceinline__ void load_q(const CUtensorMap* tq, const Smem& sm, const Tiles& t) {
  using C = Cfg<DH>;
  mbar_expect_tx(sm.q_full, C::Q_BYTES);
#pragma unroll
  for (int c = 0; c < DH / 64; ++c)
    tma_load_4d(sm.q + c * C::Q_REGION, tq, sm.q_full, 64 * c, t.h, t.q0, t.b);
}

// Issued by one thread: K, then V, of kv tile `i` into ring stage i % STAGES,
// each once the consumers have released that stage's previous tile.
template <int DH>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        const Smem& sm, const Tiles& t, int i) {
  using C = Cfg<DH>;
  constexpr int STAGES = C::STAGES, BK = C::BK;
  const int s = i % STAGES, k0 = t.kv_begin + i * BK;
  if (i >= STAGES) mbar_wait(&sm.k_empty[s], (i / STAGES - 1) & 1);
  mbar_expect_tx(&sm.k_full[s], C::TILE_BYTES);
#pragma unroll
  for (int c = 0; c < DH / 64; ++c)
    tma_load_4d(sm.k + s * C::TILE_BYTES + c * C::KV_REGION, tk, &sm.k_full[s], 64 * c, t.kh, k0, t.b);
  if (i >= STAGES) mbar_wait(&sm.v_empty[s], (i / STAGES - 1) & 1);
  mbar_expect_tx(&sm.v_full[s], C::TILE_BYTES);
#pragma unroll
  for (int c = 0; c < DH / 64; ++c)
    tma_load_4d(sm.v + s * C::TILE_BYTES + c * C::KV_REGION, tv, &sm.v_full[s], 64 * c, t.kh, k0, t.b);
}

// One consumer warpgroup: 64 query rows from `qa`; this thread's rows are r0
// and r0 + 8, its columns 8j + 2 * (lane & 3) + {0, 1} of each n8 block j.
template <int DH>
struct Consumer {
  using C = Cfg<DH>;
  static constexpr int BK = C::BK;
  const Smem& sm;
  int wg, lane, qa, r0;
  int S, causal, window;
  float scale_log2;
  float o[DH / 2];
  float m[2], l[2], alpha[2];
  uint32_t pa[BK / 16][4];

  // S = Q K^T of the tile in stage s, 64 x 128 f32 in `sc`; issued, not waited for.
  __device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], int s) {
    reg_fence(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint64_t da =
          sw128_desc(sm.q + (kk / 4) * C::Q_REGION + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          sw128_desc(sm.k + s * C::TILE_BYTES + (kk / 4) * C::KV_REGION + (kk % 4) * 32, 16, 1024);
      wgmma_m64n128k16_ss(sc, da, db, kk > 0);
    }
    wg_commit();
  }
  // O += P V with V of stage s, an MN-major B (dh contiguous); issued, not waited for.
  __device__ __forceinline__ void issue_pv(int s) {
    reg_fence(pa);
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DH>(o, pa[kk], sw128_desc(sm.v + s * C::TILE_BYTES + kk * 16 * 128, C::KV_REGION, 1024));
    wg_commit();
  }
  // Scores of kv tile k0 -> exp2 weights in place; updates m, l and this tile's alpha.
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], int k0) {
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qa) ||
                      (window && qa + 63 - k0 >= window);
    if (edge) {  // only tiles across the diagonal, the window's edge or S
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int row = r0 + 8 * ((e >> 1) & 1);
        const int col = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window) ok = ok && row - col < window;
        if (!ok) sc[e] = -INFINITY;
      }
    }
    // online softmax on the fragment (log2 domain: x = s * scale * log2 e)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = m[r] == -INFINITY ? 0.f : fast_exp2(m[r] - m_new);
      mb[r] = m_new == -INFINITY ? 0.f : m_new;
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      sc[e] = fast_exp2(fmaf(sc[e], scale_log2, -mb[r]));
      rs[r] += sc[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // quad-reduced at the end
  }
  // P in bf16: the accumulator layout of two n8 blocks is the A layout of one k16 slice.
  __device__ __forceinline__ void to_p(const float (&sc)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
  }
  __device__ __forceinline__ void release(uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // this warp is done with the stage
  }
  __device__ __forceinline__ void store(__nv_bfloat16* out, const Tiles& t, int H) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* dst =
          out + ((static_cast<size_t>(t.b) * S + row) * H + t.h) * DH + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
};

// grid (H, ceil(S / BQ), B).
template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, 1)
attn_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int S, int H,
           int K, int causal, int window, float scale_log2) {
  using C = Cfg<DH>;
  constexpr int NCONS = C::NCONS, STAGES = C::STAGES, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  Smem sm;
  sm.q = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  sm.k = sm.q + C::Q_BYTES;
  sm.v = sm.k + STAGES * C::TILE_BYTES;
  sm.q_full = reinterpret_cast<uint64_t*>(sm.v + STAGES * C::TILE_BYTES);
  sm.k_full = sm.q_full + 1;
  sm.v_full = sm.k_full + STAGES;
  sm.k_empty = sm.v_full + STAGES;
  sm.v_empty = sm.k_empty + STAGES;

  Tiles t;
  t.h = blockIdx.x;
  t.b = blockIdx.z;
  t.kh = t.h / (H / K);
  t.q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // the heaviest (causal) tiles launch first
  const int kv_end = causal ? min(S, t.q0 + C::BQ) : S;
  t.kv_begin = window ? max(0, t.q0 - window + 1) / BK * BK : 0;
  t.n_tiles = (kv_end - t.kv_begin + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], NCONS * 4);  // one arrival per consumer warp
      mbar_init(&sm.v_empty[s], NCONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG) {
    // ---------------------------------------------------------- producer
    if (tid == 0) {
      load_q<DH>(&tq, sm, t);
      for (int i = 0; i < t.n_tiles; ++i) load_kv<DH>(&tk, &tv, sm, t, i);
    }
  } else {
    // --------------------------------------------------------- consumers
    const int ctid = tid - WG;
    Consumer<DH> cs{sm};
    cs.wg = ctid / WG;
    cs.lane = tid & 31;
    cs.qa = t.q0 + 64 * cs.wg;                                 // first row of this warpgroup
    cs.r0 = cs.qa + 16 * ((ctid % WG) / 32) + cs.lane / 4;     // this thread's rows: r0, r0 + 8
    cs.S = S;
    cs.causal = causal;
    cs.window = window;
    cs.scale_log2 = scale_log2;
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) cs.o[e] = 0.f;
    cs.m[0] = cs.m[1] = -INFINITY;
    cs.l[0] = cs.l[1] = 0.f;
    mbar_wait(sm.q_full, 0);
    float sc[BK / 2];

    for (int i = 0; i < t.n_tiles; ++i) {
      const int s = i % STAGES, ph = (i / STAGES) & 1;
      mbar_wait(&sm.k_full[s], ph);
      cs.issue_qk(sc, s);
      wg_wait<0>();
      reg_fence(sc);
      cs.release(&sm.k_empty[s]);  // K is free as soon as its scores are in registers
      cs.softmax(sc, t.kv_begin + i * BK);
      cs.rescale();
      cs.to_p(sc);
      mbar_wait(&sm.v_full[s], ph);
      cs.issue_pv(s);
      wg_wait<0>();
      reg_fence(cs.o);
      cs.release(&sm.v_empty[s]);
    }
    cs.store(out, t, H);
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so
// nothing links against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, heads, dh) bf16 as a 4-D tensor map {dh, heads, S, B}; boxes of 64
// columns x `rows` rows of one head, 128-byte swizzled; rows past S read 0.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int dh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {dh * e, heads * dh * e, (cuuint64_t)S * heads * dh * e};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int K,
           int causal, int window, float scale_log2, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap tq, tk, tv;
  int rc = tensor_map(&tq, q, B, S, H, DH, C::BQ);
  if (rc == 0) rc = tensor_map(&tk, k, B, S, K, DH, C::BK);
  if (rc == 0) rc = tensor_map(&tv, v, B, S, K, DH, C::BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(attn_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (S + C::BQ - 1) / C::BQ, B);
  attn_wgmma<DH><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, H, K, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes): bf16 q, k, v, out, contiguous and
// 16-byte aligned; dh 64 or 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* out,
                                         int B, int S, int H, int K, int dh, int causal,
                                         int window, float scale, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float sl2 = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128) return launch<128>(q, k, v, out, B, S, H, K, causal, window, sl2, st);
  if (dh == 64) return launch<64>(q, k, v, out, B, S, H, K, causal, window, sl2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
