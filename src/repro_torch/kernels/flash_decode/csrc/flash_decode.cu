// One-token GQA attention against a ring-buffer KV cache (decode) for Hopper,
// sm_90a, in one launch.
//
// Replaces the TPU kernel `_decode_kernel` in
// src/repro/kernels/flash_decode/kernel.py (reached through
// `flash_decode_raw`). Same function: q (B,1,H,dh), caches (B,S,K,dh),
// cache_len (B,) int32; slot j is valid iff j < min(cache_len[b], S); online
// softmax in f32; a row with no valid slot gives 0, as num / max(den, 1e-30)
// does there. It takes any cache length S (the TPU wrapper needs S % 256 == 0).
//
// What bounds it: at serving batch (B <= 8) every valid cache byte is read
// once for about one FLOP, so decode attention is bound by the bytes of the
// valid K and V rows: 20-40 MB at the serve paths' shapes, 6-12 us of HBM
// time. Short of that, latency (a second launch, dependent loads, barriers)
// and instruction issue decide the time. Design:
// * one CTA per (split, head chunk, kv head, batch row) serves a chunk of up
//   to CHUNK = 8 of the G = H/K query heads of its kv head from one pass over
//   its K and V rows. At G <= 8 there is one chunk and each cache byte leaves
//   device memory once; at larger G (multi-query attention: G = 48 at
//   granite-20b) the G/8 chunks of a kv head run side by side and re-read
//   the same K/V tiles, mostly from L2 (a layer's whole cache at granite's
//   serve shape is 8.65 MB of the 50 MB);
// * the grid is sized on the host from S and the SM count alone; each CTA
//   reads valid = min(cache_len[b], S) on the device and takes its even share
//   of the valid slots, so long and short rows both spread over every split
//   and no host plan depends on cache_len;
// * K and V tiles of 64 slots stream through a 2-stage cp.async ring of
//   16-byte copies guarded by mbarriers: "full" completes when every thread's
//   copies of a tile have landed, "empty" when every warp is done with it, so
//   the next tile is in flight while the current one is scored and no
//   CTA-wide barrier runs per tile. q and cache_len are loaded first. Shared
//   rows are padded by 16 bytes so 8 consecutive rows hit distinct banks;
// * bf16 (the serve paths): the products run on the tensor cores
//   (mma.sync m16n8k16, f32 accumulate) with the chunk's heads as the rows of A =
//   q, so scoring a tile costs a few dozen instructions a warp instead of
//   thousands of FMAs and unpacks. Each of 4 warps takes 16 slots of every
//   tile with its own softmax state in registers; P feeds the P V product
//   from the score fragment as two bf16 terms (hi + lo), so the weights are
//   nearly as exact as in f32; the warps merge in shared memory at the end. float32 keeps f32 products: one warp per query head,
//   lane-per-slot scores, lane-per-column numerators;
// * every CTA writes an un-normalized partial (num, m, l). The last CTA of
//   each (b, kv head, chunk) to finish, found by a counter that it resets itself,
//   merges the partials in split order (each (m, l) and numerator chunk of up
//   to 16 splits loaded at once, not in a dependent chain), so there is no
//   second launch and no gap, and the result is the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // cache slots per ring stage
constexpr int STAGES = 2;  // depth of the K/V ring
constexpr int CHUNK = 8;   // query heads one CTA serves (of the G of its kv head)
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// The barrier counts one arrival when all of this thread's earlier cp.async copies land.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
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
// 16 bytes global -> shared; the first `src_bytes` (16 or 0) are read, the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// ------------------------------------------------------------------ ring

// K/V tiles of one (b, kv head) slice of the caches, staged through a ring of
// STAGES shared buffers by all NT threads with 16-byte cp.async copies. Rows
// past the tile's n are zero-filled (no global read), so a product over the
// whole tile stays finite.
template <typename T, int DH, int NT>
struct Ring {
  static constexpr int VEC = 16 / sizeof(T);            // elements per 16-byte chunk
  static constexpr int NCH = DH / VEC;                  // chunks per cache row
  static constexpr int ROW = DH * sizeof(T) + 16;       // padded shared row, bytes
  static constexpr int TILE_BYTES = TILE * ROW;         // one K or V tile
  static constexpr int COPIES = 2 * TILE * NCH / NT;    // copies per thread per tile
  static_assert(2 * TILE * NCH % NT == 0, "a tile does not split evenly over the threads");
  static constexpr size_t BYTES = 2 * STAGES * TILE_BYTES;

  uint8_t* sK;
  uint8_t* sV;
  uint64_t* full;
  uint64_t* empty;
  const T* kc;
  const T* vc;
  size_t row0;    // element offset of slot 0 of this (b, kv head)
  size_t stride;  // elements between slots
  int s_begin, s_end;

  __device__ void init(int nwarps) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], NT);       // every thread's copies of the tile
        mbar_init(&empty[s], nwarps);  // every warp done with it
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  __device__ int rows(int i) const { return min(TILE, s_end - (s_begin + i * TILE)); }
  __device__ void load(int i) {
    const int s = i % STAGES, s0 = s_begin + i * TILE, n = rows(i);
#pragma unroll
    for (int u = 0; u < COPIES; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int which = idx / (TILE * NCH), rem = idx - which * (TILE * NCH);
      const int r = rem / NCH, c = rem - r * NCH;
      const T* src = (which ? vc : kc) + row0 + (size_t)(s0 + min(r, n - 1)) * stride + c * VEC;
      cp_async16((which ? sV : sK) + s * TILE_BYTES + r * ROW + c * 16, src, r < n ? 16 : 0);
    }
    mbar_arrive_on_copies(&full[s]);
  }
  __device__ void wait_full(int i) { mbar_wait(&full[i % STAGES], (i / STAGES) & 1); }
  // A warp is done with tile i; once every warp is, tile i + STAGES takes its place.
  __device__ void release(int i, int n_tiles) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[i % STAGES]);
    if (i + STAGES < n_tiles) {
      mbar_wait(&empty[i % STAGES], (i / STAGES) & 1);
      load(i + STAGES);
    }
  }
};

// ----------------------------------------------------------------- merge

// Each CTA has written its partials (num, m, l for heads h0 .. h0 + gc - 1).
// The last CTA of (b, kv head, chunk) -- counter `slot` -- to get here merges
// them in split order and writes out; the others return. Each thread merges one 4-column chunk of one head: the (m, l)
// and the chunk of up to MERGE_BATCH partials are loaded at once, then summed
// with weights exp2(m_s - max m), rescaled batch to batch.
constexpr int MERGE_BATCH = 16;
template <typename T, int DH, int NT>
__device__ void merge_if_last(const float* __restrict__ part_num,
                              const float* __restrict__ part_ml, int* __restrict__ counters,
                              T* __restrict__ out, int* s_last, int b, int h0, int gc, int H,
                              int slot, int n_split) {
  const int tid = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(counters + slot, 1) == n_split - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (tid == 0) counters[slot] = 0;  // ready for the next launch on this stream

  constexpr int C4 = DH / 4;  // float4 chunks of a head's numerator
  for (int idx = tid; idx < gc * C4; idx += NT) {
    const int g = idx / C4, c = idx - g * C4;
    const size_t p0 = ((size_t)b * H + h0 + g) * n_split;
    float mx = -INFINITY, den = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += MERGE_BATCH) {
      float2 ml[MERGE_BATCH];
      float4 v[MERGE_BATCH];
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) {
        const bool in = s0 + u < n_split;
        ml[u] = in ? __ldcg(reinterpret_cast<const float2*>(part_ml + 2 * (p0 + s0 + u)))
                   : make_float2(-INFINITY, 0.f);
        v[u] = in ? __ldcg(reinterpret_cast<const float4*>(part_num + (p0 + s0 + u) * DH) + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float bm = mx;
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) bm = fmaxf(bm, ml[u].x);
      const float r = mx == -INFINITY ? 0.f : exp2f(mx - bm);  // earlier batches to the new max
      den *= r;
      acc.x *= r, acc.y *= r, acc.z *= r, acc.w *= r;
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) {
        const float w = ml[u].x == -INFINITY ? 0.f : exp2f(ml[u].x - bm);  // empty share: 0
        den = fmaf(w, ml[u].y, den);
        acc.x = fmaf(w, v[u].x, acc.x);
        acc.y = fmaf(w, v[u].y, acc.y);
        acc.z = fmaf(w, v[u].z, acc.z);
        acc.w = fmaf(w, v[u].w, acc.w);
      }
      mx = bm;
    }
    den = fmaxf(den, 1e-30f);
    T* dst = out + ((size_t)b * H + h0 + g) * DH + 4 * c;
    dst[0] = from_f<T>(acc.x / den);
    dst[1] = from_f<T>(acc.y / den);
    dst[2] = from_f<T>(acc.z / den);
    dst[3] = from_f<T>(acc.w / den);
  }
}

// The query heads of this CTA: blockIdx.y = kv head * n_chunk + chunk.
struct Heads {
  int kh, h0, gc;  // kv head, first query head, heads in the chunk (1 .. CHUNK)
};
__device__ __forceinline__ Heads heads(int H, int K) {
  const int G = H / K, n_chunk = (G + CHUNK - 1) / CHUNK;
  const int kh = blockIdx.y / n_chunk, c = blockIdx.y - kh * n_chunk;
  return {kh, kh * G + c * CHUNK, min(CHUNK, G - c * CHUNK)};
}

// This CTA's even share of the row's valid slots.
__device__ __forceinline__ void share(int valid, int n_split, int* s_begin, int* s_end) {
  const int chunk = (valid + n_split - 1) / n_split;
  *s_begin = min(valid, (int)blockIdx.x * chunk);
  *s_end = min(valid, *s_begin + chunk);
}

// ------------------------------------------------------ bf16: tensor cores

constexpr int MMA_WARPS = 4;  // each takes 16 slots of every tile
constexpr int MMA_NT = 32 * MMA_WARPS;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d (rows 0-7 of a 16 x 8 f32 tile) += A (16 x 16 bf16) B (16 x 8 bf16). Rows
// 8-15 of A are zero here (at most CHUNK = 8 heads), so rows 8-15 of D are dropped.
__device__ __forceinline__ void mma_bf16(float (&d)[2], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%10, %11, %12, %12};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]),
        "f"(0.f));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (n_split, K * n_chunk, B), MMA_NT threads. Thread layout of a warp's fragments:
// head hr = lane / 4 (the row), slot or column pair 2 * (lane % 4) + {0, 1}.
template <int DH>
__global__ void __launch_bounds__(MMA_NT)
decode_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
           const __nv_bfloat16* __restrict__ vc, const int* __restrict__ cache_len,
           float* __restrict__ part_num, float* __restrict__ part_ml, int* __restrict__ counters,
           __nv_bfloat16* __restrict__ out, int S, int H, int K, int n_split, float scale_log2) {
  using R = Ring<__nv_bfloat16, DH, MMA_NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Heads hd = heads(H, K);
  const int kh = hd.kh, b = blockIdx.z, gc = hd.gc;
  const int hr = lane / 4, cp = 2 * (lane % 4);

  // q and cache_len first; q is the A operand, its rows the chunk's heads (rest 0)
  const int valid = min(__ldg(cache_len + b), S);
  uint32_t qa[DH / 16][4];
  {
    const uint32_t* qrow =
        reinterpret_cast<const uint32_t*>(q + ((size_t)b * H + hd.h0 + min(hr, gc - 1)) * DH);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      qa[kk][0] = hr < gc ? __ldg(qrow + (16 * kk + cp) / 2) : 0u;
      qa[kk][2] = hr < gc ? __ldg(qrow + (16 * kk + 8 + cp) / 2) : 0u;
      qa[kk][1] = qa[kk][3] = 0u;
    }
  }

  R ring;
  ring.sK = smem;
  ring.sV = smem + STAGES * R::TILE_BYTES;
  ring.full = reinterpret_cast<uint64_t*>(smem + R::BYTES);
  ring.empty = ring.full + STAGES;
  int* s_last = reinterpret_cast<int*>(ring.empty + STAGES);
  ring.kc = kc;
  ring.vc = vc;
  ring.row0 = ((size_t)b * S * K + kh) * DH;
  ring.stride = (size_t)K * DH;
  share(valid, n_split, &ring.s_begin, &ring.s_end);
  const int n_tiles = (ring.s_end - ring.s_begin + TILE - 1) / TILE;
  ring.init(MMA_WARPS);
  for (int i = 0; i < min(STAGES, n_tiles); ++i) ring.load(i);

  float m = -INFINITY, l = 0.f, o[DH / 8][2];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, nw = ring.rows(i) - 16 * warp;  // this warp's slots in the tile
    ring.wait_full(i);
    if (nw > 0) {
      // scores of slots 16*warp + 8j + cp + {0, 1} for head hr
      const uint8_t* kt = ring.sK + s * R::TILE_BYTES + 16 * warp * R::ROW;
      float c[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t kb[4];  // B fragments of slots 0-7 and 8-15, d 16kk .. 16kk+15
        ldmatrix_x4(kb, kt + (8 * ((lane >> 4) & 1) + (lane & 7)) * R::ROW +
                            (16 * kk + 8 * ((lane >> 3) & 1)) * 2);
        mma_bf16(c[0], qa[kk], kb[0], kb[1]);
        mma_bf16(c[1], qa[kk], kb[2], kb[3]);
      }
      float x[4], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = 8 * (e >> 1) + cp + (e & 1) < nw ? c[e >> 1][e & 1] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
      const float m_new = fmaxf(m, mx);  // finite: slot 0 of the window is valid
      const float alpha = m == -INFINITY ? 0.f : exp2f(m - m_new);
      float p[4], ps = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) ps += (p[e] = exp2f(x[e] - m_new));  // masked -> 0
      l = l * alpha + ps;  // this thread's columns; the quad is summed at the end
      m = m_new;
      // O += P V: P (heads x 16 slots) from the score fragment, V by ldmatrix.trans.
      // P = hi + lo, both bf16, so the weights keep about 16 bits (f32 P's error
      // of 2^-17 rather than bf16's 2^-9); the second product costs no bytes.
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = p[e] - __bfloat162float(__float2bfloat16(p[e]));
      const uint32_t pa[4] = {pack_bf16(p[0], p[1]), 0u, pack_bf16(p[2], p[3]), 0u};
      const uint32_t pl[4] = {pack_bf16(r[0], r[1]), 0u, pack_bf16(r[2], r[3]), 0u};
      const uint8_t* vt = ring.sV + s * R::TILE_BYTES + 16 * warp * R::ROW;
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t vb[4];  // B fragments of columns 16nd .. +7 and 16nd+8 .. +15
        ldmatrix_x4_trans(vb, vt + (8 * ((lane >> 3) & 1) + (lane & 7)) * R::ROW +
                                  (16 * nd + 8 * ((lane >> 4) & 1)) * 2);
        o[2 * nd][0] *= alpha, o[2 * nd][1] *= alpha;
        o[2 * nd + 1][0] *= alpha, o[2 * nd + 1][1] *= alpha;
        mma_bf16(o[2 * nd], pa, vb[0], vb[1]);
        mma_bf16(o[2 * nd], pl, vb[0], vb[1]);
        mma_bf16(o[2 * nd + 1], pa, vb[2], vb[3]);
        mma_bf16(o[2 * nd + 1], pl, vb[2], vb[3]);
      }
    }
    ring.release(i, n_tiles);
  }
  l += __shfl_xor_sync(FULL_MASK, l, 1);
  l += __shfl_xor_sync(FULL_MASK, l, 2);

  // merge the 4 warps' states in shared memory (the ring is free once all are done)
  __syncthreads();
  float* rm = reinterpret_cast<float*>(smem);  // [warp][head]
  float* rl = rm + MMA_WARPS * 8;
  float* ro = rl + MMA_WARPS * 8;              // [warp][head][DH]
  if (lane % 4 == 0) rm[warp * 8 + hr] = m, rl[warp * 8 + hr] = l;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    *reinterpret_cast<float2*>(ro + (warp * 8 + hr) * DH + 8 * j + cp) = make_float2(o[j][0], o[j][1]);
  __syncthreads();
  for (int idx = tid; idx < gc * DH; idx += MMA_NT) {
    const int g = idx / DH, d = idx - g * DH;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) mx = fmaxf(mx, rm[w * 8 + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float wt = rm[w * 8 + g] == -INFINITY ? 0.f : exp2f(rm[w * 8 + g] - mx);
      num = fmaf(wt, ro[(w * 8 + g) * DH + d], num);
      den = fmaf(wt, rl[w * 8 + g], den);
    }
    const size_t p = ((size_t)b * H + hd.h0 + g) * n_split + blockIdx.x;
    part_num[p * DH + d] = num;
    if (d == 0) part_ml[2 * p] = mx, part_ml[2 * p + 1] = den;
  }
  merge_if_last<__nv_bfloat16, DH, MMA_NT>(part_num, part_ml, counters, out, s_last, b, hd.h0,
                                           gc, H, b * gridDim.y + blockIdx.y, n_split);
}

// --------------------------------------------------- float32: FMA pipes

constexpr int SIMT_WARPS = CHUNK;  // warp g serves query head g of the chunk
constexpr int SIMT_NT = 32 * SIMT_WARPS;

// grid (n_split, K * n_chunk, B), SIMT_NT threads.
template <int DH>
__global__ void __launch_bounds__(SIMT_NT)
decode_simt(const float* __restrict__ q, const float* __restrict__ kc,
            const float* __restrict__ vc, const int* __restrict__ cache_len,
            float* __restrict__ part_num, float* __restrict__ part_ml, int* __restrict__ counters,
            float* __restrict__ out, int S, int H, int K, int n_split, float scale_log2) {
  using R = Ring<float, DH, SIMT_NT>;
  constexpr int EPL = DH / 32, NCH = R::NCH;  // numerator columns per lane; 4-float chunks a row
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const Heads hd = heads(H, K);
  const int kh = hd.kh, b = blockIdx.z;
  const bool has_head = g < hd.gc;

  // q and cache_len first
  const int valid = min(__ldg(cache_len + b), S);
  float qv[EPL];
  if (has_head) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[e] = __ldg(q + ((size_t)b * H + hd.h0 + g) * DH + lane * EPL + e);
  }

  R ring;
  ring.sK = smem;
  ring.sV = smem + STAGES * R::TILE_BYTES;
  float* sQ = reinterpret_cast<float*>(smem + R::BYTES);
  ring.full = reinterpret_cast<uint64_t*>(sQ + SIMT_WARPS * DH);
  ring.empty = ring.full + STAGES;
  int* s_last = reinterpret_cast<int*>(ring.empty + STAGES);
  ring.kc = kc;
  ring.vc = vc;
  ring.row0 = ((size_t)b * S * K + kh) * DH;
  ring.stride = (size_t)K * DH;
  share(valid, n_split, &ring.s_begin, &ring.s_end);
  const int n_tiles = (ring.s_end - ring.s_begin + TILE - 1) / TILE;
  ring.init(SIMT_WARPS);
  for (int i = 0; i < min(STAGES, n_tiles); ++i) ring.load(i);

  if (has_head) {  // q, pre-scaled into the log2 domain, for this warp's scores
#pragma unroll
    for (int e = 0; e < EPL; ++e) sQ[g * DH + lane * EPL + e] = qv[e] * scale_log2;
  }
  __syncwarp();

  float m = -INFINITY, l = 0.f, o[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) o[e] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, n = ring.rows(i);
    ring.wait_full(i);
    if (has_head) {
      // scores: lane owns slots lane and lane + 32 of the tile
      const uint8_t* kt = ring.sK + s * R::TILE_BYTES;
      const float* qh = sQ + g * DH;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int c = 0; c < NCH; ++c) {
        const float4 k0 = *reinterpret_cast<const float4*>(kt + lane * R::ROW + c * 16);
        const float4 k1 = *reinterpret_cast<const float4*>(kt + (lane + 32) * R::ROW + c * 16);
        const float4 qq = *reinterpret_cast<const float4*>(qh + 4 * c);
        a0 = fmaf(qq.x, k0.x, a0), a1 = fmaf(qq.x, k1.x, a1);
        a0 = fmaf(qq.y, k0.y, a0), a1 = fmaf(qq.y, k1.y, a1);
        a0 = fmaf(qq.z, k0.z, a0), a1 = fmaf(qq.z, k1.z, a1);
        a0 = fmaf(qq.w, k0.w, a0), a1 = fmaf(qq.w, k1.w, a1);
      }
      const float x0 = lane < n ? a0 : -INFINITY, x1 = lane + 32 < n ? a1 : -INFINITY;
      const float m_new = fmaxf(m, warp_max(fmaxf(x0, x1)));  // finite: n >= 1
      const float alpha = m == -INFINITY ? 0.f : exp2f(m - m_new);
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);  // masked -> 0
      l = l * alpha + warp_sum(p0 + p1);
      m = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[e] *= alpha;
      // numerator: lane owns columns lane*EPL .. lane*EPL + EPL of every V row
      const float* vt = reinterpret_cast<const float*>(ring.sV + s * R::TILE_BYTES) + lane * EPL;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(FULL_MASK, j < 32 ? p0 : p1, j & 31);
        const float* vr = vt + j * (R::ROW / 4);
#pragma unroll
        for (int e = 0; e < EPL; ++e) o[e] = fmaf(pj, vr[e], o[e]);
      }
    }
    ring.release(i, n_tiles);
  }

  if (has_head) {  // this CTA's partial of head g (zeros and m = -inf for an empty share)
    const size_t p = ((size_t)b * H + hd.h0 + g) * n_split + blockIdx.x;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part_num[p * DH + lane * EPL + e] = o[e];
    if (lane == 0) part_ml[2 * p] = m, part_ml[2 * p + 1] = l;
  }
  merge_if_last<float, DH, SIMT_NT>(part_num, part_ml, counters, out, s_last, b, hd.h0, hd.gc,
                                    H, b * gridDim.y + blockIdx.y, n_split);
}

// --------------------------------------------------------------- launches

template <int DH>
size_t mma_smem() { return Ring<__nv_bfloat16, DH, MMA_NT>::BYTES + 2 * STAGES * 8 + 16; }
template <int DH>
size_t simt_smem() {
  return Ring<float, DH, SIMT_NT>::BYTES + 4 * SIMT_WARPS * DH + 2 * STAGES * 8 + 16;
}

template <int DH>
int launch(int dtype, const void* q, const void* kc, const void* vc, const int* lens, float* num,
           float* ml, int* cnt, void* out, int B, int S, int H, int K, int n_split, float sl2,
           cudaStream_t st) {
  const dim3 grid(n_split, K * ((H / K + CHUNK - 1) / CHUNK), B);
  if (dtype == 1) {
    const size_t smem = mma_smem<DH>();
    cudaError_t err = cudaFuncSetAttribute(decode_mma<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_mma<DH><<<grid, MMA_NT, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
        static_cast<const __nv_bfloat16*>(vc), lens, num, ml, cnt,
        static_cast<__nv_bfloat16*>(out), S, H, K, n_split, sl2);
  } else {
    const size_t smem = simt_smem<DH>();
    cudaError_t err = cudaFuncSetAttribute(decode_simt<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_simt<DH><<<grid, SIMT_NT, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kc),
        static_cast<const float*>(vc), lens, num, ml, cnt, static_cast<float*>(out), S, H, K,
        n_split, sl2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// part_num: B*H*n_split*dh floats, part_ml: B*H*n_split*2 floats (scratch);
// counters: B*K*ceil(H/K / 8) ints, zero before the launch and left zero
// after it (the buffer may not be shared by launches that can run at the same
// time). q and the caches must be 16-byte aligned and contiguous; any H/K.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_decode_fwd(const void* q, const void* k_cache, const void* v_cache,
                                const void* cache_len, void* part_num, void* part_ml,
                                void* counters, void* out, int B, int S, int H, int K, int dh,
                                int n_split, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H < K || H % K != 0 || n_split < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(cache_len);
  float* num = static_cast<float*>(part_num);
  float* ml = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  const float sl2 = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(dtype, q, k_cache, v_cache, lens, num, ml, cnt, out, B, S, H, K, n_split, sl2, st);
    case 64: return launch<64>(dtype, q, k_cache, v_cache, lens, num, ml, cnt, out, B, S, H, K, n_split, sl2, st);
    case 128: return launch<128>(dtype, q, k_cache, v_cache, lens, num, ml, cnt, out, B, S, H, K, n_split, sl2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
