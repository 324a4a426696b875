// Mamba-1 selective scan for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/selective_scan/kernel.py:21
// _scan_kernel (selective_scan_raw). For every batch row b and inner channel
// e, the SSM state h[b, e, :] of n values runs over time as
//   h_t    = exp(dt_t[e] * A[e, :]) * h_{t-1} + (dt_t[e] * x_t[e]) * B_t[:]
//   y_t[e] = sum_n h_t * C_t
// in f32, from h0 (or zeros); out come y (B, S, ed) and the final h (B, ed, n).
//
// What bounds it. Every input is read once and y written once: at the main
// path's shape (B=1, S=2048, ed=16384, n=16) that is x, dt and y, 3 x 134 MB,
// about 0.12 ms at 3.35 TB/s. It also takes S*ed*n = 537M exponentials, and
// an SM's special-function units (MUFU) issue 16 a clock: about 0.13 ms on
// 132 SMs. The two bounds are close, so device memory has to stream while
// the MUFU stays busy, and the issue slots around each exp are few: a state
// step is one multiply (dt*A), one ex2, one multiply (dt*x*B) and two FMAs
// (the state, and y): a sub-partition issues one instruction a clock, and
// its MUFU takes 8 clocks for a warp's ex2.
//
// Design. Time is a chain, so the parallelism is (b, e, n) alone: 262,144
// states at the main shape, each taking S steps in order. A block takes CH =
// 64 channels of one batch row, LPC = 2 lanes a channel, each lane R =
// ceil(n/2) states in registers (R independent exp/FMA chains): 1024 warps at
// the main shape, two to a sub-partition. It walks time in chunks of TC = 32
// steps through a ring of STAGES = 3 chunks in shared memory: x and dt (TC x
// CH) and the B and C rows (TC x NP, NP = 2R, states past n zero-filled).
// Every thread issues its share of a chunk's copies with cp.async (16 bytes
// where rows and bases allow, else 4) two chunks ahead of the chunk it
// computes, about 80 KB in flight on an SM. In a chunk a lane holds step t's
// x, dt, B and C in registers while it reads step t+1's from shared memory,
// so no step waits on a shared-memory read (each ring slot has one spare
// row for the last step's read-ahead, which no copy writes, so that read
// never touches a chunk whose copies may still be landing). B and C are
// broadcast reads (float4). A lane writes its partial sum of y_t (its R
// states) into its own shared y tile: no shuffle, no store from one lane in
// two. A chunk's tiles are summed and written back as coalesced 16-byte
// stores (4-byte where ed or the base is not a multiple of 4 floats) while
// the next chunk computes: the tiles are double buffered, and one
// __syncthreads a chunk orders the ring and the tiles. At the main shape:
// 256 blocks of 128 threads, 94 KB of shared memory each, two to an SM, all
// resident at once. Any S >= 1, any ed, n <= 16, any 4-byte-aligned base.
// exp is one ex2.approx of dt*A*log2(e) (relative error about 2^-22).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LPC = 2;        // lanes per channel
constexpr int CH = 64;        // channels per block
constexpr int NT = CH * LPC;  // threads per block
constexpr int TC = 32;        // time steps per chunk
constexpr int STAGES = 3;     // chunks in the ring
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float out;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(out) : "f"(v));
  return out;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared, 16 or 4 bytes; the first `src_bytes` are read, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared memory of a block with R states a lane: the ring and the y tiles.
template <int R>
struct Tiles {
  static constexpr int NP = LPC * R;  // B and C values a row holds (n padded)
  // STAGES chunks of TC rows, each with a spare row for its last step's read-ahead
  alignas(16) float x[STAGES][TC + 1][CH];
  alignas(16) float dt[STAGES][TC + 1][CH];
  alignas(16) float b[STAGES][TC + 1][NP];
  alignas(16) float c[STAGES][TC + 1][NP];
  alignas(16) float y[2][LPC][TC][CH];  // two chunks of each lane's partial sums of y
};

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bc;
  const float* Cc;
  const float* h0;
  float* y;
  float* h;
  int S, ed, n;
  bool vec_x;  // x, dt, y rows and bases 16-byte aligned (ed % 4 == 0)
  bool vec_b;  // B, C rows and bases 16-byte aligned and n == NP
};

// Chunk k (steps t0 .. t0 + rows - 1) of this block into ring slot k % STAGES.
// Channels past ed and the padding states are zero-filled; rows past S are
// not copied (no step uses them).
template <int R>
__device__ __forceinline__ void load_chunk(Tiles<R>& sm, const Args& a, int b, int e0, int k) {
  constexpr int NP = Tiles<R>::NP;
  const int s = k % STAGES, t0 = k * TC, rows = min(TC, a.S - t0);
  const size_t row0 = (size_t)b * a.S + t0;
  if (a.vec_x) {
    // thread i copies 16 bytes of column i % Q of rows i / Q, i / Q + RSTEP, ...
    constexpr int Q = CH / 4, RSTEP = NT / Q;
    static_assert(NT % Q == 0 && TC % RSTEP == 0, "a chunk does not split evenly");
    const int q = threadIdx.x % Q, r0 = threadIdx.x / Q, e = e0 + 4 * q;
    const int bytes = e < a.ed ? 16 : 0;
    const size_t off = (row0 + r0) * a.ed + min(e, a.ed - 4);
    const size_t step = (size_t)RSTEP * a.ed;
#pragma unroll
    for (int u = 0; u < TC / RSTEP; ++u) {
      const int r = r0 + u * RSTEP;
      if (r < rows) {
        cp_async16(&sm.x[s][r][4 * q], a.x + off + u * step, bytes);
        cp_async16(&sm.dt[s][r][4 * q], a.dt + off + u * step, bytes);
      }
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < 2 * TC * CH / NT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int which = idx / (TC * CH), r = idx / CH % TC, q = idx % CH;
      const int e = e0 + q;
      if (r < rows) {
        const float* src = (which ? a.dt : a.x) + (row0 + r) * a.ed + min(e, a.ed - 1);
        cp_async4(which ? &sm.dt[s][r][q] : &sm.x[s][r][q], src, e < a.ed ? 4 : 0);
      }
    }
  }
  const float* bsrc = a.Bc + row0 * a.n;
  const float* csrc = a.Cc + row0 * a.n;
  if (a.vec_b) {  // n == NP: the chunk's rows are one contiguous run of rows * n floats
    constexpr int Q = TC * NP / 4;
    for (int idx = threadIdx.x; idx < 2 * Q; idx += NT) {
      const int which = idx / Q, q = idx % Q;
      if (4 * q < rows * NP)
        cp_async16(which ? &sm.c[s][0][4 * q] : &sm.b[s][0][4 * q],
                   (which ? csrc : bsrc) + 4 * q, 16);
    }
  } else {
    for (int idx = threadIdx.x; idx < 2 * TC * NP; idx += NT) {
      const int which = idx / (TC * NP), r = idx / NP % TC, j = idx % NP;
      if (r < rows)
        cp_async4(which ? &sm.c[s][r][j] : &sm.b[s][r][j],
                  (which ? csrc : bsrc) + r * a.n + min(j, a.n - 1), j < a.n ? 4 : 0);
    }
  }
}

// y of chunk k back to device memory, the lanes' partial sums added in lane
// order: rows < rows, channels < ed.
template <int R>
__device__ __forceinline__ void store_chunk(const Tiles<R>& sm, const Args& a, int b, int e0,
                                            int k) {
  const int t0 = k * TC, rows = min(TC, a.S - t0);
  float* yb = a.y + ((size_t)b * a.S + t0) * a.ed + e0;
  const auto& tile = sm.y[k & 1];
  if (a.vec_x) {
    constexpr int Q = CH / 4;
#pragma unroll
    for (int u = 0; u < TC * Q / NT; ++u) {
      const int idx = threadIdx.x + u * NT, r = idx / Q, q = 4 * (idx % Q);
      if (r < rows && e0 + q < a.ed) {
        float4 v = *reinterpret_cast<const float4*>(&tile[0][r][q]);
#pragma unroll
        for (int p = 1; p < LPC; ++p) {
          const float4 w = *reinterpret_cast<const float4*>(&tile[p][r][q]);
          v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
        }
        *reinterpret_cast<float4*>(yb + (size_t)r * a.ed + q) = v;
      }
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < TC * CH / NT; ++u) {
      const int idx = threadIdx.x + u * NT, r = idx / CH, q = idx % CH;
      if (r < rows && e0 + q < a.ed) {
        float v = tile[0][r][q];
#pragma unroll
        for (int p = 1; p < LPC; ++p) v += tile[p][r][q];
        yb[(size_t)r * a.ed + q] = v;
      }
    }
  }
}

template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
  }
}

// One lane's walk over a staged chunk: registers hold step t's inputs while
// step t + 1's are read from shared memory.
template <int R>
struct Lane {
  static constexpr int NP = Tiles<R>::NP;
  const float* xs;  // this lane's channel, the chunk's first row
  const float* ds;
  const float* bs;  // this lane's states, the chunk's first row
  const float* cs;
  float* ys;        // this lane's partial sums of y
  float xv, dv, bv[R], cv[R];

  __device__ __forceinline__ void first() {
    xv = xs[0], dv = ds[0];
    load_row<R>(bs, bv);
    load_row<R>(cs, cv);
  }
  __device__ __forceinline__ void step(int t, float (&h)[R], const float (&a2)[R]) {
    const float xn = xs[(t + 1) * CH], dn = ds[(t + 1) * CH];
    float bn[R], cn[R];
    load_row<R>(bs + (t + 1) * NP, bn);
    load_row<R>(cs + (t + 1) * NP, cn);
    const float dx = dv * xv;
    float acc = 0.f;  // one chain: the unrolled steps around it hide its latency
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = fmaf(ex2(dv * a2[r]), h[r], dx * bv[r]);
      acc = fmaf(h[r], cv[r], acc);
    }
    ys[t * CH] = acc;
    xv = xn, dv = dn;
#pragma unroll
    for (int r = 0; r < R; ++r) bv[r] = bn[r], cv[r] = cn[r];
  }
};

// Grid (ceil(ed / CH), B), NT threads, sizeof(Tiles<R>) of dynamic shared memory.
template <int R>
__global__ void __launch_bounds__(NT, 2) scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<R>& sm = *reinterpret_cast<Tiles<R>*>(smem_raw);
  const int b = blockIdx.y, e0 = blockIdx.x * CH;
  const int ch = threadIdx.x / LPC, sub = threadIdx.x % LPC;
  const int e = e0 + ch;
  const int ec = min(e, a.ed - 1);  // lanes past the tail compute on a real channel
  const int j0 = sub * R;           // this lane's first state

  float a2[R], h[R];
  const size_t hrow = ((size_t)b * a.ed + ec) * a.n;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    const bool ok = j < a.n;  // a padding state has A = B = C = 0 and stays 0
    a2[r] = ok ? __ldg(a.A + (size_t)ec * a.n + j) * LOG2E : 0.f;
    h[r] = (ok && a.h0 != nullptr) ? __ldg(a.h0 + hrow + j) : 0.f;
  }

  const int chunks = (a.S + TC - 1) / TC;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < chunks) load_chunk<R>(sm, a, b, e0, k);
    cp_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_wait<STAGES - 2>();  // this thread's copies of chunk k have landed
    __syncthreads();        // everyone's have; everyone is done with chunk k - 1
    if (k + STAGES - 1 < chunks) load_chunk<R>(sm, a, b, e0, k + STAGES - 1);
    cp_commit();
    if (k > 0) store_chunk<R>(sm, a, b, e0, k - 1);

    const int s = k % STAGES, rows = min(TC, a.S - k * TC);
    Lane<R> lane{&sm.x[s][0][ch], &sm.dt[s][0][ch], &sm.b[s][0][j0], &sm.c[s][0][j0],
                 &sm.y[k & 1][sub][0][ch]};
    lane.first();
    if (rows == TC) {
#pragma unroll 8
      for (int t = 0; t < TC; ++t) lane.step(t, h, a2);
    } else {
      for (int t = 0; t < rows; ++t) lane.step(t, h, a2);
    }
  }
  __syncthreads();
  store_chunk<R>(sm, a, b, e0, chunks - 1);
  if (e < a.ed) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (j0 + r < a.n) a.h[hrow + j0 + r] = h[r];
  }
}

template <int R>
int launch(Args a, int B, cudaStream_t st) {
  const int smem = (int)sizeof(Tiles<R>);
  cudaError_t err =
      cudaFuncSetAttribute(scan_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t xs = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.dt) |
                       reinterpret_cast<uintptr_t>(a.y);
  const uintptr_t bs = reinterpret_cast<uintptr_t>(a.Bc) | reinterpret_cast<uintptr_t>(a.Cc);
  a.vec_x = a.ed % 4 == 0 && xs % 16 == 0;
  a.vec_b = a.n == Tiles<R>::NP && a.n % 4 == 0 && bs % 16 == 0;
  const dim3 grid((a.ed + CH - 1) / CH, B);
  scan_kernel<R><<<grid, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The smallest R (a power of 2) that holds a lane's ceil(n / LPC) states.
template <int R>
int dispatch(const Args& a, int B, int r, cudaStream_t st) {
  if (r <= R) return launch<R>(a, B, st);
  if constexpr (2 * R * LPC <= 16) return dispatch<2 * R>(a, B, r, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes. All tensors f32 and contiguous
// (4-byte alignment is enough): x, dt, y (B, S, ed); A (ed, n); Bc, Cc
// (B, S, n); h0 (B, ed, n) or null for zeros; h (B, ed, n). 1 <= n <= 16,
// 1 <= B <= 65535. Returns 0 or the CUDA error of the launch.
extern "C" int selective_scan_fwd(const void* x, const void* dt, const void* A, const void* Bc,
                                  const void* Cc, const void* h0, void* y, void* h, int B, int S,
                                  int ed, int n, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || ed < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x),  static_cast<const float*>(dt),
               static_cast<const float*>(A),  static_cast<const float*>(Bc),
               static_cast<const float*>(Cc), static_cast<const float*>(h0),
               static_cast<float*>(y),        static_cast<float*>(h),
               S, ed, n, false, false};
  return dispatch<1>(a, B, (n + LPC - 1) / LPC, static_cast<cudaStream_t>(stream));
}
