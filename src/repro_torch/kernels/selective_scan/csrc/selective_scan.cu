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
// an SM's special-function units issue 16 a clock: about 0.13 ms on 132 SMs.
// So the exp issue rate sets the bound, by a little.
//
// Design. Time is a chain, so the parallelism is (b, e, n) alone: 262,144
// states at the main shape, each taking 2048 steps in order. One thread per
// state needs a 16-lane shuffle reduction for every y_t; one thread per
// channel leaves about 4 warps on an SM to hide every latency. Between the
// two, LANES = 4 neighbouring lanes share a channel, each holding R =
// ceil(n/4) states in registers (R independent exp/FMA chains per lane); y_t
// is the sum over the lane's states, then two xor-shuffles over the 4 lanes.
// A 128-thread block covers 32 channels of one batch row: 512 blocks at the
// main shape, all resident at once (registers are capped at 128 so that 4
// blocks fit an SM). Each lane loads x_t and dt_t of its channel (the 8
// channels of a warp share one 32-byte sector) and its R values of B_t and
// C_t (the same for every channel, so they hit L1; one float4 each where n =
// 4R), P = 4 steps before their use, through a ring in registers, so a
// load's latency hides behind the steps in between; the load pointers step
// one row per load. The tail of ed is masked (its lanes compute on a clamped
// channel and store nothing); the last S mod P steps run after the loop.
// Any S >= 1, any ed, n <= 16: the TPU kernel's S % 16 and ed % 512 tiling
// is gone. exp is one ex2.approx of dt*A*log2(e) (relative error about
// 2^-22). Staging B, C, x and dt through shared memory in chunks, and a
// chunked parallel scan over time, are later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LANES = 4;         // lanes per channel
constexpr int NT = 128;          // threads per block
constexpr int CPB = NT / LANES;  // channels per block
constexpr int P = 4;             // steps a load runs ahead of its use
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float out;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(out) : "f"(v));
  return out;
}

// one step's inputs of one lane into one slot of the ring (zeros if !in):
// x and dt of its channel, B and C of its R states (as float4 if VEC)
template <int R, bool VEC>
__device__ __forceinline__ void load_step(bool in, const float* __restrict__ xq,
                                          const float* __restrict__ dq,
                                          const float* __restrict__ bq,
                                          const float* __restrict__ cq, int j0, int n,
                                          float& xv, float& dv, float (&bv)[R], float (&cv)[R]) {
  xv = in ? __ldg(xq) : 0.f;
  dv = in ? __ldg(dq) : 0.f;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b4 = in ? __ldg(reinterpret_cast<const float4*>(bq + j0) + q) : z;
      const float4 c4 = in ? __ldg(reinterpret_cast<const float4*>(cq + j0) + q) : z;
      bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y, bv[4 * q + 2] = b4.z, bv[4 * q + 3] = b4.w;
      cv[4 * q] = c4.x, cv[4 * q + 1] = c4.y, cv[4 * q + 2] = c4.z, cv[4 * q + 3] = c4.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = in && j0 + r < n;
      bv[r] = ok ? __ldg(bq + j0 + r) : 0.f;
      cv[r] = ok ? __ldg(cq + j0 + r) : 0.f;
    }
  }
}

// one step of a lane's R states; returns y_t of its channel (on every lane)
template <int R>
__device__ __forceinline__ float step(float (&h)[R], const float (&a2)[R], float xv, float dv,
                                      const float (&bv)[R], const float (&cv)[R]) {
  const float dx = dv * xv;
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    h[r] = fmaf(ex2(dv * a2[r]), h[r], dx * bv[r]);
    acc = fmaf(h[r], cv[r], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 2);
}

// VEC: B and C rows as float4 (n == 4 * R, 16-byte aligned rows). At least
// 4 blocks an SM caps registers at 128 (512 blocks fit the card at once).
template <int R, bool VEC>
__global__ void __launch_bounds__(NT, 4)
    scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bc,
                const float* __restrict__ Cc, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int S, int ed, int n) {
  const int b = blockIdx.y;
  const int sub = threadIdx.x % LANES;
  const int e = blockIdx.x * CPB + threadIdx.x / LANES;
  const bool live = e < ed;
  const int ec = live ? e : ed - 1;  // lanes past the tail read a real channel
  const int j0 = sub * R;            // this lane's first state
  const bool store = live && sub == 0;

  float a2[R], h[R];
  const long long hrow = ((long long)b * ed + ec) * n;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    const bool ok = j < n;  // a masked state has A = B = C = 0 and stays 0
    a2[r] = ok ? __ldg(A + (long long)ec * n + j) * LOG2E : 0.f;
    h[r] = (ok && h0 != nullptr) ? __ldg(h0 + hrow + j) : 0.f;
  }
  // load pointers run P steps ahead of the step computed; each advances one
  // row (ed for x and dt, n for B and C) per load
  const long long base = (long long)b * S * ed + ec;
  const float* xl = x + base;
  const float* dl = dt + base;
  const float* bl = Bc + (long long)b * S * n;
  const float* cl = Cc + (long long)b * S * n;
  float* yq = y + base;

  float xs[P], ds[P], bs[P][R], cs[P][R];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    load_step<R, VEC>(k < S, xl, dl, bl, cl, j0, n, xs[k], ds[k], bs[k], cs[k]);
    xl += ed, dl += ed, bl += n, cl += n;
  }
  int t = 0;
  for (; t + P <= S; t += P) {  // whole rounds of the ring: no bound check on the steps
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float xv = xs[k], dv = ds[k];
      float bv[R], cv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) bv[r] = bs[k][r], cv[r] = cs[k][r];
      load_step<R, VEC>(t + k + P < S, xl, dl, bl, cl, j0, n, xs[k], ds[k], bs[k], cs[k]);
      xl += ed, dl += ed, bl += n, cl += n;
      const float yv = step<R>(h, a2, xv, dv, bv, cv);
      if (store) *yq = yv;
      yq += ed;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {  // the last S mod P steps, already in the ring
    if (t + k < S) {             // the same on every thread: the shuffles stay whole
      const float yv = step<R>(h, a2, xs[k], ds[k], bs[k], cs[k]);
      if (store) *yq = yv;
      yq += ed;
    }
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (j0 + r < n) h_out[hrow + j0 + r] = h[r];
  }
}

template <int R, bool VEC>
int launch(const void* x, const void* dt, const void* A, const void* Bc, const void* Cc,
           const void* h0, void* y, void* h, int B, int S, int ed, int n, cudaStream_t st) {
  const dim3 grid((ed + CPB - 1) / CPB, B);
  scan_kernel<R, VEC><<<grid, NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bc), static_cast<const float*>(Cc),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h), S, ed, n);
  return (int)cudaGetLastError();
}

// float4 rows of B and C where every lane's R states are real and aligned
template <int R>
int dispatch(const void* x, const void* dt, const void* A, const void* Bc, const void* Cc,
             const void* h0, void* y, void* h, int B, int S, int ed, int n, cudaStream_t st) {
  if constexpr (R % 4 == 0) {
    const uintptr_t rows = reinterpret_cast<uintptr_t>(Bc) | reinterpret_cast<uintptr_t>(Cc);
    if (n == 4 * R && rows % 16 == 0)
      return launch<R, true>(x, dt, A, Bc, Cc, h0, y, h, B, S, ed, n, st);
  }
  return launch<R, false>(x, dt, A, Bc, Cc, h0, y, h, B, S, ed, n, st);
}

}  // namespace

// Plain C entry point, bound with ctypes. All tensors f32 and contiguous:
// x, dt, y (B, S, ed); A (ed, n); Bc, Cc (B, S, n); h0 (B, ed, n) or null for
// zeros; h (B, ed, n). 1 <= n <= 16, 1 <= B <= 65535. Returns 0 or the CUDA
// error of the launch.
extern "C" int selective_scan_fwd(const void* x, const void* dt, const void* A, const void* Bc,
                                  const void* Cc, const void* h0, void* y, void* h, int B, int S,
                                  int ed, int n, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || ed < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = (n + LANES - 1) / LANES;
  if (r <= 1) return dispatch<1>(x, dt, A, Bc, Cc, h0, y, h, B, S, ed, n, st);
  if (r <= 2) return dispatch<2>(x, dt, A, Bc, Cc, h0, y, h, B, S, ed, n, st);
  if (r <= 4) return dispatch<4>(x, dt, A, Bc, Cc, h0, y, h, B, S, ed, n, st);
  return (int)cudaErrorInvalidValue;
}
