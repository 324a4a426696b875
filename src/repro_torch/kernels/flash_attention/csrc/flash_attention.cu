// Blocked online-softmax GQA attention (prefill) on the FMA pipes, sm_90a: the
// SIMT kernel, for float32 (any of d_head 32/64/128) and bf16 at d_head 32.
//
// Replaces the TPU kernel `_attn_kernel` in
// src/repro/kernels/flash_attention/kernel.py (reached through
// `flash_attention_raw`) where the tensor-core kernel
// (flash_attention_wgmma.cu, bf16 at d_head 64/128, the serve paths' case)
// does not apply. Same function: q (B,S,H,dh), k/v (B,S,K,dh), kv head
// h / (H/K), causal and sliding-window masks, f32 softmax statistics and
// accumulation, fully masked rows zeroed, alpha guarded at NEG_INF. Unlike
// the TPU kernel it normalizes in-kernel and writes (B,S,H,dh) in q's dtype,
// and it takes any S: the ragged tail of the last q and kv tiles is masked.
//
// What bounds it: prefill attention at S >= 1k does 4*dh FLOPs per visible
// (query, key) pair against 2*dh*elt bytes per key row, so it is bound by
// operations: here the f32 FMA rate (67 TFLOP/s), since a float32 product
// must keep the reference's 3e-5 bar and a TF32 tensor-core product does
// not. Design: one CTA per (q-tile of 64 rows, head, batch); the TPU's
// sequential kv grid axis becomes a loop inside the CTA, with K/V tiles
// staged in shared memory as f32 and the (m, l, acc) state in registers. kv
// tiles that the causal or window mask hides entirely are skipped (exact:
// such a tile leaves m, l and acc unchanged).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // key rows per loop step
constexpr int NT = 256;  // threads: 16 x 16, each owns 4 rows x (BK/16) keys

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reductions over the 16 lanes that share a row (lanes ty*16 .. ty*16+15).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         T* __restrict__ out, int S, int H, int K, int causal, int window, float scale) {
  constexpr int QP = DH + 1;   // padded row stride of Qs / Ks (bank spread)
  constexpr int PP = BK + 1;   // padded row stride of Ps
  constexpr int NC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x QP
  float* Ks = Qs + BQ * QP;    // BK x QP
  float* Vs = Ks + BK * QP;    // BK x DH
  float* Ps = Vs + BK * DH;    // BQ x PP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * BQ;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, d = i - r * DH, s = q0 + r;
    Qs[r * QP + d] = s < S ? to_f(q[(((size_t)b * S + s) * H + h) * DH + d]) : 0.f;
  }

  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  // kv range that any row of this tile can see; tiles outside it are skipped
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  int kv_begin = window ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous step's readers of Ks / Vs / Ps are done
    for (int i = tid; i < BK * DH; i += NT) {
      const int r = i / DH, d = i - r * DH, s = k0 + r;
      const size_t off = (((size_t)b * S + s) * K + kh) * DH + d;
      const bool in = s < S;
      Ks[r * QP + d] = in ? to_f(k[off]) : 0.f;
      Vs[r * DH + d] = in ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool valid = row < S && col < S;
        if (causal) valid = valid && row >= col;
        if (window) valid = valid && (row - col) < window;
        ok[j] = valid;
        sc[i][j] = valid ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m[i] > NEG_INF / 2 ? expf(m[i] - m_new) : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        ps += p;
      }
      ps = row_sum(ps);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * DH + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = out + (((size_t)b * S + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[tx + 16 * c] = from_f<T>(o[i][c] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int K, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_fwd<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, K, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
             int K, int dh, int causal, int window, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, K, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, K, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, K, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int H, int K, int dh, int causal,
                                   int window, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, out, B, S, H, K, dh, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, K, dh, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
