// One-token GQA attention against a ring-buffer KV cache (decode) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel `_decode_kernel` in
// src/repro/kernels/flash_decode/kernel.py (reached through
// `flash_decode_raw`). Same function: q (B,1,H,dh), caches (B,S,K,dh),
// cache_len (B,) int32; slot j is valid iff j < min(cache_len[b], S); online
// softmax in f32; a row with no valid slot gives 0, as num / max(den, 1e-30)
// does there. It takes any cache length S (the TPU wrapper needs S % 256 == 0).
//
// What bounds it: at serving batch (B <= 8) every cache byte is read once for
// 2 FLOPs per element per query head of its group, so decode attention is
// bound by the bytes of the KV cache. Design:
// * the TPU kernel walks the cache once per query head; here one CTA serves
//   all G = H/K query heads of a kv head from one pass over its K and V
//   rows, so each cache byte leaves device memory once;
// * B*K CTAs alone (32 at yi-9b's B=8, K=4) cannot keep 132 SMs pulling
//   bytes, so the cache is also split along S, one chunk per CTA, about
//   CTAS_PER_SM CTAs per SM; each writes an un-normalized partial
//   (num, m, l) and a second small kernel merges them exactly (rescaling by
//   exp(m_s - max m));
// * each thread issues all its 16-byte loads of a 64-slot K and V tile
//   before storing any, so many loads are in flight per SM; K and V stay in
//   their storage type in shared memory and are widened to f32 on use;
// * only valid slots are read: a chunk past min(cache_len, S) reads nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;  // cache slots staged per loop step
constexpr int NT = 128;   // threads of the split kernel (4 warps)
constexpr int MAXG = 8;   // query heads per kv head that one CTA serves
static_assert(TILE == 64 && NT == 128, "softmax and score passes assume these");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T widened to f32.
template <typename T> __device__ __forceinline__ void widen(const uint4& u, float* f);
template <> __device__ __forceinline__ void widen<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DH>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte vector
  static constexpr int NVR = DH / VEC;             // vectors per cache row
  static constexpr int KP = DH + VEC;              // padded K row (bank spread)
  static constexpr int NLOAD = TILE * NVR / NT;    // vectors per thread per tile
  static_assert(TILE * NVR % NT == 0, "tile does not split evenly over threads");
  static size_t smem_bytes(int G) {
    return sizeof(T) * (size_t)(TILE * KP + TILE * DH) +
           sizeof(float) * (size_t)(2 * G * DH + G * TILE + 3 * G);
  }
};

// grid (n_split, K, B). Partial p = (b*H + h)*n_split + split holds
// num[p*DH .. p*DH+DH) and (m, l) at ml[2p], ml[2p+1].
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
decode_split(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
             const int* __restrict__ cache_len, float* __restrict__ part_num,
             float* __restrict__ part_ml, int S, int H, int K, int chunk, int n_split,
             float scale) {
  using Sh = Shape<T, DH>;
  constexpr int VEC = Sh::VEC, NVR = Sh::NVR, KP = Sh::KP, NLOAD = Sh::NLOAD;
  const int G = H / K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);              // TILE x KP
  T* Vs = Ks + TILE * KP;                              // TILE x DH
  float* Qs = reinterpret_cast<float*>(Vs + TILE * DH);  // G x DH
  float* Os = Qs + G * DH;                             // G x DH  running numerators
  float* Ss = Os + G * DH;                             // G x TILE scores, then p
  float* Ms = Ss + G * TILE;                           // G running max
  float* Ls = Ms + G;                                  // G running denominators
  float* As = Ls + G;                                  // G this step's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int valid = min(cache_len[b], S);
  const int s_begin = sp * chunk;
  const int s_end = min(valid, s_begin + chunk);

  for (int i = tid; i < G * DH; i += NT) {
    Qs[i] = to_f(q[((size_t)b * H + kh * G) * DH + i]);
    Os[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }

  const size_t row0 = ((size_t)b * S * K + kh) * DH;  // element offset of slot 0
  const size_t row_stride = (size_t)K * DH;            // elements between slots
  for (int s0 = s_begin; s0 < s_end; s0 += TILE) {
    const int n = min(TILE, s_end - s0);
    __syncthreads();  // previous step's readers of Ks / Vs / Ss are done
    uint4 kr[NLOAD], vr[NLOAD];
#pragma unroll
    for (int u = 0; u < NLOAD; ++u) {
      const int i = tid + u * NT, r = i / NVR, c = i - r * NVR;
      const size_t off = row0 + (size_t)(s0 + r) * row_stride + c * VEC;
      const bool in = r < n;
      kr[u] = in ? *reinterpret_cast<const uint4*>(kc + off) : make_uint4(0, 0, 0, 0);
      vr[u] = in ? *reinterpret_cast<const uint4*>(vc + off) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < NLOAD; ++u) {
      const int i = tid + u * NT, r = i / NVR, c = i - r * NVR;
      *reinterpret_cast<uint4*>(Ks + r * KP + c * VEC) = kr[u];
      *reinterpret_cast<uint4*>(Vs + r * DH + c * VEC) = vr[u];
    }
    __syncthreads();

    {  // scores: thread (slot j, head half hg) covers heads hg, hg+2, hg+4, hg+6
      const int j = tid % TILE, hg = tid / TILE;
      float acc[MAXG / 2];
#pragma unroll
      for (int u = 0; u < MAXG / 2; ++u) acc[u] = 0.f;
#pragma unroll 4
      for (int c = 0; c < NVR; ++c) {
        float kf[VEC];
        widen<T>(*reinterpret_cast<const uint4*>(Ks + j * KP + c * VEC), kf);
#pragma unroll
        for (int u = 0; u < MAXG / 2; ++u) {
          const int g = hg + 2 * u;
          if (g < G) {
            const float4* qg = reinterpret_cast<const float4*>(Qs + g * DH + c * VEC);
#pragma unroll
            for (int e = 0; e < VEC / 4; ++e) {
              const float4 qv = qg[e];
              acc[u] = fmaf(qv.x, kf[4 * e], acc[u]);
              acc[u] = fmaf(qv.y, kf[4 * e + 1], acc[u]);
              acc[u] = fmaf(qv.z, kf[4 * e + 2], acc[u]);
              acc[u] = fmaf(qv.w, kf[4 * e + 3], acc[u]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < MAXG / 2; ++u) {
        const int g = hg + 2 * u;
        if (g < G) Ss[g * TILE + j] = j < n ? acc[u] * scale : NEG_INF;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {  // online softmax, one warp per head
      const float x0 = Ss[g * TILE + lane], x1 = Ss[g * TILE + 32 + lane];
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = lane < n ? expf(x0 - m_new) : 0.f;
      const float p1 = 32 + lane < n ? expf(x1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      Ss[g * TILE + lane] = p0;
      Ss[g * TILE + 32 + lane] = p1;
      if (lane == 0) {
        const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
        Ms[g] = m_new;
        Ls[g] = alpha * Ls[g] + psum;
        As[g] = alpha;
      }
    }
    __syncthreads();

    for (int p = tid; p < G * NVR; p += NT) {  // num = alpha * num + p @ V
      const int g = p / NVR, c = p - g * NVR;
      float* og = Os + g * DH + c * VEC;
      const float* pg = Ss + g * TILE;
      const float alpha = As[g];
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = alpha * og[e];
      for (int j = 0; j < n; ++j) {
        float vf[VEC];
        widen<T>(*reinterpret_cast<const uint4*>(Vs + j * DH + c * VEC), vf);
        const float pj = pg[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pj, vf[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) og[e] = acc[e];
    }
  }
  __syncthreads();

  const size_t base = ((size_t)b * H + kh * G) * n_split + sp;
  for (int p = tid; p < G * DH; p += NT) {
    const int g = p / DH, d = p - g * DH;
    part_num[(base + (size_t)g * n_split) * DH + d] = Os[p];
  }
  for (int g = tid; g < G; g += NT) {
    part_ml[2 * (base + (size_t)g * n_split)] = Ms[g];
    part_ml[2 * (base + (size_t)g * n_split) + 1] = Ls[g];
  }
}

// grid (B*H), block dh: exact merge of the split partials of one (b, h).
template <typename T>
__global__ void decode_combine(const float* __restrict__ part_num,
                               const float* __restrict__ part_ml, T* __restrict__ out,
                               int dh, int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * bh * n_split;
  float mx = NEG_INF;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = ml[2 * s] > NEG_INF / 2 ? expf(ml[2 * s] - mx) : 0.f;
    den += w * ml[2 * s + 1];
    num += w * part_num[(bh * n_split + s) * dh + d];
  }
  out[bh * dh + d] = from_f<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int DH>
int launch(const void* q, const void* kc, const void* vc, const int* cache_len,
           float* part_num, float* part_ml, void* out, int B, int S, int H, int K,
           int n_split, float scale, cudaStream_t stream) {
  const int G = H / K;
  const int chunk = ((S + n_split - 1) / n_split + TILE - 1) / TILE * TILE;
  const size_t smem = Shape<T, DH>::smem_bytes(G);
  cudaError_t err = cudaFuncSetAttribute(decode_split<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_split<T, DH><<<dim3(n_split, K, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      cache_len, part_num, part_ml, S, H, K, chunk, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T><<<B * H, DH, 0, stream>>>(part_num, part_ml, static_cast<T*>(out), DH,
                                              n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const int* lens, float* num,
             float* ml, void* out, int B, int S, int H, int K, int dh, int n_split,
             float scale, cudaStream_t st) {
  switch (dh) {
    case 32: return launch<T, 32>(q, kc, vc, lens, num, ml, out, B, S, H, K, n_split, scale, st);
    case 64: return launch<T, 64>(q, kc, vc, lens, num, ml, out, B, S, H, K, n_split, scale, st);
    case 128:
      return launch<T, 128>(q, kc, vc, lens, num, ml, out, B, S, H, K, n_split, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// part_num: B*H*n_split*dh floats, part_ml: B*H*n_split*2 floats (scratch).
// q and the caches must be 16-byte aligned and contiguous; H/K <= 8.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int flash_decode_fwd(const void* q, const void* k_cache, const void* v_cache,
                                const void* cache_len, void* part_num, void* part_ml,
                                void* out, int B, int S, int H, int K, int dh, int n_split,
                                float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || H / K > MAXG || n_split < 1)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(cache_len);
  float* num = static_cast<float*>(part_num);
  float* ml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k_cache, v_cache, lens, num, ml, out, B, S, H, K, dh, n_split,
                           scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, lens, num, ml, out, B, S, H, K, dh,
                                   n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
