// Fused guided / delay-compensated weight updates for Hopper, sm_90a.
//
// Replaces the four TPU kernels of src/repro/kernels/guided_update/kernel.py:
//   _sgd_kernel      (guided_sgd_update_raw)      w' = w - lr*g~
//   _momentum_kernel (guided_momentum_update_raw) m' = beta*m + g~;
//                                                 w' = w - lr*m'
//                                                 (nesterov: w - lr*(beta*m' + g~))
//   _rmsprop_kernel  (guided_rmsprop_update_raw)  r' = beta*r + (1-beta)*g~^2;
//                                                 w' = w - lr*g~/sqrt(r'+eps)
//   _adam_kernel     (guided_adam_update_raw)     m' = b1*m + (1-b1)*g~;
//                                                 v' = b2*v + (1-b2)*g~^2;
//                                                 w' = w - lr*(m'/bc1)/(sqrt(v'/bc2)+eps)
// with the DC-ASGD compensation g~ = g + lam*g*g*(w - w_stale) folded in.
//
// Each is elementwise over the flat element count: every input element is
// read once and every output written once, so the kernels are bound by
// those bytes (16 to 32 bytes per element in f32, twice that in f64). There
// is nothing to reuse or stage, so the design is the plainest one that keeps
// device memory busy: a grid-stride loop, one element per thread per trip,
// neighbouring threads on neighbouring addresses, the tail masked by the
// loop bound (the TPU wrapper pads to a block multiple instead).
//
// Numerics follow kernel.py exactly: storage type T (f64, f32 or bf16) is
// widened to the compute type C = promote(T, f32); the scalars arrive by
// value already rounded to C by the wrapper (adam's bc1/bc2 computed on the
// host from the step, rmsprop's 1-beta formed here from the rounded beta,
// adam's 1-b1 / 1-b2 rounded from the host's double); the weights are
// rounded back to T, the accumulators stored at C. Every operation goes
// through a correctly rounded intrinsic (__dmul_rn, __fadd_rn, ...), which
// nvcc never contracts into an FMA, so each rounding point is the
// reference's and the f64 results equal the plain PyTorch version's bit for
// bit wherever the scalars do.
//
// In place: an output may be its input (the mesh trainer writes each leaf's
// new weights over the old ones, and the new accumulators over theirs, and
// under SSGD w_stale is w itself). Each thread reads element i of every
// input before it writes element i of any output, and no two threads touch
// one element, so aliasing is safe; the pointers carry no __restrict__,
// which would let the compiler assume otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int BLOCKS_PER_SM = 8;   // grid cap: enough blocks in flight to fill the card

template <typename T> struct Compute { using type = T; };
template <> struct Compute<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float to_c(float x) { return x; }
__device__ __forceinline__ double to_c(double x) { return x; }
__device__ __forceinline__ float to_c(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_c(typename Compute<T>::type x);
template <> __device__ __forceinline__ float from_c<float>(float x) { return x; }
template <> __device__ __forceinline__ double from_c<double>(double x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_c<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// correctly rounded arithmetic, never fused
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fadd_rn(a, -b); }
__device__ __forceinline__ double sub(double a, double b) { return __dadd_rn(a, -b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// g~ = g + lam*g*g*(w - ws), left to right as kernel.py writes it
template <typename C>
__device__ __forceinline__ C compensate(C g, C w, C ws, C lam) {
  return add(g, mul(mul(mul(lam, g), g), sub(w, ws)));
}

template <typename T, typename C = typename Compute<T>::type>
__global__ void sgd_kernel(const T* w, const T* g, const T* ws, T* out, long long n, C lr,
                           C lam) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const C wc = to_c(w[i]);
    const C gt = compensate(to_c(g[i]), wc, to_c(ws[i]), lam);
    out[i] = from_c<T>(sub(wc, mul(lr, gt)));
  }
}

template <typename T, bool NESTEROV, typename C = typename Compute<T>::type>
__global__ void momentum_kernel(const T* w, const T* g, const T* ws, const C* m, T* out,
                                C* m_out, long long n, C lr, C lam, C beta) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const C wc = to_c(w[i]);
    const C gt = compensate(to_c(g[i]), wc, to_c(ws[i]), lam);
    const C m_new = add(mul(beta, m[i]), gt);
    // upd = -(lr*(beta*m' + g~)) or -lr*m'; w' = w + upd
    const C upd = NESTEROV ? -mul(lr, add(mul(beta, m_new), gt)) : mul(-lr, m_new);
    out[i] = from_c<T>(add(wc, upd));
    m_out[i] = m_new;
  }
}

template <typename T, typename C = typename Compute<T>::type>
__global__ void rmsprop_kernel(const T* w, const T* g, const T* ws, const C* r, T* out,
                               C* r_out, long long n, C lr, C lam, C beta, C eps) {
  const C omb = sub(C(1), beta);  // 1.0 - beta from the rounded beta, as kernel.py:125
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const C wc = to_c(w[i]);
    const C gt = compensate(to_c(g[i]), wc, to_c(ws[i]), lam);
    const C r_new = add(mul(beta, r[i]), mul(mul(omb, gt), gt));
    out[i] = from_c<T>(sub(wc, div(mul(lr, gt), root(add(r_new, eps)))));
    r_out[i] = r_new;
  }
}

template <typename T, typename C = typename Compute<T>::type>
__global__ void adam_kernel(const T* w, const T* g, const T* ws, const C* m, const C* v,
                            T* out, C* m_out, C* v_out, long long n, C lr, C lam, C b1,
                            C omb1, C b2, C omb2, C bc1, C bc2, C eps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const C wc = to_c(w[i]);
    const C gt = compensate(to_c(g[i]), wc, to_c(ws[i]), lam);
    const C m_new = add(mul(b1, m[i]), mul(omb1, gt));
    const C v_new = add(mul(b2, v[i]), mul(omb2, mul(gt, gt)));
    const C step = div(div(m_new, bc1), add(root(div(v_new, bc2)), eps));
    out[i] = from_c<T>(sub(wc, mul(lr, step)));
    m_out[i] = m_new;
    v_out[i] = v_new;
  }
}

// blocks for n elements on a card of `sms` SMs (the caller reads the count
// of the tensors' own device, so mixed cards each get their own grid)
int grid_for(long long n, int sms) {
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const long long want = (n + NT - 1) / NT;
  return (int)(want < cap ? want : cap);
}

template <typename T>
int launch_sgd(const void* w, const void* g, const void* ws, void* out, long long n, double lr,
               double lam, int sms, cudaStream_t st) {
  using C = typename Compute<T>::type;
  const int grid = grid_for(n, sms);
  sgd_kernel<T><<<grid, NT, 0, st>>>(static_cast<const T*>(w), static_cast<const T*>(g),
                                     static_cast<const T*>(ws), static_cast<T*>(out), n, C(lr),
                                     C(lam));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_momentum(const void* w, const void* g, const void* ws, const void* m, void* out,
                    void* m_out, long long n, double lr, double lam, double beta, int nesterov,
                    int sms, cudaStream_t st) {
  using C = typename Compute<T>::type;
  const int grid = grid_for(n, sms);
  auto args = [&](auto kernel) {
    kernel<<<grid, NT, 0, st>>>(static_cast<const T*>(w), static_cast<const T*>(g),
                                static_cast<const T*>(ws), static_cast<const C*>(m),
                                static_cast<T*>(out), static_cast<C*>(m_out), n, C(lr), C(lam),
                                C(beta));
  };
  if (nesterov)
    args(momentum_kernel<T, true>);
  else
    args(momentum_kernel<T, false>);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rmsprop(const void* w, const void* g, const void* ws, const void* r, void* out,
                   void* r_out, long long n, double lr, double lam, double beta, double eps,
                   int sms, cudaStream_t st) {
  using C = typename Compute<T>::type;
  const int grid = grid_for(n, sms);
  rmsprop_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const T*>(w), static_cast<const T*>(g), static_cast<const T*>(ws),
      static_cast<const C*>(r), static_cast<T*>(out), static_cast<C*>(r_out), n, C(lr), C(lam),
      C(beta), C(eps));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_adam(const void* w, const void* g, const void* ws, const void* m, const void* v,
                void* out, void* m_out, void* v_out, long long n, double lr, double lam,
                double b1, double omb1, double b2, double omb2, double bc1, double bc2,
                double eps, int sms, cudaStream_t st) {
  using C = typename Compute<T>::type;
  const int grid = grid_for(n, sms);
  adam_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const T*>(w), static_cast<const T*>(g), static_cast<const T*>(ws),
      static_cast<const C*>(m), static_cast<const C*>(v), static_cast<T*>(out),
      static_cast<C*>(m_out), static_cast<C*>(v_out), n, C(lr), C(lam), C(b1), C(omb1), C(b2),
      C(omb2), C(bc1), C(bc2), C(eps));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64 (of w, g and w_stale; accumulators are at the compute type).
// Scalars come as doubles holding values already rounded to the compute type.
// sms: the SM count of the tensors' device, which sizes the grid.
// Return 0 or the CUDA error of the launch.

extern "C" int guided_sgd_update(const void* w, const void* g, const void* ws, void* out,
                                 long long n, double lr, double lam, int dtype, int sms,
                                 void* stream) {
  if (n < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_sgd<float>(w, g, ws, out, n, lr, lam, sms, st);
  if (dtype == 1) return launch_sgd<__nv_bfloat16>(w, g, ws, out, n, lr, lam, sms, st);
  if (dtype == 2) return launch_sgd<double>(w, g, ws, out, n, lr, lam, sms, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int guided_momentum_update(const void* w, const void* g, const void* ws,
                                      const void* m, void* out, void* m_out, long long n,
                                      double lr, double lam, double beta, int nesterov,
                                      int dtype, int sms, void* stream) {
  if (n < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_momentum<float>(w, g, ws, m, out, m_out, n, lr, lam, beta, nesterov, sms,
                                  st);
  if (dtype == 1)
    return launch_momentum<__nv_bfloat16>(w, g, ws, m, out, m_out, n, lr, lam, beta, nesterov,
                                          sms, st);
  if (dtype == 2)
    return launch_momentum<double>(w, g, ws, m, out, m_out, n, lr, lam, beta, nesterov, sms,
                                   st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int guided_rmsprop_update(const void* w, const void* g, const void* ws,
                                     const void* r, void* out, void* r_out, long long n,
                                     double lr, double lam, double beta, double eps, int dtype,
                                     int sms, void* stream) {
  if (n < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rmsprop<float>(w, g, ws, r, out, r_out, n, lr, lam, beta, eps, sms, st);
  if (dtype == 1)
    return launch_rmsprop<__nv_bfloat16>(w, g, ws, r, out, r_out, n, lr, lam, beta, eps, sms,
                                         st);
  if (dtype == 2)
    return launch_rmsprop<double>(w, g, ws, r, out, r_out, n, lr, lam, beta, eps, sms, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int guided_adam_update(const void* w, const void* g, const void* ws, const void* m,
                                  const void* v, void* out, void* m_out, void* v_out,
                                  long long n, double lr, double lam, double b1, double omb1,
                                  double b2, double omb2, double bc1, double bc2, double eps,
                                  int dtype, int sms, void* stream) {
  if (n < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_adam<float>(w, g, ws, m, v, out, m_out, v_out, n, lr, lam, b1, omb1, b2, omb2,
                              bc1, bc2, eps, sms, st);
  if (dtype == 1)
    return launch_adam<__nv_bfloat16>(w, g, ws, m, v, out, m_out, v_out, n, lr, lam, b1, omb1,
                                      b2, omb2, bc1, bc2, eps, sms, st);
  if (dtype == 2)
    return launch_adam<double>(w, g, ws, m, v, out, m_out, v_out, n, lr, lam, b1, omb1, b2,
                               omb2, bc1, bc2, eps, sms, st);
  return (int)cudaErrorInvalidValue;
}
