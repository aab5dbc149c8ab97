// Fused RMSNorm row kernel for Hopper.
//
// Replaces `_rmsnorm_kernel` / `rmsnorm_fwd` of the JAX package
// (src/repro/kernels/rmsnorm/rmsnorm.py), which tiled rows into
// (256, D) VMEM blocks on the TPU: y = x * rsqrt(mean(x^2) + eps) * scale,
// in f32 inside, rounded once to x's dtype.
//
// What bounds it on the card: memory, in principle. Each row is read once
// and written once with ~4 flops per element, far below the ~295 flops
// per byte an H100 needs before compute matters; the floor is
// (2 * rows * D * itemsize + D * scale_itemsize) / 3.35 TB/s. At the
// serving shapes (4 to 64 rows) that floor is below 0.2 us and the launch
// itself (a few us) sets the time, so the design keeps both the device
// side and the host side short:
//   * one block per row, 128 or 256 threads by D; the row stays in
//     registers (up to 8 16-byte vectors a thread), so x is read from
//     device memory once and y written once;
//   * 16-byte vector loads and stores where the row pointers and the
//     scale are aligned and D is a multiple of the vector width, and a
//     coalesced scalar path otherwise (a ragged D or a misaligned view),
//     both inside the kernel, chosen per row;
//   * the sum of squares in f32: a warp shuffle, then one pass through
//     shared memory;
//   * a plain C entry point bound with ctypes that takes its arguments as
//     one packed struct, so that the Python side of a launch is a handful
//     of attribute reads, one struct.pack and one foreign call.
//
// x and y: float32, bfloat16 or float16; scale: float32 or bfloat16.
// D up to 2048 vectors of 16 bytes per row (8192 in f32, 16384 in 16-bit).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// N elements of E moved as one load or store of N * sizeof(E) bytes
template <typename E, int N>
struct alignas(N * sizeof(E) < 16 ? N * sizeof(E) : 16) Pack {
  E v[N];
};

template <typename T, typename W, int THREADS, int NV>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
               int D, long long x_rs, float eps) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte vector
  constexpr int PER = NV * VEC;           // elements per thread
  constexpr int WARPS = THREADS / 32;
  __shared__ float red[WARPS];

  const T* xr = x + (long long)blockIdx.x * x_rs;
  T* yr = y + (long long)blockIdx.x * D;
  const int tid = threadIdx.x;
  const bool vec = D % VEC == 0 && (reinterpret_cast<uintptr_t>(xr) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(yr) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) % alignof(Pack<W, VEC>)) == 0;

  // element e of thread tid: vector path, vector (tid + THREADS * (e / VEC)),
  // lane e % VEC; scalar path, column tid + THREADS * e
  float v[PER];
  float ss = 0.f;
  if (vec) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int c = (tid + n * THREADS) * VEC;
      if (c < D) {
        const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + c);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[n * VEC + i] = to_f32(p.v[i]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[n * VEC + i] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int c = tid + e * THREADS;
      v[e] = c < D ? to_f32(xr[c]) : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) ss = fmaf(v[e], v[e], ss);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) ss += red[i];
  const float rstd = rsqrtf(ss / (float)D + eps);

  if (vec) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int c = (tid + n * THREADS) * VEC;
      if (c < D) {
        const Pack<W, VEC> s = *reinterpret_cast<const Pack<W, VEC>*>(w + c);
        Pack<T, VEC> p;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          p.v[i] = from_f32<T>(v[n * VEC + i] * rstd * to_f32(s.v[i]));
        *reinterpret_cast<Pack<T, VEC>*>(yr + c) = p;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int c = tid + e * THREADS;
      if (c < D) yr[c] = from_f32<T>(v[e] * rstd * to_f32(w[c]));
    }
  }
}

template <typename T, typename W, int THREADS, int NV>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int D,
                   long long x_rs, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, W, THREADS, NV><<<rows, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      D, x_rs, eps);
  return cudaGetLastError();
}

// Threads and vectors per thread by the row's count of 16-byte vectors:
// 128 threads up to 128 vectors, then 256 threads with 1, 2, 4 or 8.
template <typename T, typename W>
cudaError_t dispatch(const void* x, const void* w, void* y, int rows, int D,
                     long long x_rs, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int vecs = (D + VEC - 1) / VEC;
  if (vecs <= 128) return launch<T, W, 128, 1>(x, w, y, rows, D, x_rs, eps, stream);
  if (vecs <= 256) return launch<T, W, 256, 1>(x, w, y, rows, D, x_rs, eps, stream);
  if (vecs <= 512) return launch<T, W, 256, 2>(x, w, y, rows, D, x_rs, eps, stream);
  if (vecs <= 1024) return launch<T, W, 256, 4>(x, w, y, rows, D, x_rs, eps, stream);
  if (vecs <= 2048) return launch<T, W, 256, 8>(x, w, y, rows, D, x_rs, eps, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_w(const void* x, const void* w, void* y, int rows, int D,
                       long long x_rs, int w_dtype, float eps,
                       cudaStream_t stream) {
  if (w_dtype == 0) return dispatch<T, float>(x, w, y, rows, D, x_rs, eps, stream);
  if (w_dtype == 1) return dispatch<T, __nv_bfloat16>(x, w, y, rows, D, x_rs, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The launch's arguments in one struct, which the Python side packs into
// one bytes object (struct format "<5q4if4x"): one foreign-call argument
// instead of ten, each of which costs ctypes a conversion per call.
struct RmsnormArgs {
  long long x, w, y;        // device addresses
  long long stream;         // cudaStream_t
  long long x_rs;           // x's row stride, elements (y's is D)
  int rows, D;
  int x_dtype;              // 0 = float32, 1 = bfloat16, 2 = float16 (y: x's dtype)
  int w_dtype;              // 0 = float32, 1 = bfloat16
  float eps;
};
// rmsnorm.py packs this layout by hand; tests/test_torch_kernels.py reads
// these three numbers and holds the Python struct to them.
static_assert(sizeof(RmsnormArgs) == 64, "RmsnormArgs: 64 bytes, as \"<5q4if4x\"");
static_assert(offsetof(RmsnormArgs, rows) == 40, "RmsnormArgs: rows at byte 40");
static_assert(offsetof(RmsnormArgs, eps) == 56, "RmsnormArgs: eps at byte 56");

// x: rows of D elements, row stride x_rs elements, last dimension
// contiguous; y: rows of D contiguous elements; w: D contiguous elements.
// Returns cudaGetLastError() of the launch (cudaErrorInvalidValue for a
// type code or a D it was not built for).
extern "C" int rmsnorm_fwd(const RmsnormArgs* a) {
  if (a->rows <= 0 || a->D <= 0) return (int)cudaErrorInvalidValue;
  const void* x = reinterpret_cast<const void*>(a->x);
  const void* w = reinterpret_cast<const void*>(a->w);
  void* y = reinterpret_cast<void*>(a->y);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a->stream);
  switch (a->x_dtype) {
    case 0:
      return (int)dispatch_w<float>(x, w, y, a->rows, a->D, a->x_rs, a->w_dtype,
                                    a->eps, st);
    case 1:
      return (int)dispatch_w<__nv_bfloat16>(x, w, y, a->rows, a->D, a->x_rs,
                                            a->w_dtype, a->eps, st);
    case 2:
      return (int)dispatch_w<__half>(x, w, y, a->rows, a->D, a->x_rs, a->w_dtype,
                                     a->eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
