// Blocked online-softmax GQA attention (FlashAttention forward) for Hopper.
//
// Replaces `_flash_kernel` / `flash_attention_fwd` of the JAX package
// (src/repro/kernels/flash_attention/flash_attention.py). The TPU kernel
// walked the KV blocks as the innermost *grid* axis, carrying m, l and acc
// in VMEM scratch from one grid step to the next. Blocks on a GPU run in
// parallel and in no order, so here each block owns one (query tile, head,
// batch) cell and loops over the KV tiles *inside* the kernel, keeping the
// running max m, denominator l (shared memory) and accumulator acc
// (registers) in f32 for the whole loop.
//
// What bounds it on the card: at prefill lengths, operations — S^2 * d work
// per head against S * d bytes. The tensor-core bound (989 TFLOP/s bf16) is
// far out of reach of this first version, which multiplies with scalar f32
// FMAs from shared memory. Its design choices are for being right and simple:
//   * Q, K, V and the score tile live in shared memory as f32, rows padded
//     to an odd stride so that the micro-tile reads are free of bank
//     conflicts; each thread computes a 4 x 4 score micro-tile and a
//     4 x (d/16) output micro-tile, so every shared-memory load feeds
//     several FMAs;
//   * the loop bounds skip KV tiles that are entirely in the future
//     (causal) or entirely before the sliding window, rather than
//     predicating them; inside a tile, keys k >= S, k > q and k <= q - window
//     are masked with -1e30 exactly as the TPU kernel does;
//   * q, k, v and o are read and written through their (B, S, H, d) strides:
//     no transposed copies.
// Tensor cores (mma.sync, then wgmma with TMA) are work for later versions.
//
// Instantiated for f32 and bf16, and for head_dim 64, 80 and 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int G,
                 int q_sb, int q_ss, int q_sh,
                 int k_sb, int k_ss, int k_sh,
                 int v_sb, int v_ss, int v_sh,
                 int o_sb, int o_ss, int o_sh,
                 int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1;     // odd row strides: conflict-free column reads
  constexpr int SP = BK + 1;
  constexpr int DC = D / 16;    // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x DP
  float* Ks = Qs + BQ * DP;         // BK x DP
  float* Vs = Ks + BK * DP;         // BK x DP
  float* Ss = Vs + BK * DP;         // BQ x SP: scores, then probabilities
  float* m_s = Ss + BQ * SP;        // running max per row
  float* l_s = m_s + BQ;            // running denominator per row
  float* a_s = l_s + BQ;            // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;             // GQA: q-head h reads kv-head h // (H/K)

  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* kb = k + (long long)b * k_sb + (long long)kh * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)kh * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    Qs[r * DP + c] = qp < S ? to_f32(qb[(long long)qp * q_ss + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  // KV tiles that hold at least one unmasked key for some row of this tile
  const int nk = (S + BK - 1) / BK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;   // first key row q0 may see
    kt_begin = first > 0 ? first / BK : 0;
  }
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kp = k0 + r;
      const bool ok = kp < S;
      Ks[r * DP + c] = ok ? to_f32(kb[(long long)kp * k_ss + c]) : 0.f;
      Vs[r * DP + c] = ok ? to_f32(vb[(long long)kp * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        Ss[r * SP + c] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: one thread per row
    if (tid < BQ) {
      float* row = Ss + tid * SP;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int c = 0; c < BK; ++c) m_new = fmaxf(m_new, row[c]);
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

    // acc = alpha * acc + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= S) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* orow = o + (long long)b * o_sb + (long long)qp * o_ss + (long long)h * o_sh;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int K, const int* st,
                   int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H / K,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int K, int D, const int* st,
                       int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, K, st, causal, window, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, K, st, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, K, st, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, S, K, D), last dimension contiguous.
// strides: 12 ints, (batch, seq, head) element strides of q, k, v, o.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int K, int D, int dtype,
                                   const int* strides, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, B, S, H, K, D, strides, causal, window, scale, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, H, K, D, strides, causal, window,
                                    scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
