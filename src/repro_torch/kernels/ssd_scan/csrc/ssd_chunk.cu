// Mamba-2 SSD intra-chunk block (matmul form) for Hopper.
//
// Replaces `_ssd_chunk_kernel` / `ssd_chunk_fwd` of the JAX package
// (src/repro/kernels/ssd_scan/ssd_scan.py). For one (batch, chunk, head)
// cell with chunk length Q, state size N and head dim P it computes
//
//   y_diag[i] = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * x_j * dt_j   (Q, P)
//   state     = sum_j B_j^T (x_j * dt_j * exp(total - cum_j))              (N, P)
//   decay     = exp(total)
//
// with cum the running sum of da over the chunk and total = cum[Q-1]. The
// inter-chunk recurrence stays outside, as in the JAX package.
//
// The TPU kernel gave one grid cell a whole chunk (Q x N tiles of C and B, a
// Q x Q score matrix) in VMEM. At mamba2-780m's shapes (Q=256, N=128) C and B
// alone are 256 KB in f32: more than a block's 227 KB of shared memory. So
// here one block computes one 64-row tile of y_diag for one head and walks
// the 64-row key tiles j <= i inside the kernel; one more block per
// (chunk, head) computes the (N, P) state by walking all key tiles. Grid:
// (H, ceil(Q/64) + 1, b * nc).
//
// What bounds it on the card: operations, about three products of
// 64 x 64 x {N, P} per tile pair, against a few bytes per input element.
// This first version multiplies with scalar f32 FMAs from shared memory (the
// kernel's contract is f32; TF32 tensor cores would change its precision):
//   * tiles live in shared memory as f32 with odd row strides (N+1, P+1,
//     65), so the micro-tile reads are free of bank conflicts; each thread
//     computes a 4 x 4 score micro-tile and a 4 x 4 output micro-tile;
//   * cum is a warp-level prefix sum kept in shared memory; the decay factor
//     exp(cum_i - cum_j) is applied to the score tile on the diagonal side
//     j <= i, and key tiles wholly above the diagonal are never loaded;
//   * C . B^T does not depend on the head, yet each head's block recomputes
//     it (the TPU grid (b*nc, H) does the same): a known waste for a later
//     version to remove;
//   * inputs are read through their (batch, chunk, row[, head]) strides, so
//     x may be a view of the conv output sliced to d_inner: no copies.
// Runtime shapes: any Q <= 256, N <= 128, P <= 64. x is f32 or bf16 (cast to
// f32 on load); C, B, dt, da are f32; all three outputs are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per tile (and key rows per tile)
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int MAX_Q = 256;
constexpr int MAX_N = 128;
constexpr int MAX_P = 64;
constexpr int SP = BQ + 1;      // score tile row stride

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  const float* C;
  const float* B;
  const void* x;
  const float* dt;
  const float* da;
  float* y;        // (b, nc, Q, H, P) contiguous
  float* state;    // (b, nc, H, N, P) contiguous
  float* decay;    // (b, nc, H) contiguous
  int nc, Q, N, H, P;
  long long sC[3];   // C: (batch, chunk, row) strides; last dim contiguous
  long long sB[3];
  long long sx[4];   // x: (batch, chunk, row, head); last dim contiguous
  long long sdt[4];  // dt, da: (batch, chunk, row, head)
  long long sda[4];
};

size_t smem_floats(int Q, int N, int P) {
  return (size_t)Q + 2 * (size_t)BQ * (N + 1) + (size_t)BQ * (P + 1) + (size_t)BQ * SP;
}

template <typename TX>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  const int Q = a.Q, N = a.N, P = a.P, H = a.H;
  const int NP = N + 1, PP = P + 1;
  float* cum = smem;                  // Q
  float* Cs = cum + Q;                // BQ x NP
  float* Bs = Cs + BQ * NP;           // BQ x NP
  float* Xs = Bs + BQ * NP;           // BQ x PP
  float* Ss = Xs + BQ * PP;           // BQ x SP

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int tile = blockIdx.y;
  const int ntiles = (Q + BQ - 1) / BQ;
  const int bi = blockIdx.z / a.nc;
  const int ci = blockIdx.z % a.nc;

  const float* Cb = a.C + bi * a.sC[0] + ci * a.sC[1];
  const float* Bb = a.B + bi * a.sB[0] + ci * a.sB[1];
  const TX* xb = static_cast<const TX*>(a.x) + bi * a.sx[0] + ci * a.sx[1] + h * a.sx[3];
  const float* dtb = a.dt + bi * a.sdt[0] + ci * a.sdt[1] + h * a.sdt[3];
  const float* dab = a.da + bi * a.sda[0] + ci * a.sda[1] + h * a.sda[3];

  // cum = inclusive prefix sum of da over the chunk: warp 0, each lane a
  // run of up to 8 consecutive rows, then a shuffle scan of the run totals.
  if (tid < 32) {
    const int per = (Q + 31) / 32;
    const int beg = tid * per;
    float run[MAX_Q / 32];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_Q / 32; ++k) {
      const int j = beg + k;
      if (k < per && j < Q) s += dab[(long long)j * a.sda[2]];
      run[k] = s;
    }
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += t;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_Q / 32; ++k) {
      const int j = beg + k;
      if (k < per && j < Q) cum[j] = excl + run[k];
    }
  }
  __syncthreads();

  const int ty = tid / 16;
  const int tx = tid % 16;

  if (tile < ntiles) {
    // ---- y_diag rows [i0, i0 + BQ) --------------------------------------
    const int i0 = tile * BQ;
    for (int idx = tid; idx < BQ * N; idx += THREADS) {
      const int r = idx / N, n = idx % N;
      const int i = i0 + r;
      Cs[r * NP + n] = i < Q ? Cb[(long long)i * a.sC[2] + n] : 0.f;
    }
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

    for (int kt = 0; kt <= tile; ++kt) {
      const int j0 = kt * BQ;
      for (int idx = tid; idx < BQ * N; idx += THREADS) {
        const int r = idx / N, n = idx % N;
        const int j = j0 + r;
        Bs[r * NP + n] = j < Q ? Bb[(long long)j * a.sB[2] + n] : 0.f;
      }
      for (int idx = tid; idx < BQ * P; idx += THREADS) {
        const int r = idx / P, p = idx % P;
        const int j = j0 + r;
        Xs[r * PP + p] = j < Q ? to_f32(xb[(long long)j * a.sx[2] + p]) *
                                     dtb[(long long)j * a.sdt[2]]
                               : 0.f;
      }
      __syncthreads();

      // scores: rows ty + 16 u, key columns tx + 16 v
      float s[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) s[u][v] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = Cs[(ty + 16 * u) * NP + n];
#pragma unroll
        for (int v = 0; v < 4; ++v) bv[v] = Bs[(tx + 16 * v) * NP + n];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) s[u][v] = fmaf(cv[u], bv[v], s[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = ty + 16 * u;
        const int i = i0 + r;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = tx + 16 * v;
          const int j = j0 + c;
          const bool ok = j <= i && i < Q;
          Ss[r * SP + c] = ok ? s[u][v] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
      __syncthreads();

      // acc += S . xdt: rows ty + 16 u, head columns tx + 16 v
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float sv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) sv[u] = Ss[(ty + 16 * u) * SP + c];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = tx + 16 * v;
          xv[v] = p < P ? Xs[c * PP + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(sv[u], xv[v], acc[u][v]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + ty + 16 * u;
      if (i >= Q) continue;
      float* yrow = a.y + ((((long long)bi * a.nc + ci) * Q + i) * H + h) * P;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int p = tx + 16 * v;
        if (p < P) yrow[p] = acc[u][v];
      }
    }
    return;
  }

  // ---- state (N, P) and decay --------------------------------------------
  // thread (tn, tp) owns rows n = tn + 16 m (m < 8) and columns p = tp + 16 k
  const float total = cum[Q - 1];
  float sacc[MAX_N / 16][4];
#pragma unroll
  for (int m = 0; m < MAX_N / 16; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) sacc[m][k] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int j0 = kt * BQ;
    for (int idx = tid; idx < BQ * N; idx += THREADS) {
      const int r = idx / N, n = idx % N;
      const int j = j0 + r;
      Bs[r * NP + n] = j < Q ? Bb[(long long)j * a.sB[2] + n] : 0.f;
    }
    for (int idx = tid; idx < BQ * P; idx += THREADS) {
      const int r = idx / P, p = idx % P;
      const int j = j0 + r;
      Xs[r * PP + p] = j < Q ? to_f32(xb[(long long)j * a.sx[2] + p]) *
                                   dtb[(long long)j * a.sdt[2]] * expf(total - cum[j])
                             : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float bv[MAX_N / 16], xv[4];
#pragma unroll
      for (int m = 0; m < MAX_N / 16; ++m) {
        const int n = ty + 16 * m;
        bv[m] = n < N ? Bs[c * NP + n] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = tx + 16 * k;
        xv[k] = p < P ? Xs[c * PP + p] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < MAX_N / 16; ++m)
#pragma unroll
        for (int k = 0; k < 4; ++k) sacc[m][k] = fmaf(bv[m], xv[k], sacc[m][k]);
    }
    __syncthreads();
  }

  float* sb = a.state + (((long long)bi * a.nc + ci) * H + h) * (long long)N * P;
#pragma unroll
  for (int m = 0; m < MAX_N / 16; ++m) {
    const int n = ty + 16 * m;
    if (n >= N) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = tx + 16 * k;
      if (p < P) sb[(long long)n * P + p] = sacc[m][k];
    }
  }
  if (tid == 0) a.decay[((long long)bi * a.nc + ci) * H + h] = expf(total);
}

template <typename TX>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_floats(a.Q, a.N, a.P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.Q + BQ - 1) / BQ + 1, b * a.nc);
  ssd_chunk_kernel<TX><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C, B: (b, nc, Q, N) f32; x: (b, nc, Q, H, P) f32 or bf16; dt, da: (b, nc, Q, H)
// f32. strides: 18 int64 element strides — C (batch, chunk, row), B (the
// same), x (batch, chunk, row, head), dt and da (batch, chunk, row, head);
// the last dimension of C, B and x is contiguous. Outputs are contiguous f32:
// y (b, nc, Q, H, P), state (b, nc, H, N, P), decay (b, nc, H).
// x_dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int ssd_chunk_fwd(const void* C, const void* B, const void* x,
                             const void* dt, const void* da, void* y, void* state,
                             void* decay, int b, int nc, int Q, int N, int H, int P,
                             int x_dtype, const long long* strides, void* stream) {
  if (b <= 0 || nc <= 0 || H <= 0 || Q <= 0 || Q > MAX_Q || N <= 0 || N > MAX_N ||
      P <= 0 || P > MAX_P || (long long)b * nc > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.C = static_cast<const float*>(C);
  a.B = static_cast<const float*>(B);
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.da = static_cast<const float*>(da);
  a.y = static_cast<float*>(y);
  a.state = static_cast<float*>(state);
  a.decay = static_cast<float*>(decay);
  a.nc = nc;
  a.Q = Q;
  a.N = N;
  a.H = H;
  a.P = P;
  for (int i = 0; i < 3; ++i) a.sC[i] = strides[i];
  for (int i = 0; i < 3; ++i) a.sB[i] = strides[3 + i];
  for (int i = 0; i < 4; ++i) a.sx[i] = strides[6 + i];
  for (int i = 0; i < 4; ++i) a.sdt[i] = strides[10 + i];
  for (int i = 0; i < 4; ++i) a.sda[i] = strides[14 + i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0)
    err = launch<float>(a, b, st);
  else if (x_dtype == 1)
    err = launch<__nv_bfloat16>(a, b, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
