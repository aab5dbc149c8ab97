// Blocked online-softmax GQA attention (FlashAttention forward) for Hopper.
//
// Replaces `_flash_kernel` / `flash_attention_fwd` of the JAX package
// (src/repro/kernels/flash_attention/flash_attention.py). The TPU kernel
// walked the KV blocks as the innermost *grid* axis, carrying m, l and acc
// in VMEM scratch from one grid step to the next. Blocks on a GPU run in
// parallel and in no order, so here each block owns one (query tile, head,
// batch) cell and loops over the KV tiles *inside* the kernel, keeping the
// running max m, denominator l and accumulator acc in f32 for the whole
// loop. Keys k >= S, k > q (causal) and k <= q - window are masked with
// -1e30 exactly as the TPU kernel does; KV tiles that hold no unmasked key
// for any row of the block are skipped by the loop bounds.
//
// What bounds it on the card: at prefill lengths, operations — S^2 * d
// work per head against S * d bytes, far above the ~295 flops per byte at
// which an H100's bf16 tensor cores (989 TFLOP/s) outrun its memory.
//
// Two kernels, chosen by dtype:
//
// * bf16: `flash_fwd_mma_kernel<D>`, FlashAttention-2 on warp-level
//   tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate). 4 warps,
//   each owning 16 of the block's 64 query rows; KV tiles of 64 keys.
//     - Q is copied once into shared memory with 16-byte cp.async and
//       loaded by ldmatrix into A fragments that stay in registers for
//       the whole KV loop.
//     - K and V tiles are double-buffered: tile j+1's cp.async is in
//       flight while tile j is multiplied. Rows past S are zero-filled by
//       the copy itself (src-size 0).
//     - Shared-memory rows are padded by 16 bytes (row strides of 144,
//       176 and 272 bytes at d = 64, 80, 128), so the 8 row addresses of
//       each ldmatrix phase fall in 8 distinct 16-byte bank groups.
//     - S = Q K^T takes K's B fragments from ldmatrix; O += P V takes V's
//       from ldmatrix.trans. P goes from the accumulator layout of S
//       straight into A fragments, with no trip through shared memory.
//     - The online softmax runs in registers, in base 2 (log2(e) folded
//       into the scale): each row's max is reduced over the 4 threads of
//       a quad with two shuffles; each thread keeps a partial row sum,
//       reduced over the quad once, after the loop.
//     - Masks are computed only on the tiles that straddle the diagonal,
//       the window's edge or S (per warp).
//     - Query tiles are issued last-first, so the blocks with the most KV
//       tiles (causal) start first and the short ones fill the tail.
//   Precision: P is rounded to bf16 for the P V product (the TPU kernel
//   keeps P in f32); the row sum l is taken over the f32 P. This is the
//   only change in precision. m, l and acc stay in f32.
//
// * f32: `flash_fwd_kernel<D>`, the scalar kernel: f32 FMAs from
//   shared memory (Q, K, V and the score tile as f32, rows padded to odd
//   strides; each thread a 4 x 4 score micro-tile and a 4 x (d/16) output
//   micro-tile), the softmax by one thread per row. f32 is the parity
//   dtype; TF32 tensor cores would not hold its 2e-5 tolerance.
//
// q, k, v and o are read and written through their (B, S, H, d) strides:
// no transposed copies. The bf16 kernel's cp.async needs 16-byte aligned
// base pointers and (batch, seq, head) strides that are multiples of 8
// elements; the Python wrapper copies a view that fails that check.
// Instantiated for head_dim 64, 80 and 128. `cudaFuncSetAttribute` runs
// once per instantiation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;          // query rows per block (16 per warp)
constexpr int MMA_BK = 64;          // keys per KV tile
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;

template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }   // shared row stride, elements

template <int D>
constexpr size_t mma_smem_bytes() {        // Q + double-buffered K and V
  return sizeof(__nv_bfloat16) * (size_t)(MMA_BQ + 4 * MMA_BK) * mma_ld<D>();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes past `src_bytes` (0 or 16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copy 64 rows of D bf16 from global (row stride `stride` elements) into a
// shared tile of row stride mma_ld<D>(); rows at or past `valid` are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int valid) {
  constexpr int CPR = D / 8;                // 16-byte chunks per row
  constexpr int LD = mma_ld<D>();
  for (int i = threadIdx.x; i < 64 * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int S, int G,
                     int q_sb, int q_ss, int q_sh,
                     int k_sb, int k_ss, int k_sh,
                     int v_sb, int v_ss, int v_sh,
                     int o_sb, int o_ss, int o_sh,
                     int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = mma_ld<D>();
  constexpr int KS = D / 16;          // k-steps of Q K^T; d pairs of P V
  constexpr int NT = MMA_BK / 8;      // score n-tiles per warp
  constexpr int OT = D / 8;           // output n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MMA_BQ * LD;           // 2 buffers of MMA_BK x LD
  __nv_bfloat16* Vs = Ks + 2 * MMA_BK * LD;       // 2 buffers of MMA_BK x LD

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;          // row within an 8-row group
  const int tig = lane & 3;           // thread in quad
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BQ;   // heavy tiles first
  const int qw = q0 + warp * 16;      // this warp's first query row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;               // GQA: q-head h reads kv-head h / (H/K)

  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)kh * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)kh * v_sh;

  // KV tiles that hold at least one unmasked key for some row of the block
  const int nk = (S + MMA_BK - 1) / MMA_BK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q0 + MMA_BQ - 1) / MMA_BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;          // first key row q0 may see
    kt_begin = first > 0 ? first / MMA_BK : 0;
  }

  // group 0: Q; group 1: the first K, V tile
  load_tile<D>(Qs, qb + (long long)q0 * q_ss, q_ss, S - q0);
  cp_async_commit();
  if (kt_begin < kt_end) {
    const int k0 = kt_begin * MMA_BK;
    load_tile<D>(Ks, kb + (long long)k0 * k_ss, k_ss, S - k0);
    load_tile<D>(Vs, vb + (long long)k0 * v_ss, v_ss, S - k0);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // Q A fragments: rows qw + (lane & 15), columns 16 kk + 8 (lane >> 4)
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};    // rows gid, gid + 8 (log2 domain)
  float l_run[2] = {0.f, 0.f};            // this thread's partial row sums
  const float scale2 = scale * LOG2E;

  // ldmatrix row/column offsets of this lane for K (non-trans) and V (trans)
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {              // prefetch tile kt + 1 into the other buffer
      const int k1 = (kt + 1) * MMA_BK;
      load_tile<D>(Ks + (buf ^ 1) * MMA_BK * LD, kb + (long long)k1 * k_ss, k_ss, S - k1);
      load_tile<D>(Vs + (buf ^ 1) * MMA_BK * LD, vb + (long long)k1 * v_ss, v_ss, S - k1);
    }
    cp_async_commit();
    cp_async_wait<1>();                 // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * MMA_BK * LD;
    const __nv_bfloat16* Vt = Vs + buf * MMA_BK * LD;
    const int k0 = kt * MMA_BK;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (jp * 16 + k_row) * LD + kk * 16 + k_col);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale into base 2; mask only where the tile straddles an edge
    const bool edge = k0 + MMA_BK > S || (causal && k0 + MMA_BK - 1 > qw) ||
                      (window > 0 && k0 <= qw + 15 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (edge) {
          const int qp = qw + gid + (e >> 1) * 8;
          const int kp = k0 + j * 8 + tig * 2 + (e & 1);
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax, rows gid (elements 0, 1) and gid + 8 (elements 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m_run[r] - mx);
      m_run[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float p0 = exp2f(s[j][2 * r] - mx), p1 = exp2f(s[j][2 * r + 1] - mx);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P's A fragments straight from the score accumulators
#pragma unroll
    for (int t = 0; t < MMA_BK / 16; ++t) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      pf[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      pf[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      pf[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (t * 16 + v_row) * LD + dp * 16 + v_col);
        mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();                    // buffer buf is free for tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qp = qw + gid + r * 8;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + (long long)b * o_sb + (long long)qp * o_ss + (long long)h * o_sh;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // 16 x 16 threads

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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

  const float* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const float* kb = k + (long long)b * k_sb + (long long)kh * k_sh;
  const float* vb = v + (long long)b * v_sb + (long long)kh * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    Qs[r * DP + c] = qp < S ? qb[(long long)qp * q_ss + c] : 0.f;
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
      Ks[r * DP + c] = ok ? kb[(long long)kp * k_ss + c] : 0.f;
      Vs[r * DP + c] = ok ? vb[(long long)kp * v_ss + c] : 0.f;
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
    float* orow = o + (long long)b * o_sb + (long long)qp * o_ss + (long long)h * o_sh;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[tx + 16 * j] = acc[i][j] / denom;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Each launcher raises its kernel's dynamic shared-memory limit once: C++
// initialises a function-local static once per template instantiation,
// thread-safely, and the result is kept for every later launch.

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int K, const int* st,
                        int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, H, B);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H / K,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int K, const int* st,
                       int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H / K,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, S, K, D), last dimension contiguous.
// strides: 12 ints, (batch, seq, head) element strides of q, k, v, o.
// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel;
// base pointers 16-byte aligned, strides multiples of 8 elements).
// Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int K, int D, int dtype,
                                   const int* strides, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 64: return (int)launch_f32<64>(q, k, v, o, B, S, H, K, strides, causal, window, scale, st);
      case 80: return (int)launch_f32<80>(q, k, v, o, B, S, H, K, strides, causal, window, scale, st);
      case 128: return (int)launch_f32<128>(q, k, v, o, B, S, H, K, strides, causal, window, scale, st);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64: return (int)launch_bf16<64>(q, k, v, o, B, S, H, K, strides, causal, window, scale, st);
      case 80: return (int)launch_bf16<80>(q, k, v, o, B, S, H, K, strides, causal, window, scale, st);
      case 128: return (int)launch_bf16<128>(q, k, v, o, B, S, H, K, strides, causal, window, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
