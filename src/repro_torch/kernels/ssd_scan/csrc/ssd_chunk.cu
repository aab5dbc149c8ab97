// Mamba-2 SSD intra-chunk block (matmul form) for Hopper, on tensor cores.
//
// Replaces `_ssd_chunk_kernel` / `ssd_chunk_fwd` of the JAX package
// (src/repro/kernels/ssd_scan/ssd_scan.py:70). For one (batch, chunk, head)
// cell with chunk length Q, state size N and head dim P it computes
//
//   y_diag[i] = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * x_j * dt_j   (Q, P)
//   state     = sum_j B_j^T (x_j * dt_j * exp(total - cum_j))              (N, P)
//   decay     = exp(total)
//
// with cum the running sum of da over the chunk and total = cum[Q-1]. The
// inter-chunk recurrence stays outside, as in the JAX package.
//
// Two launches per call, both from `ssd_chunk_fwd` below:
//
// * `ssd_cb_kernel` computes CB = C . B^T once per (batch, chunk), in
//   64 x 64 tiles of the lower triangle only (tile pairs ti >= tj), into
//   an f32 scratch of shape (b * nc, Qp, Qp), Qp = Q rounded up to 64. The
//   product does not depend on the head: the TPU grid (b*nc, H), and this
//   kernel's first version, computed it once per head (48 times at
//   mamba2-780m). The scratch is 2 MB there and stays in the 50 MB L2 for
//   the second launch. More blocks of the same launch, one warp per
//   (chunk, head), take the prefix sum cum of da and write cum, dt and
//   w = dt * exp(total - cum) into a second scratch (b * nc, H, 3, Qp), and
//   the decays. Grid: (tile pairs + ceil(H / 8), b * nc), 8 warps a block.
// * `ssd_chunk_kernel` gives one block a 64-row query tile of y_diag for
//   two heads (warps 0-3 and 4-7, 16 rows each), walking the key tiles
//   j <= i; both heads read the same CB tile from shared memory. S =
//   ceil(N / 64) more blocks per (chunk, pair of heads) compute 64 rows of
//   N each of the two (N, P) states, sharing B's tiles the same way. Grid:
//   (ceil(H / 2), b * nc, S + Qp/64). blockIdx.z is a weight rank, not the
//   tile: z < S are the state blocks (each walks every key, about the work
//   of the heaviest query tile; one block for all of N took twice that and
//   set the critical path), z = S + r the query tile Qp/64 - 1 - r (it
//   walks Qp/64 - r key tiles). The hardware issues blocks in x, y, z
//   order, so the heavy blocks of every chunk start first and the light
//   ones fill the tail (the first version's grid (H, tiles + 1, b * nc)
//   put the heavy tiles of the last chunk last). The x tiles are always
//   P_TILE = 64 columns wide in shared memory, zero past P (every served
//   model has P = 64; smaller P, as in the tests, pays the padded work),
//   and the state block's B tile always 64 columns of N, zero past N: so
//   the n-tile loops unroll without guards and the tile copies' row
//   strides and 16-byte chunk counts are compile-time constants.
//
// Precision: 3xTF32. All three products (C . B^T with K = N, (CB o L) . xdt
// and B^T . (xdt * exp(total - cum)) with K = keys) run on
// mma.sync.m16n8k8 TF32 with f32 accumulation. Each f32 operand v is split
// into big = tf32(v) and small = tf32(v - big), and a product takes
// small.big + big.small first, then big.big; only small.small is dropped,
// so each product keeps ~21 bits of its operands, as an f32 FMA loop does
// to within a few ulp. In the two products with x, the per-key weight (dt,
// or w for the state) is folded into the A operand, which is formed in f32
// anyway, and x itself is the B operand: a bf16 x is exact in TF32, so
// big.small is exactly 0 and is not issued (2 mma instead of 3, and no
// split of x); an f32 x is split and takes all 3. Single-pass TF32 (10
// bits) does not hold the kernel's contract. Emulated on the CPU
// (tests/test_torch_ssd.py: operands rounded by bit masking, f32 sums)
// against the JAX package's f32 oracle, at the JAX tests' shapes and
// inputs, single-pass misses their 1e-4 abs bound by 90-320x (9.1e-3 to
// 3.2e-2) where 3xTF32 reads 3.1e-6 to 2.3e-5; at mamba2/hymba-like decays
// single-pass reads 5.8e-4 to 7.9e-4 rel, close to the 1e-3 bound, and
// 3xTF32 7.3e-6 to 2.4e-5, the level at which two f32 summation orders
// differ there. The scores are formed in f32 (CB tile x exp(cum_i -
// cum_j) x dt_j, zero above the diagonal) and split only then.
//
// What bounds it on the card: bytes, at mamba2-780m's 2048-token prefill.
// The least work there is 3.3 GFLOP against 53 MB of inputs and outputs.
// In 3xTF32, C . B^T takes 3 tensor-core passes, and the two products
// with x (98% of the work) take 3 for an f32 x but 2 for a bf16 x (above);
// at 495 TFLOP/s TF32 that is 0.013 ms for bf16 x (0.020 ms for f32 x)
// against 0.016 ms for the bytes. What the design does about it:
//   * C . B^T once per chunk instead of once per head (above);
//   * tensor cores instead of scalar f32 FMAs (~14 TFLOP/s before), and
//     for bf16 x 2 mma per product step instead of 3 (above);
//   * the state split over blocks of 64 rows of N, so no block carries
//     twice the work of another;
//   * two heads per block, so each CB and B tile crosses from L2 once per
//     two heads, and the prefix sums come from the first launch as rows
//     that cp.async brings in with the first tiles (no strided loads of
//     da and dt, nor a scan, in front of every block);
//   * 16-byte cp.async for the C, B, CB, x and aux tiles, the next key
//     tile double-buffered while the current one multiplies. x stays bf16
//     or f32 in shared memory and goes into its fragments as it is;
//   * key sub-tiles wholly above the diagonal of a warp's 16 rows are
//     skipped, and key tiles above the query tile are never loaded;
//   * shared-memory row strides are padded so every fragment read is free
//     of bank conflicts: a row stride = 4 (mod 8) floats where lanes read
//     8 rows x 4 columns (C, B, CB tiles), = 8 or 24 (mod 32) floats where
//     they read 4 rows x 8 columns (x tiles; B for the state); for bf16 x
//     the same in 32-bit words.
// The fragments go from shared memory straight into registers; the score
// tile never round-trips through shared memory, because it is formed from
// the CB tile directly in the A-fragment layout. What is left is latency:
// besides each mma the inner loops issue several instructions (fragment
// forming, exp, TF32 splits), and the second launch takes several times
// what they need at full issue (PERF.md, Findings). wgmma with operands
// split once into shared memory is the next step.
//
// Inputs are read through their (batch, chunk, row[, head]) strides: x may
// be a view of the conv output sliced to d_inner, and C, B views of one
// tensor. cp.async needs 16-byte aligned base pointers and strides that are
// whole multiples of 16 bytes; the Python wrapper checks that and hands
// over a copy with rows padded to 16 bytes otherwise. A row's last chunk
// copies only the bytes inside the row. N is padded with zeros in shared
// memory to a multiple of 16 (the JAX property test uses N = 4), P to 64.
// Runtime shapes: Q <= 256, N <= 128, P <= 64. x is f32 or bf16; C, B, dt,
// da are f32; all three outputs are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile, key rows per tile
constexpr int BKS = 32;         // key rows per tile of the state block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_Q = 256;
constexpr int MAX_N = 128;
constexpr int MAX_P = 64;
constexpr int P_TILE = MAX_P;   // x tile columns in shared memory, zero past P
constexpr int N_TILES = P_TILE / 8;  // 8-column n-tiles of an x tile
constexpr int LDX = P_TILE + 8; // x tile row stride: = 8 (mod 32) floats, = 4 (mod 8) words for bf16
constexpr int LDCB = BQ + 4;    // CB tile row stride (floats), = 4 (mod 8)
constexpr int STATE_M = 64;     // rows of N per state block (16 per warp)
constexpr int CB_WARPS = 8;     // first launch: 4 row groups x 2 column halves
constexpr int CB_THREADS = 32 * CB_WARPS;
constexpr int HG = 2;           // heads per block of the second launch
constexpr int CHUNK_THREADS = THREADS * HG;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Args {
  const float* C;
  const float* B;
  const void* x;
  const float* dt;
  const float* da;
  float* cb;       // scratch (b * nc, Qp, Qp): lower-triangular 64 x 64 tiles
  float* aux;      // scratch (b * nc, H, 3, Qp): cum, dt, dt * exp(total - cum)
  float* y;        // (b, nc, Q, H, P) contiguous
  float* state;    // (b, nc, H, N, P) contiguous
  float* decay;    // (b, nc, H) contiguous
  int nc, Q, N, H, P;
  int Qp, Np;      // Q rounded up to 64; N rounded up to 16
  long long sC[3];   // C: (batch, chunk, row) strides; last dim contiguous
  long long sB[3];
  long long sx[4];   // x: (batch, chunk, row, head); last dim contiguous
  long long sdt[4];  // dt, da: (batch, chunk, row, head)
  long long sda[4];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy of the first src_bytes (0..16) bytes; the
// rest of the 16 are written as zeros
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

// v = big + small + O(2^-22 |v|), both TF32 (low 13 bits zero)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  uint32_t b, s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(v));
  b &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(v - __uint_as_float(b)));
  big = b;
  small = s & 0xffffe000u;
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += a * b with a = ab + as, b = bb + bs; as * bs is dropped.
// EXACT_B: b is a TF32 value (bs = 0), so ab * bs adds nothing and is not
// issued.
template <bool EXACT_B>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  if constexpr (!EXACT_B) mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

// x as a B operand, big and small parts. A bf16 value (8 mantissa bits) is
// exact in TF32, so its small part is 0 and one of the three products of
// 3xTF32 drops out; an f32 value is split.
template <typename TX> struct XOperand;
template <> struct XOperand<__nv_bfloat16> {
  static constexpr bool exact = true;
  __device__ static __forceinline__ void split(__nv_bfloat16 v, uint32_t& big,
                                               uint32_t& small) {
    big = __float_as_uint(__bfloat162float(v));
    small = 0u;
  }
};
template <> struct XOperand<float> {
  static constexpr bool exact = false;
  __device__ static __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
    split_tf32(v, big, small);
  }
};

// Copy ROWS rows of a tile into shared memory (row stride `ld` elements of
// T), `cols_pad` elements per row in 16-byte chunks, from global rows of
// stride `stride` elements, with the NT threads of the block. Elements at
// or past `cols` (the chunk that holds the row's end copies only its part
// inside the row) and rows at or past `valid` are zero-filled. CPR, when
// not 0, is cols_pad's count of chunks known at compile time, which turns
// the index arithmetic into shifts and multiplies.
template <int ROWS, int NT, typename T, int CPR = 0>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long stride,
                                          int valid, int cols, int cols_pad) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = CPR > 0 ? CPR : cols_pad / E;
  for (int i = threadIdx.x; i < ROWS * cpr; i += NT) {
    const int r = i / cpr, c = (i % cpr) * E;
    const bool ok = r < valid && c < cols;
    const int bytes = ok ? (int)sizeof(T) * min(E, cols - c) : 0;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, bytes);
  }
}

// Copy n floats (a multiple of 4, 16-byte aligned) with the NT threads.
template <int NT>
__device__ __forceinline__ void load_row(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += NT * 4) cp_async16(dst + i, src + i, 16);
}

// ---------------------------------------------------------------------------
// First launch: CB = C . B^T, one lower-triangular 64 x 64 tile pair per
// block (warp w: rows 16 (w % 4), columns 32 (w / 4)); and, in
// ceil(H / 8) more blocks per (batch, chunk), one warp per head: cum, dt
// and w = dt * exp(total - cum) into the aux scratch, and the decay
// ---------------------------------------------------------------------------

size_t cb_smem_bytes(int Np) { return sizeof(float) * 2 * (size_t)BQ * (Np + 4); }

// aux scratch (b * nc, H, 3, Qp): row 0 cum, row 1 dt, row 2 w; rows past Q
// hold cum = total, dt = w = 0
__device__ __forceinline__ float* aux_row(const Args& a, int bc, int h, int which) {
  return a.aux + (((long long)bc * a.H + h) * 3 + which) * a.Qp;
}

__device__ void prep_head(const Args& a, int bc, int h, int lane) {
  const int Q = a.Q, Qp = a.Qp;
  const int bi = bc / a.nc, ci = bc % a.nc;
  const float* dab = a.da + bi * a.sda[0] + ci * a.sda[1] + h * a.sda[3];
  const float* dtb = a.dt + bi * a.sdt[0] + ci * a.sdt[1] + h * a.sdt[3];
  // cum: each lane a run of up to 8 consecutive rows, then a shuffle scan
  // of the run totals
  const int per = (Q + 31) / 32;
  const int beg = lane * per;
  float run[MAX_Q / 32], dts[MAX_Q / 32];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) {
    const int j = beg + k;
    const bool ok = k < per && j < Q;
    dts[k] = ok ? dtb[(long long)j * a.sdt[2]] : 0.f;
    if (ok) s += dab[(long long)j * a.sda[2]];
    run[k] = s;
  }
  float incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  // total = cum[Q - 1], from the lane whose run holds row Q - 1
  const float total = __shfl_sync(0xffffffffu, excl + s, (Q - 1) / per);
  float* cum = aux_row(a, bc, h, 0);
  float* dt = aux_row(a, bc, h, 1);
  float* w = aux_row(a, bc, h, 2);
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) {
    const int j = beg + k;
    if (k < per && j < Q) {
      const float c = excl + run[k];
      cum[j] = c;
      dt[j] = dts[k];
      w[j] = dts[k] * expf(total - c);
    }
  }
  for (int j = Q + lane; j < Qp; j += 32) {
    cum[j] = total;
    dt[j] = 0.f;
    w[j] = 0.f;
  }
  if (lane == 0) a.decay[(long long)bc * a.H + h] = expf(total);
}

__global__ void __launch_bounds__(CB_THREADS) ssd_cb_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Np = a.Np, Qp = a.Qp;
  const int ntiles = Qp / BQ;
  const int npairs = ntiles * (ntiles + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x >= npairs) {
    const int h = ((int)blockIdx.x - npairs) * CB_WARPS + warp;
    if (h < a.H) prep_head(a, blockIdx.y, h, lane);
    return;
  }
  const int ld = Np + 4;                  // = 4 (mod 8): A and B reads conflict-free
  float* Cs = smem;
  float* Bs = Cs + BQ * ld;

  int ti = 0, p = blockIdx.x;             // pair p -> (ti, tj), tj <= ti
  while (p > ti) p -= ++ti;
  const int tj = p;
  const int bi = blockIdx.y / a.nc, ci = blockIdx.y % a.nc;
  const float* Cb = a.C + bi * a.sC[0] + ci * a.sC[1] + (long long)ti * BQ * a.sC[2];
  const float* Bb = a.B + bi * a.sB[0] + ci * a.sB[1] + (long long)tj * BQ * a.sB[2];
  load_tile<BQ, CB_THREADS>(Cs, ld, Cb, a.sC[2], a.Q - ti * BQ, a.N, Np);
  load_tile<BQ, CB_THREADS>(Bs, ld, Bb, a.sB[2], a.Q - tj * BQ, a.N, Np);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % 4) * 16, c0 = (warp / 4) * 32;  // this warp's 16 x 32
  const float* Cw = Cs + (r0 + g) * ld + t;
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;

  for (int k0 = 0; k0 < Np; k0 += 8) {
    uint32_t ab[4], as[4];
    split_tf32(Cw[k0], ab[0], as[0]);
    split_tf32(Cw[8 * ld + k0], ab[1], as[1]);
    split_tf32(Cw[k0 + 4], ab[2], as[2]);
    split_tf32(Cw[8 * ld + k0 + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float* Bw = Bs + (c0 + n * 8 + g) * ld + k0 + t;  // B operand (k, n) = B[n][k]
      uint32_t bb[2], bs[2];
      split_tf32(Bw[0], bb[0], bs[0]);
      split_tf32(Bw[4], bb[1], bs[1]);
      mma_3xtf32<false>(acc[n], ab, as, bb, bs);
    }
  }

  float* out = a.cb + (long long)blockIdx.y * Qp * Qp +
               (long long)(ti * BQ + r0 + g) * Qp + tj * BQ + c0 + 2 * t;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float2*>(out + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + 8 * Qp + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// Second launch: y_diag tiles and states. One block per (query tile or
// state rows, pair of heads, chunk); warps 0-3 take the first head, 4-7
// the second, and both read the same CB (or B) tiles
// ---------------------------------------------------------------------------

template <typename TX>
size_t chunk_smem_bytes(int Qp) {
  return sizeof(float) * (2 * HG * (size_t)Qp + 2 * (size_t)BQ * LDCB) +
         sizeof(TX) * 2 * HG * (size_t)BQ * LDX;
}

template <typename TX>
__global__ void __launch_bounds__(CHUNK_THREADS, 2) ssd_chunk_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  using XOp = XOperand<TX>;
  const int Q = a.Q, N = a.N, P = a.P, H = a.H;
  const int Qp = a.Qp, Np = a.Np;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp / WARPS;          // which of the block's HG heads
  const int rw = warp % WARPS;            // 16-row group of the slot
  const int h = blockIdx.x * HG + slot;
  const bool head_ok = h < H;             // an odd H leaves the last slot idle
  const int bc = blockIdx.y;
  const int bi = bc / a.nc, ci = bc % a.nc;
  const int ntiles = Qp / BQ;
  const int nstate = (Np + STATE_M - 1) / STATE_M;
  const bool is_state = (int)blockIdx.z < nstate;
  const int n0 = blockIdx.z * STATE_M;                    // state blocks: first row of N
  const int tile = ntiles + nstate - 1 - (int)blockIdx.z; // tile blocks: query tile

  // shared memory: per slot two aux rows (cum, dt; or w), the shared CB or
  // B tiles (double-buffered), per slot two x tiles
  float* aux = smem;                                  // HG x 2 x Qp
  float* tiles = aux + HG * 2 * Qp;                   // 2 CB tiles or 2 B tiles
  TX* Xs = reinterpret_cast<TX*>(tiles + 2 * BQ * LDCB);  // HG x 2 x BQ x LDX
  constexpr int xbuf = BQ * LDX;

  const TX* xb[HG];
#pragma unroll
  for (int k = 0; k < HG; ++k)   // an idle slot reads the last head, and stores nothing
    xb[k] = static_cast<const TX*>(a.x) + bi * a.sx[0] + ci * a.sx[1] +
            min((int)blockIdx.x * HG + k, H - 1) * a.sx[3];

  // state blocks: B tiles of BKS keys x STATE_M columns of N from n0 (zeros
  // past N), row stride = 8 (mod 32); ncols of them hold m-tiles
  const int ncols = min(STATE_M, Np - n0);
  constexpr int ldb = STATE_M + 8;
  const float* Bb = a.B + bi * a.sB[0] + ci * a.sB[1] + n0;
  const float* cbb = a.cb + (long long)bc * Qp * Qp + (long long)tile * BQ * Qp;
  constexpr int XCPR = P_TILE * (int)sizeof(TX) / 16;    // 16-byte chunks of an x row
  auto load_query_step = [&](int kt, int buf) {
    load_tile<BQ, CHUNK_THREADS, float, BQ / 4>(tiles + buf * BQ * LDCB, LDCB, cbb + kt * BQ,
                                                Qp, BQ, BQ, BQ);
#pragma unroll
    for (int k = 0; k < HG; ++k)
      load_tile<BQ, CHUNK_THREADS, TX, XCPR>(Xs + (2 * k + buf) * xbuf, LDX,
                                             xb[k] + (long long)kt * BQ * a.sx[2], a.sx[2],
                                             Q - kt * BQ, P, P_TILE);
  };
  auto load_state_step = [&](int ks, int buf) {
    load_tile<BKS, CHUNK_THREADS, float, STATE_M / 4>(tiles + buf * BKS * ldb, ldb,
                                                      Bb + (long long)ks * BKS * a.sB[2],
                                                      a.sB[2], Q - ks * BKS, N - n0, STATE_M);
#pragma unroll
    for (int k = 0; k < HG; ++k)
      load_tile<BKS, CHUNK_THREADS, TX, XCPR>(Xs + (2 * k + buf) * xbuf, LDX,
                                              xb[k] + (long long)ks * BKS * a.sx[2], a.sx[2],
                                              Q - ks * BKS, P, P_TILE);
  };
  // first: the slots' aux rows (cum and dt for a query tile, w for the
  // state) from the first launch's scratch, with the first tiles
#pragma unroll
  for (int k = 0; k < HG; ++k) {
    const int hk = min((int)blockIdx.x * HG + k, H - 1);
    float* dst = aux + k * 2 * Qp;
    if (is_state) {
      load_row<CHUNK_THREADS>(dst, aux_row(a, bc, hk, 2), Qp);
    } else {
      load_row<CHUNK_THREADS>(dst, aux_row(a, bc, hk, 0), Qp);
      load_row<CHUNK_THREADS>(dst + Qp, aux_row(a, bc, hk, 1), Qp);
    }
  }
  if (is_state)
    load_state_step(0, 0);
  else
    load_query_step(0, 0);
  cp_async_commit();

  // In both products the per-key weight (dt, or dt * exp(total - cum)) is
  // folded into the A operand, formed in f32 before its split; the B
  // operand is x as it was loaded (exact for bf16 x).
  if (!is_state) {
    // ---- y_diag rows [i0, i0 + BQ): warp rw of a slot owns rows 16 rw .. +15
    const float* cum = aux + slot * 2 * Qp;
    const float* dts = cum + Qp;
    const int i0 = tile * BQ;
    const int r0 = rw * 16;
    const int ia = i0 + r0 + g, ib = ia + 8;          // this thread's two rows
    float acc[N_TILES][4];
#pragma unroll
    for (int n = 0; n < N_TILES; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;

    float cia = 0.f, cib = 0.f;
    for (int kt = 0; kt <= tile; ++kt) {
      const int buf = kt & 1;
      if (kt < tile) load_query_step(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (kt == 0) {
        cia = cum[ia];
        cib = cum[ib];
      }
      const float* S = tiles + buf * BQ * LDCB + (r0 + g) * LDCB + t;
      const TX* X = Xs + (2 * slot + buf) * xbuf + t * LDX + g;
      const int j0 = kt * BQ;
      const bool diag = kt == tile;
      // on the diagonal tile, keys past the warp's last row are all masked
      const int kend = diag ? r0 + 16 : BQ;
#pragma unroll 2
      for (int k0 = 0; k0 < kend; k0 += 8) {
        const int ja = j0 + k0 + t, jb = ja + 4;
        const float cja = cum[ja], cjb = cum[jb];
        const float dta = dts[ja], dtb = dts[jb];
        // A operand (row g | g+8, key t | t+4): CB x exp(cum_i - cum_j) x dt_j
        float s[4];
        s[0] = S[k0] * expf(cia - cja) * dta;
        s[1] = S[8 * LDCB + k0] * expf(cib - cja) * dta;
        s[2] = S[k0 + 4] * expf(cia - cjb) * dtb;
        s[3] = S[8 * LDCB + k0 + 4] * expf(cib - cjb) * dtb;
        if (diag) {
          if (ja > ia) s[0] = 0.f;
          if (ja > ib) s[1] = 0.f;
          if (jb > ia) s[2] = 0.f;
          if (jb > ib) s[3] = 0.f;
        }
        uint32_t ab[4], as[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split_tf32(s[u], ab[u], as[u]);
        const TX* Xk = X + k0 * LDX;
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {  // B operand (key t | t+4, p = 8 n + g) = x[key][p]
          uint32_t bb[2], bs[2];
          XOp::split(Xk[n * 8], bb[0], bs[0]);
          XOp::split(Xk[4 * LDX + n * 8], bb[1], bs[1]);
          mma_3xtf32<XOp::exact>(acc[n], ab, as, bb, bs);
        }
      }
      __syncthreads();
    }

    // accumulator (row g | g+8, column 2t, 2t+1) of each n-tile
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? ib : ia;
      if (!head_ok || i >= Q) continue;
      float* yrow = a.y + ((((long long)bi * a.nc + ci) * Q + i) * H + h) * P;
#pragma unroll
      for (int n = 0; n < N_TILES; ++n) {
        const int p = n * 8 + 2 * t;
        if (p >= P) continue;
        const float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
        if (p + 1 < P && !(P & 1)) {
          *reinterpret_cast<float2*>(yrow + p) = make_float2(v0, v1);
        } else {
          yrow[p] = v0;
          if (p + 1 < P) yrow[p + 1] = v1;
        }
      }
    }
    return;
  }

  // ---- state rows [n0, n0 + 64) of (N, P) = (B^T o w) x ----------------------
  // warp rw of a slot owns the 16 rows n0 + 16 rw (an m-tile), if they exist
  const float* w = aux + slot * 2 * Qp;
  const int m0 = rw * 16;
  const bool active = m0 < ncols;
  float sacc[N_TILES][4];
#pragma unroll
  for (int n = 0; n < N_TILES; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) sacc[n][k] = 0.f;

  const int nks = (Q + BKS - 1) / BKS;    // key tiles wholly past Q add nothing
  for (int ks = 0; ks < nks; ++ks) {
    const int buf = ks & 1;
    if (ks + 1 < nks) load_state_step(ks + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Bt = tiles + buf * BKS * ldb + t * ldb + m0 + g;
    const TX* X = Xs + (2 * slot + buf) * xbuf + t * LDX + g;
    if (active) {
#pragma unroll
      for (int k0 = 0; k0 < BKS; k0 += 8) {
        const int ja = ks * BKS + k0 + t, jb = ja + 4;
        const float wa = w[ja], wb = w[jb];
        // A operand (row n = g | g+8, key t | t+4) = B[key][n] x w[key]
        const float* Bk = Bt + k0 * ldb;
        uint32_t ab[4], as[4];
        split_tf32(Bk[0] * wa, ab[0], as[0]);
        split_tf32(Bk[8] * wa, ab[1], as[1]);
        split_tf32(Bk[4 * ldb] * wb, ab[2], as[2]);
        split_tf32(Bk[4 * ldb + 8] * wb, ab[3], as[3]);
        const TX* Xk = X + k0 * LDX;
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {  // B operand (key t | t+4, p = 8 n + g) = x[key][p]
          uint32_t bb[2], bs[2];
          XOp::split(Xk[n * 8], bb[0], bs[0]);
          XOp::split(Xk[4 * LDX + n * 8], bb[1], bs[1]);
          mma_3xtf32<XOp::exact>(sacc[n], ab, as, bb, bs);
        }
      }
    }
    __syncthreads();
  }

  if (!active || !head_ok) return;
  float* sb = a.state + (((long long)bi * a.nc + ci) * H + h) * (long long)N * P;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int nrow = n0 + m0 + g + 8 * half;
    if (nrow >= N) continue;
#pragma unroll
    for (int n = 0; n < N_TILES; ++n) {
      const int p = n * 8 + 2 * t;
      if (p >= P) continue;
      sb[(long long)nrow * P + p] = sacc[n][2 * half];
      if (p + 1 < P) sb[(long long)nrow * P + p + 1] = sacc[n][2 * half + 1];
    }
  }
}

// Raise a kernel's dynamic shared-memory limit when a launch needs more
// than any earlier one did (once per kernel in practice).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

size_t g_cb_allowed = 0;

template <typename TX>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const int ntiles = a.Qp / BQ;
  const size_t cb_smem = cb_smem_bytes(a.Np);
  cudaError_t err = allow_smem(ssd_cb_kernel, cb_smem, g_cb_allowed);
  if (err != cudaSuccess) return err;
  const int nprep = (a.H + CB_WARPS - 1) / CB_WARPS;
  ssd_cb_kernel<<<dim3(ntiles * (ntiles + 1) / 2 + nprep, b * a.nc), CB_THREADS, cb_smem,
                  stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nstate = (a.Np + STATE_M - 1) / STATE_M;
  const dim3 grid((a.H + HG - 1) / HG, b * a.nc, nstate + ntiles);
  const size_t smem = chunk_smem_bytes<TX>(a.Qp);
  static size_t allowed = 0;
  err = allow_smem(ssd_chunk_kernel<TX>, smem, allowed);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<TX><<<grid, CHUNK_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C, B: (b, nc, Q, N) f32; x: (b, nc, Q, H, P) f32 or bf16; dt, da: (b, nc, Q, H)
// f32. cb, aux: f32 scratch of (b * nc) * Qp * Qp and (b * nc) * H * 3 * Qp
// elements, Qp = Q rounded up to 64, written by the first launch and read
// by the second.
// strides: 18 int64 element strides — C (batch, chunk, row), B (the same), x
// (batch, chunk, row, head), dt and da (batch, chunk, row, head); the last
// dimension of C, B and x is contiguous, and C, B and x are 16-byte aligned
// with 16-byte multiples for their other strides. Outputs are contiguous f32:
// y (b, nc, Q, H, P), state (b, nc, H, N, P), decay (b, nc, H).
// x_dtype: 0 = float32, 1 = bfloat16. Launches ssd_cb_kernel, then
// ssd_chunk_kernel, on `stream`; returns the first launch error, or 0.
extern "C" int ssd_chunk_fwd(const void* C, const void* B, const void* x,
                             const void* dt, const void* da, void* cb, void* aux, void* y,
                             void* state, void* decay, int b, int nc, int Q, int N,
                             int H, int P, int x_dtype, const long long* strides,
                             void* stream) {
  if (b <= 0 || nc <= 0 || H <= 0 || Q <= 0 || Q > MAX_Q || N <= 0 || N > MAX_N ||
      P <= 0 || P > MAX_P || (long long)b * nc > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.C = static_cast<const float*>(C);
  a.B = static_cast<const float*>(B);
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.da = static_cast<const float*>(da);
  a.cb = static_cast<float*>(cb);
  a.aux = static_cast<float*>(aux);
  a.y = static_cast<float*>(y);
  a.state = static_cast<float*>(state);
  a.decay = static_cast<float*>(decay);
  a.nc = nc;
  a.Q = Q;
  a.N = N;
  a.H = H;
  a.P = P;
  a.Qp = round_up(Q, BQ);
  a.Np = round_up(N, 16);
  for (int i = 0; i < 3; ++i) a.sC[i] = strides[i];
  for (int i = 0; i < 3; ++i) a.sB[i] = strides[3 + i];
  for (int i = 0; i < 4; ++i) a.sx[i] = strides[6 + i];
  for (int i = 0; i < 4; ++i) a.sdt[i] = strides[10 + i];
  for (int i = 0; i < 4; ++i) a.sda[i] = strides[14 + i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return (int)launch<float>(a, b, st);
  if (x_dtype == 1) return (int)launch<__nv_bfloat16>(a, b, st);
  return (int)cudaErrorInvalidValue;
}

// What the loaded library's three kernels use per thread, as the runtime
// reports it: registers, and local memory in bytes (register spills and
// stack). out: 6 ints, (registers, local bytes) for ssd_cb_kernel, then
// ssd_chunk_kernel for f32 x, then for bf16 x. Returns a CUDA error, or 0.
extern "C" int ssd_kernel_attrs(int* out) {
  const void* kernels[3] = {reinterpret_cast<const void*>(&ssd_cb_kernel),
                            reinterpret_cast<const void*>(&ssd_chunk_kernel<float>),
                            reinterpret_cast<const void*>(&ssd_chunk_kernel<__nv_bfloat16>)};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, kernels[i]);
    if (err != cudaSuccess) return (int)err;
    out[2 * i] = fa.numRegs;
    out[2 * i + 1] = (int)fa.localSizeBytes;
  }
  return 0;
}
