// Paged decode attention for Hopper: a chunk of C queries per slot against
// the slot's resident keys, read in place from the shared block pool through
// the slot's block table, plus the chunk's own keys, in one online softmax.
//
// Replaces no TPU kernel: the JAX package's paged decode
// (`attention_decode_paged` in src/repro/models/layers.py) is jnp, which
// gathers every slot's whole table and builds f32 scores over all of it. The
// port did the same in plain PyTorch (`ref.py` beside this file), and at the
// serving cell's tick (64 slots of 4096 keys, mean resident ~1500) that
// gather, the f32 scores and their softmax were ~90 % of the card's time.
//
// What bounds it on the card: bytes. A row of G query heads meets each key
// once per KV head: 4 G hd operations per 4 hd bytes of K and V, so at most
// ~G flops per byte, against the ~295 at which an H100's bf16 tensor cores
// outrun its 3.35 TB/s. The least time is the resident K/V that some real
// row can see, read once.
//
// What the design does about it:
//   * One block per (slot, KV head, tile of 64 query rows). The G query
//     heads that share a KV head are packed into the tile's rows, (query j,
//     group g) -> row j G + g, so each K/V tile is read once for all G heads
//     and a decode slot's G rows sit in one 16-row mma.sync fragment.
//   * The key loop visits only the 64-key tiles that hold a key some row of
//     the block can see: the resident keys [max(0, pos + j_lo - window + 1),
//     pos) looked up in the block table by the block itself (the entries it
//     needs, never the whole table, staged once in shared memory, so no copy
//     waits on a load of the table), then the chunk's keys [.., j_hi]. Rows
//     at or past adv[b] (padding: the engine never samples them) are written
//     as zeros; a block whose rows all are, and a warp whose 16 rows all
//     are, does no work.
//   * 16-byte cp.async copies of each token's row (hd elements) into a
//     double-buffered shared-memory ring: tile t + 1 is in flight while t is
//     multiplied. Keys outside the block's range are zero-filled by the copy
//     (src-size 0), never read.
//   * bf16: mma.sync m16n8k16 with f32 accumulators, the fragments and the
//     base-2 online softmax of `flash_fwd_mma_kernel` (flash_attention.cu);
//     P rounded to bf16 for P V, as the plain version's w.to(bf16). f32: the
//     scalar FMA kernel (the parity dtype), one thread per row's softmax.
//   * Flash-decoding split over keys only where the grid would not fill the
//     card: the wrapper passes nsplit > 1 when slots x KV heads is under two
//     blocks per SM (bf16 only); each split writes its unnormalised
//     accumulator, row max and row sum to scratch, and a second kernel
//     combines them. At 64 slots x 8 KV heads it is 1.
//
// Semantics, as the plain version: row (b, j) at position qpos = pos[b] + j
// sees the resident keys kpos < pos[b] (through block_table[b, kpos / bs];
// sentinel entries read the pool's zero block 0) and the chunk keys j' <= j,
// j' < adv[b]; with window > 0 both also need key position > qpos - window.
// Scores in f32, scaled by 1/sqrt(hd); masked scores -1e30. Instantiated for
// head dims 16, 64, 80 and 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// The launch's arguments in one struct, which the Python side packs into
// one bytes object (struct format "<24q10if4x").
struct PagedArgs {
  long long q, k, v;              // (B, C, H, D), (B, C, K, D), (B, C, K, D)
  long long pool_k, pool_v;       // (NB, bs, K, D), the same strides
  long long table, pos, adv;      // int32: (B, nb) row stride tbl_sb; (B,); (B,)
  long long o;                    // (B, C, H, D) contiguous
  long long part;                 // f32 scratch of nsplit > 1, else 0
  long long stream;               // cudaStream_t
  long long q_sb, q_sc, q_sh;     // element strides of batch, chunk, head
  long long k_sb, k_sc, k_sh;
  long long v_sb, v_sc, v_sh;
  long long p_sblk, p_stok, p_sh; // the pool's block, token and head strides
  long long tbl_sb;
  int B, C, H, K, D;
  int nb, bs;                     // table width, tokens per block
  int window;                     // 0: none
  int nsplit;                     // key splits per block (1: no combine)
  int dtype;                      // 0 = float32 (scalar), 1 = bfloat16 (tensor cores)
  float scale;                    // 1 / sqrt(D)
};
// paged_attention.py packs this layout by hand; the CPU tests read these
// three numbers and hold the Python struct to them.
static_assert(sizeof(PagedArgs) == 240, "PagedArgs: 240 bytes, as \"<24q10if4x\"");
static_assert(offsetof(PagedArgs, B) == 192, "PagedArgs: B at byte 192");
static_assert(offsetof(PagedArgs, scale) == 232, "PagedArgs: scale at byte 232");

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;               // query rows per block (16 per warp)
constexpr int BK = 64;               // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// What one block does: its rows, and the key tiles it visits. Tiles
// [0, n_res) are resident tiles rt_begin + t of the slot's logical
// positions, tiles [n_res, n_tiles) chunk tiles ct_begin + t - n_res; this
// split takes [t_begin, t_end).
struct Plan {
  int b, kh, G, R;                   // slot, KV head, group, rows C G
  int r0, real_rows;                 // first row; rows j < adv[b] are [0, real_rows)
  int p, n;                          // pos[b], adv[b]
  int res_lo, res_hi, rt_begin, n_res;
  int lb0, n_lb;                     // the table entries read: [lb0, lb0 + n_lb)
  int ch_lo, ch_hi, ct_begin;
  int t_begin, t_end;
};

__device__ __forceinline__ Plan make_plan(const PagedArgs& a) {
  Plan pl;
  pl.b = blockIdx.z;
  pl.kh = blockIdx.y;
  pl.G = a.H / a.K;
  pl.R = a.C * pl.G;
  const int tile = blockIdx.x / a.nsplit, split = blockIdx.x % a.nsplit;
  pl.r0 = tile * BQ;
  pl.p = reinterpret_cast<const int*>(a.pos)[pl.b];
  pl.n = min(max(reinterpret_cast<const int*>(a.adv)[pl.b], 0), a.C);
  pl.real_rows = pl.n * pl.G;
  pl.res_lo = pl.res_hi = pl.rt_begin = pl.n_res = 0;
  pl.lb0 = pl.n_lb = 0;
  pl.ch_lo = pl.ch_hi = pl.ct_begin = 0;
  pl.t_begin = pl.t_end = 0;
  if (pl.r0 >= pl.real_rows) return pl;
  const int j_lo = pl.r0 / pl.G;                                  // first query
  const int j_hi = (min(pl.r0 + BQ, pl.real_rows) - 1) / pl.G;    // last real one
  pl.res_hi = min(pl.p, a.nb * a.bs);
  pl.res_lo = a.window > 0 ? max(0, pl.p + j_lo - a.window + 1) : 0;
  if (pl.res_lo < pl.res_hi) {
    pl.rt_begin = pl.res_lo / BK;
    pl.n_res = (pl.res_hi + BK - 1) / BK - pl.rt_begin;
    pl.lb0 = pl.res_lo / a.bs;
    pl.n_lb = (pl.res_hi + a.bs - 1) / a.bs - pl.lb0;
  }
  pl.ch_lo = a.window > 0 ? max(0, j_lo - a.window + 1) : 0;
  pl.ch_hi = j_hi + 1;
  pl.ct_begin = pl.ch_lo / BK;
  const int n_tiles = pl.n_res + (pl.ch_hi + BK - 1) / BK - pl.ct_begin;
  pl.t_begin = (int)((long long)split * n_tiles / a.nsplit);
  pl.t_end = (int)((long long)(split + 1) * n_tiles / a.nsplit);
  return pl;
}

// Whether row query j sees key `key` of tile kind `res` (resident: a
// logical position; chunk: an index into the chunk).
__device__ __forceinline__ bool visible(const PagedArgs& a, const Plan& pl, bool res,
                                        int key, int j) {
  if (res)
    return key < pl.res_hi && (a.window <= 0 || key > pl.p + j - a.window);
  return key <= j && key < pl.n && (a.window <= 0 || key > j - a.window);
}

__device__ __forceinline__ int tile_key0(const Plan& pl, int t) {
  return t < pl.n_res ? (pl.rt_begin + t) * BK : (pl.ct_begin + t - pl.n_res) * BK;
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

// The block's BQ query rows into a shared tile of row stride LD: row r0 + i
// is query j = (r0 + i) / G, head kh G + (r0 + i) % G; rows past real_rows
// are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_q(T* dst, const PagedArgs& a, const Plan& pl) {
  constexpr int EPC = 16 / sizeof(T);          // elements per 16-byte copy
  constexpr int CPR = D / EPC;
  const T* q = reinterpret_cast<const T*>(a.q);
  for (int i = threadIdx.x; i < BQ * CPR; i += blockDim.x) {
    const int rr = i / CPR, c = (i % CPR) * EPC;
    const int r = pl.r0 + rr;
    const bool ok = r < pl.real_rows;
    const T* src = q;
    if (ok)
      src = q + (long long)pl.b * a.q_sb + (long long)(r / pl.G) * a.q_sc +
            (long long)(pl.kh * pl.G + r % pl.G) * a.q_sh + c;
    cp_async16(dst + rr * LD + c, src, ok ? 16 : 0);
  }
}

// The block-table entries the block reads, [lb0, lb0 + n_lb) of its slot's
// row, into shared memory, so that no copy of a key tile waits on a load
// of the table. Read after the next __syncthreads.
__device__ __forceinline__ void load_table(int* dst, const PagedArgs& a, const Plan& pl) {
  const int* table = reinterpret_cast<const int*>(a.table) + (long long)pl.b * a.tbl_sb;
  for (int i = threadIdx.x; i < pl.n_lb; i += blockDim.x) dst[i] = table[pl.lb0 + i];
}

// Key tile t's K and V rows into shared tiles of row stride LD. A resident
// key's row is found through the block's table entries `tbl` (from
// load_table); keys outside the block's range are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_kv(T* Kd, T* Vd, const PagedArgs& a, const Plan& pl,
                                        const int* tbl, int t) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = D / EPC;
  const bool res = t < pl.n_res;
  const int k0 = tile_key0(pl, t);
  const int lo = res ? pl.res_lo : pl.ch_lo, hi = res ? pl.res_hi : pl.ch_hi;
  const T* pk = reinterpret_cast<const T*>(a.pool_k);
  const T* pv = reinterpret_cast<const T*>(a.pool_v);
  for (int i = threadIdx.x; i < BK * CPR; i += blockDim.x) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    const int key = k0 + r;
    const bool ok = key >= lo && key < hi;
    const T* sk = pk;
    const T* sv = pv;
    if (ok) {
      if (res) {
        const long long off = (long long)tbl[key / a.bs - pl.lb0] * a.p_sblk +
                              (long long)(key % a.bs) * a.p_stok +
                              (long long)pl.kh * a.p_sh + c;
        sk = pk + off;
        sv = pv + off;
      } else {
        sk = reinterpret_cast<const T*>(a.k) + (long long)pl.b * a.k_sb +
             (long long)key * a.k_sc + (long long)pl.kh * a.k_sh + c;
        sv = reinterpret_cast<const T*>(a.v) + (long long)pl.b * a.v_sb +
             (long long)key * a.v_sc + (long long)pl.kh * a.v_sh + c;
      }
    }
    cp_async16(Kd + r * LD + c, sk, ok ? 16 : 0);
    cp_async16(Vd + r * LD + c, sv, ok ? 16 : 0);
  }
}

// Output row of (slot b, row r): query r / G, head kh G + r % G.
template <typename T>
__device__ __forceinline__ T* out_row(const PagedArgs& a, const Plan& pl, int r) {
  return reinterpret_cast<T*>(a.o) +
         (((long long)pl.b * a.C + r / pl.G) * a.H + pl.kh * pl.G + r % pl.G) * a.D;
}

// Zeros into rows [r_begin, r_end) of the output (16-byte stores).
template <typename T>
__device__ __forceinline__ void zero_rows(const PagedArgs& a, const Plan& pl, int r_begin,
                                          int r_end) {
  const int vecs = a.D * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < (r_end - r_begin) * vecs; i += blockDim.x)
    reinterpret_cast<uint4*>(out_row<T>(a, pl, r_begin + i / vecs))[i % vecs] =
        make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }   // shared row stride

constexpr int STAGES = 2;   // K/V tiles in the ring, STAGES - 1 in flight: deeper rings
                            // cost blocks per SM and ran slower on an H100

template <int D>
constexpr size_t mma_smem_bytes() {        // Q + the K and V ring (+ the table entries)
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 2 * STAGES * BK) * mma_ld<D>();
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

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_mma_kernel(const PagedArgs a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = mma_ld<D>();
  constexpr int KS = D / 16;          // k-steps of Q K^T; d pairs of P V
  constexpr int NT = BK / 8;          // score n-tiles per warp
  constexpr int OT = D / 8;           // output n-tiles per warp
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;            // STAGES buffers of BK x LD
  bf16* Vs = Ks + STAGES * BK * LD;   // STAGES buffers of BK x LD
  int* tbl = reinterpret_cast<int*>(Vs + STAGES * BK * LD);

  const Plan pl = make_plan(a);
  if (pl.r0 >= pl.real_rows) {        // padding only: zeros (the combine's, if split)
    if (a.nsplit == 1) zero_rows<bf16>(a, pl, pl.r0, min(pl.r0 + BQ, pl.R));
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;          // row within an 8-row group
  const int tig = lane & 3;           // thread in quad
  const int rw = pl.r0 + warp * 16;   // this warp's first row
  const bool active = rw < pl.real_rows;
  const int jr[2] = {(rw + gid) / pl.G, (rw + gid + 8) / pl.G};   // the two rows' queries

  // group 0: Q; groups 1 .. STAGES - 1: the first K, V tiles
  load_q<bf16, D, LD>(Qs, a, pl);
  cp_async_commit();
  load_table(tbl, a, pl);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (pl.t_begin + i < pl.t_end)
      load_kv<bf16, D, LD>(Ks + i * BK * LD, Vs + i * BK * LD, a, pl, tbl, pl.t_begin + i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();

  // Q A fragments: rows warp 16 + (lane & 15), columns 16 kk + 8 (lane >> 4)
  uint32_t qf[KS][4];
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }

  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};    // rows gid, gid + 8 (log2 domain)
  float l_run[2] = {0.f, 0.f};            // this thread's partial row sums
  const float scale2 = a.scale * LOG2E;

  // ldmatrix row/column offsets of this lane for K (non-trans) and V (trans)
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  for (int t = pl.t_begin; t < pl.t_end; ++t) {
    const int buf = (t - pl.t_begin) % STAGES;
    const int ahead = t + STAGES - 1;   // prefetch into the buffer tile t - 1 freed
    if (ahead < pl.t_end) {
      const int nb_ = (ahead - pl.t_begin) % STAGES;
      load_kv<bf16, D, LD>(Ks + nb_ * BK * LD, Vs + nb_ * BK * LD, a, pl, tbl, ahead);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();        // tile t has landed
    __syncthreads();
    if (active) {
      const bf16* Kt = Ks + buf * BK * LD;
      const bf16* Vt = Vs + buf * BK * LD;
      const bool res = t < pl.n_res;
      const int k0 = tile_key0(pl, t);

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

      // scale into base 2; mask only where the tile straddles an edge of
      // what this warp's rows see (every chunk tile: causal)
      const bool edge = !res || k0 + BK > pl.res_hi ||
                        (a.window > 0 && k0 <= pl.p + (rw + 15) / pl.G - a.window);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (edge && !visible(a, pl, res, k0 + j * 8 + tig * 2 + (e & 1), jr[e >> 1]))
            x = NEG_INF;
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
      for (int kt = 0; kt < BK / 16; ++kt) {
        uint32_t pf[4];
        pf[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
        pf[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
        pf[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
        pf[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vt + (kt * 16 + v_row) * LD + dp * 16 + v_col);
          mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                    // buffer buf is free for tile t + STAGES
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = rw + gid + r * 8;
    if (row >= pl.R) continue;
    if (a.nsplit > 1) {                 // this split's share, for the combine
      float* part = reinterpret_cast<float*>(a.part) +
                    ((((long long)pl.b * a.K + pl.kh) * pl.R + row) * a.nsplit +
                     blockIdx.x % a.nsplit) * (D + 2);
#pragma unroll
      for (int j = 0; j < OT; ++j)
        *reinterpret_cast<float2*>(part + j * 8 + tig * 2) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      if (tig == 0) {
        part[D] = m_run[r];
        part[D + 1] = l;
      }
      continue;
    }
    const bool real = row < pl.real_rows;
    const float inv = real ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    bf16* orow = out_row<bf16>(a, pl, row);
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

// The splits' shares of each row merged: one warp per (slot, KV head, row);
// rows at or past adv are zeros.
template <int D>
__global__ void __launch_bounds__(THREADS)
paged_combine_kernel(const PagedArgs a) {
  const int G = a.H / a.K, R = a.C * G;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= (long long)a.B * a.K * R) return;
  const int lane = threadIdx.x & 31;
  const int r = (int)(row % R);
  const int kh = (int)((row / R) % a.K);
  const int b = (int)(row / ((long long)R * a.K));
  __nv_bfloat16* orow = reinterpret_cast<__nv_bfloat16*>(a.o) +
                        (((long long)b * a.C + r / G) * a.H + kh * G + r % G) * D;
  if (r / G >= reinterpret_cast<const int*>(a.adv)[b]) {
    for (int d = lane; d < D; d += 32) orow[d] = __float2bfloat16(0.f);
    return;
  }
  const float* part = reinterpret_cast<const float*>(a.part) + row * a.nsplit * (D + 2);
  float mx = NEG_INF;
  for (int s = 0; s < a.nsplit; ++s) mx = fmaxf(mx, part[s * (D + 2) + D]);
  float l = 0.f;
  for (int s = 0; s < a.nsplit; ++s)
    l += exp2f(part[s * (D + 2) + D] - mx) * part[s * (D + 2) + D + 1];
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = lane; d < D; d += 32) {
    float o = 0.f;
    for (int s = 0; s < a.nsplit; ++s)
      o += exp2f(part[s * (D + 2) + D] - mx) * part[s * (D + 2) + d];
    orow[d] = __float2bfloat16(o * inv);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;     // 16 x 16 threads

template <int D>
__host__ __device__ constexpr int f32_ld() { return D + 4; }   // 16-byte rows

template <int D>
constexpr size_t f32_smem_bytes() {  // Q, double-buffered K and V, scores, m, l, alpha
                                     // (+ the table entries)
  return sizeof(float) * ((size_t)(BQ + 4 * BK) * f32_ld<D>() + BQ * (BK + 1) + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
paged_f32_kernel(const PagedArgs a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = f32_ld<D>();
  constexpr int SP = BK + 1;
  constexpr int DC = D / 16;        // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // BQ x LD
  float* Ks = Qs + BQ * LD;         // 2 buffers of BK x LD
  float* Vs = Ks + 2 * BK * LD;     // 2 buffers of BK x LD
  float* Ss = Vs + 2 * BK * LD;     // BQ x SP: scores, then probabilities
  float* m_s = Ss + BQ * SP;        // running max per row (log2 domain)
  float* l_s = m_s + BQ;            // running denominator per row
  float* a_s = l_s + BQ;            // this tile's rescale factor per row
  int* tbl = reinterpret_cast<int*>(a_s + BQ);

  const Plan pl = make_plan(a);
  if (pl.r0 >= pl.real_rows) {
    zero_rows<float>(a, pl, pl.r0, min(pl.r0 + BQ, pl.R));
    return;
  }
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  load_q<float, D, LD>(Qs, a, pl);
  cp_async_commit();
  load_table(tbl, a, pl);
  __syncthreads();
  if (pl.t_begin < pl.t_end) load_kv<float, D, LD>(Ks, Vs, a, pl, tbl, pl.t_begin);
  cp_async_commit();
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  const float scale2 = a.scale * LOG2E;

  for (int t = pl.t_begin; t < pl.t_end; ++t) {
    const int buf = (t - pl.t_begin) & 1;
    if (t + 1 < pl.t_end)
      load_kv<float, D, LD>(Ks + (buf ^ 1) * BK * LD, Vs + (buf ^ 1) * BK * LD, a, pl, tbl,
                            t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + buf * BK * LD;
    const float* Vt = Vs + buf * BK * LD;
    const bool res = t < pl.n_res;
    const int k0 = tile_key0(pl, t);

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
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int jq = (pl.r0 + r) / pl.G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ss[r * SP + c] = visible(a, pl, res, k0 + c, jq) ? s[i][j] * scale2 : NEG_INF;
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
        const float p = exp2f(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      const float alpha = exp2f(m_prev - m_new);
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
      for (int j = 0; j < DC; ++j) vv[j] = Vt[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();                  // buffer buf and Ss are free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = pl.r0 + r;
    if (row >= pl.R) continue;
    const bool real = row < pl.real_rows;
    const float inv = real ? 1.f / fmaxf(l_s[r], 1e-30f) : 0.f;
    float* orow = out_row<float>(a, pl, row);
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Each launcher raises its kernel's dynamic shared-memory limit to the
// card's opt-in maximum once: C++ initialises a function-local static once
// per template instantiation, thread-safely, and the result is kept for
// every later launch. A launch asks for the tiles and its nb table entries.

constexpr size_t MAX_SMEM = 232448;    // H100: 227 KB per block, opted in

inline size_t table_bytes(const PagedArgs& a) { return ((size_t)a.nb * 4 + 15) / 16 * 16; }

template <int D>
cudaError_t launch_bf16(const PagedArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const size_t smem = mma_smem_bytes<D>() + table_bytes(a);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int tiles = (a.C * (a.H / a.K) + BQ - 1) / BQ;
  paged_mma_kernel<D><<<dim3(tiles * a.nsplit, a.K, a.B), THREADS, smem, stream>>>(a);
  if (a.nsplit > 1) {
    const long long rows = (long long)a.B * a.K * a.C * (a.H / a.K);
    paged_combine_kernel<D><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const PagedArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const size_t smem = f32_smem_bytes<D>() + table_bytes(a);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int tiles = (a.C * (a.H / a.K) + BQ - 1) / BQ;
  paged_f32_kernel<D><<<dim3(tiles, a.K, a.B), F32_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launches (cudaErrorInvalidValue for a
// dtype, a head dim or a split it was not built for).
extern "C" int paged_attention_fwd(const PagedArgs* a) {
  if (a->B <= 0 || a->C <= 0 || a->K <= 0 || a->H % a->K != 0 || a->nb <= 0 ||
      a->bs <= 0 || a->nsplit < 1 || (a->nsplit > 1 && (a->dtype != 1 || a->part == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a->stream);
  if (a->dtype == 0) {
    switch (a->D) {
      case 16: return (int)launch_f32<16>(*a, st);
      case 64: return (int)launch_f32<64>(*a, st);
      case 80: return (int)launch_f32<80>(*a, st);
      case 128: return (int)launch_f32<128>(*a, st);
    }
  } else if (a->dtype == 1) {
    switch (a->D) {
      case 16: return (int)launch_bf16<16>(*a, st);
      case 64: return (int)launch_bf16<64>(*a, st);
      case 80: return (int)launch_bf16<80>(*a, st);
      case 128: return (int)launch_bf16<128>(*a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
