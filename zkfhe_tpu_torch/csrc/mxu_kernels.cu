// The modular matmul's two kernels for Hopper (sm_90a):
//   (sum_k A[m, k] * B[k, n]) * R^-1 mod p, A (20, Bt, M, K) and
//   B (20, Bt, K, N) canonical 13-bit limbs, out (20, Bt, M, N).
//
// Replaces zkfhe_tpu/ops/mxu_field.py:130 mat_mul_mont. That is not a
// Pallas kernel: it is an XLA s8 x s8 -> s32 dot_general with a jnp
// epilogue, shaped around the TPU's int8 matrix unit. The scheme stays:
//
//   zk_planes7       <- to_planes7 (:48) and the transposes (:140-141): each
//                       260-bit operand as 38 planes of 7 bits in int8, one
//                       layout for both operands: (Bt, E*38, Kp), row
//                       e*38+u for element e (m of A, n of B) and plane u,
//                       K-contiguous, K padded with zero planes to Kp, a
//                       multiple of 32. Operands are read through their
//                       strides, so a batch broadcast with stride 0 is read
//                       in place.
//   zk_plane_mm_redc <- :142-159, the dot_general and the epilogue (split,
//                       pair fold, _wide_planes_to_limbs, mont_reduce_wide)
//                       in one kernel: no int32 C in device memory.
//
// What bounds each on an H100 (3.35 TB/s; 1,979 T int8 tensor-core op/s;
// about 33.5 T 32-bit integer op/s, a multiply-add counted as 2):
//   * zk_planes7 reads 80 B and writes 38 B per operand element: bytes.
//     A block stages a 32 x 32 tile of elements' planes in shared memory,
//     so that its loads run along whichever of the operand's two axes is
//     contiguous and its stores along K, 32 bytes at a time.
//   * zk_plane_mm_redc reads the planes once and writes 80 B per output:
//     bytes at every shape of the prover (the evaluations' 40 MB of A's
//     planes take 12 us, the 15 G int8 operations of the pair product 8 us
//     at the tensor cores' peak; the SHPLONK folds' 20 MB of B's planes
//     6 us).
//
// zk_plane_mm_redc's design. The epilogue needs, per output, only the 75
// wide-plane sums W[s] = sum_k sum_{u+v=s} a_u[k] b_v[k], not the 1444
// pair sums: staging and folding the pairs in shared memory cost more than
// the product. W is itself a matrix product, over the contraction index
// (u, k): W[x][s] = sum_(u,k) X_u[x, k] * T[s][(u, k)] with T[s][(u, k)] =
// Y_(s-u)[k], the Toeplitz band of the other operand's planes. So:
//   * the operand with more elements ("X") is the MMA's 64-row side, a row
//     per element, its planes streamed as they lie (a row's 38 x Kp bytes);
//     the other ("Y") gives the N side, 80 columns (75 used) per element,
//     two elements a tile (wgmma m64n160k32, 80 int32 sums a thread). The
//     pair weight 2^(7(u+v)) is symmetric, so out[m, n] is the same sum
//     with either operand as X;
//   * T is never built: a 128-byte K window of Y's 38 planes sits in
//     shared memory in wgmma's unswizzled K-major layout (16-byte rows, so
//     a row offset is an address offset) between zero rows, and plane u's
//     band is the same window read from u rows higher: one descriptor per u;
//   * a stage is one plane u of a 128-byte K chunk of the 64 X rows (8 KB
//     in the 128-byte swizzle, row r's chunk c at c ^ (r & 7)); a ring of 7
//     stages is filled by TMA (one thread, completion on an mbarrier per
//     slot), the Y window with the first plane of each chunk (two windows,
//     double-buffered). The one to four MMAs of a stage are one
//     straight-line wgmma group, so that nothing touches the sums between
//     them; a stage's group runs on while the slot of the one before is
//     refilled and the next stage is waited for. TMA fills elements past
//     the operand and K past Kp with zeros, and MMAs past a chunk's K are
//     not issued;
//   * W grows by at most 38 * 127^2 per byte of K, so a K range of up to 27
//     chunks (3456 bytes) keeps it below 2^31 in int32. Longer K, and the
//     evaluations' few output tiles (6 at K = 8192), are split into ranges
//     whose sums meet in a zeroed 64-bit workspace (atomicAdd: exact in any
//     order); a per-tile counter elects the last block for the epilogue.
//     The folds (K = 64) run unsplit and no sum leaves the chip;
//   * epilogue: W split 16/16 into shared memory, then one thread per
//     output (128 a tile) deposits its 75 pairs into 44 limbs, folds the top
//     with 2^507 mod p and runs REDC (field_device.cuh); the limbs are
//     stored by consecutive threads for consecutive outputs.
// The MMA does 80/38 times the pair product's work (about 36 G int8
// operations at the evaluations, 18 us at the tensor cores' peak), which
// the card has to spare everywhere but at the evaluations.
//
// The epilogue's arithmetic. T = sum of a K range's W over the ranges, so
// T[s] < 38 * 127^2 * K < 2^31 * splits; lo = T & 0xFFFF and hi = T >> 16
// (below 2^15 * splits < 2^26 for K <= MAX_K):
//   1. lo and hi are deposited at bits 7s and 7s + 16 into 44 13-bit limb
//      accumulators (the value is below K * 2^520 < 2^538); each deposit
//      adds pieces below 2^13 to three limbs, and a limb takes about twelve
//      pieces, so below 2^17;
//   2. one carry chain; limbs 39-43 (bits >= 507, below 2^31) times
//      2^507 mod p are added to limbs 0-38: the 5 x 20 products are below
//      2^26, an accumulator takes at most 5 of them, so below 2^29; one
//      carry chain. The value is then below 2^507 + 2^31 * p < p * R, which
//      is what REDC needs;
//   3. redc (field_device.cuh, mont_mul's reduction): accumulators start
//      below 2^13 and take at most 20 products below 2^26 plus a carry, so
//      below 2^31; then the conditional subtract of p.
//
// Interface: plain C, loaded with ctypes, in one library with
// field_kernels.cu. Each entry launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue for
// a shape it does not take).
#include <cuda.h>

#include "field_device.cuh"

#define NP 38  // 7-bit planes of 20 x 13 bits
#define PB 7
#define NW 44  // limbs of the recomposed double-width sum
#define TOP 39  // limbs at bit >= 13 * 39 = 507 are folded down
#define NWIDE (2 * NP - 1)  // wide planes s = u + v

// 2^507 mod p for Fr, plain (not Montgomery) limbs. The loader checks it
// against the Python side (zk_mxu_params).
static __constant__ uint32_t kFold[NL] = {
    2926u, 1928u, 880u, 3230u, 2398u, 352u, 6351u, 2501u, 2175u, 1936u,
    6723u, 8085u, 2311u, 4225u, 5905u, 1768u, 3049u, 7802u, 6084u, 75u};
static const uint32_t hFold[NL] = {
    2926u, 1928u, 880u, 3230u, 2398u, 352u, 6351u, 2501u, 2175u, 1936u,
    6723u, 8085u, 2311u, 4225u, 5905u, 1768u, 3049u, 7802u, 6084u, 75u};

// ---------------------------------------------------------------------------
// Per-element and per-output arithmetic
// ---------------------------------------------------------------------------

// Plane u (bits [7u, 7u+7)) of the value in limbs a[0..20], a[20] = 0;
// u is a constant once the caller's loop is unrolled.
__device__ __forceinline__ uint32_t plane7(const uint32_t* a, int u) {
  const int lo = u * PB / LB, off = u * PB % LB;
  return ((a[lo] >> off) | (a[lo + 1] << (LB - off))) & 0x7Fu;
}

// Add w (< 2^22) at bit position BP into 13-bit limb accumulators.
template <int BP>
__device__ __forceinline__ void deposit(uint32_t* acc, uint32_t w) {
  constexpr int j = BP / LB, off = BP % LB;
  acc[j] += (w & ((1u << (LB - off)) - 1u)) << off;
  uint32_t rest = w >> (LB - off);
  acc[j + 1] += rest & LMASK;
  acc[j + 2] += rest >> LB;
}

// Wide planes S, S+1, ..., NWIDE-1: lo[s] and hi[s] deposited at bits 7s
// and 7s + 16.
template <int S>
__device__ __forceinline__ void deposit_wide(const uint32_t* lo,
                                             const uint32_t* hi,
                                             uint32_t* acc) {
  deposit<PB * S>(acc, lo[S]);
  deposit<PB * S + 16>(acc, hi[S]);
  if constexpr (S + 1 < NWIDE) deposit_wide<S + 1>(lo, hi, acc);
}

// The epilogue of one output from its wide-plane sums -> r, canonical limbs
// of (sum_s (lo[s] + 2^16 hi[s]) 2^(7s)) * R^-1 mod p, p = Fr's.
__device__ __forceinline__ void reduce_wide(const uint32_t* lo,
                                            const uint32_t* hi, uint32_t* r) {
  uint32_t acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = 0;
  deposit_wide<0>(lo, hi, acc);
  carry_chain<NW>(acc);
  uint32_t t[2 * NL];
#pragma unroll
  for (int s = 0; s < 2 * NL; ++s) t[s] = s < TOP ? acc[s] : 0;
#pragma unroll
  for (int i = 0; i < NW - TOP; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) t[i + j] += acc[TOP + i] * kFold[j];
  }
  carry_chain<2 * NL>(t);
  redc<0>(t, r);
}

// ---------------------------------------------------------------------------
// zk_planes7
// ---------------------------------------------------------------------------

#define PT 32                     // planes7 tile: 32 elements x 32 of K
#define PT_ROW (NP * PT + 4)      // bytes per element row of the tile; the
                                  // odd word count spreads rows over banks

// x (20, Bt, *, *) int32 limbs read through strides (sl, sb, sr, sk) with
// R rows r and K columns k; out (Bt, NP*R, Kp) int8, plane u of element
// (r, k) at row r*rs + u*us, column k; columns K..Kp-1 zero.
__global__ void __launch_bounds__(256)
    k_planes7(const int32_t* __restrict__ x, int64_t sl, int64_t sb,
              int64_t sr, int64_t sk, int64_t R, int64_t K, int64_t Kp,
              int64_t rs, int64_t us, int8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t tile[PT * PT_ROW];
  const int64_t b = blockIdx.z;
  const int64_t r0 = (int64_t)blockIdx.y * PT, k0 = (int64_t)blockIdx.x * PT;
  const bool k_fast = sk <= sr;  // load along the contiguous axis
  x += b * sb;
  for (int e = threadIdx.x; e < PT * PT; e += blockDim.x) {
    const int rr = k_fast ? e / PT : e % PT;
    const int kk = k_fast ? e % PT : e / PT;
    const int64_t r = r0 + rr, k = k0 + kk;
    uint32_t a[NL + 1];
    const bool in = r < R && k < K;
#pragma unroll
    for (int j = 0; j < NL; ++j)
      a[j] = in ? (uint32_t)__ldg(x + j * sl + r * sr + k * sk) : 0u;
    a[NL] = 0;
    uint8_t* row = tile + rr * PT_ROW + kk;
#pragma unroll
    for (int u = 0; u < NP; ++u) row[u * PT] = (uint8_t)plane7(a, u);
  }
  __syncthreads();
  // 4-byte words: (element row, plane, word of the 32 K columns)
  int8_t* o = out + b * (NP * R * Kp) + k0;
  for (int w = threadIdx.x; w < PT * NP * (PT / 4); w += blockDim.x) {
    const int rr = w / (NP * (PT / 4)), rem = w % (NP * (PT / 4));
    const int u = rem / (PT / 4), q = rem % (PT / 4);
    const int64_t r = r0 + rr;
    if (r >= R) continue;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(tile + rr * PT_ROW + u * PT) + q;
    *reinterpret_cast<uint32_t*>(o + (r * rs + u * us) * Kp + q * 4) = *src;
  }
}

// ---------------------------------------------------------------------------
// zk_plane_mm_redc
// ---------------------------------------------------------------------------

#define TX 64                      // X elements (MMA rows) per tile
#define TY 2                       // Y elements per tile
#define WN 80                      // MMA columns per Y element (75 used)
#define NN (TY * WN)               // the wgmma N
#define BK 128                     // bytes of K per chunk
#define XSTAGE (TX * BK)           // one stage of X: 8 KB, swizzled
#define NST 7                      // stages in the X ring
#define YZ 40                      // zero rows above the Y window (>= 37)
#define YRB 200                    // rows of a Y window: YZ + NN
#define YBUF (YRB * BK)            // one Y window, unswizzled: 25,600 B
#define YCOPY (NP * 16)            // one TMA copy into a Y window: 608 B
#define RING (NST * XSTAGE + 2 * YBUF)
#define LDW (NN + 1)               // staged row pitch (odd: no bank conflicts)
#define MAX_CHUNKS 27              // chunks of K a range: W < 2^31
#define MM_THREADS 128
#define SMEM_BYTES (1024 + RING)   // 1024: alignment slack

static_assert(YZ >= NP - 1 && YZ + NN <= YRB, "Y window rows");
static_assert(YZ * 16 % 128 == 0 && WN * 16 % 128 == 0 && YBUF % 1024 == 0,
              "TMA destinations in a Y window are 128-byte aligned");
static_assert(2 * TX * LDW * 4 <= RING, "the staged sums fit in the ring");
static_assert((int64_t)MAX_CHUNKS * BK * NP * 127 * 127 < (1ll << 31),
              "a range's sums stay below 2^31");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// mbarrier and TMA (cp.async.bulk.tensor) primitives
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// keep the compiler from moving the sums across the asynchronous MMAs
__device__ __forceinline__ void reg_fence(int32_t* acc) {
#pragma unroll
  for (int e = 0; e < NN / 2; ++e) asm volatile("" : "+r"(acc[e])::"memory");
}

// wgmma shared-memory descriptors of K-major tiles: X in the 128-byte
// swizzle (8-row groups 1024 bytes apart, layout type 1), Y unswizzled
// (layout type 0: 16-byte rows, 8-row groups 128 bytes apart, 16-byte K
// columns YBUF / 8 bytes apart).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_plain(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)((YRB * 16) >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// d (64 x 160 int32, the m64n160 accumulator fragment) += a (64 x 32 s8) .
// b (160 x 32 s8)^T, both from shared memory.
__device__ __forceinline__ void wgmma_n160(int32_t* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

// One stage: NK MMAs of 32 bytes of K, issued and committed as one group
// with no other instruction on the sums in between; returns once the
// previous stage's group is done (this one may still run).
template <int NK>
__device__ __forceinline__ void mma_stage(int32_t* acc, uint32_t xs,
                                          uint32_t yv) {
  reg_fence(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_n160(acc, desc_sw128(xs + kk * 32),
               desc_plain(yv + 2 * kk * (YRB * 16)));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  reg_fence(acc);
}

// X (EXn elements) and Y (EYn elements) planes, (*, E, 38, Kp) int8, read
// through the tensor maps mx (box: 128 bytes of one plane of 64 elements,
// 128-byte swizzle) and my (box: 16 bytes of the 38 planes of one element);
// bx, by: 1 if the operand has a batch axis, 0 if it is shared. Block
// ((b, xt, yt), s) takes X elements xt*TX.., Y elements yt*TY.. and the K
// chunks of split s. out (20, lanes) limbs, output (m, n) of batch entry b
// at (b*M + m)*N + n with (m, n) = (x, y), or (y, x) when swap. ws
// (tiles, TX, NN) uint64 and cnt (tiles) are zeroed by the caller when
// splits > 1.
__global__ void __launch_bounds__(MM_THREADS)
    k_plane_mm_redc(const __grid_constant__ CUtensorMap mx,
                    const __grid_constant__ CUtensorMap my, int bx, int by,
                    int64_t EXn, int64_t EYn, int64_t Kp, int xtiles,
                    int ytiles, int splits, int swap, int64_t M, int64_t N,
                    uint32_t* __restrict__ out, int64_t lanes,
                    unsigned long long* __restrict__ ws,
                    int* __restrict__ cnt) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST];
  __shared__ int s_last;
  // the swizzle acts on address bits [4, 10): the ring starts on 1024 bytes
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* smem = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t xbase = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ybase = xbase + NST * XSTAGE;
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(full);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int64_t bid = blockIdx.x;
  const int split = (int)(bid % splits);
  bid /= splits;
  const int yt = (int)(bid % ytiles);
  bid /= ytiles;
  const int xt = (int)(bid % xtiles);
  const int64_t b = bid / xtiles;
  const int64_t tile = (b * xtiles + xt) * ytiles + yt;
  const int xn = (int)min64(TX, EXn - (int64_t)xt * TX);
  const int yn = (int)min64(TY, EYn - (int64_t)yt * TY);
  const int64_t nchunks = (Kp + BK - 1) / BK;
  const int j0 = (int)(nchunks * split / splits);
  const int steps = (int)(nchunks * (split + 1) / splits - j0) * NP;

  // the Y windows' zero rows (and the rows of a missing element), written
  // before any copy lands there and made visible to the MMAs' proxy
  for (int e = tid; e < 2 * YBUF / 16; e += MM_THREADS)
    reinterpret_cast<int4*>(smem + NST * XSTAGE)[e] = make_int4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage i (thread 0): plane u = i % 38 of chunk j0 + i / 38 of the 64 X
  // elements into ring slot i % NST; with u = 0 also the chunk's Y window
  // into window j % 2, element e's plane v at row YZ + e*WN + v, in
  // 16-byte K columns YRB * 16 bytes apart
  auto load = [&](int i) {
    const int j = j0 + i / NP, u = i % NP, k0 = j * BK;
    const int kb = (int)min64(BK, Kp - k0);
    const uint32_t bar = bar0 + 8 * (i % NST);
    const int ycopies = u == 0 ? yn * (kb / 16) : 0;
    mbar_expect(bar, XSTAGE + ycopies * YCOPY);
    tma_load(xbase + (i % NST) * XSTAGE, &mx, bar, k0, u, xt * TX,
             (int)(b * bx));
    const uint32_t ys = ybase + (uint32_t)(j & 1) * YBUF;
    for (int c = 0; c < ycopies; ++c) {
      const int e = c / (kb / 16), q = c % (kb / 16);
      tma_load(ys + q * (YRB * 16) + (YZ + e * WN) * 16, &my, bar,
               k0 + 16 * q, 0, yt * TY + e, (int)(b * by));
    }
  };

  int32_t acc[NN / 2];
#pragma unroll
  for (int e = 0; e < NN / 2; ++e) acc[e] = 0;

  if (tid == 0)
    for (int i = 0; i < NST - 1 && i < steps; ++i) load(i);
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    mbar_wait(bar0 + 8 * (i % NST), (uint32_t)(i / NST) & 1u);
    const int j = j0 + i / NP, u = i % NP;
    const uint32_t xs = xbase + (i % NST) * XSTAGE;
    // plane u's band: the window read from u rows higher
    const uint32_t yv = ybase + (uint32_t)(j & 1) * YBUF + (YZ - u) * 16;
    switch ((int)min64(BK, Kp - (int64_t)j * BK) / 32) {
      case 1: mma_stage<1>(acc, xs, yv); break;
      case 2: mma_stage<2>(acc, xs, yv); break;
      case 3: mma_stage<3>(acc, xs, yv); break;
      default: mma_stage<4>(acc, xs, yv); break;
    }
    // stage i-1's MMAs are done (an MMA completes for the whole
    // warpgroup), so its slot takes stage i-1 + NST while stage i's run;
    // the Y window that stage may fill was last read two chunks ago
    if (tid == 0 && i - 1 + NST < steps) load(i - 1 + NST);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  reg_fence(acc);
  __syncthreads();  // every MMA has read the ring: it becomes the staging

  // sum 4jn + 2h + c of this thread: X row 16warp + lane/4 + 8h, column
  // 8jn + 2(lane%4) + c, i.e. Y element col / WN and s = col % WN
  uint32_t* lo = reinterpret_cast<uint32_t*>(smem);
  uint32_t* hi = lo + TX * LDW;
  if (splits == 1) {
#pragma unroll
    for (int jn = 0; jn < NN / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = warp * 16 + (lane >> 2) + 8 * h;
          const int col = jn * 8 + 2 * (lane & 3) + c;
          const uint32_t w = (uint32_t)acc[4 * jn + 2 * h + c];
          lo[x * LDW + col] = w & 0xFFFFu;
          hi[x * LDW + col] = w >> 16;
        }
  } else {
    unsigned long long* wt = ws + tile * (TX * NN);
#pragma unroll
    for (int jn = 0; jn < NN / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = warp * 16 + (lane >> 2) + 8 * h;
          const int col = jn * 8 + 2 * (lane & 3) + c;
          if (x < xn && col % WN < NWIDE && col / WN < yn)
            atomicAdd(wt + x * NN + col,
                      (unsigned long long)(uint32_t)acc[4 * jn + 2 * h + c]);
        }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(cnt + tile, 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int e = tid; e < TX * NN; e += MM_THREADS) {
      const unsigned long long t = __ldcg(wt + e);
      const int x = e / NN, col = e - x * NN;
      lo[x * LDW + col] = (uint32_t)(t & 0xFFFFu);
      hi[x * LDW + col] = (uint32_t)(t >> 16);
    }
  }
  __syncthreads();

  // thread t: output (x, y) = (t % TX, t / TX)
  const int x = tid % TX, y = tid / TX;
  if (x < xn && y < yn) {
    uint32_t r[NL];
    reduce_wide(lo + x * LDW + y * WN, hi + x * LDW + y * WN, r);
    const int64_t gx = (int64_t)xt * TX + x, gy = (int64_t)yt * TY + y;
    const int64_t m = swap ? gy : gx, n = swap ? gx : gy;
#pragma unroll
    for (int jl = 0; jl < NL; ++jl)
      out[jl * lanes + (b * M + m) * N + n] = r[jl];
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// planes (nb, E, 38, Kp) int8 at batch stride sb bytes; box (bk bytes of K,
// bp planes, be elements, 1)
static int plane_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int64_t nb, int64_t E, int64_t Kp, int64_t sb,
                     uint32_t bk, uint32_t bp, uint32_t be,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)Kp, NP, (cuuint64_t)E,
                              (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)Kp, (cuuint64_t)(NP * Kp),
                                 (cuuint64_t)(nb > 1 ? sb : NP * Kp * E)};
  const cuuint32_t box[4] = {bk, bp, be, 1}, estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr),
                dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

extern "C" {

// Copies Fr's 2^507 mod p into out[0..20]; returns 0.
int zk_mxu_params(uint32_t* out) {
  for (int j = 0; j < NL; ++j) out[j] = hFold[j];
  return 0;
}

int zk_planes7(const void* x, int64_t sl, int64_t sb, int64_t sr, int64_t sk,
               int64_t nb, int64_t R, int64_t K, int64_t Kp, int64_t rs,
               int64_t us, void* out, void* stream) {
  if (nb <= 0 || R <= 0 || K <= 0 || Kp % PT || Kp < K || nb > 65535 ||
      (R + PT - 1) / PT > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(Kp / PT), (unsigned)((R + PT - 1) / PT), (unsigned)nb);
  k_planes7<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, sl, sb, sr, sk, R, K, Kp, rs, us, (int8_t*)out);
  return (int)cudaGetLastError();
}

// Built for Fr (field 0) only, the one field the prover contracts over.
// X, Y: planes (nbx, EXn*38, Kp) and (nby, EYn*38, Kp), nbx and nby each 1
// (shared by the batch) or nb, batch strides sxb, syb in bytes; out
// (20, nb*M*N); with splits > 1, ws (tiles * 64 * 160 uint64) and cnt
// (tiles int32) zeroed, tiles = nb * ceil(EXn/64) * ceil(EYn/2). Each split
// takes at most 27 chunks of 128 bytes of K.
int zk_plane_mm_redc(int field, const void* X, const void* Y, int64_t nbx,
                     int64_t nby, int64_t sxb, int64_t syb, int64_t nb,
                     int64_t EXn, int64_t EYn, int64_t Kp, int64_t splits,
                     int64_t swap, int64_t M, int64_t N, void* out, void* ws,
                     void* cnt, void* stream) {
  const int64_t nchunks = (Kp + BK - 1) / BK;
  const int64_t xtiles = (EXn + TX - 1) / TX, ytiles = (EYn + TY - 1) / TY;
  const int64_t blocks = nb * xtiles * ytiles * splits;
  if (field != 0 || nb <= 0 || EXn <= 0 || EYn <= 0 || Kp <= 0 || Kp % 32 ||
      (nbx != 1 && nbx != nb) || (nby != 1 && nby != nb) || sxb % 16 ||
      syb % 16 || splits < 1 || splits > nchunks ||
      (nchunks + splits - 1) / splits > MAX_CHUNKS ||
      (splits > 1 && (!ws || !cnt)) ||
      (swap ? EXn != N || EYn != M : EXn != M || EYn != N) ||
      blocks > 0x7FFFFFFF || EXn > 0x7FFFFFFF || Kp > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  CUtensorMap mx, my;
  int rc = plane_map(encode, &mx, X, nbx, EXn, Kp, sxb, BK, 1, TX,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc)
    rc = plane_map(encode, &my, Y, nby, EYn, Kp, syb, 16, NP, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc) return rc;
  // above 48 KB of dynamic shared memory only after this attribute, which
  // is set per device
  static bool attr_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(k_plane_mm_redc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  k_plane_mm_redc<<<(unsigned)blocks, MM_THREADS, SMEM_BYTES,
                    (cudaStream_t)stream>>>(
      mx, my, nbx > 1, nby > 1, EXn, EYn, Kp, (int)xtiles, (int)ytiles,
      (int)splits, (int)swap, M, N, (uint32_t*)out, nb * M * N,
      (unsigned long long*)ws, (int*)cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
