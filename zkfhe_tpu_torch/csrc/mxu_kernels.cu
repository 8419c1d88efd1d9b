// The modular matmul's three kernels for Hopper (sm_90a):
//   (sum_k A[m, k] * B[k, n]) * R^-1 mod p, A (20, Bt, M, K) and
//   B (20, Bt, K, N) canonical 13-bit limbs, out (20, Bt, M, N).
//
// Replaces zkfhe_tpu/ops/mxu_field.py:130 mat_mul_mont. That is not a
// Pallas kernel: it is an XLA s8 x s8 -> s32 dot_general with a jnp
// epilogue, shaped around the TPU's int8 matrix unit. The scheme stays:
//
//   zk_planes7      <- to_planes7 (:48) and the transposes (:140-141): each
//                      260-bit operand as 38 planes of 7 bits in int8, in
//                      the layouts the product reads: lhs (Bt, M*38, Kp),
//                      row m*38+u; rhsT (Bt, 38*N, Kp), row v*N+n; both
//                      K-contiguous, K padded with zero planes to Kp, a
//                      multiple of 32. Operands are read through their
//                      strides, so a batch broadcast with stride 0 is read
//                      in place.
//   zk_plane_mm_s8  <- the dot_general (:142): C (Bt, M*38, 38*N) int32 =
//                      lhs . rhsT^T on the int8 tensor cores
//                      (mma.sync m16n8k32 s8.s8.s32). Every entry is a sum
//                      of at most K products of two values in [0, 127], so
//                      below 127^2 * K < 2^31 for K <= MAX_K.
//   zk_mxu_epilogue <- :146-159 (split, pair fold, _wide_planes_to_limbs,
//                      mont_reduce_wide): one thread per output, everything
//                      in registers.
//
// What bounds each on an H100 (3.35 TB/s; 1,979 T int8 tensor-core op/s;
// about 33.5 T 32-bit integer op/s, a multiply-add counted as 2):
//   * zk_planes7 reads 80 B and writes 38 B per operand element: bytes.
//     A block stages a 32 x 32 tile of elements' planes in shared memory,
//     so that its loads run along whichever of the operand's two axes is
//     contiguous and its stores along K, 32 bytes at a time.
//   * zk_plane_mm_s8: bytes at every shape of the prover. At the
//     evaluations the planes of A (40 MB at K = 8192) take 12 us, the
//     15 G int8 operations 8 us at the tensor cores' peak; at the SHPLONK
//     folds an int32 C of 47 MB comes from planes of 20 MB (K = 64).
//     64 x 64 output tiles, four warps of 32 x 32, K in steps of 128 bytes
//     staged in shared memory (rows padded to 144 bytes so that fragment
//     loads hit 32 distinct banks), the next step's 16-byte loads in
//     flight during the current step's MMAs. No wgmma or TMA yet.
//   * zk_mxu_epilogue reads 1444 int32 of C per output (5776 B) and does
//     about 8,550 integer operations: bytes. Thread i takes output
//     (b, m, n) with n fastest, so for every (u, v) a warp's loads of
//     C[b, m, u, v, n] are contiguous in n.
//
// The epilogue's arithmetic (C's entries are in [0, 2^31)):
//   1. plane pair (u, v) weighs 2^(7(u+v)); each entry is split into its
//      low 16 bits and the rest (< 2^15) before the pair fold, whose sums
//      of up to 38 raw entries would pass 2^32. For each wide plane s = u+v
//      the low halves sum below 38 * 2^16 < 2^22 and the high halves below
//      38 * 2^15 < 2^21, accumulated unsigned;
//   2. the two sums are deposited at bits 7s and 7s + 16 into 44 13-bit
//      limb accumulators (the sum is below 2^556 < 2^(13*44)); a limb takes
//      pieces below 2^13 from about nine planes of 38 pairs, so below 2^22;
//   3. one carry chain; limbs 39-43 (bits >= 507, below 2^49) times
//      2^507 mod p are added to limbs 0-38: the 5 x 20 products are below
//      2^26, an accumulator takes at most 5 of them, so below 2^29; one
//      carry chain. The value is then below 2^507 + 2^49 * p < p * R, which
//      is what REDC needs;
//   4. redc (field_device.cuh, mont_mul's reduction): accumulators start
//      below 2^13 and take at most 20 products below 2^26 plus a carry, so
//      below 2^31; then the conditional subtract of p.
//
// Interface: plain C, loaded with ctypes, in one library with
// field_kernels.cu. Each entry launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue for
// a shape it does not take).
#include "field_device.cuh"

#define NP 38  // 7-bit planes of 20 x 13 bits
#define PB 7
#define NW 44  // limbs of the recomposed double-width sum
#define TOP 39  // limbs at bit >= 13 * 39 = 507 are folded down

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

// Wide planes S, S+1, ..., 2*NP-2: c points at C[b, m, 0, 0, n], pair
// (u, v) at c[(NP*u + v) * N].
template <int S>
__device__ __forceinline__ void fold_planes(const int32_t* __restrict__ c,
                                            int64_t N, uint32_t* acc) {
  constexpr int u0 = S < NP ? 0 : S - (NP - 1);
  constexpr int u1 = S < NP ? S : NP - 1;
  uint32_t lo = 0, hi = 0;
  // 16 loads in flight per step: on an H100 9-44% faster than the full
  // unroll of the 1444 loads (90 registers against 130), at 40% of its
  // nvcc time (21 s against 54 s when built for both fields)
#pragma unroll 16
  for (int u = u0; u <= u1; ++u) {
    uint32_t x = (uint32_t)__ldg(c + (int64_t)((NP - 1) * u + S) * N);
    lo += x & 0xFFFFu;
    hi += x >> 16;
  }
  deposit<PB * S>(acc, lo);
  deposit<PB * S + 16>(acc, hi);
  if constexpr (S + 1 < 2 * NP - 1) fold_planes<S + 1>(c, N, acc);
}

// The epilogue of one output: c as in fold_planes -> r, canonical limbs of
// (sum_{u,v} C[u, v] 2^(7(u+v))) * R^-1 mod p, p = Fr's.
__device__ __forceinline__ void epilogue_lane(const int32_t* __restrict__ c,
                                              int64_t N, uint32_t* r) {
  uint32_t acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = 0;
  fold_planes<0>(c, N, acc);
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
// Kernels
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

#define MM_BM 64
#define MM_BN 64
#define MM_BK 128                 // bytes of K per step
#define MM_ROW (MM_BK + 16)       // shared row pitch: 36 words, so rows
                                  // g = 0..7 start on banks 4g
#define MM_THREADS 128

__device__ __forceinline__ void mma_s8(int32_t* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C (Bt, MR, NC) = lhs (Bt, MR, Kp) . rhsT (Bt, NC, Kp)^T; Kp % 32 == 0,
// NC even. Rows and columns past MR and NC are masked; K chunks past Kp
// load as zeros.
__global__ void __launch_bounds__(MM_THREADS)
    k_plane_mm_s8(const int8_t* __restrict__ lhs,
                  const int8_t* __restrict__ rhsT, int32_t* __restrict__ C,
                  int64_t MR, int64_t NC, int64_t Kp) {
  __shared__ __align__(16) uint8_t As[MM_BM * MM_ROW];
  __shared__ __align__(16) uint8_t Bs[MM_BN * MM_ROW];
  const int64_t b = blockIdx.z;
  const int64_t m0 = (int64_t)blockIdx.y * MM_BM;
  const int64_t n0 = (int64_t)blockIdx.x * MM_BN;
  lhs += b * MR * Kp;
  rhsT += b * NC * Kp;
  C += b * MR * NC;
  const int tid = threadIdx.x;
  // each thread moves 4 chunks of 16 bytes of each tile per step
  constexpr int CH = MM_BM * MM_BK / 16 / MM_THREADS;
  int4 ra[CH], rb[CH];
  auto fetch = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = tid + i * MM_THREADS;
      const int row = c / (MM_BK / 16), kc = (c % (MM_BK / 16)) * 16;
      const bool kin = k0 + kc < Kp;
      ra[i] = (kin && m0 + row < MR)
                  ? __ldg(reinterpret_cast<const int4*>(
                        lhs + (m0 + row) * Kp + k0 + kc))
                  : make_int4(0, 0, 0, 0);
      rb[i] = (kin && n0 + row < NC)
                  ? __ldg(reinterpret_cast<const int4*>(
                        rhsT + (n0 + row) * Kp + k0 + kc))
                  : make_int4(0, 0, 0, 0);
    }
  };
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  int32_t acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  fetch(0);
  for (int64_t k0 = 0; k0 < Kp; k0 += MM_BK) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = tid + i * MM_THREADS;
      const int row = c / (MM_BK / 16), kc = (c % (MM_BK / 16)) * 16;
      *reinterpret_cast<int4*>(As + row * MM_ROW + kc) = ra[i];
      *reinterpret_cast<int4*>(Bs + row * MM_ROW + kc) = rb[i];
    }
    __syncthreads();
    if (k0 + MM_BK < Kp) fetch(k0 + MM_BK);
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* p = As + (wm + mi * 16 + g) * MM_ROW + kk + 4 * t;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * MM_ROW);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * MM_ROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = Bs + (wn + ni * 8 + g) * MM_ROW + kk + 4 * t;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
  // accumulator q of tile (mi, ni): row g (+8 for q >= 2), columns 2t, 2t+1
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int64_t row = m0 + wm + mi * 16 + g;
      const int64_t col = n0 + wn + ni * 8 + 2 * t;
      if (col >= NC) continue;
      if (row < MR)
        *reinterpret_cast<int2*>(C + row * NC + col) =
            make_int2(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < MR)
        *reinterpret_cast<int2*>(C + (row + 8) * NC + col) =
            make_int2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// C (Bt*M, NP, NP, N) int32 -> out (20, Bt*M*N) canonical Fr limbs.
__global__ void __launch_bounds__(64)
    k_mxu_epilogue(const int32_t* __restrict__ C, uint32_t* __restrict__ out,
                   int64_t lanes, int64_t N) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const int64_t bm = i / N, n = i - bm * N;
  uint32_t r[NL];
  epilogue_lane(C + bm * (NP * NP) * N + n, N, r);
  store(out, lanes, i, r);
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

int zk_plane_mm_s8(const void* lhs, const void* rhsT, void* C, int64_t nb,
                   int64_t MR, int64_t NC, int64_t Kp, void* stream) {
  if (nb <= 0 || MR <= 0 || NC <= 0 || Kp <= 0 || Kp % 32 || NC % 2 ||
      nb > 65535 || (MR + MM_BM - 1) / MM_BM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((NC + MM_BN - 1) / MM_BN),
            (unsigned)((MR + MM_BM - 1) / MM_BM), (unsigned)nb);
  k_plane_mm_s8<<<grid, MM_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)lhs, (const int8_t*)rhsT, (int32_t*)C, MR, NC, Kp);
  return (int)cudaGetLastError();
}

// Built for Fr (field 0) only, the one field the prover contracts over:
// Fq would need its fold constant, a template instance and ~10 s more nvcc.
int zk_mxu_epilogue(int field, const void* C, void* out, int64_t lanes,
                    int64_t N, void* stream) {
  if (field != 0 || lanes <= 0 || N <= 0 || lanes % N)
    return (int)cudaErrorInvalidValue;
  k_mxu_epilogue<<<(unsigned)((lanes + 63) / 64), 64, 0,
                      (cudaStream_t)stream>>>((const int32_t*)C,
                                              (uint32_t*)out, lanes, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
