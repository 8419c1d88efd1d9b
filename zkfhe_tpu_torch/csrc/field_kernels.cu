// BN254 field kernels for Hopper (sm_90a): 20 limbs of 13 bits, Montgomery
// R = 2^260, one lane per thread.
//
// Replaces the Pallas kernels of zkfhe_tpu/ops/pallas_field.py:
//   zk_mont_mul  <- _mont_mul_kernel (_k_mont_mul, _k_carry, _k_cond_sub_p)
//   zk_add       <- _add_kernel      (_k_add)
//   zk_sub       <- _sub_kernel      (_k_sub)
//   zk_bfly_dif  <- _bfly_dif_kernel (fused Stockham DIF butterfly)
//   zk_bfly      <- _bfly_kernel     (fused DIT butterfly)
// and computes what they compute, limb for limb: a 20x20 schoolbook product
// into 40 uint32 accumulators, 20 interleaved reduction rounds, one carry
// chain and one conditional subtract of p. Accumulators stay below 2^31.8
// (zkfhe_tpu/ops/field.py mont_mul), so uint32 registers suffice.
//
// Layout: limb-major (20, n) int32 arrays, limb j of lane i at j*n + i, so a
// warp's 32 loads of one limb are one coalesced 128-byte transaction. Each
// thread keeps its operands and the 40 accumulators in registers; nothing
// goes through shared memory.
//
// What bounds it on an H100: mont_mul moves 240 B per lane (two 80 B reads,
// one 80 B write) and issues about 800 32-bit multiply-adds (400 schoolbook,
// 400 reduction). At 3.35 TB/s the bytes take 72 ps per lane; the multiply-
// adds take 48 ps at half the 67 T/s FP32 rate (IMAD issues at half rate),
// so mont_mul sits near the balance point and add/sub/bfly_dif are bound by
// bytes (bfly moves 400 B and does one mont_mul per lane, like bfly_dif).
// The design keeps each lane's traffic to one read of every input
// limb and one write of every output limb.
//
// Interface: plain C, loaded with ctypes. Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
#include "field_device.cuh"

// Host copies of field_device.cuh's constants, for zk_field_params.
static const uint32_t hP[2][NL] = {
    {1u, 0u, 1276u, 1003u, 5182u, 6216u, 1765u, 2319u, 5096u, 2369u,
     5655u, 770u, 7016u, 2082u, 1761u, 5125u, 305u, 5015u, 6419u, 96u},
    {7495u, 999u, 1462u, 280u, 5058u, 1350u, 455u, 4653u, 362u, 3260u,
     5655u, 770u, 7016u, 2082u, 1761u, 5125u, 305u, 5015u, 6419u, 96u},
};
static const uint32_t hMU[2] = {8191u, 905u};

__device__ __forceinline__ void load(const uint32_t* __restrict__ x,
                                     int64_t n, int64_t i, uint32_t* v) {
#pragma unroll
  for (int j = 0; j < NL; ++j) v[j] = __ldg(x + j * n + i);
}

template <int F>
__device__ __forceinline__ void f_add(const uint32_t* a, const uint32_t* b,
                                      uint32_t* out) {
#pragma unroll
  for (int j = 0; j < NL; ++j) out[j] = a[j] + b[j];
  carry_chain(out);
  cond_sub_p<F>(out);
}

template <int F>
__device__ __forceinline__ void f_sub(const uint32_t* a, const uint32_t* b,
                                      uint32_t* out) {
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    uint32_t v = a[j] + (1u << LB) - b[j] - borrow;
    out[j] = v & LMASK;
    borrow = 1u - (v >> LB);
  }
  if (borrow) {  // a < b: add p back
#pragma unroll
    for (int j = 0; j < NL; ++j) out[j] += kP[F][j];
    carry_chain(out);
  }
}

template <int F>
__device__ __forceinline__ void f_mont_mul(const uint32_t* a,
                                           const uint32_t* b, uint32_t* out) {
  uint32_t t[2 * NL];
#pragma unroll
  for (int s = 0; s < 2 * NL; ++s) t[s] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) t[i + j] += a[i] * b[j];
  }
  redc<F>(t, out);
}

template <int F>
__global__ void __launch_bounds__(256)
    k_mont_mul(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NL], y[NL], r[NL];
  load(a, n, i, x);
  load(b, n, i, y);
  f_mont_mul<F>(x, y, r);
  store(out, n, i, r);
}

template <int F>
__global__ void __launch_bounds__(256)
    k_add(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
          uint32_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NL], y[NL], r[NL];
  load(a, n, i, x);
  load(b, n, i, y);
  f_add<F>(x, y, r);
  store(out, n, i, r);
}

template <int F>
__global__ void __launch_bounds__(256)
    k_sub(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
          uint32_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NL], y[NL], r[NL];
  load(a, n, i, x);
  load(b, n, i, y);
  f_sub<F>(x, y, r);
  store(out, n, i, r);
}

// (u, v, tw) -> (u + v, (u - v) * tw), all mod p.
template <int F>
__global__ void __launch_bounds__(256)
    k_bfly_dif(const uint32_t* __restrict__ u, const uint32_t* __restrict__ v,
               const uint32_t* __restrict__ tw, uint32_t* __restrict__ hi,
               uint32_t* __restrict__ lo, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NL], y[NL], r[NL];
  load(u, n, i, x);
  load(v, n, i, y);
  f_add<F>(x, y, r);
  store(hi, n, i, r);
  f_sub<F>(x, y, r);
  load(tw, n, i, y);
  f_mont_mul<F>(r, y, x);
  store(lo, n, i, x);
}

// (u, v, tw) -> (u + v * tw, u - v * tw), all mod p.
template <int F>
__global__ void __launch_bounds__(256)
    k_bfly(const uint32_t* __restrict__ u, const uint32_t* __restrict__ v,
           const uint32_t* __restrict__ tw, uint32_t* __restrict__ hi,
           uint32_t* __restrict__ lo, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NL], y[NL], t[NL], r[NL];
  load(v, n, i, x);
  load(tw, n, i, y);
  f_mont_mul<F>(x, y, t);
  load(u, n, i, x);
  f_add<F>(x, t, r);
  store(hi, n, i, r);
  f_sub<F>(x, t, r);
  store(lo, n, i, r);
}

static inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + 255) / 256);
}

#define DISPATCH2(KERNEL)                                                    \
  if (n <= 0) return (int)cudaSuccess;                                       \
  cudaStream_t s = (cudaStream_t)stream;                                     \
  if (field == 0)                                                            \
    KERNEL<0><<<blocks_for(n), 256, 0, s>>>(                                 \
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);          \
  else if (field == 1)                                                       \
    KERNEL<1><<<blocks_for(n), 256, 0, s>>>(                                 \
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);          \
  else                                                                       \
    return (int)cudaErrorInvalidValue;                                       \
  return (int)cudaGetLastError();

extern "C" {

// Copies p's limbs and mu of field f into out[0..20], so the loader can
// check them against the Python side. Returns 0, or -1 for an unknown field.
int zk_field_params(int f, uint32_t* out) {
  if (f < 0 || f > 1) return -1;
  for (int j = 0; j < NL; ++j) out[j] = hP[f][j];
  out[NL] = hMU[f];
  return 0;
}

int zk_mont_mul(int field, const void* a, const void* b, void* out,
                int64_t n, void* stream) {
  DISPATCH2(k_mont_mul)
}

int zk_add(int field, const void* a, const void* b, void* out, int64_t n,
           void* stream) {
  DISPATCH2(k_add)
}

int zk_sub(int field, const void* a, const void* b, void* out, int64_t n,
           void* stream) {
  DISPATCH2(k_sub)
}

#define DISPATCH_BFLY(KERNEL)                                                \
  if (n <= 0) return (int)cudaSuccess;                                       \
  cudaStream_t s = (cudaStream_t)stream;                                     \
  if (field == 0)                                                            \
    KERNEL<0><<<blocks_for(n), 256, 0, s>>>(                                 \
        (const uint32_t*)u, (const uint32_t*)v, (const uint32_t*)tw,         \
        (uint32_t*)hi, (uint32_t*)lo, n);                                    \
  else if (field == 1)                                                       \
    KERNEL<1><<<blocks_for(n), 256, 0, s>>>(                                 \
        (const uint32_t*)u, (const uint32_t*)v, (const uint32_t*)tw,         \
        (uint32_t*)hi, (uint32_t*)lo, n);                                    \
  else                                                                       \
    return (int)cudaErrorInvalidValue;                                       \
  return (int)cudaGetLastError();

int zk_bfly_dif(int field, const void* u, const void* v, const void* tw,
                void* hi, void* lo, int64_t n, void* stream) {
  DISPATCH_BFLY(k_bfly_dif)
}

int zk_bfly(int field, const void* u, const void* v, const void* tw,
            void* hi, void* lo, int64_t n, void* stream) {
  DISPATCH_BFLY(k_bfly)
}

}  // extern "C"
