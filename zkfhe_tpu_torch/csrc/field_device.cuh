// Device arithmetic shared by field_kernels.cu and mxu_kernels.cu: BN254
// elements as 20 limbs of 13 bits in uint32 registers, Montgomery R = 2^260.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define NL 20
#define LB 13
#define LMASK 0x1FFFu

// Field 0 = BN254 Fr, field 1 = BN254 Fq: limbs of p (little-endian) and
// mu = -p^-1 mod 2^13. The Python loader checks them against its Field
// objects (zk_field_params in field_kernels.cu).
static __constant__ uint32_t kP[2][NL] = {
    {1u, 0u, 1276u, 1003u, 5182u, 6216u, 1765u, 2319u, 5096u, 2369u,
     5655u, 770u, 7016u, 2082u, 1761u, 5125u, 305u, 5015u, 6419u, 96u},
    {7495u, 999u, 1462u, 280u, 5058u, 1350u, 455u, 4653u, 362u, 3260u,
     5655u, 770u, 7016u, 2082u, 1761u, 5125u, 305u, 5015u, 6419u, 96u},
};

template <int F>
struct Fld;
template <>
struct Fld<0> {
  static constexpr uint32_t mu = 8191u;
};
template <>
struct Fld<1> {
  static constexpr uint32_t mu = 905u;
};

// Normalise LEN limbs that may exceed 13 bits (final carry dropped).
template <int LEN = NL>
__device__ __forceinline__ void carry_chain(uint32_t* t) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < LEN; ++j) {
    uint32_t v = t[j] + c;
    t[j] = v & LMASK;
    c = v >> LB;
  }
}

// r (normalised, < 2p) -> r mod p by one conditional subtract.
template <int F>
__device__ __forceinline__ void cond_sub_p(uint32_t* r) {
  uint32_t s[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    uint32_t d = r[j] + (1u << LB) - kP[F][j] - borrow;
    s[j] = d & LMASK;
    borrow = 1u - (d >> LB);
  }
  if (!borrow) {
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = s[j];
  }
}

// Montgomery reduction: t (40 accumulators holding a value below p*R) ->
// t * R^-1 mod p, canonical, in out. 20 rounds add m*p (each product below
// 2^26) to 20 consecutive accumulators and pass the round's carry on; the
// caller keeps every t[s] small enough that those additions stay below 2^32.
template <int F>
__device__ __forceinline__ void redc(uint32_t* t, uint32_t* out) {
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    uint32_t m = ((t[k] & LMASK) * Fld<F>::mu) & LMASK;
#pragma unroll
    for (int j = 0; j < NL; ++j) t[k + j] += m * kP[F][j];
    t[k + 1] += t[k] >> LB;
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) out[j] = t[NL + j];
  carry_chain(out);
  cond_sub_p<F>(out);
}

__device__ __forceinline__ void store(uint32_t* __restrict__ x, int64_t n,
                                      int64_t i, const uint32_t* v) {
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j * n + i] = v[j];
}
