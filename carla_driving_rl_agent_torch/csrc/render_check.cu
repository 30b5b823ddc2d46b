// Card-side checks of the render kernel's exact helpers (render.cuh),
// built with the kernel's flags (ops/render.py) and run by chip_smoke.py's
// kernel phase and the `cuda`-marked render test: each helper against the
// IEEE operation it replaces, bit for bit, as nvcc compiles both for the
// card.  The host build (render_host.cpp) checks the same helpers on the
// CPU, where rcp_rn is a plain 1.0f / x and cannot show a fault.
//
//   * even_floor(x) against fmodf(floorf(x), 2) == 0 on every finite float;
//   * rcp_rn(x) against 1.0f / x on every float of exponent 1..252 (all of
//     2^-126 <= |x| < 2^126; the kernel's operands lie in 1e-6 <= |x| <= 1);
//   * div_rn(a, b, 1.0f / b) against a / b on random pairs from three
//     distributions: raw bit patterns, the segment projections' operands
//     (|a| up to ~2^25, b = L2 from 1e-9 up) and the two constant divisors
//     (0.6 and 150), kept where div_rn's stated domain holds (a = 0 or
//     |a| >= 2^-100, and b, 1 / b and a / b normal).

#include <cuda_runtime.h>

#include "render.cuh"

namespace {

__device__ unsigned long long mismatches[4];

__device__ __forceinline__ uint32_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return static_cast<uint32_t>(x);
}

__global__ void all_floats(uint64_t base) {
  const uint64_t i = base + blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x;
  if (i >= (1ull << 32)) return;
  const uint32_t bits = static_cast<uint32_t>(i);
  const float x = __uint_as_float(bits);
  const uint32_t e = (bits >> 23) & 0xff;
  if (e != 0xff && cdrl::even_floor(x) != (fmodf(floorf(x), 2.0f) == 0.0f)) {
    atomicAdd(&mismatches[0], 1ull);
  }
  if (e >= 1 && e <= 252 && __float_as_uint(cdrl::rcp_rn(x)) != __float_as_uint(1.0f / x)) {
    atomicAdd(&mismatches[1], 1ull);
  }
}

__global__ void pairs(uint64_t base, int mode) {
  const uint64_t i = base + blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x;
  const uint32_t ua = mix(2 * i + 1), ub = mix(2 * i + 2);
  float a, b;
  if (mode == 0) {
    a = __uint_as_float(ua);
    b = __uint_as_float(ub);
  } else if (mode == 1) {
    a = __uint_as_float((ua & 0x807fffffu) | ((60u + (ua >> 23) % 88u) << 23));
    b = fmaxf(__uint_as_float((ub & 0x007fffffu) | ((97u + (ub >> 23) % 50u) << 23)), 1e-9f);
  } else {
    a = __uint_as_float((ua & 0x807fffffu) | ((90u + (ua >> 23) % 60u) << 23));
    b = (ub & 1u) ? 0.6f : 150.0f;
  }
  if (!isfinite(a) || !isfinite(b)) return;
  const uint32_t ea = (__float_as_uint(a) >> 23) & 0xff, eb = (__float_as_uint(b) >> 23) & 0xff;
  if (eb < 2 || eb > 251) return;                    // b and 1 / b normal
  if (a != 0.0f && ea < 127 - 100) return;           // |a| >= 2^-100
  const float q = a / b;
  const uint32_t eq = (__float_as_uint(q) >> 23) & 0xff;
  if (a != 0.0f && (eq == 0 || eq == 0xff)) return;  // a / b normal
  if (__float_as_uint(cdrl::div_rn(a, b, 1.0f / b)) != __float_as_uint(q)) {
    atomicAdd(&mismatches[mode == 0 ? 2 : 3], 1ull);
  }
}

}  // namespace

// out[0..3]: mismatches of even_floor, rcp_rn, div_rn on raw pairs and
// div_rn on the kernel's operands, over `pair_rounds` x 2^30 pairs of each
// of the three distributions.  Returns the CUDA error after the last
// kernel (0 on success).
extern "C" int cdrl_render_check_helpers(unsigned long long* out, int pair_rounds) {
  unsigned long long zero[4] = {0, 0, 0, 0};
  cudaMemcpyToSymbol(mismatches, zero, sizeof(zero));
  const uint64_t chunk = 1ull << 30;
  for (uint64_t base = 0; base < (1ull << 32); base += chunk) {
    all_floats<<<static_cast<unsigned>(chunk / 256), 256>>>(base);
  }
  for (int r = 0; r < pair_rounds; ++r) {
    for (int mode = 0; mode < 3; ++mode) {
      pairs<<<static_cast<unsigned>(chunk / 256), 256>>>(r * chunk, mode);
    }
  }
  const cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, mismatches, sizeof(zero));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
