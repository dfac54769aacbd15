// Device helpers shared by the receiver-tail kernels (tail_tm.cu, tail.cu):
// the NCO phase constants, the LO laws, the polynomial atan2 of
// ops/trig.py, the FM law and the fixed-order power reduction.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHASE_MASK = 0x7FFFFFFFu;       // 31-bit accumulator
constexpr int LOOKUP_SHIFT = 15;                   // 31 - 16 table bits
constexpr uint32_t LOOKUP_MASK = 0xFFFFu;
constexpr uint32_t QUARTER_TURN = 1u << 14;        // (1 << 16) / 4

// float32 constants, bit-equal to the numpy float32 values the plain
// versions use (np.float32(2*pi / 2**16) etc.)
constexpr float ANGLE_SCALE = 9.58738019107841e-05f;       // 2pi/2^16
constexpr float REM_TO_PI_FRACTION = 9.313225746154785e-10f;  // 2^-30, exact
constexpr float INV_2PI = 0.15915493667125702f;
constexpr float HALF_PI = 1.5707963705062866f;
constexpr float PI_F = 3.1415927410125732f;

// atan(z) coefficients for z, z^3, ..., z^19: ops/trig.py ATAN_COEFFS
// rounded to float32 (the z coefficient rounds to exactly 1)
__device__ __forceinline__ float atan_unit(float z) {
  const float z2 = z * z;
  float acc = -0.0015163531061261892f;
  acc = acc * z2 + 0.009606052190065384f;
  acc = acc * z2 + -0.028580743819475174f;
  acc = acc * z2 + 0.055143292993307114f;
  acc = acc * z2 + -0.08222618699073792f;
  acc = acc * z2 + 0.10882186144590378f;
  acc = acc * z2 + -0.14248403906822205f;
  acc = acc * z2 + 0.19996623694896698f;
  acc = acc * z2 + -0.3333319425582886f;
  acc = acc * z2 + 1.0f;
  return acc * z;
}

// ops/trig.py atan2: atan2(0, 0) = 0, atan2(0, -x) = pi
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  const float z = lo / (hi == 0.0f ? 1.0f : hi);
  float a = atan_unit(z);
  if (ay > ax) a = HALF_PI - a;
  if (x < 0.0f) a = PI_F - a;
  return y < 0.0f ? -a : a;
}

// LO sin/cos of sample n (n may be negative: the uint32 product wraps, which
// is the phase mod 2^31 all the same). FAST: the exact 31-bit angle
// 2pi*ph/2^31. The quadrant (top 2 bits) is split off in integers and
// applied by exact swaps and negations (selects, no branches); the 29-bit
// remainder goes to sincospif as a fraction of pi, whose conversion to float
// costs at most 5e-8 rad (float32 of the whole phase would cost up to 2e-7
// rad). Else the reference's 16-bit table law, sin at the quantized angle
// (downconverter.cxx:35-52).
template <bool FAST>
__device__ __forceinline__ void lo_sincos(uint32_t p0, uint32_t st, int n,
                                          float* s, float* c) {
  const uint32_t ph = (p0 + static_cast<uint32_t>(n) * st) & PHASE_MASK;
  if (FAST) {
    const float x = static_cast<float>(static_cast<int>(ph & 0x1FFFFFFFu)) *
                    REM_TO_PI_FRACTION;  // in [0, 0.5): angle = pi * x
    float sr, cr;
    sincospif(x, &sr, &cr);
    const bool odd = (ph >> 29) & 1u;  // quadrants 1, 3: rotate by pi/2
    const bool neg = (ph >> 30) & 1u;  // quadrants 2, 3: rotate by pi
    const float s1 = odd ? cr : sr;
    const float c1 = odd ? -sr : cr;
    *s = neg ? -s1 : s1;
    *c = neg ? -c1 : c1;
  } else {
    const uint32_t si = ph >> LOOKUP_SHIFT;
    const uint32_t ci = (si + QUARTER_TURN) & LOOKUP_MASK;
    *s = sinf(static_cast<float>(static_cast<int>(si)) * ANGLE_SCALE);
    *c = sinf(static_cast<float>(static_cast<int>(ci)) * ANGLE_SCALE);
  }
}

// FM law, reference arg order atan2(ii, qq) (demodulator.cxx:97)
__device__ __forceinline__ float fm_law(float yi, float yq, float pi,
                                        float pq) {
  const float ii = yi * pi + yq * pq;
  const float qq = yq * pi - yi * pq;
  return atan2_poly(ii, qq) * INV_2PI;
}

// power[c] = (sum over tiles, in tile order, of the partial sums) / nd:
// no float atomics, so the squelch gate is the same on every run
__global__ void power_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ power, int n_tiles,
                                    int C, float inv_nd) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
  for (int tl = 0; tl < n_tiles; ++tl) s += part[(size_t)tl * C + c];
  power[c] = s * inv_nd;
}

}  // namespace
