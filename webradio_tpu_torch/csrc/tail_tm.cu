// Fused time-major receiver tail for Hopper (sm_90a):
//   residual NCO mix -> 64-tap shaping FIR -> AM/FM/USB/LSB demod
//   -> squelch power -> 64-tap decimating audio FIR, plus every carry.
//
// Replaces the TPU kernel webradio_tpu/ops/pallas_tail_tm.py
// fused_tail_audio_tm (body _kernel_audio -> _audio_tail_core). It computes
// what that kernel computes, not how: the Pallas grid walks time tiles in
// order and carries the mixed halo, the FM lag, the audio tail and the power
// sum from tile to tile in VMEM scratch; CUDA blocks run in no order.
//
// Design (b) of the port: a (channel group x time tile) grid with halo
// recompute. Each block owns NT consecutive channel columns (one thread per
// channel, so a warp reads 32 consecutive floats of one product row) and one
// tile of rows [r0, r1). A tile with r0 > 0 starts 2K rows early and
// re-mixes rows [r0-2K, r0) from the product: the LO is closed-form in
// (phase0 + n*step) mod 2^31, so nothing sequential is needed. Those rows
// rebuild the K-1 mixed rows the shaping FIR reads, the FM lag and the
// K-1 demod rows the audio FIR reads. Tile 0 takes chan_hist_i/q,
// demod_prev and audio_hist from the carried state instead. The block that
// owns the last tile writes the carries, with the JAX package's definitions:
// the last K-1 MIXED rows, the last shaped row, the last K-1 demod rows.
// The power is written as per-tile partial sums and reduced in tile order
// by a second kernel (no float atomics), so the squelch gate is the same on
// every run.
//
// Each thread keeps three linear buffers of K-1+S rows (mixed I, mixed Q,
// demod audio) in its own shared-memory column; no thread reads another's
// column, so the main loop needs no barrier. Rows are processed in chunks
// of S=16: load + mix S rows (the next chunk's product rows are loaded
// before this chunk's arithmetic), shaping FIR for S outputs with the
// reversed kernel held in registers (fully unrolled: S*K FMAs per plane
// from S+K-1 buffer reads at compile-time offsets), demod with the law
// switch outside the row loop, the audio-FIR outputs whose sample index
// falls in the chunk, then slide the buffers by S rows.
//
// What bounds it on the H100: at C=1,024 and nd=10,240 a block of signal
// reads the 84 MB packed product once (plus 2K/tile_rows = 20% halo
// re-reads at the default 640-row tile) and writes about 8 MB of 48 kHz
// audio: ~30 us of HBM time at the H100 SXM's published 3.35 TB/s. The
// arithmetic is about 2*K FMAs per row for the shaping FIR plus K/D for
// the audio FIR, one sincospif (or two sinf on the table law) and a demod
// per row per channel, ~300 instructions per row per channel in all. So
// neither HBM nor the transcendentals (one sincospif, ~20 FMAs, per row)
// bound it; instruction issue does: the buffers take 60 KB
// per 64-thread block, an SM holds 3 blocks (6 warps), and latency is hidden
// by the unrolled chunk's independent work rather than by more warps. The
// measured times are in PERF.md. Tensor-core FIRs (the banded Toeplitz
// form as a GEMM) and TMA staging of the band are later work.
//
// Precision: every FIR tier ("highest", "hx5", "hx4", "high") is computed
// as the same fp32 FMA chain here. hx5, hx4 and high are TPU MXU pass
// counts and have no Hopper meaning.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;  // channels (threads) per block
constexpr int S = 16;   // rows per chunk

constexpr uint32_t PHASE_MASK = 0x7FFFFFFFu;       // 31-bit accumulator
constexpr int LOOKUP_SHIFT = 15;                   // 31 - 16 table bits
constexpr uint32_t LOOKUP_MASK = 0xFFFFu;
constexpr uint32_t QUARTER_TURN = 1u << 14;        // (1 << 16) / 4

// float32 constants, bit-equal to the numpy float32 values the plain
// version uses (np.float32(2*pi / 2**16) etc.)
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

// LO sin/cos of sample n. FAST: the exact 31-bit angle 2pi*ph/2^31. The
// quadrant (top 2 bits) is split off in integers and applied by exact
// swaps and negations (selects, no branches); the 29-bit remainder goes to
// sincospif as a fraction of pi, whose conversion to float costs at most
// 5e-8 rad (float32 of the whole phase would cost up to 2e-7 rad). Else
// the reference's 16-bit table law, sin at the quantized angle
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

template <int K, bool FAST>
__global__ void __launch_bounds__(NT)
tail_audio_tm_kernel(const float* __restrict__ xi_p,
                     const float* __restrict__ xq_p, long long row_stride,
                     const long long* __restrict__ phase0,
                     const long long* __restrict__ step,
                     const float* __restrict__ h_shape,
                     const float* __restrict__ h_audio,
                     const int* __restrict__ mode,
                     const float* __restrict__ hist_i0,
                     const float* __restrict__ hist_q0,
                     const float* __restrict__ prev0,
                     const float* __restrict__ ahist0,
                     float* __restrict__ audio48, float* __restrict__ hist_i,
                     float* __restrict__ hist_q, float* __restrict__ prev,
                     float* __restrict__ ahist,
                     float* __restrict__ power_part, int nd, int C, int D,
                     int tile_rows) {
  // per-thread columns of three linear buffers [BUF][NT]: rows 0..K-2
  // hold the K-1 rows before the chunk, rows K-1.. the chunk's S rows
  constexpr int BUF = K - 1 + S;
  extern __shared__ float smem[];
  float* const bi = smem + threadIdx.x;            // mixed I
  float* const bq = smem + BUF * NT + threadIdx.x;  // mixed Q
  float* const ba = smem + 2 * BUF * NT + threadIdx.x;  // demod audio
  __shared__ __align__(16) float ha[K];  // reversed audio kernel

  const int t = threadIdx.x;
  const int c = blockIdx.x * NT + t;
  const int tile = blockIdx.y;
  const int r0 = tile * tile_rows;
  const int r1 = min(r0 + tile_rows, nd);

  for (int k = t; k < K; k += NT) ha[k] = h_audio[k];
  __syncthreads();  // the only barrier: ha is shared, the buffers are not

  float hs[K];  // reversed shaping kernel, in registers (unrolled indices)
#pragma unroll
  for (int k = 0; k < K; ++k) hs[k] = h_shape[k];

  const uint32_t p0 = static_cast<uint32_t>(phase0[c]);
  const uint32_t st = static_cast<uint32_t>(step[c]);
  const int md = mode[c];

  float lag_i = 0.0f, lag_q = 0.0f;
  int start;
  if (r0 == 0) {
    // block-carried state: rows -(K-1)..-1 of the mixed and demod streams
    for (int j = 0; j < K - 1; ++j) {
      bi[j * NT] = hist_i0[(size_t)j * C + c];
      bq[j * NT] = hist_q0[(size_t)j * C + c];
      ba[j * NT] = ahist0[(size_t)j * C + c];
    }
    lag_i = prev0[c];
    lag_q = prev0[C + c];
    start = 0;
  } else {
    // halo recompute: mixed rows from r0-2K make shaped rows valid from
    // r0-K-1, demod rows from r0-K, which covers the audio FIR's K-1 rows
    // before r0; rows before that are never read by an emitted output
    for (int j = 0; j < K - 1; ++j) {
      bi[j * NT] = 0.0f;
      bq[j * NT] = 0.0f;
      ba[j * NT] = 0.0f;
    }
    start = r0 - 2 * K;
  }

  // product rows of the current chunk, in registers; the next chunk's
  // loads are issued before this chunk's arithmetic so their latency hides
  float cxi[S], cxq[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    cxi[r] = xi_p[(size_t)(start + r) * row_stride + c];
    cxq[r] = xq_p[(size_t)(start + r) * row_stride + c];
  }

  float pacc = 0.0f;
  for (int n0 = start; n0 < r1; n0 += S) {
    float nxi[S], nxq[S];
    const int next = n0 + S < r1 ? n0 + S : n0;  // last chunk: reload, unused
#pragma unroll
    for (int r = 0; r < S; ++r) {
      nxi[r] = xi_p[(size_t)(next + r) * row_stride + c];
      nxq[r] = xq_p[(size_t)(next + r) * row_stride + c];
    }

    // ---- residual NCO mix: rows n0..n0+S-1 into buffer rows K-1..
#pragma unroll
    for (int r = 0; r < S; ++r) {
      float s, co;
      lo_sincos<FAST>(p0, st, n0 + r, &s, &co);
      bi[(K - 1 + r) * NT] = cxi[r] * co + cxq[r] * s;
      bq[(K - 1 + r) * NT] = cxq[r] * co - cxi[r] * s;
    }

    // ---- shaping FIR: y[n0 + r] = sum_k hs[k] * m[n0 + r - (K-1) + k],
    // buffer row r + k
    float yi[S], yq[S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      yi[r] = 0.0f;
      yq[r] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BUF; ++j) {
      const float vi = bi[j * NT];
      const float vq = bq[j * NT];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const int k = j - r;
        if (k >= 0 && k < K) {
          yi[r] += hs[k] * vi;
          yq[r] += hs[k] * vq;
        }
      }
    }

    // ---- demod: the law switch sits outside the row loop, so each law's
    // rows interleave; the FM lag is the previous row's shaped sample
    float a[S];
    switch (md) {
      case 0:  // AM
#pragma unroll
        for (int r = 0; r < S; ++r) a[r] = sqrtf(yi[r] * yi[r] + yq[r] * yq[r]);
        break;
      case 1:  // FM
        a[0] = fm_law(yi[0], yq[0], lag_i, lag_q);
#pragma unroll
        for (int r = 1; r < S; ++r) {
          a[r] = fm_law(yi[r], yq[r], yi[r - 1], yq[r - 1]);
        }
        break;
      case 2:  // USB
#pragma unroll
        for (int r = 0; r < S; ++r) a[r] = yi[r] + yq[r];
        break;
      default:  // LSB
#pragma unroll
        for (int r = 0; r < S; ++r) a[r] = yi[r] - yq[r];
        break;
    }
    lag_i = yi[S - 1];
    lag_q = yq[S - 1];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (n0 + r >= r0) pacc += yi[r] * yi[r] + yq[r] * yq[r];
      ba[(K - 1 + r) * NT] = a[r];
    }

    // ---- decimating audio FIR: outputs m*D in [max(n0, r0), n0 + S);
    // output at n0 + o reads demod buffer rows o..o+K-1. Four partial sums
    // shorten the dependency chain; the taps are read four at a time.
    const int first = max(n0, r0);
    const int lim = min(n0 + S, r1);
    const float4* ha4 = reinterpret_cast<const float4*>(ha);
    for (int nn = ((first + D - 1) / D) * D; nn < lim; nn += D) {
      const float* col = ba + (nn - n0) * NT;
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < K / 4; ++k4) {
        const float4 h = ha4[k4];
        acc0 += h.x * col[(4 * k4 + 0) * NT];
        acc1 += h.y * col[(4 * k4 + 1) * NT];
        acc2 += h.z * col[(4 * k4 + 2) * NT];
        acc3 += h.w * col[(4 * k4 + 3) * NT];
      }
      audio48[(size_t)(nn / D) * C + c] = (acc0 + acc1) + (acc2 + acc3);
    }

    // ---- slide the buffers by S rows: rows 0..K-2 := the last K-1 rows
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      bi[j * NT] = bi[(j + S) * NT];
      bq[j * NT] = bq[(j + S) * NT];
      ba[j * NT] = ba[(j + S) * NT];
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
      cxi[r] = nxi[r];
      cxq[r] = nxq[r];
    }
  }

  power_part[(size_t)tile * C + c] = pacc;

  if (r1 == nd) {
    // carries: the last K-1 mixed rows, the last shaped row, the last K-1
    // demod rows (buffer rows 0..K-2 after the final slide)
    for (int j = 0; j < K - 1; ++j) {
      hist_i[(size_t)j * C + c] = bi[j * NT];
      hist_q[(size_t)j * C + c] = bq[j * NT];
      ahist[(size_t)j * C + c] = ba[j * NT];
    }
    prev[c] = lag_i;
    prev[C + c] = lag_q;
  }
}

// power[c] = (sum over tiles, in tile order, of the partial sums) / nd
__global__ void power_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ power, int n_tiles,
                                    int C, float inv_nd) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
  for (int tl = 0; tl < n_tiles; ++tl) s += part[(size_t)tl * C + c];
  power[c] = s * inv_nd;
}

constexpr int kTaps = 64;
constexpr size_t kSmemBytes = 3 * (kTaps - 1 + S) * NT * sizeof(float);

}  // namespace

extern "C" {

// Launch the fused tail on `stream`. Shapes: product planes addressed as
// x[n * row_stride + c] for n < nd, c < C (xq points at the Q columns);
// phase0/step [C] int64 holding uint32; h_shape/h_audio [K] reversed
// kernels; mode [C] int32; hist_i0/hist_q0/ahist0 and the outputs
// hist_i/hist_q/ahist [K-1, C]; prev0/prev [2, C]; audio48 [nd/D, C];
// power_part [n_tiles, C] scratch; power [C]. Returns cudaGetLastError().
int webradio_tail_tm_launch(
    const void* xi, const void* xq, long long row_stride, const void* phase0,
    const void* step, const void* h_shape, const void* h_audio,
    const void* mode, const void* hist_i0, const void* hist_q0,
    const void* prev0, const void* ahist0, void* audio48, void* hist_i,
    void* hist_q, void* prev, void* ahist, void* power_part, void* power,
    int nd, int C, int K, int D, int tile_rows, int fast, int device,
    void* stream) {
  if (K != kTaps || C % NT != 0 || nd % S != 0 || tile_rows % S != 0 ||
      tile_rows < 2 * kTaps || D < 1 || nd % D != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = fast ? tail_audio_tm_kernel<kTaps, true>
                           : tail_audio_tm_kernel<kTaps, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (nd + tile_rows - 1) / tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(C / NT, n_tiles);
  kernel<<<grid, NT, kSmemBytes, s>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xq),
      row_stride, static_cast<const long long*>(phase0),
      static_cast<const long long*>(step),
      static_cast<const float*>(h_shape), static_cast<const float*>(h_audio),
      static_cast<const int*>(mode), static_cast<const float*>(hist_i0),
      static_cast<const float*>(hist_q0), static_cast<const float*>(prev0),
      static_cast<const float*>(ahist0), static_cast<float*>(audio48),
      static_cast<float*>(hist_i), static_cast<float*>(hist_q),
      static_cast<float*>(prev), static_cast<float*>(ahist),
      static_cast<float*>(power_part), nd, C, D, tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  power_reduce_kernel<<<(C + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(power_part), static_cast<float*>(power),
      n_tiles, C, 1.0f / static_cast<float>(nd));
  return static_cast<int>(cudaGetLastError());
}

const char* webradio_tail_tm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
