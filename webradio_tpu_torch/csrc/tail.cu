// Fused time-minor receiver tail for Hopper (sm_90a):
//   residual NCO mix (16-bit table law) -> 64-tap shaping FIR with
//   per-channel coefficients -> AM/FM/USB/LSB demod -> block-mean power.
//
// Replaces the TPU kernel webradio_tpu/ops/pallas_tail.py
// fused_receiver_tail (body _tail_kernel), the legacy layout of the
// channelized step's per-channel fallback: planes [2, C, nd] with time as
// the minor axis, and the RAW (pre-mix) input tail as the carried FIR state.
// The Pallas kernel walks 8-channel tiles and loops over 1,024-lane chunks
// in order; here every (time chunk, channel) pair is an independent block.
//
// Design: a block of NTHREADS threads owns one channel and one chunk of
// TCH samples, threads along time so that every global read and the audio
// store are coalesced. The chunk and a K-sample left halo of the raw input
// (from raw_hist for the first chunk, from the block's own input after it)
// are mixed into shared memory; the phase of sample n is
// (phase0 + uint32(n) * step) mod 2^31 with n negative for history samples,
// the uint32 wrap doing the rest. Each thread then runs the 64-tap MAC for
// the outputs t, t + NTHREADS, ... of the chunk plus the one before it (the
// FM lag of the chunk's first sample), with the channel's reversed
// coefficients in registers and the mixed samples read conflict-free from
// shared memory. The shaped samples go back to shared memory, the demod
// reads each with its left neighbour, and the chunk's |y|^2 is reduced in a
// fixed order (warp shuffles, then the warps' sums in order) to one partial
// sum per (chunk, channel); a second kernel adds the chunks in order, so
// the squelch gate repeats from run to run. The block of the last chunk
// writes the FM carry; the new raw history is a slice of the input, taken
// by the caller.
//
// What bounds it on the H100: at C=1,024 and nd=10,240 it reads 84 MB and
// writes 42 MB (38 us at 3.35 TB/s) and does 2 * 2K FLOPs per sample for the
// FIR plus two sinf and a demod (about 2.9 GFLOP, 43 us at 67 TFLOP/s): the
// operations bind, narrowly. This design issues one shared-memory read per
// FMA, so shared-memory bandwidth, not the FMA pipe, sets its time; a
// register sliding window over consecutive outputs is the later lever.

#include "tail_common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int TCH = 1024;  // samples per block
constexpr int NWARPS = NTHREADS / 32;

template <int K>
__global__ void __launch_bounds__(NTHREADS)
receiver_tail_kernel(const float* __restrict__ chan_in,
                     const long long* __restrict__ phase0,
                     const long long* __restrict__ step,
                     const float* __restrict__ coeff,
                     const int* __restrict__ mode,
                     const float* __restrict__ raw_hist,
                     const float* __restrict__ prev0,
                     float* __restrict__ audio, float* __restrict__ prev,
                     float* __restrict__ power_part, int nd, int C) {
  // mixed samples: index l holds sample n = base + l - K
  __shared__ float mi[TCH + K];
  __shared__ float mq[TCH + K];
  // shaped samples: index o holds output m = base - 1 + o
  __shared__ float ysi[TCH + 1];
  __shared__ float ysq[TCH + 1];
  __shared__ float wsum[NWARPS];

  const int t = threadIdx.x;
  const int c = blockIdx.x;
  const int chunk = blockIdx.y;
  const int base = chunk * TCH;
  const float* xi = chan_in + (size_t)c * nd;
  const float* xq = chan_in + ((size_t)C + c) * nd;
  const float* hi = raw_hist + (size_t)c * (K - 1);
  const float* hq = raw_hist + ((size_t)C + c) * (K - 1);
  const uint32_t p0 = static_cast<uint32_t>(phase0[c]);
  const uint32_t st = static_cast<uint32_t>(step[c]);
  const int md = mode[c];

  // ---- mix the chunk and its halo (the table law; this kernel has no
  // other): sample -K is the zero lane of the first chunk, never read by an
  // emitted output
  for (int l = t; l < TCH + K; l += NTHREADS) {
    const int n = base + l - K;
    float vi = 0.0f, vq = 0.0f;
    if (n >= 0) {
      vi = xi[n];
      vq = xq[n];
    } else if (n > -K) {
      vi = hi[K - 1 + n];
      vq = hq[K - 1 + n];
    }
    float s, co;
    lo_sincos<false>(p0, st, n, &s, &co);
    mi[l] = vi * co + vq * s;
    mq[l] = vq * co - vi * s;
  }

  float w[K];  // reversed coefficients: w[tap] = coeff[c, K-1-tap]
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = coeff[(size_t)c * K + (K - 1 - k)];
  __syncthreads();

  // ---- shaping FIR: output o (m = base - 1 + o) reads mixed l = o..o+K-1
  for (int o = t; o <= TCH; o += NTHREADS) {
    float ai = 0.0f, aq = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ai += w[k] * mi[o + k];
      aq += w[k] * mq[o + k];
    }
    ysi[o] = ai;
    ysq[o] = aq;
  }
  __syncthreads();

  // ---- demod and power over outputs m = base + j, j = t, t + NTHREADS, ..
  float* out = audio + (size_t)c * nd + base;
  float pacc = 0.0f;
  for (int j = t; j < TCH; j += NTHREADS) {
    const float yi = ysi[j + 1];
    const float yq = ysq[j + 1];
    float a;
    switch (md) {  // one channel per block: uniform
      case 0:
        a = sqrtf(yi * yi + yq * yq);
        break;
      case 1: {
        const bool carried = base == 0 && j == 0;
        const float li = carried ? prev0[c] : ysi[j];
        const float lq = carried ? prev0[C + c] : ysq[j];
        a = fm_law(yi, yq, li, lq);
        break;
      }
      case 2:
        a = yi + yq;
        break;
      default:
        a = yi - yq;
        break;
    }
    out[j] = a;
    pacc += yi * yi + yq * yq;
  }

  // ---- the chunk's power, reduced in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pacc += __shfl_down_sync(0xFFFFFFFFu, pacc, off);
  }
  if ((t & 31) == 0) wsum[t >> 5] = pacc;
  __syncthreads();
  if (t == 0) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NWARPS; ++i) s += wsum[i];
    power_part[(size_t)chunk * C + c] = s;
    if (base + TCH == nd) {
      prev[c] = ysi[TCH];
      prev[C + c] = ysq[TCH];
    }
  }
}

constexpr int kTaps = 64;

}  // namespace

extern "C" {

// Launch the time-minor tail on `stream`. chan_in [2, C, nd]; phase0/step
// [C] int64 holding uint32; coeff [C, K] design-order coefficients; mode [C]
// int32; raw_hist [2, C, K-1] (pre-mix); prev0/prev [2, C]; audio [C, nd];
// power_part [nd / 1024, C] scratch; power [C]. Returns cudaGetLastError().
int webradio_receiver_tail_launch(
    const void* chan_in, const void* phase0, const void* step,
    const void* coeff, const void* mode, const void* raw_hist,
    const void* prev0, void* audio, void* prev, void* power_part,
    void* power, int nd, int C, int K, int device, void* stream) {
  if (K != kTaps || nd < TCH || nd % TCH != 0 || C < 1 || nd / TCH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = nd / TCH;
  dim3 grid(C, n_chunks);
  receiver_tail_kernel<kTaps><<<grid, NTHREADS, 0, s>>>(
      static_cast<const float*>(chan_in),
      static_cast<const long long*>(phase0),
      static_cast<const long long*>(step), static_cast<const float*>(coeff),
      static_cast<const int*>(mode), static_cast<const float*>(raw_hist),
      static_cast<const float*>(prev0), static_cast<float*>(audio),
      static_cast<float*>(prev), static_cast<float*>(power_part), nd, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  power_reduce_kernel<<<(C + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(power_part), static_cast<float*>(power),
      n_chunks, C, 1.0f / static_cast<float>(nd));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
