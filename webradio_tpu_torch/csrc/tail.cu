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
// Design: a block owns one channel and one chunk of TCH samples (the last
// chunk of a block that is not whole chunks holds the rest, a multiple of
// 16 samples; its window threads past the rest make nothing). All its
// threads mix the chunk and a K-sample left halo of the raw input (from
// raw_hist for the first chunk, from the block's own input after it) into
// shared memory, threads along time so the global reads are coalesced; the
// phase of sample n is (phase0 + uint32(n) * step) mod 2^31 with n negative
// for history samples, the uint32 wrap doing the rest. The shaping FIR is a
// register sliding window: a thread makes R = 8 consecutive outputs. It
// walks the 72 mixed samples under them once, 16 bytes a load, and feeds
// each sample from its register to the (up to) eight accumulators it
// belongs to; the channel's reversed coefficients pass through registers
// the same way (the unrolled window needs each for eight steps in a row, so
// the compiler keeps about nine alive, ~60 registers a thread in all): 36
// shared-memory loads for 1,024 FMAs. Every output is still one FMA
// chain in tap order, so the shaped samples and the audio are what a plain
// tap loop gives, bit for bit. The chunk is stored with bit 2 of the sample
// index XORed by bit 5, which spreads a quarter warp's 16-byte loads (32
// bytes apart from thread to thread) over all 32 banks wherever the window
// stands. The demod runs on the registers; the FM lag of a thread's first
// output is its left neighbour's last, passed through shared memory, and
// the one output before the chunk (the lag of the chunk's first sample) is
// made by the first lane of an extra warp, or taken from the carried state
// in the first chunk. A thread stores its 8 audio samples as two 16-byte
// words. The chunk's |y|^2 is reduced in a fixed order (a thread's outputs
// in order, warp shuffles, then the warps' sums in order) to one partial sum
// per (chunk, channel); a second kernel adds the chunks in order, so the
// squelch gate repeats from run to run. The block of the last chunk writes
// the FM carry; the new raw history is a slice of the input, taken by the
// caller.
//
// What bounds it on the H100: at C=1,024 and nd=10,240 it reads 84 MB and
// writes 42 MB (38 us at 3.35 TB/s) and does 2 * 2K FLOPs per sample for the
// FIR plus two sinf and a demod (about 2.9 GFLOP, 43 us at 67 TFLOP/s): the
// operations bind, narrowly. With one load per 28 FMAs the FIR is FMA
// instructions and little else, and the kernel is bound by warp issue
// slots: a thread issues ~1,400 instructions for its window, ~800 for its
// seven samples of the mix (the table law's two sinf per sample, ~40 each)
// and ~100-400 for the demod, which is ~110 us of issue at C=1,024 against
// 40 us for the FMAs alone. A table of the 2^16 sines made once per card by
// the same sinf (bit-equal) was slower: its gathers miss L1.

#include "tail_common.cuh"

namespace {

constexpr int TCH = 1024;         // samples per block
constexpr int R = 8;              // consecutive outputs per thread
constexpr int NWIN = TCH / R;     // threads that run a window
constexpr int NTHREADS = NWIN + 32;  // and the warp of the output before

// index of mixed sample l in the chunk's shared-memory planes
__device__ __forceinline__ int swz4(int l) { return l ^ (((l >> 5) & 1) << 2); }

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
  static_assert(K % 4 == 0 && R % 4 == 0, "16-byte window loads");
  // mixed samples: index l holds sample n = base + l - K (swizzled)
  __shared__ __align__(16) float mi[TCH + K];
  __shared__ __align__(16) float mq[TCH + K];
  // last_*[t]: the shaped sample before window thread t's first output
  __shared__ float last_i[NWIN + 1];
  __shared__ float last_q[NWIN + 1];
  __shared__ float wsum[NWIN / 32];

  const int t = threadIdx.x;
  const int c = blockIdx.x;
  const int chunk = blockIdx.y;
  const int base = chunk * TCH;
  const int len = min(TCH, nd - base);  // samples of this chunk
  const int nwin = len / R;             // window threads with outputs
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
  for (int l = t; l < len + K; l += NTHREADS) {
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
    mi[swz4(l)] = vi * co + vq * s;
    mq[swz4(l)] = vq * co - vi * s;
  }

  float w[K];  // reversed coefficients: w[tap] = coeff[c, K-1-tap]
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = coeff[(size_t)c * K + (K - 1 - k)];
  __syncthreads();

  // ---- shaping FIR: output o (sample m = base - 1 + o) reads mixed
  // l = o..o+K-1. Window thread t makes o = R*t + 1 + j, j < R
  float ai[R], aq[R];
  if (t < nwin) {
#pragma unroll
    for (int j = 0; j < R; ++j) ai[j] = aq[j] = 0.0f;
    // the window: mixed l = R*t + 4*q + e; it is tap l - o of output o
#pragma unroll
    for (int q = 0; q < (K + R) / 4; ++q) {
      const int at = swz4(R * t + 4 * q);
      const float4 vi = *reinterpret_cast<const float4*>(mi + at);
      const float4 vq = *reinterpret_cast<const float4*>(mq + at);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float si = e == 0 ? vi.x : e == 1 ? vi.y : e == 2 ? vi.z : vi.w;
        const float sq = e == 0 ? vq.x : e == 1 ? vq.y : e == 2 ? vq.z : vq.w;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int k = 4 * q + e - 1 - j;
          if (k >= 0 && k < K) {
            ai[j] = fmaf(w[k], si, ai[j]);
            aq[j] = fmaf(w[k], sq, aq[j]);
          }
        }
      }
    }
    last_i[t + 1] = ai[R - 1];
    last_q[t + 1] = aq[R - 1];
  } else if (t == NWIN) {
    // the output before the chunk: carried into the first chunk, else one
    // tap loop over the halo
    float li = prev0[c], lq = prev0[C + c];
    if (base != 0) {
      li = lq = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        li = fmaf(w[k], mi[swz4(k)], li);
        lq = fmaf(w[k], mq[swz4(k)], lq);
      }
    }
    last_i[0] = li;
    last_q[0] = lq;
  }
  __syncthreads();

  // ---- demod and power of the thread's outputs, in order
  float pacc = 0.0f;
  if (t < nwin) {
    float a[R];
    float li = last_i[t], lq = last_q[t];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float yi = ai[j];
      const float yq = aq[j];
      switch (md) {  // one channel per block: uniform
        case 0:
          a[j] = sqrtf(yi * yi + yq * yq);
          break;
        case 1:
          a[j] = fm_law(yi, yq, li, lq);
          break;
        case 2:
          a[j] = yi + yq;
          break;
        default:
          a[j] = yi - yq;
          break;
      }
      pacc += yi * yi + yq * yq;
      li = yi;
      lq = yq;
    }
    float4* out =
        reinterpret_cast<float4*>(audio + (size_t)c * nd + base + R * t);
#pragma unroll
    for (int j = 0; j < R; j += 4)
      out[j / 4] = make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
    if (t == nwin - 1 && base + len == nd) {
      prev[c] = ai[R - 1];
      prev[C + c] = aq[R - 1];
    }
  }
  if (t < NWIN) {
    // ---- the chunk's power, reduced in a fixed order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pacc += __shfl_down_sync(0xFFFFFFFFu, pacc, off);
    }
    if ((t & 31) == 0) wsum[t >> 5] = pacc;
  }
  __syncthreads();
  if (t == 0) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NWIN / 32; ++i) s += wsum[i];
    power_part[(size_t)chunk * C + c] = s;
  }
}

constexpr int kTaps = 64;

}  // namespace

extern "C" {

// Launch the time-minor tail on `stream`. chan_in [2, C, nd]; phase0/step
// [C] int64 holding uint32; coeff [C, K] design-order coefficients; mode [C]
// int32; raw_hist [2, C, K-1] (pre-mix); prev0/prev [2, C]; audio [C, nd],
// 16-byte aligned; power_part [ceil(nd / 1024), C] scratch; power [C]; nd a
// multiple of 16, at least K. Returns cudaGetLastError().
int webradio_receiver_tail_launch(
    const void* chan_in, const void* phase0, const void* step,
    const void* coeff, const void* mode, const void* raw_hist,
    const void* prev0, void* audio, void* prev, void* power_part,
    void* power, int nd, int C, int K, int device, void* stream) {
  const int n_chunks = (nd + TCH - 1) / TCH;
  if (K != kTaps || nd < K || nd % 16 != 0 || C < 1 || n_chunks > 65535 ||
      reinterpret_cast<uintptr_t>(audio) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
