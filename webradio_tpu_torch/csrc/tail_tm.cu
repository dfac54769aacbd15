// Fused time-major receiver tails for Hopper (sm_90a), three kernels from
// one body:
//   AUDIO     residual NCO mix -> 64-tap shaping FIR -> AM/FM/USB/LSB demod
//             -> squelch power -> 64-tap decimating audio FIR, every carry;
//   CHANRATE  the same chain without the audio FIR: the demod row is
//             written out at the channel rate;
//   PFB       AUDIO with the polyphase filterbank product made inside the
//             kernel from the im2col frames, so the packed product never
//             reaches device memory.
//
// They replace the TPU kernels of webradio_tpu/ops/pallas_tail_tm.py:
// fused_tail_audio_tm (body _kernel_audio -> _audio_tail_core),
// fused_tail_tm (body _kernel) and fused_pfb_tail_audio_tm (body
// _kernel_pfb_audio). Each computes what its TPU kernel computes, not how:
// the Pallas grid walks time tiles in order and carries the mixed halo, the
// FM lag, the audio tail and the power sum from tile to tile in VMEM
// scratch; CUDA blocks run in no order.
//
// Design: a (channel group x time tile) grid with halo recompute. Each block
// owns NT consecutive channel columns (one thread per channel, so a warp
// reads 32 consecutive floats of one product row) and one tile of rows
// [r0, r1). A tile with r0 > 0 starts HALO rows early and re-mixes rows
// [r0-HALO, r0) from the product: the LO is closed-form in
// (phase0 + n*step) mod 2^31, so nothing sequential is needed. With the
// audio FIR HALO = 2K: those rows rebuild the K-1 mixed rows the shaping FIR
// reads, the FM lag and the K-1 demod rows the audio FIR reads. Without it
// HALO = K: K-1 mixed rows plus one shaped row for the FM lag. Tile 0 takes
// chan_hist_i/q, demod_prev and audio_hist from the carried state instead.
// The block that owns the last tile writes the carries, with the JAX
// package's definitions: the last K-1 MIXED rows, the last shaped row, the
// last K-1 demod rows. The power is written as per-tile partial sums and
// reduced in tile order by a second kernel (no float atomics), so the
// squelch gate is the same on every run.
//
// Each thread keeps linear buffers of K-1+S rows (mixed I, mixed Q and, with
// the audio FIR, demod audio) in its own shared-memory column; no thread
// reads another's column, so AUDIO and CHANRATE need no barrier in the main
// loop. Rows are processed in chunks of S=16: load + mix S rows (the next
// chunk's product rows are loaded before this chunk's arithmetic), shaping
// FIR for S outputs with the reversed kernel held in registers (fully
// unrolled: S*K FMAs per plane from S+K-1 buffer reads at compile-time
// offsets), demod with the law switch outside the row loop, the audio-FIR
// outputs whose sample index falls in the chunk (or the S demod rows
// themselves, stored coalesced across the block's channels), then slide the
// buffers by S rows.
//
// PFB: the chunk's S frame rows (2K_p floats each, shared by every channel
// of the block) are staged once per chunk in shared memory, transposed so
// that one tap's S values are four float4 reads; each thread then walks the
// 2K_p taps with its channel's two weight columns (read coalesced across the
// block, served by L2: the block's 2K_p x 128 weights do not fit beside the
// FIR buffers) into S I and S Q accumulators. The frames are shared, so this
// variant has two barriers per chunk.
//
// What bounds them on the H100: at C=1,024 and nd=10,240 AUDIO reads the
// 84 MB packed product once (plus HALO/tile_rows = 20% halo re-reads at the
// default 640-row tile) and writes about 8 MB of 48 kHz audio. The
// arithmetic is about 2*K FMAs per row for the shaping FIR plus K/D for the
// audio FIR, one sincospif (or two sinf on the table law) and a demod per
// row per channel, ~300 issue slots per row per channel in all, so the
// issue rate binds, not HBM: the buffers take 60 KB per 64-thread
// block, an SM holds 3 blocks (6 warps), and latency is hidden by the
// unrolled chunk's independent work rather than by more warps. CHANRATE
// writes five times the audio bytes and does a tenth less arithmetic; bytes
// and operations are close. PFB adds 2 * 2K_p FMAs per row per channel, more
// than the rest of the chain together, and is bound by operations. The
// bounds and the measured times are in PERF.md. Tensor-core FIRs (the
// banded Toeplitz form as a GEMM), a wgmma filterbank product and TMA
// staging are later work.
//
// Precision: every FIR tier ("highest", "hx5", "hx4", "high") is computed
// as the same fp32 FMA chain here. hx5, hx4 and high are TPU MXU pass
// counts and have no Hopper meaning.

#include "tail_common.cuh"

namespace {

constexpr int NT = 64;  // channels (threads) per block
constexpr int S = 16;   // rows per chunk
// row stride of the transposed frame stage [2K_p][FS]: S values plus
// padding that keeps float4 alignment and spreads the staging stores over
// the banks
constexpr int FS = S + 4;

enum Kind { AUDIO = 0, CHANRATE = 1, PFB = 2 };

// xa/xb are the I and Q product planes addressed as x[n * row_stride + c]
// (AUDIO, CHANRATE), or the frames [nd, row_stride] and the packed weights
// [row_stride, 2C] (PFB, row_stride = 2K_p). out is audio48 [nd/D, C], or
// the channel-rate audio [nd, C] (CHANRATE, which reads no h_audio/ahist0
// and writes no ahist).
template <int K, bool FAST, int KIND>
__global__ void __launch_bounds__(NT)
tail_tm_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
               long long row_stride,
               const long long* __restrict__ phase0,
               const long long* __restrict__ step,
               const float* __restrict__ h_shape,
               const float* __restrict__ h_audio,
               const int* __restrict__ mode,
               const float* __restrict__ hist_i0,
               const float* __restrict__ hist_q0,
               const float* __restrict__ prev0,
               const float* __restrict__ ahist0,
               float* __restrict__ out, float* __restrict__ hist_i,
               float* __restrict__ hist_q, float* __restrict__ prev,
               float* __restrict__ ahist,
               float* __restrict__ power_part, int nd, int C, int D,
               int tile_rows) {
  constexpr bool HAS_AUDIO_FIR = KIND != CHANRATE;
  constexpr int HALO = HAS_AUDIO_FIR ? 2 * K : K;
  // per-thread columns of linear buffers [BUF][NT]: rows 0..K-2 hold the
  // K-1 rows before the chunk, rows K-1.. the chunk's S rows
  constexpr int BUF = K - 1 + S;
  extern __shared__ __align__(16) float smem[];
  float* const bi = smem + threadIdx.x;            // mixed I
  float* const bq = smem + BUF * NT + threadIdx.x;  // mixed Q
  float* const ba = smem + 2 * BUF * NT + threadIdx.x;  // demod audio
  // PFB: the chunk's frame rows, transposed [2K_p][FS]
  float* const fs = smem + 3 * BUF * NT;
  __shared__ __align__(16) float ha[K];  // reversed audio kernel

  // PFB walks the time tiles fastest: the blocks resident together then
  // share a few channel groups' weight columns, which stay in L2
  const int t = threadIdx.x;
  const int c = (KIND == PFB ? blockIdx.y : blockIdx.x) * NT + t;
  const int tile = KIND == PFB ? blockIdx.x : blockIdx.y;
  const int r0 = tile * tile_rows;
  const int r1 = min(r0 + tile_rows, nd);

  if (HAS_AUDIO_FIR) {
    for (int k = t; k < K; k += NT) ha[k] = h_audio[k];
    __syncthreads();
  }

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
      if (HAS_AUDIO_FIR) ba[j * NT] = ahist0[(size_t)j * C + c];
    }
    lag_i = prev0[c];
    lag_q = prev0[C + c];
    start = 0;
  } else {
    // halo recompute: mixed rows from r0-HALO make shaped rows valid from
    // r0-HALO+K-1. Without the audio FIR (HALO = K) that is row r0-1, the
    // FM lag of row r0. With it (HALO = 2K) demod rows are valid from
    // r0-K, which covers the audio FIR's K-1 rows before r0. Rows before
    // that are never read by an emitted output
    for (int j = 0; j < K - 1; ++j) {
      bi[j * NT] = 0.0f;
      bq[j * NT] = 0.0f;
      if (HAS_AUDIO_FIR) ba[j * NT] = 0.0f;
    }
    start = r0 - HALO;
  }

  // product rows of the current chunk, in registers. AUDIO and CHANRATE
  // load them from the product, the next chunk's before this chunk's
  // arithmetic so their latency hides; PFB computes them per chunk
  float cxi[S], cxq[S];
  if (KIND != PFB) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      cxi[r] = xa[(size_t)(start + r) * row_stride + c];
      cxq[r] = xb[(size_t)(start + r) * row_stride + c];
    }
  }

  float pacc = 0.0f;
  for (int n0 = start; n0 < r1; n0 += S) {
    float nxi[S], nxq[S];
    if (KIND == PFB) {
      // ---- filterbank product for rows n0..n0+S-1: every thread of the
      // block runs the same chunks, so the barriers are uniform
      const int kp2 = static_cast<int>(row_stride);
      __syncthreads();  // the previous chunk's frames are consumed
      for (int i = t; i < S * kp2; i += NT) {
        const int r = i / kp2;
        const int j = i - r * kp2;
        fs[j * FS + r] = xa[(size_t)(n0 + r) * kp2 + j];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < S; ++r) {
        cxi[r] = 0.0f;
        cxq[r] = 0.0f;
      }
      const float* wi_p = xb + c;
      const float* wq_p = xb + C + c;
#pragma unroll 8
      for (int j = 0; j < kp2; ++j) {
        const float wi = wi_p[(size_t)j * 2 * C];
        const float wq = wq_p[(size_t)j * 2 * C];
        const float4* f4 = reinterpret_cast<const float4*>(fs + j * FS);
#pragma unroll
        for (int q = 0; q < S / 4; ++q) {
          const float4 f = f4[q];
          cxi[4 * q + 0] += f.x * wi;
          cxq[4 * q + 0] += f.x * wq;
          cxi[4 * q + 1] += f.y * wi;
          cxq[4 * q + 1] += f.y * wq;
          cxi[4 * q + 2] += f.z * wi;
          cxq[4 * q + 2] += f.z * wq;
          cxi[4 * q + 3] += f.w * wi;
          cxq[4 * q + 3] += f.w * wq;
        }
      }
    } else {
      const int next = n0 + S < r1 ? n0 + S : n0;  // last chunk: unused
#pragma unroll
      for (int r = 0; r < S; ++r) {
        nxi[r] = xa[(size_t)(next + r) * row_stride + c];
        nxq[r] = xb[(size_t)(next + r) * row_stride + c];
      }
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
    // chunks start at r0 - HALO + a multiple of S and HALO is a multiple
    // of S, so a chunk lies wholly before r0 or wholly from it on
    if (n0 >= r0) {
#pragma unroll
      for (int r = 0; r < S; ++r) pacc += yi[r] * yi[r] + yq[r] * yq[r];
    }

    if (HAS_AUDIO_FIR) {
#pragma unroll
      for (int r = 0; r < S; ++r) ba[(K - 1 + r) * NT] = a[r];
      // ---- decimating audio FIR: outputs m*D in [max(n0, r0), n0 + S);
      // output at n0 + o reads demod buffer rows o..o+K-1. Four partial
      // sums shorten the dependency chain; the taps are read four at a time
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
        out[(size_t)(nn / D) * C + c] = (acc0 + acc1) + (acc2 + acc3);
      }
    } else if (n0 >= r0) {
      // ---- channel-rate audio: the chunk's demod rows, each row's store
      // coalesced across the block's channels
#pragma unroll
      for (int r = 0; r < S; ++r) out[(size_t)(n0 + r) * C + c] = a[r];
    }

    // ---- slide the buffers by S rows: rows 0..K-2 := the last K-1 rows
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      bi[j * NT] = bi[(j + S) * NT];
      bq[j * NT] = bq[(j + S) * NT];
      if (HAS_AUDIO_FIR) ba[j * NT] = ba[(j + S) * NT];
    }
    if (KIND != PFB) {
#pragma unroll
      for (int r = 0; r < S; ++r) {
        cxi[r] = nxi[r];
        cxq[r] = nxq[r];
      }
    }
  }

  power_part[(size_t)tile * C + c] = pacc;

  if (r1 == nd) {
    // carries: the last K-1 mixed rows, the last shaped row, the last K-1
    // demod rows (buffer rows 0..K-2 after the final slide)
    for (int j = 0; j < K - 1; ++j) {
      hist_i[(size_t)j * C + c] = bi[j * NT];
      hist_q[(size_t)j * C + c] = bq[j * NT];
      if (HAS_AUDIO_FIR) ahist[(size_t)j * C + c] = ba[j * NT];
    }
    prev[c] = lag_i;
    prev[C + c] = lag_q;
  }
}

constexpr int kTaps = 64;
constexpr int kBuf = kTaps - 1 + S;

template <int KIND>
int launch(const void* xa, const void* xb, long long row_stride,
           const void* phase0, const void* step, const void* h_shape,
           const void* h_audio, const void* mode, const void* hist_i0,
           const void* hist_q0, const void* prev0, const void* ahist0,
           void* out, void* hist_i, void* hist_q, void* prev, void* ahist,
           void* power_part, void* power, int nd, int C, int K, int D,
           int tile_rows, int fast, int device, void* stream) {
  constexpr int halo = KIND == CHANRATE ? kTaps : 2 * kTaps;
  if (K != kTaps || C % NT != 0 || nd % S != 0 || tile_rows % S != 0 ||
      tile_rows < halo || D < 1 || nd % D != 0 || row_stride < 1 ||
      (KIND == PFB && C / NT > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem_floats = (KIND == CHANRATE ? 2 : 3) * kBuf * NT;
  if (KIND == PFB) smem_floats += static_cast<size_t>(row_stride) * FS;
  const size_t smem_bytes = smem_floats * sizeof(float);
  if (smem_bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = fast ? tail_tm_kernel<kTaps, true, KIND>
                           : tail_tm_kernel<kTaps, false, KIND>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (nd + tile_rows - 1) / tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = KIND == PFB ? dim3(n_tiles, C / NT)
                                : dim3(C / NT, n_tiles);
  kernel<<<grid, NT, smem_bytes, s>>>(
      static_cast<const float*>(xa), static_cast<const float*>(xb),
      row_stride, static_cast<const long long*>(phase0),
      static_cast<const long long*>(step),
      static_cast<const float*>(h_shape), static_cast<const float*>(h_audio),
      static_cast<const int*>(mode), static_cast<const float*>(hist_i0),
      static_cast<const float*>(hist_q0), static_cast<const float*>(prev0),
      static_cast<const float*>(ahist0), static_cast<float*>(out),
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

}  // namespace

extern "C" {

// Launch the audio-fused tail on `stream`. Shapes: product planes addressed
// as x[n * row_stride + c] for n < nd, c < C (xq points at the Q columns);
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
  return launch<AUDIO>(xi, xq, row_stride, phase0, step, h_shape, h_audio,
                       mode, hist_i0, hist_q0, prev0, ahist0, audio48, hist_i,
                       hist_q, prev, ahist, power_part, power, nd, C, K, D,
                       tile_rows, fast, device, stream);
}

// The tail without the audio FIR: audio [nd, C] at the channel rate; the
// other arguments as above (no h_audio, ahist0, ahist or D).
int webradio_tail_tm_chanrate_launch(
    const void* xi, const void* xq, long long row_stride, const void* phase0,
    const void* step, const void* h_shape, const void* mode,
    const void* hist_i0, const void* hist_q0, const void* prev0, void* audio,
    void* hist_i, void* hist_q, void* prev, void* power_part, void* power,
    int nd, int C, int K, int tile_rows, int fast, int device, void* stream) {
  return launch<CHANRATE>(xi, xq, row_stride, phase0, step, h_shape, nullptr,
                          mode, hist_i0, hist_q0, prev0, nullptr, audio,
                          hist_i, hist_q, prev, nullptr, power_part, power,
                          nd, C, K, 1, tile_rows, fast, device, stream);
}

// The audio-fused tail with the filterbank product made in the kernel:
// frames [nd, kp2] and the packed weights [kp2, 2C] (columns [:C] make
// mixed I, [C:] mixed Q) take the product planes' place.
int webradio_pfb_tail_tm_launch(
    const void* frames, const void* weights, int kp2, const void* phase0,
    const void* step, const void* h_shape, const void* h_audio,
    const void* mode, const void* hist_i0, const void* hist_q0,
    const void* prev0, const void* ahist0, void* audio48, void* hist_i,
    void* hist_q, void* prev, void* ahist, void* power_part, void* power,
    int nd, int C, int K, int D, int tile_rows, int fast, int device,
    void* stream) {
  return launch<PFB>(frames, weights, kp2, phase0, step, h_shape, h_audio,
                     mode, hist_i0, hist_q0, prev0, ahist0, audio48, hist_i,
                     hist_q, prev, ahist, power_part, power, nd, C, K, D,
                     tile_rows, fast, device, stream);
}

const char* webradio_tail_tm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
