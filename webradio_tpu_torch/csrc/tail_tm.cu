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
// Grid: (channel group x time tile) with halo recompute. A block owns NC =
// 64 consecutive channel columns and one tile of rows [r0, r1). A tile with
// r0 > 0 starts HALO rows early and re-mixes rows [r0-HALO, r0) from the
// product: the LO is closed-form in (phase0 + n*step) mod 2^31, so nothing
// sequential is needed. With the audio FIR HALO = 2K: those rows rebuild the
// K-1 mixed rows the shaping FIR reads, the FM lag and the K-1 demod rows
// the audio FIR reads. Without it HALO = K: K-1 mixed rows plus one shaped
// row for the FM lag. Tile 0 takes chan_hist_i/q, demod_prev and audio_hist
// from the carried state instead. The block that owns the last tile writes
// the carries, with the JAX package's definitions: the last K-1 MIXED rows,
// the last shaped row, the last K-1 demod rows. The power is written as
// per-tile partial sums (each the fixed-order sum of the block's two row
// halves) and reduced in tile order by a second kernel (no float atomics),
// so the squelch gate is the same on every run.
//
// The shaping FIR runs on the tensor cores, as mma.sync.m16n8k8 TF32 with
// float32 accumulators, and the SIMT pipe keeps the LO, the mix, the demod
// law, the audio FIR and (PFB) the filterbank product. Float32 accuracy is
// held by a three-term split: every operand x is hi = tf32(x) (round to
// nearest) and lo = x - hi cut to TF32, and the product is a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi; what is dropped is at most 2^-22 of |a||b| per
// term, which is float32 accuracy for a FIR whose output is of its terms'
// size. The tensor cores round their accumulator toward zero, which would
// bias a long chain, so a_hi*b_hi (10 accumulations) is kept apart from the
// two small terms.
//
// The filterbank product stays on float32 FMAs, one chain per output in tap
// order, because the raw-FM rule of the comparisons (PERF.md, section 2)
// admits nothing else. A slot beside a strong carrier holds what the
// stopband leaves of it, 1e-3 of the terms, so any two float32-accurate
// sums of those terms differ by about 1e-6 of the slot's signal, and where
// that signal passes near zero the FM angle moves by more than the bound:
// on about 1e-4 of such a slot's samples, whichever way the other sum is
// made. Measured on the tensor cores against the float32 matmul: a
// three-term split (0.57 ms) crossed the branch cut on 1.09e-4 of the FM
// samples of the fused-filterbank path; a six-term split, closer to the
// exact product than the matmul is, still left 3 of 16,191 carried demod
// samples above 1e-5 where one is allowed. The FMA chain in tap order is
// what the plain version's matmul computes, so it agrees with it as the
// packed path does.
//
// The shaping FIR: a block's 128 threads (4 warps) work through the tile in
// chunks of S = 16 rows. The mixed rows live in two rings (I, Q) of K+S = 80
// rows x 64 channels in shared memory, five slots of 16 rows: a chunk's new
// rows overwrite the oldest slot, nothing slides. The chunk's shaped rows are
// Y[16, 64] = T[16, 80] . M[80, 64] per plane, T the banded Toeplitz form of
// the one shared kernel (row r holds the reversed kernel from column r+1;
// column 0 is padding), so the band wastes 16 of 80 columns, not half the
// depth as a 64-row tile would. T is the same for every channel and chunk:
// its 22 distinct fragment values per thread are split once into registers.
// M's fragments are read from the ring (an XOR swizzle of the channel index
// by the row keeps both the fragment loads and the mix's row stores free of
// bank conflicts without padding) and split as they are loaded. Warp w
// makes plane w/2, channels (w%2)*32.. of it. The shaped rows go back to
// shared memory, because the fragment layout is not one thread per channel,
// and the rest of the body is: thread (h, ch) mixes, demodulates and sums
// the power of rows h*8..h*8+7 of each chunk of channel ch, reading the FM
// lag from the row before (the previous chunk's last row in a register).
// The demod rows go to a third ring; thread h takes every second output of
// the decimating audio FIR, a plain FMA chain over the ring column.
//
// PFB: the product for 64 rows at a time, P[64, 128] = F[64, 2K_p] .
// W[2K_p, 128] (the block's 64 I columns and 64 Q columns of the packed
// weights, used as stored). Frames and weights are staged in slices of 16
// taps through two shared-memory stages by cp.async (16 bytes a thread, the
// next slice in flight while this one is multiplied). A thread keeps an
// 8 x 8 patch of accumulators, 8 rows by the I and Q columns of 4 channels:
// per tap it needs 8 frame samples and 8 weights from shared memory for 64
// FMAs, a quarter of a word per FMA, which is what the shared-memory pipe
// delivers beside the FMA pipe's full rate (a broadcast load costs its
// lanes' words all the same, so a taller, narrower patch is bound by that
// pipe). Loads are 16 bytes wide: four taps of a row's frames, four columns
// of a tap's weights. P goes to shared memory (over the stages) and the mix
// reads it per channel. Weights are re-read from L2 once per 64 rows. The
// grid walks the time tiles fastest, so the blocks resident together share
// a few channel groups' weight columns in L2.
//
// What bounds them on the H100 (times and shares in PERF.md): the float32
// operations bound of PERF.md counts the FIRs and the product at the SIMT
// peak; with the shaping FIR on the tensor cores the body is bound by the
// warp slots of what is left (the LO's sincospif, the demod law, the
// fragment loads and splits, the audio FIR, three barriers a chunk), and
// PFB by the FMA and shared-memory pipes of its product on top of that
// (two blocks an SM, 8 warps, leave their latencies uncovered). AUDIO
// takes 68 KB of shared memory a block and CHANRATE 48 KB (3 blocks an SM
// either way: ~150 registers a thread allow no more), PFB 102 KB (2).
//
// Precision: every FIR tier ("highest", "hx5", "hx4", "high") is computed
// as the three-term split-TF32 product, which holds the float32 bounds.
// hx5, hx4 and high are TPU MXU pass counts and have no Hopper meaning.

#include "tail_common.cuh"

namespace {

constexpr int K = 64;       // taps of the shaping and the audio FIR
constexpr int NC = 64;      // channels per block
constexpr int NTHR = 128;   // threads per block: two per channel, four warps
constexpr int S = 16;       // rows per chunk: one mma m-tile
constexpr int HR = S / 2;   // rows per thread per chunk
constexpr int WIN = K + S;  // ring rows: the chunk and the K rows before it
constexpr int NSLOT = WIN / S;
constexpr int KSTEPS = WIN / 8;    // mma k-steps over the ring
constexpr int NBAND = 2 * KSTEPS + 2;  // distinct band fragment values
constexpr int BAND_PAD = 16;       // leading zeros of the band table
constexpr int BAND_TAB = 96;       // table length: reads reach index 94
// the in-kernel filterbank product
constexpr int PM = 64;             // rows per product group (4 chunks)
constexpr int KS = 16;             // taps per staged slice
constexpr int LDA = KS + 4;        // frame-slice row stride (16-byte rows)
constexpr int LDB = 2 * NC + 8;    // weight-slice row stride
constexpr int LDP = 2 * NC + 8;    // product row stride
constexpr int STAGE_FLOATS = PM * LDA + KS * LDB;
constexpr int PFB_FLOATS =
    2 * STAGE_FLOATS > PM * LDP ? 2 * STAGE_FLOATS : PM * LDP;

enum Kind { AUDIO = 0, CHANRATE = 1, PFB = 2 };

constexpr uint32_t TF32_MASK = 0xFFFFE000u;  // sign, exponent, 10 bits

// hi = x rounded to the nearest TF32 value (ties away from zero, what
// cvt.rna.tf32.f32 gives; in integer operations, because the conversion
// runs at a fraction of their rate and the split sits in the inner loops);
// lo = x - hi, exact in float32 and at most 12 significant bits, cut to
// TF32's 11
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

// d += a[16x8, row-major] * b[8x8, col-major], TF32 in, float32 out. With
// g = lane / 4 and t = lane % 4 a thread holds a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); b0 (k=t, n=g), b1 (k=t+4, n=g); d0 (g, 2t),
// d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// float index of (row, col) in a [rows][NC] shared-memory plane whose
// channel index is XOR-swizzled by the row: a B fragment (4 rows x 8
// channels a load), a row store (32 channels of one row) and an
// accumulator store (float2 at even columns of 8 rows) all touch 32
// distinct banks
__device__ __forceinline__ int swz(int row, int col) {
  return row * NC + (col ^ ((row & 3) << 3));
}

// xa/xb are the I and Q product planes addressed as x[n * row_stride + c]
// (AUDIO, CHANRATE), or the frames [nd, row_stride] and the packed weights
// [row_stride, 2C] (PFB, row_stride = 2K_p). out is audio48 [nd/D, C], or
// the channel-rate audio [nd, C] (CHANRATE, which reads no h_audio/ahist0
// and writes no ahist).
template <bool FAST, int KIND>
__global__ void __launch_bounds__(NTHR)
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
  // rows per pass of the outer loop: a product group, or one chunk
  constexpr int GROUP = KIND == PFB ? PM : S;
  extern __shared__ __align__(16) float smem[];
  float* const ring_i = smem;                    // mixed I [WIN][NC] swizzled
  float* const ring_q = ring_i + WIN * NC;       // mixed Q
  float* const ys = ring_q + WIN * NC;           // shaped [2][S][NC] swizzled
  float* const ba = ys + 2 * S * NC;             // demod audio ring [WIN][NC]
  // PFB: two slice stages, then the product [PM][LDP] over them
  float* const stage = ba + (HAS_AUDIO_FIR ? WIN * NC : 0);
  __shared__ uint32_t band_hi[BAND_TAB], band_lo[BAND_TAB];
  __shared__ __align__(16) float ha[K];  // reversed audio kernel
  __shared__ float psum[NC];  // the second row half's power sum

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma fragment row group
  const int t = lane & 3;   // mma fragment thread in group
  const int ch = tid & (NC - 1);
  const int h = tid >> 6;   // row half: warps 0, 1 / warps 2, 3
  // PFB walks the time tiles fastest: the blocks resident together then
  // share a few channel groups' weight columns, which stay in L2
  const int c0 = (KIND == PFB ? blockIdx.y : blockIdx.x) * NC;
  const int c = c0 + ch;
  const int tile = KIND == PFB ? blockIdx.x : blockIdx.y;
  const int r0 = tile * tile_rows;
  const int r1 = min(r0 + tile_rows, nd);

  // ---- tables and rings. The band table holds the reversed shaping kernel
  // between zeros, split: band[i] = h_shape[i - BAND_PAD]
  for (int i = tid; i < BAND_TAB; i += NTHR) {
    const float v =
        (i >= BAND_PAD && i < BAND_PAD + K) ? h_shape[i - BAND_PAD] : 0.0f;
    split_tf32(v, band_hi[i], band_lo[i]);
  }
  if (HAS_AUDIO_FIR) {
    for (int k = tid; k < K; k += NTHR) ha[k] = h_audio[k];
  }
  // zeros everywhere: a halo tile's rows before the halo are never read by
  // an emitted output, but the band's padding column multiplies one of them
  // by zero, so it has to be finite
  for (int i = tid; i < (HAS_AUDIO_FIR ? 3 : 2) * WIN * NC + 2 * S * NC;
       i += NTHR) {
    smem[i] = 0.0f;
  }
  __syncthreads();

  const uint32_t p0 = static_cast<uint32_t>(phase0[c]);
  const uint32_t st = static_cast<uint32_t>(step[c]);
  const int md = mode[c];

  // FAST: the LO of a thread's HR consecutive rows is the exact phasor of
  // the first row times the exact phasors of 0..HR-1 steps (held in
  // registers for the whole tile): one sincospif a chunk instead of HR,
  // and at most three float32 roundings (~2e-7) on each of sin and cos
  float rot_s[HR], rot_c[HR];
  if (FAST) {
#pragma unroll
    for (int r = 0; r < HR; ++r)
      lo_sincos<true>(0u, st, r, &rot_s[r], &rot_c[r]);
  }

  // The first chunk writes slot 0; its window row j (row n0 - K + j of the
  // stream, j < K) is ring row S + j
  float lag_i = 0.0f, lag_q = 0.0f;
  int start;
  if (r0 == 0) {
    // block-carried state: rows -(K-1)..-1 of the mixed and demod streams
    for (int j = h; j < K - 1; j += 2) {
      ring_i[swz(S + 1 + j, ch)] = hist_i0[(size_t)j * C + c];
      ring_q[swz(S + 1 + j, ch)] = hist_q0[(size_t)j * C + c];
      if (HAS_AUDIO_FIR) ba[(S + 1 + j) * NC + ch] = ahist0[(size_t)j * C + c];
    }
    lag_i = prev0[c];
    lag_q = prev0[C + c];
    start = 0;
  } else {
    // halo recompute: mixed rows from r0-HALO make shaped rows valid from
    // r0-HALO+K-1. Without the audio FIR (HALO = K) that is row r0-1, the
    // FM lag of row r0. With it (HALO = 2K) demod rows are valid from
    // r0-K, which covers the audio FIR's K-1 rows before r0
    start = r0 - HALO;
  }

  // ---- the band's fragment values. Band element (r, j) is
  // band[j - r - 1 + BAND_PAD]; over the k-steps a thread's a0..a3 take 22
  // distinct values e[m] = band[4m + t - g + 7]: k-step kk uses
  // a0 = e[2kk+2], a1 = e[2kk], a2 = e[2kk+3], a3 = e[2kk+1]
  uint32_t eh[NBAND], el[NBAND];
  auto load_band = [&]() {
#pragma unroll
    for (int m = 0; m < NBAND; ++m) {
      eh[m] = band_hi[4 * m + t - g + 7];
      el[m] = band_lo[4 * m + t - g + 7];
    }
  };
  if (KIND != PFB) load_band();

  // the shaping FIR's share of this warp: one plane, four 8-channel tiles
  const float* const ring_p = (warp >> 1) ? ring_q : ring_i;
  float* const ys_p = ys + (warp >> 1) * S * NC;
  const int ntb = (warp & 1) * 4;

  // product rows of the current chunk, this thread's HR rows, in registers.
  // AUDIO and CHANRATE load them from the product, the next chunk's before
  // this chunk's arithmetic so their latency hides; PFB reads them from the
  // group's product in shared memory
  float cxi[HR], cxq[HR];
  if (KIND != PFB) {
#pragma unroll
    for (int r = 0; r < HR; ++r) {
      cxi[r] = xa[(size_t)(start + h * HR + r) * row_stride + c];
      cxq[r] = xb[(size_t)(start + h * HR + r) * row_stride + c];
    }
  }

  float pacc = 0.0f;
  int cur = 0;  // ring slot of the current chunk
  for (int g0 = start; g0 < r1; g0 += GROUP) {
    if (KIND == PFB) {
      // ---- filterbank product for rows g0..g0+PM-1 on float32 FMAs, one
      // chain per output in tap order (what a float32 matmul computes).
      // A thread makes an 8 x 8 patch: rows 8rg..8rg+7, I and Q columns of
      // channels 4cg..4cg+3
      const int kp2 = static_cast<int>(row_stride);
      const int n_slices = kp2 / KS;
      const int rg = 2 * warp + (lane >> 4);
      const int cg = lane & 15;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = 0.0f;

      auto load_slice = [&](int s, int sg) {
        float* const as = stage + sg * STAGE_FLOATS;
        float* const bs = as + PM * LDA;
        // frames: PM rows x 4 pieces of 16 bytes
        for (int i = tid; i < PM * (KS / 4); i += NTHR) {
          const int row = i / (KS / 4);
          const int pc = i % (KS / 4);
          cp_async16(as + row * LDA + 4 * pc,
                     xa + (size_t)(g0 + row) * kp2 + s * KS + 4 * pc);
        }
        // weights: KS taps x (the block's I columns, then its Q columns)
        for (int i = tid; i < KS * (2 * NC / 4); i += NTHR) {
          const int tap = i / (2 * NC / 4);
          const int col = 4 * (i % (2 * NC / 4));
          const int src_col = col < NC ? c0 + col : C + c0 + col - NC;
          cp_async16(bs + tap * LDB + col,
                     xb + (size_t)(s * KS + tap) * 2 * C + src_col);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
      };

      load_slice(0, 0);
      for (int s = 0; s < n_slices; ++s) {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        // slice s has landed for every thread, and every thread is done
        // with the stage that slice s+1 goes into
        __syncthreads();
        if (s + 1 < n_slices) load_slice(s + 1, (s + 1) & 1);
        const float* const as =
            stage + (s & 1) * STAGE_FLOATS + rg * 8 * LDA;
        const float* const bs =
            stage + (s & 1) * STAGE_FLOATS + PM * LDA + 4 * cg;
#pragma unroll
        for (int k4 = 0; k4 < KS / 4; ++k4) {
          // four taps: per row the four frame samples in one 16-byte load
          // (two addresses a warp), per tap the eight weights in two
          float4 f[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            f[r] = *reinterpret_cast<const float4*>(as + r * LDA + 4 * k4);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 wi = *reinterpret_cast<const float4*>(
                bs + (4 * k4 + k) * LDB);
            const float4 wq = *reinterpret_cast<const float4*>(
                bs + (4 * k4 + k) * LDB + NC);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float fk = k == 0 ? f[r].x : k == 1 ? f[r].y
                             : k == 2 ? f[r].z : f[r].w;
              acc[r][0] = fmaf(fk, wi.x, acc[r][0]);
              acc[r][1] = fmaf(fk, wi.y, acc[r][1]);
              acc[r][2] = fmaf(fk, wi.z, acc[r][2]);
              acc[r][3] = fmaf(fk, wi.w, acc[r][3]);
              acc[r][4] = fmaf(fk, wq.x, acc[r][4]);
              acc[r][5] = fmaf(fk, wq.y, acc[r][5]);
              acc[r][6] = fmaf(fk, wq.z, acc[r][6]);
              acc[r][7] = fmaf(fk, wq.w, acc[r][7]);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with the stages
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float* const pp = stage + (rg * 8 + r) * LDP + 4 * cg;
        *reinterpret_cast<float4*>(pp) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(pp + NC) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
      __syncthreads();
      load_band();
    }

    for (int n0 = g0; n0 < g0 + GROUP; n0 += S) {
      float nxi[HR], nxq[HR];
      if (KIND == PFB) {
        const float* const pp = stage + (n0 - g0 + h * HR) * LDP + ch;
#pragma unroll
        for (int r = 0; r < HR; ++r) {
          cxi[r] = pp[r * LDP];
          cxq[r] = pp[r * LDP + NC];
        }
      } else {
        const int next = n0 + S < r1 ? n0 + S : n0;  // last chunk: unused
#pragma unroll
        for (int r = 0; r < HR; ++r) {
          nxi[r] = xa[(size_t)(next + h * HR + r) * row_stride + c];
          nxq[r] = xb[(size_t)(next + h * HR + r) * row_stride + c];
        }
      }

      // ---- residual NCO mix: this thread's rows into the ring's current
      // slot
      float s0 = 0.0f, co0 = 1.0f;
      if (FAST) lo_sincos<true>(p0, st, n0 + h * HR, &s0, &co0);
#pragma unroll
      for (int r = 0; r < HR; ++r) {
        float s, co;
        if (FAST) {
          s = s0 * rot_c[r] + co0 * rot_s[r];
          co = co0 * rot_c[r] - s0 * rot_s[r];
        } else {
          lo_sincos<false>(p0, st, n0 + h * HR + r, &s, &co);
        }
        const int at = swz(cur * S + h * HR + r, ch);
        ring_i[at] = cxi[r] * co + cxq[r] * s;
        ring_q[at] = cxq[r] * co - cxi[r] * s;
      }
      __syncthreads();

      // ---- shaping FIR on the tensor cores: window row j is stream row
      // n0 - K + j; rows 16jb..16jb+15 sit in slot cur+1+jb (mod NSLOT),
      // the chunk itself (jb = NSLOT-1) in slot cur
      {
        float am[4][4], ac[4][4];  // a_hi b_hi apart from the small terms
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) am[nt][i] = ac[nt][i] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          int slot = cur + 1 + (kk >> 1);
          if (slot >= NSLOT) slot -= NSLOT;
          const int row = slot * S + (kk & 1) * 8 + t;
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = (ntb + nt) * 8 + g;
            split_tf32(ring_p[swz(row, col)], bh[nt][0], bl[nt][0]);
            split_tf32(ring_p[swz(row + 4, col)], bh[nt][1], bl[nt][1]);
          }
          // term by term over the four n-tiles, so consecutive mma do not
          // wait on one another's accumulator
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(ac[nt], el[2 * kk + 2], el[2 * kk], el[2 * kk + 3],
                     el[2 * kk + 1], bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(am[nt], eh[2 * kk + 2], eh[2 * kk], eh[2 * kk + 3],
                     eh[2 * kk + 1], bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(ac[nt], eh[2 * kk + 2], eh[2 * kk], eh[2 * kk + 3],
                     eh[2 * kk + 1], bl[nt][0], bl[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = (ntb + nt) * 8 + 2 * t;
          *reinterpret_cast<float2*>(ys_p + swz(g, col)) =
              make_float2(am[nt][0] + ac[nt][0], am[nt][1] + ac[nt][1]);
          *reinterpret_cast<float2*>(ys_p + swz(g + 8, col)) =
              make_float2(am[nt][2] + ac[nt][2], am[nt][3] + ac[nt][3]);
        }
      }
      __syncthreads();

      // ---- demod of this thread's rows: the law switch sits outside the
      // row loop, so each law's rows interleave; the FM lag is the previous
      // row's shaped sample
      float yi[HR + 1], yq[HR + 1];  // [0] is the row before
#pragma unroll
      for (int r = 0; r < HR; ++r) {
        yi[r + 1] = ys[swz(h * HR + r, ch)];
        yq[r + 1] = ys[S * NC + swz(h * HR + r, ch)];
      }
      yi[0] = h ? ys[swz(HR - 1, ch)] : lag_i;
      yq[0] = h ? ys[S * NC + swz(HR - 1, ch)] : lag_q;
      lag_i = ys[swz(S - 1, ch)];
      lag_q = ys[S * NC + swz(S - 1, ch)];
      float a[HR];
      switch (md) {
        case 0:  // AM
#pragma unroll
          for (int r = 1; r <= HR; ++r)
            a[r - 1] = sqrtf(yi[r] * yi[r] + yq[r] * yq[r]);
          break;
        case 1:  // FM
#pragma unroll
          for (int r = 1; r <= HR; ++r)
            a[r - 1] = fm_law(yi[r], yq[r], yi[r - 1], yq[r - 1]);
          break;
        case 2:  // USB
#pragma unroll
          for (int r = 1; r <= HR; ++r) a[r - 1] = yi[r] + yq[r];
          break;
        default:  // LSB
#pragma unroll
          for (int r = 1; r <= HR; ++r) a[r - 1] = yi[r] - yq[r];
          break;
      }
      // chunks start at r0 - HALO + a multiple of S and HALO is a multiple
      // of S, so a chunk lies wholly before r0 or wholly from it on
      if (n0 >= r0) {
#pragma unroll
        for (int r = 1; r <= HR; ++r) pacc += yi[r] * yi[r] + yq[r] * yq[r];
      }

      if (HAS_AUDIO_FIR) {
#pragma unroll
        for (int r = 0; r < HR; ++r)
          ba[(cur * S + h * HR + r) * NC + ch] = a[r];
        __syncthreads();
        // ---- decimating audio FIR: outputs m*D in [max(n0, r0), n0 + S),
        // every second one this thread's. Output n0 + o reads window rows
        // o+1..o+K of the demod ring, which wrap once at ring row WIN
        const int first = max(n0, r0);
        const int lim = min(n0 + S, r1);
        for (int nn = ((first + D - 1) / D) * D; nn < lim; nn += D) {
          if (((nn / D) & 1) != h) continue;
          int at = (cur + 1) * S + (nn - n0) + 1;
          if (at >= WIN) at -= WIN;
          // taps four at a time (one 16-byte load); the one group that
          // straddles the wrap picks each row's side
          const float* const col = ba + ch;
          const float4* const ha4 = reinterpret_cast<const float4*>(ha);
          const int kb = min(K, WIN - at) >> 2;  // whole groups before it
          float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
          const float* p = col + at * NC;
#pragma unroll 4
          for (int k4 = 0; k4 < kb; ++k4) {
            const float4 hv = ha4[k4];
            acc0 += hv.x * p[0];
            acc1 += hv.y * p[NC];
            acc2 += hv.z * p[2 * NC];
            acc3 += hv.w * p[3 * NC];
            p += 4 * NC;
          }
          if (kb < K / 4) {
            const float4 hv = ha4[kb];
            const int row = at + 4 * kb;  // WIN-3..WIN
            acc0 += hv.x * col[(row >= WIN ? row - WIN : row) * NC];
            acc1 += hv.y * col[(row + 1 >= WIN ? row + 1 - WIN : row + 1) * NC];
            acc2 += hv.z * col[(row + 2 >= WIN ? row + 2 - WIN : row + 2) * NC];
            acc3 += hv.w * col[(row + 3 - WIN) * NC];
            p = col + (row + 4 - WIN) * NC;
#pragma unroll 4
            for (int k4 = kb + 1; k4 < K / 4; ++k4) {
              const float4 hv2 = ha4[k4];
              acc0 += hv2.x * p[0];
              acc1 += hv2.y * p[NC];
              acc2 += hv2.z * p[2 * NC];
              acc3 += hv2.w * p[3 * NC];
              p += 4 * NC;
            }
          }
          out[(size_t)(nn / D) * C + c] = (acc0 + acc1) + (acc2 + acc3);
        }
      } else if (n0 >= r0) {
        // ---- channel-rate audio: this thread's demod rows, each row's
        // store coalesced across the block's channels
#pragma unroll
        for (int r = 0; r < HR; ++r)
          out[(size_t)(n0 + h * HR + r) * C + c] = a[r];
      }

      if (KIND != PFB) {
#pragma unroll
        for (int r = 0; r < HR; ++r) {
          cxi[r] = nxi[r];
          cxq[r] = nxq[r];
        }
      }
      cur = cur + 1 == NSLOT ? 0 : cur + 1;
    }
  }

  // the tile's power: the two row halves' sums, in that order
  if (h) psum[ch] = pacc;
  __syncthreads();
  if (!h) power_part[(size_t)tile * C + c] = pacc + psum[ch];

  if (r1 == nd) {
    // carries: the last K-1 mixed rows, the last shaped row, the last K-1
    // demod rows. They are window rows 1..K-1 of the chunk that would come
    // next (slot cur): ring rows (cur+1)*S + j, wrapped
    for (int j = h; j < K - 1; j += 2) {
      int at = (cur + 1) * S + 1 + j;
      if (at >= WIN) at -= WIN;
      hist_i[(size_t)j * C + c] = ring_i[swz(at, ch)];
      hist_q[(size_t)j * C + c] = ring_q[swz(at, ch)];
      if (HAS_AUDIO_FIR) ahist[(size_t)j * C + c] = ba[at * NC + ch];
    }
    if (!h) {
      prev[c] = lag_i;
      prev[C + c] = lag_q;
    }
  }
}


template <int KIND>
int launch(const void* xa, const void* xb, long long row_stride,
           const void* phase0, const void* step, const void* h_shape,
           const void* h_audio, const void* mode, const void* hist_i0,
           const void* hist_q0, const void* prev0, const void* ahist0,
           void* out, void* hist_i, void* hist_q, void* prev, void* ahist,
           void* power_part, void* power, int nd, int C, int taps, int D,
           int tile_rows, int fast, int device, void* stream) {
  constexpr int halo = KIND == CHANRATE ? K : 2 * K;
  // rows come in chunks of S, or in product groups of PM whose slices are
  // copied 16 bytes at a time
  constexpr int rows = KIND == PFB ? PM : S;
  if (taps != K || C % NC != 0 || nd % rows != 0 || tile_rows % rows != 0 ||
      tile_rows < halo || D < 1 || nd % D != 0 || row_stride < 1 ||
      (KIND == PFB &&
       (C / NC > 65535 || row_stride % KS != 0 ||
        reinterpret_cast<uintptr_t>(xa) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(xb) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem_floats = (KIND == CHANRATE ? 2 : 3) * WIN * NC + 2 * S * NC;
  if (KIND == PFB) smem_floats += PFB_FLOATS;
  const size_t smem_bytes = smem_floats * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = fast ? tail_tm_kernel<true, KIND>
                           : tail_tm_kernel<false, KIND>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (nd + tile_rows - 1) / tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = KIND == PFB ? dim3(n_tiles, C / NC)
                                : dim3(C / NC, n_tiles);
  kernel<<<grid, NTHR, smem_bytes, s>>>(
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
    int nd, int C, int taps, int D, int tile_rows, int fast, int device,
    void* stream) {
  return launch<AUDIO>(xi, xq, row_stride, phase0, step, h_shape, h_audio,
                       mode, hist_i0, hist_q0, prev0, ahist0, audio48, hist_i,
                       hist_q, prev, ahist, power_part, power, nd, C, taps, D,
                       tile_rows, fast, device, stream);
}

// The tail without the audio FIR: audio [nd, C] at the channel rate; the
// other arguments as above (no h_audio, ahist0, ahist or D).
int webradio_tail_tm_chanrate_launch(
    const void* xi, const void* xq, long long row_stride, const void* phase0,
    const void* step, const void* h_shape, const void* mode,
    const void* hist_i0, const void* hist_q0, const void* prev0, void* audio,
    void* hist_i, void* hist_q, void* prev, void* power_part, void* power,
    int nd, int C, int taps, int tile_rows, int fast, int device,
    void* stream) {
  return launch<CHANRATE>(xi, xq, row_stride, phase0, step, h_shape, nullptr,
                          mode, hist_i0, hist_q0, prev0, nullptr, audio,
                          hist_i, hist_q, prev, nullptr, power_part, power,
                          nd, C, taps, 1, tile_rows, fast, device, stream);
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
    int nd, int C, int taps, int D, int tile_rows, int fast, int device,
    void* stream) {
  return launch<PFB>(frames, weights, kp2, phase0, step, h_shape, h_audio,
                     mode, hist_i0, hist_q0, prev0, ahist0, audio48, hist_i,
                     hist_q, prev, ahist, power_part, power, nd, C, taps, D,
                     tile_rows, fast, device, stream);
}

const char* webradio_tail_tm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
