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
// 64 consecutive channels and one tile of rows [r0, r1). The last group may
// hold fewer than 64 (AUDIO and CHANRATE take any channel count): a column
// past C is computed on channel C-1's product under the LSB law and never
// stored (columns share nothing, so it touches no live channel), and a
// warp with no channel below C returns once the column orders are made.
// Those loads keep their addresses clamped, not predicated: a select that
// consumes a load at once stalls there, and the product's loads are
// issued a chunk ahead to hide their latency. A tile with r0 > 0
// starts HALO rows early and re-mixes rows [r0-HALO, r0) from the product:
// the LO is closed-form in (phase0 + n*step) mod 2^31, so nothing sequential
// is needed. With the audio FIR HALO = 2K: those rows rebuild the K-1 mixed
// rows the shaping FIR reads, the FM lag and the K-1 demod rows the audio
// FIR reads. Without it HALO = K: K-1 mixed rows plus one shaped row for the
// FM lag. Halo chunks whose shaped rows nobody reads (the first half of the
// halo) are only mixed. Tile 0 takes chan_hist_i/q, demod_prev and
// audio_hist from the carried state instead. The block that owns the last
// tile writes the carries, with the JAX package's definitions: the last K-1
// MIXED rows, the last shaped row, the last K-1 demod rows. The power is
// written as per-tile partial sums and reduced in tile order by a second
// kernel (no float atomics), so the squelch gate is the same on every run.
//
// The body is made of self-contained warps. A warp owns WC = 16 of the
// block's channels and both planes of them, and takes its rows in chunks of
// S = 16 through every stage: mix -> shaping FIR -> demod -> demod ring ->
// audio FIR. It shares nothing with the block's other warps but the
// coefficient tables, so the chunk loop holds no block barrier (only
// __syncwarp between a stage's stores and the next stage's loads), and the
// SM's 12 warps drift into different stages and cover one another's
// latencies: one warp's sincospif and FM polynomial run under another's
// tensor-core chain. (As one block in lock step, three barriers a chunk,
// the same arithmetic ran at a third of the issue rate.)
//
// Mix: lane (hm, cm) = (lane / 16, lane % 16) mixes rows 2r + hm of column
// cm, r < 8: a warp's store is two whole ring rows. With the fast LO the
// phasor of row n0 + hm is exact (sincospif of the integer phase) and the
// rows after it are that phasor rotated by the exact phasors of 2, 4, ..,
// 14 steps, held in registers for the whole tile: one sincospif a chunk
// and lane, at most three float32 roundings (~2e-7) on each of sin and cos.
//
// The shaping FIR runs on the tensor cores, as mma.sync.m16n8k8 TF32 with
// float32 accumulators. Float32 accuracy is held by a three-term split:
// every operand x is hi = tf32(x) (round to nearest) and lo = x - hi cut to
// TF32, and the product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi; what is
// dropped is at most 2^-22 of |a||b| per term, which is float32 accuracy for
// a FIR whose output is of its terms' size. The tensor cores round their
// accumulator toward zero, which would bias a long chain, so a_hi*b_hi is
// kept apart from the two small terms. The warp's mixed rows live in two
// rings (I, Q) of K+S = 80 rows x 16 columns, five slots of 16 rows: a
// chunk's new rows overwrite the oldest slot, nothing slides. The chunk's
// shaped rows are Y[16, 16] = T[16, 80] . M[80, 16] per plane, T the banded
// Toeplitz form of the one shared kernel (row r holds the reversed kernel
// from column r+1; column 0 is padding). T is the same for every channel
// and chunk: it is split once into a table in shared memory, from which a
// k-step reads its four fragment values. The n-tile nt of a plane is the
// columns 2g + nt, so one 8-byte load fetches a lane's B value for both
// n-tiles; a ring row's column index is XORed by 8 on every second row
// pair, which keeps those loads, the mix's row stores and the demod ring's
// 16-byte stores free of bank conflicts without padding.
//
// Demod: straight from the accumulator fragments. A lane holds rows g and
// g+8 of columns 4t..4t+3, I and Q; the FM lag (the row before) comes from
// lane - 4 by shuffle, and across the chunk edge from the lane that holds
// row 15, in a register. One instruction therefore demodulates the columns
// 4t + cc, t < 4, of one cc: the warp orders its 16 channels so that those
// four share a law (a stable sort by law, dealt round the four column
// classes; the identity where the classes are uniform already, as with one
// law on every slot or laws cycling with period 4), and the FM law's
// division and polynomial run only where a class holds FM, with all lanes.
// The lag shuffles run for every class: they cost less than a branch.
// ops/tail_tm.law_sorted_columns is the same rule in Python. The power is
// summed per lane over its rows in order and across the eight lanes of a
// column by three XOR shuffles: a fixed order that depends on neither the
// column a channel sits in nor the laws beside it.
//
// Audio FIR: the demod rows go to a third ring of 128 rows. At D = 5 (the
// stock 240 -> 48 kHz) the decimating FIR runs on the tensor cores too, per
// 40 rows: Out[16 channels, 8 outputs] = A[16, 104] . TA[104, 8], A the
// ring's rows G-64..G+39 as stored and TA[j, o] = h_audio_rev[j - 5o - 1],
// the banded form of the shared audio kernel with stride 5, pre-split in
// shared memory (its fragments would take 54 registers); the same
// three-term split with the three terms in three accumulators. A group runs
// as soon as its last row is in the ring, so it trails the chunks by up to
// 24 rows; a tile's first and last group are whole groups too (rows outside
// the tile meet zeros of the band or feed outputs that are not stored).
// Every other D keeps a SIMT loop, one FMA chain per output over the ring
// column (plain rows there), two lanes a column taking every second output.
// The launch picks by D alone.
//
// PFB: the product for 64 rows at a time, P[64, 128] = F[64, 2K_p] .
// W[2K_p, 128] (the block's 64 I columns and 64 Q columns of the packed
// weights, used as stored), made by the whole block between barriers.
// Frames and weights are staged in slices of 16 taps through two
// shared-memory stages by cp.async (16 bytes a thread, the next slice in
// flight while this one is multiplied). A thread keeps an 8 x 8 patch of
// accumulators, 8 rows by the I and Q columns of 4 channels: per tap it
// needs 8 frame samples and 8 weights from shared memory for 64 FMAs, a
// quarter of a word per FMA, which is what the shared-memory pipe delivers
// beside the FMA pipe's full rate (a broadcast load costs its lanes' words
// all the same, so a taller, narrower patch is bound by that pipe). Loads
// are 16 bytes wide: four taps of a row's frames, four columns of a tap's
// weights. P goes to shared memory (over the stages) and each warp's mix
// reads its columns of it. Weights are re-read from L2 once per 64 rows.
// The grid walks the time tiles fastest, so the blocks resident together
// share a few channel groups' weight columns in L2. The product stays on
// float32 FMAs, one chain per output in tap order, because the raw-FM rule
// of the comparisons (PERF.md, section 2) admits nothing else: a slot
// beside a strong carrier holds what the stopband leaves of it, 1e-3 of the
// terms, so any two float32-accurate sums of those terms differ by about
// 1e-6 of the slot's signal, and where that signal passes near zero the FM
// angle moves by more than the bound. The FMA chain in tap order is what
// the plain version's matmul computes, so it agrees with it as the packed
// path does.
//
// What bounds them on the H100 (times and shares in PERF.md): the float32
// operations bound of PERF.md counts the FIRs and the product at the SIMT
// peak. With both FIRs on the tensor cores the body is bound by the tensor
// pipe as mma.sync drives it: a warp issues 120 m16n8k8 TF32 mma a chunk
// for the shaping FIR and 31 for the audio FIR, and a third more of them
// cost a fifth more time (measured), about 12 cycles each on its SM
// sub-core, a third of the card's TF32 peak. The three terms are the price
// of float32 accuracy and the band wastes 16 of 80 columns; what is left
// is wgmma, whose 64-row tiles waste half a band. Beside the tensor pipe
// sit the warp issue slots of what feeds it (ring loads and integer splits,
// about half of a chunk's ~1,000 instructions a warp), the LO and the FM
// law, at 12 warps an SM: AUDIO takes 72 KB of shared memory a block (3
// blocks an SM fill its 227 KB; ~150 registers a thread), CHANRATE 40 KB,
// PFB 106 KB (2 blocks; its product's FMA and shared-memory pipes come on
// top). At C=1,024 the main path has 256 blocks for 396 places.
//
// Precision: every FIR tier ("highest", "hx5", "hx4", "high") is computed
// as the three-term split-TF32 product, which holds the float32 bounds.
// hx5, hx4 and high are TPU MXU pass counts and have no Hopper meaning.
//
// The filterbank tiers (ops/channelizer.py) give two more variants:
//
// - AUDIO and CHANRATE on a bfloat16 product (the "bf16" tier stores it so,
//   webradio_tpu/ops/pallas_tail_tm.py upcasts at load): a lane loads 8
//   bytes, four channels of one row, twice a plane and chunk, and the mix
//   lane of each (row, channel) takes its value from that lane by shuffle
//   (two a value: the channel's half word is picked after it) and upcasts
//   it, exactly (a bfloat16 is the top half of a float32). Everything after
//   the load is the float32 body. Half the bytes of the product's read.
// - PFB at "default" and "high": the product on the bf16 tensor cores,
//   mma.sync m16n8k16 with float32 accumulators. A warp makes 16 rows x 128
//   columns of the group's P (16 n-tiles, 64 accumulators a thread): per
//   16-tap slice its A fragment is the staged float32 frames rounded to
//   bfloat16 (and, for "high", the remainder rounded again: al =
//   bf16(f - ah)), its B fragments the host-split weights (hi, and lo for
//   "high", [2K_p, 2C] bfloat16 each) staged by cp.async as they are and
//   packed two taps to a register by two 16-bit loads. One pass for
//   "default"; three for "high" (al hi, ah lo, then ah hi, each over the 16
//   n-tiles so consecutive mma do not wait on one another), the law
//   ah hi + ah lo + al hi of ops/channelizer.pfb_product_high summed in
//   one accumulator. "highest" keeps the float32 FMA chains: the raw-FM rule
//   (PERF.md section 2) admits nothing else for it, while the two lossy
//   tiers are held by the tier rule, their SNR against float64.

#include <cuda_bf16.h>

#include "tail_common.cuh"

namespace {

constexpr int K = 64;       // taps of the shaping and the audio FIR
constexpr int NC = 64;      // channels per block
constexpr int NTHR = 128;   // threads per block: four warps
constexpr int NWARP = NTHR / 32;
constexpr int WC = NC / NWARP;  // channels per warp: two mma n-tiles
constexpr int S = 16;       // rows per chunk: one mma m-tile
constexpr int HR = S / 2;   // rows per lane per chunk in the mix
constexpr int WIN = K + S;  // ring rows: the chunk and the K rows before it
constexpr int NSLOT = WIN / S;
constexpr int KSTEPS = WIN / 8;    // mma k-steps over the ring
constexpr int BAND_PAD = 16;       // leading zeros of the band table
constexpr int BAND_TAB = 96;       // table length: reads reach index 94
constexpr int ARING = 128;         // demod ring rows (a power of two)
// the audio FIR on the tensor cores
constexpr int AD = 5;              // the decimation it is built for
constexpr int AOUT = 8;            // outputs per group: one mma n-tile
constexpr int AGROUP = AD * AOUT;  // rows per group
constexpr int AKSTEPS = (K + AGROUP) / 8;  // k-steps over rows G-K..G+39
constexpr int ATAB_PAD = AD * (AOUT - 1) + 1;  // leading zeros of its table
constexpr int ATAB = 144;          // table length: reads reach index 138
// the in-kernel filterbank product
constexpr int PM = 64;             // rows per product group (4 chunks)
constexpr int KS = 16;             // taps per staged slice
constexpr int LDA = KS + 4;        // frame-slice row stride (16-byte rows)
constexpr int LDB = 2 * NC + 8;    // weight-slice row stride
constexpr int LDP = 2 * NC + 8;    // product row stride
constexpr int STAGE_FLOATS = PM * LDA + KS * LDB;
// the tensor-core tiers stage the weights as bfloat16, hi then lo, in the
// float32 weight slice's room
constexpr int LDBH = 2 * NC + 8;   // bf16 weight-slice row stride
static_assert(2 * KS * LDBH <= 2 * KS * LDB, "bf16 slices exceed the stage");
constexpr int NTILES = 2 * NC / 8; // n-tiles of a product group's row
constexpr int PFB_FLOATS =
    2 * STAGE_FLOATS > PM * LDP ? 2 * STAGE_FLOATS : PM * LDP;

enum Kind { AUDIO = 0, CHANRATE = 1, PFB = 2 };
// the IN template argument: the packed product's type for AUDIO and
// CHANRATE (IN_F32, IN_BF16), the in-kernel product's tier for PFB
enum In { IN_F32 = 0, IN_BF16 = 1 };
enum Tier { T_HIGHEST = 0, T_DEFAULT = 1, T_HIGH = 2 };

constexpr uint32_t TF32_MASK = 0xFFFFE000u;  // sign, exponent, 10 bits
constexpr uint32_t FULL = 0xFFFFFFFFu;

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

// d += a[16x16, row-major] * b[16x8, col-major], bfloat16 in, float32 out.
// With g = lane / 4, t = lane % 4 a register holds two values, the lower
// index in the low half: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g); d as
// in mma_tf32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to bfloat16 (to nearest, ties to even, as
// torch's and JAX's casts), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the low and the high bfloat16 of a register, as float32 (exact)
__device__ __forceinline__ float bf16_low(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_high(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// float index of (row, col) in a warp's [rows][WC] shared-memory plane:
// the column index is XORed by 8 on every second row pair. A fragment load
// (4 rows x 8 column pairs, 8 bytes a lane), the mix's store (two rows) and
// the demod ring's store (16 bytes a lane) then touch each bank once
__device__ __forceinline__ int swz(int row, int col) {
  return row * WC + (col ^ (((row >> 1) & 1) << 3));
}

// xa/xb are the I and Q product planes addressed as x[n * row_stride + c]
// (AUDIO, CHANRATE; float32, or bfloat16 under IN_BF16), or the frames
// [nd, row_stride] and the packed weights [row_stride, 2C] (PFB, row_stride
// = 2K_p; float32 at T_HIGHEST, else the bfloat16 hi half, and xc the lo
// half, read at T_HIGH only). out is audio48 [nd/D, C], or the channel-rate
// audio [nd, C] (CHANRATE, which reads no h_audio/ahist0 and writes no
// ahist). TCA: the audio FIR on the tensor cores (D == AD).
template <bool FAST, int KIND, bool TCA, int IN>
__global__ void __launch_bounds__(NTHR, KIND == PFB ? 2 : 3)
tail_tm_kernel(const void* __restrict__ xa, const void* __restrict__ xb,
               const void* __restrict__ xc, long long row_stride,
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
  constexpr int RING_FLOATS = 2 * NWARP * WIN * WC;
  constexpr int ARING_FLOATS = HAS_AUDIO_FIR ? NWARP * ARING * WC : 0;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t band_hi[BAND_TAB], band_lo[BAND_TAB];
  __shared__ uint32_t atab_hi[TCA ? ATAB : 1], atab_lo[TCA ? ATAB : 1];
  __shared__ float ha[TCA ? 1 : K];  // the SIMT audio FIR's reversed kernel
  __shared__ int colch[NC];  // [warp][column] -> the warp's channel there

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma fragment row group
  const int t = lane & 3;    // mma fragment thread in group
  const int hm = lane >> 4;  // mix: row parity
  const int cm = lane & 15;  // mix: column
  // the warp's planes: mixed I and Q [WIN][WC], demod audio [ARING][WC]
  float* const ring_i = smem + warp * (WIN * WC);
  float* const ring_q = ring_i + NWARP * WIN * WC;
  float* const ba = smem + RING_FLOATS + warp * (ARING * WC);
  // PFB: two slice stages, then the product [PM][LDP] over them
  float* const stage = smem + RING_FLOATS + ARING_FLOATS;
  // PFB walks the time tiles fastest: the blocks resident together then
  // share a few channel groups' weight columns, which stay in L2
  const int c0 = (KIND == PFB ? blockIdx.y : blockIdx.x) * NC;
  const int cw = c0 + warp * WC;  // the warp's first channel
  const int tile = KIND == PFB ? blockIdx.x : blockIdx.y;
  const int r0 = tile * tile_rows;
  const int r1 = min(r0 + tile_rows, nd);

  // ---- tables and rings. The band table holds the reversed shaping kernel
  // between zeros, split: band[i] = h_shape[i - BAND_PAD]; the audio table
  // likewise, atab[i] = h_audio[i - ATAB_PAD]
  for (int i = tid; i < BAND_TAB; i += NTHR) {
    const float v =
        (i >= BAND_PAD && i < BAND_PAD + K) ? h_shape[i - BAND_PAD] : 0.0f;
    split_tf32(v, band_hi[i], band_lo[i]);
  }
  if (TCA) {
    for (int i = tid; i < ATAB; i += NTHR) {
      const float v =
          (i >= ATAB_PAD && i < ATAB_PAD + K) ? h_audio[i - ATAB_PAD] : 0.0f;
      split_tf32(v, atab_hi[i], atab_lo[i]);
    }
  } else if (HAS_AUDIO_FIR) {
    for (int k = tid; k < K; k += NTHR) ha[k] = h_audio[k];
  }
  // the demod ring is swizzled for the tensor-core form's fragment loads;
  // the SIMT loop walks a column of plain rows
  auto aswz = [](int row, int col) {
    return TCA ? swz(row, col) : row * WC + col;
  };
  // zeros everywhere: rows that no emitted output reads still meet zeros of
  // the bands, so they have to be finite
  for (int i = tid; i < RING_FLOATS + ARING_FLOATS; i += NTHR) smem[i] = 0.0f;

  // ---- the warp's column order: channel j of the warp (lanes j and j+16)
  // goes to column `col`. Stable position `pos` by law, then dealt round the
  // four column classes (class cc = columns 4t + cc); the identity where
  // every class is uniform as the channels stand
  bool ident;
  {
    // a channel past C sorts as the default law
    const int m = cw + cm < C ? mode[cw + cm] : 3;
    const int key = static_cast<unsigned>(m) > 3u ? 3 : m;
    int below = 0;
    uint32_t same = 0;
#pragma unroll
    for (int law = 0; law < 4; ++law) {
      const uint32_t b = __ballot_sync(FULL, key == law) & 0xFFFFu;
      if (law < key) below += __popc(b);
      if (law == key) same = b;
    }
    ident = __all_sync(FULL, key == __shfl_sync(FULL, key, lane & 3));
    const int pos = below + __popc(same & ((1u << cm) - 1u));
    const int col = ident ? cm : 4 * (pos & 3) + (pos >> 2);
    if (lane < WC) colch[warp * WC + col] = cm;
  }
  __syncthreads();
  // past the last channel: nothing of this warp is stored (no block barrier
  // follows outside PFB, whose channel count is whole blocks)
  if (KIND != PFB && cw >= C) return;

  // mix role: column cm holds channel c_mix, a live one below C; its
  // product loads read column c_ld
  const int c_mix = cw + colch[warp * WC + cm];
  const bool live = c_mix < C;
  const int c_ld = live ? c_mix : C - 1;
  const uint32_t p0 = live ? static_cast<uint32_t>(phase0[c_mix]) : 0u;
  const uint32_t st = live ? static_cast<uint32_t>(step[c_mix]) : 0u;
  // demod role: columns 4t..4t+3
  int chd[4], md[4];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    chd[cc] = cw + colch[warp * WC + 4 * t + cc];
    md[cc] = chd[cc] < C ? mode[chd[cc]] : 3;
  }
  // lane offset of a fragment load: row t (and t + 4) of eight rows, the
  // column pair 2g, 2g+1
  const int frag = swz(t, 2 * g);

  // FAST: the LO of a lane's rows n0 + hm + 2r is the exact phasor of row
  // n0 + hm times the exact phasors of 2r steps (in registers for the whole
  // tile)
  float rot_s[HR], rot_c[HR];
  if (FAST) {
#pragma unroll
    for (int r = 0; r < HR; ++r)
      lo_sincos<true>(0u, st, 2 * r, &rot_s[r], &rot_c[r]);
  }

  // Chunk n0 sits in ring slot (n0 / S) mod NSLOT; its window row j (row
  // n0 - K + j of the stream) is in slot cur + 1 + j / S. Demod row n sits
  // in ring row n mod ARING
  float lag_i[4], lag_q[4];  // lanes g == 0: the shaped row before the chunk
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) lag_i[cc] = lag_q[cc] = 0.0f;
  int start;
  if (r0 == 0) {
    // block-carried state: rows -(K-1)..-1 of the mixed and demod streams
    for (int j = hm; live && j < K - 1; j += 2) {
      ring_i[swz(S + 1 + j, cm)] = hist_i0[(size_t)j * C + c_mix];
      ring_q[swz(S + 1 + j, cm)] = hist_q0[(size_t)j * C + c_mix];
      if (HAS_AUDIO_FIR)
        ba[aswz(ARING - (K - 1) + j, cm)] = ahist0[(size_t)j * C + c_mix];
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      if (chd[cc] < C) {
        lag_i[cc] = prev0[chd[cc]];
        lag_q[cc] = prev0[C + chd[cc]];
      }
    }
    start = 0;
  } else {
    // halo recompute: mixed rows from r0-HALO make shaped rows valid from
    // r0-HALO+K-1. Without the audio FIR (HALO = K) that is row r0-1, the
    // FM lag of row r0. With it (HALO = 2K) demod rows are valid from
    // r0-K+1, the audio FIR's K-1 rows before r0
    start = r0 - HALO;
  }
  // chunks before this row are only mixed: nobody reads their shaped rows
  const int fir_from = r0 - (HAS_AUDIO_FIR ? K : S);

  // ---- the band's fragment values. Band element (r, j) is
  // band[j - r - 1 + BAND_PAD], so k-step kk takes a0 (g, 8kk + t) =
  // band[8kk + band_at + 8], a1 (g + 8, ..) = band[8kk + band_at], a2 =
  // band[8kk + band_at + 12], a3 = band[8kk + band_at + 4]: 22 distinct
  // values a thread, read from the split table at every k-step (in
  // registers they cost 44, and with them the body spilled at the 168 that
  // three blocks an SM leave a thread)
  const int band_at = t - g + 7;

  // ---- one group of the tensor-core audio FIR: outputs at rows G + 5o,
  // o < 8, of the warp's 16 channels, from demod rows G-K..G+39 (row G-K
  // meets the band's padding column). A[m, j]: channel column 2(m % 8) +
  // m / 8, ring row G - K + j; B[j, o] = atab[j - 5o - 1 + ATAB_PAD]
  const int atab_at = t - AD * g - 1 + ATAB_PAD;
  auto audio_group = [&](int G) {
    float d_hh[4], d_lh[4], d_hl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) d_hh[i] = d_lh[i] = d_hl[i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < AKSTEPS; ++kk) {
      const float* const p =
          ba + ((G - K + 8 * kk) & (ARING - 1)) * WC + frag;
      const float2 v0 = *reinterpret_cast<const float2*>(p);
      const float2 v1 = *reinterpret_cast<const float2*>(p + 4 * WC);
      uint32_t ah[4], al[4];
      split_tf32(v0.x, ah[0], al[0]);
      split_tf32(v0.y, ah[1], al[1]);
      split_tf32(v1.x, ah[2], al[2]);
      split_tf32(v1.y, ah[3], al[3]);
      const uint32_t b0h = atab_hi[atab_at + 8 * kk];
      const uint32_t b1h = atab_hi[atab_at + 8 * kk + 4];
      const uint32_t b0l = atab_lo[atab_at + 8 * kk];
      const uint32_t b1l = atab_lo[atab_at + 8 * kk + 4];
      mma_tf32(d_lh, al[0], al[1], al[2], al[3], b0h, b1h);
      mma_tf32(d_hh, ah[0], ah[1], ah[2], ah[3], b0h, b1h);
      mma_tf32(d_hl, ah[0], ah[1], ah[2], ah[3], b0l, b1l);
    }
    // d0, d1: channel column 2g, outputs 2t, 2t+1; d2, d3: column 2g+1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = G + AD * (2 * t + (i & 1));
      if (row >= r0 && row < r1) {
        const int ch = cw + colch[warp * WC + 2 * g + (i >> 1)];
        if (ch < C)
          out[(size_t)(row / AD) * C + ch] = (d_lh[i] + d_hl[i]) + d_hh[i];
      }
    }
  };
  int ag = (r0 / AGROUP) * AGROUP;  // the next audio group's first row

  // product rows of the current chunk, this lane's rows 2r + hm of column
  // cm, in registers. AUDIO and CHANRATE load them from the product, the
  // next chunk's while this chunk is demodulated so their latency hides;
  // PFB reads them from the group's product in shared memory
  constexpr bool BF16_IN = KIND != PFB && IN == IN_BF16;
  float cxi[HR], cxq[HR];
  // IN_BF16: rows 2(4j + cm/4) + hm, channels 4(cm%4)..+3 of the warp, 8
  // bytes a load; unpack_rows() hands them round
  uint2 rawi[2], rawq[2];
  auto load_rows = [&](int n) {
    if constexpr (BF16_IN) {
      const auto* const pa = static_cast<const __nv_bfloat16*>(xa);
      const auto* const pb = static_cast<const __nv_bfloat16*>(xb);
      // C is a multiple of 4: a load's four channels are all live or none
      const int group = min(cw + 4 * (cm & 3), C - 4);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t at = (size_t)(n + 2 * (4 * j + (cm >> 2)) + hm) *
                              row_stride + group;
        rawi[j] = *reinterpret_cast<const uint2*>(pa + at);
        rawq[j] = *reinterpret_cast<const uint2*>(pb + at);
      }
    } else if constexpr (KIND != PFB) {
      const float* const pa = static_cast<const float*>(xa);
      const float* const pb = static_cast<const float*>(xb);
#pragma unroll
      for (int r = 0; r < HR; ++r) {
        cxi[r] = pa[(size_t)(n + 2 * r + hm) * row_stride + c_ld];
        cxq[r] = pb[(size_t)(n + 2 * r + hm) * row_stride + c_ld];
      }
    }
  };
  // IN_BF16: row 2r + hm of channel chl sits in lane hm*16 + 4(r%4) +
  // chl/4, load r/4, half word chl%4 of its 8 bytes
  const int chl = c_mix - cw;
  auto unpack_rows = [&]() {
#pragma unroll
    for (int r = 0; r < HR; ++r) {
      const int src = (lane & 16) | (4 * (r & 3)) | (chl >> 2);
      const uint32_t ix = __shfl_sync(FULL, rawi[r >> 2].x, src);
      const uint32_t iy = __shfl_sync(FULL, rawi[r >> 2].y, src);
      const uint32_t qx = __shfl_sync(FULL, rawq[r >> 2].x, src);
      const uint32_t qy = __shfl_sync(FULL, rawq[r >> 2].y, src);
      const uint32_t wi = (chl & 2) ? iy : ix;
      const uint32_t wq = (chl & 2) ? qy : qx;
      cxi[r] = (chl & 1) ? bf16_high(wi) : bf16_low(wi);
      cxq[r] = (chl & 1) ? bf16_high(wq) : bf16_low(wq);
    }
  };
  if (KIND != PFB) load_rows(start);

  float pacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int cur = (start / S) % NSLOT;  // ring slot of the current chunk
  for (int g0 = start; g0 < r1; g0 += GROUP) {
    if constexpr (KIND == PFB && IN != T_HIGHEST) {
      // ---- filterbank product for rows g0..g0+PM-1 on the bf16 tensor
      // cores: warp w makes rows 16w..16w+15, all 128 columns
      const int kp2 = static_cast<int>(row_stride);
      const int n_slices = kp2 / KS;
      const float* const fa = static_cast<const float*>(xa);
      const auto* const wh = static_cast<const __nv_bfloat16*>(xb);
      const auto* const wl = static_cast<const __nv_bfloat16*>(xc);
      float acc[NTILES][4];
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;

      auto load_slice = [&](int s, int sg) {
        float* const as = stage + sg * STAGE_FLOATS;
        __nv_bfloat16* const bs = reinterpret_cast<__nv_bfloat16*>(
            as + PM * LDA);
        for (int i = tid; i < PM * (KS / 4); i += NTHR) {
          const int row = i / (KS / 4);
          const int pc = i % (KS / 4);
          cp_async16(as + row * LDA + 4 * pc,
                     fa + (size_t)(g0 + row) * kp2 + s * KS + 4 * pc);
        }
        // weights: KS taps x (the block's I columns, then its Q columns),
        // 8 bfloat16 a copy; hi, then (T_HIGH) lo
        constexpr int PIECES = KS * (2 * NC / 8);
        for (int i = tid; i < (IN == T_HIGH ? 2 : 1) * PIECES; i += NTHR) {
          const int half = i / PIECES;
          const int tap = (i % PIECES) / (2 * NC / 8);
          const int col = 8 * (i % (2 * NC / 8));
          const int src_col = col < NC ? c0 + col : C + c0 + col - NC;
          cp_async16(bs + half * KS * LDBH + tap * LDBH + col,
                     (half ? wl : wh) + (size_t)(s * KS + tap) * 2 * C +
                         src_col);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
      };

      __syncthreads();
      load_slice(0, 0);
      for (int s = 0; s < n_slices; ++s) {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();
        if (s + 1 < n_slices) load_slice(s + 1, (s + 1) & 1);
        const float* const as =
            stage + (s & 1) * STAGE_FLOATS + (16 * warp + g) * LDA + 2 * t;
        const unsigned short* const bh =
            reinterpret_cast<const unsigned short*>(
                stage + (s & 1) * STAGE_FLOATS + PM * LDA) +
            2 * t * LDBH + g;
        const unsigned short* const bl = bh + KS * LDBH;
        // A: rows g, g+8 of the warp's 16, taps 2t, 2t+1 and 2t+8, 2t+9
        const float2 f[4] = {
            *reinterpret_cast<const float2*>(as),
            *reinterpret_cast<const float2*>(as + 8 * LDA),
            *reinterpret_cast<const float2*>(as + 8),
            *reinterpret_cast<const float2*>(as + 8 * LDA + 8)};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = pack_bf16(f[i].x, f[i].y);
          if (IN == T_HIGH)
            al[i] = pack_bf16(f[i].x - bf16_low(ah[i]),
                              f[i].y - bf16_high(ah[i]));
        }
        // B of n-tile nt: taps 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of column
        // 8nt + g
        auto b_of = [&](const unsigned short* p, int nt, uint32_t& b0,
                        uint32_t& b1) {
          p += 8 * nt;
          b0 = p[0] | (static_cast<uint32_t>(p[LDBH]) << 16);
          b1 = p[8 * LDBH] | (static_cast<uint32_t>(p[9 * LDBH]) << 16);
        };
        if (IN == T_HIGH) {
#pragma unroll
          for (int nt = 0; nt < NTILES; ++nt) {
            uint32_t b0, b1;
            b_of(bh, nt, b0, b1);
            mma_bf16(acc[nt], al, b0, b1);
          }
#pragma unroll
          for (int nt = 0; nt < NTILES; ++nt) {
            uint32_t b0, b1;
            b_of(bl, nt, b0, b1);
            mma_bf16(acc[nt], ah, b0, b1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) {
          uint32_t b0, b1;
          b_of(bh, nt, b0, b1);
          mma_bf16(acc[nt], ah, b0, b1);
        }
      }
      __syncthreads();  // every warp is done with the stages
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        float* const pp = stage + (16 * warp + g) * LDP + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(pp) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(pp + 8 * LDP) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
      __syncthreads();
    } else if constexpr (KIND == PFB) {
      // ---- filterbank product for rows g0..g0+PM-1 on float32 FMAs, one
      // chain per output in tap order (what a float32 matmul computes).
      // A thread makes an 8 x 8 patch: rows 8rg..8rg+7, I and Q columns of
      // channels 4cg..4cg+3
      const int kp2 = static_cast<int>(row_stride);
      const float* const fa = static_cast<const float*>(xa);
      const float* const fb = static_cast<const float*>(xb);
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
                     fa + (size_t)(g0 + row) * kp2 + s * KS + 4 * pc);
        }
        // weights: KS taps x (the block's I columns, then its Q columns)
        for (int i = tid; i < KS * (2 * NC / 4); i += NTHR) {
          const int tap = i / (2 * NC / 4);
          const int col = 4 * (i % (2 * NC / 4));
          const int src_col = col < NC ? c0 + col : C + c0 + col - NC;
          cp_async16(bs + tap * LDB + col,
                     fb + (size_t)(s * KS + tap) * 2 * C + src_col);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
      };

      // every warp has mixed the last group's product out of the stages
      __syncthreads();
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
    }

    for (int n0 = g0; n0 < g0 + GROUP; n0 += S) {
      if constexpr (BF16_IN) unpack_rows();
      if (KIND == PFB) {
        const float* const pp =
            stage + (n0 - g0 + hm) * LDP + (c_mix - c0);
#pragma unroll
        for (int r = 0; r < HR; ++r) {
          cxi[r] = pp[2 * r * LDP];
          cxq[r] = pp[2 * r * LDP + NC];
        }
      }

      // ---- residual NCO mix: this lane's rows into the ring's current
      // slot
      {
        float s0 = 0.0f, co0 = 1.0f;
        if (FAST) lo_sincos<true>(p0, st, n0 + hm, &s0, &co0);
#pragma unroll
        for (int r = 0; r < HR; ++r) {
          float s, co;
          if (FAST) {
            s = s0 * rot_c[r] + co0 * rot_s[r];
            co = co0 * rot_c[r] - s0 * rot_s[r];
          } else {
            lo_sincos<false>(p0, st, n0 + 2 * r + hm, &s, &co);
          }
          // swz(): row 2r + hm of a slot, so the XOR bit is r's lowest
          const int at = (cur * S + 2 * r + hm) * WC + (cm ^ ((r & 1) << 3));
          ring_i[at] = cxi[r] * co + cxq[r] * s;
          ring_q[at] = cxq[r] * co - cxi[r] * s;
        }
      }
      __syncwarp();

      const bool shaped = n0 >= fir_from;  // uniform over the block
      float y_i[4][2], y_q[4][2];  // [column 4t + cc][row g, row g + 8]
      if (shaped) {
        // ---- shaping FIR on the tensor cores: window row j is stream row
        // n0 - K + j; rows 16jb..16jb+15 sit in slot cur+1+jb (mod NSLOT),
        // the chunk itself (jb = NSLOT-1) in slot cur. Tile (plane p,
        // n-tile nt) is index 2p + nt; a_hi b_hi apart from the small terms
        float am[4][4], ac[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) am[q][i] = ac[q][i] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          int slot = cur + 1 + (kk >> 1);
          if (slot >= NSLOT) slot -= NSLOT;
          const int at = (slot * S + (kk & 1) * 8) * WC + frag;
          const float2 vi0 = *reinterpret_cast<const float2*>(ring_i + at);
          const float2 vi1 =
              *reinterpret_cast<const float2*>(ring_i + at + 4 * WC);
          const float2 vq0 = *reinterpret_cast<const float2*>(ring_q + at);
          const float2 vq1 =
              *reinterpret_cast<const float2*>(ring_q + at + 4 * WC);
          const uint32_t* const eh = band_hi + 8 * kk + band_at;
          const uint32_t* const el = band_lo + 8 * kk + band_at;
          uint32_t bh[4][2], bl[4][2];
          split_tf32(vi0.x, bh[0][0], bl[0][0]);
          split_tf32(vi1.x, bh[0][1], bl[0][1]);
          split_tf32(vi0.y, bh[1][0], bl[1][0]);
          split_tf32(vi1.y, bh[1][1], bl[1][1]);
          split_tf32(vq0.x, bh[2][0], bl[2][0]);
          split_tf32(vq1.x, bh[2][1], bl[2][1]);
          split_tf32(vq0.y, bh[3][0], bl[3][0]);
          split_tf32(vq1.y, bh[3][1], bl[3][1]);
          // term by term over the four tiles, so consecutive mma do not
          // wait on one another's accumulator
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(ac[q], el[8], el[0], el[12], el[4], bh[q][0], bh[q][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(am[q], eh[8], eh[0], eh[12], eh[4], bh[q][0], bh[q][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(ac[q], eh[8], eh[0], eh[12], eh[4], bl[q][0], bl[q][1]);
        }
        // fragment (nt, i) is row g + 8(i / 2) of column 2(2t + i % 2) + nt
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            y_i[2 * (i & 1) + nt][i >> 1] = am[nt][i] + ac[nt][i];
            y_q[2 * (i & 1) + nt][i >> 1] = am[2 + nt][i] + ac[2 + nt][i];
          }
      }

      // the next chunk's product rows, in flight during the demod
      if (KIND != PFB) load_rows(n0 + S < r1 ? n0 + S : n0);

      if (shaped) {
        // ---- demod from the fragments. The row before row g (g + 8) is
        // lane - 4's row g (g + 8) value; for the lanes g == 0 it is the
        // carried lag (row 7, which the lanes g == 7 hold as their row g)
        const int before = (lane + 28) & 31;
        float a[4][2];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float yi0 = y_i[cc][0], yq0 = y_q[cc][0];
          const float yi1 = y_i[cc][1], yq1 = y_q[cc][1];
          // lanes g == 0 receive row 7 and row 15, the next chunk's lag.
          // (Skipping the shuffles in a warp that holds no FM slot made the
          // body slower, not faster.)
          const float u0i = __shfl_sync(FULL, yi0, before);
          const float u0q = __shfl_sync(FULL, yq0, before);
          const float u1i = __shfl_sync(FULL, yi1, before);
          const float u1q = __shfl_sync(FULL, yq1, before);
          const float pi0 = g ? u0i : lag_i[cc];
          const float pq0 = g ? u0q : lag_q[cc];
          const float pi1 = g ? u1i : u0i;
          const float pq1 = g ? u1q : u0q;
          lag_i[cc] = u1i;
          lag_q[cc] = u1q;
          switch (md[cc]) {
            case 0:  // AM
              a[cc][0] = sqrtf(yi0 * yi0 + yq0 * yq0);
              a[cc][1] = sqrtf(yi1 * yi1 + yq1 * yq1);
              break;
            case 1:  // FM
              a[cc][0] = fm_law(yi0, yq0, pi0, pq0);
              a[cc][1] = fm_law(yi1, yq1, pi1, pq1);
              break;
            case 2:  // USB
              a[cc][0] = yi0 + yq0;
              a[cc][1] = yi1 + yq1;
              break;
            default:  // LSB
              a[cc][0] = yi0 - yq0;
              a[cc][1] = yi1 - yq1;
              break;
          }
          // chunks start at r0 - HALO + a multiple of S and HALO is a
          // multiple of S, so a chunk lies wholly before r0 or from it on
          if (n0 >= r0) {
            pacc[cc] += yi0 * yi0 + yq0 * yq0;
            pacc[cc] += yi1 * yi1 + yq1 * yq1;
          }
        }

        if (HAS_AUDIO_FIR) {
          // rows n0 + g and n0 + g + 8 of columns 4t..4t+3
          float* const p = ba + aswz((n0 + g) & (ARING - 1), 4 * t);
          *reinterpret_cast<float4*>(p) =
              make_float4(a[0][0], a[1][0], a[2][0], a[3][0]);
          *reinterpret_cast<float4*>(p + 8 * WC) =
              make_float4(a[0][1], a[1][1], a[2][1], a[3][1]);
          __syncwarp();
          if (TCA) {
            // ---- decimating audio FIR, every group whose rows are in
            while (ag + AGROUP <= n0 + S) {
              audio_group(ag);
              ag += AGROUP;
            }
          } else {
            // ---- decimating audio FIR: outputs m*D in [max(n0, r0),
            // n0 + S), every second one this lane's. Output nn reads demod
            // rows nn-K+1..nn of column cm
            // rows nn-K+1..nn of column cm; they wrap at most once
            const int first = max(n0, r0);
            const int lim = min(n0 + S, r1);
            for (int nn = ((first + D - 1) / D) * D; nn < lim; nn += D) {
              if (((nn / D) & 1) != hm) continue;
              const int row = (nn - (K - 1)) & (ARING - 1);
              const int k1 = min(K, ARING - row);  // taps before the wrap
              const float* p = ba + row * WC + cm;
              float acc = 0.0f;
#pragma unroll 4
              for (int k = 0; k < k1; ++k) acc = fmaf(ha[k], p[k * WC], acc);
              p = ba + cm - k1 * WC;
#pragma unroll 4
              for (int k = k1; k < K; ++k) acc = fmaf(ha[k], p[k * WC], acc);
              if (live) out[(size_t)(nn / D) * C + c_mix] = acc;
            }
          }
        } else if (n0 >= r0) {
          // ---- channel-rate audio: rows n0 + g and n0 + g + 8; 16 bytes a
          // lane where the column order is the identity and the four
          // channels are live and 16-byte aligned
          float* const o0 = out + (size_t)(n0 + g) * C;
          float* const o1 = o0 + (size_t)8 * C;
          if (ident && (C & 3) == 0 && chd[0] < C) {
            *reinterpret_cast<float4*>(o0 + chd[0]) =
                make_float4(a[0][0], a[1][0], a[2][0], a[3][0]);
            *reinterpret_cast<float4*>(o1 + chd[0]) =
                make_float4(a[0][1], a[1][1], a[2][1], a[3][1]);
          } else {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              if (chd[cc] < C) {
                o0[chd[cc]] = a[cc][0];
                o1[chd[cc]] = a[cc][1];
              }
            }
          }
        }
      }
      // the next chunk's mix overwrites the oldest slot, which this chunk's
      // fragment loads have read
      __syncwarp();
      cur = cur + 1 == NSLOT ? 0 : cur + 1;
    }
  }
  // the tile's last audio group: its rows from r1 on are an earlier
  // chunk's, finite, and meet only outputs that are not stored
  if (TCA && ag < r1) audio_group(ag);

  // the tile's power: a lane's rows in order, then the column's eight lanes
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    float p = pacc[cc];
    p += __shfl_xor_sync(FULL, p, 4);
    p += __shfl_xor_sync(FULL, p, 8);
    p += __shfl_xor_sync(FULL, p, 16);
    if (g == 0 && chd[cc] < C) power_part[(size_t)tile * C + chd[cc]] = p;
  }

  if (r1 == nd) {
    // carries: the last K-1 mixed rows, the last shaped row, the last K-1
    // demod rows. The mixed rows are window rows 1..K-1 of the chunk that
    // would come next (slot cur): ring rows (cur+1)*S + j, wrapped
    for (int j = hm; live && j < K - 1; j += 2) {
      int at = (cur + 1) * S + 1 + j;
      if (at >= WIN) at -= WIN;
      hist_i[(size_t)j * C + c_mix] = ring_i[swz(at, cm)];
      hist_q[(size_t)j * C + c_mix] = ring_q[swz(at, cm)];
      if (HAS_AUDIO_FIR)
        ahist[(size_t)j * C + c_mix] =
            ba[aswz((nd - (K - 1) + j) & (ARING - 1), cm)];
    }
    if (g == 0) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (chd[cc] < C) {
          prev[chd[cc]] = lag_i[cc];
          prev[C + chd[cc]] = lag_q[cc];
        }
      }
    }
  }
}


// the kernel for (KIND, IN), picked by the decimation (the audio FIR's
// form) and the LO law
template <int KIND, int IN>
auto pick_kernel(int D, int fast) {
  constexpr bool HAS_AUDIO_FIR = KIND != CHANRATE;
  return HAS_AUDIO_FIR && D == AD
             ? (fast ? tail_tm_kernel<true, KIND, HAS_AUDIO_FIR, IN>
                     : tail_tm_kernel<false, KIND, HAS_AUDIO_FIR, IN>)
             : (fast ? tail_tm_kernel<true, KIND, false, IN>
                     : tail_tm_kernel<false, KIND, false, IN>);
}

template <int KIND>
int launch(const void* xa, const void* xb, const void* xc,
           long long row_stride, const void* phase0, const void* step,
           const void* h_shape, const void* h_audio, const void* mode,
           const void* hist_i0, const void* hist_q0, const void* prev0,
           const void* ahist0, void* out, void* hist_i, void* hist_q,
           void* prev, void* ahist, void* power_part, void* power, int nd,
           int C, int taps, int D, int tile_rows, int fast, int in,
           int device, void* stream) {
  constexpr int halo = KIND == CHANRATE ? K : 2 * K;
  // rows come in chunks of S, or in product groups of PM whose slices are
  // copied 16 bytes at a time
  constexpr int rows = KIND == PFB ? PM : S;
  const auto misaligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes != 0;
  };
  // AUDIO and CHANRATE take any channel count (a bfloat16 product's a
  // multiple of 4: 8-byte loads); PFB stages whole 64-channel blocks
  if (taps != K || C < 1 || (KIND == PFB && C % NC != 0) || nd % rows != 0 ||
      tile_rows % rows != 0 ||
      tile_rows < halo || D < 1 || nd % D != 0 || row_stride < 1 ||
      misaligned(out, 16) ||
      (KIND == PFB &&
       (C / NC > 65535 || row_stride % KS != 0 || in < 0 || in > 2 ||
        misaligned(xa, 16) || misaligned(xb, 16) ||
        (in == T_HIGH && misaligned(xc, 16)))) ||
      (KIND != PFB && (in < 0 || in > 1 ||
                       (in == IN_BF16 &&
                        (C % 4 != 0 || row_stride % 4 != 0 ||
                         misaligned(xa, 8) ||
                         misaligned(xb, 8)))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem_floats = 2 * NWARP * WIN * WC;
  if (KIND != CHANRATE) smem_floats += NWARP * ARING * WC;
  if (KIND == PFB) smem_floats += PFB_FLOATS;
  const size_t smem_bytes = smem_floats * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = pick_kernel<KIND, 0>(D, fast);
  if constexpr (KIND == PFB) {
    if (in == T_DEFAULT) kernel = pick_kernel<KIND, T_DEFAULT>(D, fast);
    if (in == T_HIGH) kernel = pick_kernel<KIND, T_HIGH>(D, fast);
  } else {
    if (in == IN_BF16) kernel = pick_kernel<KIND, IN_BF16>(D, fast);
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (nd + tile_rows - 1) / tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (C + NC - 1) / NC;
  const dim3 grid = KIND == PFB ? dim3(n_tiles, groups)
                                : dim3(groups, n_tiles);
  kernel<<<grid, NTHR, smem_bytes, s>>>(
      xa, xb, xc, row_stride, static_cast<const long long*>(phase0),
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
// as x[n * row_stride + c] for n < nd, c < C (xq points at the Q columns),
// float32, or bfloat16 where in_bf16 (8-byte aligned, row_stride % 4 == 0);
// phase0/step [C] int64 holding uint32; h_shape/h_audio [K] reversed
// kernels; mode [C] int32; hist_i0/hist_q0/ahist0 and the outputs
// hist_i/hist_q/ahist [K-1, C]; prev0/prev [2, C]; audio48 [nd/D, C],
// 16-byte aligned; power_part [n_tiles, C] scratch; power [C]. Returns
// cudaGetLastError().
int webradio_tail_tm_launch(
    const void* xi, const void* xq, long long row_stride, const void* phase0,
    const void* step, const void* h_shape, const void* h_audio,
    const void* mode, const void* hist_i0, const void* hist_q0,
    const void* prev0, const void* ahist0, void* audio48, void* hist_i,
    void* hist_q, void* prev, void* ahist, void* power_part, void* power,
    int nd, int C, int taps, int D, int tile_rows, int fast, int in_bf16,
    int device, void* stream) {
  return launch<AUDIO>(xi, xq, nullptr, row_stride, phase0, step, h_shape,
                       h_audio, mode, hist_i0, hist_q0, prev0, ahist0,
                       audio48, hist_i, hist_q, prev, ahist, power_part,
                       power, nd, C, taps, D, tile_rows, fast, in_bf16,
                       device, stream);
}

// The tail without the audio FIR: audio [nd, C] at the channel rate; the
// other arguments as above (no h_audio, ahist0, ahist or D).
int webradio_tail_tm_chanrate_launch(
    const void* xi, const void* xq, long long row_stride, const void* phase0,
    const void* step, const void* h_shape, const void* mode,
    const void* hist_i0, const void* hist_q0, const void* prev0, void* audio,
    void* hist_i, void* hist_q, void* prev, void* power_part, void* power,
    int nd, int C, int taps, int tile_rows, int fast, int in_bf16,
    int device, void* stream) {
  return launch<CHANRATE>(xi, xq, nullptr, row_stride, phase0, step,
                          h_shape, nullptr, mode, hist_i0, hist_q0, prev0,
                          nullptr, audio, hist_i, hist_q, prev, nullptr,
                          power_part, power, nd, C, taps, 1, tile_rows, fast,
                          in_bf16, device, stream);
}

// The audio-fused tail with the filterbank product made in the kernel:
// frames [nd, kp2] float32 and the packed weights [kp2, 2C] (columns [:C]
// make mixed I, [C:] mixed Q) take the product planes' place. tier 0
// ("highest"): float32 weights in `weights`; 1 ("default"): the bfloat16
// hi half in `weights`; 2 ("high"): hi in `weights`, lo in `weights_lo`;
// all 16-byte aligned.
int webradio_pfb_tail_tm_launch(
    const void* frames, const void* weights, const void* weights_lo, int kp2,
    const void* phase0, const void* step, const void* h_shape,
    const void* h_audio, const void* mode, const void* hist_i0,
    const void* hist_q0, const void* prev0, const void* ahist0,
    void* audio48, void* hist_i, void* hist_q, void* prev, void* ahist,
    void* power_part, void* power, int nd, int C, int taps, int D,
    int tile_rows, int fast, int tier, int device, void* stream) {
  return launch<PFB>(frames, weights, weights_lo, kp2, phase0, step, h_shape,
                     h_audio, mode, hist_i0, hist_q0, prev0, ahist0, audio48,
                     hist_i, hist_q, prev, ahist, power_part, power, nd, C,
                     taps, D, tile_rows, fast, tier, device, stream);
}

const char* webradio_tail_tm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
