// Composite 12-channel GPS L1 C/A IQ synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pluto_gps_sim_tpu/ops/synth_pallas.py::_kernel (with its epilogue
// _emit_epilogue).  It computes the same function word for word; the
// arithmetic is specified in docs/KERNEL_MATH.md and in the docstring of
// pluto_gps_sim_tpu_torch/ops/synth_cuda.py, whose synth_blocks_plain is
// the plain PyTorch twin this kernel is held to.
//
// What bounds it on this card: per (channel, sample) the function needs
// at least about 22 32-bit operations at 2.6 MHz (the carrier and code
// NCO ramps down to a 9-bit carrier index and an integer chip, the
// spreading sign, one gain-scaled lookup and one add; chip_smoke.py's
// kernel_bound counts them) against 4 output bytes per sample for all 12
// channels.  300 blocks x 260,000 samples write 312 MB (0.09 ms at
// 3.35 TB/s) but need ~2.1e10 operations (0.63 ms at 128 lanes/clk/SM),
// so it is compute-bound: what counts is instructions per channel-sample.
// The TPU kernel scaled every sample by its channel's gain,
// trunc(f32(T) * f32(g)), because a gather is costly there; a direct port
// spent 8 float <-> int conversions per channel-sample on the card's
// 16-per-clock conversion pipe and ~60 instructions in all.  The design:
//   - a per-row gain-and-sign table in shared memory: for each active
//     channel a, tab[a][itab | s << 9] holds the biased, gain-scaled pair
//     u, or kBias2 - u where the spreading sign s negates it, built with
//     the per-sample expression's own bits, so the main loop does one
//     shared load and one add where the TPU kernel did 4 conversions, 2
//     products and the sign arithmetic (u32 addition is associative, so
//     the accumulator is the same word);
//   - chip // 1023 as __umulhi(chip, 0x401005), exact for every chip
//     below 2^20, i.e. every value tq >> 12 of a u32 can take;
//   - the row's 12 C/A codes unpacked to one byte per chip, so a chip is
//     one byte load, and the nav bit moved straight to bit 9 of the key
//     by a clamped funnel shift;
//   - a persistent grid: as many 256-thread blocks as fit on the card at
//     once, each walking a contiguous range of (row, 2048-sample chunk)
//     items in row-major order and rebuilding its tables only when the
//     row changes; 8 samples per thread stay in registers.
// The two f32 truncations of the NCO residuals (srem * n, rrr * n) are
// the only conversions left per channel-sample.

// Layout (see synth_cuda.py): the param planes are [M, 256] int32 / f32
// with the per-channel columns at 12*j + c and patch slot k's copies at
// 128 + 10*k (ints) and 128 + 6*k (floats, word at lane 5); ca_tabs is
// [NS, 12, 1, 128] int32 (chip k in bit k & 31 of word k >> 5; words
// 32..127 are padding, never read); pairtab is the 512-entry biased table
// (cos+512) | (sin+512) << 16.
//
// Arithmetic notes: everything that wraps on the TPU (u32 phase, Q-level
// ramps) is uint32_t here, since signed overflow is undefined in C++;
// the carrier residual's >> 12 is arithmetic on purpose (it may be
// negative) and every other shift is logical; every f32 -> int is a
// truncation of a correctly rounded product (__fmul_rn, __float2int_rz),
// so nothing is contracted into an FMA.  Build without --use_fast_math.

#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kC = 12;              // channel slots
constexpr int kLanes = 128;         // words per C/A row, lanes per half plane
constexpr int kPlane = 2 * kLanes;  // parameter-plane row width
constexpr int kNPatch = 7;          // gain-trunc patch slots per block
constexpr int kSlotIW = 10;         // int lanes per patch slot
constexpr int kSlotFW = 6;          // float lanes per patch slot
constexpr int kSlotWord = 5;        // float slot lane holding the word
constexpr int kColF_Gain = 48;      // f32 plane column base of the gain
constexpr int kThreads = 256;
constexpr int kMinBlocksPerSM = 3;
constexpr int kSamplesPerThread = 8;
constexpr int kChunk = kThreads * kSamplesPerThread;
constexpr int kTab = 1024;          // table entries per channel: itab | s << 9
constexpr int kCaLen = 1023;
constexpr int kCaRow = 1024;        // C/A row unpacked to a byte per chip
constexpr uint32_t kDiv1023 = 0x401005u;  // ceil(2^32 / 1023)
constexpr uint32_t kNavMul = 3277u;       // (x * 3277) >> 16 == x // 20
constexpr uint32_t kBias2 = 2048u | (2048u << 16);
constexpr size_t kTabBytes = sizeof(uint32_t) * kC * kTab;

// one channel's NCO parameters as the per-sample chain reads them, from
// the main columns (stride 12) or from a patch slot's copies (stride 1);
// ic0x is ic0 * 3277 (mod 2^32), ca the row of s_ca to read, word the
// patch word (0 for a channel)
struct alignas(16) Chan {
  uint32_t phase0, step, cp0q, vq, nbm, ic0x, res0q24, r24, res0q36, r36;
  uint32_t sr12, cq12;
  float srem, rrr;
  uint32_t ca, word;
};

__device__ __forceinline__ Chan load_chan(const int32_t* ip, int is,
                                          const float* fp, int fs) {
  Chan ch;
  ch.phase0 = static_cast<uint32_t>(ip[0]);
  ch.step = static_cast<uint32_t>(ip[is]);
  ch.cp0q = static_cast<uint32_t>(ip[2 * is]);
  ch.vq = static_cast<uint32_t>(ip[3 * is]);
  ch.nbm = static_cast<uint32_t>(ip[4 * is]);
  ch.ic0x = static_cast<uint32_t>(ip[5 * is]) * kNavMul;
  ch.res0q24 = static_cast<uint32_t>(ip[6 * is]);
  ch.r24 = static_cast<uint32_t>(ip[7 * is]);
  ch.res0q36 = static_cast<uint32_t>(ip[8 * is]);
  ch.r36 = static_cast<uint32_t>(ip[9 * is]);
  ch.sr12 = static_cast<uint32_t>(__float2int_rz(fp[0]));
  ch.srem = fp[fs];
  ch.cq12 = static_cast<uint32_t>(__float2int_rz(fp[2 * fs]));
  ch.rrr = fp[3 * fs];
  return ch;
}

// The per-sample chain of one channel (synth_pallas.py::_kernel's
// chan_vals up to the LUT index): returns the 9-bit carrier index itab
// with the spreading sign (C/A chip XOR nav bit) at bit 9.  ca_row holds
// the channel's C/A chips one byte each (0 or 1).
__device__ __forceinline__ uint32_t sample_key(const Chan& ch,
                                               const uint8_t* ca_row,
                                               uint32_t n, float nf) {
  // carrier: floor u32 anchor + Q12-seeded residual, arithmetic >> 12
  const uint32_t rsum = ch.sr12 * n + ch.cq12 +
                        static_cast<uint32_t>(
                            __float2int_rz(__fmul_rn(ch.srem, nf)));
  const uint32_t phase = ch.phase0 + ch.step * n +
                         static_cast<uint32_t>(static_cast<int32_t>(rsum) >> 12);

  // code: Q12 + Q24 + Q36 integer ramps + f32 fourth level
  const uint32_t rq36 = ch.res0q36 + ch.r36 * n +
                        static_cast<uint32_t>(
                            __float2int_rz(__fmul_rn(ch.rrr, nf)));
  const uint32_t rq24 = ch.res0q24 + ch.r24 * n + (rq36 >> 12);
  const uint32_t chip = (ch.cp0q + ch.vq * n + (rq24 >> 12)) >> 12;
  const uint32_t w = __umulhi(chip, kDiv1023);  // chip // 1023
  const uint32_t cidx = chip - w * kCaLen;      // in [0, 1022]

  // nav bit q = (ic0 + w) // 20 of the per-block 32-bit mask, moved to
  // bit 9: the clamped funnel shift of nbm * 2^9 by q, which gives 0 for
  // q >= 32 as the TPU's logical shift does
  const uint32_t q = (ch.ic0x + w * kNavMul) >> 16;
  const uint32_t nav9 = __funnelshift_rc(ch.nbm << 9, ch.nbm >> 23, q);

  // bit 9 of (chip << 9) + nav9 is chip XOR nav: nothing below bit 9
  // carries into it
  const uint32_t s9 = (static_cast<uint32_t>(ca_row[cidx]) << 9) + nav9;
  return (phase >> 23) | (s9 & 0x200u);
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
synth_blocks_kernel(const int32_t* __restrict__ sf_map,
                    const int32_t* __restrict__ prmi,
                    const float* __restrict__ prmf,
                    const int32_t* __restrict__ ca_tabs,
                    const int32_t* __restrict__ pairtab,
                    int32_t* __restrict__ out0, int32_t* __restrict__ out1,
                    int n_rows, int n_sf, int block_samples, int packed) {
  extern __shared__ uint32_t s_tab[];              // [kC][kTab], dynamic
  __shared__ Chan s_ch[kC];                        // active channels
  __shared__ Chan s_patch[kNPatch];                // nonzero patch slots
  __shared__ float s_gain[kC];
  // C/A chips a byte each, written four at a time; row kC stays zero
  __shared__ uint32_t s_ca[kC + 1][kCaRow / 4];
  __shared__ int s_nact, s_npatch;

  const int tid = threadIdx.x;
  for (int i = tid; i < kCaRow / 4; i += kThreads) {
    s_ca[kC][i] = 0u;
  }

  // this block's contiguous share of the (row, chunk) items
  const int n_chunks = (block_samples + kChunk - 1) / kChunk;
  const long long items = static_cast<long long>(n_rows) * n_chunks;
  const long long i0 = items * blockIdx.x / gridDim.x;
  const long long i1 = items * (blockIdx.x + 1) / gridDim.x;
  int row = static_cast<int>(i0 / n_chunks);
  int chunk = static_cast<int>(i0 - static_cast<long long>(row) * n_chunks);
  int staged = -1;

  for (long long it = i0; it < i1; ++it) {
    if (row != staged) {
      // ---- stage the row: channel and patch parameters, C/A rows, and
      // the gain-and-sign tables of its active channels
      __syncthreads();  // every thread is done with the previous row
      const size_t prow = static_cast<size_t>(row) * kPlane;
      if (tid < 32) {
        const int32_t* pi = prmi + prow;
        const float* pf = prmf + prow;
        const uint32_t below = (1u << tid) - 1u;
        const float g = tid < kC ? pf[kColF_Gain + tid] : 0.0f;
        const uint32_t amask = __ballot_sync(~0u, g != 0.0f);
        if (g != 0.0f) {
          const int a = __popc(amask & below);
          Chan ch = load_chan(pi + tid, kC, pf + tid, kC);
          ch.ca = static_cast<uint32_t>(tid);
          ch.word = 0u;
          s_ch[a] = ch;
          s_gain[a] = g;
        }
        // an empty patch slot (word 0) self-cancels in the TPU kernel,
        // so only the nonzero ones are kept
        const int k = tid - kC;
        const int32_t wk =
            k >= 0 && k < kNPatch
                ? __float2int_rz(pf[kLanes + kSlotFW * k + kSlotWord])
                : 0;
        const uint32_t pmask = __ballot_sync(~0u, wk != 0);
        if (wk != 0) {
          Chan ch = load_chan(pi + kLanes + kSlotIW * k, 1,
                              pf + kLanes + kSlotFW * k, 1);
          const uint32_t c = (static_cast<uint32_t>(wk) >> 2) & 15u;
          ch.ca = c < static_cast<uint32_t>(kC) ? c : kC;
          ch.word = static_cast<uint32_t>(wk);
          s_patch[__popc(pmask & below)] = ch;
        }
        if (tid == 0) {
          s_nact = __popc(amask);
          s_npatch = __popc(pmask);
        }
      }
      const int sf = sf_map[row];
      // the host checks the map before staging it (check_sf_map); an
      // entry out of range aborts the launch rather than read another
      // table
      if (sf < 0 || sf >= n_sf) __trap();
      // unpack the 12 bit-packed C/A rows of the block's superframe to
      // one byte per chip, four chips per 32-bit store
      const int32_t* ca = ca_tabs + static_cast<size_t>(sf) * kC * kLanes;
      for (int i = tid; i < kC * kCaRow / 4; i += kThreads) {
        const int c = i / (kCaRow / 4), k = 4 * (i % (kCaRow / 4));
        const uint32_t x =
            static_cast<uint32_t>(ca[c * kLanes + (k >> 5)]) >> (k & 31);
        s_ca[c][k / 4] =
            (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
      }
      __syncthreads();

      // tab[a][itab | s << 9]: the per-sample expression's
      // u = (trunc(f32(tc)*g) + 1024) | (trunc(f32(ts)*g) + 1024) << 16,
      // complemented around the bias where the sign negates
      const int nact = s_nact;
      for (int e = tid; e < kTab; e += kThreads) {
        const uint32_t p = static_cast<uint32_t>(__ldg(pairtab + (e & 511)));
        const float tcf = __int2float_rn(static_cast<int32_t>(p & 0xFFFFu) - 512);
        const float tsf = __int2float_rn(static_cast<int32_t>(p >> 16) - 512);
        const uint32_t neg = 0u - static_cast<uint32_t>(e >> 9);
        for (int a = 0; a < nact; ++a) {
          const float g = s_gain[a];
          const int32_t iv = __float2int_rz(__fmul_rn(tcf, g));
          const int32_t qv = __float2int_rz(__fmul_rn(tsf, g));
          const uint32_t u = static_cast<uint32_t>(iv + 1024) |
                             (static_cast<uint32_t>(qv + 1024) << 16);
          s_tab[a * kTab + e] = u + ((kBias2 - (u << 1)) & neg);
        }
      }
      __syncthreads();
      staged = row;
    }

    const uint32_t n0 = static_cast<uint32_t>(chunk) * kChunk + tid;
    uint32_t acc[kSamplesPerThread];
    float nf[kSamplesPerThread];
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      acc[j] = 0u;
      nf[j] = __uint2float_rn(n0 + j * kThreads);  // exact: n < 2^24
    }

    // K1: every active channel, one table lookup per sample
    const int nact = s_nact;
    const uint32_t* tab = s_tab;
#pragma unroll 1
    for (int a = 0; a < nact; ++a, tab += kTab) {
      const Chan ch = s_ch[a];
      const uint8_t* ca_row = reinterpret_cast<const uint8_t*>(s_ca[ch.ca]);
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        acc[j] += tab[sample_key(ch, ca_row, n0 + j * kThreads, nf[j])];
      }
    }

    // K2: gain-trunc patch words, +-1 where the LUT value equals the
    // patched magnitude (almost no row has one)
    const int npatch = s_npatch;
    for (int k = 0; k < npatch; ++k) {
      const Chan ch = s_patch[k];
      const uint8_t* ca_row = reinterpret_cast<const uint8_t*>(s_ca[ch.ca]);
      const uint32_t uw = ch.word;
      const int32_t mag = static_cast<int32_t>(uw >> 6);
      const uint32_t half = (uw >> 1) & 1u;
      const int32_t pa = (uw & 1u) == 0u ? mag : -mag;
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const uint32_t key =
            sample_key(ch, ca_row, n0 + j * kThreads, nf[j]);
        const uint32_t p = static_cast<uint32_t>(__ldg(pairtab + (key & 511u)));
        const int32_t tgt = half == 0u
                                ? static_cast<int32_t>(p & 0xFFFFu) - 512
                                : static_cast<int32_t>(p >> 16) - 512;
        const uint32_t pm = static_cast<uint32_t>(
            static_cast<int32_t>(tgt == pa) - static_cast<int32_t>(tgt == -pa));
        const uint32_t m = 0u - (key >> 9);
        acc[j] += (pm - ((pm << 1) & m)) << (half * 16u);
      }
    }

    // K3: remove the bias of the executed channels, emit
    const int32_t bias = nact * 1024;
    const size_t orow = static_cast<size_t>(row) * block_samples;
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      const uint32_t n = n0 + j * kThreads;
      if (n >= static_cast<uint32_t>(block_samples)) continue;
      const int32_t iv = static_cast<int32_t>(acc[j] & 0xFFFFu) - bias;
      const int32_t qv = static_cast<int32_t>(acc[j] >> 16) - bias;
      if (packed) {
        out0[orow + n] = static_cast<int32_t>(
            (static_cast<uint32_t>(iv) & 0xFFFFu) |
            (static_cast<uint32_t>(qv) << 16));
      } else {
        out0[orow + n] = iv;
        out1[orow + n] = qv;
      }
    }

    if (++chunk == n_chunks) {
      chunk = 0;
      ++row;
    }
  }
}

// a failed runtime call also leaves its code as the thread's last error;
// clear it so the next launch's cudaGetLastError reports only its own
int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

// The persistent grid's size on the current device: the kernel's blocks
// that fit on it at once.  The first launch on a device opts the kernel
// into its dynamic shared memory and asks the occupancy; the answer is
// kept per device, and a failed query is returned and asked again next
// time.
constexpr int kMaxDevices = 64;
std::atomic<int> g_resident[kMaxDevices];  // 0: not asked yet

cudaError_t resident_blocks(int* resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    *resident = g_resident[dev].load();
    if (*resident > 0) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(synth_blocks_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kTabBytes));
  if (err != cudaSuccess) return err;
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, synth_blocks_kernel, kThreads, kTabBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = per_sm * n_sm;
  if (dev < kMaxDevices) g_resident[dev].store(*resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns 0 once launched, else the cudaError_t (a
// refused shared-memory or occupancy request included).  The caller has
// checked shapes, types and contiguity; a block whose sf_map entry lies
// outside [0, n_sf) traps, failing the launch.
int synth_blocks_launch(const void* sf_map, const void* prmi,
                        const void* prmf, const void* ca_tabs,
                        const void* pairtab, void* out0, void* out1,
                        int n_blocks, int n_sf, int block_samples,
                        int packed, void* stream) {
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return fail(err);

  const long long n_chunks = (block_samples + kChunk - 1) / kChunk;
  const long long items = static_cast<long long>(n_blocks) * n_chunks;
  const unsigned grid =
      static_cast<unsigned>(items < resident ? items : resident);
  synth_blocks_kernel<<<grid, kThreads, kTabBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sf_map), static_cast<const int32_t*>(prmi),
      static_cast<const float*>(prmf), static_cast<const int32_t*>(ca_tabs),
      static_cast<const int32_t*>(pairtab), static_cast<int32_t*>(out0),
      static_cast<int32_t*>(out1), n_blocks, n_sf, block_samples, packed);
  return static_cast<int>(cudaGetLastError());
}

const char* synth_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
