// Composite 12-channel GPS L1 C/A IQ synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pluto_gps_sim_tpu/ops/synth_pallas.py::_kernel (with its epilogue
// _emit_epilogue).  It computes the same integer and f32 op sequence word
// for word; the arithmetic is specified in docs/KERNEL_MATH.md and in the
// docstring of pluto_gps_sim_tpu_torch/ops/synth_cuda.py, whose
// synth_blocks_plain is the plain PyTorch twin this kernel is held to.
//
// What bounds it on this card: per (channel, sample) it does roughly 100
// integer/f32 ALU operations (three NCO ramps, a reciprocal division, two
// table lookups, two gain products) against 4 output bytes per sample for
// all 12 channels, so it is compute-bound by a wide margin: 260,000
// samples x 300 blocks write 312 MB (~0.1 ms at 3.35 TB/s) but need ~1e11
// integer operations.  The design keeps every operand on chip: one CUDA
// block stages its row's parameter planes, the 12 bit-packed C/A rows of
// its superframe and the 512-entry sin/cos pair table in shared memory
// (~9 KB), each thread keeps kSamplesPerThread packed accumulators in
// registers, and the only device-memory traffic is that staging plus one
// coalesced 4-byte store per sample (8 bytes when packed == 0).
//
// Layout (see synth_cuda.py): grid (M blocks of signal, sample chunks);
// the param planes are [M, 256] int32 / f32 with the per-channel columns
// at 12*j + c and patch slot k's copies at 128 + 10*k (ints) and
// 128 + 6*k (floats, word at lane 5); ca_tabs is [NS, 12, 1, 128] int32;
// pairtab is the 512-entry biased table (cos+512) | (sin+512) << 16.
//
// Arithmetic notes: everything that wraps on the TPU (u32 phase, Q-level
// ramps) is uint32_t here, since signed overflow is undefined in C++;
// the carrier residual's >> 12 is arithmetic on purpose (it may be
// negative) and every other shift is logical; every f32 -> int is a
// truncation of a correctly rounded product (__fmul_rn, __float2int_rz),
// so nothing is contracted into an FMA.  Build without --use_fast_math.

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
constexpr int kSamplesPerThread = 4;
constexpr int kChunk = kThreads * kSamplesPerThread;
constexpr int kCaLen = 1023;
constexpr uint32_t kBias2 = 2048u | (2048u << 16);

static_assert(kThreads == kPlane, "one thread stages one plane lane");

// one channel's NCO parameters, read from the main columns (stride 12)
// or from a patch slot's copies (stride 1): both orders list the int
// fields PHASE0, STEP, CP0Q, VQ, NBM, IC0, RES0Q24, R24, RES0Q36, R36
// and the float fields SR12, SREM, CQ12, RRR
struct Chan {
  uint32_t phase0, step, cp0q, vq, nbm, ic0, res0q24, r24, res0q36, r36;
  int32_t sr12, cq12;
  float srem, rrr;
};

__device__ __forceinline__ Chan load_chan(const int32_t* ip, int is,
                                          const float* fp, int fs) {
  Chan ch;
  ch.phase0 = static_cast<uint32_t>(ip[0]);
  ch.step = static_cast<uint32_t>(ip[is]);
  ch.cp0q = static_cast<uint32_t>(ip[2 * is]);
  ch.vq = static_cast<uint32_t>(ip[3 * is]);
  ch.nbm = static_cast<uint32_t>(ip[4 * is]);
  ch.ic0 = static_cast<uint32_t>(ip[5 * is]);
  ch.res0q24 = static_cast<uint32_t>(ip[6 * is]);
  ch.r24 = static_cast<uint32_t>(ip[7 * is]);
  ch.res0q36 = static_cast<uint32_t>(ip[8 * is]);
  ch.r36 = static_cast<uint32_t>(ip[9 * is]);
  ch.sr12 = __float2int_rz(fp[0]);
  ch.srem = fp[fs];
  ch.cq12 = __float2int_rz(fp[2 * fs]);
  ch.rrr = fp[3 * fs];
  return ch;
}

// The per-sample chain of one channel (synth_pallas.py::_kernel's
// chan_vals): the signed LUT pair (tc, ts) and the spreading mask m
// (all ones where the sample negates).
__device__ __forceinline__ void chan_vals(const Chan& ch,
                                          const uint32_t* ca_row,
                                          const uint32_t* pairtab,
                                          uint32_t n, int32_t& tc,
                                          int32_t& ts, uint32_t& m) {
  const float nf = __uint2float_rn(n);  // exact: n < 2^24

  // carrier: floor u32 anchor + Q12-seeded residual, arithmetic >> 12
  const uint32_t rsum = static_cast<uint32_t>(ch.sr12) * n +
                        static_cast<uint32_t>(ch.cq12) +
                        static_cast<uint32_t>(
                            __float2int_rz(__fmul_rn(ch.srem, nf)));
  const int32_t resc = static_cast<int32_t>(rsum) >> 12;
  const uint32_t phase = ch.phase0 + ch.step * n + static_cast<uint32_t>(resc);
  const uint32_t itab = phase >> 23;  // 9 index bits

  // code: Q12 + Q24 + Q36 integer ramps + f32 fourth level
  const uint32_t rq36 = ch.res0q36 + ch.r36 * n +
                        static_cast<uint32_t>(
                            __float2int_rz(__fmul_rn(ch.rrr, nf)));
  const uint32_t rq24 = ch.res0q24 + ch.r24 * n + (rq36 >> 12);
  const uint32_t tq = ch.cp0q + ch.vq * n + (rq24 >> 12);
  const uint32_t chip = tq >> 12;
  // chip // 1023 by 1/1023 rounded up in f32 (exact for chip < 600k);
  // synth_cuda.py asserts these bits equal its _INV1023
  const float kInv1023 = __uint_as_float(0x3A802009u);
  const int32_t w =
      __float2int_rz(__fmul_rn(__uint2float_rn(chip), kInv1023));
  const int32_t cidx = static_cast<int32_t>(chip) - w * kCaLen;

  // nav bit from the per-block 32-bit mask; // 20 by magic multiply
  const uint32_t q = ((ch.ic0 + static_cast<uint32_t>(w)) * 3277u) >> 16;
  const uint32_t nbit = q < 32u ? (ch.nbm >> q) & 1u : 0u;

  // C/A chip from the bit-packed row (the & 127 only guards memory)
  const uint32_t ucidx = static_cast<uint32_t>(cidx);
  const uint32_t word = ca_row[(ucidx >> 5) & (kLanes - 1)];
  const uint32_t cbit = (word >> (ucidx & 31u)) & 1u;

  const uint32_t p = pairtab[itab];
  tc = static_cast<int32_t>(p & 0xFFFFu) - 512;
  ts = static_cast<int32_t>(p >> 16) - 512;
  m = 0u - (cbit ^ nbit);
}

__global__ void __launch_bounds__(kThreads)
synth_blocks_kernel(const int32_t* __restrict__ sf_map,
                    const int32_t* __restrict__ prmi,
                    const float* __restrict__ prmf,
                    const int32_t* __restrict__ ca_tabs,
                    const int32_t* __restrict__ pairtab,
                    int32_t* __restrict__ out0, int32_t* __restrict__ out1,
                    int n_sf, int block_samples, int packed) {
  __shared__ int32_t s_pi[kPlane];
  __shared__ float s_pf[kPlane];
  __shared__ uint32_t s_ca[kC + 1][kLanes];  // row kC stays zero
  __shared__ uint32_t s_pair[512];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t prow = static_cast<size_t>(row) * kPlane;
  s_pi[tid] = prmi[prow + tid];
  s_pf[tid] = prmf[prow + tid];
  const int sf = sf_map[row];
  // the host checks the map before staging it (check_sf_map); an entry
  // out of range aborts the launch rather than read another table
  if (sf < 0 || sf >= n_sf) __trap();
  const int32_t* ca = ca_tabs + static_cast<size_t>(sf) * kC * kLanes;
  for (int i = tid; i < kC * kLanes; i += kThreads) {
    s_ca[i / kLanes][i % kLanes] = static_cast<uint32_t>(ca[i]);
  }
  if (tid < kLanes) s_ca[kC][tid] = 0u;
  for (int i = tid; i < 512; i += kThreads) {
    s_pair[i] = static_cast<uint32_t>(pairtab[i]);
  }
  __syncthreads();

  const uint32_t n0 = blockIdx.y * kChunk + tid;
  uint32_t acc[kSamplesPerThread];
#pragma unroll
  for (int j = 0; j < kSamplesPerThread; ++j) acc[j] = 0u;

  // K1: every channel slot with nonzero gain
  int nact = 0;
  for (int c = 0; c < kC; ++c) {
    const float g = s_pf[kColF_Gain + c];
    if (g == 0.0f) continue;  // uniform across the block
    ++nact;
    const Chan ch = load_chan(s_pi + c, kC, s_pf + c, kC);
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      int32_t tc, ts;
      uint32_t m;
      chan_vals(ch, s_ca[c], s_pair, n0 + j * kThreads, tc, ts, m);
      const int32_t iv = __float2int_rz(__fmul_rn(__int2float_rn(tc), g));
      const int32_t qv = __float2int_rz(__fmul_rn(__int2float_rn(ts), g));
      const uint32_t u = static_cast<uint32_t>(iv + 1024) |
                         (static_cast<uint32_t>(qv + 1024) << 16);
      acc[j] += u + ((kBias2 - (u << 1)) & m);
    }
  }

  // K2: gain-trunc patch words; an empty slot (word 0) self-cancels in
  // the TPU kernel, so it is skipped here
  for (int k = 0; k < kNPatch; ++k) {
    const int32_t wk =
        __float2int_rz(s_pf[kLanes + kSlotFW * k + kSlotWord]);
    if (wk == 0) continue;  // uniform across the block
    const uint32_t uw = static_cast<uint32_t>(wk);
    const uint32_t c = (uw >> 2) & 15u;
    const int32_t mag = static_cast<int32_t>(uw >> 6);
    const uint32_t half = (uw >> 1) & 1u;
    const int32_t a = (uw & 1u) == 0u ? mag : -mag;
    const int32_t b = -a;
    const Chan ch = load_chan(s_pi + kLanes + kSlotIW * k, 1,
                              s_pf + kLanes + kSlotFW * k, 1);
    const uint32_t* ca_row = s_ca[c < static_cast<uint32_t>(kC) ? c : kC];
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      int32_t tc, ts;
      uint32_t m;
      chan_vals(ch, ca_row, s_pair, n0 + j * kThreads, tc, ts, m);
      const int32_t tgt = half == 0u ? tc : ts;
      const uint32_t p = static_cast<uint32_t>(
          static_cast<int32_t>(tgt == a) - static_cast<int32_t>(tgt == b));
      const uint32_t term = p - ((p << 1) & m);
      acc[j] += term << (half * 16u);
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
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller has checked shapes, types and contiguity; a block whose
// sf_map entry lies outside [0, n_sf) traps, failing the launch.
int synth_blocks_launch(const void* sf_map, const void* prmi,
                        const void* prmf, const void* ca_tabs,
                        const void* pairtab, void* out0, void* out1,
                        int n_blocks, int n_sf, int block_samples,
                        int packed, void* stream) {
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((block_samples + kChunk - 1) / kChunk));
  synth_blocks_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sf_map), static_cast<const int32_t*>(prmi),
      static_cast<const float*>(prmf), static_cast<const int32_t*>(ca_tabs),
      static_cast<const int32_t*>(pairtab), static_cast<int32_t*>(out0),
      static_cast<int32_t*>(out1), n_sf, block_samples, packed);
  return static_cast<int>(cudaGetLastError());
}

const char* synth_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
