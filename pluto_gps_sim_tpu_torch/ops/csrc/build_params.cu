// The synthesis kernel's [M, 256] parameter planes, built on the card from
// the raw per-(row, channel) fields of a batch of superframe plans.
//
// Replaces no TPU kernel.  The JAX package builds these planes on the host
// (pack_plan(tables=False) and build_group_params, in numpy), and so does
// the port's single-receiver stream.  It was added because the port's
// Monte-Carlo batch (parallel/montecarlo.py) is host-bound: B=256
// receivers x 300 blocks make 76,800 rows a batch, whose host build took
// longer than the synthesis kernel that reads them.
//
// The function is pluto_gps_sim_tpu_torch/ops/synth_cuda.py's
// build_group_params(nudge=True) over pack_plan(plan, tables=False), bit
// for bit; synth_cuda.build_params takes that host build as its plain
// version for CPU tensors.  Layout and meaning of every lane are in
// synth_cuda.py (_P_*, _F_*, _SLOT_I, _SLOT_F, the patch word encoding).
//
// What bounds it on this card: per row it reads 12 x 53 bytes of fields
// and writes 2 KB of planes; 76,800 rows read ~49 MB and write 157 MB,
// ~0.06 ms at 3.35 TB/s.  The gain-trunc check is 223 f64 and 223 f32
// products per active (row, channel), ~0.2 G of each a batch, tens of
// microseconds on the FP64 and FP32 pipes; the nudge and patch passes
// touch ~0.02 (row, channel) pairs a block.  So the bound is the bytes.
// The design:
//   - a block of 16 rows x 12 channels, one thread per (row, channel):
//     the digit extractions, the nav-bit window and the check of all 223
//     magnitudes (the nudge's eight more candidate lanes only where the
//     first one mismatches) go into the block's rows in shared memory;
//   - one thread per row then fills its patch slots, serially, in
//     (channel, magnitude, half) order; it rarely has anything to do;
//   - the block's 16 contiguous rows (32 KB) are stored coalesced.
//
// Arithmetic: every f64 and f32 operation rounds as numpy's does.  nvcc
// contracts a*b + c into an FMA by default, which rounds once where numpy
// rounds twice, so every product and sum is written with an _rn
// intrinsic; floor, trunc and rint (numpy's round half to even) are
// exact.  Build without --use_fast_math (nextafterf must see denormals).

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kC = 12;              // channel slots
constexpr int kLanes = 128;         // lanes per half plane
constexpr int kPlane = 2 * kLanes;  // parameter-plane row width
constexpr int kNPatch = 7;          // gain-trunc patch slots per row
constexpr int kSlotIW = 10;         // int lanes per patch slot
constexpr int kSlotFW = 6;          // float lanes per patch slot
constexpr int kSlotWord = 5;        // float slot lane holding the word
constexpr int kNudgeUlps = 4;       // candidate lanes g0, +1, -1 ... +-4 ulps
constexpr int kMaxMags = 256;
constexpr int kRows = 16;           // rows per block
constexpr int kThreads = kRows * kC;
// column bases of the planes (synth_cuda._P_* and _F_*), x12 channels
constexpr int kPPhase0 = 0, kPStep = 12, kPCp0q = 24, kPVq = 36, kPNbm = 48,
              kPIc0 = 60, kPRes0q24 = 72, kPR24 = 84, kPRes0q36 = 96,
              kPR36 = 108;
constexpr int kFSr12 = 0, kFSrem = 12, kFCq12 = 24, kFRrr = 36,
              kFGain = 48;
constexpr int kIntCols = 10;        // _SLOT_I: slot lane j copies column 12*j
constexpr int kFloatCols = 5;       // _SLOT_F: slot lane j copies column 12*j
constexpr double kTwo32 = 4294967296.0;

// mismatching magnitudes of lane g against the f64 truncs of g64:
// trunc(T * g64) in f64 against trunc(f32(T) * g) in f32
__device__ int mismatches(const double* mags, const float* magsf, int n_mags,
                          double g64, float g) {
  int n = 0;
  for (int j = 0; j < n_mags; ++j) {
    const double t64 = trunc(__dmul_rn(mags[j], g64));
    const float t32 = truncf(__fmul_rn(magsf[j], g));
    n += t64 != static_cast<double>(t32);
  }
  return n;
}

__global__ void __launch_bounds__(kThreads) build_params_kernel(
    const uint8_t* __restrict__ active, const double* __restrict__ real,
    const int32_t* __restrict__ ints, double delt,
    const int8_t* __restrict__ bits, const int32_t* __restrict__ bits_map,
    const double* __restrict__ mag_tab, const uint8_t* __restrict__ mag_half,
    int32_t* __restrict__ prmi, float* __restrict__ prmf,
    int32_t* __restrict__ dropped, int n_rows, int n_tabs, int n_bits,
    int n_mags) {
  __shared__ int32_t s_i[kRows][kPlane];
  __shared__ float s_f[kRows][kPlane];
  __shared__ double s_g64[kRows][kC];
  __shared__ int s_resid[kRows][kC];
  __shared__ double s_mag[kMaxMags];
  __shared__ float s_magf[kMaxMags];
  __shared__ uint8_t s_half[kMaxMags];

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_rows - row0);
  for (int k = t; k < kRows * kPlane; k += kThreads) {
    (&s_i[0][0])[k] = 0;
    (&s_f[0][0])[k] = 0.0f;
  }
  for (int j = t; j < n_mags; j += kThreads) {
    s_mag[j] = mag_tab[j];
    s_magf[j] = static_cast<float>(mag_tab[j]);  // exact: |T| <= 512
    s_half[j] = mag_half[j];
  }
  __syncthreads();

  const int r = t / kC;
  const int c = t - r * kC;
  if (r < rows) {
    const int row = row0 + r;
    const size_t e = static_cast<size_t>(row) * kC + c;
    const size_t plane = static_cast<size_t>(n_rows) * kC;
    // fields: real [5, M, C] = f_carr, f_code, carr_phase, code_phase,
    // gain; ints [3, M, C] = iword, ibit, icode; an inactive slot's read
    // as zero (pack_plan's np.where)
    const bool act = active[e] != 0;
    const double u = act ? __dmul_rn(real[e], delt) : 0.0;
    const double v = act ? __dmul_rn(real[plane + e], delt) : 0.0;
    const double c0 = act ? real[2 * plane + e] : 0.0;
    const double cp0 = act ? real[3 * plane + e] : 0.0;
    const double g64 = act ? real[4 * plane + e] : 0.0;
    // iword*30 + ibit wraps in int32 as numpy's does
    const int b0 = act ? static_cast<int>(
                             static_cast<uint32_t>(ints[e]) * 30u +
                             static_cast<uint32_t>(ints[plane + e]))
                       : 0;
    const int ic0 = act ? ints[2 * plane + e] : 0;

    // carrier: FLOOR anchor + its Q12 digit, rounded u32 step, two-level
    // step residual
    const double phase0_f = __dmul_rn(__dsub_rn(c0, floor(c0)), kTwo32);
    const double phase0 = floor(phase0_f);
    const float cq12 = __double2float_rn(
        floor(__dmul_rn(__dsub_rn(phase0_f, phase0), 4096.0)));
    const double step_exact = __dmul_rn(__dsub_rn(u, floor(u)), kTwo32);
    const double step = rint(step_exact);
    const double sres = __dmul_rn(__dsub_rn(step_exact, step), 4096.0);
    const double sr12 = floor(sres);
    // code: Q12 + Q24 + Q36 digits of the anchor and of the rate
    const double cp4 = __dmul_rn(cp0, 4096.0);
    const double cp0q = floor(cp4);
    const double f12s = __dmul_rn(__dsub_rn(cp4, cp0q), 4096.0);
    const double res0q24 = floor(f12s);
    const double res0q36 = floor(__dmul_rn(__dsub_rn(f12s, res0q24), 4096.0));
    const double v4 = __dmul_rn(v, 4096.0);
    const double vq = floor(v4);
    const double r4s = __dmul_rn(__dsub_rn(v4, vq), 4096.0);
    const double r24 = floor(r4s);
    const double r4b = __dsub_rn(r4s, r24);
    const double r36 = floor(__dmul_rn(r4b, 4096.0));
    const double rrr =
        __dmul_rn(__dsub_rn(r4b, __dmul_rn(r36, 1.0 / 4096.0)), 4096.0);

    // nav-bit window: bit q = nav bit b0 + q as 0/1, clipped to the
    // table's last bit (the host rejects b0 < 0; the clamp keeps the read
    // inside the table whatever it is given)
    const int tab = bits_map[row];
    if (tab < 0 || tab >= n_tabs) __trap();
    const int8_t* nav = bits + (static_cast<size_t>(tab) * kC + c) * n_bits;
    const int b0s = max(0, min(b0, n_bits - 1));
    uint32_t mask = 0;
    for (int q = 0; q < 32; ++q)
      mask |= static_cast<uint32_t>(nav[min(b0s + q, n_bits - 1)] < 0) << q;

    // gain lane: f32(g64), or the first of the nudged lanes g0, +1, -1,
    // ... +-4 ulps with the fewest mismatching magnitudes
    const float g0 = __double2float_rn(g64);
    float lane = g0;
    int resid = act ? mismatches(s_mag, s_magf, n_mags, g64, g0) : 0;
    float up = g0, dn = g0;
    for (int k = 1; k <= kNudgeUlps && resid > 0; ++k) {
      up = nextafterf(up, INFINITY);
      int n = mismatches(s_mag, s_magf, n_mags, g64, up);
      if (n < resid) {
        resid = n;
        lane = up;
      }
      if (resid == 0) break;
      dn = nextafterf(dn, -INFINITY);
      n = mismatches(s_mag, s_magf, n_mags, g64, dn);
      if (n < resid) {
        resid = n;
        lane = dn;
      }
    }

    int32_t* pi = s_i[r];
    float* pf = s_f[r];
    pi[kPPhase0 + c] = static_cast<int32_t>(
        static_cast<uint32_t>(static_cast<long long>(phase0)));
    pi[kPStep + c] = static_cast<int32_t>(
        static_cast<uint32_t>(static_cast<long long>(step)));
    pi[kPCp0q + c] = static_cast<int32_t>(cp0q);
    pi[kPVq + c] = static_cast<int32_t>(vq);
    pi[kPNbm + c] = static_cast<int32_t>(mask);
    pi[kPIc0 + c] = ic0;
    pi[kPRes0q24 + c] = static_cast<int32_t>(res0q24);
    pi[kPR24 + c] = static_cast<int32_t>(r24);
    pi[kPRes0q36 + c] = static_cast<int32_t>(res0q36);
    pi[kPR36 + c] = static_cast<int32_t>(r36);
    pf[kFSr12 + c] = __double2float_rn(sr12);
    pf[kFSrem + c] = __double2float_rn(__dsub_rn(sres, sr12));
    pf[kFCq12 + c] = cq12;
    pf[kFRrr + c] = __double2float_rn(rrr);
    pf[kFGain + c] = lane;
    s_g64[r][c] = g64;
    s_resid[r][c] = resid;
  }
  __syncthreads();

  // patch words of the mismatches no lane cleared, per row in (channel,
  // magnitude, half) order; words past the row's 7 slots are counted
  if (t < rows) {
    int32_t* pi = s_i[t];
    float* pf = s_f[t];
    int k = 0, lost = 0;
    for (int ch = 0; ch < kC; ++ch) {
      if (s_resid[t][ch] == 0) continue;
      const double g64 = s_g64[t][ch];
      const float lane = pf[kFGain + ch];
      for (int j = 0; j < n_mags; ++j) {
        const double t64 = trunc(__dmul_rn(s_mag[j], g64));
        const double t32 =
            static_cast<double>(truncf(__fmul_rn(s_magf[j], lane)));
        if (t64 == t32) continue;
        // the two truncs lie within a few ulps of one product, so they
        // differ by exactly one; the word carries only its sign
        const int neg = t64 < t32;
        for (int half = 0; half < 2; ++half) {
          if (!((s_half[j] >> half) & 1)) continue;
          if (k >= kNPatch) {
            ++lost;
            continue;
          }
          for (int jj = 0; jj < kIntCols; ++jj)
            pi[kLanes + kSlotIW * k + jj] = pi[kC * jj + ch];
          for (int jj = 0; jj < kFloatCols; ++jj)
            pf[kLanes + kSlotFW * k + jj] = pf[kC * jj + ch];
          pf[kLanes + kSlotFW * k + kSlotWord] = static_cast<float>(
              (static_cast<int>(s_mag[j]) << 6) | (ch << 2) | (half << 1) |
              neg);
          ++k;
        }
      }
    }
    if (lost) atomicAdd(dropped, lost);
  }
  __syncthreads();

  // the block's rows are contiguous in both planes
  const size_t base = static_cast<size_t>(row0) * kPlane;
  const int words = rows * kPlane;
  for (int k = t; k < words; k += kThreads) {
    prmi[base + k] = (&s_i[0][0])[k];
    prmf[base + k] = (&s_f[0][0])[k];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns 0 once launched, else the cudaError_t.  The
// caller has checked shapes, types, contiguity and the fields' ranges
// (synth_cuda.check_plan_fields); a row whose bits_map entry lies outside
// [0, n_tabs) traps, failing the launch.  `dropped` is added to, not set.
int build_params_launch(const void* active, const void* real,
                        const void* ints, double delt, const void* bits,
                        const void* bits_map, const void* mag_tab,
                        const void* mag_half, void* prmi, void* prmf,
                        void* dropped, int n_rows, int n_tabs, int n_bits,
                        int n_mags, void* stream) {
  if (n_mags > kMaxMags || n_bits < 1) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((n_rows + kRows - 1) / kRows);
  build_params_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(active), static_cast<const double*>(real),
      static_cast<const int32_t*>(ints), delt,
      static_cast<const int8_t*>(bits), static_cast<const int32_t*>(bits_map),
      static_cast<const double*>(mag_tab),
      static_cast<const uint8_t*>(mag_half), static_cast<int32_t*>(prmi),
      static_cast<float*>(prmf), static_cast<int32_t*>(dropped), n_rows,
      n_tabs, n_bits, n_mags);
  return static_cast<int>(cudaGetLastError());
}

const char* build_params_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
