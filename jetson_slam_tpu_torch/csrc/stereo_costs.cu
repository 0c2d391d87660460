// Stereo window correlation: 11 centre-subtracted L1 costs per left slot.
//
// Replaces jetson_slam_tpu/ops/pallas_stereo.py::stereo_costs_pallas
// (kernel body _kernel).  The TPU kernel selects tile-anchored bands with
// one-hot matmuls because gathers are slow there; here each slot reads its
// 11x11 left patch centred at (yy, xl) and its 11x21 right strip centred at
// (yy, xr) straight from the two pyramid canvases at the left slot's
// octave.  cost[o] = sum |(L - Lc) - (R_o - Rc_o)|, exact; 0 when unmatched.
//
// Bound: launch latency plus the L2 round trips of one warp, not bytes.  A
// frame reads ~0.9 MB of windows and writes 0.16 MB of costs, a quarter of
// a microsecond at 3.35 TB/s, and the whole grid is one resident wave, so
// its time is the launch plus the chain of dependent loads of its slowest
// warp.  The design cuts that chain to two round trips:
//   - two slots per warp, 16 lanes each, lane u owning patch row u (lanes
//     11..15 pad); blocks of 4 warps, so the wave spreads over every SM;
//   - one round trip for the per-slot inputs: matched, lvl, yy, xl and xr
//     are loaded at entry, all at once, and only then branched on; a warp
//     whose two slots are unmatched writes zeros and retires;
//   - one round trip for the windows: a row lane issues the 4 + 6 aligned
//     32-bit words that cover its 11 left and 21 right bytes before using
//     any, and realigns them with __funnelshift_r.  Rows are clamped to
//     the canvas as the plain version clamps them.  A window that reaches
//     past column 0 or W0 - 1 reads its bytes one by one at clamped
//     columns instead (never on the main path: the stereo bounds check
//     keeps the strip inside its level);
//   - no memory for the centre values: lane 5 holds the centre row, and
//     Lc and the 11 Rc_o come from it by shuffles;
//   - arithmetic in f32 on the FMA pipe, which issues twice the integer
//     pipe's rate.  Pixels are 2^23 + b (one byte permute each), so every
//     difference, and every sum up to 61710, is an exact integer;
//   - a transposing xor-shuffle reduction: 15 shuffles leave cost o of the
//     slot in lane o, and the slot's 44 bytes go out as one store.  Each
//     step is a template, so it unrolls fully: left as a loop, the first
//     step indexed its registers through predicated moves and branches,
//     and the kernel ran markedly slower on the card.
// Past the two round trips the time is instruction issue: the 121 x 3 f32
// operations of a row lane, then the index, unpack and reduction work.
// Integer arithmetic (half-rate pipe), blocks of 1 or 2 warps and 32-bit
// index math were no faster on the card.  Compacting matched slots per
// block was not tried: at the EuRoC slice most warps already hold one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PH = 5;                 // patch half width
constexpr int PN = 2 * PH + 1;        // 11 patch rows and columns
constexpr int NB = 11;                // disparity offsets
constexpr int NBH = 5;
constexpr int RN = PN + NB - 1;       // 21 strip columns
constexpr int WARPS = 4;
constexpr int SLOTS = 2 * WARPS;      // slots per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Byte k of w as the exact f32 2^23 + byte (0x4B000000 | byte).
__device__ __forceinline__ float biased(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4Bu, k | 0x4550));
}

// One step of the transposing reduction over a slot's 16 lanes: keep the
// half of sums 0 .. 2H - 1 whose index bit H matches the lane's (`up`), add
// the partner lane's copy of it, give the other half away.  Sum i of the
// kept half lands in acc[i].
template <int H>
__device__ __forceinline__ void fold(float (&acc)[16], bool up) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float give = up ? acc[i] : acc[i + H];
    const float keep = up ? acc[i + H] : acc[i];
    acc[i] = keep + __shfl_xor_sync(FULL, give, H);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
stereo_costs_kernel(const uint8_t* __restrict__ pyr_l, const uint8_t* __restrict__ pyr_r,
                    const int32_t* __restrict__ lvl, const int32_t* __restrict__ yy,
                    const int32_t* __restrict__ xl, const int32_t* __restrict__ xr,
                    const uint8_t* __restrict__ matched, int K, int L, int H0, int W0,
                    int32_t* __restrict__ costs) {
  const int u = threadIdx.x & 15;                          // patch row of the lane
  const int k = blockIdx.x * SLOTS + (threadIdx.x >> 4);   // slot of frame b
  const int b = blockIdx.y;
  const bool in = k < K;
  const size_t s = (size_t)b * K + k;
  int m = 0, lv = 0, y = 0, xL = 0, xR = 0;
  if (in) {
    m = matched[s];
    lv = lvl[s];
    y = yy[s];
    xL = xl[s];
    xR = xr[s];
  }
  if (!__any_sync(FULL, m != 0)) {
    if (in && u < NB) costs[s * NB + u] = 0;
    return;
  }
  const bool live = m != 0 && u < PN;

  // window bytes 4 i .. 4 i + 3 of the lane's left row (11 used) and right
  // row (21 used); lanes that are not live keep zeros
  uint32_t lw[3] = {0u, 0u, 0u}, rw[6] = {0u, 0u, 0u, 0u, 0u, 0u};
  const size_t plane = (size_t)H0 * W0;
  const size_t row = ((size_t)b * L + clampi(lv, 0, L - 1)) * plane +
                     (size_t)clampi(y - PH + u, 0, H0 - 1) * W0;
  const uint8_t* lrow = pyr_l + row;
  const uint8_t* rrow = pyr_r + row;
  const int l0 = xL - PH, r0 = xR - PH - NBH;   // first window columns
  if (live && l0 >= 0 && xL + PH < W0 && r0 >= 0 && xR + PH + NBH < W0) {
    const uintptr_t al = (uintptr_t)(lrow + l0), ar = (uintptr_t)(rrow + r0);
    const int sl = (int)(al & 3), sr = (int)(ar & 3);
    const uint32_t* pl = reinterpret_cast<const uint32_t*>(al - sl);
    const uint32_t* pr = reinterpret_cast<const uint32_t*>(ar - sr);
    // every word holds a window byte: left byte 10 lies in word 3 only from
    // offset 2 on, right byte 20 always lies in word 5
    uint32_t wl[4], wr[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) wl[i] = __ldg(pl + i);
    wl[3] = sl >= 2 ? __ldg(pl + 3) : 0u;
#pragma unroll
    for (int i = 0; i < 6; ++i) wr[i] = __ldg(pr + i);
#pragma unroll
    for (int i = 0; i < 3; ++i) lw[i] = __funnelshift_r(wl[i], wl[i + 1], 8 * sl);
#pragma unroll
    for (int i = 0; i < 5; ++i) rw[i] = __funnelshift_r(wr[i], wr[i + 1], 8 * sr);
    rw[5] = wr[5] >> (8 * sr);
  } else if (live) {
    // past the canvas's left or right edge: the plain version's clamped columns
#pragma unroll
    for (int j = 0; j < PN; ++j)
      lw[j >> 2] |= (uint32_t)__ldg(lrow + clampi(l0 + j, 0, W0 - 1)) << (8 * (j & 3));
#pragma unroll
    for (int j = 0; j < RN; ++j)
      rw[j >> 2] |= (uint32_t)__ldg(rrow + clampi(r0 + j, 0, W0 - 1)) << (8 * (j & 3));
  }

  // centre values from lane 5 of the slot: Lc is left byte 5, Rc_o right
  // byte 5 + o (bytes 5..15: words 1..3)
  const float lc = biased(__shfl_sync(FULL, lw[1], PH, 16), 1);
  const uint32_t cw[3] = {__shfl_sync(FULL, rw[1], PH, 16), __shfl_sync(FULL, rw[2], PH, 16),
                          __shfl_sync(FULL, rw[3], PH, 16)};
  float d[NB];   // Rc_o - Lc
#pragma unroll
  for (int o = 0; o < NB; ++o) d[o] = biased(cw[((PH + o) >> 2) - 1], (PH + o) & 3) - lc;
  float lp[PN], rp[RN];
#pragma unroll
  for (int j = 0; j < PN; ++j) lp[j] = biased(lw[j >> 2], j & 3);
#pragma unroll
  for (int j = 0; j < RN; ++j) rp[j] = biased(rw[j >> 2], j & 3);

  // |(L - Lc) - (R - Rc_o)| = |(L - R) + (Rc_o - Lc)|
  float acc[16];
#pragma unroll
  for (int o = 0; o < NB; ++o) {
    float a = 0.f;
#pragma unroll
    for (int v = 0; v < PN; ++v) a += fabsf((lp[v] - rp[o + v]) + d[o]);
    acc[o] = live ? a : 0.f;
  }
#pragma unroll
  for (int o = NB; o < 16; ++o) acc[o] = 0.f;

  // after the four steps lane u holds sum u over the slot's 16 lanes
  fold<8>(acc, u & 8);
  fold<4>(acc, u & 4);
  fold<2>(acc, u & 2);
  fold<1>(acc, u & 1);
  if (in && u < NB) costs[s * NB + u] = (int32_t)acc[0];
}

}  // namespace

// pyr_l, pyr_r (B, L, H0, W0) u8; lvl, yy, xl, xr (B, K) int32; matched
// (B, K) u8 (bool).  Output costs (B, K, 11) int32.
extern "C" int stereo_costs_launch(const void* pyr_l, const void* pyr_r, const void* lvl,
                                   const void* yy, const void* xl, const void* xr,
                                   const void* matched, int B, int K, int L, int H0, int W0,
                                   void* costs, void* stream) {
  const dim3 grid((K + SLOTS - 1) / SLOTS, B);
  stereo_costs_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pyr_l, (const uint8_t*)pyr_r, (const int32_t*)lvl, (const int32_t*)yy,
      (const int32_t*)xl, (const int32_t*)xr, (const uint8_t*)matched, K, L, H0, W0,
      (int32_t*)costs);
  return (int)cudaGetLastError();
}
