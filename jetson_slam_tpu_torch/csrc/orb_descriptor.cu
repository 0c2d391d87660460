// Gaussian blur + intensity-centroid angle + rBRIEF per keypoint slot.
//
// Replaces jetson_slam_tpu/ops/pallas_descriptor.py::orb_descriptors_pallas
// (kernel body _descriptor_kernel).  The TPU kernel reads tile-anchored
// bands because gathers are slow there; here each slot reads the 45x45 u8
// window around its keypoint straight from the zero-padded pyramid canvas.
//
// Bound: operations.  A frame reads a few MB of pyramid and writes 0.26 MB,
// under 2 us at 3.35 TB/s, while the blur, moments and rBRIEF of ~4.8 k
// valid slots take ~46 k 32-bit ops each.  The blur keeps every product and
// sum rounded on its own (no fused multiply-add), so it issues one
// instruction per op.  The design spends instructions only where the
// result needs them and keeps as many slots in flight as shared memory
// allows:
//   - one warp per slot, as a block of its own, with no barrier but
//     __syncwarp on a slot's path; a warp whose slot is invalid (score
//     <= 0) writes zeros and retires at once, and frees its shared memory
//     with it;
//   - each window row is read as the aligned 16-byte chunks that cover it,
//     realigned by a shuffle and a funnel shift, and kept as u8 in the
//     warp's shared memory (zeros outside the canvas);
//   - the integer moments m10, m01 reduce by warp shuffles; atan2f, cosf
//     and sinf run in every lane, the functions the plain version's card
//     path uses, so the angle equals it exactly;
//   - the x-blur fills a 45x39 f32 buffer, each lane a half row with a
//     sliding register window over its bytes; with the window a warp
//     needs 9360 B of shared memory, so 24 warps fit on an SM;
//   - the y-blur runs only at the 512 points rBRIEF samples: each lane takes
//     8 pairs and runs the same 7 taps in the same order at each point,
//     floors, and keeps the raw value within 3 px of the level border, so
//     the result equals the full blur gathered at that point bit for bit;
//   - __ballot_sync packs each lane's pair results, 8 words per slot, which
//     lanes 0..7 store as one 32-byte row.
// The pattern and the IC weights (12 KB together) are read from device
// memory, where every warp on an SM finds them in L1.  Staged in shared
// memory once per block they cost a block-wide barrier and 12 KB a block,
// and the kernel ran slower on the card at every block size tried; without
// them, blocks of 2, 4 or 10 warps ran slower than blocks of one.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int R = 22;            // window half size: rBRIEF reach 19 + blur 3
constexpr int WIN = 2 * R + 1;   // 45
constexpr int WS = 52;           // window row stride in bytes (13 words)
constexpr int WWORDS = 12;       // words kept per window row (48 bytes)
constexpr int WIT = (WIN + 7) / 8;  // window load iterations, 8 rows each (6)
constexpr int BH = 19;           // blurred half size (rBRIEF reach)
constexpr int BWN = 2 * BH + 1;  // 39
constexpr int IC = 15;           // intensity-centroid half patch
constexpr int ICN = 2 * IC + 1;  // 31
constexpr int HALF = 20;         // x-blur outputs per lane task (half a row)
constexpr int TMP_FLOATS = WIN * BWN;  // 1755 (7020 B)

// Byte k of w as an exact f32 (0x4B000000 | b is 2^23 + b).
__device__ __forceinline__ float byte_f(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4Bu, k | 0x4550)), 8388608.f);
}

__global__ void __launch_bounds__(32)
orb_descriptor_kernel(const uint8_t* __restrict__ pyr, const int32_t* __restrict__ kx,
                      const int32_t* __restrict__ ky, const int32_t* __restrict__ ks,
                      const int32_t* __restrict__ slot_level,
                      const int32_t* __restrict__ level_hw,
                      const float* __restrict__ pattern, const float* __restrict__ gauss,
                      const int32_t* __restrict__ ic_masks, int L, int H0, int W0, int K,
                      uint8_t* __restrict__ desc, float* __restrict__ angle_deg) {
  __shared__ __align__(16) uint8_t win[WIN * WS];
  __shared__ float tmp[TMP_FLOATS];
  const int lane = threadIdx.x, k = blockIdx.x, b = blockIdx.y;
  const size_t slot = (size_t)b * K + k;
  const int score = ks[slot], x = kx[slot], y = ky[slot], lvl = slot_level[k];
  if (score <= 0) {
    if (lane < 8) reinterpret_cast<uint32_t*>(desc + slot * 32)[lane] = 0u;
    if (lane == 0) angle_deg[slot] = 0.f;
    return;
  }
  const uint8_t* canvas = pyr + ((size_t)b * L + lvl) * (size_t)H0 * W0;

  // window: each row is read as the four aligned 16-byte chunks that cover
  // it, 4 lanes a row and 8 rows an iteration, all loads issued first
  const int c4 = lane & 3, cs = x - R;
  uint4 chunk[WIT];
  int shift[WIT];
#pragma unroll
  for (int it = 0; it < WIT; ++it) {
    const int r = 8 * it + (lane >> 2), gy = y - R + r;
    const uintptr_t a = (uintptr_t)(canvas + (size_t)max(gy, 0) * W0) + (uintptr_t)(intptr_t)cs;
    shift[it] = (int)(a & 15);
    const int col = cs - shift[it] + 16 * c4;   // first column of this chunk
    chunk[it] = make_uint4(0u, 0u, 0u, 0u);
    if (r < WIN && gy >= 0 && gy < H0 && col + 15 >= 0 && col < W0)
      chunk[it] = __ldg(reinterpret_cast<const uint4*>(a - shift[it]) + c4);
  }
  const int hl = level_hw[2 * lvl], wl = level_hw[2 * lvl + 1];
  float g[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) g[j] = __ldg(gauss + j);
  // window word i of a row is bytes 4 i .. 4 i + 3 after the row's shift:
  // aligned words q + i and q + i + 1, funnel-shifted
#pragma unroll
  for (int it = 0; it < WIT; ++it) {
    const int r = 8 * it + (lane >> 2);
    const uint32_t w[5] = {chunk[it].x, chunk[it].y, chunk[it].z, chunk[it].w,
                           __shfl_down_sync(0xffffffffu, chunk[it].x, 1)};
    const int q = shift[it] >> 2, sb = 8 * (shift[it] & 3);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = 4 * c4 + m - q;
      if (r < WIN && i >= 0 && i < WWORDS)
        reinterpret_cast<uint32_t*>(win + r * WS)[i] = __funnelshift_r(w[m], w[m + 1], sb);
    }
  }
  // a window that reaches past the canvas's left or right edge: zero the
  // bytes outside it (the aligned chunks hold the neighbouring rows there)
  if (cs < 0 || cs + 4 * WWORDS > W0) {
    __syncwarp();
    const int i = lane & 15, col = cs + 4 * i;
    if (i < WWORDS && (col < 0 || col + 4 > W0)) {
      uint32_t keep = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e >= 0 && col + e < W0) keep |= 0xffu << (8 * e);
      for (int r = lane >> 4; r < WIN; r += 2) reinterpret_cast<uint32_t*>(win + r * WS)[i] &= keep;
    }
  }
  __syncwarp();

  // integer moments over the 31x31 disc: lane v takes column v
  int m10 = 0, m01 = 0;
  if (lane < ICN) {
    const uint8_t* p = win + (R - IC) * WS + (R - IC) + lane;
    const int32_t* wu = ic_masks + lane;
#pragma unroll 8
    for (int u = 0; u < ICN; ++u, p += WS, wu += ICN) {
      const int v = *p;
      m10 += __ldg(wu) * v;
      m01 += __ldg(wu + ICN * ICN) * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }

  // x-blur: task t = 2 r + h is window row r, blurred columns 20 h .. 20 h + 19
  // (window columns 20 h .. 20 h + 25); blurred column c <-> window column c + 3
  for (int t = lane; t < 2 * WIN; t += 32) {
    const int r = t >> 1, c0 = (t & 1) * HALF;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(win + r * WS + c0);
    float px[28];
#pragma unroll
    for (int w = 0; w < 7; ++w) {
      const uint32_t word = src[w];
#pragma unroll
      for (int q = 0; q < 4; ++q) px[4 * w + q] = byte_f(word, q);
    }
    float* dst = tmp + r * BWN + c0;
    const int n = c0 == 0 ? HALF : BWN - HALF;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      float acc = __fmul_rn(px[c], g[0]);
#pragma unroll
      for (int j = 1; j < 7; ++j) acc = __fadd_rn(acc, __fmul_rn(px[c + j], g[j]));
      if (c < n) dst[c] = acc;
    }
  }
  const float ang = atan2f((float)m01, (float)m10);
  const float ca = cosf(ang), sa = sinf(ang);
  __syncwarp();

  // y-blur at the sampled points only; lane takes pairs 32 j + lane
  uint32_t mine = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* pp = pattern + 4 * (32 * j + lane);
    float val[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float px = __ldg(pp + 2 * e), py = __ldg(pp + 2 * e + 1);
      const int rr = (int)rintf(__fadd_rn(__fmul_rn(px, sa), __fmul_rn(py, ca)));
      const int cc = (int)rintf(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sa)));
      const int iy = y + rr, ix = x + cc;
      if (iy >= 3 && iy < hl - 3 && ix >= 3 && ix < wl - 3) {
        const float* col = tmp + (BH + rr) * BWN + (BH + cc);
        float acc = __fmul_rn(col[0], g[0]);
#pragma unroll
        for (int q = 1; q < 7; ++q) acc = __fadd_rn(acc, __fmul_rn(col[q * BWN], g[q]));
        val[e] = floorf(acc);
      } else {
        val[e] = (float)win[(R + rr) * WS + (R + cc)];
      }
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, val[0] < val[1]);
    if (lane == j) mine = bits;
  }
  if (lane < 8) reinterpret_cast<uint32_t*>(desc + slot * 32)[lane] = mine;
  if (lane == 0) angle_deg[slot] = __fmul_rn(ang, 57.295779513082320876798f);
}

}  // namespace

// pyr (B, L, H0, W0) u8; kx, ky, ks (B, K) int32; slot_level (K,) int32;
// level_hw (L, 2) int32; pattern (512, 2) f32; gauss (7,) f32; ic_masks
// (2, 31, 31) int32.  Outputs desc (B, K, 32) u8, angle_deg (B, K) f32.
extern "C" int orb_descriptor_launch(const void* pyr, const void* kx, const void* ky,
                                     const void* ks, const void* slot_level,
                                     const void* level_hw, const void* pattern,
                                     const void* gauss, const void* ic_masks, int B,
                                     int L, int H0, int W0, int K, void* desc,
                                     void* angle_deg, void* stream) {
  const dim3 grid(K, B);
  orb_descriptor_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pyr, (const int32_t*)kx, (const int32_t*)ky, (const int32_t*)ks,
      (const int32_t*)slot_level, (const int32_t*)level_hw, (const float*)pattern,
      (const float*)gauss, (const int32_t*)ic_masks, L, H0, W0, K,
      (uint8_t*)desc, (float*)angle_deg);
  return (int)cudaGetLastError();
}
