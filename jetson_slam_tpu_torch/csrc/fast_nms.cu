// FAST-16 score + 3x3 NMS-L over a batch of zero-padded pyramid canvases.
//
// Replaces jetson_slam_tpu/ops/pallas_frontend.py::fast_score_nms_pallas
// (kernel body _fast_nms_kernel).  One block of 256 threads per (canvas,
// 32x32 output tile); thread (r, q) owns the four adjacent outputs of tile
// row r, columns 4q .. 4q + 3.
//
// Bound: bytes.  Each canvas pixel is read once (u8) and written twice
// (raw + nms, int32), so the two int32 maps, 46 MB at the EuRoC slice, set
// the bound.  What the design does about everything else:
//   - zero-only tiles: a tile whose own pixels all lie outside its canvas's
//     ROI has raw = 0 by the ROI rule and nms = (0 >= max ? 0 : 0) = 0,
//     whatever its ring holds, so it writes zeros and returns without
//     loading anything.  At the slice about two thirds of the tiles take
//     this path (the small levels fill little of their canvases);
//   - the segment-test table fast_lut(n_min, n_max) comes as a bitset of
//     65536 bits (2048 words, packed once by the wrapper) that each block
//     stages in shared memory: a lookup is one shared load, where the u8
//     table in device memory cost a scattered global read per pixel;
//   - the tile plus a 4-px halo (3 for the FAST ring, 1 for NMS-L) and, when
//     given, the mask of the score region are staged with 4-byte reads, two
//     words a thread; the pixels go to shared memory as exact f32;
//   - the segment test runs in f32 on the FMA pipe, prune first (see
//     fast_score);
//   - the raw score of the tile plus a 1-px ring goes to shared memory
//     (the ring by threads 0..131), NMS-L reads its neighbourhood there and
//     keeps the thread's own row in registers, and each thread writes its
//     four raw and four nms values as one 16-byte store each (4-byte stores
//     when the width is not a multiple of 4).
// Larger tiles (32x64), staging in more passes and fp16 pairs all ran
// slower on the card.
// The table is the reference's, so any (n_min, n_max) is bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int SW = TILE + 2 * HALO;  // staged window side (40)
constexpr int SWW = SW / 4;          // words per staged row (10)
constexpr int PS = SW + 1;           // pixel row stride in floats
constexpr int SC = TILE + 2;         // score region side (34)
constexpr int SCS = SC + 1;
constexpr int LUT_WORDS = 2048;      // 65536 bits
constexpr int THREADS = 256;         // 32 rows x 8 groups of 4 columns
static_assert(THREADS == 25 * SWW + 6, "staging walks tid and tid + THREADS");

// Bytes of columns c..c+3 of a u8 row of w columns at `row` (byte k of the
// result is column c + k), 0 outside [0, w).  Reads only the aligned words
// that hold a column of the row and funnel-shifts them into place, so any
// row address and any c work.
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, int c, int w) {
  const uintptr_t a = (uintptr_t)row + (uintptr_t)(intptr_t)c;
  const int s = (int)(a & 3);
  const int c0 = c - s;
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a - s);
  const uint32_t lo = (c0 + 3 >= 0 && c0 < w) ? __ldg(q) : 0u;
  const uint32_t hi = (s != 0 && c0 + 7 >= 0 && c0 + 4 < w) ? __ldg(q + 1) : 0u;
  uint32_t v = __funnelshift_r(lo, hi, 8 * s);
  if (c < 0 || c + 4 > w) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < 0 || c + k >= w) v &= ~(0xffu << (8 * k));
  }
  return v;
}

// FAST-16 ring (dy, dx), the order of tables.FAST_RING
__host__ __device__ constexpr int ring_dy(int k) {
  const int t[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  return t[k];
}
__host__ __device__ constexpr int ring_dx(int k) { return ring_dy((k + 12) & 15); }

// raw FAST score of the pixel at p (staged window of exact f32 pixel
// values, row stride PS).  The opposite-pair prune needs only the four
// compass pixels (ring 0, 4, 8, 12 within [v - t, v + t]), so it runs
// first and a pruned pixel skips the rest.  Every value is a small
// integer, so f32 is exact: the SAD is a sum of |ring - v|, and bit k of
// the bright (dark) mask is saturate(ring - (v + t)) (saturate((v - t) -
// ring)) times 2^k.  That keeps the 16-step loop on the FMA pipe, which
// issues twice as many 32-bit ops per clock as the integer pipe.
__device__ __forceinline__ int fast_score(const float* p, float threshold,
                                          const uint32_t* bits) {
  const float v = p[0];
  const float vt = v + threshold, v_t = v - threshold;
  // the compass pixels decide the opposite-pair prune on their own
  const float q0 = p[ring_dy(0) * PS + ring_dx(0)], q4 = p[ring_dy(4) * PS + ring_dx(4)];
  const float q8 = p[ring_dy(8) * PS + ring_dx(8)], q12 = p[ring_dy(12) * PS + ring_dx(12)];
  const bool i0 = q0 <= vt && q0 >= v_t, i4 = q4 <= vt && q4 >= v_t;
  const bool i8 = q8 <= vt && q8 >= v_t, i12 = q12 <= vt && q12 >= v_t;
  if ((i4 && i12) || (i0 && i8)) return 0;
  float bright = 0.f, dark = 0.f, sad = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float rv = p[ring_dy(k) * PS + ring_dx(k)];
    sad += fabsf(rv - v);
    bright = fmaf(__saturatef(rv - vt), (float)(1 << k), bright);
    dark = fmaf(__saturatef(v_t - rv), (float)(1 << k), dark);
  }
  // 2^23 + n holds n in its low mantissa bits
  const unsigned b = __float_as_uint(bright + 8388608.f) & 0xffffu;
  const unsigned d = __float_as_uint(dark + 8388608.f) & 0xffffu;
  const unsigned corner = (bits[b >> 5] >> (b & 31)) | (bits[d >> 5] >> (d & 31));
  return (corner & 1u) ? (int)(__float_as_uint(sad + 8388608.f) & 0xffffu) : 0;
}

// Byte k of w as an exact f32 (0x4B000000 | b is 2^23 + b).
__device__ __forceinline__ float byte_f(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4Bu, k | 0x4550)) - 8388608.f;
}

__device__ __forceinline__ void store4(int32_t* raw, int32_t* nms, size_t o, int gx, int W,
                                       bool vec, const int (&r)[4], const int (&m)[4]) {
  if (vec && gx + 3 < W) {
    *reinterpret_cast<int4*>(raw + o) = make_int4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<int4*>(nms + o) = make_int4(m[0], m[1], m[2], m[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (gx + j < W) {
      raw[o + j] = r[j];
      nms[o + j] = m[j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
fast_nms_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ mask, int n_mask,
                const int32_t* __restrict__ roi, int n_roi,
                const uint32_t* __restrict__ lut_bits, int H, int W, int threshold,
                int32_t* __restrict__ raw, int32_t* __restrict__ nms) {
  __shared__ __align__(16) uint32_t bits[LUT_WORDS];
  __shared__ float pix[SW][PS];
  __shared__ uint32_t mw[SC][SWW];   // mask of rows y0-1.., columns x0-4..
  __shared__ int score[SC][SCS];

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid >> 3, tx = (tid & 7) * 4;
  const int gy = y0 + ty, gx = x0 + tx;
  const size_t plane = (size_t)H * W;
  const size_t o = (size_t)n * plane + (size_t)gy * W + gx;
  const bool vec = (W & 3) == 0;
  const int32_t* rr = roi + 4 * (n % n_roi);
  const int ylo = rr[0], yhi = rr[1], xlo = rr[2], xhi = rr[3];

  if (y0 >= yhi || y0 + TILE <= ylo || x0 >= xhi || x0 + TILE <= xlo) {
    const int z[4] = {0, 0, 0, 0};
    if (gy < H && gx < W) store4(raw, nms, o, gx, W, vec, z, z);
    return;
  }

  const uint8_t* im = img + (size_t)n * plane;
  const float thr = (float)threshold;
  const uint8_t* mk = mask == nullptr ? nullptr : mask + (size_t)(n % n_mask) * plane;
  for (int i = tid; i < LUT_WORDS / 4; i += THREADS)
    reinterpret_cast<uint4*>(bits)[i] = __ldg(reinterpret_cast<const uint4*>(lut_bits) + i);
  {
    // 400 staged words, tasks tid and tid + 256 (row r, word i): the second
    // is 25 rows and 6 words on from the first
    int r[2], i[2];
    r[0] = tid / SWW;
    i[0] = tid - r[0] * SWW;
    r[1] = r[0] + 25 + (i[0] >= 4);
    i[1] = i[0] >= 4 ? i[0] - 4 : i[0] + 6;
    uint32_t pw[2], mkw[2];
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int sy = y0 - HALO + r[it], sx = x0 - HALO + 4 * i[it];
      const bool in = r[it] < SW && sy >= 0 && sy < H;
      pw[it] = in ? row_word(im + (size_t)sy * W, sx, W) : 0u;
      mkw[it] = in && mk != nullptr ? row_word(mk + (size_t)sy * W, sx, W) : 0u;
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      if (r[it] < SW) {
        float* d = &pix[r[it]][4 * i[it]];
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q] = byte_f(pw[it], q);
        if (r[it] >= HALO - 1 && r[it] < HALO - 1 + SC) mw[r[it] - (HALO - 1)][i[it]] = mkw[it];
      }
    }
  }
  __syncthreads();

  // score of score-region pixel (r, c), canvas pixel (y0 - 1 + r, x0 - 1 + c)
  auto region_score = [&](int r, int c) {
    const int sy = y0 - 1 + r, sx = x0 - 1 + c;
    const bool keep = sy >= ylo && sy < yhi && sx >= xlo && sx < xhi && sy >= 0 && sy < H &&
                      sx >= 0 && sx < W &&
                      (mk == nullptr || reinterpret_cast<const uint8_t*>(mw[r])[c + 3] > 0);
    return keep ? fast_score(&pix[r + HALO - 1][c + HALO - 1], thr, bits) : 0;
  };
  int sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = region_score(ty + 1, tx + j + 1);
    score[ty + 1][tx + j + 1] = sc[j];
  }
  if (tid < 4 * SC - 4) {   // the 1-px ring: top, bottom, left, right
    int r, c;
    if (tid < SC) {
      r = 0;
      c = tid;
    } else if (tid < 2 * SC) {
      r = SC - 1;
      c = tid - SC;
    } else if (tid < 2 * SC + TILE) {
      r = tid - 2 * SC + 1;
      c = 0;
    } else {
      r = tid - 2 * SC - TILE + 1;
      c = SC - 1;
    }
    score[r][c] = region_score(r, c);
  }
  __syncthreads();

  // NMS-L over rows ty .. ty + 2, columns tx .. tx + 5 of the region; the
  // middle row's own four scores are in registers
  int col[6], tb[6];
#pragma unroll
  for (int dc = 0; dc < 6; ++dc) {
    tb[dc] = max(score[ty][tx + dc], score[ty + 2][tx + dc]);
    const int mid = dc == 0 ? score[ty + 1][tx] : dc == 5 ? score[ty + 1][tx + 5] : sc[dc - 1];
    col[dc] = max(tb[dc], mid);
  }
  int m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = max(max(col[j], col[j + 2]), tb[j + 1]);
  int out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = sc[j] >= m[j] ? sc[j] : 0;
  if (gy < H && gx < W) store4(raw, nms, o, gx, W, vec, sc, out);
}

}  // namespace

// img (N, H, W) u8; mask (n_mask, H, W) u8 or null, canvas n reads mask
// n % n_mask; roi (n_roi, 4) int32 [y_lo, y_hi, x_lo, x_hi), canvas n reads
// row n % n_roi; lut_bits (2048,) 32-bit words, 16-byte aligned, bit m & 31
// of word m >> 5 is fast_lut[m].  Outputs raw, nms (N, H, W) int32.
extern "C" int fast_nms_launch(const void* img, const void* mask, int n_mask,
                               const void* roi, int n_roi, const void* lut_bits, int N,
                               int H, int W, int threshold, void* raw, void* nms,
                               void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, N);
  fast_nms_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const uint8_t*)mask, n_mask, (const int32_t*)roi, n_roi,
      (const uint32_t*)lut_bits, H, W, threshold, (int32_t*)raw, (int32_t*)nms);
  return (int)cudaGetLastError();
}
