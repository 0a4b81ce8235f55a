// Fused photometric error for Hopper (sm_90a): 0.85 * SSIM (zero padding,
// 3x3 gaussian window, comp_mode clamp) + 0.15 * L1, channel mean, and its
// analytic gradient with respect to the first input.
//
// Replaces the TPU kernels monorec_tpu/ops/pallas/photo_error.py
// (photo_error_fwd, body _fwd_kernel; photo_error_bwd, body _bwd_kernel).
// Same contract: x, y (M, C, H, W) float32 -> (M, H, W); the backward maps a
// cotangent (M, H, W) to d/dx (M, C, H, W), and y (the keyframe, data) gets
// no gradient. The TPU kernel's row blocks, lane rolls and the H % 16 /
// W % 128 shape gate are not carried over: ragged tiles are bounds-checked.
//
// Both directions share one design, made for the backward and carried over
// to the forward.
//
// What bounds them: bytes by count. The forward reads x and y and writes
// out once (235 MB at M=64, 3x256x512, 0.070 ms on an H100); the backward
// also reads the cotangent and writes gx (336 MB, 0.10 ms). The first port
// of each ran at 15-26% of that, held by its instruction stream:
// element-wise staging with a division, a remainder and a bounds check per
// element, barriers that kept every load from overlapping compute, 18
// shared-memory loads and 45 multiply-adds per pixel and channel for the
// five window sums, an IEEE division per pixel and channel, and a spill.
// The design:
//   * A lane owns a column and each of the 4 warps of a 128-thread block a
//     strip of 8 rows: the forward's tiles are 32x32 outputs; the
//     backward's g-map region (tile + 1 px) is 32x32, so its tiles are 30x30
//     outputs, and the outputs take 30 of each warp's lanes. A strip
//     recomputes the row sums of its 2 halo rows: 1.25x the rows here, 1.5x
//     with 256 threads in 4-row strips.
//   * Staging by cp.async from a 4-float column boundary left of the halo:
//     16-byte copies where W % 4 == 0 and the tensors are 16-byte aligned,
//     4-byte copies otherwise, the zero padding by the copies' src-size 0.
//     Channel c + 1 is in flight while channel c computes (two buffers; one
//     barrier per channel in the forward, two in the backward, whose
//     g-maps go through shared memory); the cotangent is staged once per
//     tile.
//   * Window sums from row sums: G = [[a,b,a],[b,c,b],[a,b,a]], so a window
//     sum is hA(row above) + hB(own row) + hA(row below) with hA, hB the
//     horizontal sums under weights (a,b,a) and (b,c,b): the same nine
//     products, grouped by row. A lane walks down its column and keeps the
//     two rows above in registers, so each staged row costs 6 shared loads
//     for all five statistics; the G* stencils of the g-maps run the same
//     way (9 loads per output row).
//   * One reciprocal per pixel and channel: of d in the forward, of p q in
//     the backward, where it also serves the clamp test and the g-maps.
//   * The forward keeps one running sum per output row of its strip in
//     registers across the channels and stores each row as one coalesced
//     128-byte warp write.
//   * __launch_bounds__(128, 8): at most 64 registers, no spill. Shared
//     memory a block: 22 KB (forward), 39 KB (backward).

// Forward, per channel: mu_x, mu_y, E[xx], E[yy], E[xy] over the zero-padded
// window, then the plain version's formula: n = (2 mu_x mu_y + C1)(2 s_xy +
// C2), d = (mu_x^2 + mu_y^2 + C1)(s_x + s_y + C2), clamp(1 - n / d, 0, 1) / 2.
// Output mean_c(0.85 ssim + 0.15 |x - y|), the plain version's 0.85
// mean_c(ssim) + 0.15 mean_c(|x - y|) with its terms in another order.
//
// Backward (photo_error.py:139-181): with a = 2 mu_x mu_y + C1,
// b = 2 (E[xy] - mu_x mu_y) + C2, p = mu_x^2 + mu_y^2 + C1,
// q = E[xx] + E[yy] - mu_x^2 - mu_y^2 + C2 and val = 1 - a b / (p q), the
// g-maps g_q = 0.85 / C * 0.5 * cot * [0 <= val <= 1] (the clamp's
// subgradient is inclusive), g_mu = g_q (-2 mu_y (b - a) / pq + 2 mu_x a b
// (q - p) / pq^2), g_xx = g_q a b p / pq^2 and g_xy = g_q (-2 a / pq) are
// computed on the tile plus a 1-pixel halo (zero outside the image, where
// the cotangent is zero), then d/dx = G*g_mu + 2 x G*g_xx + y G*g_xy +
// 0.15 / C * cot * sign(x - y), where G* is the same symmetric zero-padded
// 3x3 gaussian stencil (the transpose of a window average).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;          // 4 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int STRIP = 8;              // rows a warp walks down
// Staged columns from a 4-float boundary at or left of the tile's halo, as
// 16-byte chunks: the backward's 2-px halo (30 + 4 = 34) or the forward's
// 1-px halo (32 + 2 = 34) plus up to 3 (forward: exactly 3) of lead.
constexpr int SCOLS = 40;
constexpr float C1 = 1e-4f;           // 0.01^2
constexpr float C2 = 9e-4f;           // 0.03^2
// The reference's 3x3 GaussianAverage window G = [[GA, GB, GA], [GB, GC,
// GB], [GA, GB, GA]].
constexpr float GA = 0.0947f, GB = 0.1183f, GC = 0.1478f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; a copy that is not `valid` writes zeros and
// reads nothing (src-size 0; `src` is any mapped address then).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying the (ROWS x SCOLS) window of the plane `src` whose slot
// (0, 0) is image pixel (y0, xa) into dst, zero outside the image. VEC: xa,
// W and src are 16-byte aligned, so each 16-byte chunk lies wholly inside
// or outside a row; else 4-byte copies.
template <int ROWS, bool VEC>
__device__ __forceinline__ void stage_async(float (*dst)[SCOLS], const float* __restrict__ src,
                                            int y0, int xa, int H, int W) {
  if (VEC) {
    for (int i = threadIdx.x; i < ROWS * (SCOLS / 4); i += THREADS) {
      const int r = i / (SCOLS / 4), k = i % (SCOLS / 4) * 4;
      const int py = y0 + r, px = xa + k;
      const bool in = py >= 0 && py < H && px >= 0 && px < W;
      cp_async16(&dst[r][k], in ? src + py * W + px : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * SCOLS; i += THREADS) {
      const int r = i / SCOLS, k = i % SCOLS;
      const int py = y0 + r, px = xa + k;
      const bool in = py >= 0 && py < H && px >= 0 && px < W;
      cp_async4(&dst[r][k], in ? src + py * W + px : src, in);
    }
  }
}

// The two horizontal gaussian sums of three neighbours v0, v1, v2: with
// weights (GA, GB, GA) and (GB, GC, GB). A 3x3 window sum is hA of the row
// above + hB of its own row + hA of the row below: the same nine products.
__device__ __forceinline__ void hsums(float v0, float v1, float v2, float& ha, float& hb) {
  const float side = v0 + v2;
  ha = GA * side + GB * v1;
  hb = GB * side + GC * v1;
}

// The five statistics' row sums (x, y, xx, yy, xy) of three neighbours.
__device__ __forceinline__ void stat_sums(float x0, float x1, float x2, float y0, float y1,
                                          float y2, float (&ha)[5], float (&hb)[5]) {
  hsums(x0, x1, x2, ha[0], hb[0]);
  hsums(y0, y1, y2, ha[1], hb[1]);
  hsums(x0 * x0, x1 * x1, x2 * x2, ha[2], hb[2]);
  hsums(y0 * y0, y1 * y1, y2 * y2, ha[3], hb[3]);
  hsums(x0 * y0, x1 * y1, x2 * y2, ha[4], hb[4]);
}

// The same of staged row `xr`, `yr` at columns q..q+2.
__device__ __forceinline__ void stat_row(const float* xr, const float* yr, int q, float (&ha)[5],
                                         float (&hb)[5]) {
  stat_sums(xr[q], xr[q + 1], xr[q + 2], yr[q], yr[q + 1], yr[q + 2], ha, hb);
}

// ---- Forward -------------------------------------------------------------
//
// Tile: FT x FT outputs, a lane per column, each warp a strip of STRIP rows.
constexpr int FT = WARPS * STRIP;   // outputs per tile side (32)
constexpr int FWD_ROWS = FT + 2;    // staged x / y rows: tile + 1-px halo (34)

// Grid (ceil(W / FT), ceil(H / FT), M), 128 threads, a loop over channels
// with channel c + 1's copies in flight while channel c computes.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
photo_error_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ out, int C, int H, int W) {
  __shared__ __align__(16) float xs[2][FWD_ROWS][SCOLS];
  __shared__ __align__(16) float ys[2][FWD_ROWS][SCOLS];
  const int m = blockIdx.z;
  const int ty0 = blockIdx.y * FT, tx0 = blockIdx.x * FT;
  const int xa = tx0 - 4;  // image column of staged column 0; tx0 - 1 is staged column 3
  const int plane = H * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * STRIP;  // the strip's first output row in the tile
  const float* xm = x + (size_t)m * C * plane;
  const float* ym = y + (size_t)m * C * plane;

  // Per output row of the strip: the sum over channels of 0.85 ssim + 0.15
  // |x - y|.
  float acc[STRIP];
#pragma unroll
  for (int k = 0; k < STRIP; ++k) acc[k] = 0.f;

  // Rows ty0 - 1.. (the tile and its 1-px halo).
  stage_async<FWD_ROWS, VEC>(xs[0], xm, ty0 - 1, xa, H, W);
  stage_async<FWD_ROWS, VEC>(ys[0], ym, ty0 - 1, xa, H, W);
  cp_async_commit();

  for (int c = 0; c < C; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();  // channel c has landed; channel c - 1 is done with buf ^ 1
    if (c + 1 < C) {
      stage_async<FWD_ROWS, VEC>(xs[buf ^ 1], xm + (size_t)(c + 1) * plane, ty0 - 1, xa, H, W);
      stage_async<FWD_ROWS, VEC>(ys[buf ^ 1], ym + (size_t)(c + 1) * plane, ty0 - 1, xa, H, W);
      cp_async_commit();
    }

    // Output (ty0 + r0 + k, tx0 + lane) reads staged rows r0 + k.. r0 + k + 2
    // and columns lane + 3.. lane + 5: the lane walks down, keeping the row
    // sums of the two rows above and the centre's |x - y| of the row above.
    float a2[5], b1[5], a1[5], l1_above;
#pragma unroll
    for (int k = 0; k < STRIP + 2; ++k) {
      const float* xr = xs[buf][r0 + k];
      const float* yr = ys[buf][r0 + k];
      const float x0 = xr[lane + 3], x1 = xr[lane + 4], x2 = xr[lane + 5];
      const float y0 = yr[lane + 3], y1 = yr[lane + 4], y2 = yr[lane + 5];
      float ha[5], hb[5];
      stat_sums(x0, x1, x2, y0, y1, y2, ha, hb);
      if (k >= 2) {
        const float mu_x = a2[0] + b1[0] + ha[0], mu_y = a2[1] + b1[1] + ha[1];
        const float e_xx = a2[2] + b1[2] + ha[2], e_yy = a2[3] + b1[3] + ha[3];
        const float e_xy = a2[4] + b1[4] + ha[4];
        const float sigma_x = e_xx - mu_x * mu_x;
        const float sigma_y = e_yy - mu_y * mu_y;
        const float sigma_xy = e_xy - mu_x * mu_y;
        const float n = (2.f * mu_x * mu_y + C1) * (2.f * sigma_xy + C2);
        const float d = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2);
        const float ssim = fminf(fmaxf(1.f - n * __frcp_rn(d), 0.f), 1.f);
        acc[k - 2] += 0.425f * ssim + 0.15f * l1_above;
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) a2[i] = a1[i], a1[i] = ha[i], b1[i] = hb[i];
      l1_above = fabsf(x1 - y1);
    }
  }

  const int px = tx0 + lane;
  const float inv_c = 1.f / (float)C;
#pragma unroll
  for (int k = 0; k < STRIP; ++k) {
    const int py = ty0 + r0 + k;
    if (py < H && px < W) out[(size_t)m * plane + py * W + px] = acc[k] * inv_c;
  }
}

// ---- Backward ------------------------------------------------------------
//
// Tile: BT x BT outputs; its g-maps cover the tile + a 1-px halo, BQ x BQ =
// 32 x 32, one warp's width, so a lane owns a g-map column and each warp a
// strip of STRIP rows, every lane busy. The outputs take lanes 0..BT-1.
constexpr int BT = 30;              // outputs per tile side
constexpr int BQ = BT + 2;          // g-map side (32 = WARPS * STRIP)
constexpr int OROWS = (BT + WARPS - 1) / WARPS;  // output rows per warp (8; the last 6)
constexpr int XY_ROWS = BT + 4;     // staged x / y rows: tile + 2-px halo (34)
constexpr int COT_ROWS = BQ;        // staged cotangent rows: tile + 1-px halo (32)

// Grid (ceil(W / BT), ceil(H / BT), M), 128 threads, a loop over channels
// with channel c + 1's copies in flight while channel c computes.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
photo_error_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ cot, float* __restrict__ gx,
                       int C, int H, int W) {
  __shared__ __align__(16) float xs[2][XY_ROWS][SCOLS];
  __shared__ __align__(16) float ys[2][XY_ROWS][SCOLS];
  __shared__ __align__(16) float cs[COT_ROWS][SCOLS];
  __shared__ float gmap[3][BQ][BQ];  // g_mu, g_xx, g_xy
  const int m = blockIdx.z;
  const int ty0 = blockIdx.y * BT, tx0 = blockIdx.x * BT;
  const int xa = (tx0 - 2) & ~3;  // image column of staged column 0
  const int ox = tx0 - 2 - xa;    // staged column of image column tx0 - 2 (0..3)
  const int plane = H * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float ssim_scale = 0.85f / (float)C * 0.5f, l1_scale = 0.15f / (float)C;
  const float* xm = x + (size_t)m * C * plane;
  const float* ym = y + (size_t)m * C * plane;

  // Cotangent rows ty0 - 1.. (the g-maps' region), x and y rows ty0 - 2..
  stage_async<COT_ROWS, VEC>(cs, cot + (size_t)m * plane, ty0 - 1, xa, H, W);
  stage_async<XY_ROWS, VEC>(xs[0], xm, ty0 - 2, xa, H, W);
  stage_async<XY_ROWS, VEC>(ys[0], ym, ty0 - 2, xa, H, W);
  cp_async_commit();

  for (int c = 0; c < C; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();  // channel c has landed; channel c - 1 is done with every buffer
    if (c + 1 < C) {
      stage_async<XY_ROWS, VEC>(xs[buf ^ 1], xm + (size_t)(c + 1) * plane, ty0 - 2, xa, H, W);
      stage_async<XY_ROWS, VEC>(ys[buf ^ 1], ym + (size_t)(c + 1) * plane, ty0 - 2, xa, H, W);
      cp_async_commit();
    }

    // g-maps at g-map (r, q) = image (ty0 - 1 + r, tx0 - 1 + q): lane q walks
    // rows r0..r0 + STRIP - 1, keeping the row sums of the two rows above.
    {
      const int q = lane, r0 = warp * STRIP, px = tx0 - 1 + q;
      float a2[5], b1[5], a1[5];  // hA of staged row s - 2, hB and hA of s - 1
#pragma unroll
      for (int k = 0; k < STRIP + 2; ++k) {
        const int s = r0 + k;  // staged row: image row ty0 - 2 + s
        float ha[5], hb[5];
        stat_row(xs[buf][s], ys[buf][s], ox + q, ha, hb);
        if (k >= 2) {
          const int r = s - 2, py = ty0 - 1 + r;
          float g0 = 0.f, g1 = 0.f, g2 = 0.f;
          if (py >= 0 && py < H && px >= 0 && px < W) {
            const float mu_x = a2[0] + b1[0] + ha[0], mu_y = a2[1] + b1[1] + ha[1];
            const float e_xx = a2[2] + b1[2] + ha[2], e_yy = a2[3] + b1[3] + ha[3];
            const float e_xy = a2[4] + b1[4] + ha[4];
            const float a = 2.f * mu_x * mu_y + C1;
            const float b = 2.f * (e_xy - mu_x * mu_y) + C2;
            const float p = mu_x * mu_x + mu_y * mu_y + C1;
            const float qq = e_xx + e_yy - mu_x * mu_x - mu_y * mu_y + C2;
            const float inv_pq = __frcp_rn(p * qq);
            const float ab = a * b;
            const float val = 1.f - ab * inv_pq;
            const float g_q = (val >= 0.f && val <= 1.f) ? ssim_scale * cs[r][ox + 1 + q] : 0.f;
            const float inv2 = inv_pq * inv_pq;
            g0 = g_q * (-2.f * mu_y * (b - a) * inv_pq + 2.f * mu_x * ab * (qq - p) * inv2);
            g1 = g_q * (ab * p * inv2);
            g2 = g_q * (-2.f * a * inv_pq);
          }
          gmap[0][r][q] = g0;
          gmap[1][r][q] = g1;
          gmap[2][r][q] = g2;
        }
#pragma unroll
        for (int i = 0; i < 5; ++i) a2[i] = a1[i], a1[i] = ha[i], b1[i] = hb[i];
      }
    }
    __syncthreads();

    // Outputs at image (ty0 + o, tx0 + j): lane j < BT walks rows o0.. of
    // its strip, G* of the three g-maps from their row sums.
    if (lane < BT) {
      const int j = lane, o0 = warp * OROWS, rows = min(OROWS, BT - o0), px = tx0 + j;
      float* out = gx + ((size_t)m * C + c) * plane;
      float a2[3], b1[3], a1[3];
#pragma unroll
      for (int k = 0; k < OROWS + 2; ++k) {
        if (k >= rows + 2) break;
        const int t = o0 + k;  // g-map row
        float ha[3], hb[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          hsums(gmap[i][t][j], gmap[i][t][j + 1], gmap[i][t][j + 2], ha[i], hb[i]);
        if (k >= 2) {
          const int o = t - 2, py = ty0 + o;
          if (py < H && px < W) {
            const float xc = xs[buf][o + 2][ox + 2 + j], yc = ys[buf][o + 2][ox + 2 + j];
            const float sgn = (float)((xc > yc) - (xc < yc));
            out[py * W + px] = (a2[0] + b1[0] + ha[0]) + 2.f * xc * (a2[1] + b1[1] + ha[1]) +
                               yc * (a2[2] + b1[2] + ha[2]) +
                               l1_scale * cs[o + 1][ox + 2 + j] * sgn;
          }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) a2[i] = a1[i], a1[i] = ha[i], b1[i] = hb[i];
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Forward: out (M, H, W) from x, y (M, C, H, W). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int photo_error_fwd_launch(const float* x, const float* y, float* out, int M, int C, int H,
                           int W, void* stream) {
  if (M <= 0 || M > 65535 || C <= 0 || H <= 0 || W <= 0 || (long long)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + FT - 1) / FT, (H + FT - 1) / FT, M), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(x) && aligned16(y))
    photo_error_fwd_kernel<true><<<grid, block, 0, s>>>(x, y, out, C, H, W);
  else
    photo_error_fwd_kernel<false><<<grid, block, 0, s>>>(x, y, out, C, H, W);
  return (int)cudaGetLastError();
}

// Backward: gx (M, C, H, W) = d(sum(out * cot)) / dx for cot (M, H, W).
int photo_error_bwd_launch(const float* x, const float* y, const float* cot, float* gx, int M,
                           int C, int H, int W, void* stream) {
  if (M <= 0 || M > 65535 || C <= 0 || H <= 0 || W <= 0 || (long long)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + BT - 1) / BT, (H + BT - 1) / BT, M), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(x) && aligned16(y) && aligned16(cot))
    photo_error_bwd_kernel<true><<<grid, block, 0, s>>>(x, y, cot, gx, C, H, W);
  else
    photo_error_bwd_kernel<false><<<grid, block, 0, s>>>(x, y, cot, gx, C, H, W);
  return (int)cudaGetLastError();
}

const char* photo_error_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
