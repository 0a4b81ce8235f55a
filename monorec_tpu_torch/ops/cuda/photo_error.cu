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
// What bounds it: per output pixel and channel the five 3x3 window
// statistics are 45 multiply-adds on values that neighbouring pixels share,
// against two float32 reads per channel and one write. The design stages
// each channel's x and y tile with its halo in shared memory, so every
// input value is read from device memory once per tile and the window sums
// run out of shared memory; no (M, C, H, W) intermediate is written.
//
// Grid: (ceil(W / TX), ceil(H / TY), M) blocks of 256 threads, each thread
// two pixels of the 16x32 tile, a loop over channels inside.
//
// Forward, per channel: mu_x, mu_y, E[xx], E[yy], E[xy] over the zero-padded
// window (taps summed row-major, as the plain version's convolution reads
// them), then the plain version's formula: n = (2 mu_x mu_y + C1)(2 s_xy +
// C2), d = (mu_x^2 + mu_y^2 + C1)(s_x + s_y + C2), clamp(1 - n / d, 0, 1) / 2.
// Output 0.85 * mean_c(ssim) + 0.15 * mean_c(|x - y|).
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

constexpr int TY = 16;
constexpr int TX = 32;
constexpr int THREADS = 256;
constexpr int PIX = TY * TX / THREADS;  // pixels per thread
constexpr float C1 = 1e-4f;             // 0.01^2
constexpr float C2 = 9e-4f;             // 0.03^2

// The reference's 3x3 GaussianAverage window.
__constant__ float G[3][3] = {
    {0.0947f, 0.1183f, 0.0947f},
    {0.1183f, 0.1478f, 0.1183f},
    {0.0947f, 0.1183f, 0.0947f},
};

// Stage one channel's (rows x cols) window of `src` whose slot (0, 0) is
// image pixel (y0, x0) into shared memory, zero outside the image.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(float (*dst)[COLS], const float* __restrict__ src,
                                      int y0, int x0, int H, int W) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    const int py = y0 + r, px = x0 + c;
    dst[r][c] = (py >= 0 && py < H && px >= 0 && px < W) ? __ldg(src + (size_t)py * W + px) : 0.f;
  }
}

// Window statistics of the 3x3 window whose top-left slot is (r, c).
struct Stats {
  float mu_x, mu_y, e_xx, e_yy, e_xy;
};

template <int COLS>
__device__ __forceinline__ Stats window_stats(const float (*xs)[COLS], const float (*ys)[COLS],
                                              int r, int c) {
  Stats s = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float g = G[a][b], x = xs[r + a][c + b], y = ys[r + a][c + b];
      s.mu_x += g * x;
      s.mu_y += g * y;
      s.e_xx += g * (x * x);
      s.e_yy += g * (y * y);
      s.e_xy += g * (x * y);
    }
  return s;
}

template <int COLS>
__device__ __forceinline__ float stencil(const float (*m)[COLS], int r, int c) {
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) s += G[a][b] * m[r + a][c + b];
  return s;
}

__global__ void __launch_bounds__(THREADS)
photo_error_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ out, int C, int H, int W) {
  __shared__ float xs[TY + 2][TX + 2];
  __shared__ float ys[TY + 2][TX + 2];
  const int m = blockIdx.z;
  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * TX;
  const size_t plane = (size_t)H * W;
  float ssim_sum[PIX], l1_sum[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) ssim_sum[k] = l1_sum[k] = 0.f;

  for (int c = 0; c < C; ++c) {
    const size_t off = ((size_t)m * C + c) * plane;
    __syncthreads();  // the previous channel is done with xs / ys
    stage<TY + 2, TX + 2>(xs, x + off, ty0 - 1, tx0 - 1, H, W);
    stage<TY + 2, TX + 2>(ys, y + off, ty0 - 1, tx0 - 1, H, W);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int r = i / TX, q = i % TX;
      const Stats s = window_stats<TX + 2>(xs, ys, r, q);
      const float sigma_x = s.e_xx - s.mu_x * s.mu_x;
      const float sigma_y = s.e_yy - s.mu_y * s.mu_y;
      const float sigma_xy = s.e_xy - s.mu_x * s.mu_y;
      const float n = (2.f * s.mu_x * s.mu_y + C1) * (2.f * sigma_xy + C2);
      const float d = (s.mu_x * s.mu_x + s.mu_y * s.mu_y + C1) * (sigma_x + sigma_y + C2);
      ssim_sum[k] += fminf(fmaxf(1.f - n / d, 0.f), 1.f) / 2.f;
      l1_sum[k] += fabsf(xs[r + 1][q + 1] - ys[r + 1][q + 1]);
    }
  }
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int py = ty0 + i / TX, px = tx0 + i % TX;
    if (py < H && px < W)
      out[(size_t)m * plane + (size_t)py * W + px] =
          0.85f * (ssim_sum[k] / (float)C) + 0.15f * (l1_sum[k] / (float)C);
  }
}

__global__ void __launch_bounds__(THREADS)
photo_error_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ cot, float* __restrict__ gx,
                       int C, int H, int W) {
  constexpr int QY = TY + 2, QX = TX + 2;  // g-map extent: tile + 1-px halo
  __shared__ float xs[TY + 4][TX + 4];     // tile + 2-px halo
  __shared__ float ys[TY + 4][TX + 4];
  __shared__ float cs[QY][QX];
  __shared__ float g_mu[QY][QX], g_xx[QY][QX], g_xy[QY][QX];
  const int m = blockIdx.z;
  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * TX;
  const size_t plane = (size_t)H * W;
  const float ssim_scale = 0.85f / (float)C * 0.5f, l1_scale = 0.15f / (float)C;

  stage<QY, QX>(cs, cot + (size_t)m * plane, ty0 - 1, tx0 - 1, H, W);
  for (int c = 0; c < C; ++c) {
    const size_t off = ((size_t)m * C + c) * plane;
    __syncthreads();  // the previous channel is done with every map
    stage<TY + 4, TX + 4>(xs, x + off, ty0 - 2, tx0 - 2, H, W);
    stage<TY + 4, TX + 4>(ys, y + off, ty0 - 2, tx0 - 2, H, W);
    __syncthreads();

    // g-maps on the tile + 1-px halo; zero outside the image.
    for (int i = threadIdx.x; i < QY * QX; i += THREADS) {
      const int r = i / QX, q = i % QX;
      const int py = ty0 - 1 + r, px = tx0 - 1 + q;
      float gm = 0.f, gxx = 0.f, gxy = 0.f;
      if (py >= 0 && py < H && px >= 0 && px < W) {
        const Stats s = window_stats<TX + 4>(xs, ys, r, q);
        const float a = 2.f * s.mu_x * s.mu_y + C1;
        const float b = 2.f * (s.e_xy - s.mu_x * s.mu_y) + C2;
        const float p = s.mu_x * s.mu_x + s.mu_y * s.mu_y + C1;
        const float qq = s.e_xx + s.e_yy - s.mu_x * s.mu_x - s.mu_y * s.mu_y + C2;
        const float pq = p * qq;
        const float val = 1.f - (a * b) / pq;
        const float g_q = (val >= 0.f && val <= 1.f) ? ssim_scale * cs[r][q] : 0.f;
        const float inv_pq = 1.f / pq;
        gm = g_q * (-2.f * s.mu_y * (b - a) * inv_pq +
                    2.f * s.mu_x * a * b * (qq - p) * inv_pq * inv_pq);
        gxx = g_q * (a * b * inv_pq * inv_pq * p);
        gxy = g_q * (-2.f * a * inv_pq);
      }
      g_mu[r][q] = gm;
      g_xx[r][q] = gxx;
      g_xy[r][q] = gxy;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int r = i / TX, q = i % TX;
      const int py = ty0 + r, px = tx0 + q;
      if (py < H && px < W) {
        const float xc = xs[r + 2][q + 2], yc = ys[r + 2][q + 2];
        const float sgn = (float)((xc > yc) - (xc < yc));
        gx[off + (size_t)py * W + px] = stencil<QX>(g_mu, r, q) +
                                        2.f * xc * stencil<QX>(g_xx, r, q) +
                                        yc * stencil<QX>(g_xy, r, q) +
                                        l1_scale * cs[r + 1][q + 1] * sgn;
      }
    }
  }
}

}  // namespace

extern "C" {

// Forward: out (M, H, W) from x, y (M, C, H, W). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int photo_error_fwd_launch(const float* x, const float* y, float* out, int M, int C, int H,
                           int W, void* stream) {
  if (M <= 0 || M > 65535 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, M), block(THREADS);
  photo_error_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(x, y, out, C, H,
                                                                               W);
  return (int)cudaGetLastError();
}

// Backward: gx (M, C, H, W) = d(sum(out * cot)) / dx for cot (M, H, W).
int photo_error_bwd_launch(const float* x, const float* y, const float* cot, float* gx, int M,
                           int C, int H, int W, void* stream) {
  if (M <= 0 || M > 65535 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, M), block(THREADS);
  photo_error_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(x, y, cot, gx, C,
                                                                               H, W);
  return (int)cudaGetLastError();
}

const char* photo_error_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
