// Plane-sweep SAD scoring for Hopper (sm_90a): the fused warp + SSIM +
// channel-weighted 3x3 patch-SAD sweep of the MonoRec cost volume.
//
// Replaces the TPU kernel monorec_tpu/ops/pallas/cv_kernel.py::plane_sweep_sad
// (body _sad_kernel). Ports its contract, not its machinery: the band DMA,
// one-hot selection matmuls, per-lane shears, tap windows and depth chunks
// exist because the TPU has no vector gather. Hopper has one, so each warped
// value is a direct bilinear gather from global memory (through L1/L2: the
// D hypotheses of one tile read overlapping source windows).
//
// What bounds it: per output pixel and hypothesis it gathers 4 taps x C
// channels of the source and evaluates a 3x3-window SSIM on a halo'd tile;
// the (N, D, H, W) sad and wmask stores are the only device-memory writes.
// The design keeps every intermediate (the warped tile and its error map) in
// shared memory, and computes the depth-independent keyframe window
// statistics once per tile and reuses them for all D hypotheses — what the
// TPU kernel keeps in scratch.
//
// Grid: (ceil(W / TX), ceil(H / TY), N) blocks, a loop over D inside each.
// Per hypothesis:
//   1. warp the source over the tile + 2-px halo (bilinear, zero pad) and,
//      on the tile's own pixels, the border indicator into wmask;
//   2. photometric error on the tile + 1-px halo by use_ssim (1 SSIM,
//      2 0.85*SSIM + 0.15*L1, 0 L1, -1 3x3 avg-pooled L1), channel-weighted;
//   3. 3x3 box sum of that error into sad.
// Image borders follow the plain version exactly: the warped image and the
// keyframe are reflect-padded by one pixel for SSIM (the halo slot warps the
// mirrored output pixel), the error map is zero outside the image for the
// box sum and the avg-pooled L1. Coverage is all zeros (full reach) and is
// written by the Python wrapper.
//
// Sources: float32, or bf16 under the serving policy (the kernel is a
// template on the source type and converts on load; everything after the
// load is the float32 code, so bf16 sources give exactly the float32
// kernel's result on the upcast images). Keyframes are float32.
//
// Coordinates and the bilinear footprint come from sweep_common.cuh, shared
// with the warp-only kernel K4: float64 homographies, float32 displacements
// from M - I, each operation rounded on its own.

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

constexpr int C = 3;                 // RGB; the wrapper checks it
constexpr int TY = 16;               // output tile rows
constexpr int TX = 32;               // output tile cols
constexpr int HALO = 2;              // SSIM window (1) + SAD box (1)
constexpr int EY = TY + 2 * HALO;    // warped rows per tile
constexpr int EX = TX + 2 * HALO;
constexpr int QY = TY + 2;           // error rows per tile (1-px halo)
constexpr int QX = TX + 2;
constexpr int THREADS = 256;
constexpr float C1 = 1e-4f;          // 0.01^2
constexpr float C2 = 9e-4f;          // 0.03^2

// jnp.pad / F.pad "reflect" index map. Slots two pixels out only feed error
// values that are zeroed (outside the image), so clamp those in range.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
plane_sweep_sad_kernel(const T* __restrict__ images,         // (N, C, H, W)
                       const float* __restrict__ keyframes,  // (B, C, H, W)
                       const double* __restrict__ homs,      // (N, D, 3, 3), m22 == 1
                       float* __restrict__ sad,              // (N, D, H, W)
                       float* __restrict__ wmask,            // (N, D, H, W)
                       int D, int H, int W, int frames_per_image,
                       int border_radius, float cw0, float cw1, float cw2) {
  __shared__ float key_s[C][EY][EX];       // keyframe + 0.5, reflect-padded
  __shared__ float kst_s[2 * C][QY][QX];   // 3x3 sums of k and k*k
  __shared__ float warp_s[C][EY][EX];      // warped source + 0.5
  __shared__ float err_s[QY][QX];          // weighted error, 0 outside image

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TY - HALO;   // image coords of slot (0, 0)
  const int x0 = blockIdx.x * TX - HALO;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)H * W;
  const T* img = images + (size_t)n * C * plane;
  const float* key = keyframes + (size_t)(n / frames_per_image) * C * plane;
  const float cw[C] = {cw0, cw1, cw2};

  // Keyframe tile and its window statistics: depth-independent, once.
  for (int i = tid; i < EY * EX; i += THREADS) {
    const int ey = i / EX, ex = i % EX;
    const size_t off = (size_t)reflect(y0 + ey, H) * W + reflect(x0 + ex, W);
#pragma unroll
    for (int c = 0; c < C; ++c) key_s[c][ey][ex] = __ldg(key + c * plane + off) + 0.5f;
  }
  __syncthreads();
  if (MODE == 1 || MODE == 2) {
    for (int i = tid; i < QY * QX; i += THREADS) {
      const int qy = i / QX, qx = i % QX;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float s = 0.f, s2 = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float v = key_s[c][qy + dy][qx + dx];
            s += v;
            s2 += v * v;
          }
        kst_s[c][qy][qx] = s;
        kst_s[C + c][qy][qx] = s2;
      }
    }
  }

  for (int d = 0; d < D; ++d) {
    const sweep::Hom hom = sweep::load_hom(homs + ((size_t)n * D + d) * 9);
    const size_t out_plane = ((size_t)n * D + d) * plane;
    __syncthreads();  // the previous hypothesis is done with warp_s / err_s

    // 1. Warp the tile + 2-px halo; border indicator on the tile's pixels.
    for (int i = tid; i < EY * EX; i += THREADS) {
      const int ey = i / EX, ex = i % EX;
      const int py = y0 + ey, px = x0 + ex;
      const float fy = (float)reflect(py, H), fx = (float)reflect(px, W);
      float dx, dy;
      sweep::displacement(hom, fx, fy, dx, dy);
      const sweep::Footprint fp = sweep::footprint(fx, fy, dx, dy, H, W);
      float v[C] = {0.f, 0.f, 0.f};
      float b = 0.f;
      if (fp.near) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int tx = fp.xi + (t & 1), ty = fp.yi + (t >> 1);
          if (tx >= 0 && tx <= W - 1 && ty >= 0 && ty <= H - 1) {
            const size_t off = (size_t)ty * W + tx;
#pragma unroll
            for (int c = 0; c < C; ++c)
              v[c] = __fadd_rn(v[c], __fmul_rn(sweep::load(img + c * plane + off), fp.w[t]));
          }
          if (tx >= border_radius && tx < W - border_radius &&
              ty >= border_radius && ty < H - border_radius)
            b = __fadd_rn(b, fp.w[t]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) warp_s[c][ey][ex] = v[c] + 0.5f;
      if (ey >= HALO && ey < HALO + TY && ex >= HALO && ex < HALO + TX && py < H && px < W)
        wmask[out_plane + (size_t)py * W + px] = b;
    }
    __syncthreads();

    // 2. Channel-weighted photometric error on the tile + 1-px halo.
    for (int i = tid; i < QY * QX; i += THREADS) {
      const int qy = i / QX, qx = i % QX;
      const int py = y0 + 1 + qy, px = x0 + 1 + qx;
      float e = 0.f;
      if (py >= 0 && py < H && px >= 0 && px < W) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float w = warp_s[c][qy + 1][qx + 1];
          const float k = key_s[c][qy + 1][qx + 1];
          float diff;
          if (MODE == 1 || MODE == 2) {
            float sx = 0.f, sxx = 0.f, sxy = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const float a = warp_s[c][qy + dy][qx + dx];
                sx += a;
                sxx += a * a;
                sxy += a * key_s[c][qy + dy][qx + dx];
              }
            const float mu_x = sx / 9.f, mu_y = kst_s[c][qy][qx] / 9.f;
            const float sigma_x = sxx / 9.f - mu_x * mu_x;
            const float sigma_y = kst_s[C + c][qy][qx] / 9.f - mu_y * mu_y;
            const float sigma_xy = sxy / 9.f - mu_x * mu_y;
            const float num = (2.f * mu_x * mu_y + C1) * (2.f * sigma_xy + C2);
            const float den = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2);
            diff = fminf(fmaxf((1.f - num / den) / 2.f, 0.f), 1.f);
            if (MODE == 2) diff = 0.85f * diff + 0.15f * fabsf(w - k);
          } else if (MODE == 0) {
            diff = fabsf(w - k);
          } else {  // -1: 3x3 avg pool of L1, zero outside the image
            float s = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const int ry = py - 1 + dy, rx = px - 1 + dx;
                if (ry >= 0 && ry < H && rx >= 0 && rx < W)
                  s += fabsf(warp_s[c][qy + dy][qx + dx] - key_s[c][qy + dy][qx + dx]);
              }
            diff = s / 9.f;
          }
          e += cw[c] * diff;
        }
      }
      err_s[qy][qx] = e;
    }
    __syncthreads();

    // 3. 3x3 box sum (zero padded) into sad.
    for (int i = tid; i < TY * TX; i += THREADS) {
      const int ty = i / TX, tx = i % TX;
      const int py = y0 + HALO + ty, px = x0 + HALO + tx;
      if (py < H && px < W) {
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) s += err_s[ty + dy][tx + dx];
        sad[out_plane + (size_t)py * W + px] = s;
      }
    }
  }
}

template <typename T>
int launch(const void* images, const float* keyframes, const double* homs, float* sad,
           float* wmask, int N, int D, int H, int W, int frames_per_image, int border_radius,
           int use_ssim, float cw0, float cw1, float cw2, cudaStream_t s) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, N);
  const dim3 block(THREADS);
  const T* src = static_cast<const T*>(images);
#define PSS_LAUNCH(MODE)                                                             \
  plane_sweep_sad_kernel<T, MODE><<<grid, block, 0, s>>>(                            \
      src, keyframes, homs, sad, wmask, D, H, W, frames_per_image, border_radius, cw0, \
      cw1, cw2)
  switch (use_ssim) {
    case 1: PSS_LAUNCH(1); break;
    case 2: PSS_LAUNCH(2); break;
    case 0: PSS_LAUNCH(0); break;
    case -1: PSS_LAUNCH(-1); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PSS_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// images are float32 (images_bf16 == 0) or bf16 (1). Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int plane_sweep_sad_launch(const void* images, const float* keyframes, const double* homs,
                           float* sad, float* wmask, int N, int D, int H, int W,
                           int frames_per_image, int border_radius, int use_ssim,
                           int images_bf16, float cw0, float cw1, float cw2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (images_bf16)
    return launch<__nv_bfloat16>(images, keyframes, homs, sad, wmask, N, D, H, W,
                                 frames_per_image, border_radius, use_ssim, cw0, cw1, cw2, s);
  return launch<float>(images, keyframes, homs, sad, wmask, N, D, H, W, frames_per_image,
                       border_radius, use_ssim, cw0, cw1, cw2, s);
}

const char* plane_sweep_sad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
