// Bilinear loss warp at absolute pixel coordinates for Hopper (sm_90a), with
// its coordinate Jacobian and its cotangent contraction.
//
// Replaces the TPU kernel monorec_tpu/ops/pallas/grid_warp.py (grid_warp,
// grid_warp_jac, grid_warp_grad; body _warp_kernel). Ports its contract, not
// its machinery: the band DMA, the row-aligned slab, the per-lane shear, the
// KY / R_MAX tap windows and the per-block bounds exist because the TPU has
// no vector gather. Hopper has one, so every output pixel gathers its four
// taps directly from global memory through the read-only cache, with
// unlimited reach: coverage is always zero (written by the Python wrapper).
//
// Per output pixel (n, y, x) with sample position (X, Y) = (xs, ys)[n, y, x]:
// taps at x0 = floor(X), x0 + 1 and y0 = floor(Y), y0 + 1 with weights
// wx1 = X - x0, wx0 = 1 - wx1 (and the same in y). A tap is inside when
// 0 <= xi <= W-1 and 0 <= yi <= H-1; an outside tap reads zero, so a sample
// whose four taps are all outside is exactly 0.0 (the reprojection loss
// marks invalid pixels by `== 0`). The Jacobian follows the reference
// subgradient (d wx1 / dX = 1, also at integer fractions: dout/dX =
// I[x0+1] - I[x0] there), monorec_tpu/ops/pallas/grid_warp.py::_hat_grad.
//
// What bounds it: per pixel 4 * C scattered reads (neighbouring threads read
// neighbouring source pixels for smooth warps, so the L1/L2 absorb most of
// them) against C (values), 3 C (Jacobian) or 2 (gradient) coalesced
// float32 writes. The design keeps it at one pass over the output: one
// thread per output pixel, the coordinates and tap weights computed once
// and reused for every channel.
//
// The values are summed tap by tap in the plain version's order
// ((x0,y0), (x1,y0), (x0,y1), (x1,y1)) with contraction into FMAs
// disabled, so the kernel's values equal the plain PyTorch version's.
//
// The images are float32, or bf16 under the serving policy's loss-warp
// dtype: the kernel is a template on the image type and converts on load,
// so bf16 images give exactly the float32 kernel's result on the upcast
// images. Coordinates, cotangents and every output are float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sweep_common.cuh"  // sweep::load

namespace {

constexpr int THREADS = 256;

enum Mode { kValues = 0, kJacobian = 1, kGradient = 2 };

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
grid_warp_kernel(const T* __restrict__ images,      // (N, C, H, W)
                 const float* __restrict__ xs,      // (N, H, W)
                 const float* __restrict__ ys,      // (N, H, W)
                 const float* __restrict__ cot,     // (N, C, H, W), gradient mode
                 float* __restrict__ out,           // (N, C, H, W) or (N, 2, H, W)
                 float* __restrict__ jx,            // (N, C, H, W), Jacobian mode
                 float* __restrict__ jy,            // (N, C, H, W), Jacobian mode
                 long long total, int C, int H, int W) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)H * W;
  const long long n = idx / plane;
  const long long p = idx - n * plane;

  const float X = __ldg(xs + idx), Y = __ldg(ys + idx);
  const float fx0 = floorf(X), fy0 = floorf(Y);
  const float wx1 = __fsub_rn(X, fx0), wy1 = __fsub_rn(Y, fy0);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  // NaN coordinates fail every test below and sample zero.
  const bool inx0 = fx0 >= 0.f && fx0 <= (float)(W - 1);
  const bool inx1 = fx0 + 1.f >= 0.f && fx0 + 1.f <= (float)(W - 1);
  const bool iny0 = fy0 >= 0.f && fy0 <= (float)(H - 1);
  const bool iny1 = fy0 + 1.f >= 0.f && fy0 + 1.f <= (float)(H - 1);
  // Integer offsets only for taps that are inside (huge floats never cast).
  const int ix0 = inx0 ? (int)fx0 : 0, ix1 = inx1 ? (int)fx0 + 1 : 0;
  const int iy0 = iny0 ? (int)fy0 : 0, iy1 = iny1 ? (int)fy0 + 1 : 0;
  const bool in00 = inx0 && iny0, in10 = inx1 && iny0;
  const bool in01 = inx0 && iny1, in11 = inx1 && iny1;
  const long long o00 = (long long)iy0 * W + ix0, o10 = (long long)iy0 * W + ix1;
  const long long o01 = (long long)iy1 * W + ix0, o11 = (long long)iy1 * W + ix1;
  const float w00 = __fmul_rn(wx0, wy0), w10 = __fmul_rn(wx1, wy0);
  const float w01 = __fmul_rn(wx0, wy1), w11 = __fmul_rn(wx1, wy1);

  const T* img = images + n * C * plane;
  float gx = 0.f, gy = 0.f;
  for (int c = 0; c < C; ++c) {
    const T* ch = img + c * plane;
    const float v00 = in00 ? sweep::load(ch + o00) : 0.f;
    const float v10 = in10 ? sweep::load(ch + o10) : 0.f;
    const float v01 = in01 ? sweep::load(ch + o01) : 0.f;
    const float v11 = in11 ? sweep::load(ch + o11) : 0.f;
    const long long o = (n * C + c) * plane + p;
    if (MODE == kValues || MODE == kJacobian) {
      float v = __fmul_rn(v00, w00);
      v = __fadd_rn(v, __fmul_rn(v10, w10));
      v = __fadd_rn(v, __fmul_rn(v01, w01));
      v = __fadd_rn(v, __fmul_rn(v11, w11));
      out[o] = v;
    }
    // dout/dX = (v10 - v00) wy0 + (v11 - v01) wy1, and the same in y.
    const float dx = __fadd_rn(__fmul_rn(__fsub_rn(v10, v00), wy0),
                               __fmul_rn(__fsub_rn(v11, v01), wy1));
    const float dy = __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), wx0),
                               __fmul_rn(__fsub_rn(v11, v10), wx1));
    if (MODE == kJacobian) {
      jx[o] = dx;
      jy[o] = dy;
    }
    if (MODE == kGradient) {
      const float g = __ldg(cot + o);
      gx = __fadd_rn(gx, __fmul_rn(g, dx));
      gy = __fadd_rn(gy, __fmul_rn(g, dy));
    }
  }
  if (MODE == kGradient) {
    out[(n * 2) * plane + p] = gx;
    out[(n * 2 + 1) * plane + p] = gy;
  }
}

template <typename T>
int launch(const void* images, const float* xs, const float* ys, const float* cot, float* out,
           float* jx, float* jy, int N, int C, int H, int W, int mode, cudaStream_t s) {
  const long long total = (long long)N * H * W;
  if (total <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(THREADS);
  const T* src = static_cast<const T*>(images);
  switch (mode) {
    case kValues:
      grid_warp_kernel<T, kValues><<<grid, block, 0, s>>>(src, xs, ys, cot, out, jx, jy,
                                                          total, C, H, W);
      break;
    case kJacobian:
      grid_warp_kernel<T, kJacobian><<<grid, block, 0, s>>>(src, xs, ys, cot, out, jx, jy,
                                                            total, C, H, W);
      break;
    case kGradient:
      grid_warp_kernel<T, kGradient><<<grid, block, 0, s>>>(src, xs, ys, cot, out, jx, jy,
                                                            total, C, H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0: out = warp; 1: out, jx, jy = warp and its Jacobian; 2: out (N, 2,
// H, W) = the coordinate gradient of sum(warp * cot). images are float32
// (images_bf16 == 0) or bf16 (1). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int grid_warp_launch(const void* images, const float* xs, const float* ys, const float* cot,
                     float* out, float* jx, float* jy, int N, int C, int H, int W, int mode,
                     int images_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (images_bf16)
    return launch<__nv_bfloat16>(images, xs, ys, cot, out, jx, jy, N, C, H, W, mode, s);
  return launch<float>(images, xs, ys, cot, out, jx, jy, N, C, H, W, mode, s);
}

const char* grid_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
