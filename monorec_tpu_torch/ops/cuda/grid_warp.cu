// Bilinear loss warp at absolute pixel coordinates for Hopper (sm_90a), with
// its coordinate Jacobian and its cotangent contraction.
//
// Replaces the TPU kernel monorec_tpu/ops/pallas/grid_warp.py (grid_warp,
// grid_warp_jac, grid_warp_grad; body _warp_kernel). Ports its contract, not
// its machinery: the band DMA, the row-aligned slab, the per-lane shear, the
// KY / R_MAX tap windows and the per-block bounds exist because the TPU has
// no vector gather. Hopper has one, so every output pixel gathers its four
// taps directly from global memory through the read-only cache, with
// unlimited reach, and no pixel is left uncovered: nothing counts coverage.
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
// What bounds it: bytes. Per pixel it reads two coordinates and 4 * C
// scattered taps (neighbouring threads read neighbouring source pixels for
// smooth warps, so the L1/L2 absorb most of them) and writes C (values),
// 3 C (Jacobian) or 2 (gradient) float32 values; the arithmetic is ~12 to
// 32 operations per value. The design moves those bytes in as few, as wide
// and as cheap instructions as it can:
//   * a 2-D grid (pixel blocks x images): no 64-bit division or modulo per
//     thread, and 32-bit offsets inside an image (the wrapper checks that
//     C * H * W fits);
//   * four neighbouring pixels per thread: where H * W is a multiple of 4
//     and every tensor is 16-byte aligned, the coordinates, cotangents and
//     outputs move as float4 (one 16-byte access per thread and channel),
//     and the 16 tap gathers of a channel are independent loads in flight
//     together; a ragged image takes the same code with scalar accesses;
//   * the coordinates and tap weights computed once per pixel and reused for
//     every channel.
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

constexpr int THREADS = 128;
constexpr int VEC = 4;  // neighbouring pixels per thread

enum Mode { kValues = 0, kJacobian = 1, kGradient = 2 };

// VEC values at p (VECTOR: one aligned float4 load), or fewer at the ragged
// end of a plane (those past `count` read `fill`).
template <bool VECTOR>
__device__ __forceinline__ void load_vec(const float* p, int count, float fill, float (&v)[VEC]) {
  if (VECTOR) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = i < count ? __ldg(p + i) : fill;
  }
}

template <bool VECTOR>
__device__ __forceinline__ void store_vec(float* p, int count, const float (&v)[VEC]) {
  if (VECTOR) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < count) p[i] = v[i];
  }
}

template <typename T, int MODE, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
grid_warp_kernel(const T* __restrict__ images,      // (N, C, H, W)
                 const float* __restrict__ xs,      // (N, H, W)
                 const float* __restrict__ ys,      // (N, H, W)
                 const float* __restrict__ cot,     // (N, C, H, W), gradient mode
                 float* __restrict__ out,           // (N, C, H, W) or (N, 2, H, W)
                 float* __restrict__ jx,            // (N, C, H, W), Jacobian mode
                 float* __restrict__ jy,            // (N, C, H, W), Jacobian mode
                 int C, int H, int W) {
  const int plane = H * W;
  const int p = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (p >= plane) return;
  const int count = min(VEC, plane - p);
  const size_t n = blockIdx.y;

  // Per pixel: the four taps' offsets, inside flags and weights. NaN
  // coordinates (also the fill past a ragged end) fail every test and
  // sample zero.
  float X[VEC], Y[VEC];
  load_vec<VECTOR>(xs + n * plane + p, count, __int_as_float(0x7fc00000), X);
  load_vec<VECTOR>(ys + n * plane + p, count, __int_as_float(0x7fc00000), Y);
  int off[VEC][4];
  bool in[VEC][4];
  float wx0[VEC], wx1[VEC], wy0[VEC], wy1[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float fx0 = floorf(X[i]), fy0 = floorf(Y[i]);
    wx1[i] = __fsub_rn(X[i], fx0), wy1[i] = __fsub_rn(Y[i], fy0);
    wx0[i] = __fsub_rn(1.f, wx1[i]), wy0[i] = __fsub_rn(1.f, wy1[i]);
    const bool inx0 = fx0 >= 0.f && fx0 <= (float)(W - 1);
    const bool inx1 = fx0 + 1.f >= 0.f && fx0 + 1.f <= (float)(W - 1);
    const bool iny0 = fy0 >= 0.f && fy0 <= (float)(H - 1);
    const bool iny1 = fy0 + 1.f >= 0.f && fy0 + 1.f <= (float)(H - 1);
    // Integer offsets only for taps that are inside (huge floats never cast).
    const int ix0 = inx0 ? (int)fx0 : 0, ix1 = inx1 ? (int)fx0 + 1 : 0;
    const int iy0 = iny0 ? (int)fy0 : 0, iy1 = iny1 ? (int)fy0 + 1 : 0;
    in[i][0] = inx0 && iny0, in[i][1] = inx1 && iny0;
    in[i][2] = inx0 && iny1, in[i][3] = inx1 && iny1;
    off[i][0] = iy0 * W + ix0, off[i][1] = iy0 * W + ix1;
    off[i][2] = iy1 * W + ix0, off[i][3] = iy1 * W + ix1;
  }

  const T* img = images + n * C * plane;
  float gx[VEC], gy[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) gx[i] = gy[i] = 0.f;
  for (int c = 0; c < C; ++c) {
    const T* ch = img + c * plane;
    float v[VEC][4];
#pragma unroll
    for (int i = 0; i < VEC; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) v[i][t] = in[i][t] ? sweep::load(ch + off[i][t]) : 0.f;
    const size_t o = (n * C + c) * plane + p;
    float val[VEC], dx[VEC], dy[VEC], g[VEC];
    if (MODE == kGradient) load_vec<VECTOR>(cot + o, count, 0.f, g);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float w00 = __fmul_rn(wx0[i], wy0[i]), w10 = __fmul_rn(wx1[i], wy0[i]);
      const float w01 = __fmul_rn(wx0[i], wy1[i]), w11 = __fmul_rn(wx1[i], wy1[i]);
      val[i] = __fmul_rn(v[i][0], w00);
      val[i] = __fadd_rn(val[i], __fmul_rn(v[i][1], w10));
      val[i] = __fadd_rn(val[i], __fmul_rn(v[i][2], w01));
      val[i] = __fadd_rn(val[i], __fmul_rn(v[i][3], w11));
      // dout/dX = (v10 - v00) wy0 + (v11 - v01) wy1, and the same in y.
      dx[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i][1], v[i][0]), wy0[i]),
                        __fmul_rn(__fsub_rn(v[i][3], v[i][2]), wy1[i]));
      dy[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i][2], v[i][0]), wx0[i]),
                        __fmul_rn(__fsub_rn(v[i][3], v[i][1]), wx1[i]));
      if (MODE == kGradient) {
        gx[i] = __fadd_rn(gx[i], __fmul_rn(g[i], dx[i]));
        gy[i] = __fadd_rn(gy[i], __fmul_rn(g[i], dy[i]));
      }
    }
    if (MODE == kValues || MODE == kJacobian) store_vec<VECTOR>(out + o, count, val);
    if (MODE == kJacobian) {
      store_vec<VECTOR>(jx + o, count, dx);
      store_vec<VECTOR>(jy + o, count, dy);
    }
  }
  if (MODE == kGradient) {
    store_vec<VECTOR>(out + (n * 2) * plane + p, count, gx);
    store_vec<VECTOR>(out + (n * 2 + 1) * plane + p, count, gy);
  }
}

template <typename T, bool VECTOR>
int launch(const void* images, const float* xs, const float* ys, const float* cot, float* out,
           float* jx, float* jy, int N, int C, int H, int W, int mode, cudaStream_t s) {
  const long long plane = (long long)H * W;
  if (N <= 0 || N > 65535 || C <= 0 || plane <= 0 || C * plane > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((plane + THREADS * VEC - 1) / (THREADS * VEC)), N), block(THREADS);
  const T* src = static_cast<const T*>(images);
#define GW_LAUNCH(MODE)                                                                   \
  grid_warp_kernel<T, MODE, VECTOR><<<grid, block, 0, s>>>(src, xs, ys, cot, out, jx, jy, C, H, W)
  switch (mode) {
    case kValues: GW_LAUNCH(kValues); break;
    case kJacobian: GW_LAUNCH(kJacobian); break;
    case kGradient: GW_LAUNCH(kGradient); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GW_LAUNCH
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0; }

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
  const bool vector = (long long)H * W % VEC == 0 && aligned16(xs) && aligned16(ys) &&
                      aligned16(cot) && aligned16(out) && aligned16(jx) && aligned16(jy);
  if (images_bf16)
    return vector ? launch<__nv_bfloat16, true>(images, xs, ys, cot, out, jx, jy, N, C, H, W,
                                                mode, s)
                  : launch<__nv_bfloat16, false>(images, xs, ys, cot, out, jx, jy, N, C, H, W,
                                                 mode, s);
  return vector ? launch<float, true>(images, xs, ys, cot, out, jx, jy, N, C, H, W, mode, s)
                : launch<float, false>(images, xs, ys, cot, out, jx, jy, N, C, H, W, mode, s);
}

const char* grid_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
