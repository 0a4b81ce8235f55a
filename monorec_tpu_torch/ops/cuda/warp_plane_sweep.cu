// Plane-sweep warp for Hopper (sm_90a): every source image warped over its D
// hypothesis homographies, with the warped border indicator.
//
// Replaces the TPU kernel monorec_tpu/ops/pallas/warp_kernel.py::
// warp_plane_sweep (bodies _warp_kernel, _one_depth). Ports its contract, not
// its machinery: the band DMA, the one-hot permutation matmuls, the KY / KX
// tap windows and the depth chunks exist because the TPU has no vector
// gather. Hopper has one, so each output pixel gathers its four taps
// directly, with unlimited reach: coverage is always zero (written by the
// Python wrapper). It serves the cost volumes that the fused scoring K1
// cannot (sfcv_mult_mask=False, another patch size or channel count), whose
// scoring needs the warped values themselves.
//
// Per output pixel p = (x, y) of image n and hypothesis d: the displacement
// of p under homs[n, d] and its bilinear footprint (sweep_common.cuh, the
// code K1 uses: float64 homographies, float32 displacements from M - I);
// taps outside the image are skipped, so a sample with no tap inside is
// exactly 0.0; the taps are summed in the plain version's order with every
// operation rounded on its own (no FMA contraction), so the warped values
// equal the plain PyTorch version's (ops/plane_sweep.py::_gather_bilinear)
// bit for bit. The sfcv_mult_mask=False rule tests warped != 0 and
// warped == keyframe, where exact values matter. The border mask is the
// same bilinear warp of the indicator border_radius <= tap < size -
// border_radius. Sources are float32 or bf16 (converted on load); the
// warped stack has the sources' type, bf16 rounded to nearest even from the
// float32 sums; the mask is float32.
//
// What bounds it: the writes. Per (n, d) it stores C + 1 planes
// (N * D * (C + 1) * H * W * 4 bytes at float32: 1.07 GB at N=16, D=32, C=3,
// 256x512) and reads 4 * C taps per pixel, which neighbouring threads share
// through L1/L2 for smooth warps. One thread per output pixel: the
// displacement and the weights are computed once and reused for every
// channel, and consecutive threads write consecutive pixels.
//
// Grid: (ceil(H * W / THREADS), D, N).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
warp_plane_sweep_kernel(const T* __restrict__ images,     // (N, C, H, W)
                        const double* __restrict__ homs,  // (N, D, 3, 3), m22 == 1
                        T* __restrict__ warped,           // (N, D, C, H, W)
                        float* __restrict__ wmask,        // (N, D, H, W)
                        int C, int D, int H, int W, int border_radius) {
  const long long plane = (long long)H * W;
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= plane) return;
  const int d = blockIdx.y, n = blockIdx.z;
  const int y = (int)(p / W), x = (int)(p - (long long)y * W);
  const long long nd = (long long)n * D + d;

  const sweep::Hom hom = sweep::load_hom(homs + nd * 9);
  float dx, dy;
  sweep::displacement(hom, (float)x, (float)y, dx, dy);
  const sweep::Footprint fp = sweep::footprint((float)x, (float)y, dx, dy, H, W);

  bool inside[4];
  long long off[4];
  float b = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int tx = fp.xi + (t & 1), ty = fp.yi + (t >> 1);
    inside[t] = fp.near && tx >= 0 && tx <= W - 1 && ty >= 0 && ty <= H - 1;
    off[t] = inside[t] ? (long long)ty * W + tx : 0;
    if (fp.near && tx >= border_radius && tx < W - border_radius && ty >= border_radius &&
        ty < H - border_radius)
      b = __fadd_rn(b, fp.w[t]);
  }
  wmask[nd * plane + p] = b;

  const T* img = images + (long long)n * C * plane;
  T* out = warped + nd * C * plane + p;
  for (int c = 0; c < C; ++c) {
    const T* ch = img + c * plane;
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (inside[t]) v = __fadd_rn(v, __fmul_rn(sweep::load(ch + off[t]), fp.w[t]));
    sweep::store(out + c * plane, v);
  }
}

template <typename T>
int launch(const void* images, const double* homs, void* warped, float* wmask, int N, int C,
           int D, int H, int W, int border_radius, cudaStream_t s) {
  const long long plane = (long long)H * W;
  if (N <= 0 || C <= 0 || D <= 0 || plane <= 0 || N > 65535 || D > 65535)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (plane + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, D, N), block(THREADS);
  warp_plane_sweep_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(images), homs, static_cast<T*>(warped), wmask, C, D, H, W,
      border_radius);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// images and warped are float32 (images_bf16 == 0) or bf16 (1). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int warp_plane_sweep_launch(const void* images, const double* homs, void* warped, float* wmask,
                            int N, int C, int D, int H, int W, int border_radius,
                            int images_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (images_bf16)
    return launch<__nv_bfloat16>(images, homs, warped, wmask, N, C, D, H, W, border_radius, s);
  return launch<float>(images, homs, warped, wmask, N, C, D, H, W, border_radius, s);
}

const char* warp_plane_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
