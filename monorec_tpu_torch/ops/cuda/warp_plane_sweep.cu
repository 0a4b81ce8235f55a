// Plane-sweep warp for Hopper (sm_90a): every source image warped over its D
// hypothesis homographies, with the warped border indicator.
//
// Replaces the TPU kernel monorec_tpu/ops/pallas/warp_kernel.py::
// warp_plane_sweep (bodies _warp_kernel, _one_depth). Ports its contract, not
// its machinery: the band DMA, the one-hot permutation matmuls, the KY / KX
// tap windows and the depth chunks exist because the TPU has no vector
// gather. Hopper has one, so each output pixel gathers its four taps
// directly, with unlimited reach, and no pixel is left uncovered: nothing
// counts coverage. It serves the cost volumes that the fused scoring K1
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
// What bounds it: the writes, N * D * (C + 1) * H * W elements (1.07 GB at
// float32, N=16, D=32, C=3, 256x512), against ~56 float32 operations per
// pixel. The first port was instead bound by the instructions it executed
// per pixel: a 64-bit division for the row, the homography reloaded and
// converted from float64, and tap gathers spread over four cache lines per
// warp instruction; its bf16 stack, with 38% fewer bytes, was no faster.
// The design cuts each:
//   * Grid (W-chunks, H / ROWS, N * D): a block covers ROWS rows of a
//     4 * THREADS-pixel chunk of one (n, d), so y comes from the block index
//     and nothing is divided per pixel; offsets inside an image are 32-bit.
//     N * D larger than the grid's z limit is walked by a loop. Blocks
//     launch row by row and hypothesis by hypothesis of one image, so that
//     image's source stays in L2 while its D warps read it.
//   * M - I is converted once per block into shared memory; each thread
//     hoists the products of the row (a01 y, a11 y, a21 y) and keeps the
//     plain version's rounding order for everything else (the two IEEE
//     divisions stay: a reciprocal would not be bit-equal).
//   * Each thread takes four pixels of the row, THREADS apart, so every
//     warp instruction gathers and stores 32 neighbouring pixels: a tap
//     load touches one or two cache lines, not four, and every store writes
//     whole lines (so the scalar stores need no alignment and no ragged-edge
//     path). The stores are streaming (evict-first), so the 1 GB of output
//     does not push the sources the gathers reread out of L2.
//   * For C == 3 the wrapper passes the sources interleaved into one texel
//     per pixel (a 16-byte float4, or 8 bytes of bf16; a packing pass of
//     ~60 MB first), so a tap is one load, not three; other channel counts
//     gather from the planes. Both layouts give the same bits; at N=16,
//     D=32, 3x256x512 the packed one is faster (chip_smoke.py, phase 13).
//   * A pixel keeps its tap 0 offset, a 4-bit inside mask and its two
//     fractions between the footprint and the gathers (the tap weights are
//     formed again there, rounded alike): no instantiation spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int VEC = 4;  // pixels per thread, THREADS apart in one row
constexpr int ROW_CHUNK = THREADS * VEC;
constexpr int ROWS = 4;  // rows per block and (n, d)
constexpr int MAX_GRID_Z = 65535;

// A streaming store of one output value in the output type.
__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// The four tap weights of fractions (wx1, wy1), rounded as
// sweep::footprint rounds them.
__device__ __forceinline__ void tap_weights(float wx1, float wy1, float (&w)[4]) {
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  w[0] = __fmul_rn(wx0, wy0);
  w[1] = __fmul_rn(wx1, wy0);
  w[2] = __fmul_rn(wx0, wy1);
  w[3] = __fmul_rn(wx1, wy1);
}

// ROWS rows of a row chunk of one (n, d) per block and iteration. PACKED:
// the taps read texels (C == 3), else the C source planes.
template <typename T, bool PACKED>
__global__ void __launch_bounds__(THREADS)
warp_plane_sweep_kernel(const T* __restrict__ images,  // (N, C, H, W)
                        const typename sweep::Texel<T>::type* __restrict__ texels,  // (N, H, W)
                        const double* __restrict__ homs,  // (N, D, 3, 3), m22 == 1
                        T* __restrict__ warped,           // (N, D, C, H, W)
                        float* __restrict__ wmask,        // (N, D, H, W)
                        int C, int D, int ND, int H, int W, int border_radius) {
  __shared__ sweep::Hom hom_s;
  const int plane = H * W;
  const int x_base = blockIdx.x * ROW_CHUNK + threadIdx.x;
  const int y_end = min(H, (int)(blockIdx.y + 1) * ROWS);
  for (int nd = blockIdx.z; nd < ND; nd += gridDim.z) {
    if (threadIdx.x == 0) hom_s = sweep::load_hom(homs + (size_t)nd * 9);
    __syncthreads();
    const sweep::Hom a = hom_s;
    __syncthreads();  // every thread holds its copy before the next nd's load
    const int n = nd / D;
#pragma unroll 1
    for (int y = blockIdx.y * ROWS; y < y_end; ++y) {
      // The row's products, hoisted: the same roundings as
      // sweep::displacement, in the same order.
      const float fy = (float)y;
      const float t01 = __fmul_rn(a.a01, fy), t11 = __fmul_rn(a.a11, fy);
      const float t21 = __fmul_rn(a.a21, fy);

      // Per pixel: tap 0's offset, which taps lie inside (bit t), and the
      // fractions; the weights are formed again where the taps are summed.
      int off[VEC];
      unsigned inside[VEC];
      float wx1[VEC], wy1[VEC], b[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int x = x_base + i * THREADS;
        const float fx = (float)x;
        const float e = __fadd_rn(__fadd_rn(__fmul_rn(a.a20, fx), t21), 1e-7f);
        const float den = __fadd_rn(1.f, e);
        const float dx = __fdiv_rn(
            __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.a00, fx), t01), a.a02), __fmul_rn(fx, e)),
            den);
        const float dy = __fdiv_rn(
            __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.a10, fx), t11), a.a12), __fmul_rn(fy, e)),
            den);
        const sweep::Footprint fp = sweep::footprint(fx, fy, dx, dy, H, W);
        const bool live = fp.near && x < W;
        off[i] = fp.yi * W + fp.xi;
        wx1[i] = __fsub_rn(dx, floorf(dx));
        wy1[i] = __fsub_rn(dy, floorf(dy));
        inside[i] = 0;
        b[i] = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int tx = fp.xi + (t & 1), ty = fp.yi + (t >> 1);
          if (live && tx >= 0 && tx <= W - 1 && ty >= 0 && ty <= H - 1) inside[i] |= 1u << t;
          if (live && tx >= border_radius && tx < W - border_radius && ty >= border_radius &&
              ty < H - border_radius)
            b[i] = __fadd_rn(b[i], fp.w[t]);
        }
      }
      float* mrow = wmask + (size_t)nd * plane + y * W + x_base;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (x_base + i * THREADS < W) __stcs(mrow + i * THREADS, b[i]);

      T* orow = warped + (size_t)nd * C * plane + y * W + x_base;
      if constexpr (PACKED) {
        const typename sweep::Texel<T>::type* tex = texels + (size_t)n * plane;
        float v[VEC][3];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float w[4];
          tap_weights(wx1[i], wy1[i], w);
          v[i][0] = v[i][1] = v[i][2] = 0.f;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (inside[i] >> t & 1u) {
              float s[3];
              sweep::unpack(__ldg(tex + off[i] + (t & 1) + (t >> 1) * W), s);
#pragma unroll
              for (int k = 0; k < 3; ++k) v[i][k] = __fadd_rn(v[i][k], __fmul_rn(s[k], w[t]));
            }
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            if (x_base + i * THREADS < W) store_cs(orow + k * plane + i * THREADS, v[i][k]);
      } else {
        const T* img = images + (size_t)n * C * plane;
        for (int c = 0; c < C; ++c) {
          const T* ch = img + c * plane;
          float v[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float w[4];
            tap_weights(wx1[i], wy1[i], w);
            v[i] = 0.f;
#pragma unroll
            for (int t = 0; t < 4; ++t)
              if (inside[i] >> t & 1u)
                v[i] = __fadd_rn(
                    v[i], __fmul_rn(sweep::load(ch + off[i] + (t & 1) + (t >> 1) * W), w[t]));
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            if (x_base + i * THREADS < W) store_cs(orow + c * plane + i * THREADS, v[i]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* images, const double* homs, void* texels, void* warped, float* wmask,
           int N, int C, int D, int H, int W, int border_radius, cudaStream_t s) {
  const long long plane = (long long)H * W;
  if (N <= 0 || C <= 0 || D <= 0 || H <= 0 || W <= 0 || N > 65535 || H > 65535 ||
      (long long)C * plane > 0x7fffffffLL || (long long)N * D > 0x7fffffffLL ||
      (texels != nullptr && C != 3))
    return (int)cudaErrorInvalidValue;
  using Tex = typename sweep::Texel<T>::type;
  const T* src = static_cast<const T*>(images);
  T* out = static_cast<T*>(warped);
  const int nd = N * D;
  const dim3 grid((W + ROW_CHUNK - 1) / ROW_CHUNK, (H + ROWS - 1) / ROWS,
                  nd < MAX_GRID_Z ? nd : MAX_GRID_Z);
  if (texels != nullptr) {
    Tex* tex = static_cast<Tex*>(texels);
    const dim3 pack_grid((unsigned)((plane + THREADS - 1) / THREADS), N);
    sweep::pack_texels<T, THREADS><<<pack_grid, THREADS, 0, s>>>(src, tex, (int)plane);
    warp_plane_sweep_kernel<T, true><<<grid, THREADS, 0, s>>>(src, tex, homs, out, wmask, C, D,
                                                              nd, H, W, border_radius);
  } else {
    warp_plane_sweep_kernel<T, false><<<grid, THREADS, 0, s>>>(src, nullptr, homs, out, wmask, C,
                                                               D, nd, H, W, border_radius);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// images and warped are float32 (images_bf16 == 0) or bf16 (1). texels is
// the wrapper's (N, H, W, 4) scratch in the images' dtype for C == 3, into
// which the sources are packed first, or null for planar gathers. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int warp_plane_sweep_launch(const void* images, const double* homs, void* texels, void* warped,
                            float* wmask, int N, int C, int D, int H, int W, int border_radius,
                            int images_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (images_bf16)
    return launch<__nv_bfloat16>(images, homs, texels, warped, wmask, N, C, D, H, W,
                                 border_radius, s);
  return launch<float>(images, homs, texels, warped, wmask, N, C, D, H, W, border_radius, s);
}

const char* warp_plane_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
