// Device code shared by the gather kernels: source loads in float32 or bf16
// (K2 grid_warp.cu, K4 warp_plane_sweep.cu), and for the plane-sweep kernels
// K1 and K4 the three-channel source texels and their packing pass, the
// displacement of a pixel under a homography and its bilinear footprint.
//
// Coordinates: the homographies arrive in float64 (m22 == 1). A kernel takes
// M - I from them once per hypothesis, then evaluates in float32 the
// DISPLACEMENT of each pixel, d = (M p)_xy / (M p)_z - p, whose floor and
// fraction give the bilinear taps and weights. A float32 source coordinate
// near x = 500 resolves only ~3e-5 px, and float32 entries of M near 1 carry
// ~6e-8 each, x500; the displacement is tens of pixels and keeps ~1e-5 px
// (measured against float64 at 256x512 on an H100: 8e-6 px max vs 8e-5 px
// for xs = (M p)_x / (M p)_z in float32).
//
// Every operation here is rounded on its own (__fmul_rn, __fadd_rn, ...: no
// FMA contraction), in the order of the plain PyTorch version
// (ops/plane_sweep.py::_displacements and _gather_bilinear), so a kernel
// that sums its taps the same way reproduces the plain version bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sweep {

// A source value as float32; bf16 converts exactly.
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// One source pixel's 3 channels, interleaved and padded to one 16-byte
// (float32) or 8-byte (bf16: the bit patterns, channel 0 in the low half of
// x) word, so that a bilinear tap is one load instead of three.
template <typename T>
struct Texel;
template <>
struct Texel<float> {
  using type = float4;
};
template <>
struct Texel<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 make_texel(float a, float b, float c) {
  return make_float4(a, b, c, 0.f);
}
__device__ __forceinline__ uint2 make_texel(__nv_bfloat16 a, __nv_bfloat16 b, __nv_bfloat16 c) {
  return make_uint2((unsigned)__bfloat16_as_ushort(a) | (unsigned)__bfloat16_as_ushort(b) << 16,
                    (unsigned)__bfloat16_as_ushort(c));
}
// A texel's channels as float32 (bf16 converts exactly).
__device__ __forceinline__ void unpack(const float4& q, float (&v)[3]) {
  v[0] = q.x, v[1] = q.y, v[2] = q.z;
}
__device__ __forceinline__ void unpack(const uint2& q, float (&v)[3]) {
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
}

// (N, 3, H, W) sources -> (N, H, W) texels. Grid: (ceil(H W / THREADS), N).
template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
pack_texels(const T* __restrict__ images, typename Texel<T>::type* __restrict__ texels,
            int plane) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= plane) return;
  const size_t n = blockIdx.y;
  const T* img = images + n * 3 * plane + p;
  texels[n * plane + p] = make_texel(img[0], img[plane], img[2 * plane]);
}

// M - I of one (3, 3) homography, in float32 (m22 is not read).
struct Hom {
  float a00, a01, a02, a10, a11, a12, a20, a21;
};

__device__ __forceinline__ Hom load_hom(const double* m) {
  Hom a;
  a.a00 = (float)(__ldg(m + 0) - 1.0);
  a.a01 = (float)__ldg(m + 1);
  a.a02 = (float)__ldg(m + 2);
  a.a10 = (float)__ldg(m + 3);
  a.a11 = (float)(__ldg(m + 4) - 1.0);
  a.a12 = (float)__ldg(m + 5);
  a.a20 = (float)__ldg(m + 6);
  a.a21 = (float)__ldg(m + 7);
  return a;
}

// Displacement of pixel (fx, fy): with e = (M p)_z - 1,
// d = ((M - I) p + m_2 - p e) / (1 + e).
__device__ __forceinline__ void displacement(const Hom& a, float fx, float fy, float& dx,
                                             float& dy) {
  const float e = __fadd_rn(__fadd_rn(__fmul_rn(a.a20, fx), __fmul_rn(a.a21, fy)), 1e-7f);
  const float den = __fadd_rn(1.f, e);
  dx = __fdiv_rn(__fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.a00, fx), __fmul_rn(a.a01, fy)), a.a02),
                           __fmul_rn(fx, e)),
                 den);
  dy = __fdiv_rn(__fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.a10, fx), __fmul_rn(a.a11, fy)), a.a12),
                           __fmul_rn(fy, e)),
                 den);
}

// The 2x2 taps of pixel (fx, fy) displaced by (dx, dy): tap t lies at
// (xi + (t & 1), yi + (t >> 1)) with weight w[t], in the order (x0,y0),
// (x1,y0), (x0,y1), (x1,y1). `near` is false when no tap can lie inside the
// image (NaN and far-away coordinates included); xi, yi are 0 then, and the
// caller reads no tap.
struct Footprint {
  bool near;
  int xi, yi;
  float w[4];
};

__device__ __forceinline__ Footprint footprint(float fx, float fy, float dx, float dy, int H,
                                               int W) {
  Footprint f;
  const float fdx = floorf(dx), fdy = floorf(dy);
  const float xf = __fadd_rn(fx, fdx), yf = __fadd_rn(fy, fdy);  // integer-valued
  f.near = xf >= -1.f && xf <= (float)(W - 1) && yf >= -1.f && yf <= (float)(H - 1);
  f.xi = f.near ? (int)xf : 0;
  f.yi = f.near ? (int)yf : 0;
  const float wx1 = __fsub_rn(dx, fdx), wy1 = __fsub_rn(dy, fdy);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  f.w[0] = __fmul_rn(wx0, wy0);
  f.w[1] = __fmul_rn(wx1, wy0);
  f.w[2] = __fmul_rn(wx0, wy1);
  f.w[3] = __fmul_rn(wx1, wy1);
  return f;
}

}  // namespace sweep
