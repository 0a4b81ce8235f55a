// The epilogue of the U-Nets' convolutions for Hopper (sm_90a): per-channel
// bias and LeakyReLU in one pass, and its backward with the bias gradient.
//
// Replaces no TPU kernel. The JAX package leaves the bias and activation to
// XLA, which fuses them into the convolution; cuDNN's float32 convolutions
// take no bias, and ATen would add it in a broadcast pass of its own and run
// the activation in another. This kernel is that work in one read and one
// write of the convolution's output:
//
//   out[n, c, i, j] = act(y[n, c, top + i, left + j] + bias[c]),
//   act(v) = v > 0 ? v : v * slope
//
// with slope 0.1 after an activated convolution and 1 (the identity, v * 1
// == v bit for bit) after one that is not. The window (top, left, h, w) of
// the (Hy, Wy) input plane takes the rows and columns that a layer keeps
// (all but the leading output row and column that an implicitly padded
// k=2 convolution adds); without one the window is the whole plane. The
// output is always contiguous (N, C, h, w).
//
// Backward, from g = dL/d out and out itself: d = out > 0 ? g : g * slope
// (out > 0 exactly where the pre-activation is, for a positive slope, so at a
// pre-activation of exactly 0 it takes the slope, as torch's LeakyReLU
// does), written into the (Hy, Wy) gradient of y with zeros outside the
// window, and dL/d bias[c] = the sum of d over n and the window. Each block
// sums its chunk of one plane in a fixed order and writes the sum; a second
// kernel sums a channel's partials over (n, chunk) in a fixed order, so the
// bias gradient is the same on every run (no float atomics).
//
// The arithmetic is ATen's, operation for operation: the float32 add (in
// bf16: the add in float32, rounded to bf16, as `add_` on a bf16 tensor),
// then for a non-positive sum the float32 multiply by the slope, rounded to
// the tensor's type (`leaky_relu` and its backward). So the forward is
// bit-equal to `y + bias` then `leaky_relu`, and the gradient of y to
// autograd's; the bias gradient differs from ATen's reduction in its order.
//
// What bounds it: bytes. A forward reads y and writes out once (the bias is
// one load a block), a backward reads g and out and writes the gradient; a
// few operations an element. Whole-plane windows move as 16-byte vectors
// (4 float32 or 8 bf16 values a thread) where the plane's size is a
// multiple of the vector and the tensors start on 16-byte boundaries; a
// cropped window's rows start off the vector grid and move element by
// element. A block takes CHUNK elements of one (n, c) plane, 16 a thread,
// all loaded before any is stored so that they are in flight together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;  // elements of one plane a block
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// act(x + b) in the tensor's type, rounded where ATen rounds.
template <typename T>
__device__ __forceinline__ T bias_act(T x, float b, float slope) {
  const float v = to_float(from_float<T>(__fadd_rn(to_float(x), b)));
  return v > 0.f ? from_float<T>(v) : from_float<T>(__fmul_rn(v, slope));
}

// The gradient through act, from the output.
template <typename T>
__device__ __forceinline__ T act_grad(T g, T out, float slope) {
  const float gf = to_float(g);
  return to_float(out) > 0.f ? g : from_float<T>(__fmul_rn(gf, slope));
}

// One 16-byte access: 4 float32 or 8 bf16 values (element 0 in the low
// half of the first word).
__device__ __forceinline__ void load_pack(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load_pack(const __nv_bfloat16* p, __nv_bfloat16 (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __ushort_as_bfloat16((unsigned short)(words[k] & 0xffffu));
    v[2 * k + 1] = __ushort_as_bfloat16((unsigned short)(words[k] >> 16));
  }
}
__device__ __forceinline__ void store_pack(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_pack(__nv_bfloat16* p, const __nv_bfloat16 (&v)[8]) {
  unsigned words[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    words[k] = (unsigned)__bfloat16_as_ushort(v[2 * k]) |
               (unsigned)__bfloat16_as_ushort(v[2 * k + 1]) << 16;
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of `v` over its threads, in a fixed order, in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[WARPS];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  v = lane < WARPS ? warps[lane] : 0.f;
  return warp == 0 ? warp_sum(v) : 0.f;
}

struct Window {
  int Hy, Wy;       // the input plane
  int top, left;    // the window's first row and column in it
  int h, w;         // the window (= the output plane)
};


// Whole-plane forward: VEC elements an access (1 where the plane or a
// pointer is off the 16-byte grid).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
fwd_plane_kernel(const T* __restrict__ y, const T* __restrict__ bias, T* __restrict__ out,
                 int C, int hw, float slope) {
  constexpr int UNROLL = PER_THREAD / VEC;
  const size_t plane = blockIdx.x;
  const float b = to_float(bias[plane % C]);
  const T* src = y + plane * hw;
  T* dst = out + plane * hw;
  const int start = blockIdx.y * CHUNK;
  T v[UNROLL][VEC];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = start + (u * THREADS + threadIdx.x) * VEC;
    if (i < hw) {
      if constexpr (VEC > 1) {
        load_pack(src + i, v[u]);
      } else {
        v[u][0] = src[i];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = start + (u * THREADS + threadIdx.x) * VEC;
    if (i < hw) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[u][k] = bias_act(v[u][k], b, slope);
      if constexpr (VEC > 1) {
        store_pack(dst + i, v[u]);
      } else {
        dst[i] = v[u][0];
      }
    }
  }
}

// Windowed forward: element i of the output plane is row i / w, column
// i % w of the window.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_window_kernel(const T* __restrict__ y, const T* __restrict__ bias, T* __restrict__ out,
                  int C, Window win, float slope) {
  const size_t plane = blockIdx.x;
  const float b = to_float(bias[plane % C]);
  const int hw = win.h * win.w;
  const T* src = y + plane * win.Hy * win.Wy + win.top * win.Wy + win.left;
  T* dst = out + plane * hw;
  const int start = blockIdx.y * CHUNK;
  T v[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int i = start + u * THREADS + threadIdx.x;
    if (i < hw) {
      const int r = i / win.w;
      v[u] = src[r * win.Wy + (i - r * win.w)];
    }
  }
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int i = start + u * THREADS + threadIdx.x;
    if (i < hw) dst[i] = bias_act(v[u], b, slope);
  }
}

// Whole-plane backward: the block's partial bias gradient and, where ACT,
// the gradient of y (without an activation it is g itself, and out is not
// read).
template <typename T, int VEC, bool ACT>
__global__ void __launch_bounds__(THREADS)
bwd_plane_kernel(const T* __restrict__ g, const T* __restrict__ out, T* __restrict__ gy,
                 float* __restrict__ partial, int hw, float slope) {
  constexpr int UNROLL = PER_THREAD / VEC;
  const size_t plane = blockIdx.x;
  const int start = blockIdx.y * CHUNK;
  const T* gp = g + plane * hw;
  const T* op = out + plane * hw;
  T gv[UNROLL][VEC], ov[UNROLL][VEC];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = start + (u * THREADS + threadIdx.x) * VEC;
    if (i < hw) {
      if constexpr (VEC > 1) {
        load_pack(gp + i, gv[u]);
        if constexpr (ACT) load_pack(op + i, ov[u]);
      } else {
        gv[u][0] = gp[i];
        if constexpr (ACT) ov[u][0] = op[i];
      }
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = start + (u * THREADS + threadIdx.x) * VEC;
    if (i < hw) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if constexpr (ACT) gv[u][k] = act_grad(gv[u][k], ov[u][k], slope);
        acc += to_float(gv[u][k]);
      }
      if constexpr (ACT) {
        if constexpr (VEC > 1) {
          store_pack(gy + plane * hw + i, gv[u]);
        } else {
          gy[plane * hw + i] = gv[u][0];
        }
      }
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[plane * gridDim.y + blockIdx.y] = acc;
}

// Windowed backward: blocks cover the whole (Hy, Wy) gradient plane, zero
// outside the window.
template <typename T, bool ACT>
__global__ void __launch_bounds__(THREADS)
bwd_window_kernel(const T* __restrict__ g, const T* __restrict__ out, T* __restrict__ gy,
                  float* __restrict__ partial, Window win, float slope) {
  const size_t plane = blockIdx.x;
  const int full = win.Hy * win.Wy, hw = win.h * win.w;
  const int start = blockIdx.y * CHUNK;
  const T* gp = g + plane * hw;
  const T* op = out + plane * hw;
  T gv[PER_THREAD], ov[PER_THREAD];
  bool in[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int j = start + u * THREADS + threadIdx.x;
    const int row = j / win.Wy;
    const int r = row - win.top, c = j - row * win.Wy - win.left;
    in[u] = j < full && r >= 0 && r < win.h && c >= 0 && c < win.w;
    if (in[u]) {
      gv[u] = gp[r * win.w + c];
      if constexpr (ACT) ov[u] = op[r * win.w + c];
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int j = start + u * THREADS + threadIdx.x;
    if (j < full) {
      T d = from_float<T>(0.f);
      if (in[u]) {
        d = gv[u];
        if constexpr (ACT) d = act_grad(d, ov[u], slope);
        acc += to_float(d);
      }
      gy[plane * full + j] = d;
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[plane * gridDim.y + blockIdx.y] = acc;
}

// dL/d bias[c]: the partials of planes (n, c) summed over n and chunk, one
// warp a channel, in a fixed order.
__global__ void __launch_bounds__(THREADS)
bias_grad_kernel(const float* __restrict__ partial, float* __restrict__ grad_bias, int N, int C,
                 int chunks) {
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (c >= C) return;
  float acc = 0.f;
  for (int k = lane; k < N * chunks; k += 32) {
    const int n = k / chunks;
    acc += partial[((size_t)n * C + c) * chunks + (k - n * chunks)];
  }
  acc = warp_sum(acc);
  if (lane == 0) grad_bias[c] = acc;
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0; }

bool whole(const Window& w) { return w.top == 0 && w.left == 0 && w.h == w.Hy && w.w == w.Wy; }

long long chunks_of(long long elems) { return (elems + CHUNK - 1) / CHUNK; }

bool valid(int N, int C, const Window& w) {
  const long long full = (long long)w.Hy * w.Wy;
  return N > 0 && C > 0 && w.h > 0 && w.w > 0 && w.top >= 0 && w.left >= 0 &&
         w.top + w.h <= w.Hy && w.left + w.w <= w.Wy && full <= 0x7fffffffLL &&
         chunks_of(full) <= 65535 && (long long)N * C <= 0x7fffffffLL &&
         (long long)N * chunks_of(full) <= 0x7fffffffLL;
}

template <typename T>
int fwd(const void* y, const void* bias, void* out, int N, int C, Window win, float slope,
        cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const T* yp = static_cast<const T*>(y);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  const int hw = win.h * win.w;
  const dim3 grid((unsigned)(N * C), (unsigned)chunks_of(hw)), block(THREADS);
  if (!whole(win)) {
    fwd_window_kernel<T><<<grid, block, 0, s>>>(yp, bp, op, C, win, slope);
  } else if (hw % VEC == 0 && aligned16(y) && aligned16(out)) {
    fwd_plane_kernel<T, VEC><<<grid, block, 0, s>>>(yp, bp, op, C, hw, slope);
  } else {
    fwd_plane_kernel<T, 1><<<grid, block, 0, s>>>(yp, bp, op, C, hw, slope);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool ACT>
int bwd(const T* g, const T* out, T* gy, float* partial, float* grad_bias, int N, int C,
        Window win, float slope, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const dim3 block(THREADS);
  const int hw = win.h * win.w;
  long long chunks;
  if (!whole(win)) {
    chunks = chunks_of((long long)win.Hy * win.Wy);
    bwd_window_kernel<T, ACT><<<dim3((unsigned)(N * C), (unsigned)chunks), block, 0, s>>>(
        g, out, gy, partial, win, slope);
  } else {
    chunks = chunks_of(hw);
    const dim3 grid((unsigned)(N * C), (unsigned)chunks);
    if (hw % VEC == 0 && aligned16(g) && aligned16(out) && aligned16(gy)) {
      bwd_plane_kernel<T, VEC, ACT><<<grid, block, 0, s>>>(g, out, gy, partial, hw, slope);
    } else {
      bwd_plane_kernel<T, 1, ACT><<<grid, block, 0, s>>>(g, out, gy, partial, hw, slope);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bias_grad_kernel<<<(C + WARPS - 1) / WARPS, block, 0, s>>>(partial, grad_bias, N, C,
                                                             (int)chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_typed(const void* g, const void* out, void* gy, float* partial, float* grad_bias, int N,
              int C, Window win, float slope, bool act, cudaStream_t s) {
  const T* gp = static_cast<const T*>(g);
  const T* op = static_cast<const T*>(out);
  T* yp = static_cast<T*>(gy);
  return act ? bwd<T, true>(gp, op, yp, partial, grad_bias, N, C, win, slope, s)
             : bwd<T, false>(gp, op, yp, partial, grad_bias, N, C, win, slope, s);
}

}  // namespace

extern "C" {

// Elements of one plane that a block takes: the backward's `partial` holds
// N * C * ceil(elements / this) floats, the elements being the window's
// (h * w) for a whole-plane window and the input plane's (Hy * Wy) else.
int bias_act_chunk_elems(void) { return CHUNK; }

// out (N, C, h, w) = act(window of y (N, C, Hy, Wy) + bias[c]); y, bias and
// out are float32 (bf16 == 0) or bf16 (1). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int bias_act_fwd_launch(const void* y, const void* bias, void* out, int N, int C, int Hy, int Wy,
                        int top, int left, int h, int w, float slope, int bf16, void* stream) {
  const Window win{Hy, Wy, top, left, h, w};
  if (!valid(N, C, win)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(y, bias, out, N, C, win, slope, s)
              : fwd<float>(y, bias, out, N, C, win, slope, s);
}

// From g = dL/d out and out (both (N, C, h, w)): gy (N, C, Hy, Wy) = dL/dy and
// grad_bias (C, float32) = dL/d bias, with `partial` as scratch. Without an
// activation (act == 0) out is not read, and for a whole-plane window gy is
// not written (dL/dy is g).
int bias_act_bwd_launch(const void* g, const void* out, void* gy, float* partial,
                        float* grad_bias, int N, int C, int Hy, int Wy, int top, int left, int h,
                        int w, float slope, int act, int bf16, void* stream) {
  const Window win{Hy, Wy, top, left, h, w};
  if (!valid(N, C, win)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd_typed<__nv_bfloat16>(g, out, gy, partial, grad_bias, N, C, win, slope,
                                         act != 0, s)
              : bwd_typed<float>(g, out, gy, partial, grad_bias, N, C, win, slope, act != 0, s);
}

const char* bias_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
