// The U-Nets' stride-1 same-padded convolutions for Hopper (sm_90a), with
// their bias and LeakyReLU, in one launch:
//
//   out[n, o, y, x] = act(bias[o] + sum_{c, ky, kx} w[o, c, ky, kx] *
//                         x[n, c, y + ky - top, x + kx - left]),
//   act(v) = v > 0 ? v : v * slope,
//
// NCHW float32, the input read as zero outside its planes. (top, left) is
// TensorFlow's "same" pad on the leading sides; the trailing sides take the
// rest of k - 1, so the asymmetric pad of a k=2 convolution is computed as
// it is, with no extra row or column. Kernel sizes 3x3, 2x2, and k x 1 and
// 1 x k for k = 3, 5, 7; slope 0.1 after an activated convolution, 1 (the
// identity, v * 1 == v) after one that is not.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions, their
// bias and their activation to XLA. On the card cuDNN's float32 convolution
// (an implicit GEMM that keeps most of its 128-wide channel tile idle at
// these 24-96 output channels) was followed by a second pass, bias_act.cu,
// over its output.
//
// What bounds it: operations. 2 x the multiply-adds over the card's
// 67 TFLOP/s of float32 FFMA; at 24-96 channels and 2-9 taps each input
// value staged feeds hundreds of operations, far above the byte line. It is
// plain float32 FFMA throughout: no tensor cores (TF32 would break the exact
// policy), no split precision.
//
// What the design does about that bound: it keeps the FFMA pipes fed from
// registers and issues little else.
//   * A thread holds TM output pixels along a "strip" times TN output
//     channels (64 or 32 sums). For each input channel and tap row along
//     the lanes it loads the TM + KS - 1 input values of its strip once from
//     shared memory and slides them across the KS taps along the strip, and
//     reads TN weights as warp-wide broadcasts (float4): 16-19 shared loads
//     per 192 FFMAs at 3x3 (8 x 8).
//   * The 32 lanes of a warp take 32 neighbouring pixels across the strip,
//     so their loads hit 32 banks. The strip runs down the columns (lanes
//     along x) for every kernel with more than one row of taps, and along
//     the rows for 1 x k (lanes along y, on a staged tile of odd pitch),
//     so a 1 x k convolution slides along its taps too.
//   * A block computes a 32 x 16 pixel tile for BCO output channels (warps
//     along the strip and along the channels). The input tile with its halo
//     and the weights of CI_CHUNK input channels are staged by cp.async into
//     a ring of STAGES buffers, three chunks ahead of the one being summed;
//     a copy that falls outside the planes, or beyond C_in, writes zeros
//     (src-size 0): that zero fill is the same pad, so no padded copy of
//     the input is made. cp.async and not a TMA tensor map: the tile can
//     take an odd pitch (conflict-free reads down a column) and planes of
//     any width, with no 16-byte stride rule, and the copies cost under 5%
//     of the issue slots. Each thread works out its elements' offsets in a
//     plane once and reuses them for every channel; weights are copied
//     from their (C_out, C_in, kh, kw) rows as they lie.
//   * The channel block (BCO = TN x warps along channels: 32, 24 or 8) and
//     the strip (TM = 8 or 4) come from the configuration the wrapper picks
//     from the shape (ops/same_conv.py, plan), so 24-, 36- and 48-channel
//     layers leave few channels of their blocks idle.
//   * The epilogue adds the bias, applies the slope and stores once from
//     registers: coalesced across lanes down the columns, as two 16-byte
//     vectors a channel along the rows.
// Each output's sum runs over input-channel chunks, channels, tap rows and
// taps in a fixed order, so a launch repeats bit for bit.

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int CI_CHUNK = 4;  // input channels a stage holds
constexpr int STAGES = 4;    // the cp.async ring

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 4 bytes; a copy that is not `valid` writes zeros and reads
// nothing (src-size 0; `src` is any mapped address then).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// KS taps along the strip, KL across the lanes; HORIZ: the strip runs
// along x (lanes along y), else along y (lanes along x). TM pixels x TN
// channels a thread; WS warps along the strip, WC along the channels.
template <int KS, int KL, bool HORIZ, int TM, int TN, int WS, int WC>
struct Cfg {
  static constexpr int THREADS = 32 * WS * WC;
  static constexpr int STRIP_T = TM * WS;      // output tile along the strip
  static constexpr int LANE_T = 32;            // and across the lanes
  static constexpr int SE = STRIP_T + KS - 1;  // staged extent along the strip
  static constexpr int LE = LANE_T + KL - 1;   // and across the lanes
  // The staged tile is [ROWS][P] floats a channel, rows along y. Down the
  // columns the lanes read along a row (stride 1); along the rows they read
  // down a column, at a pitch that is odd so that 32 rows hit 32 banks.
  static constexpr int ROWS = HORIZ ? LE : SE;
  static constexpr int COLS = HORIZ ? SE : LE;
  static constexpr int P = HORIZ ? (COLS | 1) : COLS;
  static constexpr int CH = ROWS * P;
  static constexpr int LS = HORIZ ? P : 1;  // the lane axis's stride
  static constexpr int SS = HORIZ ? 1 : P;  // the strip's
  static constexpr int BCO = TN * WC;
  static constexpr int TAPS = KS * KL;
  static constexpr int W_FLOATS = CI_CHUNK * TAPS * BCO;  // [c][tap][o]
  static constexpr int IN_FLOATS = (CI_CHUNK * CH + 3) / 4 * 4;
  static constexpr int STAGE = W_FLOATS + IN_FLOATS;  // weights first, 16-byte aligned
  static constexpr int SMEM = STAGES * STAGE * 4;
  static constexpr int PER_THREAD = (ROWS * COLS + THREADS - 1) / THREADS;
  static constexpr int MIN_BLOCKS = THREADS >= 192 ? 2 : 3;
  static_assert(TN % 4 == 0 && BCO % 4 == 0, "weights are read as float4");
  static_assert(!HORIZ || KL == 1, "1 x k only along the rows");
};

struct Args {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  int N, C_in, H, W, C_out, top, left;
  float slope;
};

// Tap index in the weights' (kh, kw) order for tap s along the strip and l
// across the lanes.
template <int KS, int KL, bool HORIZ>
__device__ __forceinline__ constexpr int tap(int s, int l) {
  return HORIZ ? l * KS + s : s * KL + l;
}

template <int KS, int KL, bool HORIZ, int TM, int TN, int WS, int WC>
__global__ void __launch_bounds__(Cfg<KS, KL, HORIZ, TM, TN, WS, WC>::THREADS,
                                  Cfg<KS, KL, HORIZ, TM, TN, WS, WC>::MIN_BLOCKS)
    same_conv_kernel(const Args a) {
  using C = Cfg<KS, KL, HORIZ, TM, TN, WS, WC>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ws = warp % WS;  // the warp's place along the strip
  const int wc = warp / WS;  // and among the channels
  // blockIdx: x the tile across the lanes, y along the strip, z (image,
  // channel block).
  const int co_blocks = (a.C_out + C::BCO - 1) / C::BCO;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * C::BCO;
  const int lane0 = blockIdx.x * C::LANE_T;
  const int strip0 = blockIdx.y * C::STRIP_T;
  const int y0 = HORIZ ? lane0 : strip0;
  const int x0 = HORIZ ? strip0 : lane0;
  const int HW = a.H * a.W;
  const int taps_in = a.C_in * C::TAPS;  // a weight row: one output channel's
  const float* xn = a.x + static_cast<size_t>(n) * a.C_in * HW;

  // This thread's staged elements of one channel: their offsets in the
  // plane and whether they lie inside it. The same for every channel.
  int g_off[C::PER_THREAD];
  unsigned inside = 0;
#pragma unroll
  for (int j = 0; j < C::PER_THREAD; ++j) {
    const int e = tid + j * C::THREADS;
    const int r = e / C::COLS, q = e - r * C::COLS;
    const int gy = y0 - a.top + r, gx = x0 - a.left + q;
    const bool in = e < C::ROWS * C::COLS &&
                    static_cast<unsigned>(gy) < static_cast<unsigned>(a.H) &&
                    static_cast<unsigned>(gx) < static_cast<unsigned>(a.W);
    inside |= static_cast<unsigned>(in) << j;
    g_off[j] = in ? gy * a.W + gx : 0;
  }

  const int n_chunks = (a.C_in + CI_CHUNK - 1) / CI_CHUNK;

  auto load = [&](int stage, int chunk) {
    float* sw = smem + stage * C::STAGE;
    float* sin = sw + C::W_FLOATS;
    const int c0 = chunk * CI_CHUNK;
#pragma unroll
    for (int c = 0; c < CI_CHUNK; ++c) {
      const bool ch_ok = c0 + c < a.C_in;
      const float* plane = xn + static_cast<size_t>(ch_ok ? c0 + c : 0) * HW;
#pragma unroll
      for (int j = 0; j < C::PER_THREAD; ++j) {
        const int e = tid + j * C::THREADS;
        if (j < C::PER_THREAD - 1 || e < C::ROWS * C::COLS) {
          const int r = e / C::COLS, q = e - r * C::COLS;
          cp_async4(sin + c * C::CH + r * C::P + q, plane + g_off[j],
                    ch_ok && ((inside >> j) & 1u));
        }
      }
    }
    // The chunk's weights, [c][tap][o]: element ct = c * TAPS + tap of
    // output channel co0 + o's row, from c0 * TAPS on.
    const float* w_c0 = a.w + static_cast<size_t>(c0) * C::TAPS;
    const int ct_end = (a.C_in - c0) * C::TAPS;
#pragma unroll
    for (int j = 0; j < (C::W_FLOATS + C::THREADS - 1) / C::THREADS; ++j) {
      const int e = tid + j * C::THREADS;
      if (C::W_FLOATS % C::THREADS == 0 || e < C::W_FLOATS) {
        const int o = e % C::BCO, ct = e / C::BCO;
        const bool ok = co0 + o < a.C_out && ct < ct_end;
        cp_async4(sw + e, ok ? w_c0 + static_cast<size_t>(co0 + o) * taps_in + ct : a.w, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int o = 0; o < TN; ++o) acc[i][o] = 0.f;

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < n_chunks) load(k, k);
    cp_async_commit();
  }

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the chunk is staged; every warp is done with the buffer refilled next
    const int next = chunk + STAGES - 1;
    if (next < n_chunks) load(next % STAGES, next);
    cp_async_commit();

    const float* sw = smem + (chunk % STAGES) * C::STAGE + wc * TN;
    const float* sin = smem + (chunk % STAGES) * C::STAGE + C::W_FLOATS + lane * C::LS +
                       ws * TM * C::SS;
    const int n_c = min(CI_CHUNK, a.C_in - chunk * CI_CHUNK);
#pragma unroll 1
    for (int c = 0; c < n_c; ++c) {
      const float* in_c = sin + c * C::CH;
      const float* w_c = sw + c * C::TAPS * C::BCO;
#pragma unroll
      for (int l = 0; l < KL; ++l) {
        float v[TM + KS - 1];
#pragma unroll
        for (int j = 0; j < TM + KS - 1; ++j) v[j] = in_c[l * C::LS + j * C::SS];
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          float wv[TN];
#pragma unroll
          for (int q = 0; q < TN / 4; ++q) {
            const float4 f = *reinterpret_cast<const float4*>(
                w_c + tap<KS, KL, HORIZ>(s, l) * C::BCO + 4 * q);
            wv[4 * q] = f.x;
            wv[4 * q + 1] = f.y;
            wv[4 * q + 2] = f.z;
            wv[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int o = 0; o < TN; ++o) acc[i][o] = fmaf(v[i + s], wv[o], acc[i][o]);
        }
      }
    }
  }

  const int lane_c = lane0 + lane;       // this thread's coordinate across the lanes
  const int strip_c = strip0 + ws * TM;  // and its strip's first along the strip
  const int co_t = co0 + wc * TN;        // and its first output channel
  // Epilogue: bias, activation, one store of each output.
  const bool vec = HORIZ && (a.W % 4 == 0) && strip_c + TM <= a.W && lane_c < a.H;
#pragma unroll
  for (int o = 0; o < TN; ++o) {
    const int co = co_t + o;
    if (co >= a.C_out) break;
    const float b = __ldg(a.bias + co);
    float* plane = a.out + (static_cast<size_t>(n) * a.C_out + co) * HW;
    float r[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float v = acc[i][o] + b;
      r[i] = v > 0.f ? v : v * a.slope;
    }
    if (vec) {
      float4* dst = reinterpret_cast<float4*>(plane + lane_c * a.W + strip_c);
#pragma unroll
      for (int q = 0; q < TM / 4; ++q)
        dst[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int y = HORIZ ? lane_c : strip_c + i;
        const int x = HORIZ ? strip_c + i : lane_c;
        if (y < a.H && x < a.W) plane[y * a.W + x] = r[i];
      }
    }
  }
}

// The configurations the wrapper picks from (ops/same_conv.py, CONFIGS):
// (TM, TN, WS, WC).
//   0: 8 x 8 a thread, 32 channels and 32 x 16 pixels a block (256 threads)
//   1: 8 x 8 a thread, 24 channels and 32 x 16 pixels a block (192 threads)
//   2: 4 x 8 a thread,  8 channels and 32 x 16 pixels a block (128 threads)
constexpr int N_CONFIGS = 3;

struct Kernel {
  const void* fn;
  int threads, smem, strip_t, bco;
};

// The kernel's launch shape, its shared-memory limit raised on the current
// device the first time it is asked for there (a bit a device in `raised`),
// so that a launch after the first makes no driver call but the launch.
template <int KS, int KL, bool HORIZ, int TM, int TN, int WS, int WC>
cudaError_t prepare(Kernel* k) {
  using C = Cfg<KS, KL, HORIZ, TM, TN, WS, WC>;
  auto fn = same_conv_kernel<KS, KL, HORIZ, TM, TN, WS, WC>;
  *k = Kernel{reinterpret_cast<const void*>(fn), C::THREADS, C::SMEM, C::STRIP_T, C::BCO};
  static std::atomic<unsigned long long> raised{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit & raised.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

template <int KS, int KL, bool HORIZ>
cudaError_t prepare_config(int config, Kernel* k) {
  switch (config) {
    case 0: return prepare<KS, KL, HORIZ, 8, 8, 2, 4>(k);
    case 1: return prepare<KS, KL, HORIZ, 8, 8, 2, 3>(k);
    case 2: return prepare<KS, KL, HORIZ, 4, 8, 4, 1>(k);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel for a (kh, kw) and configuration, with its shared-memory limit
// raised. The strip runs along the rows (HORIZ) for 1 x k.
cudaError_t prepare_kernel(int kh, int kw, int config, Kernel* k) {
  if (kh == 3 && kw == 3) return prepare_config<3, 3, false>(config, k);
  if (kh == 2 && kw == 2) return prepare_config<2, 2, false>(config, k);
  if (kw == 1 && kh == 7) return prepare_config<7, 1, false>(config, k);
  if (kw == 1 && kh == 5) return prepare_config<5, 1, false>(config, k);
  if (kw == 1 && kh == 3) return prepare_config<3, 1, false>(config, k);
  if (kh == 1 && kw == 7) return prepare_config<7, 1, true>(config, k);
  if (kh == 1 && kw == 5) return prepare_config<5, 1, true>(config, k);
  if (kh == 1 && kw == 3) return prepare_config<3, 1, true>(config, k);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Blocks of the (kh, kw) kernel in `config` that one SM holds at once
// (0 where the pair is not built), for the wrapper's choice of
// configuration.
int same_conv_blocks_per_sm(int kh, int kw, int config) {
  Kernel k;
  if (prepare_kernel(kh, kw, config, &k) != cudaSuccess) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.fn, k.threads, k.smem) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// out (N, C_out, H, W) = act(conv(x (N, C_in, H, W), w (C_out, C_in, kh, kw))
// + bias) with the same pad (top, left), all float32 and contiguous, in
// `config`. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int same_conv_launch(const float* x, const float* w, const float* bias, float* out, int N,
                     int C_in, int H, int W, int C_out, int kh, int kw, int top, int left,
                     float slope, int config, void* stream) {
  if (N <= 0 || C_in <= 0 || H <= 0 || W <= 0 || C_out <= 0 || top < 0 || left < 0 ||
      top >= kh || left >= kw || config < 0 || config >= N_CONFIGS)
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel k;
  cudaError_t err = prepare_kernel(kh, kw, config, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool horiz = kh == 1 && kw > 1;
  const long long z = static_cast<long long>(N) * ((C_out + k.bco - 1) / k.bco);
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((horiz ? H : W) + 31) / 32, ((horiz ? W : H) + k.strip_t - 1) / k.strip_t,
                  static_cast<unsigned>(z));
  Args args{x, w, bias, out, N, C_in, H, W, C_out, top, left, slope};
  void* params[] = {&args};
  err = cudaLaunchKernel(k.fn, grid, dim3(k.threads), params, static_cast<size_t>(k.smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* same_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
