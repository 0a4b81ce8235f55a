// Plane-sweep scoring for Hopper (sm_90a): the fused warp + SSIM +
// channel-weighted 3x3 patch-SAD sweep of the MonoRec cost volume, with the
// per-frame scoring and the frame fusion of the cost volume folded in.
//
// Replaces the TPU kernel monorec_tpu/ops/pallas/cv_kernel.py::plane_sweep_sad
// (body _sad_kernel) and the XLA scoring that follows it
// (monorec_tpu/ops/cost_volume.py::_score_and_fuse). Ports the contract, not
// the machinery: the band DMA, one-hot selection matmuls, per-lane shears,
// tap windows and depth chunks exist because the TPU has no vector gather.
// Hopper has one, so each warped value is a direct bilinear gather from
// global memory (through L1/L2: the D hypotheses of one tile read
// overlapping source windows).
//
// Two epilogues of one kernel:
//   * raw: the TPU kernel's outputs, sad and wmask (N, D, H, W);
//   * cost volume: the border indicator is reduced over D in shared memory to valid =
//     interior and all_d(indicator != 0). After the D loop each thread
//     scores its own pixels: min over D, sharp = sum_d exp(-alpha (sad -
//     min)^2), the frame weight (1 - (sharp - 1) / (D - 1)) valid, and
//     sfcv = (1 - 2 sad) valid. Neither sad nor wmask reaches device memory
//     as such. The weight is taken as deficit / (D - 1), deficit =
//     sum_d (1 - exp(..)) by expm1f: the same value without the cancellation
//     of sharp - 1 near D (a float32 sum of D terms near 1 carries ~D ulp(D),
//     which at D = 96 moves a flat curve's weight by percent).
//     The SADs wait in the sfcv output itself, each read back (from L2) by
//     the thread that wrote it. Kept in shared memory instead (D x 4 KB a
//     block) they measured slower on an H100 at D = 8 and at D = 32, where
//     they cost the blocks an SM holds, so there is one store for every D.
//     A second, elementwise launch (fuse_frames_kernel) forms the fused CV
//     sum_f sfcv_f w_f / sum_f w_f from sfcv and the frame weights: the
//     block of one source frame cannot see the other frames of its keyframe,
//     and blocks that each took all F frames would be F times fewer (1024 at
//     B = 8, 256x512: under three waves of the 396 an H100 holds at once).
//   * grouped cost volumes (monorec_tpu/ops/cost_volume.py::
//     _plane_sweep_sad_grouped): the frames of one keyframe are split into
//     groups, consecutive runs of the frame axis (the stage 2-4 protocol's
//     F mono frames and its stereo frame), each fused into a cost volume of
//     its own. The sweep runs once over all of them (a frame is scored
//     against its keyframe alone, so nothing in it mixes frames), and
//     fuse_frames_kernel runs once per group over that group's frames:
//     each group's output is bit-equal to a launch over its frames alone.
//
// What bounds it: instruction issue. Per output pixel and hypothesis it
// evaluates a displacement (two IEEE divisions), gathers 4 bilinear taps
// and scores a 3x3-window SSIM on 3 channels: ~175 float32 operations that
// depend on the hypothesis, which at the card's float32 peak take about as
// long as the compulsory bytes (the sources in, the per-frame and fused CVs
// out), and around them the gathers' and shared memory's loads and the
// address arithmetic. The design:
//   * the sources are first interleaved into one texel per pixel (a 16-byte
//     float4, or 8 bytes of bf16), so each bilinear tap is one load, not C;
//   * the warped tile and its error map stay in shared memory, and the
//     keyframe tile is loaded once per block;
//   * the SSIM window sums and the box sum come from running 3-row sums in
//     registers: each thread walks down a column strip, so a window costs 6
//     shared loads per row and channel instead of 27;
//   * one hypothesis takes two barriers: the one after the error stage also
//     orders the next hypothesis's warp after this one's readers.
//
// Grid: (ceil(W / 32), ceil(H / 32), N) blocks of 256 threads, a loop over D
// inside each. Per hypothesis:
//   1. warp the source over the tile + 2-px halo (bilinear, zero pad) and,
//      on the tile's own pixels, the border indicator (1296 slots);
//   2. photometric error on the tile + 1-px halo by use_ssim (1 SSIM,
//      2 0.85*SSIM + 0.15*L1, 0 L1, -1 3x3 avg-pooled L1), channel-weighted:
//      34 columns x 7 row strips of 4-5 rows (238 threads);
//   3. 3x3 box sum of that error: 32 columns x 8 strips of 4 rows.
// Image borders follow the plain version exactly: the warped image and the
// keyframe are reflect-padded by one pixel for SSIM (the halo slot warps the
// mirrored output pixel), the error map is zero outside the image for the
// box sum and the avg-pooled L1. Coverage is all zeros (full reach) and is
// written by the Python wrapper.
//
// Sources: float32, or bf16 under the serving policy (the kernel is a
// template on the source type and converts each texel on load; everything
// after the load is the float32 code, so bf16 sources give exactly the
// float32 kernel's result on the upcast images). Keyframes are float32.
//
// Coordinates and the bilinear footprint come from sweep_common.cuh, shared
// with the warp-only kernel K4: float64 homographies, float32 displacements
// from M - I, each operation rounded on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

constexpr int C = 3;                 // RGB; the wrapper checks it
constexpr int TY = 32;               // output tile rows
constexpr int TX = 32;               // output tile cols
constexpr int TILE = TY * TX;
constexpr int HALO = 2;              // SSIM window (1) + SAD box (1)
constexpr int EY = TY + 2 * HALO;    // warped rows per tile
constexpr int EX = TX + 2 * HALO;
constexpr int QY = TY + 2;           // error rows per tile (1-px halo)
constexpr int QX = TX + 2;
constexpr int THREADS = 256;
constexpr int PIX = TILE / THREADS;  // output pixels per thread (box stage, epilogue)
constexpr int STRIPS = 7;            // error stage: QX columns x STRIPS row strips
constexpr int FUSE_VEC = 4;          // pixels per thread of the frame fusion
constexpr int STRIP_ROWS = (QY + STRIPS - 1) / STRIPS;
constexpr float C1 = 1e-4f;          // 0.01^2
constexpr float C2 = 9e-4f;          // 0.03^2
constexpr float INV9 = 1.f / 9.f;

enum Out { RAW = 0, CV = 1 };

// jnp.pad / F.pad "reflect" index map. Slots two pixels out only feed error
// values that are zeroed (outside the image), so clamp those in range.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// Error of one strip of error slots (rows q0 .. q0 + len - 1, column qx) of
// one channel, added with weight cw into e[]. Running 3-row sums: row j of
// the strip's window rows is loaded once (3 warped + 3 keyframe values), and
// only the last three rows' sums are live (row j in slot j % 3), so the
// registers do not grow with the strip. The L1 term reads its centre pixel
// where it is needed.
template <int MODE>
__device__ __forceinline__ void strip_error(const float (*ws)[EX], const float (*ks)[EX], int q0,
                                            int len, int qx, int y0, int x0, int H, int W,
                                            float cw, float* e) {
  float h_x[3], h_xx[3], h_xy[3], h_k[3], h_kk[3];
#pragma unroll
  for (int j = 0; j < STRIP_ROWS + 2; ++j) {
    if (j < len + 2) {
      const int s = j % 3;
      h_x[s] = h_xx[s] = h_xy[s] = h_k[s] = h_kk[s] = 0.f;
      const int r = q0 + j;
      const bool row_in = (unsigned)(y0 + r) < (unsigned)H;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float a = ws[r][qx + dx], k = ks[r][qx + dx];
        if (MODE == 1 || MODE == 2) {
          h_x[s] += a;
          h_xx[s] += a * a;
          h_xy[s] += a * k;
          h_k[s] += k;
          h_kk[s] += k * k;
        } else if (MODE == -1) {
          if (row_in && (unsigned)(x0 + qx + dx) < (unsigned)W) h_x[s] += fabsf(a - k);
        }
      }
      if (j >= 2) {  // error row o = j - 2 from window rows o, o + 1, o + 2
        const int o = j - 2, s0 = o % 3, s1 = (o + 1) % 3, s2 = (o + 2) % 3;
        const float l1 = fabsf(ws[r - 1][qx + 1] - ks[r - 1][qx + 1]);
        float diff;
        if (MODE == 1 || MODE == 2) {
          const float mu_x = (h_x[s0] + h_x[s1] + h_x[s2]) * INV9;
          const float mu_y = (h_k[s0] + h_k[s1] + h_k[s2]) * INV9;
          const float sigma_x = (h_xx[s0] + h_xx[s1] + h_xx[s2]) * INV9 - mu_x * mu_x;
          const float sigma_y = (h_kk[s0] + h_kk[s1] + h_kk[s2]) * INV9 - mu_y * mu_y;
          const float sigma_xy = (h_xy[s0] + h_xy[s1] + h_xy[s2]) * INV9 - mu_x * mu_y;
          const float num = (2.f * mu_x * mu_y + C1) * (2.f * sigma_xy + C2);
          const float den = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2);
          diff = fminf(fmaxf((1.f - __fdividef(num, den)) * 0.5f, 0.f), 1.f);
          if (MODE == 2) diff = 0.85f * diff + 0.15f * l1;
        } else if (MODE == 0) {
          diff = l1;
        } else {  // -1: 3x3 avg pool of L1, zero outside the image
          diff = (h_x[s0] + h_x[s1] + h_x[s2]) * INV9;
        }
        e[o] += cw * diff;
      }
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 3)
plane_sweep_kernel(const typename sweep::Texel<T>::type* __restrict__ texels,  // (N, H, W)
                   const float* __restrict__ keyframes,  // (B, C, H, W)
                   const double* __restrict__ homs,      // (N, D, 3, 3), m22 == 1
                   float* __restrict__ sad,              // raw: (N, D, H, W); CV: sfcv
                   float* __restrict__ aux,              // raw: wmask (N, D, H, W); CV: weight
                   int D, int H, int W, int frames_per_image, int border_radius, int out,
                   float alpha, float cw0, float cw1, float cw2) {
  __shared__ float key_s[C][EY][EX];       // keyframe + 0.5, reflect-padded
  __shared__ float warp_s[C][EY][EX];      // warped source + 0.5
  __shared__ float err_s[QY][QX];          // weighted error, 0 outside image
  __shared__ unsigned char valid_s[TILE];  // all_d(border indicator != 0)

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TY - HALO;   // image coords of slot (0, 0)
  const int x0 = blockIdx.x * TX - HALO;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t plane = (size_t)H * W;
  const typename sweep::Texel<T>::type* tex = texels + (size_t)n * plane;
  const float* key = keyframes + (size_t)(n / frames_per_image) * C * plane;
  const float cw[C] = {cw0, cw1, cw2};
  // Error stage: this thread's column and row strip.
  const int qx = tid % QX, strip = tid / QX;
  const int q0 = strip * QY / STRIPS, q_len = (strip + 1) * QY / STRIPS - q0;
  // Cost-volume mode: the SAD of hypothesis d for this thread's output
  // pixel k (box stage and epilogue; tile row PIX * warp + k, column lane)
  // waits in sfcv at sad[sad_px + k * W + d * plane].
  const size_t sad_px = (size_t)n * D * plane + (size_t)(y0 + HALO + PIX * warp) * W +
                        (x0 + HALO + lane);

  for (int i = tid; i < EY * EX; i += THREADS) {
    const int ey = i / EX, ex = i % EX;
    const size_t off = (size_t)reflect(y0 + ey, H) * W + reflect(x0 + ex, W);
#pragma unroll
    for (int c = 0; c < C; ++c) key_s[c][ey][ex] = __ldg(key + c * plane + off) + 0.5f;
  }
  for (int i = tid; i < TILE; i += THREADS) valid_s[i] = 1;
  __syncthreads();  // valid_s is set before any warp stage clears it

  for (int d = 0; d < D; ++d) {
    const sweep::Hom hom = sweep::load_hom(homs + ((size_t)n * D + d) * 9);
    const size_t out_plane = ((size_t)n * D + d) * plane;

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
            float s[C];
            sweep::unpack(__ldg(tex + ty * W + tx), s);
#pragma unroll
            for (int c = 0; c < C; ++c) v[c] = __fadd_rn(v[c], __fmul_rn(s[c], fp.w[t]));
          }
          if (tx >= border_radius && tx < W - border_radius &&
              ty >= border_radius && ty < H - border_radius)
            b = __fadd_rn(b, fp.w[t]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) warp_s[c][ey][ex] = v[c] + 0.5f;
      if (ey >= HALO && ey < HALO + TY && ex >= HALO && ex < HALO + TX && py < H && px < W) {
        if (out == RAW)
          aux[out_plane + (size_t)py * W + px] = b;
        else if (b == 0.f)
          valid_s[(ey - HALO) * TX + ex - HALO] = 0;
      }
    }
    __syncthreads();  // warp_s is complete (and, at d = 0, key_s)

    // 2. Channel-weighted photometric error on the tile + 1-px halo.
    if (strip < STRIPS) {
      float e[STRIP_ROWS];
#pragma unroll
      for (int j = 0; j < STRIP_ROWS; ++j) e[j] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        strip_error<MODE>(warp_s[c], key_s[c], q0, q_len, qx, y0, x0, H, W, cw[c], e);
      const bool col_in = (unsigned)(x0 + 1 + qx) < (unsigned)W;
#pragma unroll
      for (int j = 0; j < STRIP_ROWS; ++j)
        if (j < q_len)
          err_s[q0 + j][qx] =
              col_in && (unsigned)(y0 + 1 + q0 + j) < (unsigned)H ? e[j] : 0.f;
    }
    __syncthreads();  // err_s is complete; every thread is done with warp_s

    // 3. 3x3 box sum (zero padded): rows PIX * warp .. + PIX - 1, column lane.
    {
      float h[PIX + 2];
#pragma unroll
      for (int j = 0; j < PIX + 2; ++j) {
        const float* row = err_s[PIX * warp + j];
        h[j] = row[lane] + row[lane + 1] + row[lane + 2];
      }
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        const int py = y0 + HALO + PIX * warp + k, px = x0 + HALO + lane;
        if (py < H && px < W) {
          const float s = h[k] + h[k + 1] + h[k + 2];
          if (out == RAW)
            sad[out_plane + (size_t)py * W + px] = s;
          else
            sad[sad_px + k * W + d * plane] = s;
        }
      }
    }
  }
  if (out == RAW) return;
  __syncthreads();  // valid_s is complete

  // Per-frame scoring of this thread's pixels (ops/plane_sweep.py::
  // score_and_fuse): sfcv over the SADs, the frame weight beside it.
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int ty = PIX * warp + k;
    const int py = y0 + HALO + ty, px = x0 + HALO + lane;
    if (py >= H || px >= W) continue;
    const float* slot = sad + sad_px + k * W;
    float m = slot[0];
    for (int d = 1; d < D; ++d) m = fminf(m, slot[d * plane]);
    float deficit = 0.f;  // D - sharp
    for (int d = 0; d < D; ++d) {
      const float t = slot[d * plane] - m;
      deficit -= expm1f(-alpha * (t * t));
    }
    const bool interior = py >= border_radius && py < H - border_radius &&
                          px >= border_radius && px < W - border_radius;
    const float valid = interior && valid_s[ty * TX + lane] ? 1.f : 0.f;
    const size_t p = (size_t)py * W + px;
    aux[(size_t)n * plane + p] = deficit / (float)(D - 1) * valid;
    for (int d = 0; d < D; ++d) {
      const float s = slot[d * plane];
      sad[((size_t)n * D + d) * plane + p] = (1.f - 2.f * s) * valid;
    }
  }
}

// fused (B, D, H, W) from frames [f0, f0 + fg) of sfcv (B, F, D, H, W) and
// of the frame weights (B, F, H, W): sum_f sfcv w / sum_f w (= 1 - 2 sum_f
// sad w / sum_f w where the weights are positive), or sum_f sad w / sum_f w
// without centring; 0 where no frame has weight. Grid: (ceil(H W / (V
// THREADS)), D, B); V neighbouring pixels per thread, moved as one float4
// where V = 4 (the wrapper's tensors are 16-byte aligned and V divides H W).
template <int V>
__device__ __forceinline__ void load_px(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS)
fuse_frames_kernel(const float* __restrict__ sfcv, const float* __restrict__ weight,
                   float* __restrict__ fused, int F, int f0, int fg, int D, int plane,
                   int center) {
  const int p = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (p >= plane) return;
  const int d = blockIdx.y;
  const size_t b = blockIdx.z;
  float wsum[V], num[V];
#pragma unroll
  for (int i = 0; i < V; ++i) wsum[i] = num[i] = 0.f;
  for (int f = f0; f < f0 + fg; ++f) {
    const size_t nf = b * F + f;
    float w[V], s[V];
    load_px<V>(weight + nf * plane + p, w);
    load_px<V>(sfcv + (nf * D + d) * plane + p, s);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      wsum[i] += w[i];
      num[i] += s[i] * w[i];
    }
  }
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = 0.f;
    if (wsum[i] > 0.f) {
      const float q = num[i] / wsum[i];
      v[i] = center ? q : (1.f - q) * 0.5f;
    }
  }
  float* out = fused + (b * D + d) * plane + p;
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  else
    out[0] = v[0];
}

template <typename T>
int launch(const void* images, const float* keyframes, const double* homs, void* texels,
           float* sad, float* aux, int N, int D, int H, int W, int frames_per_image,
           int border_radius, int use_ssim, int out, float alpha, float cw0, float cw1,
           float cw2, cudaStream_t s) {
  using Tex = typename sweep::Texel<T>::type;
  const int plane = H * W;
  sweep::pack_texels<T, THREADS><<<dim3((plane + THREADS - 1) / THREADS, N), THREADS, 0, s>>>(
      static_cast<const T*>(images), static_cast<Tex*>(texels), plane);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, N);
  const dim3 block(THREADS);
  const Tex* src = static_cast<const Tex*>(texels);
#define PSS_LAUNCH(MODE)                                                                  \
  plane_sweep_kernel<T, MODE><<<grid, block, 0, s>>>(src, keyframes, homs, sad, aux, D, H, W, \
                                                     frames_per_image, border_radius, out,  \
                                                     alpha, cw0, cw1, cw2)
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

int launch_sources(const void* images, const float* keyframes, const double* homs, void* texels,
                   float* sad, float* aux, int N, int D, int H, int W, int frames_per_image,
                   int border_radius, int use_ssim, int images_bf16, int out, float alpha,
                   float cw0, float cw1, float cw2, cudaStream_t s) {
  if (images_bf16)
    return launch<__nv_bfloat16>(images, keyframes, homs, texels, sad, aux, N, D, H, W,
                                 frames_per_image, border_radius, use_ssim, out, alpha, cw0,
                                 cw1, cw2, s);
  return launch<float>(images, keyframes, homs, texels, sad, aux, N, D, H, W, frames_per_image,
                       border_radius, use_ssim, out, alpha, cw0, cw1, cw2, s);
}

}  // namespace

extern "C" {

// The TPU kernel's contract: sad and wmask (N, D, H, W). images are float32
// (images_bf16 == 0) or bf16 (1); texels is the wrapper's scratch for the
// interleaved sources, N * H * W * 16 (float32) or * 8 (bf16) bytes,
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int plane_sweep_sad_launch(const void* images, const float* keyframes, const double* homs,
                           void* texels, float* sad, float* wmask, int N, int D, int H, int W,
                           int frames_per_image, int border_radius, int use_ssim,
                           int images_bf16, float cw0, float cw1, float cw2, void* stream) {
  return launch_sources(images, keyframes, homs, texels, sad, wmask, N, D, H, W,
                        frames_per_image, border_radius, use_ssim, images_bf16, RAW, 0.f, cw0,
                        cw1, cw2, static_cast<cudaStream_t>(stream));
}

// The cost volume: sfcv (N, D, H, W) = (B, F, D, H, W), the frame weights
// (N, H, W) and the fused CVs (G, B, D, H, W), one per group of frames
// (groups[g] frames each, in order along F; they sum to F), all 16-byte
// aligned; texels as above. Returns the first error (0 on success).
int plane_sweep_cost_volume_launch(const void* images, const float* keyframes,
                                   const double* homs, void* texels, float* sfcv, float* weight,
                                   float* fused, int N, int D, int H, int W,
                                   int frames_per_image, int n_groups, const int* groups,
                                   int border_radius, int use_ssim, int images_bf16, float alpha,
                                   int center, float cw0, float cw1, float cw2, void* stream) {
  if (frames_per_image <= 0 || N % frames_per_image || n_groups <= 0)
    return (int)cudaErrorInvalidValue;
  int total = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (groups[g] <= 0) return (int)cudaErrorInvalidValue;
    total += groups[g];
  }
  if (total != frames_per_image) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = launch_sources(images, keyframes, homs, texels, sfcv, weight, N, D, H, W,
                                  frames_per_image, border_radius, use_ssim, images_bf16, CV,
                                  alpha, cw0, cw1, cw2, s);
  if (code) return code;
  const int plane = H * W, B = N / frames_per_image;
  for (int g = 0, f0 = 0; g < n_groups; f0 += groups[g++]) {
    float* out = fused + (size_t)g * B * D * plane;
    if (plane % FUSE_VEC == 0)
      fuse_frames_kernel<FUSE_VEC>
          <<<dim3((plane / FUSE_VEC + THREADS - 1) / THREADS, D, B), THREADS, 0, s>>>(
              sfcv, weight, out, frames_per_image, f0, groups[g], D, plane, center);
    else
      fuse_frames_kernel<1><<<dim3((plane + THREADS - 1) / THREADS, D, B), THREADS, 0, s>>>(
          sfcv, weight, out, frames_per_image, f0, groups[g], D, plane, center);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

const char* plane_sweep_sad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
