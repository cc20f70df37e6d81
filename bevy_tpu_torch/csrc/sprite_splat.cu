// Kernel B5: window-splat sprite raster — each pixel under-composites the
// sprite windows over it, front to back, into a premultiplied accumulator
// and merges it over the framebuffer.
//
// Replaces bevy_tpu/ops/raster2d_splat.py::_splat_kernel (entry
// raster_sprites_splat). There, one sequential grid step streamed every
// window's record into SMEM (double-buffered DMA) and read-modify-wrote a
// (win_h, 128) slice of a VMEM accumulator held as (ncols, H, 128)
// column-major planes, in column-group passes; the sequential grid made the
// read-modify-write race-free and kept z order. Here blending depends on
// order, so each framebuffer block has one owner: a 128 x 8 CTA owns one
// 8-row block of a 128-column strip and walks that block's window list,
// which the preparation (ops/raster2d_splat.py) sorted stably by block, so
// it is the global front-to-back order restricted to the block. A window
// starts on any 8-aligned row and spans win_h rows, so it is listed in
// every block it covers.
//
// What bounds it on an H100: per (pixel, window) pair ~10 FP32 operations
// for the row test and coverage, and ~40 more for a covered pixel's
// alpha-only sample and blend; bytes are the framebuffer in and out (32 B a
// pixel) plus the window lists and sprite rows. With bevymark's overlap
// (hundreds of birds in the spawn corner) the serial walk per block and
// the per-pixel opaque skip decide the time.
//
// Design:
// - Window records (the sprite row, 17 floats, and the window's top row)
//   are staged 64 at a time into shared memory and read as broadcasts.
// - A pixel stops once its alpha is exactly 1.0: the reference skips a
//   window whose covered pixels are all opaque, the same test per pixel
//   (later terms are scaled by a transmittance of 0). The CTA stops when
//   all its pixels have.
// - `bilinear`, `bf16`, `rotated` and `alpha_only` are template parameters.
//   Sampling is two-tap per axis (the reference's tent matmuls with their
//   zeros dropped), both axes normalised, bf16 rounding after the
//   normalisation, the column pass first (rounded to bf16) and then the
//   row pass. Rotated coverage uses the reference's row/column affine
//   pieces, and its uv terms come from the window's first row and column,
//   as the reference's do.
// - The library builds with --fmad=false and '/' is IEEE division, so the
//   plain PyTorch version (ops/raster2d_splat.py) computes the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int WIN_W = 128;
constexpr int ROWS = 8;            // block height
constexpr int THREADS = WIN_W * ROWS;
constexpr int CHUNK = 64;          // windows staged per pass
constexpr int ROWW = 17;

struct Args {
  const float* fb;         // (4, H, W)
  const float* pk;         // (v, 17) front to back
  const int* win;          // (wcap, 3): pk row, column, top row
  const int* blk_win;      // window ids by block
  const int* blk_start;    // (ncols * nrb,)
  const int* blk_count;
  const float* atlas;      // (4, ah, aw)
  float* out;              // (4, H, W)
  int ah, aw, H, W, nrb, win_h;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BILINEAR>
__device__ __forceinline__ void taps(float f, int size, bool strict, int& k0,
                                     int& k1, float& w0, float& w1) {
  const float kf0 = floorf(f);
  const float last = (float)(size - 1);
  float w[2];
  int k[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float kf = i == 0 ? kf0 : kf0 + 1.0f;
    const float d = fabsf(kf - f);
    float wi;
    if constexpr (BILINEAR) {
      wi = fmaxf(1.0f - d, 0.0f);
    } else {
      wi = (strict ? d < 0.5f : d <= 0.5f) ? 1.0f : 0.0f;
    }
    w[i] = (kf >= 0.0f && kf <= last) ? wi : 0.0f;
    k[i] = (int)fminf(fmaxf(kf, 0.0f), last);
  }
  k0 = k[0];
  k1 = k[1];
  w0 = w[0];
  w1 = w[1];
}

// tex[c] for c in 0..3 (only tex[3] when ALPHA); lx, ly: the local offsets
// that carry the uv
template <bool BILINEAR, bool BF16, bool ALPHA>
__device__ __forceinline__ void sample(const Args& a, const float* d,
                                       float lx, float ly, float tex[4]) {
  const float hx = d[2], hy = d[3];
  const float u0 = d[10], v0 = d[11], u1 = d[12], v1 = d[13];
  const float sx = (u1 - u0) / fmaxf(2.0f * hx, 1e-6f);
  const float sy = (v1 - v0) / fmaxf(2.0f * hy, 1e-6f);
  float fx = u0 + (u1 - u0) * 0.5f + sx * lx;
  fx = fminf(fmaxf(fx, fminf(u0, u1)), fmaxf(u0, u1)) * (float)a.aw - 0.5f;
  float fy = v0 + (v1 - v0) * 0.5f + sy * ly;
  fy = fminf(fmaxf(fy, fminf(v0, v1)), fmaxf(v0, v1)) * (float)a.ah - 0.5f;
  int ky0, ky1, kx0, kx1;
  float wy0, wy1, wx0, wx1;
  taps<BILINEAR>(fy, a.ah, false, ky0, ky1, wy0, wy1);
  taps<BILINEAR>(fx, a.aw, true, kx0, kx1, wx0, wx1);
  const float ny = fmaxf(wy0 + wy1, 1e-6f);
  const float nx = fmaxf(wx0 + wx1, 1e-6f);
  wy0 = wy0 / ny;
  wy1 = wy1 / ny;
  wx0 = wx0 / nx;
  wx1 = wx1 / nx;
  if constexpr (BF16) {
    wy0 = bf16r(wy0);
    wy1 = bf16r(wy1);
    wx0 = bf16r(wx0);
    wx1 = bf16r(wx1);
  }
  const size_t plane = (size_t)a.ah * a.aw;
  const size_t r0 = (size_t)ky0 * a.aw, r1 = (size_t)ky1 * a.aw;
#pragma unroll
  for (int c = ALPHA ? 3 : 0; c < 4; ++c) {
    const float* A = a.atlas + c * plane;
    float t00 = __ldg(A + r0 + kx0), t01 = __ldg(A + r0 + kx1);
    float t10 = __ldg(A + r1 + kx0), t11 = __ldg(A + r1 + kx1);
    if constexpr (BF16) {
      t00 = bf16r(t00);
      t01 = bf16r(t01);
      t10 = bf16r(t10);
      t11 = bf16r(t11);
    }
    float m0 = t00 * wx0 + t01 * wx1;
    float m1 = t10 * wx0 + t11 * wx1;
    if constexpr (BF16) {
      m0 = bf16r(m0);
      m1 = bf16r(m1);
    }
    tex[c] = wy0 * m0 + wy1 * m1;
  }
}

template <bool BILINEAR, bool BF16, bool ROTATED, bool ALPHA>
__global__ void __launch_bounds__(THREADS) sprite_splat(Args a) {
  __shared__ float L[CHUNK * ROWW];
  __shared__ int WY[CHUNK];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * WIN_W + tx;
  const int col = blockIdx.x, rb = blockIdx.y;
  const int b = col * a.nrb + rb;
  const int x = col * WIN_W + tx, y = rb * ROWS + ty;
  const bool in = x < a.W && y < a.H;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float px0 = (float)(col * WIN_W) + 0.5f;
  const int cnt = a.blk_count[b];
  const int base = a.blk_start[b];

  float ar = 0.0f, ag = 0.0f, ab = 0.0f, aa = 0.0f;
  for (int c0 = 0; c0 < cnt; c0 += CHUNK) {
    // every pixel opaque: the rest of the list adds exactly nothing (this
    // barrier also closes the previous chunk before it is overwritten)
    if (__syncthreads_and(!in || aa == 1.0f)) break;
    const int n = min(CHUNK, cnt - c0);
    for (int i = tid; i < n * ROWW; i += THREADS) {
      const int k = i / ROWW, f = i - k * ROWW;
      const int w = a.blk_win[base + c0 + k];
      L[i] = a.pk[(size_t)a.win[3 * w] * ROWW + f];
    }
    if (tid < n) WY[tid] = a.win[3 * a.blk_win[base + c0 + tid] + 2];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (aa == 1.0f) break;
      const int wy0 = WY[j];
      if (y < wy0 || y >= wy0 + a.win_h) continue;
      const float* d = L + j * ROWW;
      const float cx = d[0], cy = d[1], hx = d[2], hy = d[3];
      float lx_row, ly_col;
      bool inside;
      if constexpr (ROTATED) {
        const float cs = d[4], sn = d[5];
        const float lxr = cs * px - (cs * cx + sn * cy);
        const float lyr = -sn * px + (sn * cx - cs * cy);
        const float lx = lxr + sn * py, ly = lyr + cs * py;
        inside = fabsf(lx) <= hx && fabsf(ly) <= hy;
        lx_row = lxr + sn * ((float)wy0 + 0.5f);
        ly_col = (-sn * px0 + (sn * cx - cs * cy)) + cs * py;
      } else {
        lx_row = px - cx;
        ly_col = py - cy;
        inside = fabsf(lx_row) <= hx && fabsf(ly_col) <= hy;
      }
      if (!inside) continue;
      float tex[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (d[14] >= 0.0f)
        sample<BILINEAR, BF16, ALPHA>(a, d, lx_row, ly_col, tex);
      const float tav = (1.0f - aa) * (tex[3] * d[9]);
      if constexpr (ALPHA) {
        ar = ar + d[6] * tav;
        ag = ag + d[7] * tav;
        ab = ab + d[8] * tav;
      } else {
        ar = ar + tex[0] * d[6] * tav;
        ag = ag + tex[1] * d[7] * tav;
        ab = ab + tex[2] * d[8] * tav;
      }
      aa = aa + tav;
    }
  }
  if (in) {
    const size_t plane = (size_t)a.H * a.W;
    const size_t pix = (size_t)y * a.W + x;
    const float ia = 1.0f - aa;
    a.out[pix] = a.fb[pix] * ia + ar;
    a.out[plane + pix] = a.fb[plane + pix] * ia + ag;
    a.out[2 * plane + pix] = a.fb[2 * plane + pix] * ia + ab;
    a.out[3 * plane + pix] = a.fb[3 * plane + pix] * ia + aa;
  }
}

using Launch = void (*)(const Args&, dim3, cudaStream_t);

template <int V>
void launch(const Args& a, dim3 grid, cudaStream_t s) {
  sprite_splat<(V & 1) != 0, (V & 2) != 0, (V & 4) != 0, (V & 8) != 0>
      <<<grid, dim3(WIN_W, ROWS), 0, s>>>(a);
}

template <int... V>
constexpr std::array<Launch, sizeof...(V)> make_table(
    std::integer_sequence<int, V...>) {
  return {{&launch<V>...}};
}

constexpr auto kLaunch = make_table(std::make_integer_sequence<int, 16>{});

}  // namespace

// fb (4, H, W) f32; pk (v, 17) f32; win (wcap, 3) int32; blk_win int32;
// blk_start, blk_count (ncols * nrb,) int32 with nrb 8-row blocks a
// column; atlas (4, ah, aw) f32; out (4, H, W) f32. variant bits: 1
// bilinear, 2 bf16, 4 rotated, 8 alpha_only. Returns cudaGetLastError().
extern "C" int bt_sprite_splat(const float* fb, const float* pk,
                               const int* win, const int* blk_win,
                               const int* blk_start, const int* blk_count,
                               const float* atlas, int ah, int aw, int H,
                               int W, int nrb, int win_h, int variant,
                               float* out, void* stream) {
  if (variant < 0 || variant >= 16 || ah <= 0 || aw <= 0 ||
      nrb * ROWS < H)
    return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  const Args a{fb, pk, win, blk_win, blk_start, blk_count, atlas, out,
               ah, aw, H,   W,       nrb,       win_h};
  const dim3 grid((W + WIN_W - 1) / WIN_W, nrb);
  kLaunch[variant](a, grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
