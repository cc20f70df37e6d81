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
// order, so each pixel has one owner that walks its 8-row block's window
// list, which the preparation (ops/raster2d_splat.py) sorted stably by
// block, so it is the global front-to-back order restricted to the block.
// A window starts on any 8-aligned row and spans win_h rows, so it is
// listed in every block it covers.
//
// What bounds it on an H100: bytes — the framebuffer in and out (32 B a
// pixel), the window lists and sprite rows — and, per (pixel, window) pair
// inside the sprite, its alpha-only sample and blend (~100 FP32
// operations). Under bevymark's spawn corner some 8-row blocks list 2,600
// windows while the median block lists none, and a pixel on the rim of the
// spawn pile, where the birds' alpha is fractional, blends windows one
// after another for most of that list before its alpha reaches 1.0: that
// warp's serial walk, one sample and blend a window, sets the time.
//
// Design:
// - A CTA owns 32 columns x 8 rows of a block (one warp a row), so a
//   128-column block's list is walked by four CTAs on four SMs. Every pixel
//   still walks its block's whole list in the same order, so every pixel's
//   result is the same bits as with one CTA a block.
// - Window records (the sprite row, 17 floats, and the window's top row)
//   are staged 64 at a time into shared memory with cp.async,
//   double-buffered: each thread that stages a window issues its row's
//   copies, and the ids of the chunk after next (blk_win -> win) are loaded
//   into registers while the current chunk is walked.
// - The cull. Each warp keeps a staged window only if it can cover a pixel
//   of the warp's row segment, and compacts the survivors in list order
//   (warp ballot, popcount prefix). It keeps one iff the window's rows hold
//   the warp's row and, in the walk's own arithmetic:
//   - unrotated: |py - cy| <= hy on the row (exactly the walk's row term),
//     and neither px - cx > hx at the segment's first centre nor px - cx <
//     -hx at its last;
//   - rotated: neither local coordinate (lx or ly, each as the walk computes
//     it) lies past the same side of [-h, h] at both end centres.
//   Correct rounding is monotone, so fl(px - cx), and lx and ly with their
//   constant row terms, are monotone in px along the row: a coordinate past
//   one side of [-h, h] at both ends is past it at every centre between
//   (NaN keeps the window), so a dropped window covers no pixel of the warp.
//   raster2d_splat.sprite_in_warp replays these decisions in PyTorch.
// - A pixel stops once its alpha is exactly 1.0: the reference skips a
//   window whose covered pixels are all opaque, the same test per pixel
//   (later terms are scaled by a transmittance of 0). A warp skips a chunk
//   when all its pixels have stopped, and the CTA stops when all its pixels
//   have.
// - `bilinear`, `bf16`, `rotated` and `alpha_only` are template parameters.
//   Sampling is two-tap per axis (the reference's tent matmuls with their
//   zeros dropped), both axes normalised, bf16 rounding after the
//   normalisation, the column pass first (rounded to bf16) and then the
//   row pass. Rotated coverage uses the reference's row/column affine
//   pieces, and its uv terms come from the window's first row and column,
//   as the reference's do. The sample's row terms (the row taps and their
//   normalised weights, the column scale: four of its six IEEE divisions)
//   are the same for a window across a warp's row: the culling lane
//   computes them once, in the same arithmetic, beside the survivor.
// - The library builds with --fmad=false and '/' is IEEE division, so the
//   plain PyTorch version (ops/raster2d_splat.py) computes the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int WIN_W = 128;         // a block's column strip
constexpr int CTA_W = 32;          // a CTA's columns: one warp a row
constexpr int ROWS = 8;            // block height
constexpr int THREADS = CTA_W * ROWS;
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

// The sample's terms that one window shares across a row of pixels: the
// row taps (offsets ky * aw into a plane, weights normalised and, for bf16,
// rounded) at the row's local offset ly, and the column scale sx.
struct RowTaps {
  int r0, r1;
  float w0, w1, sx;
};

template <bool BILINEAR, bool BF16>
__device__ __forceinline__ RowTaps row_taps(const Args& a, const float* d,
                                            float ly) {
  const float hx = d[2], hy = d[3];
  const float u0 = d[10], v0 = d[11], u1 = d[12], v1 = d[13];
  RowTaps t;
  t.sx = (u1 - u0) / fmaxf(2.0f * hx, 1e-6f);
  const float sy = (v1 - v0) / fmaxf(2.0f * hy, 1e-6f);
  float fy = v0 + (v1 - v0) * 0.5f + sy * ly;
  fy = fminf(fmaxf(fy, fminf(v0, v1)), fmaxf(v0, v1)) * (float)a.ah - 0.5f;
  int ky0, ky1;
  float wy0, wy1;
  taps<BILINEAR>(fy, a.ah, false, ky0, ky1, wy0, wy1);
  const float ny = fmaxf(wy0 + wy1, 1e-6f);
  wy0 = wy0 / ny;
  wy1 = wy1 / ny;
  if constexpr (BF16) {
    wy0 = bf16r(wy0);
    wy1 = bf16r(wy1);
  }
  t.r0 = ky0 * a.aw;
  t.r1 = ky1 * a.aw;
  t.w0 = wy0;
  t.w1 = wy1;
  return t;
}

// tex[c] for c in 0..3 (only tex[3] when ALPHA) at the column offset lx,
// with the row's terms from row_taps
template <bool BILINEAR, bool BF16, bool ALPHA>
__device__ __forceinline__ void sample(const Args& a, const float* d,
                                       const RowTaps& ty, float lx,
                                       float tex[4]) {
  const float u0 = d[10], u1 = d[12];
  float fx = u0 + (u1 - u0) * 0.5f + ty.sx * lx;
  fx = fminf(fmaxf(fx, fminf(u0, u1)), fmaxf(u0, u1)) * (float)a.aw - 0.5f;
  int kx0, kx1;
  float wx0, wx1;
  taps<BILINEAR>(fx, a.aw, true, kx0, kx1, wx0, wx1);
  const float nx = fmaxf(wx0 + wx1, 1e-6f);
  wx0 = wx0 / nx;
  wx1 = wx1 / nx;
  if constexpr (BF16) {
    wx0 = bf16r(wx0);
    wx1 = bf16r(wx1);
  }
  const size_t plane = (size_t)a.ah * a.aw;
#pragma unroll
  for (int c = ALPHA ? 3 : 0; c < 4; ++c) {
    const float* A = a.atlas + c * plane;
    float t00 = __ldg(A + ty.r0 + kx0), t01 = __ldg(A + ty.r0 + kx1);
    float t10 = __ldg(A + ty.r1 + kx0), t11 = __ldg(A + ty.r1 + kx1);
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
    tex[c] = ty.w0 * m0 + ty.w1 * m1;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// true unless sprite d surely covers no pixel centre of the row segment
// [pxa, pxb] at py (the walk's arithmetic; see the header)
template <bool ROTATED>
__device__ __forceinline__ bool may_cover(const float* d, float pxa,
                                          float pxb, float py) {
  const float cx = d[0], cy = d[1], hx = d[2], hy = d[3];
  if constexpr (ROTATED) {
    const float cs = d[4], sn = d[5];
    const float kx = cs * cx + sn * cy, ky = sn * cx - cs * cy;
    const float lxa = (cs * pxa - kx) + sn * py;
    const float lxb = (cs * pxb - kx) + sn * py;
    const float lya = (-sn * pxa + ky) + cs * py;
    const float lyb = (-sn * pxb + ky) + cs * py;
    return !((lxa > hx && lxb > hx) || (lxa < -hx && lxb < -hx) ||
             (lya > hy && lyb > hy) || (lya < -hy && lyb < -hy));
  } else {
    return fabsf(py - cy) <= hy && !(pxa - cx > hx) && !(pxb - cx < -hx);
  }
}

template <bool BILINEAR, bool BF16, bool ROTATED, bool ALPHA>
__global__ void __launch_bounds__(THREADS) sprite_splat(Args a) {
  __shared__ float L[2][CHUNK * ROWW];
  __shared__ int WY[2][CHUNK];
  __shared__ unsigned char KEEP[ROWS][CHUNK];
  __shared__ RowTaps TY[ROWS][CHUNK];  // the kept windows' row terms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = blockIdx.x / (WIN_W / CTA_W);
  const int x0 = blockIdx.x * CTA_W;  // the warp's first column
  const int b = col * a.nrb + blockIdx.y;
  const int x = x0 + lane, y = blockIdx.y * ROWS + warp;
  const bool in = x < a.W && y < a.H;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float pxa = (float)x0 + 0.5f, pxb = (float)(x0 + CTA_W - 1) + 0.5f;
  const float px0 = (float)(col * WIN_W) + 0.5f;
  const int cnt = a.blk_count[b];
  const int base = a.blk_start[b];

  // staging: thread k < n of a chunk stages its window k; `rid`/`wy` hold
  // the ids of the next chunk to stage
  int rid = 0, wyn = 0;
  auto load_ids = [&](int c0) {
    if (c0 + tid < cnt && tid < CHUNK) {
      const int w = a.blk_win[base + c0 + tid];
      rid = a.win[3 * w];
      wyn = a.win[3 * w + 2];
    }
  };
  auto stage = [&](int buf, int c0) {
    if (c0 + tid < cnt && tid < CHUNK) {
      WY[buf][tid] = wyn;
      const float* src = a.pk + (size_t)rid * ROWW;
#pragma unroll
      for (int f = 0; f < ROWW; ++f) cp_async4(&L[buf][tid * ROWW + f], src + f);
    }
    cp_async_commit();
  };
  if (cnt > 0) {
    load_ids(0);
    stage(0, 0);
    load_ids(CHUNK);
  }

  float ar = 0.0f, ag = 0.0f, ab = 0.0f, aa = 0.0f;
  int buf = 0;
  for (int c0 = 0; c0 < cnt; c0 += CHUNK, buf ^= 1) {
    cp_async_wait_all();
    // every pixel opaque: the rest of the list adds exactly nothing (this
    // barrier also lands chunk c0 and closes the walk of the chunk before)
    if (__syncthreads_and(!in || aa == 1.0f)) break;
    if (c0 + CHUNK < cnt) {
      stage(buf ^ 1, c0 + CHUNK);
      load_ids(c0 + 2 * CHUNK);
    }
    if (__all_sync(0xffffffffu, !in || aa == 1.0f)) continue;
    const int n = min(CHUNK, cnt - c0);
    const float* Lb = L[buf];
    int m = 0;
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int k = k0 + lane;
      const float* d = Lb + k * ROWW;
      bool keep = false;
      if (k < n) {
        const int wy0 = WY[buf][k];
        keep = y >= wy0 && y < wy0 + a.win_h &&
               may_cover<ROTATED>(d, pxa, pxb, py);
      }
      const unsigned ball = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int i = m + __popc(ball & ((1u << lane) - 1u));
        KEEP[warp][i] = k;
        if (d[14] >= 0.0f) {
          // the uv row term, as the walk has it: py - cy, or the
          // rotated ly on the window's first column
          float ly_col = py - d[1];
          if constexpr (ROTATED)
            ly_col = (-d[5] * px0 + (d[5] * d[0] - d[4] * d[1])) + d[4] * py;
          TY[warp][i] = row_taps<BILINEAR, BF16>(a, d, ly_col);
        }
      }
      m += __popc(ball);
    }
    __syncwarp();
    for (int i = 0; i < m; ++i) {
      if (!in || aa == 1.0f) break;
      const int j = KEEP[warp][i];
      const float* d = Lb + j * ROWW;
      const float cx = d[0], cy = d[1], hx = d[2], hy = d[3];
      float lx_row;
      bool inside;
      if constexpr (ROTATED) {
        const float cs = d[4], sn = d[5];
        const float lxr = cs * px - (cs * cx + sn * cy);
        const float lyr = -sn * px + (sn * cx - cs * cy);
        const float lx = lxr + sn * py, ly = lyr + cs * py;
        inside = fabsf(lx) <= hx && fabsf(ly) <= hy;
        lx_row = lxr + sn * ((float)WY[buf][j] + 0.5f);
      } else {
        lx_row = px - cx;
        inside = fabsf(lx_row) <= hx && fabsf(py - cy) <= hy;
      }
      if (!inside) continue;
      float tex[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (d[14] >= 0.0f)
        sample<BILINEAR, BF16, ALPHA>(a, d, TY[warp][i], lx_row, tex);
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
  cp_async_wait_all();
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
      <<<grid, THREADS, 0, s>>>(a);
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
  const dim3 grid((W + WIN_W - 1) / WIN_W * (WIN_W / CTA_W), nrb);
  kLaunch[variant](a, grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
