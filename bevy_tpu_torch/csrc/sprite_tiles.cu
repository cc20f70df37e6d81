// Kernel B4: tile-binned sprite raster — each pixel under-composites its
// bin tile's sprite run front to back, sampling the texture atlas with
// separable tent weights, and merges the result over the framebuffer.
//
// Replaces bevy_tpu/ops/raster2d_pallas.py::_kernel and ::_kernel_batched
// (entry raster_sprites_pallas). There, one grid step owned one 32x128
// tile in VMEM: it DMA'd the tile's sprite table (lane-padded) and walked
// it with the tile's pixels as vectors, sampling with two small tent-weight
// matmuls per channel (the batched body stacked 8 sprites a step and
// composited them with a halves-pairing tree). Here one thread owns one
// pixel; a 256-thread CTA covers a 16x16 block inside one bin tile, so the
// 16 CTAs of a 32x128 tile read the same run.
//
// What bounds it on an H100: per covered (pixel, sprite) pair the coverage
// test is ~12 FP32 operations, the blend 16 and a textured sample ~110;
// bytes are the framebuffer in and out (32 B a pixel) plus 68 B a listed
// sprite row. At many_sprites' density (6-px sprites on an 8-px pitch, ~70
// listed a tile) a 16x16 block meets only 4-9 of its tile's sprites, so a
// walk of the whole run tests ~70 pairs a pixel for at most one covered.
//
// Design:
// - The cull. The CTA takes its tile's run front-most first, 256 listed
//   sprites a pass, one a thread: the thread reads the sprite's centre,
//   half size, cos and sin and drops it iff it covers no pixel centre of
//   the block. The survivors are compacted in order (warp ballot,
//   popcount, the warps' totals in shared memory) and their 17-float rows
//   staged in shared memory; every thread then walks only those, as
//   broadcasts.
// - Why the cull is exact. The walk's coverage test is |lx| <= hx and
//   |ly| <= hy with lx = cos*(px - cx) + sin*(py - cy), ly = -sin*(px - cx)
//   + cos*(py - cy), each step rounded (--fmad=false). Correct rounding is
//   monotone, so lx is monotone in px for a fixed py (with the sign of
//   cos) and in py for a fixed px (with the sign of sin): over the block's
//   centres it is least and greatest at the corners those signs pick, and
//   likewise ly (signs of -sin and cos). A sprite is dropped iff lx lies
//   wholly past one side of [-hx, hx], or ly of [-hy, hy], at those
//   corners, in the walk's own arithmetic; a NaN fails every comparison
//   and keeps it. A dropped sprite is then outside every pixel of the
//   block, where the full walk skips it too (its alpha term is 0), so the
//   image is the full walk's bit for bit. raster2d.sprite_in_block
//   replays these decisions in PyTorch.
// - A pixel stops walking once its alpha is exactly 1.0 (every later term
//   is scaled by a transmittance of 0, so the image equals the full walk),
//   and the CTA stops taking passes when all its pixels have.
// - `bilinear` and `bf16` are template parameters. Each weight axis has at
//   most two non-zero taps, so the reference's matmuls become two-tap sums
//   (adding zeros is exact); f32 follows _kernel's order (both axes
//   normalised, rows then columns), bf16 follows _kernel_batched's (row
//   weights normalised then rounded, row pass rounded to bf16, column
//   weights rounded unnormalised, 1/sum applied after the column pass).
// - The library builds with --fmad=false and '/' is IEEE division, so the
//   plain PyTorch version (ops/raster2d.py) computes the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 16;
constexpr int THREADS = BLK * BLK;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS;  // listed sprites culled per pass, one a thread
constexpr int ROWW = 17;        // packed sprite row width
constexpr int MIN_CTAS = 6;     // CTAs an SM

struct Args {
  const float* fb;       // (4, H, W)
  const float* pk;       // (v, 17) back to front
  const int* pair;       // (P,) rows of pk by tile
  const int* starts;     // (T,)
  const int* counts;     // (T,)
  const float* atlas;    // (4, ah, aw)
  float* out;            // (4, H, W)
  int ah, aw, H, W, tile_h, tile_w, ntx;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The two candidate taps floor(f) and floor(f) + 1 of one weight axis:
// tent weights (or nearest: |k - f| <= 0.5, < 0.5 when strict), 0 outside
// [0, size); indices clamped into range.
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

template <bool BILINEAR, bool BF16>
__device__ __forceinline__ void sample(const Args& a, const float* d,
                                       float px, float py, float tex[4]) {
  const float cx = d[0], cy = d[1], hx = d[2], hy = d[3];
  const float u0 = d[10], v0 = d[11], u1 = d[12], v1 = d[13];
  const float inv2hx = 1.0f / fmaxf(2.0f * hx, 1e-6f);
  const float inv2hy = 1.0f / fmaxf(2.0f * hy, 1e-6f);
  const float uu = (px - cx) * inv2hx + 0.5f;
  const float vv = (py - cy) * inv2hy + 0.5f;
  const float fx =
      fminf(fmaxf(u0 + uu * (u1 - u0), fminf(u0, u1)), fmaxf(u0, u1)) *
          (float)a.aw -
      0.5f;
  const float fy =
      fminf(fmaxf(v0 + vv * (v1 - v0), fminf(v0, v1)), fmaxf(v0, v1)) *
          (float)a.ah -
      0.5f;
  int ky0, ky1, kx0, kx1;
  float wy0, wy1, wx0, wx1;
  taps<BILINEAR>(fy, a.ah, false, ky0, ky1, wy0, wy1);
  taps<BILINEAR>(fx, a.aw, true, kx0, kx1, wx0, wx1);
  const float ny = fmaxf(wy0 + wy1, 1e-6f);
  wy0 = wy0 / ny;
  wy1 = wy1 / ny;
  const float nx = fmaxf(wx0 + wx1, 1e-6f);
  float inv_nx = 0.0f;
  if constexpr (BF16) {
    wy0 = bf16r(wy0);
    wy1 = bf16r(wy1);
    wx0 = bf16r(wx0);
    wx1 = bf16r(wx1);
    inv_nx = 1.0f / nx;
  } else {
    wx0 = wx0 / nx;
    wx1 = wx1 / nx;
  }
  const size_t plane = (size_t)a.ah * a.aw;
  const size_t i00 = (size_t)ky0 * a.aw + kx0, i10 = (size_t)ky1 * a.aw + kx0;
  const size_t i01 = (size_t)ky0 * a.aw + kx1, i11 = (size_t)ky1 * a.aw + kx1;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* A = a.atlas + c * plane;
    float t00 = __ldg(A + i00), t10 = __ldg(A + i10);
    float t01 = __ldg(A + i01), t11 = __ldg(A + i11);
    if constexpr (BF16) {
      t00 = bf16r(t00);
      t10 = bf16r(t10);
      t01 = bf16r(t01);
      t11 = bf16r(t11);
    }
    const float r0 = wy0 * t00 + wy1 * t10;
    const float r1 = wy0 * t01 + wy1 * t11;
    if constexpr (BF16) {
      tex[c] = (bf16r(r0) * wx0 + bf16r(r1) * wx1) * inv_nx;
    } else {
      tex[c] = r0 * wx0 + r1 * wx1;
    }
  }
}

// a*(px - cx) + b*(py - cy) in the walk's order of rounding
__device__ __forceinline__ float local(float a, float b, float px, float py,
                                       float cx, float cy) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(px, cx)),
                   __fmul_rn(b, __fsub_rn(py, cy)));
}

// true iff sprite (cx, cy, hx, hy, cos c, sin s) covers no pixel centre of
// the BLK x BLK block at (x0, y0) in the walk's arithmetic: lx or ly lies
// wholly past one side of its range at the corners where it is least and
// greatest (NaN keeps)
__device__ __forceinline__ bool outside_block(const float* d, int x0,
                                              int y0) {
  const float cx = d[0], cy = d[1], hx = d[2], hy = d[3], c = d[4],
              s = d[5], ns = -s;
  const float xa = (float)x0 + 0.5f, xb = (float)(x0 + BLK - 1) + 0.5f;
  const float ya = (float)y0 + 0.5f, yb = (float)(y0 + BLK - 1) + 0.5f;
  const float lx_lo = local(c, s, c >= 0.0f ? xa : xb, s >= 0.0f ? ya : yb,
                            cx, cy);
  const float lx_hi = local(c, s, c >= 0.0f ? xb : xa, s >= 0.0f ? yb : ya,
                            cx, cy);
  const float ly_lo = local(ns, c, ns >= 0.0f ? xa : xb, c >= 0.0f ? ya : yb,
                            cx, cy);
  const float ly_hi = local(ns, c, ns >= 0.0f ? xb : xa, c >= 0.0f ? yb : ya,
                            cx, cy);
  return lx_lo > hx || lx_hi < -hx || ly_lo > hy || ly_hi < -hy;
}

// one step of the walk: sprite row r under-composited at pixel (px, py)
// if it covers it
template <bool BILINEAR, bool BF16>
__device__ __forceinline__ void walk_step(const Args& a, const float* r,
                                          float px, float py, float& pr,
                                          float& pg, float& pb, float& pa) {
  const float dx = px - r[0], dy = py - r[1];
  const float lx = r[4] * dx + r[5] * dy;
  const float ly = -r[5] * dx + r[4] * dy;
  if (!(fabsf(lx) <= r[2] && fabsf(ly) <= r[3])) return;
  float tex[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  if (r[14] >= 0.0f) sample<BILINEAR, BF16>(a, r, px, py, tex);
  const float al = tex[3] * r[9];
  const float t_ = 1.0f - pa;
  pr = pr + t_ * tex[0] * r[6] * al;
  pg = pg + t_ * tex[1] * r[7] * al;
  pb = pb + t_ * tex[2] * r[8] * al;
  pa = pa + t_ * al;
}

// MIN_CTAS: at most 40 registers a thread (measured on an H100, PERF.md:
// fewer CTAs an SM, a per-warp second cull, or staging whole rows in the
// cull pass were slower)
template <bool BILINEAR, bool BF16>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) sprite_tiles(Args a) {
  __shared__ float L[CHUNK * ROWW];
  __shared__ int warp_kept[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx0 = blockIdx.x * BLK, by0 = blockIdx.y * BLK;
  const int x = bx0 + tid % BLK, y = by0 + tid / BLK;
  const bool in = x < a.W && y < a.H;
  const int t = (by0 / a.tile_h) * a.ntx + bx0 / a.tile_w;
  const int cnt = a.counts[t];
  const int base = a.starts[t];
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;

  float pr = 0.0f, pg = 0.0f, pb = 0.0f, pa = 0.0f;
  for (int c0 = 0; c0 < cnt; c0 += CHUNK) {
    // every pixel opaque: the rest of the run adds exactly nothing (this
    // barrier also closes the previous pass's walk before its rows and
    // counts are overwritten)
    if (__syncthreads_and(!in || pa == 1.0f)) break;
    // the cull: listed sprite c0 + tid from the front
    const float* d = nullptr;
    bool keep = false;
    if (c0 + tid < cnt) {
      d = a.pk + (size_t)a.pair[base + cnt - 1 - c0 - tid] * ROWW;
      keep = !outside_block(d, bx0, by0);
    }
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ball);
    __syncthreads();
    int k = __popc(ball & ((1u << lane) - 1u)), n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_kept[w];
      k += w < warp ? c : 0;
      n += c;
    }
    if (keep) {  // stage the survivor's row in order
#pragma unroll
      for (int f = 0; f < ROWW; ++f) L[k * ROWW + f] = d[f];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (pa == 1.0f) break;
      walk_step<BILINEAR, BF16>(a, L + j * ROWW, px, py, pr, pg, pb, pa);
    }
  }
  if (in) {
    const size_t plane = (size_t)a.H * a.W;
    const size_t pix = (size_t)y * a.W + x;
    const float ia = 1.0f - pa;
    a.out[pix] = a.fb[pix] * ia + pr;
    a.out[plane + pix] = a.fb[plane + pix] * ia + pg;
    a.out[2 * plane + pix] = a.fb[2 * plane + pix] * ia + pb;
    a.out[3 * plane + pix] = a.fb[3 * plane + pix] * ia + pa;
  }
}

}  // namespace

// fb (4, H, W) f32; pk (v, 17) f32; pair (P,) int32; starts, counts (T,)
// int32 with T = ceil(H/tile_h) * ntx; atlas (4, ah, aw) f32; out
// (4, H, W) f32. tile_h and tile_w are multiples of 16. Returns
// cudaGetLastError().
extern "C" int bt_sprite_tiles(const float* fb, const float* pk,
                               const int* pair, const int* starts,
                               const int* counts, const float* atlas, int ah,
                               int aw, int H, int W, int tile_h, int tile_w,
                               int ntx, int bilinear, int bf16, float* out,
                               void* stream) {
  if (tile_h % BLK || tile_w % BLK || ah <= 0 || aw <= 0)
    return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  const Args a{fb, pk, pair, starts, counts, atlas, out, ah,
               aw, H,  W,    tile_h, tile_w, ntx};
  const dim3 grid((W + BLK - 1) / BLK, (H + BLK - 1) / BLK);
  cudaStream_t s = (cudaStream_t)stream;
  if (bilinear && bf16)
    sprite_tiles<true, true><<<grid, THREADS, 0, s>>>(a);
  else if (bilinear)
    sprite_tiles<true, false><<<grid, THREADS, 0, s>>>(a);
  else if (bf16)
    sprite_tiles<false, true><<<grid, THREADS, 0, s>>>(a);
  else
    sprite_tiles<false, false><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
