// Kernels B7 and B8: per-tile z-buffered triangle raster — each pixel walks
// its bin tile's triangle list in order and keeps the triangle whose
// interpolated depth beats its own strictly (reverse-z), writing Lambert +
// ambient + emissive colour, or the first 12 G-buffer planes.
//
// Replaces bevy_tpu/ops/raster3d_pallas.py (entry raster_tris_pallas):
// - B7 `_kernel` (layout "corners"): corner records, edge functions from the
//   corners, barycentrics times 1/area2, perspective-correct normals (the
//   interpolated premultiplied normal divided by the interpolated 1/w);
// - B8 `_plane_kernel` ("planes") and `_plane_kernel_gbuf` ("planes_gbuf"):
//   plane-equation records, every quantity one a*px + b*py + c.
// There, one grid step owned one tile in VMEM, DMA'd a per-tile transposed
// copy of its records (tiles x 40 x max_per_tile, 128-padded) into SMEM and
// walked it with the tile's pixels as vectors. Here one thread owns one
// pixel; a 256-thread CTA covers a 16x16 block inside one bin tile, so the
// 8 (16x128 tiles) or 16 (32x128) CTAs of a tile walk the same list.
//
// What bounds it on an H100: per (pixel, listed triangle) the edge tests are
// 18 FP32 operations (corners) or 15 (planes), a pixel inside the edges 9 or
// 5 more for its depth test, and a pixel that takes the triangle ~30-50
// more; bytes are the framebuffer and depth in and out plus 116 B (corners)
// or 132 B (planes) a listed record. At the many_cubes density (up to 3,072
// triangles a 16x128 tile) it is bound by operations on the serial walk.
//
// Design:
// - Records are read by id from the (T, 40) table through the tile's run in
//   the sorted pair list (no per-tile copy), 64 at a time into shared
//   memory (29 or 33 floats each); every thread then reads them as
//   broadcasts. A list may hold thousands of entries, so it is never staged
//   whole. Corner records also get their three edges staged there, once a
//   record, as the reference computes them once a triangle as scalars: a
//   float4 (edge vector, start corner) each, e.g. (cx-bx, cy-by, bx, by),
//   the same subtractions, so the same bits. The walk then reads a pair's
//   edge tests with three 16-byte broadcasts instead of six scalar loads
//   and six subtractions.
// - One thread walks its pixel's list in list order with a strict `z > dep`:
//   exactly the sequential result, so no atomics. A pixel outside a
//   triangle's edges, or behind the depth, skips the rest of that triangle
//   (the plain version computes it and discards it with a select: the same
//   bits where it is kept).
// - Template parameters: layout (corners, planes, planes_gbuf) x scissor
//   (off, on): six instantiations. The scissor rect rides the light vector's
//   slots 9..12, as in the reference.
// - Arithmetic in the reference body's order. The library builds with
//   --fmad=false and '/' is IEEE division; max(x, c) propagates NaN like
//   torch.clamp; the rsqrt is rsqrtf (MUFU.RSQ, not correctly rounded),
//   chosen because the plain PyTorch version's torch.rsqrt calls the same
//   function on the card (as kernel B3 does): so the kernel equals the
//   plain version bit for bit there.
// - Outputs are new buffers: the kernel reads fb/depth and writes out /
//   dep_out for every in-frame pixel; G-buffer planes 12 and up are copied
//   through.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 16;
constexpr int THREADS = BLK * BLK;
constexpr int CHUNK = 64;   // records staged per pass
constexpr int F_PAD = 40;   // table row width
enum { CORNERS = 0, PLANES = 1, PLANES_GBUF = 2 };
static_assert(CHUNK <= THREADS, "one thread sets up each staged record");

struct Args {
  const float* fb;       // (nplanes, H, W)
  const float* depth;    // (H, W)
  const float* table;    // (T, 40)
  const int* pair;       // (P,) triangle ids by tile
  const int* starts;     // (tiles,)
  const int* counts;     // (tiles,)
  const float* light;    // (16,) dir, light rgb, ambient rgb, scissor
  float* out;            // (nplanes, H, W)
  float* dep_out;        // (H, W)
  int nplanes, H, W, tile_h, tile_w, ntx;
};

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

template <int LAYOUT, bool SCISSOR>
__global__ void __launch_bounds__(THREADS) tri_raster(Args a) {
  constexpr int F = LAYOUT == CORNERS ? 29 : 33;   // fields read
  constexpr int NW = LAYOUT == PLANES_GBUF ? 12 : 4;  // planes written
  __shared__ float L[CHUNK * F];
  __shared__ float4 E[LAYOUT == CORNERS ? 3 * CHUNK : 1];  // corner edges
  const int tid = threadIdx.x;
  const int bx0 = blockIdx.x * BLK, by0 = blockIdx.y * BLK;
  const int x = bx0 + tid % BLK, y = by0 + tid / BLK;
  const bool in = x < a.W && y < a.H;
  const int t = (by0 / a.tile_h) * a.ntx + bx0 / a.tile_w;
  const int cnt = a.counts[t];
  const int base = a.starts[t];
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float* lt = a.light;
  const float ldx = lt[0], ldy = lt[1], ldz = lt[2];
  bool live = in;
  if constexpr (SCISSOR) {
    live = live && px >= lt[9] && py >= lt[10] && px < lt[11] && py < lt[12];
  }
  const size_t plane = (size_t)a.H * a.W;
  const size_t pix = in ? (size_t)y * a.W + x : 0;
  float dep = in ? a.depth[pix] : 0.0f;
  float v[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) v[k] = in ? a.fb[k * plane + pix] : 0.0f;

  for (int c0 = 0; c0 < cnt; c0 += CHUNK) {
    __syncthreads();   // the previous chunk is done before it is overwritten
    const int n = min(CHUNK, cnt - c0);
    for (int i = tid; i < n * F; i += THREADS) {
      const int k = i / F, f = i - k * F;
      const int row = a.pair[base + c0 + k];
      L[i] = a.table[(size_t)row * F_PAD + f];
    }
    if constexpr (LAYOUT == CORNERS) {
      __syncthreads();
      if (tid < n) {   // the edges of record tid (CHUNK <= THREADS)
        const float* d = L + tid * F;
        E[3 * tid] = make_float4(d[4] - d[2], d[5] - d[3], d[2], d[3]);
        E[3 * tid + 1] = make_float4(d[0] - d[4], d[1] - d[5], d[4], d[5]);
        E[3 * tid + 2] = make_float4(d[2] - d[0], d[3] - d[1], d[0], d[1]);
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* d = L + j * F;
      float z, iw, nx, ny, nz;
      const float *rgba, *emi;
      if constexpr (LAYOUT == CORNERS) {
        // (cx-bx)*(py-by) - (cy-by)*(px-bx), and so on round the corners
        const float4 g0 = E[3 * j], g1 = E[3 * j + 1], g2 = E[3 * j + 2];
        const float e0 = g0.x * (py - g0.w) - g0.y * (px - g0.z);
        const float e1 = g1.x * (py - g1.w) - g1.y * (px - g1.z);
        const float e2 = g2.x * (py - g2.w) - g2.y * (px - g2.z);
        if (!(e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f)) continue;
        const float b0 = e0 * d[12], b1 = e1 * d[12], b2 = e2 * d[12];
        z = b0 * d[6] + b1 * d[7] + b2 * d[8];
        if (!(z > dep)) continue;
        iw = clamp_min(b0 * d[9] + b1 * d[10] + b2 * d[11], 1e-12f);
        nx = (b0 * d[13] + b1 * d[16] + b2 * d[19]) / iw;
        ny = (b0 * d[14] + b1 * d[17] + b2 * d[20]) / iw;
        nz = (b0 * d[15] + b1 * d[18] + b2 * d[21]) / iw;
        rgba = d + 22;
        emi = d + 26;
      } else {
        if (!(d[0] * px + d[1] * py + d[2] <= 0.0f &&
              d[3] * px + d[4] * py + d[5] <= 0.0f &&
              d[6] * px + d[7] * py + d[8] <= 0.0f))
          continue;
        z = d[9] * px + d[10] * py + d[11];
        if (!(z > dep)) continue;
        iw = clamp_min(d[12] * px + d[13] * py + d[14], 1e-12f);
        nx = (d[15] * px + d[16] * py + d[17]) / iw;
        ny = (d[18] * px + d[19] * py + d[20]) / iw;
        nz = (d[21] * px + d[22] * py + d[23]) / iw;
        rgba = d + 24;
        emi = d + 28;
      }
      const float inv_len =
          rsqrtf(clamp_min(nx * nx + ny * ny + nz * nz, 1e-12f));
      if constexpr (LAYOUT == PLANES_GBUF) {
        v[0] = rgba[0];
        v[1] = rgba[1];
        v[2] = rgba[2];
        v[3] = rgba[3];
        v[4] = nx * inv_len;
        v[5] = ny * inv_len;
        v[6] = nz * inv_len;
        v[7] = emi[0];
        v[8] = emi[1];
        v[9] = emi[2];
        v[10] = d[31];
        v[11] = d[32];
      } else {
        const float lam =
            clamp_min(-(nx * ldx + ny * ldy + nz * ldz) * inv_len, 0.0f);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          v[k] = rgba[k] * (lt[6 + k] + lt[3 + k] * lam) + emi[k];
        v[3] = rgba[3];
      }
      dep = z;
    }
  }
  if (in) {
#pragma unroll
    for (int k = 0; k < NW; ++k) a.out[k * plane + pix] = v[k];
    for (int k = NW; k < a.nplanes; ++k)
      a.out[k * plane + pix] = a.fb[k * plane + pix];
    a.dep_out[pix] = dep;
  }
}

template <int LAYOUT>
void launch(const Args& a, bool scissor, dim3 grid, cudaStream_t s) {
  if (scissor)
    tri_raster<LAYOUT, true><<<grid, THREADS, 0, s>>>(a);
  else
    tri_raster<LAYOUT, false><<<grid, THREADS, 0, s>>>(a);
}

}  // namespace

// fb (nplanes, H, W) f32 (nplanes 4, or >= 12 for layout 2); depth (H, W)
// f32; table (T, 40) f32; pair (P,) int32; starts, counts (tiles,) int32
// with tiles = ceil(H / tile_h) * ntx; light (16,) f32; layout 0 corners,
// 1 planes, 2 planes_gbuf; out (nplanes, H, W), dep_out (H, W) f32. tile_h
// and tile_w are multiples of 16. Returns cudaGetLastError().
extern "C" int bt_tri_raster(const float* fb, const float* depth,
                             const float* table, const int* pair,
                             const int* starts, const int* counts,
                             const float* light, int nplanes, int H, int W,
                             int tile_h, int tile_w, int ntx, int layout,
                             int scissor, float* out, float* dep_out,
                             void* stream) {
  if (tile_h % BLK || tile_w % BLK || layout < 0 || layout > 2 ||
      nplanes < (layout == PLANES_GBUF ? 12 : 4))
    return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  const Args a{fb,  depth,   table, pair,   starts, counts, light, out,
               dep_out, nplanes, H,     W,      tile_h, tile_w, ntx};
  const dim3 grid((W + BLK - 1) / BLK, (H + BLK - 1) / BLK);
  cudaStream_t s = (cudaStream_t)stream;
  if (layout == CORNERS)
    launch<CORNERS>(a, scissor != 0, grid, s);
  else if (layout == PLANES)
    launch<PLANES>(a, scissor != 0, grid, s);
  else
    launch<PLANES_GBUF>(a, scissor != 0, grid, s);
  return (int)cudaGetLastError();
}
