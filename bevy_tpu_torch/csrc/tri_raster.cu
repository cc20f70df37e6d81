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
// pixel; a 256-thread CTA covers a 16x16 block inside one bin tile.
//
// What bounds it on an H100: the work the inputs need is the edge and depth
// tests of the (pixel, triangle) pairs inside the edges, the shade of each
// covered pixel, and bytes: the framebuffer and depth in and out, and of
// each record what its triangle needs: the edges of a listed one (24 B
// corners, 36 B planes), the depth of one inside at some pixel (16 B,
// 12 B) and the shade of one that wins a pixel (76 B; planes_gbuf 84 B).
// Bytes set the bound at 160k cubes. The reference walks every
// pair of a tile's list instead — 18 FP32 operations (corners) or 15
// (planes) each — and at the many_cubes density (up to 3,072 triangles a
// 16x128 tile, a few pixels each) about 1% of those pairs are inside. So
// both cull the list to what can touch each CTA's block before they walk,
// and shade each pixel's winner once.
//
// B7 (corners), the culled walk:
// - The list is culled 256 entries a pass, one thread an entry: the thread
//   reads the record's six corner floats, whose min / max is exactly the
//   screen AABB that triangle_setup_corners gave bin_tris, and keeps the
//   entry iff that AABB overlaps the CTA's block by bin_tris' own floor
//   rule at 16-px granularity (floor(min / 16) <= block <= floor(max / 16)),
//   unless the entry is a sliver (below), which every block keeps.
// - Why the cull is exact, slivers aside. Every pixel centre P of a block
//   the AABB misses lies t >= 1/2 px beyond it along x or y; P is in one
//   of the tiles the AABB spans, so |P - vertex| <= M + tile side per
//   axis, M the AABB's longer side. Exactly, with barycentrics l_i of P,
//   some l_i <= -t / (2M), and that edge's value is -l_i |area2| >=
//   |area2| / (4M). The float edge value (the edge vector rounded, then
//   two products and a difference) errs by at most ~3 ulp-units of
//   |dx| |py - by| + |dy| |px - bx| <= M (2M + tile_h + tile_w), i.e.
//   3 * 2^-24 of it. So if |area2| > 12 * 2^-24 M^2 (2M + tile_h +
//   tile_w), that edge reads > 0 and P reads outside, as the plain
//   version finds it. B7 tests |area2| (from the corners, in
//   triangle_setup_corners' order; its own rounding is far inside the
//   margin) against 2^-19 = 32 * 2^-24 of that product; an entry at or
//   below it is a sliver, kept in every block with the full row range.
//   A sliver's float edges can read inside beyond its AABB: a 53-px one,
//   |area2| 5e-5, reads inside 18 px past its AABB (SLIVER_CORNERS in
//   tests/torch_scenes.py). The tile binning has the same blind spot at
//   tile edges (bin_tris, and the reference's): there it stays, as the
//   reference behaviour. chip_smoke.py counts the dropped pairs that were inside
//   and asserts 0.
// - A warp ballot, a popcount prefix and a scan of the eight warps' totals
//   compact the survivors in list order. The culling thread writes its
//   survivor's three edges (float4: edge vector, start corner, e.g.
//   (cx-bx, cy-by, bx, by) — the walk's subtractions, so the same bits),
//   its depths and 1/area2 (a float4) and its row range to shared memory:
//   no other field is staged.
// - Each warp owns two rows of the block and skips a survivor whose AABB
//   misses them, by the same floor rule at 2-row granularity (a centre
//   outside the rows is again >= 1/2 px beyond the AABB): uniform within
//   the warp, exact for the same reason.
// - The walk stays the reference's: one thread a pixel, in list order, with
//   a strict `z > dep` (ties keep the first, no atomics) and the same
//   arithmetic. It keeps the row of the last triangle that passed, and the
//   pixel shades that winner once at the end, from its record, in the same
//   arithmetic: the colour the reference's last taken pair wrote, so B7
//   equals the plain version (which walks the whole list and also shades
//   only the winner) bit for bit. At 160k cubes a covered pixel passes the
//   depth test ~13 times; the shade's three IEEE divisions ran each time.
// - The next pass's corners are not prefetched during the walk: the cull
//   reads 28 B an entry from L2, and the walk dominates.
//
// B8 (planes, planes_gbuf), the culled walk:
// - Plane records carry no corners, so B7's AABB test has nothing to test.
//   The edges themselves are planes e(px, py) = a*px + b*py + c, which the
//   walk evaluates as (a*px + b*py) + c with each product and sum rounded
//   (--fmad=false). Rounding is monotone, so over a block's pixel centres
//   e is least at the corner picked by the signs of a and b, and the cull
//   evaluates it there in the same arithmetic: if it reads > 0, every
//   centre of the block reads > 0 and is outside, exactly as the walk
//   finds it. So the cull needs no margin and no sliver rule (a sliver's
//   own arithmetic is what is tested), and a NaN there keeps the entry.
// - The list is culled 256 entries a pass, one thread an entry reading only
//   the 9 edge floats of its record. An entry kept for the 16x16 block is
//   tested again over each warp's two rows (the same corner test, rows
//   picked by b's sign), giving a mask of the warps whose rows some pixel
//   of it could be inside; an entry with no such warp is dropped. (A warp
//   that passes implies the block passes: its rows are a subset.)
// - Survivors are compacted in list order (ballot, popcount, a scan of the
//   eight warps' totals, as B7) and staged as their 9 edge and 3 depth
//   floats (three 16-byte loads), their table row and their warp mask; a
//   warp skips a survivor whose mask misses it (uniform within the warp).
// - The cull is a chain of dependent loads (run, pair index, record) a
//   pass, so it is pipelined: a pass's records are loaded, and the next
//   pass's pair indices, while the previous pass is walked.
// - The walk is the reference's, one thread a pixel in list order with a
//   strict z > dep, keeping the row of the last triangle that passed; the
//   pixel shades that winner once at the end from its record in global
//   memory (fields 12:31 forward, 12:33 for planes_gbuf) in the same
//   arithmetic: the bits the reference's last taken pair wrote, which the
//   plain version also computes by shading only the winner. At 160k cubes
//   a covered pixel passed the depth test ~13 times, and the first design
//   shaded each time (three IEEE divisions and an rsqrt); it also staged
//   all 33 floats of every listed record.
// - Measured on an H100 at the 160k cubes (variant calls, PERF.md): the
//   cull alone takes a large share of the call; the pipeline and at most
//   48 registers (5 CTAs an SM) each made the call faster, 40 registers
//   spilled; the warp mask saves no time there (a variant without it was
//   as fast), since the plane cull already keeps few entries a block.
//
// Both: a pixel outside a triangle's edges, or behind the depth, skips the
// rest of that triangle (the plain version computes it and discards it
// with a select: the same bits where it is kept). Template parameters:
// layout (corners, planes, planes_gbuf) x scissor (off, on): six
// instantiations. The scissor rect rides the light vector's slots 9..12,
// as in the reference. Arithmetic in the reference body's order. The
// library builds with --fmad=false and '/' is IEEE division; max(x, c)
// propagates NaN like torch.clamp; the rsqrt is rsqrtf (MUFU.RSQ, not
// correctly rounded), chosen because the plain PyTorch version's
// torch.rsqrt calls the same function on the card (as kernel B3 does): so
// the kernel equals the plain version bit for bit there. Outputs are new
// buffers: the kernel reads fb/depth and writes out / dep_out for every
// in-frame pixel; G-buffer planes 12 and up are copied through.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 16;
constexpr int THREADS = BLK * BLK;
constexpr int NWARPS = THREADS / 32;
constexpr int SCAN = THREADS;  // list entries culled per pass
constexpr int PLANES_CTAS = 5;  // B8's CTAs an SM: at most 48 registers
constexpr int F_PAD = 40;      // table row width
constexpr float SLIVER = 0x1p-19f;  // raster3d_tris.SLIVER
enum { CORNERS = 0, PLANES = 1, PLANES_GBUF = 2 };
static_assert(BLK / 2 == NWARPS, "each warp owns two rows of the block");

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

// Lambert + ambient + emissive of a taken triangle at the (unnormalised)
// interpolated normal n.
__device__ __forceinline__ void forward_shade(float nx, float ny, float nz,
                                              float inv_len,
                                              const float* rgba,
                                              const float* emi,
                                              const float* lt, float* v) {
  const float lam =
      clamp_min(-(nx * lt[0] + ny * lt[1] + nz * lt[2]) * inv_len, 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    v[k] = rgba[k] * (lt[6 + k] + lt[3 + k] * lam) + emi[k];
  v[3] = rgba[3];
}

// The pixel, its scissor test and its framebuffer / depth, shared by both
// kernels.
struct Px {
  int x, y;
  bool in, live;
  size_t plane, pix;
  float px, py;
};

template <bool SCISSOR>
__device__ __forceinline__ Px pixel_of(const Args& a) {
  Px p;
  const int tid = threadIdx.x;
  p.x = blockIdx.x * BLK + tid % BLK;
  p.y = blockIdx.y * BLK + tid / BLK;
  p.in = p.x < a.W && p.y < a.H;
  p.px = (float)p.x + 0.5f;
  p.py = (float)p.y + 0.5f;
  p.live = p.in;
  if constexpr (SCISSOR) {
    const float* lt = a.light;
    p.live = p.live && p.px >= lt[9] && p.py >= lt[10] && p.px < lt[11] &&
             p.py < lt[12];
  }
  p.plane = (size_t)a.H * a.W;
  p.pix = p.in ? (size_t)p.y * a.W + p.x : 0;
  return p;
}

template <int NW>
__device__ __forceinline__ void store(const Args& a, const Px& p,
                                      const float* v, float dep) {
  if (!p.in) return;
#pragma unroll
  for (int k = 0; k < NW; ++k) a.out[k * p.plane + p.pix] = v[k];
  for (int k = NW; k < a.nplanes; ++k)
    a.out[k * p.plane + p.pix] = a.fb[k * p.plane + p.pix];
  a.dep_out[p.pix] = dep;
}

// B7: corner records, the list culled to the CTA's block and, per warp, to
// its two rows; the walk keeps the winner's row, shaded once at the end.
template <bool SCISSOR>
__global__ void __launch_bounds__(THREADS) tri_corners(Args a) {
  __shared__ float4 E[3 * SCAN];   // survivors' edges
  __shared__ float4 Z[SCAN];       // survivors' NDC depths and 1/area2
  __shared__ float2 R[SCAN];       // survivors' row-pair range
  __shared__ int S[SCAN];          // survivors' table rows
  __shared__ int wtot[NWARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Px p = pixel_of<SCISSOR>(a);
  const int t = (blockIdx.y * BLK / a.tile_h) * a.ntx +
                blockIdx.x * BLK / a.tile_w;
  const int cnt = a.counts[t];
  const int base = a.starts[t];
  const float fbx = (float)blockIdx.x, fby = (float)blockIdx.y;
  const float frow = (float)(blockIdx.y * (BLK / 2) + warp);
  const float tile_hw = (float)(a.tile_h + a.tile_w);
  float dep = p.in ? a.depth[p.pix] : 0.0f;
  int won = -1;  // the table row of the triangle this pixel took last

  for (int c0 = 0; c0 < cnt; c0 += SCAN) {
    __syncthreads();  // the previous pass is walked
    const int i = c0 + tid;
    bool keep = false;
    int row = 0;
    float c[6], ylo = 0.0f, yhi = 0.0f;
    if (i < cnt) {
      row = a.pair[base + i];
      const float* d = a.table + (size_t)row * F_PAD;
#pragma unroll
      for (int k = 0; k < 6; ++k) c[k] = d[k];
      const float x0 = fminf(fminf(c[0], c[2]), c[4]);
      const float x1 = fmaxf(fmaxf(c[0], c[2]), c[4]);
      const float y0 = fminf(fminf(c[1], c[3]), c[5]);
      const float y1 = fmaxf(fmaxf(c[1], c[3]), c[5]);
      keep = floorf(x0 / 16.0f) <= fbx && floorf(x1 / 16.0f) >= fbx &&
             floorf(y0 / 16.0f) <= fby && floorf(y1 / 16.0f) >= fby;
      ylo = floorf(y0 / 2.0f);
      yhi = floorf(y1 / 2.0f);
      // a sliver is walked by every warp of every block of its tiles
      const float m = fmaxf(x1 - x0, y1 - y0);
      const float area2 = (c[2] - c[0]) * (c[5] - c[1]) -
                          (c[3] - c[1]) * (c[4] - c[0]);
      if (!(fabsf(area2) > m * m * (2.0f * m + tile_hw) * SLIVER)) {
        keep = true;
        ylo = -INFINITY;
        yhi = INFINITY;
      }
    }
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wtot[warp] = __popc(ball);
    __syncthreads();
    int m = 0, pre = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      pre += w < warp ? wtot[w] : 0;
      m += wtot[w];
    }
    if (keep) {
      const int k = pre + __popc(ball & ((1u << lane) - 1u));
      const float* d = a.table + (size_t)row * F_PAD;
      E[3 * k] = make_float4(c[4] - c[2], c[5] - c[3], c[2], c[3]);
      E[3 * k + 1] = make_float4(c[0] - c[4], c[1] - c[5], c[4], c[5]);
      E[3 * k + 2] = make_float4(c[2] - c[0], c[3] - c[1], c[0], c[1]);
      Z[k] = make_float4(d[6], d[7], d[8], d[12]);
      R[k] = make_float2(ylo, yhi);
      S[k] = row;
    }
    __syncthreads();
    if (!p.live) continue;
    for (int j = 0; j < m; ++j) {
      const float2 r = R[j];
      if (r.x > frow || r.y < frow) continue;  // misses this warp's rows
      // (cx-bx)*(py-by) - (cy-by)*(px-bx), and so on round the corners
      const float4 g0 = E[3 * j], g1 = E[3 * j + 1], g2 = E[3 * j + 2];
      const float e0 = g0.x * (p.py - g0.w) - g0.y * (p.px - g0.z);
      const float e1 = g1.x * (p.py - g1.w) - g1.y * (p.px - g1.z);
      const float e2 = g2.x * (p.py - g2.w) - g2.y * (p.px - g2.z);
      if (!(e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f)) continue;
      const float4 zr = Z[j];
      const float z = e0 * zr.w * zr.x + e1 * zr.w * zr.y + e2 * zr.w * zr.z;
      if (!(z > dep)) continue;
      dep = z;
      won = S[j];
    }
  }

  float v[4];
  if (won < 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = p.in ? a.fb[k * p.plane + p.pix] : 0.0f;
  } else {
    // the winner's shade, from its record, in the walk's arithmetic
    const float* d = a.table + (size_t)won * F_PAD;
    const float e0 = (d[4] - d[2]) * (p.py - d[3]) - (d[5] - d[3]) * (p.px - d[2]);
    const float e1 = (d[0] - d[4]) * (p.py - d[5]) - (d[1] - d[5]) * (p.px - d[4]);
    const float e2 = (d[2] - d[0]) * (p.py - d[1]) - (d[3] - d[1]) * (p.px - d[0]);
    const float b0 = e0 * d[12], b1 = e1 * d[12], b2 = e2 * d[12];
    const float iw = clamp_min(b0 * d[9] + b1 * d[10] + b2 * d[11], 1e-12f);
    const float nx = (b0 * d[13] + b1 * d[16] + b2 * d[19]) / iw;
    const float ny = (b0 * d[14] + b1 * d[17] + b2 * d[20]) / iw;
    const float nz = (b0 * d[15] + b1 * d[18] + b2 * d[21]) / iw;
    const float inv_len =
        rsqrtf(clamp_min(nx * nx + ny * ny + nz * nz, 1e-12f));
    forward_shade(nx, ny, nz, inv_len, d + 22, d + 26, a.light, v);
  }
  store<4>(a, p, v, dep);
}

// B8: plane records, the list culled to the CTA's block by each edge's least
// corner and, per warp, to its two rows; the walk keeps the winner's row,
// shaded once at the end.
template <int LAYOUT, bool SCISSOR>
__global__ void __launch_bounds__(THREADS, PLANES_CTAS) tri_planes(Args a) {
  constexpr int NW = LAYOUT == PLANES_GBUF ? 12 : 4;  // planes written
  __shared__ float4 E[3 * SCAN];    // survivors' edge and depth planes
  __shared__ int S[SCAN];           // survivors' table rows
  __shared__ unsigned char M[SCAN];  // survivors' warps (a bit a warp)
  __shared__ int wtot[NWARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Px p = pixel_of<SCISSOR>(a);
  const int t = (blockIdx.y * BLK / a.tile_h) * a.ntx +
                blockIdx.x * BLK / a.tile_w;
  const int cnt = a.counts[t];
  const int base = a.starts[t];
  const float px = p.px, py = p.py;
  // the block's least and greatest pixel centres
  const float x0 = (float)(blockIdx.x * BLK) + 0.5f, x1 = x0 + (BLK - 1);
  const float y0 = (float)(blockIdx.y * BLK) + 0.5f, y1 = y0 + (BLK - 1);
  const unsigned bit = 1u << warp;
  float dep = p.in ? a.depth[p.pix] : 0.0f;
  int won = -1;  // the table row of the triangle this pixel took last

  // entry i's 9 edge and 3 depth floats (16-byte loads), from its row
  auto fetch = [&](int i, int row, float4* e) {
    if (i < cnt) {
      const float4* r =
          reinterpret_cast<const float4*>(a.table + (size_t)row * F_PAD);
      e[0] = __ldg(r);
      e[1] = __ldg(r + 1);
      e[2] = __ldg(r + 2);
    }
  };
  // a pipeline: this pass's records in registers, the next pass's row
  // index loaded; both are issued during the previous pass's walk
  int row = tid < cnt ? a.pair[base + tid] : 0;
  int row_next = tid + SCAN < cnt ? a.pair[base + tid + SCAN] : 0;
  float4 e[3];
  fetch(tid, row, e);

  for (int c0 = 0; c0 < cnt; c0 += SCAN) {
    __syncthreads();  // the previous pass is walked
    const int i = c0 + tid;
    unsigned mask = 0;
    if (i < cnt) {
      const float d[9] = {e[0].x, e[0].y, e[0].z, e[0].w, e[1].x,
                          e[1].y, e[1].z, e[1].w, e[2].x};
      // each edge a*px + b*py + c at the block's least corner, in the
      // walk's arithmetic: > 0 there reads outside at every centre
      float ax[3];
      bool keep = true;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ax[k] = d[3 * k] * (d[3 * k] >= 0.0f ? x0 : x1);
        if (ax[k] + d[3 * k + 1] * (d[3 * k + 1] >= 0.0f ? y0 : y1) +
                d[3 * k + 2] >
            0.0f)
          keep = false;
      }
      // then over each warp's two rows
      if (keep)
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) {
          const float r0 = y0 + (float)(2 * w);
          bool in = true;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (ax[k] + d[3 * k + 1] * (d[3 * k + 1] >= 0.0f ? r0 : r0 + 1.0f) +
                    d[3 * k + 2] >
                0.0f)
              in = false;
          mask |= (unsigned)in << w;
        }
    }
    const unsigned ball = __ballot_sync(0xffffffffu, mask != 0);
    if (lane == 0) wtot[warp] = __popc(ball);
    __syncthreads();
    int m = 0, pre = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      pre += w < warp ? wtot[w] : 0;
      m += wtot[w];
    }
    if (mask != 0) {
      const int k = pre + __popc(ball & ((1u << lane) - 1u));
      E[3 * k] = e[0];
      E[3 * k + 1] = e[1];
      E[3 * k + 2] = e[2];
      S[k] = row;
      M[k] = (unsigned char)mask;
    }
    __syncthreads();
    // the next pass's records and the row index after them, in flight
    // during this pass's walk
    row = row_next;
    fetch(i + SCAN, row, e);
    row_next = i + 2 * SCAN < cnt ? a.pair[base + i + 2 * SCAN] : 0;
    if (!p.live) continue;
    for (int j = 0; j < m; ++j) {
      if (!(M[j] & bit)) continue;  // misses this warp's rows
      const float4 g0 = E[3 * j], g1 = E[3 * j + 1], g2 = E[3 * j + 2];
      if (!(g0.x * px + g0.y * py + g0.z <= 0.0f &&
            g0.w * px + g1.x * py + g1.y <= 0.0f &&
            g1.z * px + g1.w * py + g2.x <= 0.0f))
        continue;
      const float z = g2.y * px + g2.z * py + g2.w;
      if (!(z > dep)) continue;
      dep = z;
      won = S[j];
    }
  }

  float v[NW];
  if (won < 0) {
#pragma unroll
    for (int k = 0; k < NW; ++k)
      v[k] = p.in ? a.fb[k * p.plane + p.pix] : 0.0f;
  } else {
    // the winner's shade, from its record, in the reference body's order
    const float* d = a.table + (size_t)won * F_PAD;
    const float iw = clamp_min(d[12] * px + d[13] * py + d[14], 1e-12f);
    const float nx = (d[15] * px + d[16] * py + d[17]) / iw;
    const float ny = (d[18] * px + d[19] * py + d[20]) / iw;
    const float nz = (d[21] * px + d[22] * py + d[23]) / iw;
    const float* rgba = d + 24;
    const float* emi = d + 28;
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
      forward_shade(nx, ny, nz, inv_len, rgba, emi, a.light, v);
    }
  }
  store<NW>(a, p, v, dep);
}

template <bool SCISSOR>
void launch(const Args& a, int layout, dim3 grid, cudaStream_t s) {
  if (layout == CORNERS)
    tri_corners<SCISSOR><<<grid, THREADS, 0, s>>>(a);
  else if (layout == PLANES)
    tri_planes<PLANES, SCISSOR><<<grid, THREADS, 0, s>>>(a);
  else
    tri_planes<PLANES_GBUF, SCISSOR><<<grid, THREADS, 0, s>>>(a);
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
  if (scissor != 0)
    launch<true>(a, layout, grid, s);
  else
    launch<false>(a, layout, grid, s);
  return (int)cudaGetLastError();
}
