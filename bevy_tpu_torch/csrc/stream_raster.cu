// Kernel B2: streaming-tile depth + winner-id raster (the fallback for
// giant and near-plane clusters of the window-splat path).
//
// Replaces bevy_tpu/ops/raster3d_visbuf.py::_stream_kernel (entry
// raster_visbuf). There, each tile DMA'd per-tile copies of its cluster
// records (tile_chunk_records) in double-buffered chunks; here a block
// reads each listed cluster's record row by id straight from the
// (NCL, rec_w) cluster_records table, so the per-tile copy never exists.
//
// What bounds it on an H100: the fallback set is small (<= 2,048 clusters at
// many_cubes 160k) but near-plane straddlers carry full-viewport AABBs and
// so land in every tile's list; each (tile, triangle) pair costs ~20 FP32
// ops on each of the tile's pixels, with one scalar AABB reject first. The
// list walk is serial within a tile, so the bound is per-tile latency: list
// length x cs triangles, not bandwidth.
//
// Design: one CTA per tile (tile_h x tile_w <= 4096 px; 256 threads hold
// up to 16 pixels each in registers). A tile owns its pixels, so no
// atomics; the cluster list is walked in order (ties keep the first
// writer, as on the TPU). Each cluster's record row is staged in shared
// memory once for all the tile's pixels. Edges and z use
// __fmul_rn/__fadd_rn in the JAX association order (d0*px + d1*py) + d2,
// matching the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXP = 16;   // pixels per thread: tile_h * tile_w <= 4096
constexpr int ZREC = 20;

__device__ __forceinline__ float plane(const float* d, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(d[0], px), __fmul_rn(d[1], py)), d[2]);
}

__global__ void __launch_bounds__(THREADS)
stream_tiles(const float* __restrict__ recs, int rec_w,
             const int* __restrict__ cl_table, int max_cl,
             const int* __restrict__ cl_counts, int ntx, int cs, int tile_h,
             int tile_w, int H, int W, float* __restrict__ depth,
             float* __restrict__ winner) {
  extern __shared__ float rec[];
  const int t = blockIdx.x;
  const int tx = t % ntx, ty = t / ntx;
  const int npx = tile_h * tile_w;
  const float tx0 = (float)(tx * tile_w), ty0 = (float)(ty * tile_h);
  const float tx1 = tx0 + (float)tile_w, ty1 = ty0 + (float)tile_h;

  float dep[MAXP], win[MAXP], pxs[MAXP], pys[MAXP];
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    const int p = threadIdx.x + k * THREADS;
    const int x = tx * tile_w + p % tile_w, y = ty * tile_h + p / tile_w;
    const bool in = p < npx && x < W && y < H;
    pxs[k] = (float)x + 0.5f;
    pys[k] = (float)y + 0.5f;
    dep[k] = in ? depth[(size_t)y * W + x] : 0.f;
    win[k] = in ? winner[(size_t)y * W + x] : 0.f;
  }

  const int nk = (npx + THREADS - 1) / THREADS;  // pixel slots in use
  const int cnt = min(cl_counts[t], max_cl);
  for (int l = 0; l < cnt; ++l) {
    const int cid = cl_table[(size_t)t * max_cl + l];
    __syncthreads();  // the previous cluster's row is consumed
    if (cid >= 0)
      for (int i = threadIdx.x; i < rec_w; i += THREADS)
        rec[i] = recs[(size_t)cid * rec_w + i];
    __syncthreads();
    if (cid < 0) continue;
    for (int s = 0; s < cs; ++s) {
      const float* d = rec + s * ZREC;
      const bool hit = d[12] >= 0.f && d[15] > tx0 && d[13] < tx1 &&
                       d[16] > ty0 && d[14] < ty1;
      if (!hit) continue;  // uniform across the block
#pragma unroll
      for (int k = 0; k < MAXP; ++k) {
        if (k >= nk) break;
        const float px = pxs[k], py = pys[k];
        const bool inside = plane(d, px, py) <= 0.f &&
                            plane(d + 3, px, py) <= 0.f &&
                            plane(d + 6, px, py) <= 0.f;
        const float z = plane(d + 9, px, py);
        if (inside && z > dep[k]) {
          dep[k] = z;
          win[k] = d[12];
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    const int p = threadIdx.x + k * THREADS;
    const int x = tx * tile_w + p % tile_w, y = ty * tile_h + p / tile_w;
    if (p < npx && x < W && y < H) {
      depth[(size_t)y * W + x] = dep[k];
      winner[(size_t)y * W + x] = win[k];
    }
  }
}

}  // namespace

// recs (ncl, rec_w) f32; cl_table (ntiles, max_cl) int32 (-1 pad);
// cl_counts (ntiles,) int32; depth, winner (H, W) f32, updated in place
// (the wrapper passes fresh copies). Returns cudaGetLastError().
extern "C" int bt_stream_raster(const float* recs, int rec_w,
                                const int* cl_table, int max_cl,
                                const int* cl_counts, int ntiles, int ntx,
                                int cs, int tile_h, int tile_w, int H, int W,
                                float* depth, float* winner, void* stream) {
  if (ntiles > 0)
    stream_tiles<<<ntiles, THREADS, (size_t)rec_w * sizeof(float),
                   (cudaStream_t)stream>>>(recs, rec_w, cl_table, max_cl,
                                           cl_counts, ntx, cs, tile_h, tile_w,
                                           H, W, depth, winner);
  return (int)cudaGetLastError();
}
