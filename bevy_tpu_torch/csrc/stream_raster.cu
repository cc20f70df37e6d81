// Kernel B2: streaming-tile depth + winner-id raster (the fallback for
// giant and near-plane clusters of the window-splat path).
//
// Replaces bevy_tpu/ops/raster3d_visbuf.py::_stream_kernel (entry
// raster_visbuf). There, one grid step owned one tile_h x tile_w bin tile,
// copied depth and winner in, DMA'd per-tile copies of its cluster records
// (tile_chunk_records) in double-buffered chunks and, per listed triangle
// whose screen AABB meets the tile, evaluated the three edges and the depth
// plane on every pixel of the tile. Here a CTA reads each listed cluster's
// record row by id from the (NCL, rec_w) cluster_records table, so the
// per-tile copy never exists.
//
// What bounds it on an H100: bytes. Every pixel's depth and winner are read
// once and written once (14.7 MB at 1280x720, 4.4 us at 3.35 TB/s), and the
// fallback set is small (1.5 clusters a frame at many_cubes 160k), so the
// fixed full-frame pass sets the time. The first design paid that pass
// three times (the wrapper cloned depth and winner, the kernel updated the
// clones in place) in 450 CTAs of 16 scalar loads a thread; and each
// listed triangle whose AABB met a 32 x 128 or 16 x 128 tile was evaluated
// on every pixel of it, which a near-plane straddler (a full-viewport
// AABB) does in every tile.
//
// Design:
// - One pass, out of place. The kernel reads depth and winner and writes
//   new outputs: each pixel read once and written once, with one 16-byte
//   streaming load / store of 4 pixels a thread where the quad lies in the
//   frame and the tile and its address is 16-byte aligned (scalar
//   otherwise: a width that is not a multiple of 4, a tile edge that cuts
//   a quad).
// - Many CTAs. Each bin tile is cut into 16 x 64 blocks, one 256-thread CTA
//   each (900 CTAs at 1280x720 with 16 x 128 tiles). Every CTA walks its
//   tile's list; a block owns its pixels, so there are no atomics.
// - An exact block cull. Per listed triangle the CTA keeps the reference's
//   own tile test (valid id, screen AABB against the whole tile) as it is:
//   bit-equality needs the same skips. Then it drops the triangle for the
//   block iff some edge reads > 0 at every pixel centre of the block (the
//   part in the tile and the frame). The edge is (d0*px + d1*py) + d2 with
//   each product and sum rounded (__fmul_rn / __fadd_rn), and rounding is
//   monotone, so over the block's centres it is least at the corner picked
//   by the signs of d0 and d1: the cull evaluates it there, in the walk's
//   own arithmetic, so a dropped triangle reads outside at every centre of
//   the block, exactly as the walk would find it. No margin, no sliver
//   case (as B1's cull). A NaN at the corner keeps the triangle.
// - Ordered staging. A pass takes 256 / cs listed clusters, one thread a
//   (cluster, triangle) entry: the thread cp.async's its entry's record
//   (16 floats; the AABB's last float rides a register) into a double
//   buffer one pass ahead, tests it, and a warp ballot, a popcount prefix
//   and a scan of the eight warps' totals compact the survivors in list
//   order. The walk reads only the survivors, in order, with a strict
//   z > dep (ties keep the first writer), as the reference walks.
// - The scissor is a template flag, as in B7 / B8: a pixel outside the
//   rect [x0, y0, x1, y1) (device floats) takes no triangle and keeps its
//   input. The cull ignores it.
// - Measured on an H100 at many_cubes 160k (PERF.md): the call is now
//   one kernel near the bytes' bound; capping registers for 6 or 8 CTAs
//   an SM (57 registers, 4 CTAs, now) spilled and was slower.
// Edges and z use __fmul_rn/__fadd_rn in the JAX association order
// (d0*px + d1*py) + d2, so the result equals the plain PyTorch version's
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BH = 16;                // block rows
constexpr int QW = THREADS / BH;      // 4-pixel quads a block row
constexpr int BW = 4 * QW;            // block columns
constexpr int NWARPS = THREADS / 32;
constexpr int ZREC = 20;
constexpr int STAGE = 16;             // record floats staged per entry

struct Args {
  const float* recs;       // (ncl, rec_w)
  const int* cl_table;     // (ntiles, max_cl), -1 pad
  const int* cl_counts;    // (ntiles,)
  const float* depth;      // (H, W)
  const float* winner;     // (H, W)
  const float* scissor;    // (4,) [x0, y0, x1, y1) or null
  float* dep_out;
  float* win_out;
  int rec_w, max_cl, ntx, cs, tile_h, tile_w, H, W, nbx, nby;
  int vec_ok;              // depth and winner 16-byte aligned
};

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool SCISSOR>
__global__ void __launch_bounds__(THREADS) stream_tiles(Args a) {
  extern __shared__ float4 stage[];   // [2][THREADS][STAGE / 4]
  __shared__ int S[THREADS];          // survivors' entries, in list order
  __shared__ int wtot[NWARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bpt = a.nbx * a.nby;
  const int t = blockIdx.x / bpt, b = blockIdx.x - t * bpt;
  const int by = b / a.nbx, bx = b - by * a.nbx;
  const int tx0 = (t % a.ntx) * a.tile_w, ty0 = (t / a.ntx) * a.tile_h;
  // the block's pixels: columns [x0, x1), rows [y0, y1) of tile and frame
  const int x0 = tx0 + bx * BW, y0 = ty0 + by * BH;
  const int x1 = min(min(x0 + BW, tx0 + a.tile_w), a.W);
  const int y1 = min(min(y0 + BH, ty0 + a.tile_h), a.H);
  if (x0 >= x1 || y0 >= y1) return;   // uniform: no pixel of the frame

  const int y = y0 + tid / QW, x = x0 + 4 * (tid % QW);
  const size_t pix = (size_t)y * a.W + x;
  const float py = (float)y + 0.5f;
  float px[4], dep[4], win[4];
  bool in[4], live[4];
  const bool vec = a.vec_ok && y < y1 && x + 3 < x1 && (pix & 3) == 0;
  if (vec) {
    const float4 d4 = __ldcs(reinterpret_cast<const float4*>(a.depth + pix));
    const float4 w4 = __ldcs(reinterpret_cast<const float4*>(a.winner + pix));
    dep[0] = d4.x, dep[1] = d4.y, dep[2] = d4.z, dep[3] = d4.w;
    win[0] = w4.x, win[1] = w4.y, win[2] = w4.z, win[3] = w4.w;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    in[k] = y < y1 && x + k < x1;
    px[k] = (float)(x + k) + 0.5f;
    if (!vec) {
      dep[k] = in[k] ? __ldcs(a.depth + pix + k) : 0.0f;
      win[k] = in[k] ? __ldcs(a.winner + pix + k) : 0.0f;
    }
    live[k] = in[k];
    if constexpr (SCISSOR)
      live[k] = live[k] && px[k] >= a.scissor[0] && py >= a.scissor[1] &&
                px[k] < a.scissor[2] && py < a.scissor[3];
  }

  const int cnt = min(a.cl_counts[t], a.max_cl);
  const int per = THREADS / a.cs;         // clusters a pass
  const int g = tid / a.cs, s = tid - g * a.cs;
  const float ftx0 = (float)tx0, fty0 = (float)ty0;
  const float ftx1 = ftx0 + (float)a.tile_w, fty1 = fty0 + (float)a.tile_h;
  const float cx0 = (float)x0 + 0.5f, cx1 = (float)(x1 - 1) + 0.5f;
  const float cy0 = (float)y0 + 0.5f, cy1 = (float)(y1 - 1) + 0.5f;

  // this thread's entry of pass p into stage[p & 1]; returns whether it is
  // listed (a cluster id >= 0) and, in *aabb_y1, the record's float 16
  auto fetch = [&](int p, float* aabb_y1) {
    const int l = p * per + g;
    int cid = -1;
    if (g < per && l < cnt) cid = a.cl_table[(size_t)t * a.max_cl + l];
    if (cid >= 0) {
      const float* src = a.recs + (size_t)cid * a.rec_w + s * ZREC;
      float4* dst = stage + ((p & 1) * THREADS + tid) * (STAGE / 4);
#pragma unroll
      for (int k = 0; k < STAGE / 4; ++k) cp_async16(dst + k, src + 4 * k);
      *aabb_y1 = __ldg(src + STAGE);
    }
    cp_async_commit();
    return cid >= 0;
  };

  const int npass = (cnt + per - 1) / per;
  float cur_y1 = 0.0f, next_y1 = 0.0f;
  bool cur = npass > 0 && fetch(0, &cur_y1);
  for (int p = 0; p < npass; ++p) {
    __syncthreads();  // the previous pass is walked: its buffer is free
    // (past the list the fetch copies nothing, but commits its group)
    const bool next = fetch(p + 1, &next_y1);
    cp_async_wait<1>();  // this thread's entry of pass p has landed
    const float4* e = stage + ((p & 1) * THREADS + tid) * (STAGE / 4);
    bool keep = false;
    if (cur) {
      const float4 q0 = e[0], q1 = e[1], q2 = e[2], q3 = e[3];
      // the reference's tile test: valid id, AABB against the whole tile
      keep = q3.x >= 0.f && q3.w > ftx0 && q3.y < ftx1 && cur_y1 > fty0 &&
             q3.z < fty1;
      // each edge at the block's least corner (rounding is monotone)
      const float ed[9] = {q0.x, q0.y, q0.z, q0.w, q1.x,
                           q1.y, q1.z, q1.w, q2.x};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float ea = ed[3 * k], eb = ed[3 * k + 1];
        if (plane(ea, eb, ed[3 * k + 2], ea >= 0.f ? cx0 : cx1,
                  eb >= 0.f ? cy0 : cy1) > 0.f)
          keep = false;
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
    if (keep) S[pre + __popc(ball & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4* d = stage + ((p & 1) * THREADS + S[j]) * (STAGE / 4);
      const float4 q0 = d[0], q1 = d[1], q2 = d[2];
      const float id = d[3].x;
      // the row's products, shared by the thread's four pixels
      const float b0 = __fmul_rn(q0.y, py), b1 = __fmul_rn(q1.x, py);
      const float b2 = __fmul_rn(q1.w, py), bz = __fmul_rn(q2.z, py);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool inside =
            __fadd_rn(__fadd_rn(__fmul_rn(q0.x, px[k]), b0), q0.z) <= 0.f &&
            __fadd_rn(__fadd_rn(__fmul_rn(q0.w, px[k]), b1), q1.y) <= 0.f &&
            __fadd_rn(__fadd_rn(__fmul_rn(q1.z, px[k]), b2), q2.x) <= 0.f;
        const float z =
            __fadd_rn(__fadd_rn(__fmul_rn(q2.y, px[k]), bz), q2.w);
        if (live[k] && inside && z > dep[k]) {
          dep[k] = z;
          win[k] = id;
        }
      }
    }
    cur = next;
    cur_y1 = next_y1;
  }

  if (vec) {
    __stcs(reinterpret_cast<float4*>(a.dep_out + pix),
           make_float4(dep[0], dep[1], dep[2], dep[3]));
    __stcs(reinterpret_cast<float4*>(a.win_out + pix),
           make_float4(win[0], win[1], win[2], win[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (in[k]) {
        __stcs(a.dep_out + pix + k, dep[k]);
        __stcs(a.win_out + pix + k, win[k]);
      }
  }
}

}  // namespace

// recs (ncl, rec_w) f32, rec_w a multiple of 4 and recs 16-byte aligned;
// cl_table (ntiles, max_cl) int32 (-1 pad); cl_counts (ntiles,) int32;
// depth, winner (H, W) f32, read; dep_out, win_out (H, W) f32, written
// (every pixel); scissor (4,) f32 [x0, y0, x1, y1) or null; cs <= 256;
// vec_ok: depth and winner are 16-byte aligned (the outputs must be).
// Returns cudaGetLastError().
extern "C" int bt_stream_raster(const float* recs, int rec_w,
                                const int* cl_table, int max_cl,
                                const int* cl_counts, int ntiles, int ntx,
                                int cs, int tile_h, int tile_w, int H, int W,
                                const float* depth, const float* winner,
                                const float* scissor, int vec_ok,
                                float* dep_out, float* win_out,
                                void* stream) {
  if (cs < 1 || cs > THREADS || rec_w % 4 || rec_w < cs * ZREC ||
      tile_h < 1 || tile_w < 1)
    return (int)cudaErrorInvalidValue;
  const int nbx = (tile_w + BW - 1) / BW, nby = (tile_h + BH - 1) / BH;
  const Args a{recs,    cl_table, cl_counts, depth, winner, scissor,
               dep_out, win_out,  rec_w,     max_cl, ntx,   cs,
               tile_h,  tile_w,   H,         W,      nbx,   nby,
               vec_ok};
  const long long blocks = (long long)ntiles * nbx * nby;
  if (blocks <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * THREADS * STAGE * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (scissor != nullptr)
    stream_tiles<true><<<(unsigned)blocks, THREADS, smem, s>>>(a);
  else
    stream_tiles<false><<<(unsigned)blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}
