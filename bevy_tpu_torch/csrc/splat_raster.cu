// Kernel B1: fused window evaluate + composite for the window-splat raster.
//
// Replaces bevy_tpu/ops/raster3d_splat.py::_fused_kernel (entry
// fused_eval_composite), which ran windows one after another on the TPU's
// sequential grid and so read-modify-wrote the framebuffer race-free. There
// every window evaluated all win_h x 128 pixels (128, the TPU's lane width)
// against all ntri record slots.
//
// What bounds it on an H100: the edge and depth tests of the (pixel, slot)
// pairs inside a slot's edges, one 8-byte atomic per pixel a window wins,
// and bytes: depth and winner in and out, the keys, the owners' records.
// At many_cubes 160k (1280x720; 48k half-height and 15k full-height
// windows a frame, footprints of ~10 x 10 and ~25 x 19 px) only 5-12% of
// the window pixels lie in the cluster's screen box, so the reference's
// whole-window walk is mostly work on pixels no slot can reach.
//
// Design:
// - One warp per window, up to eight windows a CTA (fewer where a window's
//   shared memory needs it: tall windows, many slots), as many CTAs as the
//   card holds at once, over a grid-stride loop that stops at the first
//   invalid window (wvalid is a prefix): the work follows the valid count
//   on the device, with no host read. The warp stages its window's record
//   row in shared memory.
// - The cull. The window is cut into 8 x 4-pixel tiles (one warp pass each).
//   A (tile, slot) pair is dropped iff some edge of the slot reads > 0 at
//   the one pixel centre of the tile where that edge reads least: the left
//   or right column by the sign of its x coefficient a, the top or bottom
//   row by the sign of b, in the walk's own arithmetic. The same test runs
//   first on 32 x 16 blocks (4 x 4 tiles), one (block, slot) pair a lane,
//   and then on the tiles of the kept blocks against their kept slots, one
//   tile a lane; the survivors are compacted (warp ballot, popcount).
//   The slots go through cull and walk in groups of 32, one bit each in
//   the masks, in order (one group unless ntri > 32); each group's best
//   slot at a pixel goes to the merge, whose maximum over the groups is
//   the window's best slot.
// - Why the cull is exact. An edge reads e = fl(fl(fl(a*px) + c) + fl(b*py))
//   (__fmul_rn / __fadd_rn, the reference's association). Correct rounding
//   is monotone, so fl(a*px) is monotone in px with the sign of a (px >
//   0), and each fl(u + v) is monotone in u and in v: e is monotone in px
//   for a fixed py, and in py for a fixed px. Over a rectangle of centres,
//   e is therefore least at the corner chosen above; if it reads > 0 there,
//   every centre of the tile reads > 0, or NaN where an infinity meets
//   another (a NaN centre fails `e <= 0` as well), so the slot is outside
//   every pixel of the tile in the walk's arithmetic too. No margin and no
//   sliver case: the argument uses the record's own floats, whatever the
//   triangle's shape, degenerate padding slots and 4-edge quads included.
//   A NaN coefficient makes the test read NaN, which keeps the pair.
// - A slot whose depth plane is all zeros (the zero records that pad a row
//   past its valid triangles) reads z = 0 everywhere; it is dropped from
//   every tile when no incoming depth is below 0 (init_keys checks).
//   A slot with z <= depth at a pixel neither writes there nor changes
//   which slot of the window writes: if the window's best z beats the
//   depth, that slot is below it; if not, nothing writes. Without this
//   the padding slot, inside its zero edges everywhere, would keep every
//   tile of every window.
// - The scissor (a template flag, as in B2, B7 and B8; a camera's viewport
//   rect [x0, x1) x [y0, y1), four floats in device memory, read once a
//   CTA): a pixel writes only where its centre passes the reference's test
//   px >= x0 & px < x1 & py >= y0 & py < y1. A block or tile is dropped
//   whole where no pixel centre of it can pass: its last centre column
//   lies left of x0 or its first at or right of x1 (rows alike); small
//   integers plus 0.5 are exact floats, so the test reads the walk's own
//   centres. A NaN bound drops everything, as the per-pixel test writes
//   nothing.
//   raster3d_splat.window_px_kept replays these decisions in PyTorch.
// - The walk visits only the kept tiles, one pixel a lane, and only each
//   tile's kept slots, in slot order; per pixel it is the reference's test
//   (every e <= 0, z = (za*px + zc) + zb*py, the first slot of maximal z,
//   a strict z > depth), so each window's best slot at each pixel is the
//   same as the whole-window walk's.
// - The merge stays order-free: the sequential TPU result at a pixel is the
//   lexicographic maximum of (z, -seq) over writes that pass the edge test
//   (seq = window * ntri + slot; the incoming depth wins ties), so each
//   pixel's best slot of a window goes into a 64-bit atomicMax on
//     key = order(z) << 32 | (0xFFFFFFFE - seq)
//   where order() maps f32 bits to an int32 of the same order. A decode
//   pass turns seq back into the record's id. The plain PyTorch version
//   computes the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_merge.cuh"

namespace {

constexpr int WIN_W = 128;
constexpr int THREADS = 256;  // the pixel passes; the window kernel's most
constexpr int WARPS = THREADS / 32;
constexpr int TILE_W = 8, TILE_H = 4;  // 32 pixels: one lane each
constexpr int TILES_X = WIN_W / TILE_W;
constexpr int BLK_W = 32, BLK_H = 16;  // a first, coarser cull: 4 x 4 tiles
constexpr int BLKS_X = WIN_W / BLK_W;

__device__ __forceinline__ float edge(float a, float b, float c, float px,
                                      float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), c), __fmul_rn(b, py));
}

// true iff some pixel centre of the w x h rectangle at (x0, y0) can pass
// the scissor test s (its nearest centres to the rect, exact in f32)
__device__ __forceinline__ bool meets(const float* s, int x0, int y0, int w,
                                      int h) {
  return (float)(x0 + w - 1) + 0.5f >= s[0] && (float)x0 + 0.5f < s[2] &&
         (float)(y0 + h - 1) + 0.5f >= s[1] && (float)y0 + 0.5f < s[3];
}

// true iff some edge of slot d reads > 0 at every pixel centre of the
// w x h rectangle at (x0, y0): each edge is tested at its least corner
template <int NEDGE>
__device__ __forceinline__ bool outside(const float* d, int x0, int y0, int w,
                                        int h) {
  bool out = false;
#pragma unroll
  for (int j = 0; j < NEDGE; ++j) {
    const float a = d[3 * j], b = d[3 * j + 1], c = d[3 * j + 2];
    const float px = (float)(x0 + (a >= 0.0f ? 0 : w - 1)) + 0.5f;
    const float py = (float)(y0 + (b >= 0.0f ? 0 : h - 1)) + 0.5f;
    out = out || edge(a, b, c, px, py) > 0.0f;
  }
  return out;
}

// the window kernel's shared memory per warp, in 4-byte words: the record
// row, the blocks' slot masks, the kept blocks' ids (16-bit), the kept
// tiles' slot masks and ids (16-bit); a multiple of 4 so every record row
// is float4-aligned
struct Layout {
  int rec_f, nblk, ntiles, words;
  __host__ __device__ Layout(int ntri, int nedge, int win_h) {
    rec_f = ntri * (3 * nedge + 4);
    nblk = BLKS_X * ((win_h + BLK_H - 1) / BLK_H);
    ntiles = TILES_X * ((win_h + TILE_H - 1) / TILE_H);
    words = (rec_f + nblk + (nblk + 1) / 2 + ntiles + (ntiles + 1) / 2 + 3) /
            4 * 4;
  }
};

// GROUPS: ntri > 32, the slots in groups of 32 (else one group, the whole
// record row, which the compiler keeps to the registers of a single pass);
// SCISSOR: pixels outside the rect `sciss` neither test nor write
template <int NEDGE, bool GROUPS, bool SCISSOR>
__global__ void __launch_bounds__(THREADS)
splat_windows(const float* __restrict__ depth,
              const float* __restrict__ rec_rows, int row_len,
              const int* __restrict__ owner, const int* __restrict__ meta,
              const unsigned char* __restrict__ wvalid, int nwin, int ntri,
              int win_h, int H, int W, long long* __restrict__ key,
              const int* __restrict__ neg,
              const float* __restrict__ sciss) {
  constexpr int STRIDE = 3 * NEDGE + 4;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (SCISSOR) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sc[k] = sciss[k];
  }
  extern __shared__ float4 smem4[];
  const Layout lay(ntri, NEDGE, win_h);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  float* rec = (float*)smem4 + (size_t)(threadIdx.x >> 5) * lay.words;
  unsigned* bmask = (unsigned*)(rec + lay.rec_f);
  unsigned short* kblk = (unsigned short*)(bmask + lay.nblk);
  unsigned* tmask = bmask + lay.nblk + (lay.nblk + 1) / 2;
  unsigned short* ktile = (unsigned short*)(tmask + lay.ntiles);
  const int tile_rows = (win_h + TILE_H - 1) / TILE_H;
  const bool drop_zero_z = *neg == 0;
  const int step = gridDim.x * warps;
  for (int b = blockIdx.x * warps + (threadIdx.x >> 5); b < nwin; b += step) {
    if (!wvalid[b]) break;  // the valid windows are a prefix
    __syncwarp();           // the previous window's reads are done
    const float* src = rec_rows + (size_t)owner[b] * row_len;
    for (int i = lane; i < lay.rec_f; i += 32) rec[i] = src[i];
    const int m = meta[b];
    const int x0 = (m / 2048) * WIN_W, y0 = m % 2048;
    for (int g0 = 0; g0 < ntri; g0 += 32) {
      const int gn = GROUPS ? min(32, ntri - g0) : ntri;
      const float* grp = rec + g0 * STRIDE;  // slot sl of the group
      for (int i = lane; i < lay.nblk; i += 32) bmask[i] = 0;
      __syncwarp();  // the row staged; the previous group's walk done
      // slots that can write: all but the zero depth planes over depth >= 0
      unsigned live = 0xffffffffu >> (32 - gn);
      if (drop_zero_z) {
        bool zero = false;
        if (lane < gn) {
          const float* zp = grp + lane * STRIDE + 3 * NEDGE;
          zero = zp[0] == 0.0f && zp[1] == 0.0f && zp[2] == 0.0f;
        }
        live &= ~__ballot_sync(0xffffffffu, zero);
      }

      // cull 1: (32 x 16 block, slot) pairs, one a lane
      for (int p0 = 0; p0 < lay.nblk * gn; p0 += 32) {
        const int p = p0 + lane, blk = p / gn, sl = p - blk * gn;
        const int bx = x0 + (blk % BLKS_X) * BLK_W;
        const int by = y0 + (blk / BLKS_X) * BLK_H;
        if (blk < lay.nblk && (live >> sl & 1u) && bx < W && by < H &&
            (!SCISSOR || meets(sc, bx, by, BLK_W, BLK_H)) &&
            !outside<NEDGE>(grp + sl * STRIDE, bx, by, BLK_W, BLK_H))
          atomicOr(&bmask[blk], 1u << sl);
      }
      __syncwarp();
      int nkb = 0;  // the blocks with a slot, compacted in order
      for (int c = 0; c < lay.nblk; c += 32) {
        const bool has = c + lane < lay.nblk && bmask[c + lane] != 0u;
        const unsigned ball = __ballot_sync(0xffffffffu, has);
        if (has) kblk[nkb + __popc(ball & ((1u << lane) - 1u))] = c + lane;
        nkb += __popc(ball);
      }
      __syncwarp();

      // cull 2: the kept blocks' 8 x 4 tiles, one a lane, each tested
      // against its block's slots; kept tiles compacted with their masks
      int nkept = 0;
      for (int q0 = 0; q0 < nkb * 16; q0 += 32) {
        const int q = q0 + lane;
        unsigned mask = 0;
        int t = 0;
        if (q < nkb * 16) {
          const int blk = kblk[q / 16], j = q % 16;
          const int tr = (blk / BLKS_X) * 4 + j / 4;
          t = tr * TILES_X + (blk % BLKS_X) * 4 + j % 4;
          const int tx = x0 + (t % TILES_X) * TILE_W;
          const int ty = y0 + tr * TILE_H;
          if (tr < tile_rows && tx < W && ty < H &&
              (!SCISSOR || meets(sc, tx, ty, TILE_W, TILE_H))) {
            for (unsigned left = bmask[blk]; left; left &= left - 1) {
              const int sl = __ffs(left) - 1;
              if (!outside<NEDGE>(grp + sl * STRIDE, tx, ty, TILE_W, TILE_H))
                mask |= 1u << sl;
            }
          }
        }
        const unsigned ball = __ballot_sync(0xffffffffu, mask != 0);
        if (mask) {
          const int k = nkept + __popc(ball & ((1u << lane) - 1u));
          ktile[k] = (unsigned short)t;
          tmask[k] = mask;
        }
        nkept += __popc(ball);
      }
      __syncwarp();

      // walk: the kept tiles, one pixel a lane, the tile's kept slots in
      // order
      for (int i = 0; i < nkept; ++i) {
        const int t = ktile[i];
        const unsigned mask = tmask[i];
        const int r = (t / TILES_X) * TILE_H + lane / TILE_W;
        const int x = x0 + (t % TILES_X) * TILE_W + lane % TILE_W;
        const int y = y0 + r;
        if (r >= win_h || x >= W || y >= H) continue;
        const float px = (float)x + 0.5f, py = (float)y + 0.5f;
        if (SCISSOR &&
            !(px >= sc[0] && px < sc[2] && py >= sc[1] && py < sc[3]))
          continue;
        float best = __int_as_float(0xff800000);  // -inf
        int best_s = -1;
        for (unsigned left = mask; left; left &= left - 1) {
          const int sl = __ffs(left) - 1;
          float d[STRIDE];
          if constexpr (STRIDE % 4 == 0) {
            const float4* q = (const float4*)(grp + sl * STRIDE);
#pragma unroll
            for (int k = 0; k < STRIDE / 4; ++k) {
              const float4 v = q[k];
              d[4 * k] = v.x;
              d[4 * k + 1] = v.y;
              d[4 * k + 2] = v.z;
              d[4 * k + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int k = 0; k < STRIDE; ++k) d[k] = grp[sl * STRIDE + k];
          }
          bool inside = true;
#pragma unroll
          for (int j = 0; j < NEDGE; ++j)  // NaN fails, as max(..) <= 0 does
            inside = inside &&
                     edge(d[3 * j], d[3 * j + 1], d[3 * j + 2], px, py) <= 0.f;
          const float z = edge(d[3 * NEDGE], d[3 * NEDGE + 1],
                               d[3 * NEDGE + 2], px, py);
          if (inside && z > best) {
            best = z;
            best_s = sl;
          }
        }
        if (best_s < 0) continue;
        const size_t pix = (size_t)y * W + x;
        if (!(best > depth[pix])) continue;
        const unsigned int seq =
            (unsigned int)b * (unsigned int)ntri + g0 + best_s;
        atomicMax(&key[pix], make_key(best, 0xFFFFFFFEu - seq));
      }
      if constexpr (!GROUPS) break;
    }
  }
}

__global__ void decode_keys(const long long* __restrict__ key,
                            const float* __restrict__ depth,
                            const float* __restrict__ winner,
                            const float* __restrict__ rec_rows, int row_len,
                            const int* __restrict__ owner, int ntri,
                            int stride, int id_field, int n,
                            float* __restrict__ dep_out,
                            float* __restrict__ win_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = key[i];
  const unsigned int low = (unsigned int)(k & 0xFFFFFFFFll);
  if (low == LOW_INIT) {
    dep_out[i] = depth[i];
    win_out[i] = winner[i];
    return;
  }
  const unsigned int seq = 0xFFFFFFFEu - low;
  const int b = (int)(seq / (unsigned int)ntri);
  const int s = (int)(seq % (unsigned int)ntri);
  dep_out[i] = key_float(k);
  win_out[i] = rec_rows[(size_t)owner[b] * row_len + s * stride + id_field];
}

}  // namespace

extern "C" const char* bt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// depth, winner: (H, W) f32 inputs; rec_rows (ncl, row_len) f32; owner,
// meta (nwin,) int32; wvalid (nwin,) bool, a valid prefix; key (H * W + 1)
// int64 scratch (the last element holds the negative-depth flag); dep_out,
// win_out (H, W) f32 outputs; scissor (4,) f32 [x0, y0, x1, y1) in device
// memory, or null for none. Returns cudaErrorInvalidValue, launching
// nothing, when one window's shared memory exceeds what a CTA may opt
// into; else cudaGetLastError().
extern "C" int bt_splat_fused(const float* depth, const float* winner,
                              const float* rec_rows, int row_len,
                              const int* owner, const int* meta,
                              const unsigned char* wvalid, int nwin, int ntri,
                              int nedge, int win_h, int H, int W,
                              long long* key, float* dep_out, float* win_out,
                              const float* scissor, void* stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int per_warp = Layout(ntri, nedge, win_h).words * 4;
  const int warps = per_warp * WARPS <= optin ? WARPS : optin / per_warp;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int smem = warps * per_warp;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = H * W;
  const int pix_blocks = (n + THREADS - 1) / THREADS;
  int* neg = (int*)(key + n);
  cudaMemsetAsync(neg, 0, sizeof(int), st);
  init_keys<<<pix_blocks, THREADS, 0, st>>>(depth, key, n, neg);
  if (nwin > 0) {
    // as many CTAs as fit on the card at once; the grid-stride loop takes
    // the rest (a second wave would leave its SMs the last windows alone)
    using Kernel = decltype(&splat_windows<3, false, false>);
    static const Kernel kernels[2][2][2] = {
        {{splat_windows<3, false, false>, splat_windows<3, false, true>},
         {splat_windows<3, true, false>, splat_windows<3, true, true>}},
        {{splat_windows<4, false, false>, splat_windows<4, false, true>},
         {splat_windows<4, true, false>, splat_windows<4, true, true>}}};
    const Kernel kernel =
        kernels[nedge == 4][ntri > 32][scissor != nullptr];
    if (smem > 48 * 1024)  // past the default: opt in
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32,
                                                  smem);
    const int need = (nwin + warps - 1) / warps;
    const int fit = (per_sm > 0 ? per_sm : 1) * sms;
    kernel<<<need < fit ? need : fit, warps * 32, smem, st>>>(
        depth, rec_rows, row_len, owner, meta, wvalid, nwin, ntri, win_h, H, W,
        key, neg, scissor);
  }
  const int stride = 3 * nedge + 4;
  decode_keys<<<pix_blocks, THREADS, 0, st>>>(
      key, depth, winner, rec_rows, row_len, owner, ntri, stride,
      3 * nedge + 3, n, dep_out, win_out);
  return (int)cudaGetLastError();
}
