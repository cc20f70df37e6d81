// Kernel B6: merge of pre-evaluated windows into depth + winner id.
//
// Replaces bevy_tpu/ops/raster3d_splat.py::_composite_kernel (entry
// composite_windows), which held the whole framebuffer in VMEM and ran
// windows one after another on the TPU's sequential grid, so each window's
// read-modify-write saw every earlier one.
//
// What bounds it on an H100: per window pixel one 4-byte load, one compare
// and at most one 8-byte atomic; per frame pixel 16 bytes of depth/winner
// read and written. At many_cubes 160k sharded 4 ways (1280x720, <= 32,768
// windows of <= 32 x 128 px a class and shard, ~10k of them valid) that is
// ~1.6e8 bytes of window pixels: memory-bound, and most of those pixels
// are empty (0, "no hit": only 5-12% of a window lies in its cluster's
// screen box).
//
// Design:
// - Only the valid windows. wvalid is a prefix: a persistent grid (as many
//   256-thread CTAs as the card holds at once) walks (window, 2-row group)
//   items in a grid-stride loop that stops at the first invalid window, so
//   the work follows the valid count on the device with no host read and
//   no CTA a budget slot.
// - Wide, independent loads. One warp an item: each lane loads 4 adjacent
//   columns of each row with one 16-byte streaming load (32 lanes cover
//   the 128 columns; the windows are read once). The loads depend on the
//   item index alone, so a warp sends the next item's loads before it
//   tests this one (reading its window's flag and meta, loading the
//   depths, issuing the atomics): one item's loads are always in flight.
// - Empty pixels skipped exactly. With no incoming depth below 0 (init_keys
//   sets a flag), a value dz that is not > 0 (0, "no hit", or NaN) cannot
//   beat any depth (every depth is >= 0, -0 or NaN), so it loads no depth
//   and makes no atomic. Where some depth is below 0, every pixel takes
//   the full test: 0 > depth writes there, as the reference does.
// - Measured on an H100 at many_cubes 160k, 4 shards (PERF.md): 2
//   rows an item with at most 64 registers a thread (4 CTAs an SM) beat 4
//   and 8 rows, loads that wait for the flag, and plain (cached) loads;
//   reading the key instead of the depth to skip atomics that cannot win,
//   and init and decode with 4 pixels a thread, were no faster.
// - The merge is order-free: the sequential TPU result at a pixel is the
//   lexicographic maximum of (dz, -w) over the windows whose dz beats the
//   incoming depth (strict; the incoming value wins ties), so each such
//   pixel goes into a 64-bit atomicMax on
//     key = order(dz) << 32 | (0xFFFFFFFE - w)
//   with the incoming value's low bits 0xFFFFFFFF: B1's key (key_merge.cuh).
//   A decode pass turns w back into owner[w] * cs + (bits(dz) & 15). No
//   float arithmetic, so the result is the plain PyTorch version's bit for
//   bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_merge.cuh"

namespace {

constexpr int WIN_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS = 2;  // window rows a warp item
constexpr int MIN_CTAS = 4;  // CTAs an SM: at most 64 registers a thread
constexpr int ID_MASK = 15;

// one warp item: window b's rows r0 .. r0 + ROWS - 1, 4 columns a lane
struct Item {
  int b, r0;
  float dz[ROWS][4];
};

__device__ __forceinline__ void load_item(const float4* __restrict__ windows,
                                          int it, int groups, int win_h,
                                          int lane, Item& t) {
  t.b = it / groups;
  t.r0 = (it - t.b * groups) * ROWS;
  const float4* src =
      windows + ((size_t)t.b * win_h + t.r0) * (WIN_W / 4) + lane;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t.r0 + i < win_h) v = __ldcs(src + i * (WIN_W / 4));
    t.dz[i][0] = v.x;
    t.dz[i][1] = v.y;
    t.dz[i][2] = v.z;
    t.dz[i][3] = v.w;
  }
}

// merges item t; false at the first invalid window
__device__ __forceinline__ bool merge_item(
    const float* __restrict__ depth, const int* __restrict__ meta,
    const unsigned char* __restrict__ wvalid, int win_h, int H, int W,
    long long* __restrict__ key, bool full_test, int lane, const Item& t) {
  if (!wvalid[t.b]) return false;  // the valid windows are a prefix
  const int m = meta[t.b];
  const int x = (m / 2048) * WIN_W + 4 * lane;  // this lane's first column
  const int y0 = m % 2048 + t.r0;
  if (x >= W) return true;  // columns past the frame are never stored
  const unsigned int low = 0xFFFFFFFEu - (unsigned int)t.b;
  // a pixel needs a depth load iff it is in the window and the frame and,
  // unless some depth is below 0, not empty (dz > 0)
  bool need[ROWS][4];
  float cur[ROWS][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      need[i][j] = t.r0 + i < win_h && y0 + i < H && x + j < W &&
                   (full_test || t.dz[i][j] > 0.0f);
      cur[i][j] = need[i][j] ? depth[(size_t)(y0 + i) * W + x + j] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (need[i][j] && t.dz[i][j] > cur[i][j])
        atomicMax(&key[(size_t)(y0 + i) * W + x + j],
                  make_key(t.dz[i][j], low));
    }
  }
  return true;
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
merge_windows(const float* __restrict__ depth,
              const float4* __restrict__ windows,
              const int* __restrict__ meta,
              const unsigned char* __restrict__ wvalid, int nwin, int win_h,
              int H, int W, long long* __restrict__ key,
              const int* __restrict__ neg) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const bool full_test = *neg != 0;
  const int groups = (win_h + ROWS - 1) / ROWS;  // items a window
  const int items = nwin * groups;
  const int step = gridDim.x * warps;
  int it = blockIdx.x * warps + (threadIdx.x >> 5);
  if (it >= items) return;
  Item cur;
  load_item(windows, it, groups, win_h, lane, cur);
  for (;;) {
    const int next = it + step;
    Item nxt;  // in flight while this item is tested
    if (next < items) load_item(windows, next, groups, win_h, lane, nxt);
    if (!merge_item(depth, meta, wvalid, win_h, H, W, key, full_test, lane,
                    cur) ||
        next >= items)
      break;
    it = next;
    cur = nxt;
  }
}

__global__ void decode_keys(const long long* __restrict__ key,
                            const float* __restrict__ depth,
                            const float* __restrict__ winner,
                            const int* __restrict__ owner, int cs, int n,
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
  const int w = (int)(0xFFFFFFFEu - low);
  const float dz = key_float(k);
  dep_out[i] = dz;
  win_out[i] = __int2float_rn(owner[w] * cs + (__float_as_int(dz) & ID_MASK));
}

}  // namespace

// depth, winner: (H, W) f32 inputs; windows (nwin, win_h, 128) f32 packed
// z|id, 16-byte aligned; owner, meta (nwin,) int32; wvalid (nwin,) bool, a
// valid prefix; key (H * W + 1) int64 scratch (the last element holds the
// negative-depth flag); dep_out, win_out (H, W) f32 outputs. Returns
// cudaErrorInvalidValue, launching nothing, for a misaligned `windows` or
// more (window, 2-row group) items than an int holds; else
// cudaGetLastError().
extern "C" int bt_window_composite(const float* depth, const float* winner,
                                   const float* windows, const int* owner,
                                   const int* meta,
                                   const unsigned char* wvalid, int nwin,
                                   int win_h, int cs, int H, int W,
                                   long long* key, float* dep_out,
                                   float* win_out, void* stream) {
  const long long items = (long long)nwin * ((win_h + ROWS - 1) / ROWS);
  if ((uintptr_t)windows % 16 != 0 || items > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = H * W;
  const int pix_blocks = (n + THREADS - 1) / THREADS;
  int* neg = (int*)(key + n);
  cudaMemsetAsync(neg, 0, sizeof(int), st);
  init_keys<<<pix_blocks, THREADS, 0, st>>>(depth, key, n, neg);
  if (items > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_windows,
                                                  THREADS, 0);
    const long long need = (items + THREADS / 32 - 1) / (THREADS / 32);
    const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    merge_windows<<<(int)(need < fit ? need : fit), THREADS, 0, st>>>(
        depth, (const float4*)windows, meta, wvalid, nwin, win_h, H, W, key,
        neg);
  }
  decode_keys<<<pix_blocks, THREADS, 0, st>>>(key, depth, winner, owner, cs,
                                              n, dep_out, win_out);
  return (int)cudaGetLastError();
}
