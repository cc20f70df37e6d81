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
// windows of <= 32 x 128 px a class and shard) that is O(1e8) bytes and
// O(1e7) operations: memory-bound, and the atomics' contention on the few
// pixels many windows cover.
//
// Design: one CTA per window, in any order; the windows of one (win_h x
// 128) block are contiguous, so a warp's loads coalesce. Single-band
// clusters' windows start at any row and overlap, so ownership of pixels
// cannot be split by window. The sequential TPU result at a pixel is the
// lexicographic maximum of (dz, -w) over the windows whose dz beats the
// incoming depth (strict; the incoming value wins ties), so each such pixel
// goes into a 64-bit atomicMax on
//   key = order(dz) << 32 | (0xFFFFFFFE - w)
// with the incoming value's low bits 0xFFFFFFFF: B1's key (key_merge.cuh).
// A decode pass turns w back into owner[w] * cs + (bits(dz) & 15). No
// float arithmetic, so the result is the plain PyTorch version's bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_merge.cuh"

namespace {

constexpr int WIN_W = 128;
constexpr int THREADS = 256;
constexpr int ID_MASK = 15;

__global__ void __launch_bounds__(THREADS)
merge_windows(const float* __restrict__ depth,
              const float* __restrict__ windows,
              const int* __restrict__ meta,
              const unsigned char* __restrict__ wvalid, int win_h, int H,
              int W, long long* __restrict__ key) {
  const int b = blockIdx.x;
  if (!wvalid[b]) return;
  const int m = meta[b];
  const int lane = threadIdx.x % WIN_W;
  const int x = (m / 2048) * WIN_W + lane;
  const int y0 = m % 2048;
  if (x >= W) return;  // columns past the frame are never stored
  const float* win = windows + (size_t)b * win_h * WIN_W;
  const unsigned int low = 0xFFFFFFFEu - (unsigned int)b;
  for (int r = threadIdx.x / WIN_W; r < win_h; r += THREADS / WIN_W) {
    const int y = y0 + r;
    if (y >= H) break;
    const float dz = win[r * WIN_W + lane];
    const size_t p = (size_t)y * W + x;
    if (!(dz > depth[p])) continue;
    atomicMax(&key[p], make_key(dz, low));
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
// z|id; owner, meta (nwin,) int32; wvalid (nwin,) bool; key (H, W) int64
// scratch; dep_out, win_out (H, W) f32 outputs. Returns cudaGetLastError().
extern "C" int bt_window_composite(const float* depth, const float* winner,
                                   const float* windows, const int* owner,
                                   const int* meta,
                                   const unsigned char* wvalid, int nwin,
                                   int win_h, int cs, int H, int W,
                                   long long* key, float* dep_out,
                                   float* win_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = H * W;
  const int pix_blocks = (n + THREADS - 1) / THREADS;
  init_keys<<<pix_blocks, THREADS, 0, st>>>(depth, key, n, nullptr);
  if (nwin > 0)
    merge_windows<<<nwin, THREADS, 0, st>>>(depth, windows, meta, wvalid,
                                            win_h, H, W, key);
  decode_keys<<<pix_blocks, THREADS, 0, st>>>(key, depth, winner, owner, cs,
                                              n, dep_out, win_out);
  return (int)cudaGetLastError();
}
