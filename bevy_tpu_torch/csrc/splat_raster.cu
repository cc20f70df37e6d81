// Kernel B1: fused window evaluate + composite for the window-splat raster.
//
// Replaces bevy_tpu/ops/raster3d_splat.py::_fused_kernel (entry
// fused_eval_composite), which ran windows one after another on the TPU's
// sequential grid and so read-modify-wrote the framebuffer race-free.
//
// What bounds it on an H100: per window, ntri record slots x (nedge+1)
// plane evaluations over win_h x 128 pixels — a few hundred FP32 ops per
// pixel at most — against 4 bytes of depth read plus one 8-byte atomic per
// covered pixel. At many_cubes 160k (1280x720, <= 2 x 65,536 windows of
// <= 32 x 128 px, 4 quad slots) that is O(1e9) simple ops and O(1e8) bytes:
// issue- and launch-bound, far from both rooflines.
//
// Design: one CTA per window, in any order. The sequential TPU result at a
// pixel is the lexicographic maximum of (z, -seq) over writes that pass the
// edge test (seq = window * ntri + slot; the incoming depth wins ties), so
// each pixel's best slot of a window goes into a 64-bit atomicMax on
//   key = order(z) << 32 | (0xFFFFFFFE - seq)
// where order() maps f32 bits to an int32 of the same order. A decode pass
// turns seq back into the record's id. Edges and z are evaluated with
// __fmul_rn/__fadd_rn in the JAX association order (a*px + c) + b*py, so
// results match the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_merge.cuh"

namespace {

constexpr int WIN_W = 128;
constexpr int THREADS = 256;

template <int NEDGE>
__global__ void __launch_bounds__(THREADS)
splat_windows(const float* __restrict__ depth,
              const float* __restrict__ rec_rows, int row_len,
              const int* __restrict__ owner, const int* __restrict__ meta,
              const unsigned char* __restrict__ wvalid, int ntri, int win_h,
              int H, int W, long long* __restrict__ key) {
  extern __shared__ float rec[];
  const int b = blockIdx.x;
  if (!wvalid[b]) return;
  const float* src = rec_rows + (size_t)owner[b] * row_len;
  for (int i = threadIdx.x; i < row_len; i += THREADS) rec[i] = src[i];
  __syncthreads();

  constexpr int STRIDE = 3 * NEDGE + 4;
  const int m = meta[b];
  const int x = (m / 2048) * WIN_W + (threadIdx.x % WIN_W);
  const int y0 = m % 2048;
  const float px = (float)x + 0.5f;
  if (x >= W) return;  // computed columns past the frame are never stored
  for (int r = threadIdx.x / WIN_W; r < win_h; r += THREADS / WIN_W) {
    const int y = y0 + r;
    if (y >= H) break;
    const float py = (float)y + 0.5f;
    float best = __int_as_float(0xff800000);  // -inf
    int best_s = -1;
    for (int s = 0; s < ntri; ++s) {
      const float* d = rec + s * STRIDE;
      bool inside = true;
#pragma unroll
      for (int j = 0; j < NEDGE; ++j) {
        float e = __fadd_rn(__fadd_rn(__fmul_rn(d[3 * j], px), d[3 * j + 2]),
                            __fmul_rn(d[3 * j + 1], py));
        inside = inside && (e <= 0.f);  // NaN fails, as max(..) <= 0 does
      }
      const float* zp = d + 3 * NEDGE;
      float z = __fadd_rn(__fadd_rn(__fmul_rn(zp[0], px), zp[2]),
                          __fmul_rn(zp[1], py));
      if (inside && z > best) {
        best = z;
        best_s = s;
      }
    }
    if (best_s < 0) continue;
    const size_t p = (size_t)y * W + x;
    if (!(best > depth[p])) continue;
    const unsigned int seq = (unsigned int)b * (unsigned int)ntri + best_s;
    atomicMax(&key[p], make_key(best, 0xFFFFFFFEu - seq));
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
// meta (nwin,) int32; wvalid (nwin,) bool; key (H, W) int64 scratch;
// dep_out, win_out (H, W) f32 outputs. Returns cudaGetLastError().
extern "C" int bt_splat_fused(const float* depth, const float* winner,
                              const float* rec_rows, int row_len,
                              const int* owner, const int* meta,
                              const unsigned char* wvalid, int nwin, int ntri,
                              int nedge, int win_h, int H, int W,
                              long long* key, float* dep_out, float* win_out,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = H * W;
  const int pix_blocks = (n + THREADS - 1) / THREADS;
  init_keys<<<pix_blocks, THREADS, 0, st>>>(depth, key, n);
  const size_t smem = (size_t)row_len * sizeof(float);
  if (nwin > 0) {
    if (nedge == 4)
      splat_windows<4><<<nwin, THREADS, smem, st>>>(
          depth, rec_rows, row_len, owner, meta, wvalid, ntri, win_h, H, W,
          key);
    else
      splat_windows<3><<<nwin, THREADS, smem, st>>>(
          depth, rec_rows, row_len, owner, meta, wvalid, ntri, win_h, H, W,
          key);
  }
  const int stride = 3 * nedge + 4;
  decode_keys<<<pix_blocks, THREADS, 0, st>>>(
      key, depth, winner, rec_rows, row_len, owner, ntri, stride,
      3 * nedge + 3, n, dep_out, win_out);
  return (int)cudaGetLastError();
}
