// Kernel B3: deferred GGX shade — directional + ambient + tile-binned
// point, spot and rect lights — of a G-buffer into a colour buffer.
//
// Replaces bevy_tpu/ops/shade_pallas.py::_shade_kernel (entry
// deferred_shade). There, one grid step shaded a whole 32x128 bin tile:
// it DMA'd the tile's (F, mpt) light list into SMEM behind a semaphore and
// walked it with the tile's pixels as vectors, skipping a light whose
// range sphere misses the tile's sub-frustum. Here one thread shades one
// pixel; a 256-thread CTA covers a 16x16 block inside one bin tile.
//
// What bounds it on an H100: arithmetic on the light walk. A (pixel,
// light) body costs ~94 FP32 operations (two rsqrt, four divisions) and
// more with spot, clearcoat or anisotropy, against ~70 bytes of G-buffer,
// depth and output a pixel. The reference walks every light of the tile
// that passes the tile test; at many_lights 100k (a light grid 1.5 above
// the floor, range 6) most of those pairs add exactly nothing, because a
// 16x16 block sees only a small floor patch. The work the inputs need is
// the body over the pairs that contribute (win > 0).
//
// Design:
// - Block bounds, once a CTA: the bin tile's four sub-frustum side planes
//   (the reference's test, from the tile's corners) and the 16x16 block's
//   own, with the same corner_dir / side_plane arithmetic and the band row
//   offset P[34]; and the world-space AABB of the block's geometry pixels
//   (dep > 0), reduced with warp shuffles and shared memory. A sky-only
//   block skips the walk.
// - Lights are staged 128 at a time (F x 128 floats) with cp.async into a
//   double buffer: the next chunk is in flight while the current one is
//   culled and walked.
// - Cull and compaction, one thread a staged light: the reference's tile
//   test, unchanged (the plain version applies it, so the kernel must
//   too), then the block side planes with a relative margin of 2^-10 of
//   (range + |light - eye|_1), and the sphere-vs-geometry-AABB test. A
//   warp ballot, a popcount prefix and a scan of the four warps' totals
//   write the survivors' slots to shared memory in list order, so every
//   pixel adds its terms in the reference's order. Rect lights walk the
//   whole list, as in the reference.
// - The AABB test is exact with no margin: it computes the gap from the
//   light centre to the box with the body's own subtraction (d0 - w) and
//   squares and sums it in the body's order. Rounding is monotone, so
//   every geometry pixel's d2 is >= that sum and its q = d2 / rng2 >= the
//   tested one; a dropped light has q >= 1 on every geometry pixel, so
//   1 - q*q <= 0 and win == 0 there. The side planes are conservative by
//   their margin: a pixel centre lies half a pixel inside its block, which
//   puts its world point ~6e-4 of its distance inside each plane, far
//   beyond the few-ulp errors the margin covers.
// - Per-pixel exact early-out: the body computes d2, q and win exactly as
//   before and skips the rest of the light where win == 0.0f (a warp skips
//   the light when all its lanes do). Why the skipped term is +0.0: atten
//   = win*win / (d2 + 1) = +0, so cr = d(3) * 0 is +-0, and every other
//   factor of (dr + sr) * cr * nol (or ((dr + sr) * keep + coat) * cr *
//   nol) is finite and non-negative for a G-buffer of finite, in-range
//   values (every denominator is clamped away from 0, nol >= 0, albedo,
//   metallic and clearcoat in [0, 1]); acc + (+-0) == acc, since acc
//   (ambient + directional, both >= 0) is never -0. The one case where
//   the skip is not exact: a NaN or an infinity in the G-buffer, where
//   the walk would have added NaN (x * 0) and the skip adds nothing. The
//   block cull drops only lights whose win is 0 on every geometry pixel,
//   so the same argument covers it.
// - The six static variants (spot, rect, clearcoat, anisotropy,
//   reflectance, specular tint) are template parameters; no shadow plane
//   means a factor of 1.0f (x * 1.0f == x, exact).
// - Arithmetic follows the reference's association order and the library
//   builds with --fmad=false, so no multiply-add is contracted. Intrinsics:
//   rsqrtf for rsqrt (MUFU.RSQ, not correctly rounded — the plain PyTorch
//   version's torch.rsqrt calls the same function), sqrtf and '/' IEEE
//   round-to-nearest (nvcc's default -prec-sqrt=true -prec-div=true).

#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int BLK = 16;       // CTA block: BLK x BLK pixels
constexpr int THREADS = BLK * BLK;
constexpr int NWARPS = THREADS / 32;
constexpr int CHUNK = 128;    // lights staged per pass
constexpr int CWARPS = CHUNK / 32;   // warps that cull a chunk
constexpr int MAXF = 24;
constexpr float PI = 3.14159265f;
constexpr float PLANE_MARGIN = 1.0f / 1024.0f;
static_assert(CHUNK <= THREADS, "one thread culls each staged light");

struct Args {
  const float* gbuf;    // (nplanes, H, W)
  const float* depth;   // (H, W)
  const float* shadow;  // (H, W) or nullptr
  const float* table;   // (T, F, mpt)
  const int* counts;    // (T,)
  const float* params;  // (40,)
  float* out;           // (4, H, W)
  int H, W, F, mpt, tile_h, tile_w, ntx;
};

struct Corner {
  float x, y, z;
};

__device__ __forceinline__ Corner corner_dir(const float* p, float cx,
                                             float cy) {
  const float nxc = 2.0f * cx / p[25] - 1.0f;
  const float nyc = 1.0f - 2.0f * cy / p[26];
  const float ux = p[0] * nxc + p[1] * nyc + p[2] + p[3];
  const float uy = p[4] * nxc + p[5] * nyc + p[6] + p[7];
  const float uz = p[8] * nxc + p[9] * nyc + p[10] + p[11];
  const float uw = p[12] * nxc + p[13] * nyc + p[14] + p[15];
  const float inv = 1.0f / (fabsf(uw) > 1e-12f ? uw : 1e-12f);
  return {ux * inv - p[31], uy * inv - p[32], uz * inv - p[33]};
}

__device__ __forceinline__ Corner side_plane(Corner a, Corner b, Corner ce) {
  const float nx = a.y * b.z - a.z * b.y;
  const float ny = a.z * b.x - a.x * b.z;
  const float nz = a.x * b.y - a.y * b.x;
  const float inv_n = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-18f));
  const float s =
      nx * ce.x + ny * ce.y + nz * ce.z >= 0.0f ? inv_n : -inv_n;
  return {nx * s, ny * s, nz * s};
}

// The inward side planes of the sub-frustum through the screen rect
// [x0, x0 + w) x [y0, y0 + h) (y0 with the band offset added).
__device__ __forceinline__ void sub_frustum(const float* p, float x0,
                                            float y0, float w, float h,
                                            Corner* out) {
  const Corner ca = corner_dir(p, x0, y0);
  const Corner cb = corner_dir(p, x0 + w, y0);
  const Corner cc = corner_dir(p, x0 + w, y0 + h);
  const Corner cd = corner_dir(p, x0, y0 + h);
  const Corner ce = corner_dir(p, x0 + 0.5f * w, y0 + 0.5f * h);
  out[0] = side_plane(ca, cb, ce);
  out[1] = side_plane(cb, cc, ce);
  out[2] = side_plane(cc, cd, ce);
  out[3] = side_plane(cd, ca, ce);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The gap from c to [lo, hi] by the body's subtraction c - w: every w in
// [lo, hi] gives |c - w| >= |gap| (rounding is monotone).
__device__ __forceinline__ float gap(float c, float lo, float hi) {
  return c > hi ? c - hi : (c < lo ? c - lo : 0.0f);
}

// Per-pixel state shared by every light (the reference's values hoisted
// out of shade_light).
struct Pixel {
  float nx, ny, nz, vx, vy, vz, nov, alpha, a2;
  float dr, dg, db, f0r, f0g, f0b;
  float cc, cc_a2;                                    // clearcoat
  float tx, ty, tz, bx, by, bz, at, ab, lam_v_c;      // anisotropy
};

template <bool CC, bool ANISO>
__device__ __forceinline__ void shade_light(const Pixel& q, float lx,
                                            float ly, float lz, float cr,
                                            float cg, float cb, float& rr,
                                            float& rg, float& rb) {
  const float nol = fmaxf(q.nx * lx + q.ny * ly + q.nz * lz, 0.0f);
  const float hx = lx + q.vx, hy = ly + q.vy, hz = lz + q.vz;
  const float inv_h = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-9f));
  const float noh = fmaxf((q.nx * hx + q.ny * hy + q.nz * hz) * inv_h, 0.0f);
  const float loh = fmaxf((lx * hx + ly * hy + lz * hz) * inv_h, 0.0f);
  float dist, vis;
  if constexpr (ANISO) {
    const float toh = (q.tx * hx + q.ty * hy + q.tz * hz) * inv_h;
    const float boh = (q.bx * hx + q.by * hy + q.bz * hz) * inv_h;
    const float a2an = q.at * q.ab;
    const float qt = toh / q.at, qb = boh / q.ab;
    const float dsum = qt * qt + qb * qb + noh * noh;
    dist = 1.0f / fmaxf(PI * a2an * dsum * dsum, 1e-9f);
    const float tol = q.tx * lx + q.ty * ly + q.tz * lz;
    const float bol = q.bx * lx + q.by * ly + q.bz * lz;
    const float la = q.at * tol, lb = q.ab * bol;
    const float lam_l = sqrtf(fmaxf(la * la + lb * lb + nol * nol, 1e-12f));
    vis = 0.5f / fmaxf(nol * q.lam_v_c + q.nov * lam_l, 1e-4f);
  } else {
    const float den = noh * noh * (q.a2 - 1.0f) + 1.0f;
    dist = q.a2 / fmaxf(PI * den * den, 1e-9f);
    vis = 0.5f / fmaxf(nol * (q.nov * (1.0f - q.alpha) + q.alpha) +
                           q.nov * (nol * (1.0f - q.alpha) + q.alpha),
                       1e-4f);
  }
  const float x = 1.0f - loh;
  const float x2 = x * x;
  const float fres = x2 * x2 * x;
  const float dv = dist * vis;
  const float sr = dv * (q.f0r + (1.0f - q.f0r) * fres);
  const float sg = dv * (q.f0g + (1.0f - q.f0g) * fres);
  const float sb = dv * (q.f0b + (1.0f - q.f0b) * fres);
  if constexpr (!CC) {
    rr = (q.dr + sr) * cr * nol;
    rg = (q.dg + sg) * cg * nol;
    rb = (q.db + sb) * cb * nol;
  } else {
    const float ccden = noh * noh * (q.cc_a2 - 1.0f) + 1.0f;
    const float ccdist = q.cc_a2 / fmaxf(PI * ccden * ccden, 1e-9f);
    const float ccvis = 0.25f / fmaxf(loh * loh, 1e-4f);
    const float fc = (0.04f + 0.96f * fres) * q.cc;
    const float coat = ccdist * ccvis * fc;
    const float keep = 1.0f - fc;
    rr = ((q.dr + sr) * keep + coat) * cr * nol;
    rg = ((q.dg + sg) * keep + coat) * cg * nol;
    rb = ((q.db + sb) * keep + coat) * cb * nol;
  }
}

// Two CTAs an SM at least: with the thread count alone, ptxas stops at 80
// registers in 20 of the 64 variants (for a third CTA an SM) and spills
// 24-32 bytes there; with the minimum of two it uses 80-96 and spills
// none (NVIDIA H100, nvcc 12.9).
template <bool SPOT, bool RECT, bool CC, bool ANISO, bool REFL, bool TINT>
__global__ void __launch_bounds__(THREADS, 2) shade(Args a) {
  __shared__ float P[40];
  __shared__ float L[2][MAXF * CHUNK];     // double-buffered light chunk
  __shared__ unsigned char slots[CHUNK];   // survivors, in list order
  __shared__ int wtot[CWARPS];
  __shared__ float red[6][NWARPS];
  __shared__ float box[6];                 // geometry AABB: min xyz, max xyz
  __shared__ Corner planes[4];             // the bin tile's side planes
  __shared__ Corner bplanes[4];            // this block's side planes

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bx0 = blockIdx.x * BLK, by0 = blockIdx.y * BLK;
  const int x = bx0 + tid % BLK, y = by0 + tid / BLK;
  const bool in = x < a.W && y < a.H;
  const size_t plane = (size_t)a.H * a.W;
  const size_t pix = in ? (size_t)y * a.W + x : 0;
  if (tid < 40) P[tid] = a.params[tid];
  const int t = (by0 / a.tile_h) * a.ntx + bx0 / a.tile_w;
  const int cnt = min(a.counts[t], a.mpt);
  const float* tl = a.table + (size_t)t * a.F * a.mpt;
  const int nchunks = (cnt + CHUNK - 1) / CHUNK;
  // the first chunk's copy overlaps the pixel setup
  auto stage = [&](int buf, int c0) {
    const int n = min(CHUNK, cnt - c0);
    for (int i = tid; i < a.F * CHUNK; i += THREADS) {
      const int k = i / CHUNK, j = i % CHUNK;
      if (j < n) cp_async4(&L[buf][i], tl + (size_t)k * a.mpt + c0 + j);
    }
    cp_async_commit();
  };
  if (nchunks > 0) stage(0, 0);
  __syncthreads();

  if (tid == 0) {
    // the bin tile's sub-frustum (reference: corner_dir / side_plane)
    sub_frustum(P, (float)((bx0 / a.tile_w) * a.tile_w),
                (float)((by0 / a.tile_h) * a.tile_h) + P[34],
                (float)a.tile_w, (float)a.tile_h, planes);
  } else if (tid == 32) {
    sub_frustum(P, (float)bx0, (float)by0 + P[34], (float)BLK, (float)BLK,
                bplanes);
  }

  auto g = [&](int k) { return in ? a.gbuf[(size_t)k * plane + pix] : 0.0f; };
  const float dep = in ? a.depth[pix] : 0.0f;
  const bool geom = dep > 0.0f;

  // world position from reverse-z depth
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f + P[34];
  const float ndx = 2.0f * px / P[25] - 1.0f;
  const float ndy = 1.0f - 2.0f * py / P[26];
  float wx = P[0] * ndx + P[1] * ndy + P[2] * dep + P[3];
  float wy = P[4] * ndx + P[5] * ndy + P[6] * dep + P[7];
  float wz = P[8] * ndx + P[9] * ndy + P[10] * dep + P[11];
  const float ww = P[12] * ndx + P[13] * ndy + P[14] * dep + P[15];
  const float inv_ww = 1.0f / (fabsf(ww) > 1e-9f ? ww : 1.0f);
  wx = wx * inv_ww;
  wy = wy * inv_ww;
  wz = wz * inv_ww;

  // the AABB of the block's geometry pixels
  {
    float v[6] = {geom ? wx : INFINITY,  geom ? wy : INFINITY,
                  geom ? wz : INFINITY,  geom ? wx : -INFINITY,
                  geom ? wy : -INFINITY, geom ? wz : -INFINITY};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float o = __shfl_xor_sync(0xffffffffu, v[k], off);
        v[k] = k < 3 ? fminf(v[k], o) : fmaxf(v[k], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) red[k][warp] = v[k];
    }
  }
  __syncthreads();
  if (tid < 6) {
    float r = red[tid][0];
    for (int w = 1; w < NWARPS; ++w)
      r = tid < 3 ? fminf(r, red[tid][w]) : fmaxf(r, red[tid][w]);
    box[tid] = r;
  }

  Pixel q;
  const float ar = g(0), ag = g(1), ab = g(2), aa = g(3);
  q.nx = g(4);
  q.ny = g(5);
  q.nz = g(6);
  const float er = g(7), eg = g(8), eb = g(9);
  const float met = g(10);
  const float rough = clampf(g(11), 0.045f, 1.0f);
  if constexpr (CC) {
    q.cc = g(12);
    const float ccr = clampf(g(13), 0.045f, 1.0f);
    q.cc_a2 = (ccr * ccr) * (ccr * ccr);
  }
  float aniso = 0.0f;
  if constexpr (ANISO) {
    float tx = g(14), ty = g(15), tz = g(16);
    aniso = g(17);
    const float tlen2 = tx * tx + ty * ty + tz * tz;
    const float fy = fabsf(q.ny) < 0.9f ? 1.0f : 0.0f;
    const float fx = 1.0f - fy;
    const bool use_fb = tlen2 < 0.25f;
    if (use_fb) {
      tx = fy * q.nz;
      ty = -fx * q.nz;
      tz = fx * q.ny - fy * q.nx;
    }
    const float inv_tl = rsqrtf(fmaxf(tx * tx + ty * ty + tz * tz, 1e-12f));
    q.tx = tx * inv_tl;
    q.ty = ty * inv_tl;
    q.tz = tz * inv_tl;
    if (use_fb) aniso = 0.0f;
  }

  q.vx = P[31] - wx;
  q.vy = P[32] - wy;
  q.vz = P[33] - wz;
  const float inv_vlen =
      rsqrtf(fmaxf(q.vx * q.vx + q.vy * q.vy + q.vz * q.vz, 1e-9f));
  q.vx = q.vx * inv_vlen;
  q.vy = q.vy * inv_vlen;
  q.vz = q.vz * inv_vlen;
  q.nov = fmaxf(q.nx * q.vx + q.ny * q.vy + q.nz * q.vz, 1e-4f);
  q.alpha = rough * rough;
  q.a2 = q.alpha * q.alpha;
  if constexpr (ANISO) {
    q.bx = q.ny * q.tz - q.nz * q.ty;
    q.by = q.nz * q.tx - q.nx * q.tz;
    q.bz = q.nx * q.ty - q.ny * q.tx;
    q.at = fmaxf(q.alpha * (1.0f + aniso), 1e-3f);
    q.ab = fmaxf(q.alpha * (1.0f - aniso), 1e-3f);
    const float tov = q.tx * q.vx + q.ty * q.vy + q.tz * q.vz;
    const float bov = q.bx * q.vx + q.by * q.vy + q.bz * q.vz;
    const float va = q.at * tov, vb = q.ab * bov;
    q.lam_v_c = sqrtf(fmaxf(va * va + vb * vb + q.nov * q.nov, 1e-12f));
  }
  q.dr = ar * (1.0f - met);
  q.dg = ag * (1.0f - met);
  q.db = ab * (1.0f - met);
  float base_f0 = 0.04f;
  if constexpr (REFL) base_f0 = 0.16f * g(18) * g(18);
  if constexpr (TINT) {
    q.f0r = base_f0 * g(19) * (1.0f - met) + ar * met;
    q.f0g = base_f0 * g(20) * (1.0f - met) + ag * met;
    q.f0b = base_f0 * g(21) * (1.0f - met) + ab * met;
  } else {
    q.f0r = base_f0 * (1.0f - met) + ar * met;
    q.f0g = base_f0 * (1.0f - met) + ag * met;
    q.f0b = base_f0 * (1.0f - met) + ab * met;
  }

  // directional (shadowed) + ambient
  const float lit = (a.shadow != nullptr && in) ? a.shadow[pix] : 1.0f;
  float drr, drg, drb;
  shade_light<CC, ANISO>(q, -P[16], -P[17], -P[18], P[19], P[20], P[21], drr,
                         drg, drb);
  float acc_r = ar * P[22] + drr * lit;
  float acc_g = ag * P[23] + drg * lit;
  float acc_b = ab * P[24] + drb * lit;

  // the tile's light walk, culled to this block, in list order; a block
  // with no geometry skips it (and drains its first copy)
  if (!__syncthreads_or(geom)) {
    cp_async_wait<0>();
  } else {
    for (int c = 0; c < nchunks; ++c) {
      const int buf = c & 1, c0 = c * CHUNK, n = min(CHUNK, cnt - c0);
      __syncthreads();  // chunk c - 1 is walked: its buffer may be reused
      if (c + 1 < nchunks) {
        stage(buf ^ 1, c0 + CHUNK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c has landed for every thread
      const float* Lb = L[buf];
      bool keep = false;
      if (tid < n) {
        keep = true;
        if constexpr (!RECT) {
          const float l0 = Lb[tid], l1 = Lb[CHUNK + tid],
                      l2 = Lb[2 * CHUNK + tid], rng = Lb[6 * CHUNK + tid];
          const float lcx = l0 - P[31], lcy = l1 - P[32], lcz = l2 - P[33];
          // the reference's tile test, as it is
#pragma unroll
          for (int k = 0; k < 4; ++k)
            keep = keep && (planes[k].x * lcx + planes[k].y * lcy +
                                planes[k].z * lcz >
                            -rng);
          const float margin =
              PLANE_MARGIN * (rng + fabsf(lcx) + fabsf(lcy) + fabsf(lcz));
#pragma unroll
          for (int k = 0; k < 4; ++k)
            keep = keep && (bplanes[k].x * lcx + bplanes[k].y * lcy +
                                bplanes[k].z * lcz >
                            -(rng + margin));
          const float gx = gap(l0, box[0], box[3]);
          const float gy = gap(l1, box[1], box[4]);
          const float gz = gap(l2, box[2], box[5]);
          const float rng2 = fmaxf(rng * rng, 1e-9f);
          keep = keep && !((gx * gx + gy * gy + gz * gz) / rng2 >= 1.0f);
        }
      }
      const unsigned ball = __ballot_sync(0xffffffffu, keep);
      if (warp < CWARPS && lane == 0) wtot[warp] = __popc(ball);
      __syncthreads();
      int m = 0, pre = 0;
#pragma unroll
      for (int w = 0; w < CWARPS; ++w) {
        pre += w < warp ? wtot[w] : 0;
        m += wtot[w];
      }
      if (keep) slots[pre + __popc(ball & ((1u << lane) - 1u))] = tid;
      __syncthreads();
      if (!geom) continue;
      for (int s = 0; s < m; ++s) {
        const int j = slots[s];
        auto d = [&](int k) { return Lb[k * CHUNK + j]; };
        float dx = d(0) - wx, dy = d(1) - wy, dz = d(2) - wz;
        float side = 1.0f;
        if constexpr (RECT) {
          const float qu =
              clampf(-(dx * d(16) + dy * d(17) + dz * d(18)), -d(22), d(22));
          const float qv =
              clampf(-(dx * d(19) + dy * d(20) + dz * d(21)), -d(23), d(23));
          side = (d(15) > 0.5f && dx * d(8) + dy * d(9) + dz * d(10) > 0.0f)
                     ? 0.0f
                     : 1.0f;
          dx = dx + qu * d(16) + qv * d(19);
          dy = dy + qu * d(17) + qv * d(20);
          dz = dz + qu * d(18) + qv * d(21);
        }
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float rng2 = fmaxf(d(6) * d(6), 1e-9f);
        const float r = d2 / rng2;
        const float win = clampf(1.0f - r * r, 0.0f, 1.0f);
        if (win == 0.0f) continue;  // the term is +0.0 (see the header)
        const float inv_d = rsqrtf(fmaxf(d2, 1e-9f));
        float atten = win * win / (d2 + 1.0f);
        if constexpr (SPOT) {
          const float cos_to = -(dx * inv_d * d(8) + dy * inv_d * d(9) +
                                 dz * inv_d * d(10));
          const float cone = clampf((cos_to - d(11)) * d(12), 0.0f, 1.0f);
          atten = atten * cone * cone;
        }
        if constexpr (RECT) atten = atten * side;
        float pr, pg, pb;
        shade_light<CC, ANISO>(q, dx * inv_d, dy * inv_d, dz * inv_d,
                               d(3) * atten, d(4) * atten, d(5) * atten, pr,
                               pg, pb);
        acc_r = acc_r + pr;
        acc_g = acc_g + pg;
        acc_b = acc_b + pb;
      }
    }
  }

  if (in) {
    a.out[pix] = geom ? acc_r + er : P[27];
    a.out[plane + pix] = geom ? acc_g + eg : P[28];
    a.out[2 * plane + pix] = geom ? acc_b + eb : P[29];
    a.out[3 * plane + pix] = geom ? aa : P[30];
  }
}

using Launch = void (*)(const Args&, dim3, cudaStream_t);

template <int V>
void launch(const Args& a, dim3 grid, cudaStream_t s) {
  shade<(V & 1) != 0, (V & 2) != 0, (V & 4) != 0, (V & 8) != 0,
        (V & 16) != 0, (V & 32) != 0><<<grid, THREADS, 0, s>>>(a);
}

template <int... V>
constexpr std::array<Launch, sizeof...(V)> make_table(
    std::integer_sequence<int, V...>) {
  return {{&launch<V>...}};
}

constexpr auto kLaunch = make_table(std::make_integer_sequence<int, 64>{});

}  // namespace

// gbuffer (nplanes, H, W) f32; depth (H, W) f32; shadow (H, W) f32 or 0;
// table (T, F, mpt) f32 with T = ceil(H/tile_h) * ntx; counts (T,) int32;
// params (40,) f32; out (4, H, W) f32. variant bits: 1 spot, 2 rect,
// 4 clearcoat, 8 anisotropy, 16 reflectance, 32 specular tint.
// tile_h and tile_w are multiples of 16. Returns cudaGetLastError().
extern "C" int bt_deferred_shade(const float* gbuf, int nplanes,
                                 const float* depth, const float* shadow,
                                 const float* table, int F, int mpt,
                                 const int* counts, const float* params,
                                 int H, int W, int tile_h, int tile_w,
                                 int ntx, int variant, float* out,
                                 void* stream) {
  (void)nplanes;
  if (variant < 0 || variant >= 64 || F > MAXF || tile_h % BLK ||
      tile_w % BLK)
    return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  const Args a{gbuf, depth, shadow, table, counts, params, out,
               H,    W,     F,      mpt,   tile_h, tile_w, ntx};
  const dim3 grid((W + BLK - 1) / BLK, (H + BLK - 1) / BLK);
  kLaunch[variant](a, grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
