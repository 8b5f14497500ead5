// Bundle splat tracer forward, CUDA C++ for sm_90a.
//
// Replaces materialrefgs_tpu/ops/tracer/pallas_kernels.py:trace_bundles_fwd
// (the Pallas `_fwd_kernel`): each bundle of 256 rays composites its pair
// list (gaussians sorted by depth along the bundle's axis) in 128-pair chunks.
// Per (ray, pair): ray-plane hit t = <p-o,n>/<d,n> (|<d,n>| > 1e-9,
// t >= tmin), splat coordinates u, v from the tu/su and tv/sv rows,
// rho = u^2+v^2 <= 9, alpha = min(0.99, opacity*exp(-rho/2)) >= 1/255, color
// max(Y(d/|d|).sh + 0.5, 0) at the ray's own direction, normal flipped against
// the ray. Outputs per ray: rgb, depth, normal, final_T, n_contrib (largest
// 1-based list position that counted), SUMLG (the log-transmittance carried
// past the last processed chunk) and NPROC (processed chunks), in the OUT_*
// layout of ops/tracer/layout.py.
//
// The chunk-to-chunk carry is the chunk's order-independent total,
// logT[c+1] = logT[c] + tot[c], tot[c] the sum of log1p(-alpha) over the
// chunk's hits in lane order (the JAX kernel's exact-order carry,
// pallas_kernels.py:321-323); the bundle stops before the first chunk where
// no ray has logT >= log(1e-4) (its `cond`). So a chunk's starting logT
// depends only on earlier chunk totals, and a bundle's walk is cut into
// ranges of at most R chunks (ops/tracer/ranges.py; R = 8 on the main path,
// a wrapper argument), one block of 256 threads
// (one per ray) per range, in four launches:
//  (a) totals: every range in parallel writes each chunk's tot per ray and
//      the ray's 128-bit mask of the lanes that pass the hit test (the hit
//      test and a log1pf per hit: no color, no sort); a range stops early
//      once its own running total is below the stop for every ray (logT
//      there is at most that total, so the bundle has stopped);
//  (b) carry: one block per bundle turns the totals into each chunk's end
//      logT in chunk order, stops as the JAX `cond` does, and writes NPROC,
//      SUMLG = logT[NPROC] and the per-chunk end logT in place of the
//      totals (with the hit masks, the backward's residual);
//  (c) composite: every range below NPROC in parallel, each chunk from its
//      known starting logT, over the lanes of each ray's hit mask only (the
//      hit test, recomputed for them, gives what it gave (a); a chunk no ray
//      hits is skipped), with the plain version's within-chunk
//      arithmetic: list order lane by lane;
//      exact order the ok lanes' 64-bit (t bits, lane) keys insertion-sorted
//      per thread (in shared memory, KEYS_SMEM per ray, then a local-memory
//      list for a ray with more hits in one chunk), then composited in that
//      order. Each range writes per-(range, ray) partials: rgb, depth,
//      normal from 0, the least included log T, the largest n_contrib;
//  (d) reduce: one block per bundle sums its ranges' partials in range order
//      into the OUT_* row.
// Payload chunks are staged into a two-slot shared-memory ring with cp.async
// (16-byte copies where the payload is aligned), so the next chunk's load
// overlaps this chunk's hit tests: (13 + 3 n_sh) rows x 128 x 4 B a slot,
// 31 KB at n_sh = 16. Launch (a) stages the 13 geometry rows only, lane-major
// (16 floats a lane), so that a hit test reads its lane with four 16-byte
// shared-memory loads, and runs a lane's expf only where the other tests
// pass.
//
// What bounds it on the H100: per (ray, pair) of a processed chunk the hit
// test costs ~45 FP32 operations and one expf; a hit adds a log1pf, an expf
// and 3*(2*n_sh + 1) + ~20 operations for color and compositing (exact order:
// plus its sort). Launch (a) runs every hit test (over chunks past NPROC
// too, up to its early exit) and sets the time; (c) repeats the hit test for
// the hits alone, a fraction of a percent of the tests at a ring view. The
// payload is (13 + 3*n_sh)*4 bytes per pair, shared by 256 rays: FP32/SFU
// work bounds it, not bytes. No block walks more than R chunks, so a
// bundle's long walk (hundreds of chunks on silhouette bundles) is spread
// over as many SMs as it has ranges.
//
// ptxas at n_sh = 16, exact order: (a) 51 registers and 16 KB of shared
// memory; (c) ~100 registers and 95 KB (two staging slots, 16 keys a ray):
// two blocks per SM.
//
// Numerics follow the plain torch version (trace_fwd.trace_bundles_fwd_plain,
// which walks the same ranges) operation for operation, built with
// -fmad=false, so the two agree bit for bit where libdevice and torch do
// (n_contrib and NPROC exactly).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NRAY = 256;  // threads per block, rays per bundle
constexpr int K = 128;     // pairs per chunk
constexpr int C_OUT = 16;
constexpr int NPART = 9;   // per-(range, ray) partials: rgb 3, depth, normal 3, min log T, n_contrib
constexpr int KEYS_SMEM = 16;  // exact-order sort keys per ray kept in shared memory
constexpr int NRES = 5;        // residual rows per chunk: end log T (float bits), 4 hit-mask words

// Index of residual row `row` of global chunk g for ray r.
__device__ __forceinline__ long long res_at(long long g, int row, int r) { return (g * NRES + row) * NRAY + r; }

constexpr int ROW_P = 0;
constexpr int ROW_TU = 3;
constexpr int ROW_TV = 6;
constexpr int ROW_N = 9;
constexpr int ROW_OPA = 12;
constexpr int ROW_SH = 13;

constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float RHO_CUTOFF = 9.0f;
constexpr float LOG_T_STOP = -9.210340371976182f;  // log(1e-4)

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f;
constexpr float C2_1 = -1.0925484305920792f;
constexpr float C2_2 = 0.31539156525252005f;
constexpr float C2_3 = -1.0925484305920792f;
constexpr float C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f;
constexpr float C3_1 = 2.890611442640554f;
constexpr float C3_2 = -0.4570457994644658f;
constexpr float C3_3 = 0.3731763325901154f;
constexpr float C3_4 = -0.4570457994644658f;
constexpr float C3_5 = 1.445305721320277f;
constexpr float C3_6 = -0.5900435899266435f;

// torch.clamp semantics: NaN stays NaN.
__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

// utils/sh.py:sh_basis, expression for expression.
template <int NSH>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* Y) {
  Y[0] = C0;
  if (NSH >= 4) {
    Y[1] = -C1 * y;
    Y[2] = C1 * z;
    Y[3] = -C1 * x;
  }
  if (NSH >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    Y[4] = C2_0 * x * y;
    Y[5] = C2_1 * y * z;
    Y[6] = C2_2 * (2.0f * zz - xx - yy);
    Y[7] = C2_3 * x * z;
    Y[8] = C2_4 * (xx - yy);
    if (NSH >= 16) {
      Y[9] = C3_0 * y * (3.0f * xx - yy);
      Y[10] = C3_1 * x * y * z;
      Y[11] = C3_2 * y * (4.0f * zz - xx - yy);
      Y[12] = C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      Y[13] = C3_4 * x * (4.0f * zz - xx - yy);
      Y[14] = C3_5 * z * (xx - yy);
      Y[15] = C3_6 * x * (xx - 3.0f * yy);
    }
  }
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int b, int r) {
  const float* p = rays + ((long long)b * NRAY + r) * 8;
  return Ray{p[0], p[1], p[2], p[3], p[4], p[5]};
}

struct Hit {
  bool ok;
  float t, alpha, denom;
};

// The hit test of pallas_kernels.py:_geom for lane j of a staged chunk s
// (row-major, K floats a row).
__device__ __forceinline__ Hit hit_test(const float* s, int j, const Ray& q, float tmin) {
  const float px = s[ROW_P * K + j], py = s[(ROW_P + 1) * K + j], pz = s[(ROW_P + 2) * K + j];
  const float nx = s[ROW_N * K + j], ny = s[(ROW_N + 1) * K + j], nz = s[(ROW_N + 2) * K + j];
  Hit h;
  h.denom = q.dx * nx + q.dy * ny + q.dz * nz;
  const bool den_ok = fabsf(h.denom) > 1e-9f;
  const float den_s = den_ok ? h.denom : 1.0f;
  h.t = ((px - q.ox) * nx + (py - q.oy) * ny + (pz - q.oz) * nz) / den_s;
  const float qx = q.ox + h.t * q.dx - px;
  const float qy = q.oy + h.t * q.dy - py;
  const float qz = q.oz + h.t * q.dz - pz;
  const float u = qx * s[ROW_TU * K + j] + qy * s[(ROW_TU + 1) * K + j] + qz * s[(ROW_TU + 2) * K + j];
  const float v = qx * s[ROW_TV * K + j] + qy * s[(ROW_TV + 1) * K + j] + qz * s[(ROW_TV + 2) * K + j];
  const float rho = u * u + v * v;
  h.alpha = clamp_max(s[ROW_OPA * K + j] * expf(-0.5f * rho), ALPHA_MAX);
  h.ok = den_ok && h.t >= tmin && rho <= RHO_CUTOFF && h.alpha >= ALPHA_MIN;
  return h;
}

// Order-preserving map of a float to an unsigned key (all t here are > 0).
__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Start copying rows [0, nrow) of the chunk at column `off` into dst
// (row-major, K floats a row) as one cp.async group.
template <int NROW>
__device__ __forceinline__ void stage_chunk(float* dst, const float* __restrict__ payload, long long ld,
                                            long long off, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < NROW * (K / 4); i += NRAY) {
      const int row = i / (K / 4), q4 = (i % (K / 4)) * 4;
      cp_async16(dst + row * K + q4, payload + (long long)row * ld + off + q4);
    }
  } else {
    for (int i = threadIdx.x; i < NROW * K; i += NRAY) {
      const int row = i / K, lane = i % K;
      cp_async4(dst + row * K + lane, payload + (long long)row * ld + off + lane);
    }
  }
  cp_async_commit();
}

// Sort keys of one thread: KEYS_SMEM in shared memory (stride NRAY), moved
// to a local-memory list when a chunk gives the ray more hits.
struct KeyList {
  unsigned long long* base;
  int stride;
  __device__ __forceinline__ unsigned long long& operator[](int i) { return base[i * stride]; }
};

__device__ __forceinline__ void insert_key(KeyList& kl, unsigned long long* spill, int& n_hits,
                                           unsigned long long key) {
  if (n_hits == KEYS_SMEM && kl.stride != 1) {
    for (int i = 0; i < KEYS_SMEM; ++i) spill[i] = kl[i];
    kl.base = spill;
    kl.stride = 1;
  }
  // Lanes arrive in increasing order: a tie stays behind the earlier lane
  // (the stable sort's order).
  int i = n_hits++;
  while (i > 0 && kl[i - 1] > key) {
    kl[i] = kl[i - 1];
    --i;
  }
  kl[i] = key;
}

struct RangeWork {
  int b, c0, c1;  // bundle and chunk interval [c0, c1) of the block's range
  long long g0;   // the bundle's first global chunk (column / 128)
  int count;
};

__device__ __forceinline__ bool range_of(const int* __restrict__ rb, const int* __restrict__ rc0,
                                         const int* __restrict__ seg_start, const int* __restrict__ seg_count,
                                         int NB, int R, RangeWork& w) {
  w.b = rb[blockIdx.x];
  if (w.b >= NB) return false;
  w.count = seg_count[w.b];
  const int n_chunks = (w.count + K - 1) / K;
  w.c0 = rc0[blockIdx.x];
  w.c1 = min(w.c0 + R, n_chunks);
  w.g0 = seg_start[w.b] / K;
  return w.c0 < w.c1;
}

// ---- (a) chunk totals and hit masks.
constexpr int GSTRIDE = 16;  // floats per lane of (a)'s lane-major staging: 13 geometry rows + pad

// Start copying the geometry rows of the chunk at column `off` into dst,
// lane-major (dst[lane * GSTRIDE + row]), as one cp.async group: a hit test
// then reads its lane's 13 values with four 16-byte loads.
__device__ __forceinline__ void stage_geometry(float* dst, const float* __restrict__ payload, long long ld,
                                               long long off) {
  for (int i = threadIdx.x; i < ROW_SH * K; i += NRAY) {
    const int row = i / K, lane = i % K;
    cp_async4(dst + lane * GSTRIDE + row, payload + (long long)row * ld + off + lane);
  }
  cp_async_commit();
}

// hit_test's arithmetic on lane-major geometry (g: the lane's 16 floats);
// alpha's expf runs only where the other tests pass (alpha is read only
// where ok holds).
__device__ __forceinline__ Hit hit_test_lane(const float* g, const Ray& q, float tmin) {
  const float4 g0 = *reinterpret_cast<const float4*>(g), g1 = *reinterpret_cast<const float4*>(g + 4);
  const float4 g2 = *reinterpret_cast<const float4*>(g + 8), g3 = *reinterpret_cast<const float4*>(g + 12);
  const float px = g0.x, py = g0.y, pz = g0.z;             // ROW_P
  const float tux = g0.w, tuy = g1.x, tuz = g1.y;          // ROW_TU
  const float tvx = g1.z, tvy = g1.w, tvz = g2.x;          // ROW_TV
  const float nx = g2.y, ny = g2.z, nz = g2.w, opa = g3.x;  // ROW_N, ROW_OPA
  Hit h;
  h.denom = q.dx * nx + q.dy * ny + q.dz * nz;
  const bool den_ok = fabsf(h.denom) > 1e-9f;
  const float den_s = den_ok ? h.denom : 1.0f;
  h.t = ((px - q.ox) * nx + (py - q.oy) * ny + (pz - q.oz) * nz) / den_s;
  const float qx = q.ox + h.t * q.dx - px;
  const float qy = q.oy + h.t * q.dy - py;
  const float qz = q.oz + h.t * q.dz - pz;
  const float u = qx * tux + qy * tuy + qz * tuz;
  const float v = qx * tvx + qy * tvy + qz * tvz;
  const float rho = u * u + v * v;
  h.ok = den_ok && h.t >= tmin && rho <= RHO_CUTOFF;
  h.alpha = 0.0f;
  if (h.ok) {
    h.alpha = clamp_max(opa * expf(-0.5f * rho), ALPHA_MAX);
    h.ok = h.alpha >= ALPHA_MIN;
  }
  return h;
}

__global__ void __launch_bounds__(NRAY)
totals_kernel(const float* __restrict__ payload, long long ld, const float* __restrict__ rays,
              const int* __restrict__ seg_start, const int* __restrict__ seg_count, const int* __restrict__ rb,
              const int* __restrict__ rc0, int NB, int R, float tmin, int* __restrict__ res) {
  __shared__ __align__(16) float sh[2][K * GSTRIDE];
  RangeWork w;
  if (!range_of(rb, rc0, seg_start, seg_count, NB, R, w)) return;
  const int r = threadIdx.x;
  const Ray q = load_ray(rays, w.b, r);
  const long long start = seg_start[w.b];
  float run = 0.0f;  // the range's own running total (the early exit's test)
  stage_geometry(sh[0], payload, ld, start + (long long)w.c0 * K);
  for (int c = w.c0; c < w.c1; ++c) {
    const int k = c - w.c0;
    if (c + 1 < w.c1) {
      stage_geometry(sh[(k + 1) & 1], payload, ld, (long long)(c + 1) * K + start);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s = sh[k & 1];
    const int n_lanes = min(K, w.count - c * K);
    float tot = 0.0f;
    unsigned m[4];
#pragma unroll
    for (int wd = 0; wd < 4; ++wd) {
      unsigned bits = 0u;
      for (int b = 0; b < 32 && wd * 32 + b < n_lanes; ++b) {
        const Hit h = hit_test_lane(s + (wd * 32 + b) * GSTRIDE, q, tmin);
        if (h.ok) {
          tot = tot + log1pf(-h.alpha);
          bits |= 1u << b;
        }
      }
      m[wd] = bits;
    }
    res[res_at(w.g0 + c, 0, r)] = __float_as_int(tot);
#pragma unroll
    for (int i = 0; i < 4; ++i) res[res_at(w.g0 + c, 1 + i, r)] = (int)m[i];
    run = run + tot;
    // Also the barrier before the slot is staged again.
    if (!__syncthreads_or(run >= LOG_T_STOP)) break;
  }
  cp_async_wait<0>();
}

// ---- (b) the carry: one block per bundle, in chunk order.
__global__ void __launch_bounds__(NRAY)
carry_kernel(const int* __restrict__ seg_start, const int* __restrict__ seg_count, int* __restrict__ res,
             int* __restrict__ nproc, float* __restrict__ out) {
  constexpr int BATCH = 8;  // totals loaded ahead of the serial scan
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int n = (seg_count[b] + K - 1) / K;
  const long long g0 = seg_start[b] / K;
  float logT = 0.0f;
  int c = 0;
  bool live = true;
  while (live && c < n) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) v[u] = c + u < n ? __int_as_float(res[res_at(g0 + c + u, 0, r)]) : 0.0f;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (!live || c >= n) break;
      // The bundle's loop condition (pallas_kernels.py:328-329).
      if (!__syncthreads_or(logT >= LOG_T_STOP)) {
        live = false;
        break;
      }
      logT = logT + v[u];
      res[res_at(g0 + c, 0, r)] = __float_as_int(logT);
      ++c;
    }
  }
  float* o = out + ((long long)b * NRAY + r) * C_OUT;
  o[9] = logT;
  o[10] = (float)c;
  if (r == 0) nproc[b] = c;
}

// ---- (c) composite every range below NPROC.
template <int NSH, bool EXACT>
__global__ void __launch_bounds__(NRAY)
composite_kernel(const float* __restrict__ payload, long long ld, const float* __restrict__ rays,
                 const int* __restrict__ seg_start, const int* __restrict__ seg_count,
                 const int* __restrict__ rb, const int* __restrict__ rc0, const int* __restrict__ nproc,
                 const int* __restrict__ res, int NB, int R, float tmin, float* __restrict__ part) {
  constexpr int NROW = ROW_SH + 3 * NSH;  // payload rows read
  extern __shared__ __align__(16) float smem[];
  float* slot[2] = {smem, smem + NROW * K};
  unsigned long long* keys_smem = reinterpret_cast<unsigned long long*>(smem + 2 * NROW * K);

  RangeWork w;
  if (!range_of(rb, rc0, seg_start, seg_count, NB, R, w)) return;
  w.c1 = min(w.c1, nproc[w.b]);
  if (w.c0 >= w.c1) return;
  const int r = threadIdx.x;
  const Ray q = load_ray(rays, w.b, r);
  const float inv = 1.0f / sqrtf(clamp_min(q.dx * q.dx + q.dy * q.dy + q.dz * q.dz, 1e-24f));
  float Y[NSH];
  sh_basis<NSH>(q.dx * inv, q.dy * inv, q.dz * inv, Y);
  const bool vec = (ld % 4 == 0) && ((uintptr_t)payload % 16 == 0);
  const long long start = seg_start[w.b];

  float rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f, dep = 0.0f;
  float nrm0 = 0.0f, nrm1 = 0.0f, nrm2 = 0.0f;
  float fin = 0.0f, n_contrib = 0.0f;
  unsigned long long spill[EXACT ? K : 1];

  // The ray's hits in a chunk, as launch (a) found them; a chunk no ray of
  // the block hits is neither staged nor composited.
  auto load_masks = [&](int c, unsigned* m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = (unsigned)res[res_at(w.g0 + c, 1 + i, r)];
  };
  unsigned m[4];
  load_masks(w.c0, m);
  bool any = __syncthreads_or((m[0] | m[1] | m[2] | m[3]) != 0u);
  if (any) stage_chunk<NROW>(slot[0], payload, ld, start + (long long)w.c0 * K, vec);
  for (int c = w.c0; c < w.c1; ++c) {
    const int k = c - w.c0;
    // The chunk's starting log T: the carry's end value of the chunk before.
    const float p0 = c == 0 ? 0.0f : __int_as_float(res[res_at(w.g0 + c - 1, 0, r)]);
    unsigned mn[4] = {0u, 0u, 0u, 0u};
    if (c + 1 < w.c1) load_masks(c + 1, mn);
    // Also the barrier after which no thread reads the slot the next chunk
    // is staged into (it held chunk c - 1).
    const bool any_next = __syncthreads_or((mn[0] | mn[1] | mn[2] | mn[3]) != 0u);
    if (any_next) {
      stage_chunk<NROW>(slot[(k + 1) & 1], payload, ld, start + (long long)(c + 1) * K, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s = slot[k & 1];
    float p = p0;

    // Composite lane j (which passed the hit test h) at the current log T.
    auto composite = [&](int j, const Hit& h) {
      const float lg = log1pf(-h.alpha);
      const float incl = p + lg;
      if (incl >= LOG_T_STOP) {
        const float wt = h.alpha * expf(p);
        float col[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float raw = Y[0] * s[(ROW_SH + ch * NSH) * K + j];
#pragma unroll
          for (int kk = 1; kk < NSH; ++kk) raw = raw + Y[kk] * s[(ROW_SH + ch * NSH + kk) * K + j];
          col[ch] = clamp_min(raw + 0.5f, 0.0f);
        }
        rgb0 = rgb0 + wt * col[0];
        rgb1 = rgb1 + wt * col[1];
        rgb2 = rgb2 + wt * col[2];
        dep = dep + wt * h.t;
        const float wf = wt * (h.denom > 0.0f ? -1.0f : 1.0f);
        nrm0 = nrm0 + wf * s[ROW_N * K + j];
        nrm1 = nrm1 + wf * s[(ROW_N + 1) * K + j];
        nrm2 = nrm2 + wf * s[(ROW_N + 2) * K + j];
        fin = incl < fin ? incl : fin;
        const float pos = (float)(c * K + j + 1);
        n_contrib = pos > n_contrib ? pos : n_contrib;
      }
      p = incl;
    };

    // Only the hits: a lane's hit test gives what it gave launch (a).
    if (any && !EXACT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        for (unsigned bits = m[i]; bits; bits &= bits - 1u) {
          const int j = i * 32 + __ffs(bits) - 1;
          composite(j, hit_test(s, j, q, tmin));
        }
      }
    } else if (any) {
      KeyList kl{keys_smem + r, NRAY};
      int n_hits = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        for (unsigned bits = m[i]; bits; bits &= bits - 1u) {
          const int j = i * 32 + __ffs(bits) - 1;
          const Hit h = hit_test(s, j, q, tmin);
          insert_key(kl, spill, n_hits, ((unsigned long long)order_bits(h.t) << 32) | (unsigned)j);
        }
      }
      for (int i = 0; i < n_hits; ++i) {
        const int j = (int)(kl[i] & 0xffffffffull);
        composite(j, hit_test(s, j, q, tmin));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = mn[i];
    any = any_next;
  }
  cp_async_wait<0>();

  float* o = part + (long long)blockIdx.x * NPART * NRAY + r;
  o[0 * NRAY] = rgb0;
  o[1 * NRAY] = rgb1;
  o[2 * NRAY] = rgb2;
  o[3 * NRAY] = dep;
  o[4 * NRAY] = nrm0;
  o[5 * NRAY] = nrm1;
  o[6 * NRAY] = nrm2;
  o[7 * NRAY] = fin;
  o[8 * NRAY] = n_contrib;
}

// ---- (d) the bundle's ranges' partials, summed in range order.
__global__ void __launch_bounds__(NRAY)
reduce_kernel(const int* __restrict__ range_off, const int* __restrict__ nproc, const float* __restrict__ part,
              int R, float* __restrict__ out) {
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int nr = (nproc[b] + R - 1) / R;
  float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float fin = 0.0f, n_contrib = 0.0f;
  for (int k = 0; k < nr; ++k) {
    const float* p = part + (long long)(range_off[b] + k) * NPART * NRAY + r;
#pragma unroll
    for (int i = 0; i < 7; ++i) acc[i] = acc[i] + p[i * NRAY];
    const float f = p[7 * NRAY], n = p[8 * NRAY];
    fin = f < fin ? f : fin;
    n_contrib = n > n_contrib ? n : n_contrib;
  }
  float* o = out + ((long long)b * NRAY + r) * C_OUT;
#pragma unroll
  for (int i = 0; i < 7; ++i) o[i] = acc[i];
  o[7] = expf(fin);
  o[8] = n_contrib;
#pragma unroll
  for (int c = 11; c < C_OUT; ++c) o[c] = 0.0f;
}

template <int NSH, bool EXACT>
cudaError_t launch_composite_t(const float* payload, long long ld, const float* rays, const int* seg_start,
                             const int* seg_count, const int* rb, const int* rc0, const int* nproc,
                             const int* res, int NB, int n_ranges, int R, float tmin, float* part,
                             cudaStream_t stream) {
  constexpr int NROW = ROW_SH + 3 * NSH;
  const size_t bytes = 2 * NROW * K * sizeof(float) + (EXACT ? KEYS_SMEM * NRAY * sizeof(unsigned long long) : 0);
  cudaError_t e = cudaFuncSetAttribute(composite_kernel<NSH, EXACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  composite_kernel<NSH, EXACT><<<n_ranges, NRAY, bytes, stream>>>(payload, ld, rays, seg_start, seg_count, rb,
                                                                  rc0, nproc, res, NB, R, tmin, part);
  return cudaGetLastError();
}

template <int NSH>
cudaError_t launch_composite(const float* payload, long long ld, const float* rays, const int* seg_start,
                             const int* seg_count, const int* rb, const int* rc0, const int* nproc,
                             const int* res, int NB, int n_ranges, int R, float tmin, float* part, int exact,
                             cudaStream_t stream) {
  if (exact)
    return launch_composite_t<NSH, true>(payload, ld, rays, seg_start, seg_count, rb, rc0, nproc, res, NB,
                                       n_ranges, R, tmin, part, stream);
  return launch_composite_t<NSH, false>(payload, ld, rays, seg_start, seg_count, rb, rc0, nproc, res, NB,
                                      n_ranges, R, tmin, part, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). payload: (pay_rows(n_sh), ld)
// float32 rows, one column per pair; rays: (NB, 256, 8) float32;
// seg_start (NB+1,) / seg_count (NB,) int32; the work list of
// ops/tracer/ranges.py: range_bundle / range_chunk0 (n_ranges,), range_off
// (NB+1,) int32, ranges of at most R chunks. res (ld / 128, 5, 256) int32:
// on return, for each processed chunk, row 0 its end log T (float bits) and
// rows 1-4 each ray's 128-bit mask of the lanes that pass the hit test (the
// backward's residual); nproc (NB,) int32 and part (n_ranges, 9, 256)
// float32 are scratch. out: (NB, 256, 16) float32. With full == 0 only
// launches (a) and (b) run (the backward's recomputation of res; out then
// holds SUMLG and NPROC only).
// Returns the first failing launch's error, cudaErrorInvalidValue for an
// n_sh it was not built for.
extern "C" int trace_bundles_fwd(const float* payload, long long ld, const float* rays, const int* seg_start,
                                 const int* seg_count, const int* range_bundle, const int* range_chunk0,
                                 const int* range_off, int n_ranges, int* res, int* nproc, float* part,
                                 float* out, int NB, int n_sh, int R, float tmin, int exact_order, int full,
                                 void* stream) {
  if (NB <= 0) return (int)cudaSuccess;
  if (n_sh != 1 && n_sh != 4 && n_sh != 9 && n_sh != 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_ranges > 0) {
    totals_kernel<<<n_ranges, NRAY, 0, s>>>(payload, ld, rays, seg_start, seg_count, range_bundle, range_chunk0,
                                            NB, R, tmin, res);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  carry_kernel<<<NB, NRAY, 0, s>>>(seg_start, seg_count, res, nproc, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !full) return (int)e;
  if (n_ranges > 0) {
    switch (n_sh) {
      case 1: e = launch_composite<1>(payload, ld, rays, seg_start, seg_count, range_bundle, range_chunk0, nproc, res, NB, n_ranges, R, tmin, part, exact_order, s); break;
      case 4: e = launch_composite<4>(payload, ld, rays, seg_start, seg_count, range_bundle, range_chunk0, nproc, res, NB, n_ranges, R, tmin, part, exact_order, s); break;
      case 9: e = launch_composite<9>(payload, ld, rays, seg_start, seg_count, range_bundle, range_chunk0, nproc, res, NB, n_ranges, R, tmin, part, exact_order, s); break;
      default: e = launch_composite<16>(payload, ld, rays, seg_start, seg_count, range_bundle, range_chunk0, nproc, res, NB, n_ranges, R, tmin, part, exact_order, s); break;
    }
    if (e != cudaSuccess) return (int)e;
  }
  reduce_kernel<<<NB, NRAY, 0, s>>>(range_off, nproc, part, R, out);
  return (int)cudaGetLastError();
}
