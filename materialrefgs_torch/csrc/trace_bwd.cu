// Bundle splat tracer backward, CUDA C++ for sm_90a.
//
// Replaces materialrefgs_tpu/ops/tracer/pallas_kernels.py:trace_bundles_bwd
// (the Pallas `_bwd_kernel`). It walks the chunks the forward processed
// (csrc/trace_fwd.cu) in reverse, up to each segment's active end
// (seg_active: NPROC x 128 in exact order, the bundle's largest n_contrib in
// list order), and returns the gradient of every payload row of every walked
// pair (center, tu/su, tv/sv, normal, opacity, raw SH) and of every ray's
// origin and direction, for the cotangent of the forward's rgb, depth,
// normal and final_T outputs. Per (ray, pair):
//   dL/dalpha = T_i G_i - (sum over later hits of G w) / (1 - alpha_i)
//               - final_T / (1 - alpha_i) dL/dfinal_T,
// G_i = dL/dw_i = <dRGB, color> + t dDepth + flip <n, dNormal>; then the chain
// rule through rho = u^2 + v^2, u = <q, tu>, v = <q, tv>, q = o + t d - p and
// t = <p - o, n> / <d, n>, the w flip dNormal term on the normal, the depth
// term on t, and the SH rows gated by the color clamp (raw > 0); the ray
// direction also through the SH basis Jacobian (n_sh > 1). The alpha clamp
// passes its gradient, as in the JAX kernel.
//
// Design: the walk is cut into the forward's ranges of at most R chunks
// (ops/tracer/ranges.py; R = 8 on the main path), one block of 256 threads
// (one per ray) per range.
// The forward's residual gives each chunk's end log T (Lend) and each ray's
// hit mask: the backward visits the hits alone (a chunk, or a half chunk, no
// ray of the block hits is skipped; its dpayload columns stay zero), and
// within a chunk walked back to front prefix_i = Lend - suffix - lg_i (the JAX
// formula prefix = SUMLG - suffix - lg with the later chunks' totals folded
// into Lend), in each ray's order: its lanes in reverse (list order; a hit
// carries a gradient up to the ray's n_contrib), or its hits by the
// forward's 64-bit (t bits, lane) keys, insertion-sorted per thread in
// shared memory (a local-memory list past KEYS_SMEM hits), with the T-stop
// inclusion re-derived (exact order). Three launches:
//  (b') every range but a bundle's first computes its own sum of G w over
//       its included hits (the walk alone);
//  (c') every range in parallel starts from carry_gw, the sum of the later
//       ranges' (b') sums taken from the last range back, and walks its
//       chunks in reverse. Per chunk, for each half of 64 lanes: pass A, the
//       ray's walk, writes w and dL/dalpha of its included hits in the half
//       to shared memory ([ray][lane], rows padded to 65 floats: no bank
//       conflicts either way) and adds the ray's own origin, direction and
//       SH-basis terms in registers; pass B, transposed: thread (lane, ray
//       quarter) loops over its 64 rays in order and, for each included
//       (ray, lane), recomputes the hit geometry from the staged rays and
//       payload and adds the 13 geometry rows and, per color channel, the
//       3 n_sh SH rows Y_k [raw_c > 0] dRGB_c w (a register-tiled FP32
//       product over the rays, skipping the rays that did not composite the
//       lane); the four quarters' sums are added in order and the block
//       writes the lane's column of dpayload. A range's chunks belong to it
//       alone: no atomics, no cross-block order. The ray gradients are
//       per-(range, ray) partials;
//  (d') one block per bundle adds its ranges' ray partials in range order.
// When the forward's residual is not given, launches (a) and (b) of
// csrc/trace_fwd.cu recompute it first (ops/tracer/trace_bwd.py).
//
// What bounds it on the H100: per hit its geometry (~45 FP32 operations and
// one expf), color 3 (2 n_sh + 1), G (14) and the walk's log1pf/expf/
// division; a composited hit the chain rule (~90), its SH rows (6 n_sh) and
// one add into each of the 13 + 3 n_sh row sums. The walk runs in (b'), in
// (c') once per half in exact order (the sorted walk spans both halves), and
// pass B recomputes a composited hit's geometry; the forward's launch (a)
// ran the hit test of every (ray, pair), which the bound counts here too. The payload is read once and dpayload written once per range,
// (13 + 3 n_sh) x 4 bytes per pair each, shared by 256 rays: FP32 work bounds
// it, not bytes (chip_smoke.py counts the bound from the plain version's
// outcomes on the same inputs). Shared memory (227 KB at n_sh = 16: the
// staged chunk, the two 64-lane buffers, the staged rays, the sort keys)
// holds (c') to one block per SM; ptxas gives it ~245 registers at n_sh = 16
// (no spills) and (b') 64.
//
// Numerics follow the plain torch version (trace_bwd.trace_bundles_bwd_plain,
// which walks the same ranges) operation for operation in the walk, built
// with -fmad=false; sums over a bundle's rays and a chunk's lanes are taken
// in another order than torch.sum's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NRAY = 256;  // threads per block, rays per bundle
constexpr int K = 128;     // pairs per chunk
constexpr int C_OUT = 16;

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
constexpr double D2_0 = 1.0925484305920792, D2_1 = -1.0925484305920792, D2_2 = 0.31539156525252005,
                 D2_3 = -1.0925484305920792, D2_4 = 0.5462742152960396;
constexpr double D3_0 = -0.5900435899266435, D3_1 = 2.890611442640554, D3_2 = -0.4570457994644658,
                 D3_3 = 0.3731763325901154, D3_4 = -0.4570457994644658, D3_5 = 1.445305721320277,
                 D3_6 = -0.5900435899266435;

__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

// utils/sh.py:sh_basis, expression for expression.
template <int NSH>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* Y) {
  Y[0] = C0;
  if constexpr (NSH >= 4) {
    Y[1] = -C1 * y;
    Y[2] = C1 * z;
    Y[3] = -C1 * x;
  }
  if constexpr (NSH >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    Y[4] = (float)D2_0 * x * y;
    Y[5] = (float)D2_1 * y * z;
    Y[6] = (float)D2_2 * (2.0f * zz - xx - yy);
    Y[7] = (float)D2_3 * x * z;
    Y[8] = (float)D2_4 * (xx - yy);
    if constexpr (NSH >= 16) {
      Y[9] = (float)D3_0 * y * (3.0f * xx - yy);
      Y[10] = (float)D3_1 * x * y * z;
      Y[11] = (float)D3_2 * y * (4.0f * zz - xx - yy);
      Y[12] = (float)D3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      Y[13] = (float)D3_4 * x * (4.0f * zz - xx - yy);
      Y[14] = (float)D3_5 * z * (xx - yy);
      Y[15] = (float)D3_6 * x * (xx - 3.0f * yy);
    }
  }
}

// du = sum_k dY[k] * d(basis_k)/d(unit dir) with utils/sh.py:sh_basis_grad's
// expressions (its constant products are rounded once, as torch rounds a
// Python scalar product).
template <int NSH>
__device__ __forceinline__ void sh_grad_dot(float x, float y, float z, const float* dY, float& gx,
                                            float& gy, float& gz) {
  gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if constexpr (NSH >= 4) {
    gy = gy + dY[1] * -C1;
    gz = gz + dY[2] * C1;
    gx = gx + dY[3] * -C1;
  }
  if constexpr (NSH >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gx = gx + dY[4] * ((float)D2_0 * y);
    gy = gy + dY[4] * ((float)D2_0 * x);
    gy = gy + dY[5] * ((float)D2_1 * z);
    gz = gz + dY[5] * ((float)D2_1 * y);
    gx = gx + dY[6] * ((float)(-2.0 * D2_2) * x);
    gy = gy + dY[6] * ((float)(-2.0 * D2_2) * y);
    gz = gz + dY[6] * ((float)(4.0 * D2_2) * z);
    gx = gx + dY[7] * ((float)D2_3 * z);
    gz = gz + dY[7] * ((float)D2_3 * x);
    gx = gx + dY[8] * ((float)(2.0 * D2_4) * x);
    gy = gy + dY[8] * ((float)(-2.0 * D2_4) * y);
    if constexpr (NSH >= 16) {
      gx = gx + dY[9] * ((float)(6.0 * D3_0) * x * y);
      gy = gy + dY[9] * ((float)D3_0 * (3.0f * xx - 3.0f * yy));
      gx = gx + dY[10] * ((float)D3_1 * y * z);
      gy = gy + dY[10] * ((float)D3_1 * x * z);
      gz = gz + dY[10] * ((float)D3_1 * x * y);
      gx = gx + dY[11] * ((float)(-2.0 * D3_2) * x * y);
      gy = gy + dY[11] * ((float)D3_2 * (4.0f * zz - xx - 3.0f * yy));
      gz = gz + dY[11] * ((float)(8.0 * D3_2) * y * z);
      gx = gx + dY[12] * ((float)(-6.0 * D3_3) * x * z);
      gy = gy + dY[12] * ((float)(-6.0 * D3_3) * y * z);
      gz = gz + dY[12] * ((float)D3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy));
      gx = gx + dY[13] * ((float)D3_4 * (4.0f * zz - 3.0f * xx - yy));
      gy = gy + dY[13] * ((float)(-2.0 * D3_4) * x * y);
      gz = gz + dY[13] * ((float)(8.0 * D3_4) * x * z);
      gx = gx + dY[14] * ((float)(2.0 * D3_5) * x * z);
      gy = gy + dY[14] * ((float)(-2.0 * D3_5) * y * z);
      gz = gz + dY[14] * ((float)D3_5 * (xx - yy));
      gx = gx + dY[15] * ((float)D3_6 * (3.0f * xx - 3.0f * yy));
      gy = gy + dY[15] * ((float)(-6.0 * D3_6) * x * y);
    }
  }
}

constexpr int KEYS_SMEM = 16;  // exact-order sort keys per ray kept in shared memory
constexpr int HALF = 64;       // lanes per pass-A/pass-B half chunk
constexpr int WPAD = HALF + 1; // padded row of the [ray][lane] buffers
constexpr int NDR = 6;         // per-(range, ray) ray partials: origin 3, direction 3

// The hit geometry of lane j of the staged chunk s (row-major, K floats a
// row; pallas_kernels.py:_geom), with the forward kernel's operations in its
// order.
struct Geo {
  bool ok;
  float t, alpha, denom, den_s, G, u, v, qx, qy, qz, pox, poy, poz;
};

__device__ __forceinline__ Geo geometry(const float* s, int j, float ox, float oy, float oz, float dx,
                                        float dy, float dz, float tmin) {
  const float px = s[ROW_P * K + j], py = s[(ROW_P + 1) * K + j], pz = s[(ROW_P + 2) * K + j];
  const float nx = s[ROW_N * K + j], ny = s[(ROW_N + 1) * K + j], nz = s[(ROW_N + 2) * K + j];
  Geo g;
  g.denom = dx * nx + dy * ny + dz * nz;
  const bool den_ok = fabsf(g.denom) > 1e-9f;
  g.den_s = den_ok ? g.denom : 1.0f;
  g.pox = px - ox;
  g.poy = py - oy;
  g.poz = pz - oz;
  g.t = (g.pox * nx + g.poy * ny + g.poz * nz) / g.den_s;
  g.qx = ox + g.t * dx - px;
  g.qy = oy + g.t * dy - py;
  g.qz = oz + g.t * dz - pz;
  g.u = g.qx * s[ROW_TU * K + j] + g.qy * s[(ROW_TU + 1) * K + j] + g.qz * s[(ROW_TU + 2) * K + j];
  g.v = g.qx * s[ROW_TV * K + j] + g.qy * s[(ROW_TV + 1) * K + j] + g.qz * s[(ROW_TV + 2) * K + j];
  const float rho = g.u * g.u + g.v * g.v;
  g.G = expf(-0.5f * rho);
  g.alpha = clamp_max(s[ROW_OPA * K + j] * g.G, ALPHA_MAX);
  g.ok = den_ok && g.t >= tmin && rho <= RHO_CUTOFF && g.alpha >= ALPHA_MIN;
  return g;
}

// The raw (pre-clamp) color of lane j at basis Y (stride ys), +0.5 included.
template <int NSH>
__device__ __forceinline__ float raw_color(const float* s, int c, int j, const float* Y, int ys) {
  float raw = Y[0] * s[(ROW_SH + c * NSH) * K + j];
#pragma unroll
  for (int k = 1; k < NSH; ++k) raw = raw + Y[k * ys] * s[(ROW_SH + c * NSH + k) * K + j];
  return raw + 0.5f;
}

__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
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
  // Lanes arrive in increasing order: a tie stays behind the earlier lane.
  int i = n_hits++;
  while (i > 0 && kl[i - 1] > key) {
    kl[i] = kl[i - 1];
    --i;
  }
  kl[i] = key;
}

// One ray's forward outputs and cotangent.
struct RayCot {
  float ox, oy, oz, dx, dy, dz, inv, xu, yu, zu;
  float final_T, n_contrib, dTfin, dDep;
  float dRGB[3], dN[3];
};

__device__ __forceinline__ RayCot load_ray(const float* __restrict__ rays, const float* __restrict__ fwd,
                                           const float* __restrict__ cot, int b, int r) {
  RayCot q;
  const long long i = (long long)b * NRAY + r;
  const float* ray = rays + i * 8;
  q.ox = ray[0], q.oy = ray[1], q.oz = ray[2];
  q.dx = ray[3], q.dy = ray[4], q.dz = ray[5];
  q.inv = 1.0f / sqrtf(clamp_min(q.dx * q.dx + q.dy * q.dy + q.dz * q.dz, 1e-24f));
  q.xu = q.dx * q.inv, q.yu = q.dy * q.inv, q.zu = q.dz * q.inv;
  const float* f = fwd + i * C_OUT;
  q.final_T = f[7], q.n_contrib = f[8];
  const float* g = cot + i * C_OUT;
  q.dRGB[0] = g[0], q.dRGB[1] = g[1], q.dRGB[2] = g[2];
  q.dDep = g[3];
  q.dN[0] = g[4], q.dN[1] = g[5], q.dN[2] = g[6];
  q.dTfin = g[7];
  return q;
}

// The bundle's walk bound in chunks: seg_active, the segment, NPROC.
__device__ __forceinline__ int active_chunks(const int* __restrict__ seg_count, const int* __restrict__ seg_active,
                                             const float* __restrict__ fwd, int b) {
  const int n_chunks = (seg_count[b] + K - 1) / K;
  const int nproc = (int)fwd[(long long)b * NRAY * C_OUT + 10];
  return min(min((seg_active[b] + K - 1) / K, n_chunks), nproc);
}

template <int NROW>
__device__ __forceinline__ void stage_chunk(float* s, const float* __restrict__ payload, long long ld,
                                            long long off) {
  for (int i = threadIdx.x; i < NROW * K; i += NRAY) {
    const int row = i / K, lane = i % K;
    s[row * K + lane] = payload[(long long)row * ld + off + lane];
  }
}

constexpr int NRES = 5;  // residual rows per chunk: end log T (float bits), 4 hit-mask words

// Index of residual row `row` of global chunk g for ray r.
__device__ __forceinline__ long long res_at(long long g, int row, int r) { return (g * NRES + row) * NRAY + r; }

// One included hit of the ray's walk (back to front) at lane j: its w and
// dL/dalpha; s_lg is the suffix of log1p(-alpha) inside the chunk, sg the
// suffix of G w over later included hits. visit(j, g, raw, w, dalpha) runs
// for every included hit.
template <int NSH, bool EXACT, class Visit>
__device__ __forceinline__ void walk_hit(const float* s, int c, int j, const RayCot& q, const float* Y, float Lend,
                                         float tmin, float& s_lg, float& sg, Visit& visit) {
  const Geo g = geometry(s, j, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, tmin);
  const float a = g.alpha;
  const float lg = log1pf(-a);
  const float prefix_excl = Lend - s_lg - lg;
  const bool inc = EXACT ? prefix_excl + lg >= LOG_T_STOP : (float)(c * K + j + 1) <= q.n_contrib;
  if (inc) {
    float raw[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) raw[ch] = raw_color<NSH>(s, ch, j, Y, 1);
    float Gw = q.dRGB[0] * clamp_min(raw[0], 0.0f) + q.dRGB[1] * clamp_min(raw[1], 0.0f) +
               q.dRGB[2] * clamp_min(raw[2], 0.0f);
    Gw = Gw + g.t * q.dDep;
    const float flip = g.denom > 0.0f ? -1.0f : 1.0f;
    Gw = Gw + flip * (s[ROW_N * K + j] * q.dN[0] + s[(ROW_N + 1) * K + j] * q.dN[1] +
                      s[(ROW_N + 2) * K + j] * q.dN[2]);
    const float T_i = expf(clamp_max(prefix_excl, 0.0f));
    const float w = a * T_i;
    const float one_m = 1.0f - a;
    const float dalpha = T_i * Gw - sg / one_m - (q.final_T / one_m) * q.dTfin;
    visit(j, g, raw, w, dalpha);
    sg = sg + Gw * w;
  }
  s_lg = s_lg + lg;
}

// List order: the ray's hits among lanes [base, base + 64) (mask words lo,
// hi) in reverse lane order.
template <int NSH, class Visit>
__device__ __forceinline__ void walk_lanes(const float* s, int c, unsigned lo, unsigned hi, int base,
                                           const RayCot& q, const float* Y, float Lend, float tmin, float& s_lg,
                                           float& sg, Visit& visit) {
  for (unsigned bits = hi; bits;) {
    const int bit = 31 - __clz(bits);
    bits &= ~(1u << bit);
    walk_hit<NSH, false>(s, c, base + 32 + bit, q, Y, Lend, tmin, s_lg, sg, visit);
  }
  for (unsigned bits = lo; bits;) {
    const int bit = 31 - __clz(bits);
    bits &= ~(1u << bit);
    walk_hit<NSH, false>(s, c, base + bit, q, Y, Lend, tmin, s_lg, sg, visit);
  }
}

// Exact order: the ray's sorted hits, back to front.
template <int NSH, class Visit>
__device__ __forceinline__ void walk_sorted(const float* s, int c, KeyList& kl, int n_hits, const RayCot& q,
                                            const float* Y, float Lend, float tmin, float& s_lg, float& sg,
                                            Visit& visit) {
  for (int i = n_hits - 1; i >= 0; --i)
    walk_hit<NSH, true>(s, c, (int)(kl[i] & 0xffffffffull), q, Y, Lend, tmin, s_lg, sg, visit);
}

// Exact order: the ray's hits of the staged chunk (the forward's hit masks),
// insertion-sorted by the forward's keys.
__device__ __forceinline__ int sort_hits(const float* s, const unsigned* m, const RayCot& q, float tmin,
                                         KeyList& kl, unsigned long long* spill) {
  int n_hits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (unsigned bits = m[i]; bits; bits &= bits - 1u) {
      const int j = i * 32 + __ffs(bits) - 1;
      const Geo g = geometry(s, j, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, tmin);
      insert_key(kl, spill, n_hits, ((unsigned long long)order_bits(g.t) << 32) | (unsigned)j);
    }
  }
  return n_hits;
}

// The ray's hit masks of global chunk g; true when a ray of the block has a hit.
__device__ __forceinline__ bool load_masks(const int* __restrict__ res, long long g, int r, unsigned* m) {
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = (unsigned)res[res_at(g, 1 + i, r)];
  return __syncthreads_or((m[0] | m[1] | m[2] | m[3]) != 0u);
}

struct RangeWork {
  int b, k, c0, c1, count;  // bundle, range index in it, walked chunks [c0, c1)
  long long start;          // the segment's first column
};

__device__ __forceinline__ bool range_of(const int* __restrict__ rb, const int* __restrict__ rc0,
                                         const int* __restrict__ range_off, const int* __restrict__ seg_start,
                                         const int* __restrict__ seg_count, const int* __restrict__ seg_active,
                                         const float* __restrict__ fwd, int NB, int R, RangeWork& w) {
  w.b = rb[blockIdx.x];
  if (w.b >= NB) return false;
  w.k = blockIdx.x - range_off[w.b];
  w.count = seg_count[w.b];
  w.c0 = rc0[blockIdx.x];
  w.c1 = min(w.c0 + R, active_chunks(seg_count, seg_active, fwd, w.b));
  w.start = seg_start[w.b];
  return w.c0 < w.c1;
}

// ---- (b') each range's own sum of G w (a bundle's first range needs none).
template <int NSH, bool EXACT>
__global__ void __launch_bounds__(NRAY)
gw_kernel(const float* __restrict__ payload, long long ld, const float* __restrict__ rays,
          const int* __restrict__ seg_start, const int* __restrict__ seg_count, const int* __restrict__ seg_active,
          const int* __restrict__ rb, const int* __restrict__ rc0, const int* __restrict__ range_off,
          const float* __restrict__ fwd, const float* __restrict__ cot, const int* __restrict__ res, int NB,
          int R, float tmin, float* __restrict__ gwsum) {
  constexpr int NROW = ROW_SH + 3 * NSH;
  extern __shared__ __align__(16) float smem[];
  float* s = smem;
  unsigned long long* keys_smem = reinterpret_cast<unsigned long long*>(smem + NROW * K);
  RangeWork w;
  if (!range_of(rb, rc0, range_off, seg_start, seg_count, seg_active, fwd, NB, R, w) || w.k == 0) return;
  const int r = threadIdx.x;
  const RayCot q = load_ray(rays, fwd, cot, w.b, r);
  float Y[NSH];
  sh_basis<NSH>(q.xu, q.yu, q.zu, Y);
  unsigned long long spill[EXACT ? K : 1];
  auto none = [](int, const Geo&, const float*, float, float) {};
  float sg = 0.0f;
  for (int c = w.c1 - 1; c >= w.c0; --c) {
    const long long g = w.start / K + c;
    unsigned m[4];
    // Also the barrier after which the previous chunk is no longer read.
    if (!load_masks(res, g, r, m)) continue;  // no ray hits a pair of this chunk
    stage_chunk<NROW>(s, payload, ld, w.start + (long long)c * K);
    __syncthreads();
    const float Lend = __int_as_float(res[res_at(g, 0, r)]);
    float s_lg = 0.0f;
    if (EXACT) {
      KeyList kl{keys_smem + r, NRAY};
      const int n_hits = sort_hits(s, m, q, tmin, kl, spill);
      walk_sorted<NSH>(s, c, kl, n_hits, q, Y, Lend, tmin, s_lg, sg, none);
    } else {
      walk_lanes<NSH>(s, c, m[2], m[3], 64, q, Y, Lend, tmin, s_lg, sg, none);
      walk_lanes<NSH>(s, c, m[0], m[1], 0, q, Y, Lend, tmin, s_lg, sg, none);
    }
  }
  gwsum[(long long)blockIdx.x * NRAY + r] = sg;
}

// ---- (c') the range's gradients.
template <int NSH, bool EXACT>
__global__ void __launch_bounds__(NRAY, 1)
grad_kernel(const float* __restrict__ payload, long long ld, const float* __restrict__ rays,
            const int* __restrict__ seg_start, const int* __restrict__ seg_count, const int* __restrict__ seg_active,
            const int* __restrict__ rb, const int* __restrict__ rc0, const int* __restrict__ range_off,
            const float* __restrict__ fwd, const float* __restrict__ cot, const int* __restrict__ res,
            const float* __restrict__ gwsum, int NB, int R, float tmin, float* __restrict__ dpayload,
            float* __restrict__ part) {
  constexpr int NROW = ROW_SH + 3 * NSH;
  constexpr int NRS = 13 + NSH;  // staged ray fields: o 3, d 3, dDep, dN 3, dRGB 3, Y
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                    // (NROW, K) the staged chunk
  float* wbuf = s + NROW * K;         // (NRAY, WPAD) w of the half's lanes, zero where none
  float* dabuf = wbuf + NRAY * WPAD;  // (NRAY, WPAD) dL/dalpha; pass B's quarter sums
  float* rs = dabuf + NRAY * WPAD;    // (NRS, NRAY) the rays
  unsigned long long* keys_smem = reinterpret_cast<unsigned long long*>(rs + NRS * NRAY);

  RangeWork w;
  if (!range_of(rb, rc0, range_off, seg_start, seg_count, seg_active, fwd, NB, R, w)) return;
  const int r = threadIdx.x;
  const RayCot q = load_ray(rays, fwd, cot, w.b, r);
  float Y[NSH];
  sh_basis<NSH>(q.xu, q.yu, q.zu, Y);
  {
    float f[13] = {q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, q.dDep, q.dN[0], q.dN[1], q.dN[2],
                   q.dRGB[0], q.dRGB[1], q.dRGB[2]};
#pragma unroll
    for (int i = 0; i < 13; ++i) rs[i * NRAY + r] = f[i];
#pragma unroll
    for (int k = 0; k < NSH; ++k) rs[(13 + k) * NRAY + r] = Y[k];
    for (int i = r; i < NRAY * WPAD; i += NRAY) wbuf[i] = 0.0f;
  }
  // carry_gw: the later ranges' sums, from the last range back.
  float sg = 0.0f;
  {
    const int nra = (active_chunks(seg_count, seg_active, fwd, w.b) + R - 1) / R;
    const long long first = range_off[w.b];
    for (int k = nra - 1; k > w.k; --k) sg = sg + gwsum[(first + k) * NRAY + r];
  }
  unsigned long long spill[EXACT ? K : 1];
  float do_r[3] = {0.0f, 0.0f, 0.0f}, dd_r[3] = {0.0f, 0.0f, 0.0f};
  const int jl = r & (HALF - 1), quarter = r / HALF;  // pass B's lane and ray quarter

  for (int c = w.c1 - 1; c >= w.c0; --c) {
    const long long g = w.start / K + c;
    const long long off = w.start + (long long)c * K;
    unsigned m[4];
    // Also the barrier after which the previous chunk is no longer read. A
    // chunk no ray hits has no gradient: its dpayload columns stay zero.
    if (!load_masks(res, g, r, m)) continue;
    stage_chunk<NROW>(s, payload, ld, off);
    __syncthreads();
    const float Lend = __int_as_float(res[res_at(g, 0, r)]);
    KeyList kl{keys_smem + r, NRAY};
    const int n_hits = EXACT ? sort_hits(s, m, q, tmin, kl, spill) : 0;
    const float sg_in = sg;
    float s_lg = 0.0f;
    float do_c[3] = {0.0f, 0.0f, 0.0f}, dd_c[3] = {0.0f, 0.0f, 0.0f}, dY[NSH];
#pragma unroll
    for (int k = 0; k < NSH; ++k) dY[k] = 0.0f;

#pragma unroll
    for (int half = 1; half >= 0; --half) {
      const unsigned mlo = half ? m[2] : m[0], mhi = half ? m[3] : m[1];
      // Also the barrier after which the previous half's sums are read.
      if (!__syncthreads_or((mlo | mhi) != 0u)) continue;  // no ray hits a lane of this half
      // ---- A: this ray's w and dL/dalpha on the half's lanes.
      auto visit = [&](int j, const Geo& g, const float* raw, float wt, float dalpha) {
        if (EXACT && (j / HALF) != half) return;
        wbuf[r * WPAD + (j & (HALF - 1))] = wt;
        dabuf[r * WPAD + (j & (HALF - 1))] = dalpha;
        // The ray's own terms (origin, direction, SH basis).
        const float tux = s[ROW_TU * K + j], tuy = s[(ROW_TU + 1) * K + j], tuz = s[(ROW_TU + 2) * K + j];
        const float tvx = s[ROW_TV * K + j], tvy = s[(ROW_TV + 1) * K + j], tvz = s[(ROW_TV + 2) * K + j];
        const float nx = s[ROW_N * K + j], ny = s[(ROW_N + 1) * K + j], nz = s[(ROW_N + 2) * K + j];
        const float dG_g = s[ROW_OPA * K + j] * dalpha;
        const float drho = -0.5f * g.G * dG_g;
        const float du = 2.0f * g.u * drho;
        const float dv = 2.0f * g.v * drho;
        const float dqx = du * tux + dv * tvx;
        const float dqy = du * tuy + dv * tvy;
        const float dqz = du * tuz + dv * tvz;
        const float dt = wt * q.dDep + dqx * q.dx + dqy * q.dy + dqz * q.dz;
        const float inv_den = 1.0f / g.den_s;
        const float dden = -g.t * inv_den * dt;
        do_c[0] = do_c[0] + (dqx - dt * nx * inv_den);
        do_c[1] = do_c[1] + (dqy - dt * ny * inv_den);
        do_c[2] = do_c[2] + (dqz - dt * nz * inv_den);
        dd_c[0] = dd_c[0] + (g.t * dqx + dden * nx);
        dd_c[1] = dd_c[1] + (g.t * dqy + dden * ny);
        dd_c[2] = dd_c[2] + (g.t * dqz + dden * nz);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float Xc = raw[ch] > 0.0f ? q.dRGB[ch] * wt : 0.0f;
#pragma unroll
          for (int k = 0; k < NSH; ++k) dY[k] = dY[k] + Xc * s[(ROW_SH + ch * NSH + k) * K + j];
        }
      };
      if (EXACT) {
        // The sorted walk spans both halves: it runs whole for each.
        s_lg = 0.0f;
        sg = sg_in;
        walk_sorted<NSH>(s, c, kl, n_hits, q, Y, Lend, tmin, s_lg, sg, visit);
      } else {
        walk_lanes<NSH>(s, c, mlo, mhi, half * HALF, q, Y, Lend, tmin, s_lg, sg, visit);
      }
      __syncthreads();

      // ---- B: thread (lane, quarter) sums its rays' rows for the lane.
      float acc[NROW];
#pragma unroll
      for (int i = 0; i < NROW; ++i) acc[i] = 0.0f;
      const int j = half * HALF + jl;
      const float nx = s[ROW_N * K + j], ny = s[(ROW_N + 1) * K + j], nz = s[(ROW_N + 2) * K + j];
      const float tux = s[ROW_TU * K + j], tuy = s[(ROW_TU + 1) * K + j], tuz = s[(ROW_TU + 2) * K + j];
      const float tvx = s[ROW_TV * K + j], tvy = s[(ROW_TV + 1) * K + j], tvz = s[(ROW_TV + 2) * K + j];
      const float opa = s[ROW_OPA * K + j];
      for (int i = 0; i < NRAY / 4; ++i) {
        const int rr = quarter * (NRAY / 4) + i;
        const float wj = wbuf[rr * WPAD + jl];
        if (wj == 0.0f) continue;  // not composited (an included hit has w > 0)
        const float dalpha = dabuf[rr * WPAD + jl];
        const float ox = rs[0 * NRAY + rr], oy = rs[1 * NRAY + rr], oz = rs[2 * NRAY + rr];
        const float dx = rs[3 * NRAY + rr], dy = rs[4 * NRAY + rr], dz = rs[5 * NRAY + rr];
        const float dDep = rs[6 * NRAY + rr];
        const Geo g = geometry(s, j, ox, oy, oz, dx, dy, dz, tmin);
        const float dG_g = opa * dalpha;
        const float dopa = g.G * dalpha;
        const float drho = -0.5f * g.G * dG_g;
        const float du = 2.0f * g.u * drho;
        const float dv = 2.0f * g.v * drho;
        const float dqx = du * tux + dv * tvx;
        const float dqy = du * tuy + dv * tvy;
        const float dqz = du * tuz + dv * tvz;
        const float dt = wj * dDep + dqx * dx + dqy * dy + dqz * dz;
        const float inv_den = 1.0f / g.den_s;
        const float dden = -g.t * inv_den * dt;
        const float wf = wj * (g.denom > 0.0f ? -1.0f : 1.0f);
        acc[0] = acc[0] + (-dqx + dt * nx * inv_den);
        acc[1] = acc[1] + (-dqy + dt * ny * inv_den);
        acc[2] = acc[2] + (-dqz + dt * nz * inv_den);
        acc[3] = acc[3] + du * g.qx;
        acc[4] = acc[4] + du * g.qy;
        acc[5] = acc[5] + du * g.qz;
        acc[6] = acc[6] + dv * g.qx;
        acc[7] = acc[7] + dv * g.qy;
        acc[8] = acc[8] + dv * g.qz;
        acc[9] = acc[9] + (dt * g.pox * inv_den + dden * dx + wf * rs[7 * NRAY + rr]);
        acc[10] = acc[10] + (dt * g.poy * inv_den + dden * dy + wf * rs[8 * NRAY + rr]);
        acc[11] = acc[11] + (dt * g.poz * inv_den + dden * dz + wf * rs[9 * NRAY + rr]);
        acc[12] = acc[12] + dopa;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float raw = raw_color<NSH>(s, ch, j, rs + 13 * NRAY + rr, NRAY);
          const float Xc = raw > 0.0f ? rs[(10 + ch) * NRAY + rr] * wj : 0.0f;
#pragma unroll
          for (int k = 0; k < NSH; ++k)
            acc[ROW_SH + ch * NSH + k] = acc[ROW_SH + ch * NSH + k] + rs[(13 + k) * NRAY + rr] * Xc;
        }
      }
      __syncthreads();  // every thread is done with wbuf / dabuf
      // The ray's entries go back to zero (every hit of the half; the
      // walk wrote only the included ones); the quarters' sums go to dabuf.
      for (unsigned bits = mlo; bits; bits &= bits - 1u) wbuf[r * WPAD + __ffs(bits) - 1] = 0.0f;
      for (unsigned bits = mhi; bits; bits &= bits - 1u) wbuf[r * WPAD + 32 + __ffs(bits) - 1] = 0.0f;
      float* qsum = dabuf;  // (4, NROW, HALF)
#pragma unroll
      for (int i = 0; i < NROW; ++i) qsum[(quarter * NROW + i) * HALF + jl] = acc[i];
      __syncthreads();
      for (int i = r; i < NROW * HALF; i += NRAY) {
        const int row = i / HALF, lane = i % HALF;
        float sum = qsum[row * HALF + lane];
#pragma unroll
        for (int qq = 1; qq < 4; ++qq) sum = sum + qsum[(qq * NROW + row) * HALF + lane];
        dpayload[(long long)row * ld + off + half * HALF + lane] = sum;
      }
    }

    // The ray direction's gradient through the SH basis, once per chunk.
    if constexpr (NSH > 1) {
      float gx, gy, gz;
      sh_grad_dot<NSH>(q.xu, q.yu, q.zu, dY, gx, gy, gz);
      const float proj = q.xu * gx + q.yu * gy + q.zu * gz;
      dd_c[0] = dd_c[0] + q.inv * (gx - q.xu * proj);
      dd_c[1] = dd_c[1] + q.inv * (gy - q.yu * proj);
      dd_c[2] = dd_c[2] + q.inv * (gz - q.zu * proj);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      do_r[i] = do_r[i] + do_c[i];
      dd_r[i] = dd_r[i] + dd_c[i];
    }
  }

  float* o = part + (long long)blockIdx.x * NDR * NRAY + r;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i * NRAY] = do_r[i];
    o[(3 + i) * NRAY] = dd_r[i];
  }
}

// ---- (d') the bundle's ray partials, summed in range order.
__global__ void __launch_bounds__(NRAY)
ray_reduce_kernel(const int* __restrict__ seg_count, const int* __restrict__ seg_active,
                  const int* __restrict__ range_off, const float* __restrict__ fwd, const float* __restrict__ part,
                  int R, float* __restrict__ drays) {
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int nra = (active_chunks(seg_count, seg_active, fwd, b) + R - 1) / R;
  float acc[NDR] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < nra; ++k) {
    const float* p = part + (long long)(range_off[b] + k) * NDR * NRAY + r;
#pragma unroll
    for (int i = 0; i < NDR; ++i) acc[i] = acc[i] + p[i * NRAY];
  }
  float* o = drays + ((long long)b * NRAY + r) * 8;
#pragma unroll
  for (int i = 0; i < NDR; ++i) o[i] = acc[i];
  o[6] = 0.0f;
  o[7] = 0.0f;
}

template <int NSH, bool EXACT>
cudaError_t launch_t(const float* payload, long long ld, const float* rays, const int* seg_start,
                     const int* seg_count, const int* seg_active, const int* rb, const int* rc0,
                     const int* range_off, int n_ranges, const float* fwd, const float* cot, const int* res,
                     float* gwsum, float* part, float* dpayload, int NB, int R, float tmin, cudaStream_t stream) {
  constexpr int NROW = ROW_SH + 3 * NSH;
  const size_t keys = EXACT ? KEYS_SMEM * NRAY * sizeof(unsigned long long) : 0;
  const size_t gw_bytes = NROW * K * sizeof(float) + keys;
  const size_t grad_bytes = (NROW * K + 2 * NRAY * WPAD + (13 + NSH) * NRAY) * sizeof(float) + keys;
  cudaError_t e = cudaFuncSetAttribute(gw_kernel<NSH, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)gw_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(grad_kernel<NSH, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)grad_bytes);
  if (e != cudaSuccess) return e;
  gw_kernel<NSH, EXACT><<<n_ranges, NRAY, gw_bytes, stream>>>(payload, ld, rays, seg_start, seg_count, seg_active,
                                                              rb, rc0, range_off, fwd, cot, res, NB, R, tmin,
                                                              gwsum);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  grad_kernel<NSH, EXACT><<<n_ranges, NRAY, grad_bytes, stream>>>(payload, ld, rays, seg_start, seg_count,
                                                                  seg_active, rb, rc0, range_off, fwd, cot, res,
                                                                  gwsum, NB, R, tmin, dpayload, part);
  return cudaGetLastError();
}

template <int NSH>
cudaError_t launch(const float* payload, long long ld, const float* rays, const int* seg_start,
                   const int* seg_count, const int* seg_active, const int* rb, const int* rc0,
                   const int* range_off, int n_ranges, const float* fwd, const float* cot, const int* res,
                   float* gwsum, float* part, float* dpayload, int NB, int R, float tmin, int exact,
                   cudaStream_t stream) {
  if (exact)
    return launch_t<NSH, true>(payload, ld, rays, seg_start, seg_count, seg_active, rb, rc0, range_off, n_ranges,
                               fwd, cot, res, gwsum, part, dpayload, NB, R, tmin, stream);
  return launch_t<NSH, false>(payload, ld, rays, seg_start, seg_count, seg_active, rb, rc0, range_off, n_ranges,
                              fwd, cot, res, gwsum, part, dpayload, NB, R, tmin, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). payload: (pay_rows(n_sh), ld)
// float32 rows, one column per pair; rays: (NB, 256, 8); seg_start (NB+1,),
// seg_count / seg_active (NB,) int32; the forward's work list (range_bundle /
// range_chunk0 (n_ranges,), range_off (NB+1,) int32, ranges of at most R
// chunks); fwd / cot: (NB, 256, 16) float32; res (ld / 128, 5, 256) int32:
// the forward's residual (each processed chunk's end log T and the rays'
// hit masks, csrc/trace_fwd.cu). Scratch: gwsum
// (n_ranges, 256), part (n_ranges, 6, 256) float32. dpayload: the payload's
// shape, zeroed by the caller (only walked chunks are written); drays:
// (NB, 256, 8). Returns the first failing launch's error
// (cudaErrorInvalidValue for an n_sh it was not built for).
extern "C" int trace_bundles_bwd(const float* payload, long long ld, const float* rays, const int* seg_start,
                                 const int* seg_count, const int* seg_active, const int* range_bundle,
                                 const int* range_chunk0, const int* range_off, int n_ranges, const float* fwd,
                                 const float* cot, const int* res, float* gwsum, float* part, float* dpayload,
                                 float* drays, int NB, int n_sh, int R, float tmin, int exact_order, void* stream) {
  if (NB <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (n_ranges > 0) {
    switch (n_sh) {
      case 1: e = launch<1>(payload, ld, rays, seg_start, seg_count, seg_active, range_bundle, range_chunk0, range_off, n_ranges, fwd, cot, res, gwsum, part, dpayload, NB, R, tmin, exact_order, s); break;
      case 4: e = launch<4>(payload, ld, rays, seg_start, seg_count, seg_active, range_bundle, range_chunk0, range_off, n_ranges, fwd, cot, res, gwsum, part, dpayload, NB, R, tmin, exact_order, s); break;
      case 9: e = launch<9>(payload, ld, rays, seg_start, seg_count, seg_active, range_bundle, range_chunk0, range_off, n_ranges, fwd, cot, res, gwsum, part, dpayload, NB, R, tmin, exact_order, s); break;
      case 16: e = launch<16>(payload, ld, rays, seg_start, seg_count, seg_active, range_bundle, range_chunk0, range_off, n_ranges, fwd, cot, res, gwsum, part, dpayload, NB, R, tmin, exact_order, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return (int)e;
  }
  ray_reduce_kernel<<<NB, NRAY, 0, s>>>(seg_count, seg_active, range_off, fwd, part, R, drays);
  return (int)cudaGetLastError();
}
