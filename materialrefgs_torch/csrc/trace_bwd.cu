// Bundle splat tracer backward, CUDA C++ for sm_90a.
//
// Replaces materialrefgs_tpu/ops/tracer/pallas_kernels.py:trace_bundles_bwd
// (the Pallas `_bwd_kernel`). For every bundle of 256 rays it walks the chunks
// the forward processed (csrc/trace_fwd.cu) in reverse, from the segment's
// active end (seg_active: NPROC x 128 in exact order, the bundle's largest
// n_contrib in list order), and returns the gradient of every payload row of
// every walked pair (center, tu/su, tv/sv, normal, opacity, raw SH) and of
// every ray's origin and direction, for the cotangent of the forward's rgb,
// depth, normal and final_T outputs. Per (ray, pair):
//   dL/dalpha = T_i G_i - (sum over later hits of G w) / (1 - alpha_i)
//               - final_T / (1 - alpha_i) dL/dfinal_T,
// G_i = dL/dw_i = <dRGB, color> + t dDepth + flip <n, dNormal>; then the chain
// rule through rho = u^2 + v^2, u = <q, tu>, v = <q, tv>, q = o + t d - p and
// t = <p - o, n> / <d, n>, the w flip dNormal term on the normal, the depth
// term on t, and the SH rows gated by the color clamp (raw > 0); the ray
// direction also through the SH basis Jacobian (n_sh > 1). The alpha clamp
// passes its gradient, as in the JAX kernel.
//
// Design: one block of 256 threads per bundle, one thread per ray. Each chunk
// of the segment (walked in reverse) is staged in shared memory, (13 + 3 n_sh)
// rows x 128 pairs (31 KB at n_sh = 16). Two passes per chunk:
//  A. Each thread rebuilds its ray's weights in its own order, back to front,
//     carrying the suffix sums of log1p(-alpha) and of G w from the later
//     chunks. List order: the lanes in reverse, up to the ray's n_contrib,
//     T_i = exp(log final_T - inclusive suffix). Exact order: the ray's hits
//     insertion-sorted by the forward's 64-bit keys (the hit distance's bits,
//     then the lane), walked in reverse with prefix = SUMLG - suffix - lg and
//     the T-stop inclusion re-derived. w_i and dL/dalpha_i of each composited
//     hit go to a per-thread array (local memory) and a 128-bit mask.
//  B. The lanes in order, all threads together: a lane no ray composited is
//     skipped by the whole block (__syncthreads_or); otherwise each thread
//     computes its (13 + 3 n_sh) contributions, each is summed over the warp
//     with xor shuffles and over the 8 warps in a fixed order (deterministic,
//     as csrc/rasterize_bwd.cu), and the lane's column of gradient sums
//     replaces its payload column in shared memory (no later lane reads it).
//     A chunk's columns belong to this bundle alone, so the block writes them
//     to dpayload directly: no atomics. The ray's origin and direction
//     gradients stay in registers and are written once.
//
// What bounds it on the H100: per (ray, pair) of a walked chunk the hit test
// (~45 FP32 operations and one expf) runs in both passes; a hit adds its color
// (3 (2 n_sh + 1)), G (14) and the walk's log1pf/expf/division; a composited
// hit the chain rule (~90) and its SH rows (6 n_sh), and 13 + 3 n_sh warp
// reductions. The payload is read once and dpayload written once per bundle,
// (13 + 3 n_sh) x 4 bytes per pair each, shared by 256 rays: FP32 and shuffle
// work bound it, not bytes (chip_smoke.py counts the bound from the plain
// version's outcomes on the same inputs).
//
// Numerics follow the plain torch version (trace_bwd.trace_bundles_bwd_plain)
// operation for operation, built with -fmad=false; sums over a bundle's rays
// and a chunk's lanes are taken in another order than torch.sum's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NRAY = 256;  // threads per block, rays per bundle
constexpr int NWARP = NRAY / 32;
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

// The hit geometry of lane j of the staged chunk (pallas_kernels.py:_geom),
// with the forward kernel's operations in its order.
struct Geo {
  bool ok;
  float t, alpha, denom, den_s, G, u, v, qx, qy, qz, pox, poy, poz;
};

__device__ __forceinline__ Geo geometry(const float (*sh)[K], int j, float ox, float oy, float oz,
                                        float dx, float dy, float dz, float tmin) {
  const float px = sh[ROW_P][j], py = sh[ROW_P + 1][j], pz = sh[ROW_P + 2][j];
  const float nx = sh[ROW_N][j], ny = sh[ROW_N + 1][j], nz = sh[ROW_N + 2][j];
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
  g.u = g.qx * sh[ROW_TU][j] + g.qy * sh[ROW_TU + 1][j] + g.qz * sh[ROW_TU + 2][j];
  g.v = g.qx * sh[ROW_TV][j] + g.qy * sh[ROW_TV + 1][j] + g.qz * sh[ROW_TV + 2][j];
  const float rho = g.u * g.u + g.v * g.v;
  g.G = expf(-0.5f * rho);
  g.alpha = clamp_max(sh[ROW_OPA][j] * g.G, ALPHA_MAX);
  g.ok = den_ok && g.t >= tmin && rho <= RHO_CUTOFF && g.alpha >= ALPHA_MIN;
  return g;
}

// The raw (pre-clamp) color of lane j at the ray's basis, +0.5 included.
template <int NSH>
__device__ __forceinline__ float raw_color(const float (*sh)[K], int c, int j, const float* Y) {
  float raw = Y[0] * sh[ROW_SH + c * NSH][j];
#pragma unroll
  for (int k = 1; k < NSH; ++k) raw = raw + Y[k] * sh[ROW_SH + c * NSH + k][j];
  return raw + 0.5f;
}

// G_i = dL/dw_i of lane j.
template <int NSH>
__device__ __forceinline__ float dl_dw(const float (*sh)[K], int j, const Geo& g, const float* Y,
                                       const float* dRGB, float dDep, const float* dN) {
  float gw = dRGB[0] * clamp_min(raw_color<NSH>(sh, 0, j, Y), 0.0f) +
             dRGB[1] * clamp_min(raw_color<NSH>(sh, 1, j, Y), 0.0f) +
             dRGB[2] * clamp_min(raw_color<NSH>(sh, 2, j, Y), 0.0f);
  gw = gw + g.t * dDep;
  const float flip = g.denom > 0.0f ? -1.0f : 1.0f;
  gw = gw + flip * (sh[ROW_N][j] * dN[0] + sh[ROW_N + 1][j] * dN[1] + sh[ROW_N + 2][j] * dN[2]);
  return gw;
}

__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <int NSH, bool EXACT>
__global__ void __launch_bounds__(NRAY)
trace_bwd_kernel(const float* __restrict__ payload, long long ld, const float* __restrict__ rays,
                 const int* __restrict__ seg_start, const int* __restrict__ seg_count,
                 const int* __restrict__ seg_active, const float* __restrict__ fwd,
                 const float* __restrict__ cot, float* __restrict__ dpayload,
                 float* __restrict__ drays, float tmin) {
  constexpr int NROW = ROW_SH + 3 * NSH;  // payload rows read and written
  __shared__ float sh[NROW][K];
  __shared__ float part[NWARP][NROW];

  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int warp = r >> 5, lane_id = r & 31;
  const float* ray = rays + ((long long)b * NRAY + r) * 8;
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float inv = 1.0f / sqrtf(clamp_min(dx * dx + dy * dy + dz * dz, 1e-24f));
  const float xu = dx * inv, yu = dy * inv, zu = dz * inv;
  float Y[NSH];
  sh_basis<NSH>(xu, yu, zu, Y);

  const float* f = fwd + ((long long)b * NRAY + r) * C_OUT;
  const float final_T = f[7], n_contrib = f[8], total_lg = f[9];
  const float logT_fin = logf(clamp_min(final_T, 1e-30f));
  const float* g_ = cot + ((long long)b * NRAY + r) * C_OUT;
  const float dRGB[3] = {g_[0], g_[1], g_[2]};
  const float dDep = g_[3];
  const float dN[3] = {g_[4], g_[5], g_[6]};
  const float dTfin = g_[7];

  const long long start = seg_start[b];
  const int count = seg_count[b];
  const int n_chunks = (count + K - 1) / K;
  const int active_chunks = min((seg_active[b] + K - 1) / K, n_chunks);

  float carry_lg = 0.0f, carry_gw = 0.0f;
  float do_acc[3] = {0.0f, 0.0f, 0.0f}, dd_acc[3] = {0.0f, 0.0f, 0.0f};
  float w_of[K], da_of[K];  // this ray's w and dL/dalpha per composited lane
  unsigned long long keys[EXACT ? K : 1];

  for (int chunk = active_chunks - 1; chunk >= 0; --chunk) {
    // The previous chunk's gradients have been written out.
    __syncthreads();
    const long long off = start + (long long)chunk * K;
    for (int i = r; i < NROW * K; i += NRAY) {
      const int row = i / K, lane = i % K;
      sh[row][lane] = payload[(long long)row * ld + off + lane];
    }
    __syncthreads();
    const int n_lanes = min(K, count - chunk * K);
    unsigned long long mask_lo = 0ull, mask_hi = 0ull;  // composited lanes
    auto mark = [&](int j) {
      if (j < 64) mask_lo |= 1ull << j;
      else mask_hi |= 1ull << (j - 64);
    };

    // ---- A: this ray's weights and dL/dalpha, back to front.
    float s = carry_lg, sg = carry_gw;
    if constexpr (!EXACT) {
      for (int j = n_lanes - 1; j >= 0; --j) {
        if ((float)(chunk * K + j + 1) > n_contrib) continue;
        const Geo g = geometry(sh, j, ox, oy, oz, dx, dy, dz, tmin);
        if (!g.ok) continue;
        const float a = g.alpha;
        const float lg = log1pf(-a);
        const float Gw = dl_dw<NSH>(sh, j, g, Y, dRGB, dDep, dN);
        const float suf_incl = s + lg;
        const float T_i = expf(logT_fin - suf_incl);
        const float w = a * T_i;
        const float one_m = 1.0f - a;
        w_of[j] = w;
        da_of[j] = T_i * Gw - sg / one_m - (final_T / one_m) * dTfin;
        mark(j);
        s = suf_incl;
        sg = sg + Gw * w;
      }
    } else {
      int n_hits = 0;
      for (int j = 0; j < n_lanes; ++j) {
        const Geo g = geometry(sh, j, ox, oy, oz, dx, dy, dz, tmin);
        if (!g.ok) continue;
        // Lanes arrive in increasing order: a tie stays behind the earlier
        // lane (the forward's order).
        const unsigned long long key = ((unsigned long long)order_bits(g.t) << 32) | (unsigned)j;
        int i = n_hits++;
        while (i > 0 && keys[i - 1] > key) {
          keys[i] = keys[i - 1];
          --i;
        }
        keys[i] = key;
      }
      for (int i = n_hits - 1; i >= 0; --i) {
        const int j = (int)(keys[i] & 0xffffffffull);
        const Geo g = geometry(sh, j, ox, oy, oz, dx, dy, dz, tmin);
        const float a = g.alpha;
        const float lg = log1pf(-a);
        const float prefix_excl = total_lg - s - lg;
        if (prefix_excl + lg >= LOG_T_STOP) {
          const float Gw = dl_dw<NSH>(sh, j, g, Y, dRGB, dDep, dN);
          const float T_i = expf(clamp_max(prefix_excl, 0.0f));
          const float w = a * T_i;
          const float one_m = 1.0f - a;
          w_of[j] = w;
          da_of[j] = T_i * Gw - sg / one_m - (final_T / one_m) * dTfin;
          mark(j);
          sg = sg + Gw * w;
        }
        s = s + lg;
      }
    }
    carry_lg = s;
    carry_gw = sg;

    // ---- B: per lane, every ray's contributions summed into the lane's column.
    float do_c[3] = {0.0f, 0.0f, 0.0f}, dd_c[3] = {0.0f, 0.0f, 0.0f};
    float dY[NSH];
#pragma unroll
    for (int k = 0; k < NSH; ++k) dY[k] = 0.0f;
    for (int j = 0; j < K; ++j) {
      const bool mine = ((j < 64 ? mask_lo >> j : mask_hi >> (j - 64)) & 1ull) != 0ull;
      // Also the barrier after which lane j-1's partial sums may be overwritten.
      if (!__syncthreads_or(mine)) {
        if (r < NROW) sh[r][j] = 0.0f;
        continue;
      }
      if (!__any_sync(0xffffffffu, mine)) {
        for (int row = lane_id; row < NROW; row += 32) part[warp][row] = 0.0f;
      } else {
        float v[13];
        float Xc[3] = {0.0f, 0.0f, 0.0f};
        float wj = 0.0f;
        if (mine) {
          const Geo g = geometry(sh, j, ox, oy, oz, dx, dy, dz, tmin);
          const float dalpha = da_of[j];
          wj = w_of[j];
          const float nx = sh[ROW_N][j], ny = sh[ROW_N + 1][j], nz = sh[ROW_N + 2][j];
          const float tux = sh[ROW_TU][j], tuy = sh[ROW_TU + 1][j], tuz = sh[ROW_TU + 2][j];
          const float tvx = sh[ROW_TV][j], tvy = sh[ROW_TV + 1][j], tvz = sh[ROW_TV + 2][j];
          const float dG_g = sh[ROW_OPA][j] * dalpha;
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
          v[0] = -dqx + dt * nx * inv_den;
          v[1] = -dqy + dt * ny * inv_den;
          v[2] = -dqz + dt * nz * inv_den;
          v[3] = du * g.qx;
          v[4] = du * g.qy;
          v[5] = du * g.qz;
          v[6] = dv * g.qx;
          v[7] = dv * g.qy;
          v[8] = dv * g.qz;
          v[9] = dt * g.pox * inv_den + dden * dx + wf * dN[0];
          v[10] = dt * g.poy * inv_den + dden * dy + wf * dN[1];
          v[11] = dt * g.poz * inv_den + dden * dz + wf * dN[2];
          v[12] = dopa;
          do_c[0] = do_c[0] + (dqx - dt * nx * inv_den);
          do_c[1] = do_c[1] + (dqy - dt * ny * inv_den);
          do_c[2] = do_c[2] + (dqz - dt * nz * inv_den);
          dd_c[0] = dd_c[0] + (g.t * dqx + dden * nx);
          dd_c[1] = dd_c[1] + (g.t * dqy + dden * ny);
          dd_c[2] = dd_c[2] + (g.t * dqz + dden * nz);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            Xc[c] = raw_color<NSH>(sh, c, j, Y) > 0.0f ? dRGB[c] * wj : 0.0f;
#pragma unroll
            for (int k = 0; k < NSH; ++k) dY[k] = dY[k] + Xc[c] * sh[ROW_SH + c * NSH + k][j];
          }
        } else {
#pragma unroll
          for (int i = 0; i < 13; ++i) v[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 13; ++i) {
          const float sum = warp_sum(v[i]);
          if (lane_id == 0) part[warp][i] = sum;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int k = 0; k < NSH; ++k) {
            const float sum = warp_sum(Y[k] * Xc[c]);
            if (lane_id == 0) part[warp][ROW_SH + c * NSH + k] = sum;
          }
        }
      }
      __syncthreads();
      if (r < NROW) {
        float sum = part[0][r];
#pragma unroll
        for (int w8 = 1; w8 < NWARP; ++w8) sum = sum + part[w8][r];
        sh[r][j] = sum;  // no later lane reads column j of the payload
      }
    }

    // The ray direction's gradient through the SH basis, once per chunk.
    if constexpr (NSH > 1) {
      float gx, gy, gz;
      sh_grad_dot<NSH>(xu, yu, zu, dY, gx, gy, gz);
      const float proj = xu * gx + yu * gy + zu * gz;
      dd_c[0] = dd_c[0] + inv * (gx - xu * proj);
      dd_c[1] = dd_c[1] + inv * (gy - yu * proj);
      dd_c[2] = dd_c[2] + inv * (gz - zu * proj);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      do_acc[i] = do_acc[i] + do_c[i];
      dd_acc[i] = dd_acc[i] + dd_c[i];
    }

    __syncthreads();
    for (int i = r; i < NROW * K; i += NRAY) {
      const int row = i / K, lane = i % K;
      dpayload[(long long)row * ld + off + lane] = sh[row][lane];
    }
  }

  float* out = drays + ((long long)b * NRAY + r) * 8;
  out[0] = do_acc[0];
  out[1] = do_acc[1];
  out[2] = do_acc[2];
  out[3] = dd_acc[0];
  out[4] = dd_acc[1];
  out[5] = dd_acc[2];
  out[6] = 0.0f;
  out[7] = 0.0f;
}

template <int NSH>
cudaError_t launch(const float* payload, long long ld, const float* rays, const int* seg_start,
                   const int* seg_count, const int* seg_active, const float* fwd, const float* cot,
                   float* dpayload, float* drays, int NB, float tmin, int exact, cudaStream_t stream) {
  if (exact)
    trace_bwd_kernel<NSH, true><<<NB, NRAY, 0, stream>>>(payload, ld, rays, seg_start, seg_count,
                                                         seg_active, fwd, cot, dpayload, drays, tmin);
  else
    trace_bwd_kernel<NSH, false><<<NB, NRAY, 0, stream>>>(payload, ld, rays, seg_start, seg_count,
                                                          seg_active, fwd, cot, dpayload, drays, tmin);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). payload: (pay_rows(n_sh), ld)
// float32 rows, one column per pair; rays: (NB, 256, 8); seg_start (NB+1,),
// seg_count / seg_active (NB,) int32; fwd / cot: (NB, 256, 16) float32;
// dpayload: the payload's shape, zeroed by the caller (only walked chunks
// are written); drays: (NB, 256, 8). Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an n_sh it was not built for).
extern "C" int trace_bundles_bwd(const float* payload, long long ld, const float* rays,
                                 const int* seg_start, const int* seg_count, const int* seg_active,
                                 const float* fwd, const float* cot, float* dpayload, float* drays,
                                 int NB, int n_sh, float tmin, int exact_order, void* stream) {
  if (NB <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_sh) {
    case 1: return (int)launch<1>(payload, ld, rays, seg_start, seg_count, seg_active, fwd, cot, dpayload, drays, NB, tmin, exact_order, s);
    case 4: return (int)launch<4>(payload, ld, rays, seg_start, seg_count, seg_active, fwd, cot, dpayload, drays, NB, tmin, exact_order, s);
    case 9: return (int)launch<9>(payload, ld, rays, seg_start, seg_count, seg_active, fwd, cot, dpayload, drays, NB, tmin, exact_order, s);
    case 16: return (int)launch<16>(payload, ld, rays, seg_start, seg_count, seg_active, fwd, cot, dpayload, drays, NB, tmin, exact_order, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
