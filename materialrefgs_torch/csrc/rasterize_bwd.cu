// Tile rasterizer backward for 2D Gaussian surfels, CUDA C++ for sm_90a.
//
// Replaces materialrefgs_tpu/ops/rasterize/pallas_bwd.py:rasterize_tiles_bwd
// (the Pallas `_bwd_kernel`): for each 16x16 tile, walk its depth-sorted
// (gaussian, tile) pairs back to front and produce, per pair, the gradient of
// the loss with respect to the pair's payload rows: dTu/dTv/dTw (9), dmean2d
// (2), dopacity (1) and the linearly composited channels dlin (S+6). The
// caller reduces the per-pair rows per gaussian (one index_add_ keyed by the
// pair's gaussian id), which is what the JAX package's scatter-add does.
//
// Math (the JAX kernel's, line for line): transmittance is rebuilt in log
// space from the saved final_T, T_i = exp(log T_fin - sum_{j>=i} log1p(-a_j));
// the alpha gradient is
//   dL/da_i = T_i G_i - (sum_{j>i} G_j w_j) / (1 - a_i) - T_fin/(1 - a_i) dL/dT_fin
// with G_i = dL/dw_i collecting color/feature/normal/depth/M1/M2/distortion
// terms (distortion through the saved M1/M2/final_T totals); the median-depth
// gradient lands on the pair whose 1-based position equals median_contrib;
// the alpha = min(0.99, o*G) clamp passes its gradient through (as the CUDA
// reference, backward.cu:328/425). A pair counts for a pixel only if it passes
// the forward's tests and its position is <= the pixel's n_contrib; culled
// pairs inside that range still advance the position (PARITY.md N1).
//
// Design: one block of 256 threads per tile, one thread per pixel, blocks
// mapped to tiles longest walk first (`order`, a device argsort of
// tile_active). Pair columns are staged back to front in batches of P = 32
// through a two-slot cp.async ring, from position tile_active (the tile's
// largest n_contrib) down to 1. Each thread carries two running sums over
// the pairs behind it: sum log1p(-a) and sum G*w (the JAX kernel's two
// carries). Each batch first goes through the forward's exact prefilter
// (csrc/rasterize_fwd.cu) for every (pixel, pair) of the pixel's
// contributor range, with no divisions and no branches: a bit per pair where
// alpha < 1/255 is not certain. A warp then walks, back to front, only the
// pairs one of its lanes has a bit for. A pair's gradient row is a sum over
// the tile's pixels, taken in two parts:
//   - the S+6 linear rows dlin[k] = sum_pixels w dL/dlin[k]: each thread
//     writes its w for the pair to shared memory (P x 256 per batch), and
//     after the batch the threads that own (pair, k) outputs sum w times the
//     tile's cotangent, held in shared memory once per tile, over the warps
//     that saw the pair;
//   - the 12 geometric rows (dTu, dTv, dTw, dmean2d, dopacity): a warp that
//     sees the pair sums its 32 lanes' 12 values with one reduce-scatter of
//     13 shuffles (each lane ends with one row's warp sum), or, where none of
//     its lanes takes the 3D branch, its 4 nonzero rows (dTw.z, dmean2d,
//     dopacity) with 6 shuffles; after the batch the owners of (pair, row)
//     add the warps' partials in warp order.
// A warp none of whose lanes counts the pair does nothing for it (one
// ballot); a bitmask per pair says which warps did. Every pair belongs to
// one tile and every sum has a fixed order, so no atomics on floats are
// needed and the result is deterministic.
//
// What bounds it on the H100: per (pixel, pair) inside the pixel's
// contributor range the function needs the forward hit test again (~42 FP32
// operations, one expf); only the pairs that pass it (a fraction that depends
// on the scene) need log1pf + expf and the chain rule, ~180 operations at S=9
// on the 3D branch and ~125 on the 2D one, counted with their gradient
// rows' sums. It reads the pair's (12+S+6) payload rows once per tile and
// writes the same number of gradient rows, plus 2 x C_OUT floats per pixel of
// saved output and cotangent. That is below the card's bytes-per-operation
// balance, so the kernel is bound by FP32/SFU work (chip_smoke.py prints the
// bound for its data). A one-pass design with a warp butterfly per (row,
// pair) and 8-warp partial sums of every row spent 27-35 % of its time in
// those sums on the H100, and after an opacity reset walked ~10,000
// positions per tile at ~390 issue slots per (pixel, position), most of them
// on tests that cannot pass: the prefilter, the ballot skip and the two
// reduction passes above address those; the tile order addresses the
// longest walk (15-35 % of such a launch when alone on the card).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, pixels per tile
constexpr int NWARP = PIX / 32;
constexpr int P = 32;              // pair columns per batch
constexpr int WSTRIDE = PIX + 1;   // shared row stride of w and the cotangent
constexpr int NG = 12;             // geometric gradient rows: dTu, dTv, dTw, dmean2d, dopacity
constexpr unsigned FULL = 0xffffffffu;
constexpr int MIN_BLOCKS = 3;      // blocks per SM the register budget is set for

constexpr int ROW_TU = 0;
constexpr int ROW_TV = 3;
constexpr int ROW_TW = 6;
constexpr int ROW_MEAN2D = 9;
constexpr int ROW_OPACITY = 11;
constexpr int ROW_LIN = 12;
constexpr int ROW_TWZ = ROW_TW + 2;  // rows 8..11 are the only ones the 2D branch sets

constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float NEAR_N = 0.2f;
constexpr float NDC_SCALE = (float)(100.0 / (100.0 - 0.2));  // FAR/(FAR-NEAR)
constexpr float DMD_NUM = (float)(100.0 * 0.2);              // FAR*NEAR
constexpr float DMD_DEN = (float)(100.0 - 0.2);              // FAR-NEAR
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float PZ2_MIN = 1e-30f;  // below it the prefilter defers to the exact path

// torch.minimum semantics: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return a + b;
  return a < b ? a : b;
}

// The prefilter's bound on rho for opacity o (csrc/rasterize_fwd.cu; the same
// as tiles_fwd.prefilter_bound): alpha fails wherever rho > thr_of(o). NaN for
// a NaN opacity (the test then never skips).
__device__ __forceinline__ float thr_of(float o) {
  const float tau = 2.0f * logf(255.0f * o);
  return (tau < 0.0f ? 0.0f : tau) * 1.001f + 1e-3f;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// One exchange step of a reduce-scatter: the lane keeps half of `v` (the
// upper half where `hi`), adds the partner's copy of that half, and hands
// the partner the other half.
template <int N>
__device__ __forceinline__ void halve(const float* v, float* out, bool hi, int offset) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = hi ? v[i + N] : v[i];
    const float send = hi ? v[i] : v[i + N];
    out[i] = keep + __shfl_xor_sync(FULL, send, offset);
  }
}

// Warp sums of the 12 geometric values, scattered: lane l ends with the sum
// of row (l & 16 ? 6 : 0) + (l & 8 ? 3 : 0) + ((l >> 1) & 3), when that
// last term is < 3 and l is even; *row is -1 on the other lanes.
__device__ __forceinline__ float reduce12(const float* v, int lane, int* row) {
  float a[6], b[4], c[2];
  halve<6>(v, a, lane & 16, 16);
  halve<3>(a, b, lane & 8, 8);
  b[3] = 0.0f;
  halve<2>(b, c, lane & 4, 4);
  float e;
  halve<1>(c, &e, lane & 2, 2);
  e = e + __shfl_xor_sync(FULL, e, 1);
  const int sub = (lane >> 1) & 3;
  *row = ((lane & 1) || sub == 3) ? -1 : ((lane & 16) ? 6 : 0) + ((lane & 8) ? 3 : 0) + sub;
  return e;
}

// Warp sums of rows 8..11 (dTw.z, dmean2d, dopacity): lane l ends with row
// 8 + (l & 16 ? 2 : 0) + (l & 8 ? 1 : 0); *row is -1 unless l % 8 == 0.
__device__ __forceinline__ float reduce4(const float* v, int lane, int* row) {
  float a[2];
  halve<2>(v, a, lane & 16, 16);
  float e;
  halve<1>(a, &e, lane & 8, 8);
  e = e + __shfl_xor_sync(FULL, e, 4);
  e = e + __shfl_xor_sync(FULL, e, 2);
  e = e + __shfl_xor_sync(FULL, e, 1);
  *row = (lane & 7) ? -1 : ROW_TWZ + ((lane & 16) ? 2 : 0) + ((lane & 8) ? 1 : 0);
  return e;
}

// The forward's exact prefilter (csrc/rasterize_fwd.cu) over the first m
// staged columns: bit c set where pz != 0 and alpha < 1/255 is not certain
// for this pixel. No divisions and no branches, so the tests overlap.
template <int ROW_THR>
__device__ __forceinline__ unsigned candidates(const float (*sh)[P], int m, float pix_x, float pix_y) {
  unsigned bits = 0u;
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    const float twx = sh[ROW_TW][j], twy = sh[ROW_TW + 1][j], twz = sh[ROW_TW + 2][j];
    const float kx = pix_x * twx - sh[ROW_TU][j];
    const float ky = pix_x * twy - sh[ROW_TU + 1][j];
    const float kz = pix_x * twz - sh[ROW_TU + 2][j];
    const float lx = pix_y * twx - sh[ROW_TV][j];
    const float ly = pix_y * twy - sh[ROW_TV + 1][j];
    const float lz = pix_y * twz - sh[ROW_TV + 2][j];
    const float px = ky * lz - kz * ly;
    const float py = kz * lx - kx * lz;
    const float pz = kx * ly - ky * lx;
    const float d1 = sh[ROW_MEAN2D][j] - pix_x;
    const float d2 = sh[ROW_MEAN2D + 1][j] - pix_y;
    const float rho2d = FILTER_INV_SQUARE * (d1 * d1 + d2 * d2);
    const float th = sh[ROW_THR][j];
    const float pz2 = pz * pz;
    const bool skip = (rho2d > th) & (pz2 >= PZ2_MIN) & (px * px + py * py > th * pz2);
    bits |= (unsigned)((pz != 0.0f) & !skip) << j;
  }
  return bits;
}

// Start copying columns [col0, col0 + n) of the NROW payload rows into dst
// as one cp.async group.
template <int NROW>
__device__ __forceinline__ void stage(float (*dst)[P], const float* __restrict__ payload, long long ld,
                                      long long col0, int n) {
  for (int i = threadIdx.x; i < NROW * n; i += PIX) {
    const int r = i / n, c = i - r * n;
    cp_async4(&dst[r][c], payload + (long long)r * ld + col0 + c);
  }
  cp_async_commit();
}

template <int S>
struct Smem {
  static constexpr int ACC = S + 6;
  static constexpr int NROW = ROW_LIN + ACC;
  float pay[2][NROW + 1][P];    // staged payload columns + their prefilter bounds, two ring slots
  float w[P][WSTRIDE];          // w per (pair, pixel) of the batch
  float dlin[ACC][WSTRIDE];     // the tile's cotangent of the linear channels
  float part[NWARP][NG][P];     // warp sums of the geometric rows
  unsigned warps_any[P];        // warps that count the pair
  unsigned warps_3d[P];         // ... with a lane on the 3D branch
};

template <int S>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
rasterize_bwd_kernel(const float* __restrict__ payload, long long ld,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ tile_active,
                     const int* __restrict__ order,
                     const float* __restrict__ fwd_out,
                     const float* __restrict__ cot,
                     float* __restrict__ dpair, int grid_x, int row0) {
  constexpr int ACC = S + 6;           // color(3) + features(S) + normal(3)
  constexpr int NROW = ROW_LIN + ACC;  // payload rows read = gradient rows written
  constexpr int ROW_THR = NROW;        // the prefilter bound of each staged pair
  constexpr int C_RAW = ACC + 8;       // out_layout(S)["_channels"]
  constexpr int C_OUT = (C_RAW + 7) / 8 * 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<S>& sm = *reinterpret_cast<Smem<S>*>(smem_raw);

  const int t = order[blockIdx.x];
  const int active = min(tile_active[t], tile_count[t]);
  if (active <= 0) return;  // the whole block: nothing to walk
  const int pid = threadIdx.x;
  const int lane = pid & 31;
  const int warp = pid >> 5;
  const float pix_x = (float)((t % grid_x) * TILE + pid % TILE);
  const float pix_y = (float)((t / grid_x + row0) * TILE + pid / TILE);
  const int start = tile_start[t];

  const float* f = fwd_out + ((long long)t * PIX + pid) * C_OUT;
  const float* g = cot + ((long long)t * PIX + pid) * C_OUT;
  const float M1_tot = f[ACC + 1];
  const float M2_tot = f[ACC + 2];
  const float final_T = f[ACC + 5];
  const float n_contrib = f[ACC + 6];
  const int n_contrib_i = (int)n_contrib;
  const float med_contrib = f[ACC + 7];
  const float A_tot = 1.0f - final_T;
  const float logT_fin = logf(fmaxf(final_T, 1e-30f));
#pragma unroll
  for (int k = 0; k < ACC; ++k) sm.dlin[k][pid] = g[k];
  const float dD = g[ACC + 0];
  const float dM1 = g[ACC + 1];
  const float dM2 = g[ACC + 2];
  const float dReg = g[ACC + 3];
  const float dMed = g[ACC + 4];
  const float dTfin = g[ACC + 5];

  float carry_gw = 0.0f;  // sum of G*w over the pairs behind this one
  float carry_lg = 0.0f;  // sum of log1p(-a) over the pairs behind this one

  const int nb = (active + P - 1) / P;
  stage<NROW>(sm.pay[0], payload, ld, (long long)start + max(active - P, 0), min(P, active));
  for (int b = 0, slot = 0; b < nb; ++b, slot ^= 1) {
    const int hi = active - b * P;
    const int lo = max(hi - P, 0);
    const int n = hi - lo;
    cp_async_wait_all();
    __syncthreads();  // this batch has landed; the previous batch's sums are written
    if (pid < n) {
      sm.pay[slot][ROW_THR][pid] = thr_of(sm.pay[slot][ROW_OPACITY][pid]);
      sm.warps_any[pid] = 0u;
      sm.warps_3d[pid] = 0u;
    }
    if (b + 1 < nb) {
      const int lo2 = max(lo - P, 0);
      stage<NROW>(sm.pay[slot ^ 1], payload, ld, (long long)start + lo2, lo - lo2);
    }
    __syncthreads();

    // The batch's prefilter first (columns inside this pixel's contributor
    // range only), then the exact path back to front on the columns some
    // lane of the warp has to test.
    const unsigned cand = candidates<ROW_THR>(sm.pay[slot], max(0, min(n, n_contrib_i - lo)), pix_x, pix_y);
    for (unsigned todo = __reduce_or_sync(FULL, cand); todo; ) {
      const int c = 31 - __clz(todo);
      todo &= ~(1u << c);
      const float idx1 = (float)(lo + c + 1);
      const float tux = sm.pay[slot][ROW_TU][c], tuy = sm.pay[slot][ROW_TU + 1][c], tuz = sm.pay[slot][ROW_TU + 2][c];
      const float tvx = sm.pay[slot][ROW_TV][c], tvy = sm.pay[slot][ROW_TV + 1][c], tvz = sm.pay[slot][ROW_TV + 2][c];
      const float twx = sm.pay[slot][ROW_TW][c], twy = sm.pay[slot][ROW_TW + 1][c], twz = sm.pay[slot][ROW_TW + 2][c];
      const float opa = sm.pay[slot][ROW_OPACITY][c];

      // Recompute the forward's per-(pixel, pair) quantities.
      const float kx = pix_x * twx - tux;
      const float ky = pix_x * twy - tuy;
      const float kz = pix_x * twz - tuz;
      const float lx = pix_y * twx - tvx;
      const float ly = pix_y * twy - tvy;
      const float lz = pix_y * twz - tvz;
      const float px = ky * lz - kz * ly;
      const float py = kz * lx - kx * lz;
      const float pz = kx * ly - ky * lx;
      const float d1 = sm.pay[slot][ROW_MEAN2D][c] - pix_x;
      const float d2 = sm.pay[slot][ROW_MEAN2D + 1][c] - pix_y;
      const float rho2d = FILTER_INV_SQUARE * (d1 * d1 + d2 * d2);
      bool ok = (cand >> c) & 1u;  // pz != 0, inside the contributor range, not prefiltered
      float s1 = 0.0f, s2 = 0.0f, depth = 1.0f, Gg = 0.0f, a = 0.0f;
      bool use3d = false;
      if (ok) {
        s1 = px / pz;
        s2 = py / pz;
        const float rho3d = s1 * s1 + s2 * s2;
        use3d = rho3d <= rho2d;
        const float rho = nan_min(rho3d, rho2d);
        depth = use3d ? (s1 * twx + s2 * twy + twz) : twz;
        const float power = -0.5f * rho;
        Gg = expf(power);
        a = nan_min(ALPHA_MAX, opa * Gg);
        ok = depth >= NEAR_N && power <= 0.0f && a >= ALPHA_MIN;
      }
      if (!__any_sync(FULL, ok)) continue;  // no pixel of this warp counts the pair

      float v[NG];
#pragma unroll
      for (int r = 0; r < NG; ++r) v[r] = 0.0f;
      float w = 0.0f;
      if (ok) {
        const float lg = log1pf(-a);
        const float T_i = expf(logT_fin - (carry_lg + lg));
        w = a * T_i;
        const float m = NDC_SCALE * (1.0f - NEAR_N / depth);

        // G_i = dL/dw_i.
        float G = 0.0f;
#pragma unroll
        for (int k = 0; k < ACC; ++k) G = G + sm.dlin[k][pid] * sm.pay[slot][ROW_LIN + k][c];
        G = G + depth * dD + m * dM1 + (m * m) * dM2;
        G = G + (M2_tot + m * m * A_tot - 2.0f * m * M1_tot) * dReg;
        const float gw = G * w;
        const float one_m = 1.0f - a;
        const float dalpha = T_i * G - carry_gw / one_m - (final_T / one_m) * dTfin;

        // Depth gradient (expected depth, median depth, M1/M2, distortion).
        const float dmd_dd = DMD_NUM / (DMD_DEN * depth * depth);
        float dz = w * dD;
        if (idx1 == med_contrib) dz = dz + dMed;
        dz = dz + (2.0f * w * (m * A_tot - M1_tot) * dReg + w * dM1 + 2.0f * w * m * dM2) * dmd_dd;

        const float dG_g = opa * dalpha;  // pass-through min clamp
        v[ROW_OPACITY] = Gg * dalpha;
        if (use3d) {
          const float ds1 = dG_g * (-Gg) * s1 + dz * twx;
          const float ds2 = dG_g * (-Gg) * s2 + dz * twy;
          const float dp1 = ds1 / pz;
          const float dp2 = ds2 / pz;
          const float dp3 = -(dp1 * s1 + dp2 * s2);
          // dL/dk = cross(l, dp); dL/dl = cross(dp, k)
          const float dk1 = ly * dp3 - lz * dp2;
          const float dk2 = lz * dp1 - lx * dp3;
          const float dk3 = lx * dp2 - ly * dp1;
          const float dl1 = dp2 * kz - dp3 * ky;
          const float dl2 = dp3 * kx - dp1 * kz;
          const float dl3 = dp1 * ky - dp2 * kx;
          v[ROW_TU + 0] = -dk1;
          v[ROW_TU + 1] = -dk2;
          v[ROW_TU + 2] = -dk3;
          v[ROW_TV + 0] = -dl1;
          v[ROW_TV + 1] = -dl2;
          v[ROW_TV + 2] = -dl3;
          v[ROW_TW + 0] = pix_x * dk1 + pix_y * dl1 + dz * s1;
          v[ROW_TW + 1] = pix_x * dk2 + pix_y * dl2 + dz * s2;
          v[ROW_TW + 2] = pix_x * dk3 + pix_y * dl3 + dz;
        } else {
          // Low-pass (2D) branch: mean2d gradient + Tw.z depth pass-through.
          v[ROW_MEAN2D + 0] = dG_g * (-Gg) * FILTER_INV_SQUARE * d1;
          v[ROW_MEAN2D + 1] = dG_g * (-Gg) * FILTER_INV_SQUARE * d2;
          v[ROW_TW + 2] = dz;
        }
        carry_gw = carry_gw + gw;
        carry_lg = carry_lg + lg;
      }

      sm.w[c][pid] = w;
      int row;
      float sum;
      const bool any3 = __any_sync(FULL, ok && use3d);
      if (any3) {
        sum = reduce12(v, lane, &row);
      } else {
        sum = reduce4(v + ROW_TWZ, lane, &row);
      }
      if (row >= 0) sm.part[warp][row][c] = sum;
      if (lane == 0) {
        atomicOr(&sm.warps_any[c], 1u << warp);
        if (any3) atomicOr(&sm.warps_3d[c], 1u << warp);
      }
    }
    __syncthreads();

    // Geometric rows: the warps' partials in warp order (rows 0..7 exist
    // only in warps with a 3D lane).
    for (int i = pid; i < NG * n; i += PIX) {
      const int c = i / NG, r = i - c * NG;
      unsigned mask = r < ROW_TWZ ? sm.warps_3d[c] : sm.warps_any[c];
      if (!mask) continue;
      float s = 0.0f;
      while (mask) {
        const int wi = __ffs(mask) - 1;
        mask &= mask - 1u;
        s = s + sm.part[wi][r][c];
      }
      dpair[(long long)(start + lo + c) * NROW + r] = s;
    }
    // Linear rows: sum over the pixels of the warps that saw the pair of
    // w times the cotangent, pixel order.
    for (int i = pid; i < ACC * n; i += PIX) {
      const int c = i / ACC, k = i - c * ACC;
      unsigned mask = sm.warps_any[c];
      if (!mask) continue;
      float s = 0.0f;
      while (mask) {
        const int p0 = (__ffs(mask) - 1) * 32;
        mask &= mask - 1u;
#pragma unroll 8
        for (int l = 0; l < 32; ++l) s = __fmaf_rn(sm.w[c][p0 + l], sm.dlin[k][p0 + l], s);
      }
      dpair[(long long)(start + lo + c) * NROW + ROW_LIN + k] = s;
    }
  }
}

template <int S>
cudaError_t launch(const float* payload, long long ld, const int* tile_start,
                   const int* tile_count, const int* tile_active, const int* order,
                   const float* fwd_out, const float* cot, float* dpair,
                   int num_tiles, int grid_x, int row0, cudaStream_t stream) {
  const int bytes = (int)sizeof(Smem<S>);
  cudaError_t e = cudaFuncSetAttribute(rasterize_bwd_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  rasterize_bwd_kernel<S><<<num_tiles, PIX, bytes, stream>>>(
      payload, ld, tile_start, tile_count, tile_active, order, fwd_out, cot, dpair, grid_x, row0);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). payload: (C_PAD, ld) float32 rows,
// one column per sorted pair; tile_start/tile_count/tile_active: int32;
// order: int32 permutation of the tiles, block b walks tile order[b];
// fwd_out/cot: (grid_x*grid_y, 256, C_OUT(S)) float32; dpair: (ld, 12+S+6)
// float32, zero-filled by the caller (rows of no tile, and the pairs no
// pixel counts, stay zero); row0 as in rasterize_tiles_fwd. Returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for an S it was not
// built for).
extern "C" int rasterize_tiles_bwd(const float* payload, long long ld,
                                   const int* tile_start, const int* tile_count,
                                   const int* tile_active, const int* order,
                                   const float* fwd_out, const float* cot, float* dpair,
                                   int S, int grid_x, int grid_y, int row0, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define MRGS_BWD_CASE(N)                                                           \
  case N:                                                                          \
    return (int)launch<N>(payload, ld, tile_start, tile_count, tile_active, order, \
                          fwd_out, cot, dpair, num_tiles, grid_x, row0, s);
  switch (S) {
    MRGS_BWD_CASE(1)
    MRGS_BWD_CASE(2)
    MRGS_BWD_CASE(3)
    MRGS_BWD_CASE(4)
    MRGS_BWD_CASE(5)
    MRGS_BWD_CASE(6)
    MRGS_BWD_CASE(7)
    MRGS_BWD_CASE(8)
    MRGS_BWD_CASE(9)
    MRGS_BWD_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MRGS_BWD_CASE
}
