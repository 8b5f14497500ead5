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
// Design: one block of 256 threads per tile, one thread per pixel. Pair
// columns are staged through shared memory in batches of 32, back to front,
// from position tile_active (the tile's largest n_contrib) down to 1. Each
// thread carries two running sums over the pairs behind it: sum log1p(-a)
// and sum G*w (the JAX kernel's two carries). Per pair, each thread computes
// its (12+S+6) gradient contributions, a butterfly warp shuffle sums them over
// the warp's 32 pixels (skipped when no pixel of the warp counts the pair),
// and lane 0 parks the warp's sums in shared memory; after the batch the
// block adds the 8 warps' partials in a fixed order and writes each pair's
// gradient row (pair-major, so the caller's per-gaussian index_add_ reads
// contiguous rows) with plain stores. Every pair belongs to one tile, so no
// atomics are needed and the result is deterministic.
//
// What bounds it on the H100: per (pixel, pair) inside the pixel's
// contributor range the function needs the forward hit test again (~42 FP32
// operations, one expf); only the pairs that pass it (a fraction that depends
// on the scene) need log1pf + expf and the chain rule, ~180 operations at S=9
// on the 3D branch and ~125 on the 2D one, counted with their gradient
// rows' sums. It reads the pair's (12+S+6) payload rows once per tile and
// writes the same number of gradient rows, plus 2 x C_OUT floats per pixel of
// saved output and cotangent. That is below the card's bytes-per-operation
// balance, so the kernel is bound by FP32/SFU work and shuffles (chip_smoke.py
// prints the bound for its data): the design keeps payload and
// warp partials in shared memory, the per-pixel saved state and carries in
// registers, skips the reduction for pairs no pixel of a warp counts, and
// touches device memory only to stage a batch and to store its gradients.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, pixels per tile
constexpr int NWARP = PIX / 32;
constexpr int BATCH = 32;  // pair columns staged per shared-memory batch
constexpr unsigned FULL = 0xffffffffu;

constexpr int ROW_TU = 0;
constexpr int ROW_TV = 3;
constexpr int ROW_TW = 6;
constexpr int ROW_MEAN2D = 9;
constexpr int ROW_OPACITY = 11;
constexpr int ROW_LIN = 12;

constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float NEAR_N = 0.2f;
constexpr float NDC_SCALE = (float)(100.0 / (100.0 - 0.2));  // FAR/(FAR-NEAR)
constexpr float DMD_NUM = (float)(100.0 * 0.2);              // FAR*NEAR
constexpr float DMD_DEN = (float)(100.0 - 0.2);              // FAR-NEAR
constexpr float FILTER_INV_SQUARE = 2.0f;

// torch.minimum semantics: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return a + b;
  return a < b ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int S>
__global__ void __launch_bounds__(PIX)
rasterize_bwd_kernel(const float* __restrict__ payload, long long ld,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ tile_active,
                     const float* __restrict__ fwd_out,
                     const float* __restrict__ cot,
                     float* __restrict__ dpair, int grid_x) {
  constexpr int ACC = S + 6;           // color(3) + features(S) + normal(3)
  constexpr int NROW = ROW_LIN + ACC;  // payload rows read = gradient rows written
  constexpr int C_RAW = ACC + 8;       // out_layout(S)["_channels"]
  constexpr int C_OUT = (C_RAW + 7) / 8 * 8;

  __shared__ float sh[NROW][BATCH];
  __shared__ float part[NWARP][NROW][BATCH];

  const int t = blockIdx.x;
  const int pid = threadIdx.x;
  const int lane = pid & 31;
  const int warp = pid >> 5;
  const float pix_x = (float)((t % grid_x) * TILE + pid % TILE);
  const float pix_y = (float)((t / grid_x) * TILE + pid / TILE);
  const int start = tile_start[t];
  const int active = min(tile_active[t], tile_count[t]);

  const float* f = fwd_out + ((long long)t * PIX + pid) * C_OUT;
  const float* g = cot + ((long long)t * PIX + pid) * C_OUT;
  const float M1_tot = f[ACC + 1];
  const float M2_tot = f[ACC + 2];
  const float final_T = f[ACC + 5];
  const float n_contrib = f[ACC + 6];
  const float med_contrib = f[ACC + 7];
  const float A_tot = 1.0f - final_T;
  const float logT_fin = logf(fmaxf(final_T, 1e-30f));
  float dLin[ACC];
#pragma unroll
  for (int c = 0; c < ACC; ++c) dLin[c] = g[c];
  const float dD = g[ACC + 0];
  const float dM1 = g[ACC + 1];
  const float dM2 = g[ACC + 2];
  const float dReg = g[ACC + 3];
  const float dMed = g[ACC + 4];
  const float dTfin = g[ACC + 5];

  float carry_gw = 0.0f;  // sum of G*w over the pairs behind this one
  float carry_lg = 0.0f;  // sum of log1p(-a) over the pairs behind this one

  for (int hi = active; hi > 0; hi -= BATCH) {
    const int lo = max(hi - BATCH, 0);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's payload and partials are consumed
    for (int i = pid; i < NROW * n; i += PIX) {
      const int r = i / n, c = i % n;
      sh[r][c] = payload[(long long)r * ld + start + lo + c];
    }
    __syncthreads();

    for (int c = n - 1; c >= 0; --c) {
      float grad[NROW];
#pragma unroll
      for (int r = 0; r < NROW; ++r) grad[r] = 0.0f;
      const float idx1 = (float)(lo + c + 1);

      const float tux = sh[ROW_TU][c], tuy = sh[ROW_TU + 1][c], tuz = sh[ROW_TU + 2][c];
      const float tvx = sh[ROW_TV][c], tvy = sh[ROW_TV + 1][c], tvz = sh[ROW_TV + 2][c];
      const float twx = sh[ROW_TW][c], twy = sh[ROW_TW + 1][c], twz = sh[ROW_TW + 2][c];
      const float opa = sh[ROW_OPACITY][c];

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
      bool ok = pz != 0.0f && idx1 <= n_contrib;
      float s1 = 0.0f, s2 = 0.0f, d1 = 0.0f, d2 = 0.0f, depth = 1.0f, Gg = 0.0f, a = 0.0f;
      bool use3d = false;
      if (ok) {
        s1 = px / pz;
        s2 = py / pz;
        const float rho3d = s1 * s1 + s2 * s2;
        d1 = sh[ROW_MEAN2D][c] - pix_x;
        d2 = sh[ROW_MEAN2D + 1][c] - pix_y;
        const float rho2d = FILTER_INV_SQUARE * (d1 * d1 + d2 * d2);
        use3d = rho3d <= rho2d;
        const float rho = nan_min(rho3d, rho2d);
        depth = use3d ? (s1 * twx + s2 * twy + twz) : twz;
        const float power = -0.5f * rho;
        Gg = expf(power);
        a = nan_min(ALPHA_MAX, opa * Gg);
        ok = depth >= NEAR_N && power <= 0.0f && a >= ALPHA_MIN;
      }

      if (ok) {
        const float lg = log1pf(-a);
        const float T_i = expf(logT_fin - (carry_lg + lg));
        const float w = a * T_i;
        const float m = NDC_SCALE * (1.0f - NEAR_N / depth);

        // G_i = dL/dw_i.
        float G = 0.0f;
#pragma unroll
        for (int k = 0; k < ACC; ++k) G = G + dLin[k] * sh[ROW_LIN + k][c];
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
        grad[ROW_OPACITY] = Gg * dalpha;
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
          grad[ROW_TU + 0] = -dk1;
          grad[ROW_TU + 1] = -dk2;
          grad[ROW_TU + 2] = -dk3;
          grad[ROW_TV + 0] = -dl1;
          grad[ROW_TV + 1] = -dl2;
          grad[ROW_TV + 2] = -dl3;
          grad[ROW_TW + 0] = pix_x * dk1 + pix_y * dl1 + dz * s1;
          grad[ROW_TW + 1] = pix_x * dk2 + pix_y * dl2 + dz * s2;
          grad[ROW_TW + 2] = pix_x * dk3 + pix_y * dl3 + dz;
        } else {
          // Low-pass (2D) branch: mean2d gradient + Tw.z depth pass-through.
          grad[ROW_MEAN2D + 0] = dG_g * (-Gg) * FILTER_INV_SQUARE * d1;
          grad[ROW_MEAN2D + 1] = dG_g * (-Gg) * FILTER_INV_SQUARE * d2;
          grad[ROW_TW + 2] = dz;
        }
#pragma unroll
        for (int k = 0; k < ACC; ++k) grad[ROW_LIN + k] = dLin[k] * w;

        carry_gw = carry_gw + gw;
        carry_lg = carry_lg + lg;
      }

      if (__any_sync(FULL, ok)) {
#pragma unroll
        for (int r = 0; r < NROW; ++r) {
          const float v = warp_sum(grad[r]);
          if (lane == 0) part[warp][r][c] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NROW; ++r) part[warp][r][c] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = pid; i < NROW * n; i += PIX) {
      const int c = i / NROW, r = i % NROW;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) s = s + part[w][r][c];
      dpair[(long long)(start + lo + c) * NROW + r] = s;
    }
  }
}

template <int S>
cudaError_t launch(const float* payload, long long ld, const int* tile_start,
                   const int* tile_count, const int* tile_active,
                   const float* fwd_out, const float* cot, float* dpair,
                   int num_tiles, int grid_x, cudaStream_t stream) {
  rasterize_bwd_kernel<S><<<num_tiles, PIX, 0, stream>>>(
      payload, ld, tile_start, tile_count, tile_active, fwd_out, cot, dpair, grid_x);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). payload: (C_PAD, ld) float32 rows,
// one column per sorted pair; tile_start/tile_count/tile_active: int32;
// fwd_out/cot: (grid_x*grid_y, 256, C_OUT(S)) float32; dpair: (ld, 12+S+6)
// float32, zero-filled by the caller (rows of no tile stay zero, and each
// tile writes its positions 1..tile_active). Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an S it was not built for).
extern "C" int rasterize_tiles_bwd(const float* payload, long long ld,
                                   const int* tile_start, const int* tile_count,
                                   const int* tile_active, const float* fwd_out,
                                   const float* cot, float* dpair, int S,
                                   int grid_x, int grid_y, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define MRGS_BWD_CASE(N)                                                           \
  case N:                                                                          \
    return (int)launch<N>(payload, ld, tile_start, tile_count, tile_active,       \
                          fwd_out, cot, dpair, num_tiles, grid_x, s);
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
