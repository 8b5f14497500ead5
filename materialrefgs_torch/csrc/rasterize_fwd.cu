// Tile rasterizer forward for 2D Gaussian surfels, CUDA C++ for sm_90a.
//
// Replaces materialrefgs_tpu/ops/rasterize/pallas_fwd.py:rasterize_tiles_fwd
// (the Pallas `_fwd_kernel`): front-to-back compositing of each 16x16 tile's
// depth-sorted (gaussian, tile) pairs into color / feature / normal sums,
// expected depth, M1, M2, distortion, median depth, final_T, n_contrib and
// median_contrib, in the per-tile output layout of layout.out_layout(S).
//
// Design: one block of 256 threads per tile, one thread per pixel. The tile's
// pair columns are staged through shared memory in batches of 256 (the payload
// is channel-major with one column per pair, so for each channel row the 256
// threads read 256 consecutive floats). Each thread then walks the batch
// sequentially with its own log-transmittance and exits the walk as soon as
// its pixel stops; the block stops loading batches once every pixel has
// stopped (__syncthreads_count).
//
// What bounds it on the H100: per (pixel, pair) evaluation the ray-splat hit
// costs ~42 FP32 operations plus one expf, and a contributing pair adds a
// log1pf, an expf and 2*(S+6)+12 more; the payload the tile reads is
// (12+S+6)*4 bytes per pair, shared by 256 pixels. So the kernel is bound by
// FP32/SFU work, not bytes: the design keeps every pair's payload in shared
// memory (read once from device memory per tile) and spends registers on the
// per-pixel accumulators so the inner loop touches no device memory.
//
// Numerics follow the JAX kernel: transmittance is carried as a sum of
// log1p(-alpha) and a pair counts only while log T after it stays >= log(1e-4);
// final_T is T after the last counted pair; contributor indices are 1-based
// positions in the tile's pair list. The arithmetic order matches the plain
// torch version (tiles_fwd.rasterize_tiles_fwd_plain) operation for
// operation; built with -fmad=false it reproduces that version's roundings,
// so n_contrib agrees exactly.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, pixels per tile
constexpr int BATCH = PIX;        // pair columns staged per shared-memory batch

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
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float LOG_T_STOP = -9.210340371976182f;  // log(1e-4)
constexpr float LOG_HALF = -0.6931471805599453f;   // log(0.5)
constexpr float DEAD = -1e9f;

// torch.minimum semantics: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return a + b;
  return a < b ? a : b;
}

template <int S>
__global__ void __launch_bounds__(PIX)
rasterize_fwd_kernel(const float* __restrict__ payload, long long ld,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     float* __restrict__ out, int grid_x, int W, int H) {
  constexpr int ACC = S + 6;             // color(3) + features(S) + normal(3)
  constexpr int NROW = ROW_LIN + ACC;    // payload rows the forward reads
  constexpr int C_RAW = ACC + 8;         // out_layout(S)["_channels"]
  constexpr int C_OUT = (C_RAW + 7) / 8 * 8;

  __shared__ float sh[NROW][BATCH];

  const int t = blockIdx.x;
  const int pid = threadIdx.x;
  const int px_i = (t % grid_x) * TILE + pid % TILE;
  const int py_i = (t / grid_x) * TILE + pid / TILE;
  const float pix_x = (float)px_i;
  const float pix_y = (float)py_i;
  const bool inside = px_i < W && py_i < H;
  const int start = tile_start[t];
  const int count = tile_count[t];

  float acc[ACC];
#pragma unroll
  for (int c = 0; c < ACC; ++c) acc[c] = 0.0f;
  float depth_acc = 0.0f, m1_acc = 0.0f, m2_acc = 0.0f, dist_acc = 0.0f;
  float w_sum = 0.0f, wm_sum = 0.0f, wm2_sum = 0.0f;
  float med_depth = 0.0f, med_idx = -1.0f, n_contrib = 0.0f;
  float logT = inside ? 0.0f : DEAD;
  float T = expf(logT);
  float final_logT = 0.0f;
  bool done = !inside;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    // Also the barrier that keeps the previous batch alive until every
    // thread has finished reading it.
    if (__syncthreads_count(done ? 1 : 0) == PIX) break;
    const int n = min(BATCH, count - b0);
    if (pid < n) {
      const float* col = payload + (long long)start + b0 + pid;
#pragma unroll
      for (int r = 0; r < NROW; ++r) sh[r][pid] = col[(long long)r * ld];
    }
    __syncthreads();
    if (done) continue;

    for (int j = 0; j < n; ++j) {
      const float tux = sh[ROW_TU][j], tuy = sh[ROW_TU + 1][j], tuz = sh[ROW_TU + 2][j];
      const float tvx = sh[ROW_TV][j], tvy = sh[ROW_TV + 1][j], tvz = sh[ROW_TV + 2][j];
      const float twx = sh[ROW_TW][j], twy = sh[ROW_TW + 1][j], twz = sh[ROW_TW + 2][j];

      // Ray-splat intersection (forward.cu:366-382).
      const float kx = pix_x * twx - tux;
      const float ky = pix_x * twy - tuy;
      const float kz = pix_x * twz - tuz;
      const float lx = pix_y * twx - tvx;
      const float ly = pix_y * twy - tvy;
      const float lz = pix_y * twz - tvz;
      const float px = ky * lz - kz * ly;
      const float py = kz * lx - kx * lz;
      const float pz = kx * ly - ky * lx;
      if (pz == 0.0f) continue;
      const float s1 = px / pz;
      const float s2 = py / pz;
      const float rho3d = s1 * s1 + s2 * s2;
      const float d1 = sh[ROW_MEAN2D][j] - pix_x;
      const float d2 = sh[ROW_MEAN2D + 1][j] - pix_y;
      const float rho2d = FILTER_INV_SQUARE * (d1 * d1 + d2 * d2);
      const bool use3d = rho3d <= rho2d;
      const float rho = nan_min(rho3d, rho2d);
      const float depth = use3d ? (s1 * twx + s2 * twy + twz) : twz;
      const float power = -0.5f * rho;
      const float alpha = nan_min(ALPHA_MAX, sh[ROW_OPACITY][j] * expf(power));
      if (!(depth >= NEAR_N && power <= 0.0f && alpha >= ALPHA_MIN)) continue;

      const float logT_incl = logT + log1pf(-alpha);
      if (!(logT_incl >= LOG_T_STOP)) {  // this pair would take T below 1e-4
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < ACC; ++c) acc[c] = acc[c] + w * sh[ROW_LIN + c][j];
      depth_acc = depth_acc + w * depth;
      // Distortion (forward.cu:407-415) on the NDC-mapped depth.
      const float m = NDC_SCALE * (1.0f - NEAR_N * (1.0f / depth));
      const float wm = w * m;
      const float wm2 = wm * m;
      dist_acc = dist_acc + w * (m * m * w_sum + wm2_sum - 2.0f * m * wm_sum);
      m1_acc = m1_acc + wm;
      m2_acc = m2_acc + wm2;
      w_sum = w_sum + w;
      wm_sum = wm_sum + wm;
      wm2_sum = wm2_sum + wm2;
      const float idx1 = (float)(b0 + j + 1);
      n_contrib = idx1;
      if (logT > LOG_HALF) {  // median: last contributor with T before > 0.5
        med_depth = depth;
        med_idx = idx1;
      }
      final_logT = logT_incl;
      logT = logT_incl;
      T = expf(logT);
    }
  }

  float* o = out + ((long long)t * PIX + pid) * C_OUT;
#pragma unroll
  for (int c = 0; c < ACC; ++c) o[c] = acc[c];
  o[ACC + 0] = depth_acc;
  o[ACC + 1] = m1_acc;
  o[ACC + 2] = m2_acc;
  o[ACC + 3] = dist_acc;
  o[ACC + 4] = med_depth;
  o[ACC + 5] = expf(final_logT);
  o[ACC + 6] = n_contrib;
  o[ACC + 7] = med_idx;
#pragma unroll
  for (int c = C_RAW; c < C_OUT; ++c) o[c] = 0.0f;
}

template <int S>
cudaError_t launch(const float* payload, long long ld, const int* tile_start,
                   const int* tile_count, float* out, int num_tiles, int grid_x,
                   int W, int H, cudaStream_t stream) {
  rasterize_fwd_kernel<S><<<num_tiles, PIX, 0, stream>>>(
      payload, ld, tile_start, tile_count, out, grid_x, W, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). payload: (C_PAD, ld) float32 rows,
// one column per sorted pair; tile_start/tile_count: int32 raw ranges;
// out: (grid_x*grid_y, 256, C_OUT(S)) float32. Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an S it was not built for).
extern "C" int rasterize_tiles_fwd(const float* payload, long long ld,
                                   const int* tile_start, const int* tile_count,
                                   float* out, int S, int grid_x, int grid_y,
                                   int W, int H, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (S) {
    case 1: return (int)launch<1>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    case 2: return (int)launch<2>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    case 3: return (int)launch<3>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    case 4: return (int)launch<4>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    case 5: return (int)launch<5>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    case 6: return (int)launch<6>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    case 7: return (int)launch<7>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    case 8: return (int)launch<8>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    case 9: return (int)launch<9>(payload, ld, tile_start, tile_count, out, num_tiles, grid_x, W, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
