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
// 1-based list position that counted), SUMLG (sum of log1p(-alpha) over every
// hit of every processed chunk) and NPROC (processed chunks), in the OUT_*
// layout of ops/tracer/layout.py.
//
// Design: one block of 256 threads per bundle, one thread per ray. The
// thread's unit direction and its n_sh SH basis values live in registers.
// The bundle's pairs are staged through shared memory one 128-pair chunk at
// a time from the segment's own start (the payload is channel-major with one
// column per pair, so for each row consecutive threads read consecutive
// floats): (13 + 3*n_sh) rows x 128 x 4 B, 31 KB at n_sh = 16.
//  - List order: each thread walks the chunk's lanes in order. An ok lane
//    adds lg = log1p(-alpha) to the thread's log-transmittance; it counts
//    (weight alpha*T) while log T after it stays >= log(1e-4).
//  - Exact order: a first pass collects the ok lanes' (t, lane) keys into a
//    per-thread list (local memory) kept sorted by insertion, which keeps
//    ties in lane order; a second pass recomputes those lanes' hits in that
//    order and composites them with the same law. Lanes that miss move no
//    prefix, as in the JAX kernel (t_key = inf for them).
// The chunk loop runs while chunks remain and any ray of the bundle still has
// log T >= log(1e-4) (__syncthreads_or, the JAX kernel's `cond`). A thread
// whose ray has stopped still runs every hit test and keeps summing lg: SUMLG
// is the sum over all processed chunks, which the exact-order backward reads.
//
// What bounds it on the H100: per (ray, pair) of a processed chunk the hit
// test costs ~45 FP32 operations and one expf; a hit adds a log1pf, an expf
// and 3*(2*n_sh + 1) + ~20 operations for color and compositing (exact order:
// plus its sort). The payload a bundle reads is (13 + 3*n_sh)*4 bytes per
// pair, shared by 256 rays, so the kernel is bound by FP32/SFU work, not
// bytes: the design reads each pair from device memory once per bundle and
// keeps every per-ray accumulator in registers.
//
// Numerics follow the plain torch version (trace_fwd.trace_bundles_fwd_plain)
// operation for operation, and it is built with -fmad=false, so the two agree
// bit for bit where libdevice and torch do (n_contrib and NPROC exactly).
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

struct Hit {
  bool ok;
  float t, alpha, denom;
};

// The hit test of pallas_kernels.py:_geom for lane j of the staged chunk.
template <int NROW>
__device__ __forceinline__ Hit hit_test(const float (*sh)[K], int j, float ox, float oy,
                                        float oz, float dx, float dy, float dz, float tmin) {
  const float px = sh[ROW_P][j], py = sh[ROW_P + 1][j], pz = sh[ROW_P + 2][j];
  const float nx = sh[ROW_N][j], ny = sh[ROW_N + 1][j], nz = sh[ROW_N + 2][j];
  Hit h;
  h.denom = dx * nx + dy * ny + dz * nz;
  const bool den_ok = fabsf(h.denom) > 1e-9f;
  const float den_s = den_ok ? h.denom : 1.0f;
  h.t = ((px - ox) * nx + (py - oy) * ny + (pz - oz) * nz) / den_s;
  const float qx = ox + h.t * dx - px;
  const float qy = oy + h.t * dy - py;
  const float qz = oz + h.t * dz - pz;
  const float u = qx * sh[ROW_TU][j] + qy * sh[ROW_TU + 1][j] + qz * sh[ROW_TU + 2][j];
  const float v = qx * sh[ROW_TV][j] + qy * sh[ROW_TV + 1][j] + qz * sh[ROW_TV + 2][j];
  const float rho = u * u + v * v;
  h.alpha = clamp_max(sh[ROW_OPA][j] * expf(-0.5f * rho), ALPHA_MAX);
  h.ok = den_ok && h.t >= tmin && rho <= RHO_CUTOFF && h.alpha >= ALPHA_MIN;
  return h;
}

// Order-preserving map of a float to an unsigned key (all t here are > 0).
__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int NSH, bool EXACT>
__global__ void __launch_bounds__(NRAY)
trace_fwd_kernel(const float* __restrict__ payload, long long ld,
                 const float* __restrict__ rays, const int* __restrict__ seg_start,
                 const int* __restrict__ seg_count, float* __restrict__ out, float tmin) {
  constexpr int NROW = ROW_SH + 3 * NSH;  // payload rows read
  __shared__ float sh[NROW][K];

  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const float* ray = rays + ((long long)b * NRAY + r) * 8;
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float inv = 1.0f / sqrtf(clamp_min(dx * dx + dy * dy + dz * dz, 1e-24f));
  float Y[NSH];
  sh_basis<NSH>(dx * inv, dy * inv, dz * inv, Y);

  const long long start = seg_start[b];
  const int count = seg_count[b];
  const int n_chunks = (count + K - 1) / K;

  float p = 0.0f;  // log T; after the loop, SUMLG
  float rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f, dep = 0.0f;
  float nrm0 = 0.0f, nrm1 = 0.0f, nrm2 = 0.0f;
  float fin = 0.0f, n_contrib = 0.0f;
  unsigned long long keys[EXACT ? K : 1];

  int chunk = 0;
  for (; chunk < n_chunks; ++chunk) {
    // Also the barrier that keeps the previous chunk alive until every
    // thread has finished reading it.
    if (!__syncthreads_or(p >= LOG_T_STOP)) break;
    const long long off = start + (long long)chunk * K;
    for (int i = r; i < NROW * K; i += NRAY) {
      const int row = i / K, lane = i % K;
      sh[row][lane] = payload[(long long)row * ld + off + lane];
    }
    __syncthreads();
    const int n_lanes = min(K, count - chunk * K);

    // Composite lane j (which passed the hit test h) at the current log T.
    auto composite = [&](int j, const Hit& h) {
      const float lg = log1pf(-h.alpha);
      const float incl = p + lg;
      if (incl >= LOG_T_STOP) {
        const float w = h.alpha * expf(p);
        float col[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float raw = Y[0] * sh[ROW_SH + c * NSH][j];
#pragma unroll
          for (int k = 1; k < NSH; ++k) raw = raw + Y[k] * sh[ROW_SH + c * NSH + k][j];
          col[c] = clamp_min(raw + 0.5f, 0.0f);
        }
        rgb0 = rgb0 + w * col[0];
        rgb1 = rgb1 + w * col[1];
        rgb2 = rgb2 + w * col[2];
        dep = dep + w * h.t;
        const float wf = w * (h.denom > 0.0f ? -1.0f : 1.0f);
        nrm0 = nrm0 + wf * sh[ROW_N][j];
        nrm1 = nrm1 + wf * sh[ROW_N + 1][j];
        nrm2 = nrm2 + wf * sh[ROW_N + 2][j];
        fin = incl < fin ? incl : fin;
        const float pos = (float)(chunk * K + j + 1);
        n_contrib = pos > n_contrib ? pos : n_contrib;
      }
      p = incl;
    };

    if (!EXACT) {
      for (int j = 0; j < n_lanes; ++j) {
        const Hit h = hit_test<NROW>(sh, j, ox, oy, oz, dx, dy, dz, tmin);
        if (h.ok) composite(j, h);
      }
    } else {
      int n_hits = 0;
      for (int j = 0; j < n_lanes; ++j) {
        const Hit h = hit_test<NROW>(sh, j, ox, oy, oz, dx, dy, dz, tmin);
        if (!h.ok) continue;
        // Insertion by (t, lane): lanes arrive in increasing order, so a
        // tie stays behind the earlier lane (the stable sort's order).
        const unsigned long long key = ((unsigned long long)order_bits(h.t) << 32) | (unsigned)j;
        int i = n_hits++;
        while (i > 0 && keys[i - 1] > key) {
          keys[i] = keys[i - 1];
          --i;
        }
        keys[i] = key;
      }
      for (int i = 0; i < n_hits; ++i) {
        const int j = (int)(keys[i] & 0xffffffffull);
        composite(j, hit_test<NROW>(sh, j, ox, oy, oz, dx, dy, dz, tmin));
      }
    }
  }

  float* o = out + ((long long)b * NRAY + r) * C_OUT;
  o[0] = rgb0;
  o[1] = rgb1;
  o[2] = rgb2;
  o[3] = dep;
  o[4] = nrm0;
  o[5] = nrm1;
  o[6] = nrm2;
  o[7] = expf(fin);
  o[8] = n_contrib;
  o[9] = p;
  o[10] = (float)chunk;
#pragma unroll
  for (int c = 11; c < C_OUT; ++c) o[c] = 0.0f;
}

template <int NSH>
cudaError_t launch(const float* payload, long long ld, const float* rays, const int* seg_start,
                   const int* seg_count, float* out, int NB, float tmin, int exact,
                   cudaStream_t stream) {
  if (exact)
    trace_fwd_kernel<NSH, true><<<NB, NRAY, 0, stream>>>(payload, ld, rays, seg_start,
                                                         seg_count, out, tmin);
  else
    trace_fwd_kernel<NSH, false><<<NB, NRAY, 0, stream>>>(payload, ld, rays, seg_start,
                                                          seg_count, out, tmin);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). payload: (pay_rows(n_sh), ld)
// float32 rows, one column per pair; rays: (NB, 256, 8) float32;
// seg_start (NB+1,) / seg_count (NB,) int32; out: (NB, 256, 16) float32.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for an n_sh
// it was not built for).
extern "C" int trace_bundles_fwd(const float* payload, long long ld, const float* rays,
                                 const int* seg_start, const int* seg_count, float* out,
                                 int NB, int n_sh, float tmin, int exact_order, void* stream) {
  if (NB <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_sh) {
    case 1: return (int)launch<1>(payload, ld, rays, seg_start, seg_count, out, NB, tmin, exact_order, s);
    case 4: return (int)launch<4>(payload, ld, rays, seg_start, seg_count, out, NB, tmin, exact_order, s);
    case 9: return (int)launch<9>(payload, ld, rays, seg_start, seg_count, out, NB, tmin, exact_order, s);
    case 16: return (int)launch<16>(payload, ld, rays, seg_start, seg_count, out, NB, tmin, exact_order, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
