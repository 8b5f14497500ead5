// The multi-view warp's bilinear sampler, CUDA C++ for sm_90a.
//
// Not a port of a TPU kernel: the JAX package samples with four jnp gathers
// (train/warp.py grid_sample) and lets XLA fuse them. In the port the same
// expression in plain torch (ops/warp_sample.grid_sample_plain) reads each
// corner with `img[yi, xi]`, whose autograd backward is an accumulating
// index_put_ that sorts its int64 indices: 4 sorts of 5,017,600 entries per
// warped map a train step. This pair replaces the four gathers and their
// backward: `warp_sample_fwd` gathers, `warp_sample_bwd` splats.
//
// Values. The forward repeats the plain expression's float32 operations in
// its order, each rounded on its own (-fmad=false; the intrinsics say so
// where it matters): fx = (x + 1) * (W - 1) / 2, the floor, jnp.clip of the
// fraction (NaN passes through, as torch.maximum / minimum pass it), each
// corner read at its clamped texel and multiplied by 1.0 or 0.0 (zero
// padding: a NaN or inf texel or coordinate gives what the plain version
// gives), then c00*(1-wx)*(1-wy) + c01*wx*(1-wy) + c10*(1-wx)*wy + c11*wx*wy
// left to right. So its output equals the plain version's bit for bit.
//
// Gradients. The backward keeps nothing from the forward: it recomputes the
// corners and weights from the coordinates. The map's gradient is
// atomicAdd'ed into a zeroed (H, W, C) map at the texel the plain version's
// index_put_ adds to, with the same products (g * (1-wy) * (1-wx) * ok, ...);
// a product that is exactly 0 adds nothing and is skipped (a NaN is added).
// The coordinates' gradient, written only when asked for, carries
// jnp.clip's gradient (half at a bound), floor's zero and the (W - 1) / 2
// chain. Atomics sum in another order than the plain version: the map's
// gradient differs at rounding level.
//
// What bounds it on the H100: bytes. A coordinate costs 8 bytes read and
// C floats written (forward) or C floats of gradient read (backward); the
// map is read in 4 C-float corners per coordinate, but a warped map is at
// most a few MB and neighbouring coordinates (a 7x7 patch) share corners,
// so the reads and the atomics stay in the 50 MB L2. Design: one thread per
// coordinate, all C channels in registers, the corners' offsets computed
// once. Nothing is allocated here: the wrapper allocates the output and
// the gradients.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Map {
  const float* p;
  long long sH, sW, sC;  // element strides (a channel slice of a wider map keeps its own)
  int H, W, C;
};

struct Pairs {  // (M, 2) float32, or the (M, C) output gradient, by strides
  const float* p;
  long long s0, s1;
};

// The four corners of one coordinate, in the order c00, c01, c10, c11.
struct Corners {
  float wx, wy;     // the clipped fractions (the bilinear weights)
  float kx, ky;     // jnp.clip's gradient at wx, wy: 1, 0.5 at a bound, 0 outside
  long long at[4];  // the clamped texel's offset in the map (elements)
  long long cell[4];  // the clamped texel's row in an (H * W, C) gradient
  float ok[4];      // 1.0 in bounds, 0.0 out
};

// jnp.clip(v, 0, 1) = min(max(v, 0), 1) with torch's NaN propagation, and
// its gradient factor: torch.maximum / minimum give half at a tie and 0 to
// the side that loses (a NaN passes the gradient whole).
__device__ __forceinline__ float clip01(float v, float* k) {
  const float m = (v != v) ? v : (v < 0.0f ? 0.0f : v);
  const float kmax = (v == 0.0f) ? 0.5f : (v < 0.0f ? 0.0f : 1.0f);
  const float w = (m != m) ? m : (m > 1.0f ? 1.0f : m);
  const float kmin = (m == 1.0f) ? 0.5f : (m > 1.0f ? 0.0f : 1.0f);
  *k = kmin * kmax;
  return w;
}

// torch.clamp(torch.nan_to_num(f, nan=0.0), 0, n - 1).long() of an integral f.
__device__ __forceinline__ long long texel(float f, int n) {
  if (f != f) return 0;
  return (long long)fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

__device__ __forceinline__ Corners corners(const Map& m, float x, float y) {
  Corners k;
  const float fx = __fdiv_rn(__fmul_rn(__fadd_rn(x, 1.0f), (float)(m.W - 1)), 2.0f);
  const float fy = __fdiv_rn(__fmul_rn(__fadd_rn(y, 1.0f), (float)(m.H - 1)), 2.0f);
  const float x0 = floorf(fx), y0 = floorf(fy);
  k.wx = clip01(__fsub_rn(fx, x0), &k.kx);
  k.wy = clip01(__fsub_rn(fy, y0), &k.ky);
  const float xs[2] = {x0, __fadd_rn(x0, 1.0f)};
  const float ys[2] = {y0, __fadd_rn(y0, 1.0f)};
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const float xf = xs[j & 1], yf = ys[j >> 1];
    const bool in = xf >= 0.0f && xf < (float)m.W && yf >= 0.0f && yf < (float)m.H;
    const long long xi = texel(xf, m.W), yi = texel(yf, m.H);
    k.ok[j] = in ? 1.0f : 0.0f;
    k.at[j] = yi * m.sH + xi * m.sW;
    k.cell[j] = yi * m.W + xi;
  }
  return k;
}

__device__ __forceinline__ void splat(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);
}

// kC > 0: the channel count known at compile time; 0: read it from the map.
template <int kC>
__global__ void __launch_bounds__(kThreads) warp_sample_fwd_kernel(Map m, Pairs q, long long M, float* out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  const int C = kC > 0 ? kC : m.C;
  const Corners k = corners(m, q.p[i * q.s0], q.p[i * q.s0 + q.s1]);
  const float ax = __fsub_rn(1.0f, k.wx), ay = __fsub_rn(1.0f, k.wy);
#pragma unroll
  for (int c = 0; c < C; c++) {
    const long long o = c * m.sC;
    const float c00 = __fmul_rn(m.p[k.at[0] + o], k.ok[0]);
    const float c01 = __fmul_rn(m.p[k.at[1] + o], k.ok[1]);
    const float c10 = __fmul_rn(m.p[k.at[2] + o], k.ok[2]);
    const float c11 = __fmul_rn(m.p[k.at[3] + o], k.ok[3]);
    float v = __fmul_rn(__fmul_rn(c00, ax), ay);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(c01, k.wx), ay));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(c10, ax), k.wy));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(c11, k.wx), k.wy));
    out[i * C + c] = v;
  }
}

// dmap (H * W, C) zeroed, or null; dq (M, 2), or null.
template <int kC>
__global__ void __launch_bounds__(kThreads)
    warp_sample_bwd_kernel(Map m, Pairs q, long long M, Pairs g, float* dmap, float* dq) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  const int C = kC > 0 ? kC : m.C;
  const Corners k = corners(m, q.p[i * q.s0], q.p[i * q.s0 + q.s1]);
  const float ax = __fsub_rn(1.0f, k.wx), ay = __fsub_rn(1.0f, k.wy);
  // The weights' gradients as autograd gathers them: (1-wx) from c00 and
  // c10, wx from c01 and c11; (1-wy) from c00 and c01, wy from c10 and c11.
  float gax = 0.0f, gwx = 0.0f, gay = 0.0f, gwy = 0.0f;
#pragma unroll
  for (int c = 0; c < C; c++) {
    const float gc = g.p[i * g.s0 + c * g.s1];
    const float gb = __fmul_rn(gc, ay), gt = __fmul_rn(gc, k.wy);
    if (dmap != nullptr) {
      splat(dmap + k.cell[0] * C + c, __fmul_rn(__fmul_rn(gb, ax), k.ok[0]));
      splat(dmap + k.cell[1] * C + c, __fmul_rn(__fmul_rn(gb, k.wx), k.ok[1]));
      splat(dmap + k.cell[2] * C + c, __fmul_rn(__fmul_rn(gt, ax), k.ok[2]));
      splat(dmap + k.cell[3] * C + c, __fmul_rn(__fmul_rn(gt, k.wx), k.ok[3]));
    }
    if (dq != nullptr) {
      const long long o = c * m.sC;
      const float c00 = __fmul_rn(m.p[k.at[0] + o], k.ok[0]);
      const float c01 = __fmul_rn(m.p[k.at[1] + o], k.ok[1]);
      const float c10 = __fmul_rn(m.p[k.at[2] + o], k.ok[2]);
      const float c11 = __fmul_rn(m.p[k.at[3] + o], k.ok[3]);
      gax = __fadd_rn(gax, __fadd_rn(__fmul_rn(gb, c00), __fmul_rn(gt, c10)));
      gwx = __fadd_rn(gwx, __fadd_rn(__fmul_rn(gb, c01), __fmul_rn(gt, c11)));
      gay = __fadd_rn(gay, __fadd_rn(__fmul_rn(gc, __fmul_rn(c00, ax)), __fmul_rn(gc, __fmul_rn(c01, k.wx))));
      gwy = __fadd_rn(gwy, __fadd_rn(__fmul_rn(gc, __fmul_rn(c10, ax)), __fmul_rn(gc, __fmul_rn(c11, k.wx))));
    }
  }
  if (dq != nullptr) {
    const float dfx = __fmul_rn(__fsub_rn(gwx, gax), k.kx);
    const float dfy = __fmul_rn(__fsub_rn(gwy, gay), k.ky);
    dq[2 * i] = __fmul_rn(__fdiv_rn(dfx, 2.0f), (float)(m.W - 1));
    dq[2 * i + 1] = __fmul_rn(__fdiv_rn(dfy, 2.0f), (float)(m.H - 1));
  }
}

unsigned blocks(long long M) { return (unsigned)((M + kThreads - 1) / kThreads); }

}  // namespace

// out (M, C) float32 contiguous.
extern "C" int warp_sample_fwd(const float* map, long long sH, long long sW, long long sC, int H, int W,
                               int C, const float* coords, long long cs0, long long cs1, long long M,
                               float* out, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Map m{map, sH, sW, sC, H, W, C};
  const Pairs q{coords, cs0, cs1};
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: warp_sample_fwd_kernel<1><<<blocks(M), kThreads, 0, s>>>(m, q, M, out); break;
    case 3: warp_sample_fwd_kernel<3><<<blocks(M), kThreads, 0, s>>>(m, q, M, out); break;
    default: warp_sample_fwd_kernel<0><<<blocks(M), kThreads, 0, s>>>(m, q, M, out); break;
  }
  return (int)cudaGetLastError();
}

// grad (M, C) by strides; dmap (H, W, C) float32 contiguous and zeroed, or
// null; dcoords (M, 2) float32 contiguous, or null.
extern "C" int warp_sample_bwd(const float* map, long long sH, long long sW, long long sC, int H, int W,
                               int C, const float* coords, long long cs0, long long cs1, long long M,
                               const float* grad, long long gs0, long long gs1, float* dmap,
                               float* dcoords, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Map m{map, sH, sW, sC, H, W, C};
  const Pairs q{coords, cs0, cs1}, g{grad, gs0, gs1};
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: warp_sample_bwd_kernel<1><<<blocks(M), kThreads, 0, s>>>(m, q, M, g, dmap, dcoords); break;
    case 3: warp_sample_bwd_kernel<3><<<blocks(M), kThreads, 0, s>>>(m, q, M, g, dmap, dcoords); break;
    default: warp_sample_bwd_kernel<0><<<blocks(M), kThreads, 0, s>>>(m, q, M, g, dmap, dcoords); break;
  }
  return (int)cudaGetLastError();
}
