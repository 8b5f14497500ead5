// JPEG coefficients to pixels, CUDA C++ for sm_90a.
//
// Not a port of a TPU kernel: the JAX package decodes photos with Pillow
// (libjpeg-turbo) on the host. This kernel is the parallel half of the
// port's decoder (materialrefgs_torch/utils/jpeg.py): after the host's
// Huffman decode (csrc/jpeg_entropy.cpp) it dequantises each block, runs
// libjpeg-turbo's integer inverse DCT (jidctint.c, jpeg_idct_islow:
// CONST_BITS 13, PASS1_BITS 2, the output saturated to 0..255 as its SIMD
// path does), upsamples chroma as jdsample.c's fancy filters do
// (h2v1, h1v2 and h2v2 triangles with their edge replication and rounding
// biases; box replication where libjpeg-turbo uses it) and converts YCbCr to
// RGB with jdcolor.c's integer tables (SCALEBITS 16). All integer
// arithmetic: the result equals the plain torch version
// (jpeg.idct_color_plain) and Pillow's decode bit for bit.
//
// Design (the first, simple one): launch 1, one thread per 8x8 block, both
// IDCT passes in registers, the 64 samples stored into the component's
// plane (bh*8 x bw*8 bytes, scratch); launch 2, one thread per output pixel,
// which reads its components' samples (two rows and two columns of the
// nearer and farther chroma samples for the fancy filters) and writes RGB.
//
// What bounds it on the H100: bytes. A block's 128 bytes of coefficients
// are read once and its 64 samples written, and each output pixel costs 3
// bytes written; the IDCT's ~12 multiplies and ~30 adds per 8 samples are
// far below the card's integer rate. The bound counts the coefficients read
// and the pixels written (the sample planes are scratch that stays in L2
// for a small photo, not for a 16-megapixel one).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxComp = 3;
enum { GRAY = 0, YCC = 1, RGB = 2 };
enum { FULL = 0, H2V1 = 1, H1V2 = 2, H2V2 = 3, BOX = 4 };

struct Comp {
  long long offset;  // first block (coefficients) and sample plane (x 64 bytes)
  int bw, bh;        // blocks per row, rows of blocks
  int dw, dh;        // real samples
  int rh, rv;        // upsampling ratio
  int mode;
};

struct Params {
  Comp c[kMaxComp];
  int ncomp;
  int height, width;
  int color;
  long long nblocks;
};

// jidctint.c's FIX(x) at CONST_BITS 13.
constexpr int F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270;
constexpr int F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137;
constexpr int F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// One jpeg_idct_islow pass on d[0..7] (stride s), outputs descaled by
// `shift` bits with rounding into o[0..7] (stride t).
__device__ __forceinline__ void idct_1d(const int* d, int s, int* o, int t, int shift) {
  int z2 = d[2 * s], z3 = d[6 * s];
  int z1 = (z2 + z3) * F0541;
  int tmp2 = z1 + z3 * -F1847;
  int tmp3 = z1 + z2 * F0765;
  int tmp0 = (d[0] + d[4 * s]) * (1 << 13);
  int tmp1 = (d[0] - d[4 * s]) * (1 << 13);
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = d[7 * s];
  tmp1 = d[5 * s];
  tmp2 = d[3 * s];
  tmp3 = d[1 * s];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int z4 = tmp1 + tmp3;
  const int z5 = (z3 + z4) * F1175;
  tmp0 = tmp0 * F0298;
  tmp1 = tmp1 * F2053;
  tmp2 = tmp2 * F3072;
  tmp3 = tmp3 * F1501;
  z1 = z1 * -F0899;
  z2 = z2 * -F2562;
  z3 = z3 * -F1961;
  z4 = z4 * -F0390;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  const int half = 1 << (shift - 1);
  o[0 * t] = (tmp10 + tmp3 + half) >> shift;
  o[7 * t] = (tmp10 - tmp3 + half) >> shift;
  o[1 * t] = (tmp11 + tmp2 + half) >> shift;
  o[6 * t] = (tmp11 - tmp2 + half) >> shift;
  o[2 * t] = (tmp12 + tmp1 + half) >> shift;
  o[5 * t] = (tmp12 - tmp1 + half) >> shift;
  o[3 * t] = (tmp13 + tmp0 + half) >> shift;
  o[4 * t] = (tmp13 - tmp0 + half) >> shift;
}

// The output range limit: v + CENTERJSAMPLE saturated to 0..255, as
// libjpeg-turbo's x86-64 SIMD IDCT (which Pillow runs) packs it; the C
// IDCT's table would wrap |v| >= 512 mod 1024 first, which no encoder of
// 8-bit samples reaches.
__device__ __forceinline__ uint32_t range_limit(int v) { return (uint32_t)min(max(v + 128, 0), 255); }

__global__ void idct_blocks(const int16_t* __restrict__ coef, const int* __restrict__ quant,
                            uint8_t* __restrict__ samples, Params p) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.nblocks) return;
  int ci = 0;
  if (p.ncomp > 1 && b >= p.c[1].offset) ci = (p.ncomp > 2 && b >= p.c[2].offset) ? 2 : 1;
  const Comp& c = p.c[ci];
  const long long local = b - c.offset;
  const int by = (int)(local / c.bw), bx = (int)(local % c.bw);

  int ws[64];
  const int4* src = reinterpret_cast<const int4*>(coef + b * 64);
  const int* q = quant + ci * 64;
#pragma unroll
  for (int i = 0; i < 8; i++) {  // 8 coefficients per 16-byte load
    const int4 v = src[i];
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; j++) {  // little-endian: the low half is the even coefficient
      ws[i * 8 + 2 * j] = (int)(int16_t)(w[j] & 0xFFFF) * q[i * 8 + 2 * j];
      ws[i * 8 + 2 * j + 1] = (w[j] >> 16) * q[i * 8 + 2 * j + 1];
    }
  }
  int tmp[64];
#pragma unroll
  for (int col = 0; col < 8; col++) idct_1d(ws + col, 8, tmp + col, 8, 11);  // columns
  const long long pitch = (long long)c.bw * 8;
  uint8_t* dst = samples + c.offset * 64 + (long long)by * 8 * pitch + bx * 8;
#pragma unroll
  for (int row = 0; row < 8; row++) {  // rows
    int o[8];
    idct_1d(tmp + row * 8, 1, o, 1, 18);
    uint2 packed;
    packed.x = range_limit(o[0]) | range_limit(o[1]) << 8 | range_limit(o[2]) << 16 | range_limit(o[3]) << 24;
    packed.y = range_limit(o[4]) | range_limit(o[5]) << 8 | range_limit(o[6]) << 16 | range_limit(o[7]) << 24;
    *reinterpret_cast<uint2*>(dst + row * pitch) = packed;
  }
}

__device__ __forceinline__ int sample(const uint8_t* plane, long long pitch, int y, int x) {
  return plane[(long long)y * pitch + x];
}

// A component's value at output pixel (y, x), as jdsample.c computes it.
__device__ int upsampled(const uint8_t* samples, const Comp& c, int y, int x) {
  const uint8_t* plane = samples + c.offset * 64;
  const long long pitch = (long long)c.bw * 8;
  switch (c.mode) {
    case FULL:
      return sample(plane, pitch, y, x);
    case H2V1: {
      const int j = x >> 1, odd = x & 1;
      const int jf = odd ? min(j + 1, c.dw - 1) : max(j - 1, 0);
      return (3 * sample(plane, pitch, y, j) + sample(plane, pitch, y, jf) + 1 + odd) >> 2;
    }
    case H1V2: {
      const int i = y >> 1, odd = y & 1;
      const int f = odd ? min(i + 1, c.dh - 1) : max(i - 1, 0);
      return (3 * sample(plane, pitch, i, x) + sample(plane, pitch, f, x) + 1 + odd) >> 2;
    }
    case H2V2: {
      const int i = y >> 1, j = x >> 1;
      const int f = (y & 1) ? min(i + 1, c.dh - 1) : max(i - 1, 0);
      const int jf = (x & 1) ? min(j + 1, c.dw - 1) : max(j - 1, 0);
      const int near = 3 * sample(plane, pitch, i, j) + sample(plane, pitch, f, j);
      const int far = 3 * sample(plane, pitch, i, jf) + sample(plane, pitch, f, jf);
      return (3 * near + far + ((x & 1) ? 7 : 8)) >> 4;
    }
    default:  // BOX
      return sample(plane, pitch, y / c.rv, x / c.rh);
  }
}

__global__ void upsample_color(const uint8_t* __restrict__ samples, uint8_t* __restrict__ out, Params p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.height * p.width) return;
  const int y = (int)(idx / p.width), x = (int)(idx % p.width);
  if (p.color == GRAY) {
    out[idx] = (uint8_t)upsampled(samples, p.c[0], y, x);
    return;
  }
  const int v0 = upsampled(samples, p.c[0], y, x);
  const int v1 = upsampled(samples, p.c[1], y, x);
  const int v2 = upsampled(samples, p.c[2], y, x);
  int r = v0, g = v1, b = v2;
  if (p.color == YCC) {  // jdcolor.c ycc_rgb_convert
    const int cb = v1 - 128, cr = v2 - 128;
    r = v0 + ((91881 * cr + 32768) >> 16);
    g = v0 + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
    b = v0 + ((116130 * cb + 32768) >> 16);
  }
  uint8_t* o = out + idx * 3;
  o[0] = (uint8_t)min(max(r, 0), 255);
  o[1] = (uint8_t)min(max(g, 0), 255);
  o[2] = (uint8_t)min(max(b, 0), 255);
}

}  // namespace

// comp: ncomp x 8 int32 on the host (offset, bw, bh, dw, dh, rh, rv, mode).
// samples: nblocks * 64 bytes of scratch; out: height x width (x 3) bytes.
extern "C" int jpeg_idct_color(const int16_t* coef, const int* quant, uint8_t* samples, uint8_t* out,
                               const int* comp, int ncomp, long long nblocks, int height, int width,
                               int color, void* stream) {
  if (ncomp < 1 || ncomp > kMaxComp || nblocks <= 0 || height <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  for (int i = 0; i < ncomp; i++) {
    const int* c = comp + 8 * i;
    p.c[i] = Comp{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
  }
  p.ncomp = ncomp;
  p.height = height;
  p.width = width;
  p.color = color;
  p.nblocks = nblocks;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  idct_blocks<<<(unsigned)((nblocks + threads - 1) / threads), threads, 0, s>>>(coef, quant, samples, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long pixels = (long long)height * width;
  upsample_color<<<(unsigned)((pixels + threads - 1) / threads), threads, 0, s>>>(samples, out, p);
  return (int)cudaGetLastError();
}
