// COLMAP sparse-model parsers for images.bin and points3D.bin, host C++
// behind a plain C interface (ctypes: materialrefgs_torch/data/native_io.py).
//
// The port's own copy of the two parsers in native/fastio.cpp (the JAX
// package's native loader): one pass over the file into buffers that the
// caller frees with colmap_free. The pure parser in data/colmap_loader.py
// loops in Python over every point and every 2D observation; a real model's
// points3D.bin holds hundreds of thousands of points.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local char g_err[256];

void set_err(const char* msg) { snprintf(g_err, sizeof(g_err), "%s", msg); }

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> out;
  FILE* f = fopen(path, "rb");
  if (!f) {
    set_err("cannot open file");
    return out;
  }
  fseek(f, 0, SEEK_END);
  const long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n > 0 ? n : 0);
  if (n > 0 && fread(out.data(), 1, n, f) != (size_t)n) {
    set_err("short read");
    out.clear();
  }
  fclose(f);
  return out;
}

}  // namespace

extern "C" {

const char* colmap_last_error() { return g_err; }

void colmap_free(void* p) { free(p); }

// points3D.bin -> xyz (N, 3) f64, rgb (N, 3) u8, error (N,) f64. Returns N,
// or -1 (colmap_last_error says why).
long long colmap_read_points3d(const char* path, double** xyz_out, uint8_t** rgb_out,
                               double** err_out) {
  g_err[0] = 0;
  auto buf = read_file(path);
  if (buf.size() < 8) {
    if (!g_err[0]) set_err("truncated header");
    return -1;
  }
  const uint8_t* p = buf.data();
  const uint8_t* end = p + buf.size();
  uint64_t n;
  memcpy(&n, p, 8);
  p += 8;
  // Each row is at least 51 bytes, so a count beyond that is corrupt (and
  // would overflow the sizes below).
  if (n > (uint64_t)(end - p) / 51) return set_err("bad point count"), -1;
  double* xyz = (double*)malloc(n * 3 * sizeof(double) + 1);
  uint8_t* rgb = (uint8_t*)malloc(n * 3 + 1);
  double* err = (double*)malloc(n * sizeof(double) + 1);
  if (!xyz || !rgb || !err) {
    free(xyz), free(rgb), free(err);
    return set_err("out of memory"), -1;
  }
  for (uint64_t i = 0; i < n; i++) {
    // point3D_id u64, xyz 3 f64, rgb 3 u8, error f64, track length u64,
    // then (image_id i32, point2D_idx i32) per track element.
    if (p + 51 > end) {
      set_err("truncated point");
      free(xyz), free(rgb), free(err);
      return -1;
    }
    p += 8;
    memcpy(xyz + i * 3, p, 24);
    p += 24;
    memcpy(rgb + i * 3, p, 3);
    p += 3;
    memcpy(err + i, p, 8);
    p += 8;
    uint64_t tl;
    memcpy(&tl, p, 8);
    p += 8;
    if (tl > (uint64_t)(end - p) / 8) {
      set_err("truncated track");
      free(xyz), free(rgb), free(err);
      return -1;
    }
    p += tl * 8;
  }
  *xyz_out = xyz;
  *rgb_out = rgb;
  *err_out = err;
  return (long long)n;
}

// images.bin -> image_id (N,) i32, qvec (N, 4) f64, tvec (N, 3) f64,
// camera_id (N,) i32 and the names, NUL-joined (names_len bytes). Returns
// N, or -1.
long long colmap_read_images(const char* path, int32_t** id_out, double** qvec_out,
                             double** tvec_out, int32_t** camid_out, char** names_out,
                             long long* names_len) {
  g_err[0] = 0;
  auto buf = read_file(path);
  if (buf.size() < 8) {
    if (!g_err[0]) set_err("truncated header");
    return -1;
  }
  const uint8_t* p = buf.data();
  const uint8_t* end = p + buf.size();
  uint64_t n;
  memcpy(&n, p, 8);
  p += 8;
  if (n > (uint64_t)(end - p) / 73) return set_err("bad image count"), -1;
  int32_t* ids = (int32_t*)malloc(n * 4 + 1);
  double* qv = (double*)malloc(n * 4 * sizeof(double) + 1);
  double* tv = (double*)malloc(n * 3 * sizeof(double) + 1);
  int32_t* cid = (int32_t*)malloc(n * 4 + 1);
  std::string names;
  const char* why = nullptr;
  if (!ids || !qv || !tv || !cid) why = "out of memory";
  for (uint64_t i = 0; i < n && !why; i++) {
    // image_id i32, qvec 4 f64, tvec 3 f64, camera_id i32, name NUL,
    // num_points2D u64, then (x f64, y f64, point3D_id i64) per point.
    if (p + 64 > end) {
      why = "truncated image";
      break;
    }
    memcpy(ids + i, p, 4);
    p += 4;
    memcpy(qv + i * 4, p, 32);
    p += 32;
    memcpy(tv + i * 3, p, 24);
    p += 24;
    memcpy(cid + i, p, 4);
    p += 4;
    const uint8_t* nul = (const uint8_t*)memchr(p, 0, end - p);
    if (!nul) {
      why = "truncated name";
      break;
    }
    names.append((const char*)p, nul - p);
    names.push_back('\0');
    p = nul + 1;
    if (p + 8 > end) {
      why = "truncated point count";
      break;
    }
    uint64_t npts;
    memcpy(&npts, p, 8);
    p += 8;
    if (npts > (uint64_t)(end - p) / 24) {
      why = "truncated 2D points";
      break;
    }
    p += npts * 24;
  }
  char* nb = why ? nullptr : (char*)malloc(names.size() + 1);
  if (!why && !nb) why = "out of memory";
  if (why) {
    set_err(why);
    free(ids), free(qv), free(tv), free(cid), free(nb);
    return -1;
  }
  memcpy(nb, names.data(), names.size());
  *id_out = ids;
  *qvec_out = qv;
  *tvec_out = tv;
  *camid_out = cid;
  *names_out = nb;
  *names_len = (long long)names.size();
  return (long long)n;
}

}  // extern "C"
