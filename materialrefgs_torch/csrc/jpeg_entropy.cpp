// JPEG Huffman entropy decoder, host C++ behind a plain C interface (ctypes:
// materialrefgs_torch/utils/jpeg.py).
//
// The JAX package reads photos through Pillow, whose libjpeg-turbo decodes
// them. The port splits that decode in two: this file turns one scan's
// entropy-coded segment into quantised DCT coefficients, and the card's
// kernel (csrc/jpeg_idct.cu) dequantises, inverse-transforms, upsamples and
// converts colour. Huffman decoding is sequential (every code's length is
// known only once the code before it is decoded), so it stays on the host;
// a restart-interval-parallel decode is later work.
//
// One call decodes one scan (ITU-T T.81 Annex F and G.1.2): baseline and
// extended sequential Huffman, progressive DC first/refine and AC
// first/refine (successive approximation, end-of-band runs), interleaved
// (MCU of h x v blocks per component) and non-interleaved scans (one block
// per MCU over the component's own ceil(w/8) x ceil(h/8) blocks), restart
// intervals (DC predictors and the EOB run reset at each RSTn), byte stuffing
// and fill bytes. Coefficients are written as int16 in natural (row-major)
// order into the caller's buffer, one 64-entry row per block, each
// component's blocks row-major from its block offset. Malformed data (a bad
// code, a coefficient index past 63, a missing or wrong restart marker, data
// that ends before the scan's last MCU) is an error, reported through
// jpeg_last_error(); nothing is guessed.
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

thread_local char g_err[256];

void set_err(const char* msg) { snprintf(g_err, sizeof(g_err), "%s", msg); }

// Zigzag index -> natural (row-major) position (T.81 Figure A.6).
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLook = 9;  // lookahead bits; longer codes take the slow path

struct Huff {
  uint8_t look_len[1 << kLook];  // 0: the code is longer than kLook bits
  uint8_t look_sym[1 << kLook];
  int32_t maxcode[18];  // largest code of each length, -1 where none
  int32_t valoffset[17];
  uint8_t vals[256];
};

// Build the decoding tables of one DHT table (T.81 Annex C and F.2.2.3).
bool build_huff(const uint8_t* bits, const uint8_t* vals, Huff* h) {
  memset(h->look_len, 0, sizeof(h->look_len));
  memcpy(h->vals, vals, 256);
  int32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    const int n = bits[l - 1];
    if (p + n > 256) return false;
    h->valoffset[l] = p - code;
    for (int i = 0; i < n; i++, p++, code++) {
      // Over-subscribed lengths, or an all-ones code (jdhuff.c refuses
      // both): refused before the code indexes the lookahead table.
      if (code >= (1 << l) - 1) return false;
      if (l <= kLook) {
        const int shift = kLook - l;
        for (int j = 0; j < (1 << shift); j++) {
          h->look_len[(code << shift) | j] = (uint8_t)l;
          h->look_sym[(code << shift) | j] = vals[p];
        }
      }
    }
    h->maxcode[l] = n ? code - 1 : -1;
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  return true;
}

struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;  // next byte to read
  uint64_t buf = 0;
  int bits = 0;     // valid bits, at the low end of buf
  int virt = 0;     // how many of the buffered bits are zeros past a marker
  bool marker = false;

  void fill() {
    while (bits <= 56) {
      int c = 0;
      if (!marker) {
        if (pos >= size) {
          marker = true;
        } else if (data[pos] != 0xFF) {
          c = data[pos++];
        } else {
          // 0xFF 0x00 is a stuffed data byte; fill bytes (more 0xFF) may
          // precede either it or a marker, which ends the segment.
          int64_t q = pos + 1;
          while (q < size && data[q] == 0xFF) q++;
          if (q < size && data[q] == 0) {
            c = 0xFF;
            pos = q + 1;
          } else {
            marker = true;
          }
        }
      }
      if (marker) virt += 8;
      buf = (buf << 8) | (uint64_t)c;
      bits += 8;
    }
  }
  // Bits consumed beyond the segment's data: the scan was cut short.
  bool overrun() const { return virt > bits; }
  uint32_t peek(int n) const { return (uint32_t)(buf >> (bits - n)) & ((1u << n) - 1); }
  uint32_t get(int n) {
    if (n == 0) return 0;
    if (bits < n) fill();
    const uint32_t v = peek(n);
    bits -= n;
    return v;
  }
  int decode(const Huff& h) {
    if (bits < 16) fill();
    const uint32_t look = peek(kLook);
    const int l = h.look_len[look];
    if (l) {
      bits -= l;
      return h.look_sym[look];
    }
    for (int n = kLook + 1; n <= 16; n++) {
      const int32_t code = (int32_t)peek(n);
      if (code <= h.maxcode[n]) {
        bits -= n;
        return h.vals[h.valoffset[n] + code];
      }
    }
    return -1;
  }
  // Restart: drop the interval's padding bits and read RSTn.
  bool restart(int n) {
    if (overrun()) return false;
    buf = 0;
    bits = 0;
    virt = 0;
    marker = false;
    while (pos + 1 < size && data[pos] == 0xFF && data[pos + 1] == 0xFF) pos++;
    if (pos + 1 >= size || data[pos] != 0xFF || data[pos + 1] != 0xD0 + (n & 7)) return false;
    pos += 2;
    return true;
  }
  // After the scan: the offset of the marker that follows its data.
  int64_t end() const {
    int64_t q = pos;
    while (q < size) {
      if (data[q] == 0xFF) {
        int64_t r = q + 1;
        while (r < size && data[r] == 0xFF) r++;
        if (r < size && data[r] != 0 && (data[r] < 0xD0 || data[r] > 0xD7)) return r - 1;
        q = r + 1;
      } else {
        q++;
      }
    }
    return size;
  }
};

inline int extend(uint32_t v, int s) {
  return (v < (1u << (s - 1))) ? (int)v - (1 << s) + 1 : (int)v;
}

struct ScanComp {
  int16_t* base;  // block (0, 0) of the component
  int bw;         // blocks per row of the component's plane
  int nbw, nbh;   // blocks a non-interleaved scan covers
  int h, v;       // sampling factors (blocks per MCU)
  const Huff* dc;
  const Huff* ac;
  int pred;
};

struct Scan {
  int ss, se, ah, al;
  bool progressive;
  int eobrun;
};

// One block of the scan into `blk` (natural order).
bool decode_block(BitReader& br, ScanComp& c, Scan& s, int16_t* blk) {
  if (!s.progressive) {
    const int t = br.decode(*c.dc);
    if (t < 0 || t > 15) return set_err("bad DC Huffman code"), false;
    c.pred += t ? extend(br.get(t), t) : 0;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; k++) {
      const int rs = br.decode(*c.ac);
      if (rs < 0) return set_err("bad AC Huffman code"), false;
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) return set_err("AC coefficient index past 63"), false;
        blk[kNatural[k]] = (int16_t)extend(br.get(sz), sz);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return true;
  }
  if (s.ss == 0) {  // DC scans (G.1.2.1)
    if (s.ah == 0) {
      const int t = br.decode(*c.dc);
      if (t < 0 || t > 15) return set_err("bad DC Huffman code"), false;
      c.pred += t ? extend(br.get(t), t) : 0;
      blk[0] = (int16_t)(c.pred * (1 << s.al));
    } else if (br.get(1)) {
      blk[0] = (int16_t)(blk[0] | (1 << s.al));
    }
    return true;
  }
  if (s.ah == 0) {  // AC first (G.1.2.2)
    if (s.eobrun > 0) {
      s.eobrun--;
      return true;
    }
    for (int k = s.ss; k <= s.se; k++) {
      const int rs = br.decode(*c.ac);
      if (rs < 0) return set_err("bad AC Huffman code"), false;
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) return set_err("AC coefficient index past 63"), false;
        blk[kNatural[k]] = (int16_t)(extend(br.get(sz), sz) * (1 << s.al));
      } else if (r == 15) {
        k += 15;
      } else {
        s.eobrun = (1 << r) - 1;
        if (r) s.eobrun += (int)br.get(r);
        break;
      }
    }
    return true;
  }
  // AC refinement (G.1.2.3): correction bits for coefficients already
  // nonzero, newly nonzero ones of magnitude 1 << al.
  const int p1 = 1 << s.al, m1 = -(1 << s.al);
  int k = s.ss;
  if (s.eobrun == 0) {
    for (; k <= s.se; k++) {
      const int rs = br.decode(*c.ac);
      if (rs < 0) return set_err("bad AC Huffman code"), false;
      int r = rs >> 4, sz = rs & 15, val = 0;
      if (sz) {
        if (sz != 1) return set_err("AC refinement symbol of size other than 1"), false;
        val = br.get(1) ? p1 : m1;
      } else if (r != 15) {
        s.eobrun = 1 << r;
        if (r) s.eobrun += (int)br.get(r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= s.se);
      if (val) {
        if (k > s.se) return set_err("AC refinement past the end of the band"), false;
        blk[kNatural[k]] = (int16_t)val;
      }
    }
  }
  if (s.eobrun > 0) {
    for (; k <= s.se; k++) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0) {
        if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
      }
    }
    s.eobrun--;
  }
  return true;
}

}  // namespace

extern "C" {

const char* jpeg_last_error() { return g_err; }

// Decode one scan whose entropy-coded data starts at data[pos]. comp holds 8
// int32 per scan component: block offset (in blocks, from coef), plane width
// in blocks, non-interleaved width and height in blocks, h, v, DC table,
// AC table. tables: 8 DHT tables of 16 counts + 256 values (0-3 DC, 4-7
// AC); present[i] != 0 where table i was defined. Returns the offset of the
// marker after the scan's data, or -1 (jpeg_last_error says why).
long long jpeg_decode_scan(const uint8_t* data, long long size, long long pos, int16_t* coef,
                           int ncomp, const int32_t* comp, const uint8_t* tables,
                           const int32_t* present, int mcus_x, int mcus_y, int restart_interval,
                           int ss, int se, int ah, int al, int progressive) {
  g_err[0] = 0;
  if (ncomp < 1 || ncomp > 4) return set_err("bad component count in scan"), -1;
  static thread_local Huff huff[8];
  bool built[8] = {false};
  ScanComp sc[4];
  for (int i = 0; i < ncomp; i++) {
    const int32_t* c = comp + 8 * i;
    sc[i].base = coef + (int64_t)c[0] * 64;
    sc[i].bw = c[1];
    sc[i].nbw = c[2];
    sc[i].nbh = c[3];
    sc[i].h = c[4];
    sc[i].v = c[5];
    sc[i].pred = 0;
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss > 0;
    for (int which = 0; which < 2; which++) {
      const bool need = which == 0 ? need_dc : need_ac;
      const int sel = c[6 + which];
      if (sel < 0 || sel > 3) return set_err("bad Huffman table selector in scan"), -1;
      if (!need) continue;
      const int id = 4 * which + sel;
      if (!present[id]) return set_err("scan uses an undefined Huffman table"), -1;
      if (!built[id]) {
        if (!build_huff(tables + 272 * id, tables + 272 * id + 16, &huff[id]))
          return set_err("malformed Huffman table"), -1;
        built[id] = true;
      }
    }
    sc[i].dc = &huff[c[6]];
    sc[i].ac = &huff[4 + c[7]];
  }
  BitReader br;
  br.data = data;
  br.size = size;
  br.pos = pos;
  Scan s{ss, se, ah, al, progressive != 0, 0};
  const int64_t n_mcu =
      ncomp == 1 ? (int64_t)sc[0].nbw * sc[0].nbh : (int64_t)mcus_x * mcus_y;
  int next_rst = 0;
  for (int64_t m = 0; m < n_mcu; m++) {
    if (restart_interval && m > 0 && m % restart_interval == 0) {
      if (!br.restart(next_rst++)) return set_err("missing or out-of-order restart marker"), -1;
      for (int i = 0; i < ncomp; i++) sc[i].pred = 0;
      s.eobrun = 0;
    }
    if (ncomp == 1) {
      ScanComp& c = sc[0];
      const int64_t by = m / c.nbw, bx = m % c.nbw;
      if (!decode_block(br, c, s, c.base + (by * c.bw + bx) * 64)) return -1;
    } else {
      const int64_t my = m / mcus_x, mx = m % mcus_x;
      for (int i = 0; i < ncomp; i++) {
        ScanComp& c = sc[i];
        for (int y = 0; y < c.v; y++)
          for (int x = 0; x < c.h; x++) {
            const int64_t by = my * c.v + y, bx = mx * c.h + x;
            if (!decode_block(br, c, s, c.base + (by * c.bw + bx) * 64)) return -1;
          }
      }
    }
  }
  if (br.overrun()) return set_err("entropy-coded data ends before the scan's last block"), -1;
  return br.end();
}

}  // extern "C"
