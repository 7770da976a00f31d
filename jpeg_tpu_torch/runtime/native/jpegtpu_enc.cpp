// jpeg_tpu native runtime: baseline JPEG entropy ENCODER.
//
// The reference never built an encoder (its forward DCT is dead code,
// src/transform.rs:18-53). This implements the host half of the TPU encode
// pipeline: quantized coefficients arrive as per-component natural-order
// int16 planes (the same layout the TPU forward-DCT kernel emits and the
// decoder's entropy stage consumes), and this library performs zigzag
// readout, DC prediction, run-length + magnitude coding, Huffman bit packing
// with 0xFF00 stuffing, and restart markers — parallel across restart
// segments (each segment is byte-aligned and DC-reset, so segments encode
// independently and concatenate; JPEG F.2.1.3.1).
//
// Built as its own .so (see build.py) and driven via ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kZigRow[64] = {
    0, 0, 1, 2, 1, 0, 0, 1, 2, 3, 4, 3, 2, 1, 0, 0, 1, 2, 3, 4, 5, 6,
    5, 4, 3, 2, 1, 0, 0, 1, 2, 3, 4, 5, 6, 7, 7, 6, 5, 4, 3, 2, 1, 2,
    3, 4, 5, 6, 7, 7, 6, 5, 4, 3, 4, 5, 6, 7, 7, 6, 5, 6, 7, 7};
constexpr uint8_t kZigCol[64] = {
    0, 1, 0, 0, 1, 2, 3, 2, 1, 0, 0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0, 0,
    1, 2, 3, 4, 5, 6, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 6, 7, 7,
    6, 5, 4, 3, 2, 3, 4, 5, 6, 7, 7, 6, 5, 4, 5, 6, 7, 7, 6, 7};

// MSB-first bit packer with JPEG byte stuffing (B.1.1.5).
struct BitWriter {
  uint8_t* out;
  int64_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;

  explicit BitWriter(uint8_t* buf) : out(buf) {}

  inline void put(uint32_t code, int len) {
    acc = (acc << len) | (code & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      nbits -= 8;
      uint8_t b = (uint8_t)(acc >> nbits);
      out[pos++] = b;
      if (b == 0xFF) out[pos++] = 0x00;  // stuffing
    }
    acc &= (1u << nbits) - 1;
  }
  inline void flush() {  // pad final byte with 1-bits (F.1.2.3)
    if (nbits) {
      int pad = 8 - nbits;
      put((1u << pad) - 1, pad);
    }
  }
};

inline int magnitude(int32_t v) {
  uint32_t a = v < 0 ? -v : v;
  return a == 0 ? 0 : 32 - __builtin_clz(a);
}

struct EncJob {
  const int16_t* const* planes;  // [n_comp] natural-order quantized coeffs
  const int64_t* plane_stride;
  const uint8_t* slot_comp;  // [bpm]
  const uint8_t* slot_vi;
  const uint8_t* slot_hi;
  int32_t blocks_per_mcu;
  const uint8_t* comp_h;
  const uint8_t* comp_v;
  int32_t n_comp;
  int32_t mcus_x;
  int64_t n_mcus;
  int32_t restart_interval;  // MCUs per segment (0 = single segment)
  // Encode tables: symbol -> (code, length), [tid][256]
  const uint32_t* dc_code;  // [2][256] (table 0 luma, 1 chroma)
  const uint8_t* dc_len;
  const uint32_t* ac_code;
  const uint8_t* ac_len;
  const uint8_t* comp_tid;  // [n_comp] 0/1 table selector
  uint8_t* out;             // per-segment scratch, seg_capacity each
  int64_t seg_capacity;
  int64_t* seg_bytes;  // [n_segs] out: bytes written per segment
};

inline void encode_block(BitWriter& bw, const int16_t* blk, int64_t stride,
                         int32_t* prev_dc, const uint32_t* dc_code,
                         const uint8_t* dc_len, const uint32_t* ac_code,
                         const uint8_t* ac_len) {
  int32_t dc = blk[0];
  int32_t diff = dc - *prev_dc;
  *prev_dc = dc;
  int size = magnitude(diff);
  bw.put(dc_code[size], dc_len[size]);
  if (size) {
    int32_t v = diff < 0 ? diff + (1 << size) - 1 : diff;
    bw.put((uint32_t)v, size);
  }
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int32_t v = blk[kZigRow[k] * stride + kZigCol[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run >= 16) {
      bw.put(ac_code[0xF0], ac_len[0xF0]);  // ZRL
      run -= 16;
    }
    int s = magnitude(v);
    int sym = (run << 4) | s;
    bw.put(ac_code[sym], ac_len[sym]);
    int32_t m = v < 0 ? v + (1 << s) - 1 : v;
    bw.put((uint32_t)m, s);
    run = 0;
  }
  if (run) bw.put(ac_code[0x00], ac_len[0x00]);  // EOB
}

void encode_segments(const EncJob& job, int64_t seg_lo, int64_t seg_hi,
                     int64_t ri) {
  for (int64_t s = seg_lo; s < seg_hi; ++s) {
    int64_t mcu0 = s * ri;
    int64_t mcu1 = std::min<int64_t>(mcu0 + ri, job.n_mcus);
    BitWriter bw(job.out + s * job.seg_capacity);
    int32_t prev_dc[4] = {0, 0, 0, 0};
    for (int64_t mcu = mcu0; mcu < mcu1; ++mcu) {
      int64_t my = mcu / job.mcus_x;
      int64_t mx = mcu % job.mcus_x;
      for (int slot = 0; slot < job.blocks_per_mcu; ++slot) {
        int c = job.slot_comp[slot];
        int tid = job.comp_tid[c];
        int64_t st = job.plane_stride[c];
        int64_t by = my * job.comp_v[c] + job.slot_vi[slot];
        int64_t bx = mx * job.comp_h[c] + job.slot_hi[slot];
        const int16_t* blk = job.planes[c] + by * 8 * st + bx * 8;
        encode_block(bw, blk, st, &prev_dc[c], job.dc_code + tid * 256,
                     job.dc_len + tid * 256, job.ac_code + tid * 256,
                     job.ac_len + tid * 256);
      }
    }
    bw.flush();
    job.seg_bytes[s] = bw.pos;
  }
}

}  // namespace


// ---------------------------------------------------------------------------
// Arithmetic (SOF9) entropy ENCODE: QM coder duals of the decode models
// (see jpeg_tpu/entropy/arith.py for the verified register semantics).

struct QeEntryE {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr QeEntryE kQeTableE[114] = {
    {0x5A1D, 1, 1, 1}, {0x2586, 2, 14, 0}, {0x1114, 3, 16, 0}, {0x080B, 4, 18, 0},
    {0x03D8, 5, 20, 0}, {0x01DA, 6, 23, 0}, {0x00E5, 7, 25, 0}, {0x006F, 8, 28, 0},
    {0x0036, 9, 30, 0}, {0x001A, 10, 33, 0}, {0x000D, 11, 35, 0}, {0x0006, 12, 9, 0},
    {0x0003, 13, 10, 0}, {0x0001, 13, 12, 0}, {0x5A7F, 15, 15, 1}, {0x3F25, 16, 36, 0},
    {0x2CF2, 17, 38, 0}, {0x207C, 18, 39, 0}, {0x17B9, 19, 40, 0}, {0x1182, 20, 42, 0},
    {0x0CEF, 21, 43, 0}, {0x09A1, 22, 45, 0}, {0x072F, 23, 46, 0}, {0x055C, 24, 48, 0},
    {0x0406, 25, 49, 0}, {0x0303, 26, 51, 0}, {0x0240, 27, 52, 0}, {0x01B1, 28, 54, 0},
    {0x0144, 29, 56, 0}, {0x00F5, 30, 57, 0}, {0x00B7, 31, 59, 0}, {0x008A, 32, 60, 0},
    {0x0068, 33, 62, 0}, {0x004E, 34, 63, 0}, {0x003B, 35, 32, 0}, {0x002C, 9, 33, 0},
    {0x5AE1, 37, 37, 1}, {0x484C, 38, 64, 0}, {0x3A0D, 39, 65, 0}, {0x2EF1, 40, 67, 0},
    {0x261F, 41, 68, 0}, {0x1F33, 42, 69, 0}, {0x19A8, 43, 70, 0}, {0x1518, 44, 72, 0},
    {0x1177, 45, 73, 0}, {0x0E74, 46, 74, 0}, {0x0BFB, 47, 75, 0}, {0x09F8, 48, 77, 0},
    {0x0861, 49, 78, 0}, {0x0706, 50, 79, 0}, {0x05CD, 51, 48, 0}, {0x04DE, 52, 50, 0},
    {0x040F, 53, 50, 0}, {0x0363, 54, 51, 0}, {0x02D4, 55, 52, 0}, {0x025C, 56, 53, 0},
    {0x01F8, 57, 54, 0}, {0x01A4, 58, 55, 0}, {0x0160, 59, 56, 0}, {0x0125, 60, 57, 0},
    {0x00F6, 61, 58, 0}, {0x00CB, 62, 59, 0}, {0x00AB, 63, 61, 0}, {0x008F, 32, 61, 0},
    {0x5B12, 65, 65, 1}, {0x4D04, 66, 80, 0}, {0x412C, 67, 81, 0}, {0x37D8, 68, 82, 0},
    {0x2FE8, 69, 83, 0}, {0x293C, 70, 84, 0}, {0x2379, 71, 86, 0}, {0x1EDF, 72, 87, 0},
    {0x1AA9, 73, 87, 0}, {0x174E, 74, 72, 0}, {0x1424, 75, 72, 0}, {0x119C, 76, 74, 0},
    {0x0F6B, 77, 74, 0}, {0x0D51, 78, 75, 0}, {0x0BB6, 79, 77, 0}, {0x0A40, 48, 77, 0},
    {0x5832, 81, 80, 1}, {0x4D1C, 82, 88, 0}, {0x438E, 83, 89, 0}, {0x3BDD, 84, 90, 0},
    {0x34EE, 85, 91, 0}, {0x2EAE, 86, 92, 0}, {0x299A, 87, 93, 0}, {0x2516, 71, 86, 0},
    {0x5570, 89, 88, 1}, {0x4CA9, 90, 95, 0}, {0x44D9, 91, 96, 0}, {0x3E22, 92, 97, 0},
    {0x3824, 93, 99, 0}, {0x32B4, 94, 99, 0}, {0x2E17, 86, 93, 0}, {0x56A8, 96, 95, 1},
    {0x4F46, 97, 101, 0}, {0x47E5, 98, 102, 0}, {0x41CF, 99, 103, 0}, {0x3C3D, 100, 104, 0},
    {0x375E, 93, 99, 0}, {0x5231, 102, 105, 0}, {0x4C0F, 103, 106, 0}, {0x4639, 104, 107, 0},
    {0x415E, 99, 103, 0}, {0x5627, 106, 105, 1}, {0x50E7, 107, 108, 0}, {0x4B85, 103, 109, 0},
    {0x5597, 109, 110, 0}, {0x504F, 107, 111, 0}, {0x5A10, 111, 110, 1}, {0x5522, 109, 112, 0},
    {0x59EB, 111, 112, 1}, {0x5A1D, 113, 113, 0},
};
constexpr uint8_t kFixedBinE = 113;

struct QMEncoder {
  int64_t c = 0, a = 0x10000;
  int64_t sc = 0, zc = 0;
  int ct = 11;
  int buffer = -1;
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  bool overflow = false;

  QMEncoder(uint8_t* o, int64_t capacity) : out(o), cap(capacity) {}

  inline void emit(uint8_t b) {
    if (__builtin_expect(n < cap, 1)) out[n++] = b;
    else overflow = true;
  }
  inline void flush_zc() {
    while (zc) {
      emit(0);
      --zc;
    }
  }
  void byte_out() {
    int64_t temp = c >> 19;
    if (temp > 0xFF) {
      if (buffer >= 0) {
        flush_zc();
        emit((uint8_t)(buffer + 1));
        if (buffer + 1 == 0xFF) emit(0);
      }
      zc += sc;
      sc = 0;
      buffer = (int)(temp & 0xFF);
    } else if (temp == 0xFF) {
      ++sc;
    } else {
      if (buffer == 0) {
        ++zc;
      } else if (buffer > 0) {
        flush_zc();
        emit((uint8_t)buffer);
      }
      if (sc) {
        flush_zc();
        while (sc) {
          emit(0xFF);
          emit(0);
          --sc;
        }
      }
      buffer = (int)temp;
    }
    c &= 0x7FFFF;
    ct = 8;
  }
  void encode(uint8_t* st, int bit) {
    uint8_t sv = *st;
    const QeEntryE e = kQeTableE[sv & 0x7F];
    a -= e.qe;
    if (bit != (sv >> 7)) {
      if (a >= e.qe) {
        c += a;
        a = e.qe;
      }
      *st = (uint8_t)((e.sw ? ((sv & 0x80) ^ 0x80) : (sv & 0x80)) | e.nlps);
    } else {
      if (a >= 0x8000) return;
      if (a < e.qe) {
        c += a;
        a = e.qe;
      }
      *st = (sv & 0x80) | e.nmps;
    }
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byte_out();
    } while (a < 0x8000);
  }
  void finish() {
    int64_t temp = (a - 1 + c) & 0xFFFF0000;
    c = (temp < c) ? temp + 0x8000 : temp;
    c <<= ct;
    if (c & 0xF8000000LL) {
      if (buffer >= 0) {
        flush_zc();
        emit((uint8_t)(buffer + 1));
        if (buffer + 1 == 0xFF) emit(0);
      }
      zc += sc;
      sc = 0;
    } else {
      if (buffer == 0) {
        ++zc;
      } else if (buffer > 0) {
        flush_zc();
        emit((uint8_t)buffer);
      }
      if (sc) {
        flush_zc();
        while (sc) {
          emit(0xFF);
          emit(0);
          --sc;
        }
      }
    }
    if (c & 0x7FFF800LL) {
      flush_zc();
      uint8_t b = (uint8_t)((c >> 19) & 0xFF);
      emit(b);
      if (b == 0xFF) emit(0);
      if (c & 0x7F800LL) {
        b = (uint8_t)((c >> 11) & 0xFF);
        emit(b);
        if (b == 0xFF) emit(0);
      }
    }
  }
};

struct EArithStats {
  uint8_t dc[4][64];
  uint8_t ac[4][256];
  uint8_t fixed;
  int32_t ctx[8];
  int32_t last_dc[8];
  void reset() {
    std::memset(this, 0, sizeof(*this));
    fixed = kFixedBinE;
  }
};

inline void qm_encode_dc(QMEncoder& enc, EArithStats& s, int tbl, int ci,
                         int L, int U, int dc) {
  uint8_t* st = s.dc[tbl];
  int base = s.ctx[ci];
  int diff = dc - s.last_dc[ci];
  s.last_dc[ci] = dc;
  if (diff == 0) {
    enc.encode(st + base, 0);
    s.ctx[ci] = 0;
    return;
  }
  enc.encode(st + base, 1);
  int sign = diff < 0;
  enc.encode(st + base + 1, sign);
  int v = (sign ? -diff : diff) - 1;
  int i = base + 2 + sign;
  int m;
  if (v == 0) {
    enc.encode(st + i, 0);
    m = 0;
  } else {
    enc.encode(st + i, 1);
    m = 1;
    i = 20;
    while ((m << 1) <= v) {
      enc.encode(st + i, 1);
      m <<= 1;
      ++i;
    }
    enc.encode(st + i, 0);
  }
  if (m < (1 << L) >> 1) s.ctx[ci] = 0;
  else if (m > (1 << U) >> 1) s.ctx[ci] = 12 + sign * 4;
  else s.ctx[ci] = 4 + sign * 4;
  i += 14;
  for (int mm = m >> 1; mm; mm >>= 1)
    enc.encode(st + i, (v & mm) ? 1 : 0);
}

inline void qm_encode_ac(QMEncoder& enc, EArithStats& s, int tbl, int kx,
                         const int16_t* blk, int64_t stride) {
  uint8_t* st_ac = s.ac[tbl];
  int ke = 0;
  for (int k = 63; k > 0; --k) {
    if (blk[kZigRow[k] * stride + kZigCol[k]]) {
      ke = k;
      break;
    }
  }
  int k = 1;
  while (k <= ke) {
    uint8_t* st = st_ac + 3 * (k - 1);
    enc.encode(st, 0);  // not EOB
    int val;
    while ((val = blk[kZigRow[k] * stride + kZigCol[k]]) == 0) {
      enc.encode(st + 1, 0);
      st += 3;
      ++k;
    }
    enc.encode(st + 1, 1);
    int sign = val < 0;
    enc.encode(&s.fixed, sign);
    int v = (sign ? -val : val) - 1;
    st += 2;
    int m;
    if (v == 0) {
      enc.encode(st, 0);
      m = 0;
    } else {
      enc.encode(st, 1);
      if (v == 1) {
        enc.encode(st, 0);
        m = 1;
      } else {
        enc.encode(st, 1);
        m = 2;
        st = st_ac + (k <= kx ? 189 : 217);
        while ((m << 1) <= v) {
          enc.encode(st, 1);
          m <<= 1;
          ++st;
        }
        enc.encode(st, 0);
      }
    }
    st += 14;
    for (int mm = m >> 1; mm; mm >>= 1)
      enc.encode(st, (v & mm) ? 1 : 0);
    ++k;
  }
  if (ke < 63) enc.encode(st_ac + 3 * (k - 1), 1);  // EOB
}

extern "C" {

// Encode all restart segments in parallel. `out` must hold n_segs *
// seg_capacity bytes; per-segment lengths land in seg_bytes. Returns 0, or
// -1 if any segment overran seg_capacity (caller retries with more room).

// Arithmetic sequential scan encode from natural-order int16 planes.
// Per-segment output buffers (seg_capacity each, like jt_encode_scan);
// returns 0 ok, -1 if any segment overflowed its buffer.
int32_t jt_encode_arith_scan(
    const int16_t* const* planes, const int64_t* plane_stride,
    const uint8_t* slot_comp, const uint8_t* slot_vi, const uint8_t* slot_hi,
    int32_t blocks_per_mcu, const uint8_t* comp_h, const uint8_t* comp_v,
    int32_t n_comp, int32_t mcus_x, int64_t n_mcus, int32_t restart_interval,
    const uint8_t* comp_tid, const uint8_t* dc_L, const uint8_t* dc_U,
    const uint8_t* ac_K, uint8_t* out, int64_t seg_capacity,
    int64_t* seg_bytes, int32_t n_threads) {
  (void)n_comp;
  int64_t ri = restart_interval > 0 ? restart_interval : n_mcus;
  int64_t n_segs = (n_mcus + ri - 1) / ri;
  std::atomic<int32_t> bad(0);
  auto work = [&](int64_t lo, int64_t hi) {
    EArithStats stats;
    for (int64_t sgi = lo; sgi < hi; ++sgi) {
      QMEncoder enc(out + sgi * seg_capacity, seg_capacity);
      stats.reset();
      int64_t mcu0 = sgi * ri;
      int64_t mcu1 = std::min(n_mcus, mcu0 + ri);
      for (int64_t mcu = mcu0; mcu < mcu1; ++mcu) {
        int64_t my = mcu / mcus_x;
        int64_t mx = mcu % mcus_x;
        for (int slot = 0; slot < blocks_per_mcu; ++slot) {
          int ci = slot_comp[slot];
          int tid = comp_tid[ci];
          int64_t st = plane_stride[ci];
          int64_t by = my * comp_v[ci] + slot_vi[slot];
          int64_t bx = mx * comp_h[ci] + slot_hi[slot];
          const int16_t* blk = planes[ci] + by * 8 * st + bx * 8;
          qm_encode_dc(enc, stats, tid, ci, dc_L[tid], dc_U[tid],
                       blk[0]);
          qm_encode_ac(enc, stats, tid, ac_K[tid], blk, st);
        }
      }
      enc.finish();
      seg_bytes[sgi] = enc.n;
      if (enc.overflow) bad.store(1);
    }
  };
  int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_segs);
  if (nt <= 1) {
    work(0, n_segs);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t)
      threads.emplace_back(work, n_segs * t / nt, n_segs * (t + 1) / nt);
    for (auto& th : threads) th.join();
  }
  return bad.load() ? -1 : 0;
}

int32_t jt_encode_scan(const int16_t* const* planes,
                       const int64_t* plane_stride, const uint8_t* slot_comp,
                       const uint8_t* slot_vi, const uint8_t* slot_hi,
                       int32_t blocks_per_mcu, const uint8_t* comp_h,
                       const uint8_t* comp_v, int32_t n_comp, int32_t mcus_x,
                       int64_t n_mcus, int32_t restart_interval,
                       const uint32_t* dc_code, const uint8_t* dc_len,
                       const uint32_t* ac_code, const uint8_t* ac_len,
                       const uint8_t* comp_tid, uint8_t* out,
                       int64_t seg_capacity, int64_t* seg_bytes,
                       int32_t n_threads) {
  int64_t ri = restart_interval > 0 ? restart_interval : n_mcus;
  int64_t n_segs = (n_mcus + ri - 1) / ri;
  EncJob job{planes,  plane_stride, slot_comp, slot_vi, slot_hi,
             blocks_per_mcu, comp_h, comp_v,   n_comp,  mcus_x,
             n_mcus,  restart_interval,        dc_code, dc_len,
             ac_code, ac_len,       comp_tid,  out,     seg_capacity,
             seg_bytes};
  int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_segs);
  if (nt <= 1) {
    encode_segments(job, 0, n_segs, ri);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) {
      int64_t lo = n_segs * t / nt;
      int64_t hi = n_segs * (t + 1) / nt;
      threads.emplace_back(encode_segments, std::cref(job), lo, hi, ri);
    }
    for (auto& th : threads) th.join();
  }
  for (int64_t s = 0; s < n_segs; ++s) {
    if (seg_bytes[s] > seg_capacity - 2) return -1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Progressive (SOF2) entropy ENCODE — C++ port of
// jpeg_tpu.entropy.progressive_encode (the Python oracle; byte-identical).
// mode 0 = statistics pass (freq[256] out), mode 1 = emit pass.

namespace {

inline int nbits_u(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

struct ProgEmit {
  int mode;             // 0 = count, 1 = emit
  int64_t* freq;        // [256] (count mode)
  const uint32_t* code;  // [256] (emit mode)
  const uint8_t* len;
  uint8_t* out;
  int64_t pos = 0;
  uint64_t acc = 0;
  int nb = 0;

  inline void symbol(int sym) {
    if (mode == 0) {
      ++freq[sym];
    } else {
      bits(code[sym], len[sym]);
    }
  }
  inline void bits(uint32_t v, int n) {
    if (mode == 0 || n == 0) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    nb += n;
    while (nb >= 8) {
      nb -= 8;
      uint8_t b = (uint8_t)(acc >> nb);
      out[pos++] = b;
      if (b == 0xFF) out[pos++] = 0x00;
    }
    acc &= (1u << nb) - 1;
  }
  inline void flush() {
    if (mode == 1 && nb) {
      int pad = 8 - nb;
      bits((1u << pad) - 1, pad);
    }
  }
};

}  // namespace

// AC scan encode (first or refine). blocks: [n_blocks] in raster order over
// the comp grid ([rows, cols, 64] int32, row stride cols*64). Returns bytes
// written (emit) or 0 (count).
int64_t jt_encode_prog_ac(
    const int32_t* state, int64_t cols, int64_t bw, int64_t u0, int64_t u1,
    int32_t ss, int32_t se, int32_t ah, int32_t al, int32_t mode,
    int64_t* freq, const uint32_t* code, const uint8_t* len, uint8_t* out) {
  ProgEmit em{mode, freq, code, len, out};
  int64_t eobrun = 0;
  // Pending correction bits across EOB runs (refine): worst case 63/block,
  // EOBRUN <= 0x7FFF blocks.
  std::vector<uint8_t> pending;
  auto emit_eobrun = [&]() {
    if (eobrun > 0) {
      int n = nbits_u((uint32_t)eobrun) - 1;
      em.symbol(n << 4);
      if (n) em.bits((uint32_t)(eobrun & ((1 << n) - 1)), n);
      for (uint8_t b : pending) em.bits(b, 1);
      pending.clear();
      eobrun = 0;
    }
  };
  for (int64_t bi = u0; bi < u1; ++bi) {
    int64_t by = bi / bw, bx = bi % bw;
    const int32_t* coef = state + (by * cols + bx) * 64;
    if (ah == 0) {
      int r = 0;
      for (int k = ss; k <= se; ++k) {
        int32_t t = coef[k];
        uint32_t temp, temp2;
        if (t < 0) {
          temp = (uint32_t)(-t) >> al;
          temp2 = ~temp;
        } else {
          temp = (uint32_t)t >> al;
          temp2 = temp;
        }
        if (temp == 0) {
          ++r;
          continue;
        }
        emit_eobrun();
        while (r > 15) {
          em.symbol(0xF0);
          r -= 16;
        }
        int s = nbits_u(temp);
        em.symbol((r << 4) + s);
        em.bits(temp2 & ((1u << s) - 1), s);
        r = 0;
      }
      if (r > 0) {
        ++eobrun;
        if (eobrun == 0x7FFF) emit_eobrun();
      }
    } else {
      uint32_t absv[64];
      int eob = ss - 1;
      for (int k = ss; k <= se; ++k) {
        int32_t t = coef[k];
        uint32_t a = (uint32_t)(t < 0 ? -t : t) >> al;
        absv[k] = a;
        if (a == 1) eob = k;
      }
      int r = 0;
      std::vector<uint8_t> br;
      for (int k = ss; k <= se; ++k) {
        uint32_t temp = absv[k];
        if (temp == 0) {
          ++r;
          continue;
        }
        while (r > 15 && k <= eob) {
          emit_eobrun();
          em.symbol(0xF0);
          r -= 16;
          for (uint8_t b : br) em.bits(b, 1);
          br.clear();
        }
        if (temp > 1) {
          br.push_back((uint8_t)(temp & 1));
          continue;
        }
        emit_eobrun();
        em.symbol((r << 4) + 1);
        r = 0;
        em.bits(coef[k] < 0 ? 0 : 1, 1);
        for (uint8_t b : br) em.bits(b, 1);
        br.clear();
      }
      if (r > 0 || !br.empty()) {
        ++eobrun;
        pending.insert(pending.end(), br.begin(), br.end());
        if (eobrun == 0x7FFF) emit_eobrun();
      }
    }
  }
  emit_eobrun();
  em.flush();
  return em.pos;
}

// DC scan encode. Units iterate like the decoder's jt_decode_prog_dc.
// Per-scan-component symbol tables for count/emit (dc refinement uses none).
int64_t jt_encode_prog_dc(
    const int32_t* const* state, const int64_t* state_cols,
    int32_t n_scan_comps, const int32_t* comp_h, const int32_t* comp_v,
    int32_t mcus_x, int64_t u0, int64_t u1, int32_t interleaved,
    const int64_t* comp_bw, int32_t ah, int32_t al, int32_t mode,
    int64_t* const* freqs, const uint32_t* const* codes,
    const uint8_t* const* lens, uint8_t* out) {
  ProgEmit em{mode, nullptr, nullptr, nullptr, out};
  int64_t pred[4] = {0, 0, 0, 0};
  auto one = [&](int si, int32_t dc) {
    if (ah == 0) {
      int64_t v = dc >> al;  // arithmetic shift
      int64_t diff = v - pred[si];
      pred[si] = v;
      uint32_t mag = (uint32_t)(diff < 0 ? -diff : diff);
      int s = nbits_u(mag);
      if (mode == 0) {
        ++freqs[si][s];
      } else {
        em.bits(codes[si][s], lens[si][s]);
      }
      if (s) {
        em.bits((uint32_t)(diff < 0 ? diff + (1 << s) - 1 : diff), s);
      }
    } else {
      em.bits((uint32_t)((dc >> al) & 1), 1);
    }
  };
  for (int64_t u = u0; u < u1; ++u) {
    if (interleaved) {
      int64_t my = u / mcus_x, mx = u % mcus_x;
      for (int si = 0; si < n_scan_comps; ++si) {
        int h = comp_h[si], v = comp_v[si];
        for (int vi = 0; vi < v; ++vi)
          for (int hi = 0; hi < h; ++hi)
            one(si, state[si][((my * v + vi) * state_cols[si] + mx * h + hi) *
                              64]);
      }
    } else {
      int64_t by = u / comp_bw[0], bx = u % comp_bw[0];
      one(0, state[0][(by * state_cols[0] + bx) * 64]);
    }
  }
  em.flush();
  return em.pos;
}

}  // extern "C"
