// The port's C++ runtime library: jpegtpu.cpp (a verbatim copy of the JAX
// package's runtime, included whole) plus the entry points that only the
// port binds. Build: g++ -O3 -march=native -std=c++17 -fPIC -pthread -shared
// jpegtpu_port.cpp (jpeg_tpu_torch.runtime.load does this at first use).
#include "jpegtpu.cpp"

extern "C" {

// Lossless (SOF3) differences only: phase 1 of jt_decode_lossless, the
// mod-2^16 prediction differences in scan order into `out` [H * W * ncomp],
// parallel over restart segments. The card route of
// jpeg_tpu_torch.entropy.lossless.decode_lossless reconstructs predictors
// 1 and 2 from them with torch.cumsum. Returns -1 ok, else the first failed
// segment index.
int64_t jt_decode_lossless_diffs(
    const uint8_t* data, const int64_t* seg_start, const int64_t* seg_end,
    const int64_t* seg_mcu_start, const int64_t* seg_mcu_count,
    int64_t n_segs, int32_t ncomp, const uint16_t* dc_luts,
    const int32_t* comp_dc_id, uint16_t* out, int32_t n_threads) {
  TwoLevelLut luts[4];
  bool built[4] = {};
  const TwoLevelLut* comp_lut[4];
  for (int c = 0; c < ncomp; ++c) {
    int id = comp_dc_id[c];
    if (!built[id]) {
      luts[id].build(dc_luts + id * kLutSize);
      built[id] = true;
    }
    comp_lut[c] = &luts[id];
  }
  std::atomic<int64_t> first_error(-1);
  std::atomic<int64_t> next(0);
  int nt = (int)std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_segs);
  pool_run(nt, [&](int) {
    for (;;) {
      int64_t s = next.fetch_add(1);
      if (s >= n_segs) return;
      BitReader br(data + seg_start[s], seg_end[s] - seg_start[s]);
      uint16_t* o = out + seg_mcu_start[s] * ncomp;
      int64_t n = seg_mcu_count[s] * ncomp;
      for (int64_t i = 0; i < n; ++i) {
        if (br.count < 31) br.refill();
        uint32_t e = comp_lut[i % ncomp]->lookup((uint32_t)(br.bits >> 48));
        int len = e & 0xFF;
        if (__builtin_expect(len == 0, 0)) {
          int64_t expect = -1;
          first_error.compare_exchange_strong(expect, s);
          return;
        }
        br.consume(len);
        int ssss = e >> 8;
        int32_t diff;
        if (ssss == 16) {
          diff = 32768;  // H.2 Table H.2: no additional bits
        } else if (ssss == 0) {
          diff = 0;
        } else {
          uint32_t v = br.read(ssss);
          diff = (v >> (ssss - 1)) ? (int32_t)v
                                   : (int32_t)v - (1 << ssss) + 1;
        }
        o[i] = (uint16_t)diff;
      }
    }
  });
  return first_error.load();
}

}  // extern "C"
