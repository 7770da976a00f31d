// Phase-level microbenchmark for the host entropy decoder. Reads the arrays
// dumped by tools/dump_scan.py and times:
//   full2   jt_decode_scan_planes, 1 thread, prezero=2 (production seq rate)
//   full0   same, prezero=0 on an already-zeroed buffer (isolates zero cost)
//   huff    pure Huffman decode into one reused L1 temp tile (no plane
//           traffic at all) — the bit-twiddling floor
//   zero    bulk plane zeroing alone
// Build: g++ -O3 -march=native -std=c++17 -pthread -o /tmp/profent \
//          tools/profile_entropy.cpp
#include "../../runtime/native/jpegtpu.cpp"

#include <sys/mman.h>

#include <chrono>
#include <cstdio>
#include <string>

static std::vector<uint8_t> rd(const std::string& p) {
  FILE* f = fopen(p.c_str(), "rb");
  if (!f) { fprintf(stderr, "missing %s\n", p.c_str()); exit(1); }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> v(n);
  if (fread(v.data(), 1, n, f) != (size_t)n) exit(1);
  fclose(f);
  return v;
}

template <typename T>
static std::vector<T> rdT(const std::string& p) {
  auto raw = rd(p);
  std::vector<T> v(raw.size() / sizeof(T));
  memcpy(v.data(), raw.data(), v.size() * sizeof(T));
  return v;
}

int main(int argc, char** argv) {
  std::string dir = argc > 1 ? argv[1] : "/tmp/scan4k";
  int reps = argc > 2 ? atoi(argv[2]) : 10;
  auto data = rd(dir + "/data.u8.bin");
  auto seg_start = rdT<int64_t>(dir + "/seg_start.i64.bin");
  auto seg_end = rdT<int64_t>(dir + "/seg_end.i64.bin");
  auto seg_mcu_start = rdT<int64_t>(dir + "/seg_mcu_start.i64.bin");
  auto seg_mcu_count = rdT<int64_t>(dir + "/seg_mcu_count.i64.bin");
  auto slot_comp = rd(dir + "/slot_comp.u8.bin");
  auto slot_vi = rd(dir + "/slot_vi.u8.bin");
  auto slot_hi = rd(dir + "/slot_hi.u8.bin");
  auto comp_dc = rd(dir + "/comp_dc.u8.bin");
  auto comp_ac = rd(dir + "/comp_ac.u8.bin");
  auto comp_h = rd(dir + "/comp_h.u8.bin");
  auto comp_v = rd(dir + "/comp_v.u8.bin");
  auto dc_luts = rdT<uint16_t>(dir + "/dc_luts.u16.bin");
  auto ac_luts = rdT<uint16_t>(dir + "/ac_luts.u16.bin");
  auto meta = rdT<int64_t>(dir + "/meta.i64.bin");
  int bpm = (int)meta[0];
  int n_comp = (int)meta[1];
  int mcus_x = (int)meta[2];
  int64_t n_mcus = meta[3];
  int64_t n_segs = meta[4];
  std::vector<int64_t> rows(n_comp), strides(n_comp);
  for (int c = 0; c < n_comp; ++c) {
    rows[c] = meta[5 + 2 * c];
    strides[c] = meta[5 + 2 * c + 1];
  }
  bool huge = argc > 3 && atoi(argv[3]) != 0;
  std::vector<std::vector<int16_t>> planes_s(n_comp);
  std::vector<int16_t*> planes(n_comp);
  for (int c = 0; c < n_comp; ++c) {
    size_t bytes = (size_t)(rows[c] * strides[c]) * 2;
    if (huge) {
      size_t rounded = (bytes + (2u << 20) - 1) & ~((size_t)(2u << 20) - 1);
      void* p = mmap(nullptr, rounded, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
      madvise(p, rounded, MADV_HUGEPAGE);
      memset(p, 0, bytes);  // fault in as hugepages
      planes[c] = (int16_t*)p;
    } else {
      planes_s[c].assign((size_t)(rows[c] * strides[c]), 0);
      planes[c] = planes_s[c].data();
    }
  }
  if (huge) printf("hugepages: requested\n");
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto msec = [](auto a, auto b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };

  auto run_full = [&](int prezero) {
    return jt_decode_scan_planes(
        data.data(), data.size(), seg_start.data(), seg_end.data(),
        seg_mcu_start.data(), seg_mcu_count.data(), n_segs, slot_comp.data(),
        slot_vi.data(), slot_hi.data(), bpm, comp_dc.data(), comp_ac.data(),
        comp_h.data(), comp_v.data(), n_comp, mcus_x, dc_luts.data(),
        ac_luts.data(), planes.data(), strides.data(), rows.data(), prezero,
        1);
  };

  run_full(2);  // warmup
  double best2 = 1e30, best0 = 1e30, bestz = 1e30, besth = 1e30;
  for (int r = 0; r < reps; ++r) {
    auto t0 = now();
    run_full(2);
    best2 = std::min(best2, msec(t0, now()));
  }
  // prezero=0 on a pre-zeroed buffer: zero it once outside the timer.
  for (int r = 0; r < reps; ++r) {
    for (int c = 0; c < n_comp; ++c)
      memset(planes[c], 0, planes_s[c].size() * 2);
    auto t0 = now();
    run_full(0);
    best0 = std::min(best0, msec(t0, now()));
  }
  for (int r = 0; r < reps; ++r) {
    auto t0 = now();
    for (int c = 0; c < n_comp; ++c)
      memset(planes[c], 0, planes_s[c].size() * 2);
    bestz = std::min(bestz, msec(t0, now()));
  }
  // Pure Huffman: decode every segment into one reused tile.
  {
    TwoLevelLut dc_tab[4], ac_tab[4];
    FastLut dc_fast[4];
    PairLut ac_pair[4];
    bool dcb[4] = {}, acb[4] = {};
    const TwoLevelLut *sdc[64], *sac[64];
    const FastLut* sdf[64];
    const PairLut* saf[64];
    int sci[64];
    for (int s = 0; s < bpm; ++s) {
      int c = slot_comp[s];
      sci[s] = c;
      int di = comp_dc[c], ai = comp_ac[c];
      if (!dcb[di]) {
        dc_tab[di].build(dc_luts.data() + di * kLutSize);
        dc_fast[di].build(dc_luts.data() + di * kLutSize, true);
        dcb[di] = true;
      }
      if (!acb[ai]) {
        ac_tab[ai].build(ac_luts.data() + ai * kLutSize);
        ac_pair[ai].build(ac_luts.data() + ai * kLutSize);
        acb[ai] = true;
      }
      sdc[s] = &dc_tab[di];
      sac[s] = &ac_tab[ai];
      sdf[s] = &dc_fast[di];
      saf[s] = &ac_pair[ai];
    }
    int32_t zoff8[64];
    for (int k = 0; k < 64; ++k) zoff8[k] = kZigRow[k] * 8 + kZigCol[k];
    alignas(64) int16_t tile[64];
    volatile int16_t sink = 0;
    for (int r = 0; r < reps; ++r) {
      auto t0 = now();
      for (int64_t s = 0; s < n_segs; ++s) {
        BitReader br(data.data() + seg_start[s], seg_end[s] - seg_start[s]);
        int32_t prev_dc[4] = {0, 0, 0, 0};
        for (int64_t m = 0; m < seg_mcu_count[s]; ++m) {
          for (int slot = 0; slot < bpm; ++slot) {
            next_block_plane<true>(br, *sdc[slot], *sac[slot], *sdf[slot],
                                   *saf[slot], tile, 8, zoff8,
                                   &prev_dc[sci[slot]]);
          }
        }
      }
      besth = std::min(besth, msec(t0, now()));
      sink += tile[0];
    }
    (void)sink;
  }
  printf("full prezero=2: %7.2f ms  (%5.1f fps)\n", best2, 1000 / best2);
  printf("full prezero=0: %7.2f ms  (%5.1f fps)\n", best0, 1000 / best0);
  printf("zero only:      %7.2f ms\n", bestz);
  printf("huffman only:   %7.2f ms  (%5.1f fps)\n", besth, 1000 / besth);
  printf("plane-write tax:%7.2f ms (full0 - huff)\n", best0 - besth);
  return 0;
}
