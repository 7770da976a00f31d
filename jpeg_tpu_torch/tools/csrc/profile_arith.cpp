// Microbenchmark for the arithmetic (SOF9) entropy decoder. Reads the
// arrays dumped by tools/dump_scan.py from an arithmetic-coded jpeg.
//   plane1   jt_decode_arith_scan_planes, 1 thread (per-core rate)
//   plane4   same, 4 threads (the production rate)
// Build: g++ -O3 -march=native -std=c++17 -pthread -o /tmp/profarith \
//          tools/profile_arith.cpp
#include "../../runtime/native/jpegtpu.cpp"

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
  std::string dir = argc > 1 ? argv[1] : "/tmp/scan4k_arith";
  int reps = argc > 2 ? atoi(argv[2]) : 8;
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
  auto dc_L = rd(dir + "/dc_L.u8.bin");
  auto dc_U = rd(dir + "/dc_U.u8.bin");
  auto ac_K = rd(dir + "/ac_K.u8.bin");
  auto meta = rdT<int64_t>(dir + "/meta.i64.bin");
  int bpm = (int)meta[0];
  int n_comp = (int)meta[1];
  int mcus_x = (int)meta[2];
  int64_t n_segs = meta[4];
  std::vector<int64_t> rows(n_comp), strides(n_comp);
  for (int c = 0; c < n_comp; ++c) {
    rows[c] = meta[5 + 2 * c];
    strides[c] = meta[5 + 2 * c + 1];
  }
  std::vector<std::vector<int16_t>> planes_s(n_comp);
  std::vector<int16_t*> planes(n_comp);
  for (int c = 0; c < n_comp; ++c) {
    planes_s[c].assign((size_t)(rows[c] * strides[c]), 0);
    planes[c] = planes_s[c].data();
  }
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto msec = [](auto a, auto b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };
  auto run = [&](int prezero, int nt) {
    return jt_decode_arith_scan_planes(
        data.data(), data.size(), seg_start.data(), seg_end.data(),
        seg_mcu_start.data(), seg_mcu_count.data(), n_segs, slot_comp.data(),
        slot_vi.data(), slot_hi.data(), bpm, comp_dc.data(), comp_ac.data(),
        comp_h.data(), comp_v.data(), n_comp, mcus_x, dc_L.data(),
        dc_U.data(), ac_K.data(), planes.data(), strides.data(), rows.data(),
        prezero, nt);
  };
  run(2, 4);  // warmup
  double b1 = 1e30, b4 = 1e30;
  for (int r = 0; r < reps; ++r) {
    auto t0 = now();
    run(2, 1);
    b1 = std::min(b1, msec(t0, now()));
  }
  for (int r = 0; r < reps; ++r) {
    auto t0 = now();
    run(2, 4);
    b4 = std::min(b4, msec(t0, now()));
  }
  printf("arith 1-thread: %7.2f ms (%5.1f fps)\n", b1, 1000 / b1);
  printf("arith 4-thread: %7.2f ms (%5.1f fps)\n", b4, 1000 / b4);
  return 0;
}
