// Microbenchmark for progressive (SOF2) scan decode: replays every dumped
// scan serially with per-scan timing (min over reps), on state grids
// matching the production layout. Build:
//   g++ -O3 -march=native -std=c++17 -pthread -o /tmp/profprog \
//       tools/profile_prog.cpp
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
  std::string dir = argc > 1 ? argv[1] : "/tmp/scan4k_prog";
  int reps = argc > 2 ? atoi(argv[2]) : 8;
  auto meta = rdT<int64_t>(dir + "/meta.i64.bin");
  auto comp = rdT<int64_t>(dir + "/comp.i64.bin");
  int64_t width = meta[0], height = meta[1];
  int64_t mcus_x = meta[2], mcus_y = meta[3];
  int n_comp = (int)meta[5];
  int64_t h_max = meta[6], v_max = meta[7];
  int n_scans = (int)meta[8];
  // State grids: AC [bh, bw, 64] int32 (bh = mcus_y * v), DC compact.
  std::vector<std::vector<int32_t>> ac_s(n_comp), dc_s(n_comp);
  std::vector<int64_t> gh(n_comp), gw(n_comp), bh(n_comp), bw(n_comp);
  for (int c = 0; c < n_comp; ++c) {
    int64_t h = comp[2 * c], v = comp[2 * c + 1];
    gh[c] = mcus_y * v;
    gw[c] = mcus_x * h;
    int64_t cw = (width * h + h_max - 1) / h_max;
    int64_t ch = (height * v + v_max - 1) / v_max;
    bh[c] = (ch + 7) / 8;
    bw[c] = (cw + 7) / 8;
    ac_s[c].assign((size_t)(gh[c] * gw[c] * 64), 0);
    dc_s[c].assign((size_t)(gh[c] * gw[c]), 0);
  }
  struct Scan {
    std::vector<uint8_t> data;
    std::vector<int64_t> bounds;
    std::vector<int64_t> sm;
    std::vector<uint16_t> dc_luts, ac_luts;
  };
  std::vector<Scan> scans(n_scans);
  for (int i = 0; i < n_scans; ++i) {
    std::string pre = dir + "/scan" + std::to_string(i);
    scans[i].data = rd(pre + "_data.u8.bin");
    scans[i].bounds = rdT<int64_t>(pre + "_bounds.i64.bin");
    scans[i].sm = rdT<int64_t>(pre + "_meta.i64.bin");
    scans[i].dc_luts = rdT<uint16_t>(pre + "_dc_luts.u16.bin");
    scans[i].ac_luts = rdT<uint16_t>(pre + "_ac_luts.u16.bin");
  }
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto msec = [](auto a, auto b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };
  std::vector<double> best(n_scans, 1e30);
  std::vector<double> total(reps, 0.0);
  for (int r = 0; r < reps; ++r) {
    for (int c = 0; c < n_comp; ++c) {
      memset(ac_s[c].data(), 0, ac_s[c].size() * 4);
      memset(dc_s[c].data(), 0, dc_s[c].size() * 4);
    }
    for (int i = 0; i < n_scans; ++i) {
      Scan& s = scans[i];
      int ss = (int)s.sm[0], se = (int)s.sm[1];
      int ah = (int)s.sm[2], al = (int)s.sm[3];
      int nsc = (int)s.sm[4];
      int64_t ri = s.sm[5];
      const int64_t* cis = &s.sm[6];
      const int64_t* dcids = &s.sm[6 + nsc];
      const int64_t* acids = &s.sm[6 + 2 * nsc];
      int64_t n_segs = (int64_t)s.bounds.size() / 2;
      std::vector<int64_t> seg_s(n_segs), seg_e(n_segs);
      for (int64_t k = 0; k < n_segs; ++k) {
        seg_s[k] = s.bounds[2 * k];
        seg_e[k] = s.bounds[2 * k + 1];
      }
      auto t0 = now();
      int64_t err = -1;
      if (ss == 0) {
        int interleaved = nsc > 1 ? 1 : 0;
        int64_t n_units =
            interleaved ? (mcus_x * mcus_y) : (bh[cis[0]] * bw[cis[0]]);
        int64_t rri = ri ? ri : n_units;
        std::vector<int32_t> sch(nsc), scv(nsc), sdc(nsc);
        std::vector<int32_t*> st(nsc);
        std::vector<int64_t> cols(nsc), bws(1, interleaved ? 0 : bw[cis[0]]);
        for (int k2 = 0; k2 < nsc; ++k2) {
          int ci = (int)cis[k2];
          sch[k2] = (int32_t)comp[2 * ci];
          scv[k2] = (int32_t)comp[2 * ci + 1];
          sdc[k2] = (int32_t)dcids[k2];
          st[k2] = dc_s[ci].data();
          cols[k2] = gw[ci];
        }
        err = jt_decode_prog_dc(
            s.data.data(), seg_s.data(), seg_e.data(), n_segs, rri, ah, al,
            nsc, sch.data(), scv.data(), st.data(), cols.data(),
            s.dc_luts.data(), sdc.data(), (int32_t)mcus_x, n_units,
            interleaved, bws.data(), 0);
      } else {
        int ci = (int)cis[0];
        int64_t n_blocks = bh[ci] * bw[ci];
        int64_t rri = ri ? ri : n_blocks;
        err = jt_decode_prog_ac(
            s.data.data(), seg_s.data(), seg_e.data(), n_segs, rri, ss, se,
            ah, al, ac_s[ci].data(), gw[ci], s.ac_luts.data(),
            (int32_t)acids[0], bw[ci], n_blocks, 0, nullptr, nullptr);
      }
      double ms = msec(t0, now());
      total[r] += ms;
      best[i] = std::min(best[i], ms);
      if (err >= 0) { fprintf(stderr, "scan %d err seg %ld\n", i, err); return 1; }
    }
  }
  double sum = 0;
  for (int i = 0; i < n_scans; ++i) {
    Scan& s = scans[i];
    printf("scan %2d comp=%ld ss=%2ld se=%2ld ah=%ld al=%ld %8zuB %7.2f ms\n",
           i, s.sm[6], s.sm[0], s.sm[1], s.sm[2], s.sm[3], s.data.size(),
           best[i]);
    sum += best[i];
  }
  double tbest = 1e30;
  for (double t : total) tbest = std::min(tbest, t);
  printf("sum of per-scan bests: %.2f ms; best serial total: %.2f ms\n",
         sum, tbest);
  return 0;
}
