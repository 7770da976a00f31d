// K3's pass 1 (csrc/huffman_lanes.cu: boundary_pass) with one cost term
// taken out at a time, for jpeg_tpu_torch/tools/ablate_kernel.py: the
// counterpart, on the card, of tools/ablate_kernel.py's ablation of the JAX
// package's lockstep entropy kernel.
//
// Every variant runs the shipping frame (tables and DC predictors in shared
// memory, lane layout, records of rows after an error block, err flag) and
// huffman_common.cuh's walk_lane, instantiated with another reader (R) or
// record (RecAt) type:
//   kFull      the shipping pass: records to `meta`, bit for bit;
//   kNoStore   every record to one shared-memory slot (no global stores);
//   kNoRefill  a reader that loads once: each refill still shifts and masks
//              the window, but from the words loaded at the lane's start
//              (no memory loads after them; other symbols are decoded);
//   kGlobal    the pair table read from global memory (__ldg) instead of
//              shared memory: a copy of walk_lane that differs only there.
// One symbol a step (the pair table's two-symbol bit cleared) and the lanes
// a warp are the host's: the same kFull kernel with another table or
// `lanes_per_warp`. With `steps` non-null a lane also writes how many steps
// it took (one a table lookup), through a reader that counts its refills:
// a separate, untimed launch, so that the timed ones run the shipping step.
// Only kFull's output is checked (against the shipping pass 1); the others
// decode other symbols or drop records, and stand for cost alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "huffman_common.cuh"

namespace {

using namespace huffman;

enum Mode { kFull = 0, kNoStore = 1, kNoRefill = 2, kGlobal = 3 };

// ByteReader whose refill tops up from the words of the last fetch and
// never loads again.
struct OnceReader : ByteReader {
  __device__ __forceinline__ void refill() {
    if (cnt < 43) {
      buf |= window() >> cnt;
      pos += (63 - cnt) >> 3;
      cnt |= 56;
    }
  }
};

// A reader that counts its refills (one a step of walk_lane).
template <class R>
struct Counted : R {
  int steps;
  __device__ __forceinline__ void refill() {
    ++steps;
    R::refill();
  }
};

// walk_lane (huffman_common.cuh) with the table entry loaded from global
// memory at `gtab` + the byte offset that walk_lane keeps as a shared
// address (`tab` is 0 here, so the slot descriptors hold byte offsets).
template <class R, class RecAt>
__device__ __forceinline__ int walk_lane_global(
    R& br, const Tables& t, const SlotDesc* desc, int32_t* pred,
    const char* gtab, int dcrow0, int nblk, int bpm, int lane, RecAt rec_at,
    bool* bad) {
  int blk = 0, slot = 0, k = 0;
  SlotDesc d = desc[0];
  uint32_t row_addr = kRowBytes * dcrow0;
  int32_t* pred_of = pred + threadIdx.x;
  *bad = false;
  while (blk < nblk) {
    uint32_t e = __ldg(reinterpret_cast<const uint32_t*>(
        gtab + row_addr + 4 * br.top11()));
    br.refill();
    const bool dc = k == 0;
    if (e == 0) {
      int sym = 0;
      const int length = t.walk(row_addr / kRowBytes, br.peek32(), &sym);
      e = make_pair_entry(length, sym, dc);
    }
    const uint64_t bits = br.buf;
    const int start = br.consumed_bits();
    const int blk0 = blk, slot0 = slot, comp = d.comp;
    const int adv1 = (e >> 6) & 0x7F;
    const bool two = ((e >> 26) & 1) && k + adv1 < 64;
    br.consume(two ? (e >> 13) & 0x3F : e & 0x3F);
    k += two ? static_cast<int>((e >> 19) & 0x7F) : adv1;
    const bool next = k >= 64;
    k = next ? 0 : k;
    row_addr = next ? d.next_dc_row : d.ac_row;
    blk += next;
    slot = next ? (slot + 1 == bpm ? 0 : slot + 1) : slot;
    d = desc[slot];
    if (dc) {
      int32_t* pp = pred_of + comp * kWalkThreads;
      const int length = e >> 27;
      const int32_t diff = magnitude(bits, length, (e & 0x3F) - length);
      const int32_t dc_pred = static_cast<int32_t>(
          static_cast<uint32_t>(*pp) + static_cast<uint32_t>(diff));
      *pp = dc_pred;
      *rec_at(blk0) = make_int4(start, dc_pred, lane, slot0);
    }
    if (e == 0) {
      *bad = true;
      break;
    }
  }
  return blk;
}

template <int kMode, bool kCount>
__global__ void __launch_bounds__(kWalkThreads)
ablate_pass(const uint8_t* __restrict__ data,
            const int64_t* __restrict__ lane_start,
            const int32_t* __restrict__ lane_len,
            const int32_t* __restrict__ lane_nblk,
            const int64_t* __restrict__ lane_out, int n_lanes,
            const int32_t* __restrict__ pair, const int32_t* __restrict__ hv,
            const int32_t* __restrict__ canon,
            const int32_t* __restrict__ slots, int n_rows, int bpm,
            int lanes_per_warp, int4* __restrict__ meta,
            uint8_t* __restrict__ err_out, int32_t* __restrict__ steps_out) {
  extern __shared__ uint32_t s_skip[];
  __shared__ SharedTables st;
  const Tables t = load_tables(s_skip, &st, pair, hv, canon, slots, n_rows, bpm);
  __shared__ SlotDesc s_desc[kMaxSlots];
  __shared__ int32_t s_pred[4 * kWalkThreads];
  __shared__ int4 s_sink;
  const uint32_t tab =
      kMode == kGlobal ? 0u
                       : static_cast<uint32_t>(__cvta_generic_to_shared(s_skip));
  init_walk(s_desc, s_pred, st, tab, bpm);

  const int in_warp = threadIdx.x & 31;
  const int lane =
      (blockIdx.x * (kWalkThreads / 32) + (threadIdx.x >> 5)) * lanes_per_warp +
      in_warp;
  if (in_warp >= lanes_per_warp || lane >= n_lanes) return;
  using Base = typename std::conditional<kMode == kNoRefill, OnceReader,
                                         ByteReader>::type;
  using Reader = typename std::conditional<kCount, Counted<Base>, Base>::type;
  Reader br;
  br.start(data + lane_start[lane], lane_len[lane], 0);
  if constexpr (kCount) br.steps = 0;
  const int nblk = lane_nblk[lane];
  int4* rec = meta + lane_out[lane];
  bool bad;
  int blk;
  if constexpr (kMode == kNoStore) {
    int4* sink = &s_sink;
    blk = walk_lane(br, t, s_desc, s_pred, tab, st.dcrow[0], nblk, bpm, lane,
                    [sink](int) { return sink; }, &bad);
  } else if constexpr (kMode == kGlobal) {
    blk = walk_lane_global(br, t, s_desc, s_pred,
                           reinterpret_cast<const char*>(pair), st.dcrow[0],
                           nblk, bpm, lane, [rec](int b) { return rec + b; },
                           &bad);
  } else {
    blk = walk_lane(br, t, s_desc, s_pred, tab, st.dcrow[0], nblk, bpm, lane,
                    [rec](int b) { return rec + b; }, &bad);
  }
  if constexpr (kMode != kNoStore)
    for (int b = blk + 1; b < nblk; ++b) rec[b] = make_int4(0, 0, lane, -1);
  const int64_t bitend = static_cast<int64_t>(br.len) * 8;
  err_out[lane] = (bad || br.consumed_bits() > bitend + 8) ? 1 : 0;
  if constexpr (kCount) steps_out[lane] = br.steps;
}

template <int kMode, bool kCount>
cudaError_t launch(const uint8_t* d, const int64_t* ls, const int32_t* ll,
                   const int32_t* nb, const int64_t* lo, int n_lanes,
                   const int32_t* pair, const int32_t* hv, const int32_t* cn,
                   const int32_t* sl, int n_rows, int bpm, int lanes_per_warp,
                   int4* meta, uint8_t* err, int32_t* steps, cudaStream_t s) {
  const size_t smem = sizeof(uint32_t) * kT11 * n_rows;
  cudaError_t e = cudaFuncSetAttribute(
      ablate_pass<kMode, kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(uint32_t) * kT11 * kMaxRows));
  if (e != cudaSuccess) return e;
  const int per_block = (kWalkThreads / 32) * lanes_per_warp;
  ablate_pass<kMode, kCount><<<(n_lanes + per_block - 1) / per_block,
                               kWalkThreads, smem, s>>>(
      d, ls, ll, nb, lo, n_lanes, pair, hv, cn, sl, n_rows, bpm,
      lanes_per_warp, meta, err, steps);
  return cudaGetLastError();
}

template <bool kCount>
cudaError_t launch_mode(int mode, const uint8_t* d, const int64_t* ls,
                        const int32_t* ll, const int32_t* nb,
                        const int64_t* lo, int n_lanes, const int32_t* pair,
                        const int32_t* hv, const int32_t* cn,
                        const int32_t* sl, int n_rows, int bpm, int lpw,
                        int4* meta, uint8_t* err, int32_t* steps,
                        cudaStream_t s) {
  switch (mode) {
    case kFull:
      return launch<kFull, kCount>(d, ls, ll, nb, lo, n_lanes, pair, hv, cn,
                                   sl, n_rows, bpm, lpw, meta, err, steps, s);
    case kNoStore:
      return launch<kNoStore, kCount>(d, ls, ll, nb, lo, n_lanes, pair, hv,
                                      cn, sl, n_rows, bpm, lpw, meta, err,
                                      steps, s);
    case kNoRefill:
      return launch<kNoRefill, kCount>(d, ls, ll, nb, lo, n_lanes, pair, hv,
                                       cn, sl, n_rows, bpm, lpw, meta, err,
                                       steps, s);
    case kGlobal:
      return launch<kGlobal, kCount>(d, ls, ll, nb, lo, n_lanes, pair, hv,
                                     cn, sl, n_rows, bpm, lpw, meta, err,
                                     steps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch pass 1 in `mode` (0 full, 1 no record store, 2 no refill, 3 the
// table in global memory) on `stream`, with the arguments of
// jt_huffman_lanes' pass 1: the scan bytes and lane arrays, the pair table
// [n_rows, 2048], huffval [n_rows, 256], canon [n_rows, 15], slots
// [bpm, 3]; outputs meta [total_rows, 4] i32 and err [n_lanes] u8.
// `lanes_per_warp` 0 takes the shipping rule (lanes_per_warp_for), else a
// power of two up to 32. With `steps` non-null, each lane's step count
// [n_lanes] i32 is written too (the counting instantiation). Returns
// cudaGetLastError() after the launch (0 = launched).
int jt_k3_ablate(int32_t mode, const void* data, const void* lane_start,
                 const void* lane_len, const void* lane_nblk,
                 const void* lane_out, int32_t n_lanes, const void* pair,
                 const void* huffval, const void* canon, const void* slots,
                 int32_t n_rows, int32_t bpm, int32_t lanes_per_warp,
                 void* meta, void* err, void* steps, void* stream) {
  if (n_lanes < 1 || bpm < 1 || bpm > kMaxSlots || n_rows < 1 ||
      n_rows > kMaxRows || lanes_per_warp < 0 || lanes_per_warp > 32 ||
      (lanes_per_warp & (lanes_per_warp - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int lpw = lanes_per_warp;
  if (lpw == 0) {
    cudaError_t e;
    const int sms = sm_count(&e);
    if (e != cudaSuccess) return static_cast<int>(e);
    lpw = lanes_per_warp_for(n_lanes, sms);
  }
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ls = static_cast<const int64_t*>(lane_start);
  const auto* ll = static_cast<const int32_t*>(lane_len);
  const auto* nb = static_cast<const int32_t*>(lane_nblk);
  const auto* lo = static_cast<const int64_t*>(lane_out);
  const auto* pr = static_cast<const int32_t*>(pair);
  const auto* hv = static_cast<const int32_t*>(huffval);
  const auto* cn = static_cast<const int32_t*>(canon);
  const auto* sl = static_cast<const int32_t*>(slots);
  auto* m = static_cast<int4*>(meta);
  auto* er = static_cast<uint8_t*>(err);
  auto* stp = static_cast<int32_t*>(steps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      steps != nullptr
          ? launch_mode<true>(mode, d, ls, ll, nb, lo, n_lanes, pr, hv, cn, sl,
                              n_rows, bpm, lpw, m, er, stp, s)
          : launch_mode<false>(mode, d, ls, ll, nb, lo, n_lanes, pr, hv, cn,
                               sl, n_rows, bpm, lpw, m, er, stp, s));
}

// The lanes a warp that the shipping launcher gives `n_lanes` lanes on this
// device (lanes_per_warp_for), or -1 on a CUDA error.
int jt_k3_lanes_per_warp(int32_t n_lanes) {
  cudaError_t e;
  const int sms = sm_count(&e);
  return e == cudaSuccess ? lanes_per_warp_for(n_lanes, sms) : -1;
}

}  // extern "C"
