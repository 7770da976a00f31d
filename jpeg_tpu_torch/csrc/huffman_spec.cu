// K7: phase A of the speculative chunk-lane entropy decoder, for Hopper
// (sm_90a).
//
// Replaces jpeg_tpu/entropy/device_spec.py::_compiled_spec_kernel, an XLA
// while loop that steps every lane in lockstep. It keeps that loop's output
// contract at every index the host merge reads (entropy/device_spec.py) and
// none of its mechanics (no 96-bit register of word gathers, no flat 65536-
// entry tables, no one-hot coefficient accumulate):
//
// - lanes: every restart segment (the whole scan when there is none) cut
//   into byte-aligned chunks on the host; lane l starts at bit_start[l], a
//   guess that self-synchronises with the true symbol stream within a few
//   MCUs;
// - bit stream: the lane's restart segment from the lane's start, across
//   chunk ends, then 0xAA fill bytes forever, as the C++ decoder and K3
//   read a segment (the TPU loop reads on into the next segment's bytes;
//   on a damaged segment whose last MCU runs past its end, that gave other
//   coefficients than the C++ decoder, F8 in ROADMAP.md);
// - per MCU m, before decoding it: mcu_bits[m] = the cursor. The lane
//   counts MCU starts at or after its chunk end (past_end) and starts MCU m
//   only while cursor < seg_end_bit and past_end <= overlap;
// - blocks: the rules of huffman_common.cuh (11-bit skip tables, the
//   canonical walk past 11 bits, Table F.2, EOB / ZRL with the run capped at
//   the block end); DC prediction lane-local from 0 per component (i32
//   wrap), written into each block's coefficient 0;
// - a lane dies at its first invalid prefix: that block's row stays zero,
//   its component's predictor keeps its value, earlier blocks of the MCU
//   keep theirs; dc_cum[m + 1] holds the predictors after MCU m (also after
//   a failed one) and n_dec counts whole MCUs only;
// - a lane still alive after `cap` MCUs records its final cursor in
//   mcu_bits[cap].
//
// Outputs (the caller zeroes out, mcu_bits and dc_cum; entries the lane
// never reaches stay zero): out [S, cap * bpm, 64] i32 zigzag, lane-local
// DC; mcu_bits [S, cap + 1] i32; dc_cum [S, cap + 1, n_comp] i32;
// n_dec [S] i32.
//
// Design: one thread per lane walks its MCUs serially (the TPU loop's
// lockstep is what a CUDA thread does alone), table rows in shared memory
// as K3's pass 2 holds them, the byte reader shared with K3. Bound: the
// serial chain of the longest lane (about 360 cycles a step on K3's pass
// 1, tools/ablate_kernel.py, PERF.md), not bytes: 2,048 lanes of a 4K frame read ~1.5 MB and
// write ~148 MB of rows, 0.05 ms at 3.35 TB/s. Warps get as few lanes as
// keep about two warps per scheduler (huffman::lanes_per_warp_for), since a
// warp's lanes wait for each other's loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_common.cuh"

namespace {

using namespace huffman;

constexpr int kSpecThreads = kWalkThreads;  // four warps a thread block

__global__ void __launch_bounds__(kSpecThreads)
spec_lanes(const uint8_t* __restrict__ data, int n_bytes,
           const int32_t* __restrict__ bit_start,
           const int32_t* __restrict__ chunk_end_bit,
           const int32_t* __restrict__ seg_end_bit, int n_lanes,
           const int32_t* __restrict__ skip, const int32_t* __restrict__ hv,
           const int32_t* __restrict__ canon,
           const int32_t* __restrict__ slots, int n_rows, int bpm, int n_comp,
           int cap, int overlap, int lanes_per_warp, int32_t* __restrict__ out,
           int32_t* __restrict__ mcu_bits, int32_t* __restrict__ dc_cum,
           int32_t* __restrict__ n_dec) {
  extern __shared__ uint32_t s_skip[];
  __shared__ SharedTables st;
  __shared__ int32_t s_pred[4 * kSpecThreads];
  const Tables t = load_tables(s_skip, &st, skip, hv, canon, slots, n_rows, bpm);
  const uint32_t tab = static_cast<uint32_t>(__cvta_generic_to_shared(s_skip));

  const int in_warp = threadIdx.x & 31;
  const int lane =
      (blockIdx.x * (kSpecThreads / 32) + (threadIdx.x >> 5)) * lanes_per_warp +
      in_warp;
  if (in_warp >= lanes_per_warp || lane >= n_lanes) return;
  int32_t* pred = s_pred + threadIdx.x;  // component c at pred[c * kSpecThreads]
  for (int c = 0; c < 4; ++c) pred[c * kSpecThreads] = 0;

  ByteReader br;
  br.start(data, seg_end_bit[lane] >> 3, bit_start[lane]);
  const int chunk_end = chunk_end_bit[lane], seg_end = seg_end_bit[lane];
  int32_t* lane_out = out + static_cast<int64_t>(lane) * cap * bpm * 64;
  int32_t* bits = mcu_bits + static_cast<int64_t>(lane) * (cap + 1);
  int32_t* cum = dc_cum + static_cast<int64_t>(lane) * (cap + 1) * n_comp;
  int past_end = 0, n = 0;
  bool alive = true;
  for (int m = 0; m < cap && alive; ++m) {
    const int pos = br.consumed_bits();
    bits[m] = pos;
    past_end += pos >= chunk_end;
    if (pos >= seg_end || past_end > overlap) {
      alive = false;
      break;
    }
    for (int slot = 0; slot < bpm && alive; ++slot) {
      int32_t* row = lane_out + (static_cast<int64_t>(m) * bpm + slot) * 64;
      const uint32_t e = dc_entry(br, t, tab, t.dcrow[slot]);
      if (e != 0) {
        const int32_t diff =
            magnitude(br.buf, (e >> 8) & 0x1F, (e >> 16) & 0x1F);
        br.consume(e & 0x3F);
        if (decode_ac<1>(br, t, tab, t.acrow[slot], row)) {
          int32_t* pp = pred + st.comp[slot] * kSpecThreads;
          const int32_t dc = static_cast<int32_t>(static_cast<uint32_t>(*pp) +
                                                  static_cast<uint32_t>(diff));
          *pp = dc;
          row[0] = dc;
          continue;
        }
      }
      // An invalid prefix: the block's row goes back to zeros.
      for (int k = 0; k < 64; ++k) row[k] = 0;
      alive = false;
    }
    for (int c = 0; c < n_comp; ++c)
      cum[(m + 1) * n_comp + c] = pred[c * kSpecThreads];
    n += alive;
  }
  if (alive) bits[cap] = br.consumed_bits();  // ran out of MCUs: n == cap
  n_dec[lane] = n;
}

}  // namespace

extern "C" {

// Launch K7 on `stream`. All pointers are device pointers: the scan bytes
// `data` (n_bytes, followed by 16 bytes of padding), the lanes' i32 bit
// positions bit_start, chunk_end_bit and seg_end_bit [n_lanes]; K3's pass-2
// skip table [n_rows, 2048], huffval [n_rows, 256] and canon [n_rows, 15]
// (i32) of the table rows the slots use, slots [bpm, 3] (component, DC row,
// AC row); outputs out [n_lanes, cap * bpm, 64], mcu_bits [n_lanes, cap + 1]
// and dc_cum [n_lanes, cap + 1, n_comp], zeroed by the caller, and n_dec
// [n_lanes] (all i32). Returns cudaGetLastError() after the launch (0 =
// launched).
int jt_huffman_spec(const void* data, int32_t n_bytes, const void* bit_start,
                    const void* chunk_end_bit, const void* seg_end_bit,
                    int32_t n_lanes, const void* skip, const void* huffval,
                    const void* canon, const void* slots, int32_t n_rows,
                    int32_t bpm, int32_t n_comp, int32_t cap, int32_t overlap,
                    void* out, void* mcu_bits, void* dc_cum, void* n_dec,
                    void* stream) {
  if (n_lanes < 1 || bpm < 1 || bpm > kMaxSlots || n_rows < 1 ||
      n_rows > kMaxRows || n_comp < 1 || n_comp > 4 || cap < 0 ||
      overlap < 0 || n_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;  // set last, once the kernel may use its memory
  if (sms == 0) {
    cudaError_t e;
    const int n_sm = sm_count(&e);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(spec_lanes,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(uint32_t) * kT11 * kMaxRows));
    if (e != cudaSuccess) return static_cast<int>(e);
    sms = n_sm;
  }
  const int lanes_per_warp = lanes_per_warp_for(n_lanes, sms);
  const int per_block = (kSpecThreads / 32) * lanes_per_warp;
  spec_lanes<<<(n_lanes + per_block - 1) / per_block, kSpecThreads,
               sizeof(uint32_t) * kT11 * n_rows,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n_bytes,
      static_cast<const int32_t*>(bit_start),
      static_cast<const int32_t*>(chunk_end_bit),
      static_cast<const int32_t*>(seg_end_bit), n_lanes,
      static_cast<const int32_t*>(skip), static_cast<const int32_t*>(huffval),
      static_cast<const int32_t*>(canon), static_cast<const int32_t*>(slots),
      n_rows, bpm, n_comp, cap, overlap, lanes_per_warp,
      static_cast<int32_t*>(out), static_cast<int32_t*>(mcu_bits),
      static_cast<int32_t*>(dc_cum), static_cast<int32_t*>(n_dec));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
