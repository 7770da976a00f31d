// K3: lane-per-restart-segment Huffman decoder for Hopper (sm_90a), in two
// passes.
//
// Replaces the Pallas kernel jpeg_tpu/entropy/device_window.py::
// _make_window_kernel (launched K times by _compiled_window_chain). It keeps
// that kernel's output contract bit for bit and none of its mechanics (no
// word windows, select or MXU gathers, Kronecker LUT split or VMEM frame
// model):
//
// - bit stream: the segment's bytes followed by 0xAA fill bytes forever
//   (the reference's tail padding, src/jpeg/huffman.rs:240-250);
// - symbols: 11-bit peek tables plus the canonical walk over code lengths
//   12..16 (mincode / maxcode / valptr), as the TPU kernel resolves them;
// - Table F.2 sign extension, per-lane per-component DC prediction (i32
//   wrap), EOB / ZRL with the run capped at the block end;
// - errors: a lane stops at its first invalid prefix; the block being
//   decoded keeps what it decoded so far plus its DC predictor, later blocks
//   are zero. The flag is set when that happened, or when the lane consumed
//   more than 8 bits past its segment end (cursor > bitend + 8).
//
// Output: coefficients [rows, 64] i32, zigzag order, DC predicted; lane l
// owns rows lane_out[l] .. lane_out[l] + lane_nblk[l] - 1 (MCU stream
// order); err [lanes] u8. Every output byte is written exactly once, so the
// caller allocates both uninitialised.
//
// Pass 1, the boundary walk (boundary_pass): one thread per lane. It decodes
// no coefficient values. Its two loops (blocks, AC symbols) are one loop
// over the state (slot in the MCU, coefficient index k), so the lanes of a
// warp advance one step per iteration whatever their block lengths and
// wait only for the lane with the most steps in total. Per step: one
// shared-memory lookup in a table built on the host (per 11-bit peek: bits
// consumed and advance of k, for two AC symbols at once where both lie
// within the peek and the first leaves the block open), one 64-bit shift,
// a refill from bytes loaded at the previous refill (Reader); the canonical
// walk only for codes longer than 11 bits. The table row of the next step
// is one select; the DC predictor lives in shared memory. Per block it
// stores one 16-byte record (start bit, DC predictor after the block,
// lane, slot); rows after a lane's error block get slot -1.
// Bound: the latency of that serial chain, step after step (a 4K lane's
// ~15,500 symbols take ~10,000 steps; tests/test_torch_k3_two_pass.py). A
// warp's registers share one scoreboard, so its lanes also wait for each
// other's loads: the launcher gives a warp as few lanes as keep about two
// warps per scheduler (1 lane a warp at 135 lanes, 2 at 1,080, 8 at 4,320).
//
// Pass 2, the block decode (block_pass): one thread per output row (1.56 M
// at 8 4K frames). A thread decodes its block from the recorded start bit
// with the same tables, reader and rules, into a per-warp staging area in
// shared memory (its row zeroed first); the warp then writes its 32 rows,
// 8 KB of contiguous output, with 16-byte stores. Bound: the output bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT11 = 2048;        // skip entries per table row (11-bit peek)
constexpr int kMaxRows = 8;       // table rows: at most 4 DC + 4 AC
constexpr int kMaxSlots = 10;     // blocks per MCU (JPEG limit)
constexpr int kWalkThreads = 128;  // pass 1: four warps per block
constexpr int kRowThreads = 256;  // pass 2: eight warps per block
constexpr int kStage = 68;        // staging row stride in i32 (16-byte rows)
constexpr int kWarps = kRowThreads / 32;

// Pass 2's skip entry (i32): bits 0-5 bits consumed (code + magnitude),
// 8-12 code length, 16-20 magnitude bits, 24-30 advance of k (DC 1, EOB 64,
// else run + 1, ZRL 16). Pass 1's pair entry: bits 0-5 bits consumed, 6-12
// advance, 27-31 a DC code's length; in an AC row, where the next whole
// symbol also lies within the 11-bit peek, bits 13-18 and 19-25 the bits
// and advance of both, bit 26 set. In both tables 0 means "not an 11-bit
// code": walk canonically (device_huffman.skip_entries, pair_table).
// (magnitude bits, advance of k) of a symbol: a DC symbol is its size and
// advances 1; an AC symbol's size is its low nibble, it advances run + 1,
// and EOB ends the block.
__device__ __forceinline__ int2 size_advance(int sym, bool dc) {
  return dc ? make_int2(sym, 1)
            : make_int2(sym & 0xF, sym == 0 ? 64 : (sym >> 4) + 1);
}

__device__ __forceinline__ uint32_t make_entry(int length, int sym, bool dc) {
  const int2 sa = size_advance(sym, dc);
  return length == 0 ? 0u
                     : static_cast<uint32_t>((length + sa.x) | (length << 8) |
                                             (sa.x << 16) | (sa.y << 24));
}

__device__ __forceinline__ uint32_t make_pair_entry(int length, int sym,
                                                    bool dc) {
  const int2 sa = size_advance(sym, dc);
  return length == 0 ? 0u
                     : static_cast<uint32_t>(length + sa.x) | (sa.y << 6) |
                           (dc ? static_cast<uint32_t>(length) << 27 : 0u);
}

struct Tables {
  const uint8_t* hv;      // [n_rows, 256]
  const int32_t* canon;   // [n_rows, 15]
  const int* dcrow;       // per slot: DC table row,
  const int* acrow;       //           AC table row

  // The code longer than 11 bits at the top of `peek`: its length (0 for
  // an invalid prefix) and symbol.
  __device__ __forceinline__ int walk(int row, uint32_t peek, int* sym) const {
    const int32_t p16 = static_cast<int32_t>(peek >> 16);
    const int32_t* cn = canon + row * 15;
    for (int i = 0; i < 5; ++i) {
      if (cn[5 + i] < 0) continue;
      const int32_t code = p16 >> (4 - i);  // 16 - (12 + i)
      if (code >= cn[i] && code <= cn[5 + i]) {
        *sym = hv[row * 256 + ((cn[10 + i] + code - cn[i]) & 0xFF)];
        return 12 + i;
      }
    }
    return 0;
  }
};

// Shared-memory layout of both passes: the skip rows, then the small tables.
struct SharedTables {
  uint8_t hv[kMaxRows * 256];
  int32_t canon[kMaxRows * 15];
  int comp[kMaxSlots], dcrow[kMaxSlots], acrow[kMaxSlots];
};

__device__ Tables load_tables(uint32_t* s_skip, SharedTables* st,
                              const int32_t* __restrict__ skip,
                              const int32_t* __restrict__ hv,
                              const int32_t* __restrict__ canon,
                              const int32_t* __restrict__ slots, int n_rows,
                              int bpm) {
  const int4* src = reinterpret_cast<const int4*>(skip);
  int4* dst = reinterpret_cast<int4*>(s_skip);
  for (int i = threadIdx.x; i < n_rows * kT11 / 4; i += blockDim.x)
    dst[i] = __ldg(src + i);
  for (int i = threadIdx.x; i < n_rows * 256; i += blockDim.x)
    st->hv[i] = static_cast<uint8_t>(hv[i]);
  for (int i = threadIdx.x; i < n_rows * 15; i += blockDim.x)
    st->canon[i] = canon[i];
  for (int i = threadIdx.x; i < bpm; i += blockDim.x) {
    st->comp[i] = slots[3 * i];
    st->dcrow[i] = slots[3 * i + 1];
    st->acrow[i] = slots[3 * i + 2];
  }
  __syncthreads();
  return Tables{st->hv, st->canon, st->dcrow, st->acrow};
}

// A lane's bits, left-aligned in a 64-bit buffer. A step is:
//   idx = top11();  // the next table index
//   refill();       // below 43 bits: top up to 56-63 bits from the bytes
//                   // loaded at the last refill, and load the next ones
// A symbol takes at most 32 bits, so >= 11 bits are left after it: the
// index never waits for the refill, and a refill reads loads issued at an
// earlier one.
struct Reader {
  const uint8_t* p;
  int len;       // segment bytes; past them the stream reads 0xAA
  int pos;       // bytes moved into buf, fill bytes included
  int cnt;       // valid bits in buf
  uint64_t buf;
  uint32_t w0, w1, w2;  // the aligned words holding bytes pos .. pos + 7
  int sh;               // 8 x the offset of byte pos in w0

  // Three aligned 4-byte loads around byte `pos`, clamped to the segment
  // end (the caller pads the data by 16 bytes).
  __device__ __forceinline__ void fetch() {
    const uintptr_t at = reinterpret_cast<uintptr_t>(p + min(pos, len));
    const uint32_t* a = reinterpret_cast<const uint32_t*>(at & ~uintptr_t{3});
    sh = static_cast<int>(at & 3) * 8;
    w0 = __ldg(a);
    w1 = __ldg(a + 1);
    w2 = __ldg(a + 2);
  }
  // Bytes pos .. pos + 7, big-endian, 0xAA past the segment end.
  __device__ __forceinline__ uint64_t window() const {
    const uint32_t x0 = __byte_perm(__funnelshift_r(w0, w1, sh), 0, 0x0123);
    const uint32_t x1 = __byte_perm(__funnelshift_r(w1, w2, sh), 0, 0x0123);
    const uint64_t be = (static_cast<uint64_t>(x0) << 32) | x1;
    const int avail = len - pos;
    const uint64_t keep = avail >= 8 ? ~uint64_t{0}
                          : avail <= 0 ? uint64_t{0}
                                       : ~uint64_t{0} << (64 - 8 * avail);
    return (be & keep) | (0xAAAAAAAAAAAAAAAAull & ~keep);
  }
  __device__ __forceinline__ void refill() {
    if (cnt < 43) {
      buf |= window() >> cnt;
      pos += (63 - cnt) >> 3;
      cnt |= 56;
      fetch();
    }
  }
  __device__ __forceinline__ void start(const uint8_t* data, int n, int bit) {
    p = data;
    len = n;
    pos = bit >> 3;
    cnt = 0;
    buf = 0;
    fetch();
    refill();
    consume(bit & 7);
  }
  __device__ __forceinline__ uint32_t top11() const {
    return static_cast<uint32_t>(buf >> 53);
  }
  __device__ __forceinline__ uint32_t peek32() const {
    return static_cast<uint32_t>(buf >> 32);
  }
  __device__ __forceinline__ void consume(int n) {
    buf <<= n;
    cnt -= n;
  }
  __device__ __forceinline__ int consumed_bits() const { return pos * 8 - cnt; }

  // One step up to the table index: the index, then the refill.
  __device__ __forceinline__ uint32_t step() {
    const uint32_t idx = top11();
    refill();
    return idx;
  }
};

// The `nbits` magnitude bits after a `length`-bit code at the top of
// `buf`, sign-extended per Table F.2 (0 when there are none).
__device__ __forceinline__ int32_t magnitude(uint64_t buf, int length,
                                             int nbits) {
  const uint32_t top = static_cast<uint32_t>((buf << length) >> 32);
  const int32_t raw_bits = static_cast<int32_t>((top >> 1) >> (31 - nbits));
  const int32_t base = (1 << nbits) >> 1;
  return raw_bits < base ? raw_bits - 2 * base + 1 : raw_bits;
}

// A skip entry from shared memory by its shared-space byte address (kept in
// a register, so the loops do not rebuild a generic address each step).
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// Per slot, in shared memory for pass 1: the shared-space addresses of its
// AC table row and of the next slot's DC row, and its component.
struct SlotDesc {
  uint32_t ac_row, next_dc_row;
  int comp, pad;
};

__global__ void __launch_bounds__(kWalkThreads)
boundary_pass(const uint8_t* __restrict__ data,
              const int64_t* __restrict__ lane_start,
              const int32_t* __restrict__ lane_len,
              const int32_t* __restrict__ lane_nblk,
              const int64_t* __restrict__ lane_out, int n_lanes,
              const int32_t* __restrict__ pair,
              const int32_t* __restrict__ hv,
              const int32_t* __restrict__ canon,
              const int32_t* __restrict__ slots, int n_rows, int bpm,
              int lanes_per_warp, int4* __restrict__ meta,
              uint8_t* __restrict__ err_out) {
  extern __shared__ uint32_t s_skip[];
  __shared__ SharedTables st;
  const Tables t = load_tables(s_skip, &st, pair, hv, canon, slots, n_rows, bpm);
  __shared__ SlotDesc s_desc[kMaxSlots];
  __shared__ int32_t s_pred[4 * kWalkThreads];  // DC predictor per comp, lane
  const uint32_t tab = static_cast<uint32_t>(__cvta_generic_to_shared(s_skip));
  constexpr uint32_t kRowBytes = 4 * kT11;
  for (int i = threadIdx.x; i < bpm; i += blockDim.x) {
    const int nxt = i + 1 == bpm ? 0 : i + 1;
    s_desc[i] = SlotDesc{tab + kRowBytes * st.acrow[i],
                         tab + kRowBytes * st.dcrow[nxt], st.comp[i], 0};
  }
  for (int i = threadIdx.x; i < 4 * kWalkThreads; i += blockDim.x) s_pred[i] = 0;
  __syncthreads();

  const int in_warp = threadIdx.x & 31;
  const int lane =
      (blockIdx.x * (kWalkThreads / 32) + (threadIdx.x >> 5)) * lanes_per_warp +
      in_warp;
  if (in_warp >= lanes_per_warp || lane >= n_lanes) return;
  Reader br;
  br.start(data + lane_start[lane], lane_len[lane], 0);
  const int nblk = lane_nblk[lane];
  int4* rec = meta + lane_out[lane];
  int blk = 0, slot = 0, k = 0;
  SlotDesc d = s_desc[0];
  uint32_t row_addr = tab + kRowBytes * st.dcrow[0];  // table of this symbol
  int32_t* pred_of = s_pred + threadIdx.x;
  bool bad = false;
  while (blk < nblk) {
    const uint32_t idx = br.step();
    uint32_t e = lds32(row_addr + 4 * idx);
    const bool dc = k == 0;
    if (e == 0) {
      int sym = 0;
      const int length = t.walk((row_addr - tab) / kRowBytes, br.peek32(), &sym);
      e = make_pair_entry(length, sym, dc);
    }
    // The serial chain first: consume one symbol or two, advance k, pick
    // the next table row. Two only if the first leaves the block open. An
    // invalid prefix (e == 0) consumes nothing and advances nothing.
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
    d = s_desc[slot];
    // Then, on a DC symbol, the prediction and the block's record.
    if (dc) {
      int32_t* pp = pred_of + comp * kWalkThreads;
      const int length = e >> 27;
      const int32_t diff = magnitude(bits, length, (e & 0x3F) - length);
      const int32_t pred = static_cast<int32_t>(
          static_cast<uint32_t>(*pp) + static_cast<uint32_t>(diff));
      *pp = pred;
      rec[blk0] = make_int4(start, pred, lane, slot0);
    }
    if (e == 0) {
      bad = true;
      break;
    }
  }
  for (int b = blk + 1; b < nblk; ++b) rec[b] = make_int4(0, 0, lane, -1);
  const int64_t bitend = static_cast<int64_t>(br.len) * 8;
  err_out[lane] = (bad || br.consumed_bits() > bitend + 8) ? 1 : 0;
}

__global__ void __launch_bounds__(kRowThreads)
block_pass(const uint8_t* __restrict__ data,
           const int64_t* __restrict__ lane_start,
           const int32_t* __restrict__ lane_len,
           const int32_t* __restrict__ skip, const int32_t* __restrict__ hv,
           const int32_t* __restrict__ canon,
           const int32_t* __restrict__ slots, int n_rows, int bpm,
           const int4* __restrict__ meta, int64_t total_rows,
           int32_t* __restrict__ coeffs) {
  extern __shared__ uint32_t s_skip[];
  __shared__ SharedTables st;
  const Tables t = load_tables(s_skip, &st, skip, hv, canon, slots, n_rows, bpm);
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x & 31;
  int32_t* stage =
      reinterpret_cast<int32_t*>(s_skip + n_rows * kT11) + warp * 32 * kStage;
  int4* stage4 = reinterpret_cast<int4*>(stage);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int64_t n_chunks = (total_rows + 31) / 32;

  for (int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       chunk < n_chunks;
       chunk += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t row0 = chunk * 32;
    // Zero the warp's 32 staging rows: 16 B a thread, 512 B a step.
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = i * 32 + tid;
      stage4[(q >> 4) * (kStage / 4) + (q & 15)] = zero;
    }
    __syncwarp();
    const int64_t row = row0 + tid;
    const int4 m = row < total_rows ? meta[row] : make_int4(0, 0, 0, -1);
    if (m.w >= 0) {
      int32_t* out = stage + tid * kStage;
      Reader br;
      br.start(data + lane_start[m.z], lane_len[m.z], m.x);
      out[0] = m.y;
      const uint32_t tab =
          static_cast<uint32_t>(__cvta_generic_to_shared(s_skip));
      const int dcrow = t.dcrow[m.w];
      uint32_t e = lds32(tab + 4 * (dcrow * kT11 + br.step()));
      int sym = 0, length = 0;
      if (e == 0) {
        length = t.walk(dcrow, br.peek32(), &sym);
        e = make_entry(length, sym, true);
      }
      if (e != 0) {
        br.consume(e & 0x3F);
        const int acrow = t.acrow[m.w];
        int k = 1;
        while (k < 64) {
          e = lds32(tab + 4 * (acrow * kT11 + br.step()));
          if (e == 0) {
            length = t.walk(acrow, br.peek32(), &sym);
            e = make_entry(length, sym, false);
          }
          if (e == 0) break;
          const int adv = static_cast<int>(e >> 24);
          // EOB and ZRL carry no magnitude bits: they store a zero at a
          // position not yet written (>= k).
          out[min(k + adv - 1, 63)] =
              magnitude(br.buf, (e >> 8) & 0x1F, (e >> 16) & 0x1F);
          br.consume(e & 0x3F);
          k = min(k + adv, 64);
        }
      }
    }
    __syncwarp();
    // The warp's rows are contiguous in the output: 16 B a thread.
    int4* dst = reinterpret_cast<int4*>(coeffs + row0 * 64);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = i * 32 + tid;
      if (row0 + (q >> 4) < total_rows)
        dst[q] = stage4[(q >> 4) * (kStage / 4) + (q & 15)];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launch K3's two passes on `stream`. All pointers are device pointers:
// the scan bytes and lane arrays; the skip and pair tables [n_rows, 2048]
// (pass 2's and pass 1's), huffval
// [n_rows, 256], canon [n_rows, 15] (i32) of the n_rows table rows the
// slots use, slots [bpm, 3] (component, DC row, AC row); scratch meta
// [total_rows, 4] i32; outputs coeffs [total_rows, 64] i32 and err
// [n_lanes] u8, none initialised. Returns cudaGetLastError() after the
// launches (0 = launched).
int jt_huffman_lanes(const void* data, const void* lane_start,
                     const void* lane_len, const void* lane_nblk,
                     const void* lane_out, int32_t n_lanes, const void* skip,
                     const void* pair, const void* huffval, const void* canon,
                     const void* slots, int32_t n_rows, int32_t bpm,
                     int64_t total_rows, void* meta, void* coeffs, void* err,
                     void* stream) {
  if (n_lanes < 1 || bpm < 1 || bpm > kMaxSlots || n_rows < 1 ||
      n_rows > kMaxRows || total_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t skip_bytes = sizeof(uint32_t) * kT11 * n_rows;
  const size_t stage_bytes = sizeof(int32_t) * kWarps * 32 * kStage;
  static int sms = 0;  // set last, once both kernels may use their memory
  if (sms == 0) {
    int dev = 0, n_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(boundary_pass,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(uint32_t) * kT11 * kMaxRows));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          block_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(sizeof(uint32_t) * kT11 * kMaxRows + stage_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    sms = n_sm;
  }
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ls = static_cast<const int64_t*>(lane_start);
  const auto* ll = static_cast<const int32_t*>(lane_len);
  const auto* sk = static_cast<const int32_t*>(skip);
  const auto* hv = static_cast<const int32_t*>(huffval);
  const auto* cn = static_cast<const int32_t*>(canon);
  const auto* sl = static_cast<const int32_t*>(slots);
  auto* m = static_cast<int4*>(meta);
  // Lanes per warp: the fewest (a power of two) that keep the launch at
  // <= 8 warps per SM, about two per scheduler.
  int lanes_per_warp = 1;
  while (lanes_per_warp < 32 &&
         (n_lanes + lanes_per_warp - 1) / lanes_per_warp > 8 * sms)
    lanes_per_warp *= 2;
  const int per_block = (kWalkThreads / 32) * lanes_per_warp;
  boundary_pass<<<(n_lanes + per_block - 1) / per_block, kWalkThreads,
                  skip_bytes, s>>>(
      d, ls, ll, static_cast<const int32_t*>(lane_nblk),
      static_cast<const int64_t*>(lane_out), n_lanes,
      static_cast<const int32_t*>(pair), hv, cn, sl, n_rows, bpm,
      lanes_per_warp, m, static_cast<uint8_t*>(err));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || total_rows == 0) return static_cast<int>(e);
  // Two blocks of eight warps per SM, each walking warp-sized row chunks.
  const int64_t blocks_needed = (total_rows + kRowThreads - 1) / kRowThreads;
  const int blocks = static_cast<int>(
      blocks_needed < 2 * sms ? blocks_needed : 2 * sms);
  block_pass<<<blocks, kRowThreads, skip_bytes + stage_bytes, s>>>(
      d, ls, ll, sk, hv, cn, sl, n_rows, bpm, m, total_rows,
      static_cast<int32_t*>(coeffs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
