// Device code shared by the Huffman kernels, K3 (huffman_lanes.cu, byte
// streams), K4 (huffman_words.cu, word columns) and K7 (huffman_spec.cu,
// speculative chunk lanes): the host-built tables' entry formats, the
// canonical walk for codes longer than 11 bits, Table F.2 sign extension,
// the byte-stream reader of K3 and K7, and the bodies of the two passes,
// each a template over the kernel's bit reader (K7 decodes with pass 2's
// DC and AC parts, dc_entry and decode_ac).
//
// A reader R holds a lane's bits left-aligned in a 64-bit buffer `buf` and
// offers
//   top11()          the next 11-bit table index;
//   refill()         below 43 bits, top up from memory loaded at the previous
//                    refill, and load for the next one;
//   peek32()         the top 32 bits;
//   consume(n)       drop n <= 32 bits;
//   consumed_bits()  bits dropped since the lane's first.
// A step is the index, the table lookup by it, then the refill. A symbol
// takes at most 32 bits, so >= 11 bits are left after it: the index never
// waits for the refill, the lookup's latency covers it, and a refill reads
// loads issued at an earlier one.
//
// Pass 1, the boundary walk (walk_lane): one thread per lane. It decodes no
// coefficient values. Its two loops (blocks, AC symbols) are one loop over
// the state (slot in the MCU, coefficient index k), so the lanes of a warp
// advance one step per iteration whatever their block lengths and wait only
// for the lane with the most steps in total. Per step: one shared-memory
// lookup in the pair table (per 11-bit peek: bits consumed and advance of k,
// for two AC symbols at once where both lie within the peek and the first
// leaves the block open), one 64-bit shift, one refill; the canonical walk
// only for codes longer than 11 bits. The table row of the next step is one
// select; the DC predictor lives in shared memory. Per block it stores one
// 16-byte record (start bit, DC predictor after the block, lane, slot).
// Every AC symbol advances k by at least 1 and a block opens at k = 1, so a
// block closes within 63 AC symbols: the walk needs no step counter
// (tests/test_torch_k4_two_pass.py proves it for all 256 symbols).
//
// Pass 2's inner part (decode_block): one thread decodes one block from its
// recorded start bit with the skip table, the same reader and rules, into a
// staging column that the caller has zeroed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace huffman {

constexpr int kT11 = 2048;         // entries per table row (11-bit peek)
constexpr int kMaxRows = 8;        // table rows: at most 4 DC + 4 AC
constexpr int kMaxSlots = 10;      // blocks per MCU (JPEG limit)
constexpr int kWalkThreads = 128;  // pass 1: four warps per thread block
constexpr uint32_t kRowBytes = 4 * kT11;

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

// K3's and K7's reader: a lane's bytes, then 0xAA fill bytes forever. A
// refill, below 43 bits, tops up to 56-63 bits from the bytes loaded at the
// last refill and loads the next ones.
struct ByteReader {
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
};

// Shared-memory layout of both passes: the table rows, then the small tables.
struct SharedTables {
  uint8_t hv[kMaxRows * 256];
  int32_t canon[kMaxRows * 15];
  int comp[kMaxSlots], dcrow[kMaxSlots], acrow[kMaxSlots];
};

__device__ __forceinline__ Tables load_tables(
    uint32_t* s_skip, SharedTables* st, const int32_t* __restrict__ skip,
    const int32_t* __restrict__ hv, const int32_t* __restrict__ canon,
    const int32_t* __restrict__ slots, int n_rows, int bpm) {
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

// The `nbits` magnitude bits after a `length`-bit code at the top of
// `buf`, sign-extended per Table F.2 (0 when there are none).
__device__ __forceinline__ int32_t magnitude(uint64_t buf, int length,
                                             int nbits) {
  const uint32_t top = static_cast<uint32_t>((buf << length) >> 32);
  const int32_t raw_bits = static_cast<int32_t>((top >> 1) >> (31 - nbits));
  const int32_t base = (1 << nbits) >> 1;
  return raw_bits < base ? raw_bits - 2 * base + 1 : raw_bits;
}

// A table entry from shared memory by its shared-space byte address (kept in
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

// Fill pass 1's shared state beside the tables, for a thread block of
// kWalkThreads threads: the slot descriptors `desc` [kMaxSlots] and the DC
// predictors `pred` [4 * kWalkThreads], one per (component, thread). `tab`
// is the shared-space address of the pair table.
__device__ __forceinline__ void init_walk(SlotDesc* desc, int32_t* pred,
                                          const SharedTables& st, uint32_t tab,
                                          int bpm) {
  for (int i = threadIdx.x; i < bpm; i += blockDim.x) {
    const int nxt = i + 1 == bpm ? 0 : i + 1;
    desc[i] = SlotDesc{tab + kRowBytes * st.acrow[i],
                       tab + kRowBytes * st.dcrow[nxt], st.comp[i], 0};
  }
  for (int i = threadIdx.x; i < 4 * kWalkThreads; i += blockDim.x) pred[i] = 0;
  __syncthreads();
}

// Pass 1 over one lane whose reader `br` stands at its first bit: walks
// `nblk` blocks, storing block b's record (start bit, DC predictor after
// it, lane, slot) at *rec_at(b). Stops at the first invalid prefix, whose
// block still gets its record. Returns the number of blocks closed; *bad
// says whether it stopped early.
template <class R, class RecAt>
__device__ __forceinline__ int walk_lane(R& br, const Tables& t,
                                         const SlotDesc* desc, int32_t* pred,
                                         uint32_t tab, int dcrow0, int nblk,
                                         int bpm, int lane, RecAt rec_at,
                                         bool* bad) {
  int blk = 0, slot = 0, k = 0;
  SlotDesc d = desc[0];
  uint32_t row_addr = tab + kRowBytes * dcrow0;  // table of this symbol
  int32_t* pred_of = pred + threadIdx.x;
  *bad = false;
  while (blk < nblk) {
    uint32_t e = lds32(row_addr + 4 * br.top11());
    br.refill();
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
    d = desc[slot];
    // Then, on a DC symbol, the prediction and the block's record.
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

// The skip entry of the DC code at reader `br` (0 for an invalid prefix),
// the reader refilled and nothing consumed.
template <class R>
__device__ __forceinline__ uint32_t dc_entry(R& br, const Tables& t,
                                             uint32_t tab, int dcrow) {
  uint32_t e = lds32(tab + 4 * (dcrow * kT11 + br.top11()));
  br.refill();
  if (e == 0) {
    int sym = 0;
    const int length = t.walk(dcrow, br.peek32(), &sym);
    e = make_entry(length, sym, true);
  }
  return e;
}

// A block's AC symbols from reader `br` just after its DC code: every
// non-zero coefficient to out[k * kStride] (zigzag index k; the caller
// zeroed the column). Returns false at an invalid prefix, keeping what it
// wrote.
template <int kStride, class R>
__device__ __forceinline__ bool decode_ac(R& br, const Tables& t, uint32_t tab,
                                          int acrow, int32_t* out) {
  int k = 1;
  while (k < 64) {
    uint32_t e = lds32(tab + 4 * (acrow * kT11 + br.top11()));
    br.refill();
    if (e == 0) {
      int sym = 0;
      const int length = t.walk(acrow, br.peek32(), &sym);
      e = make_entry(length, sym, false);
    }
    if (e == 0) return false;
    const int adv = static_cast<int>(e >> 24);
    // EOB and ZRL carry no magnitude bits: they store a zero at a
    // position not yet written (>= k).
    out[min(k + adv - 1, 63) * kStride] =
        magnitude(br.buf, (e >> 8) & 0x1F, (e >> 16) & 0x1F);
    br.consume(e & 0x3F);
    k = min(k + adv, 64);
  }
  return true;
}

// Pass 2 for one block: from reader `br` at the block's start bit, write
// the DC predictor `pred` and every non-zero AC coefficient to
// out[k * kStride] (zigzag index k; the caller zeroed the column). Stops at
// an invalid prefix, keeping what it wrote.
template <int kStride, class R>
__device__ __forceinline__ void decode_block(R& br, const Tables& t,
                                             uint32_t tab, int dcrow, int acrow,
                                             int32_t pred, int32_t* out) {
  out[0] = pred;
  const uint32_t e = dc_entry(br, t, tab, dcrow);
  if (e == 0) return;
  br.consume(e & 0x3F);
  decode_ac<kStride>(br, t, tab, acrow, out);
}

// Lanes per warp of pass 1: the fewest (a power of two) that keep the launch
// at <= 8 warps per SM, about two per scheduler. A warp's registers share
// one scoreboard, so its lanes wait for each other's loads.
inline int lanes_per_warp_for(int n_lanes, int sms) {
  int lanes_per_warp = 1;
  while (lanes_per_warp < 32 &&
         (n_lanes + lanes_per_warp - 1) / lanes_per_warp > 8 * sms)
    lanes_per_warp *= 2;
  return lanes_per_warp;
}

// The number of SMs of the current device (0 and *err set on failure).
inline int sm_count(cudaError_t* err) {
  int dev = 0, n_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  return *err == cudaSuccess ? n_sm : 0;
}

}  // namespace huffman
