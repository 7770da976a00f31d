// The encoder's Huffman pack for Hopper (sm_90a): K2's quantized int16
// coefficient planes -> the entropy-coded bytes of one baseline scan, byte
// stuffing and RST0-7 markers included.
//
// Replaces no TPU kernel: the JAX package packs on the host (its C++
// runtime's jt_encode_scan), and so did the port until this kernel. It is
// the encoder's counterpart of K3, the device Huffman decoder. Its bytes
// equal runtime/native/jpegtpu_enc.cpp::jt_encode_scan's, joined with RST
// markers by runtime.join_segments, for the same planes and tables: the same
// DC prediction (reset at each restart segment), run-length symbols, ZRLs,
// EOB, MSB-first packing, 1-bit padding of a segment's last byte and 0x00
// after every 0xFF. A symbol the tables hold no code for (length 0) writes
// no code bits, as the host packer does.
//
// One thread an 8x8 block in scan order (MCU by MCU, each MCU's slots in
// order), so no thread walks a segment and a frame without restarts packs
// as fast as one with them. Six launches on the caller's stream:
//   1. count: each thread reads its block in zigzag order (eight 16-byte
//      row loads; the 63 AC steps are unrolled with constant indices, so
//      the block stays in registers) and the DC of the block before it in
//      the segment (that block's coefficient 0: a plain read, so blocks are
//      independent), and sums its bits from the tables, held in shared
//      memory as (length << 16) | code. It writes the count, and the thread
//      block the composition of its blocks' steps (below).
//   2. offsets (one thread block): the scan of the thread blocks' steps.
//      A block's step is "add its bits", or "add its bits, then round up to
//      a byte" for the last block of a segment; such steps compose into
//      "add a, round up, add c", so one scan gives every block's bit
//      position in the unstuffed concatenation of byte-aligned segments.
//   3. emit: each thread rescans its thread block's steps, writes its codes
//      MSB-first at its position as big-endian 32-bit words (the words it
//      shares with its neighbours by atomicOr, the others by plain stores),
//      and the last block of a segment its 1-bit padding. The first block
//      of a segment records the segment's first byte.
//   4. 0xFF count: 16 bytes a thread, a sum a thread block.
//   5. 0xFF offsets (one thread block): the scan of those sums, the output
//      length (bytes + 0xFF count + 2 bytes a marker), markers of segments
//      that start at the end.
//   6. scatter: each byte to its place (its index + the 0xFFs before it + 2
//      for each marker before it), a 0x00 after each 0xFF, each RST marker
//      before its segment's first byte; each thread zeroes the 16 bytes it
//      read, so the word buffer is all zero for the next call (the wrapper
//      makes it with zeros, and remakes it after a failed call).
// The caller reads the output length (meta[1]) and copies that many bytes.
//
// Bound on the H100: bytes. A 4K 4:2:0 frame's 194,400 blocks are 24.9 MB
// of int16, read twice (count and emit), and the scan (~1.2 MB at q85) is
// written about three times (words, scatter, zeroing): ~17 us at 3.35 TB/s.
// The arithmetic is a few hundred instructions a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // count and emit: one thread a block
constexpr int kByteThreads = 256;  // 0xFF count and scatter
constexpr int kChunk = 16;         // bytes a thread there
constexpr int kByteTile = kByteThreads * kChunk;
constexpr int kScanThreads = 1024;  // the two offset passes
constexpr int kMaxComp = 4;
constexpr int kMaxSlots = 32;
constexpr unsigned kFull = 0xffffffffu;

// The scan's geometry: component planes (natural order, blocks at
// [by * 8, bx * 8]) and the MCU's slots, as jt_encode_scan takes them.
struct Scan {
  const int16_t* plane[kMaxComp];
  long long stride[kMaxComp];
  int comp_h[kMaxComp], comp_v[kMaxComp], comp_tid[kMaxComp];
  int first_slot[kMaxComp], last_slot[kMaxComp];
  unsigned char slot_comp[kMaxSlots], slot_vi[kMaxSlots], slot_hi[kMaxSlots];
  int bpm;
  int mcus_x;
  long long n_mcus, ri, n_blocks;
};

// A step of the offset scan: x -> x + a (r = 0), or
// x -> round8(x + a) + c (r = 1). Steps compose into steps.
struct Run {
  unsigned long long a, c;
  unsigned int r;
};

__device__ __forceinline__ unsigned long long round8(unsigned long long x) {
  return (x + 7) & ~7ull;
}

__device__ __forceinline__ Run identity() {
  Run x;
  x.a = 0;
  x.c = 0;
  x.r = 0;
  return x;
}

// f first, then g.
__device__ __forceinline__ Run compose(const Run& f, const Run& g) {
  Run h;
  if (!g.r) {
    h.r = f.r;
    h.a = f.r ? f.a : f.a + g.a;
    h.c = f.r ? f.c + g.a : 0;
  } else if (!f.r) {
    h.r = 1;
    h.a = f.a + g.a;
    h.c = g.c;
  } else {
    h.r = 1;
    h.a = f.a;
    h.c = round8(f.c + g.a) + g.c;
  }
  return h;
}

__device__ __forceinline__ unsigned long long apply(const Run& f,
                                                    unsigned long long x) {
  return f.r ? round8(x + f.a) + f.c : x + f.a;
}

__device__ __forceinline__ Run shfl_up(const Run& x, int d) {
  Run y;
  y.a = __shfl_up_sync(kFull, x.a, d);
  y.c = __shfl_up_sync(kFull, x.c, d);
  y.r = __shfl_up_sync(kFull, x.r, d);
  return y;
}

__device__ __forceinline__ Run warp_inclusive(Run x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Run y = shfl_up(x, d);
    if (lane >= d) x = compose(y, x);
  }
  return x;
}

// Exclusive scan of one step a thread over the thread block; every thread
// calls it. `total` gets the composition of all. `sh`: 33 shared Runs.
__device__ Run block_exclusive(const Run& x, Run* sh, Run* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const Run inc = warp_inclusive(x, lane);
  Run exc = shfl_up(inc, 1);
  if (lane == 0) exc = identity();
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const Run ti = warp_inclusive(lane < n_warps ? sh[lane] : identity(), lane);
    Run te = shfl_up(ti, 1);
    if (lane == 0) te = identity();
    __syncwarp();
    if (lane < n_warps) sh[lane] = te;
    if (lane == 31) sh[32] = ti;
  }
  __syncthreads();
  const Run pre = compose(sh[warp], exc);
  *total = sh[32];
  __syncthreads();
  return pre;
}

// The bit positions of tiles [0, n) from their steps `agg`, from 0; returns
// the position after the last. One thread block.
__device__ unsigned long long scan_tiles(const Run* __restrict__ agg,
                                         long long n,
                                         unsigned long long* __restrict__ start,
                                         Run* sh) {
  unsigned long long carry = 0;
  for (long long base = 0; base < n; base += blockDim.x) {
    const long long t = base + threadIdx.x;
    Run total;
    const Run pre = block_exclusive(t < n ? agg[t] : identity(), sh, &total);
    if (t < n) start[t] = apply(pre, carry);
    carry = apply(total, carry);
  }
  return carry;
}

// Coefficient `col` of a block row held as eight int16 in an int4.
__device__ __forceinline__ int half16(const int4& q, int col) {
  const int w = col < 2 ? q.x : col < 4 ? q.y : col < 6 ? q.z : q.w;
  return (col & 1) ? (w >> 16) : static_cast<int>(static_cast<short>(w & 0xffff));
}

__device__ __forceinline__ int magnitude(int v) {
  return v == 0 ? 0 : 32 - __clz(v < 0 ? -v : v);
}

__device__ __forceinline__ uint32_t low_bits(int v, int s) {
  return static_cast<uint32_t>(v < 0 ? v + (1 << s) - 1 : v);
}

struct Counter {
  uint32_t bits = 0;
  __device__ __forceinline__ void put(uint32_t, int len) { bits += len; }
};

// MSB-first writer from bit `at` of a buffer of big-endian 32-bit words. The
// first word and the last (partial) one may hold a neighbour's bits: they
// are OR-ed in; the words between belong to this block alone.
struct Writer {
  uint32_t* words;
  unsigned long long w, first, acc;
  int n;  // bits in acc, the first word's bits before `at` included

  __device__ Writer(uint32_t* out, unsigned long long at)
      : words(out), w(at >> 5), first(at >> 5), acc(0),
        n(static_cast<int>(at & 31)) {}

  __device__ __forceinline__ void put(uint32_t code, int len) {
    acc = (acc << len) | (code & ((1u << len) - 1u));
    n += len;
    if (n >= 32) {
      n -= 32;
      store(static_cast<uint32_t>(acc >> n));
      acc &= (1ull << n) - 1ull;
    }
  }
  __device__ __forceinline__ void store(uint32_t word) {
    const uint32_t be = __byte_perm(word, 0, 0x0123);
    if (w == first)
      atomicOr(words + w, be);
    else
      words[w] = be;
    ++w;
  }
  __device__ __forceinline__ void finish() {
    if (n > 0)
      atomicOr(words + w,
               __byte_perm(static_cast<uint32_t>(acc << (32 - n)), 0, 0x0123));
  }
};

template <class Sink>
__device__ __forceinline__ void put_entry(Sink& out, uint32_t e) {
  out.put(e & 0xffffu, static_cast<int>(e >> 16));
}

template <class Sink>
__device__ __forceinline__ void ac_symbol(Sink& out, const uint32_t* ac,
                                          int run, int v) {
  while (run >= 16) {
    put_entry(out, ac[0xf0]);  // ZRL
    run -= 16;
  }
  const int s = magnitude(v);
  put_entry(out, ac[(run << 4) | s]);
  out.put(low_bits(v, s), s);
}

// Natural indices of the AC coefficients in zigzag order
// (ops/zigzag.py::ZIGZAG_INDICES[1:]).
#define JT_ZIGZAG_AC(X)                                                      \
  X(1) X(8) X(16) X(9) X(2) X(3) X(10) X(17) X(24) X(32) X(25) X(18) X(11)   \
  X(4) X(5) X(12) X(19) X(26) X(33) X(40) X(48) X(41) X(34) X(27) X(20)      \
  X(13) X(6) X(7) X(14) X(21) X(28) X(35) X(42) X(49) X(56) X(57) X(50)      \
  X(43) X(36) X(29) X(22) X(15) X(23) X(30) X(37) X(44) X(51) X(58) X(59)    \
  X(52) X(45) X(38) X(31) X(39) X(46) X(53) X(60) X(61) X(54) X(47) X(55)    \
  X(62) X(63)

#define JT_AC_STEP(nat)                                  \
  {                                                      \
    const int v = half16(rows[(nat) >> 3], (nat) & 7);   \
    if (v == 0) {                                        \
      ++run;                                             \
    } else {                                             \
      ac_symbol(out, ac, run, v);                        \
      run = 0;                                           \
    }                                                    \
  }

// One block's codes: DC difference, AC symbols, EOB (jt_encode_scan's
// encode_block).
template <class Sink>
__device__ __forceinline__ void code_block(Sink& out, const int4 (&rows)[8],
                                           int diff, const uint32_t* dc,
                                           const uint32_t* ac) {
  const int s = magnitude(diff);
  put_entry(out, dc[s]);
  out.put(low_bits(diff, s), s);
  int run = 0;
  JT_ZIGZAG_AC(JT_AC_STEP)
  if (run) put_entry(out, ac[0x00]);  // EOB
}

// Block b of the scan: its rows, its DC difference, its tables, where it
// sits in its segment.
struct Block {
  int4 rows[8];
  int diff;
  int tid;
  long long seg;
  bool first, last;
};

__device__ __forceinline__ const int16_t* block_at(const Scan& g, int slot,
                                                   long long mcu) {
  const int c = g.slot_comp[slot];
  const long long my = mcu / g.mcus_x, mx = mcu - my * g.mcus_x;
  return g.plane[c] +
         (my * g.comp_v[c] + g.slot_vi[slot]) * 8 * g.stride[c] +
         (mx * g.comp_h[c] + g.slot_hi[slot]) * 8;
}

__device__ __forceinline__ void load_block(const Scan& g, long long b,
                                           Block& k) {
  const long long mcu = b / g.bpm;
  const int slot = static_cast<int>(b - mcu * g.bpm);
  const int c = g.slot_comp[slot];
  const long long in_seg = mcu % g.ri;
  const int16_t* blk = block_at(g, slot, mcu);
  const long long st = g.stride[c];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    k.rows[r] = *reinterpret_cast<const int4*>(blk + r * st);
  int prev = 0;  // the DC before, of the same component in the segment
  if (slot != g.first_slot[c])
    prev = *block_at(g, slot - 1, mcu);
  else if (in_seg != 0)
    prev = *block_at(g, g.last_slot[c], mcu - 1);
  k.diff = half16(k.rows[0], 0) - prev;
  k.tid = g.comp_tid[c];
  k.seg = mcu / g.ri;
  k.first = in_seg == 0 && slot == 0;
  k.last = slot == g.bpm - 1 && (in_seg == g.ri - 1 || mcu == g.n_mcus - 1);
}

__device__ __forceinline__ void load_tables(const uint32_t* __restrict__ tables,
                                            uint32_t* tab) {
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
}

__device__ __forceinline__ unsigned ff_in(const uint4& q) {
  return (__popc(__vcmpeq4(q.x, kFull)) + __popc(__vcmpeq4(q.y, kFull)) +
          __popc(__vcmpeq4(q.z, kFull)) + __popc(__vcmpeq4(q.w, kFull))) >> 3;
}

__global__ void __launch_bounds__(kThreads)
pack_count_kernel(const Scan g, const uint32_t* __restrict__ tables,
                  uint32_t* __restrict__ bits, Run* __restrict__ tile_agg) {
  __shared__ uint32_t tab[4 * 256];
  __shared__ Run sh[33];
  load_tables(tables, tab);
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Run x = identity();
  if (b < g.n_blocks) {
    Block k;
    load_block(g, b, k);
    Counter cnt;
    code_block(cnt, k.rows, k.diff, tab + k.tid * 512, tab + k.tid * 512 + 256);
    bits[b] = cnt.bits;
    x.a = cnt.bits;
    x.r = k.last;
  }
  Run total;
  block_exclusive(x, sh, &total);
  if (threadIdx.x == 0) tile_agg[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
pack_offsets_kernel(const Run* __restrict__ tile_agg, long long n_tiles,
                    unsigned long long* __restrict__ tile_start,
                    unsigned long long* __restrict__ meta) {
  __shared__ Run sh[33];
  const unsigned long long end = scan_tiles(tile_agg, n_tiles, tile_start, sh);
  if (threadIdx.x == 0) meta[0] = end >> 3;  // bytes before stuffing
}

__global__ void __launch_bounds__(kThreads)
pack_emit_kernel(const Scan g, const uint32_t* __restrict__ tables,
                 const uint32_t* __restrict__ bits,
                 const unsigned long long* __restrict__ tile_start,
                 uint32_t* __restrict__ words,
                 unsigned long long* __restrict__ seg_start) {
  __shared__ uint32_t tab[4 * 256];
  __shared__ Run sh[33];
  load_tables(tables, tab);
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = b < g.n_blocks;
  Block k;
  Run x = identity();
  if (live) {
    load_block(g, b, k);
    x.a = bits[b];
    x.r = k.last;
  }
  Run total;
  const Run pre = block_exclusive(x, sh, &total);
  if (!live) return;
  const unsigned long long at = apply(pre, tile_start[blockIdx.x]);
  if (k.first) seg_start[k.seg] = at >> 3;
  Writer out(words, at);
  code_block(out, k.rows, k.diff, tab + k.tid * 512, tab + k.tid * 512 + 256);
  if (k.last) {  // pad the segment's last byte with 1-bits
    const int pad = static_cast<int>((8 - ((at + x.a) & 7)) & 7);
    out.put((1u << pad) - 1u, pad);
  }
  out.finish();
}

__global__ void __launch_bounds__(kByteThreads)
pack_ff_count_kernel(const uint8_t* __restrict__ scan,
                     const unsigned long long* __restrict__ meta,
                     Run* __restrict__ ff_tile) {
  __shared__ Run sh[33];
  const unsigned long long n_bytes = meta[0];
  const long long n_tiles = static_cast<long long>((n_bytes + kByteTile - 1) / kByteTile);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const unsigned long long at =
        (static_cast<unsigned long long>(t) * kByteThreads + threadIdx.x) * kChunk;
    Run x = identity();
    if (at < n_bytes) x.a = ff_in(*reinterpret_cast<const uint4*>(scan + at));
    Run total;
    block_exclusive(x, sh, &total);
    if (threadIdx.x == 0) ff_tile[t] = total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
pack_ff_offsets_kernel(const Run* __restrict__ ff_tile,
                       unsigned long long* __restrict__ ff_start,
                       const unsigned long long* __restrict__ seg_start,
                       long long n_segs, unsigned long long* __restrict__ meta,
                       uint8_t* __restrict__ out) {
  __shared__ Run sh[33];
  const unsigned long long n_bytes = meta[0];
  const long long n_tiles = static_cast<long long>((n_bytes + kByteTile - 1) / kByteTile);
  const unsigned long long ff = scan_tiles(ff_tile, n_tiles, ff_start, sh);
  if (threadIdx.x == 0) {
    meta[1] = n_bytes + ff + 2ull * static_cast<unsigned long long>(n_segs - 1);
    // Markers of segments without a byte at the end of the scan.
    for (long long s = n_segs - 1; s >= 1 && seg_start[s] >= n_bytes; --s) {
      const unsigned long long p = n_bytes + ff + 2ull * (s - 1);
      out[p] = 0xff;
      out[p + 1] = static_cast<uint8_t>(0xd0 + ((s - 1) & 7));
    }
  }
}

__global__ void __launch_bounds__(kByteThreads)
pack_scatter_kernel(uint8_t* __restrict__ scan,
                    const unsigned long long* __restrict__ ff_start,
                    const unsigned long long* __restrict__ seg_start,
                    long long n_segs,
                    const unsigned long long* __restrict__ meta,
                    uint8_t* __restrict__ out) {
  __shared__ Run sh[33];
  const unsigned long long n_bytes = meta[0];
  const long long n_tiles = static_cast<long long>((n_bytes + kByteTile - 1) / kByteTile);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const unsigned long long at =
        (static_cast<unsigned long long>(t) * kByteThreads + threadIdx.x) * kChunk;
    uint4 q = make_uint4(0, 0, 0, 0);
    if (at < n_bytes) q = *reinterpret_cast<const uint4*>(scan + at);
    Run x = identity();
    x.a = ff_in(q);
    Run total;
    const Run pre = block_exclusive(x, sh, &total);
    if (at >= n_bytes) continue;
    unsigned long long ff = ff_start[t] + pre.a;  // 0xFF bytes before `at`
    long long lo = 1, hi = n_segs;  // the first segment >= 1 from `at` on
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (seg_start[mid] < at)
        lo = mid + 1;
      else
        hi = mid;
    }
    long long s = lo;
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const unsigned long long j = at + i;
      if (j < n_bytes) {
        for (; s < n_segs && seg_start[s] == j; ++s) {
          const unsigned long long p = j + ff + 2ull * (s - 1);
          out[p] = 0xff;
          out[p + 1] = static_cast<uint8_t>(0xd0 + ((s - 1) & 7));
        }
        const uint8_t byte = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
        const unsigned long long p = j + ff + 2ull * (s - 1);
        out[p] = byte;
        if (byte == 0xff) {
          out[p + 1] = 0;
          ++ff;
        }
      }
    }
    *reinterpret_cast<uint4*>(scan + at) = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

extern "C" {

// Pack one scan on `stream`. Device pointers: planes[c] (int16, natural
// order, rows of stride[c] elements, 16-byte aligned, stride a multiple of
// 8), tables ([2 table ids][DC, AC][256] u32, (length << 16) | code), and
// the wrapper's scratch: bits [n_blocks] u32, tile_agg / tile_start
// [ceil(n_blocks / 128)] (24-byte steps, u64), seg_start [n_segs] u64, scan
// (words; all zero, 16-byte aligned, at least the unstuffed scan rounded up
// to 16 bytes), ff_tile / ff_start [ceil(scan bytes / 4096)], out (at least
// twice the unstuffed scan plus 2 bytes a marker), meta [2] u64 (bytes
// before stuffing, output length). Host arrays: everything else.
// ff_grid thread blocks run the byte passes. Returns the first
// cudaGetLastError() after a launch that is not 0, else 0.
int jt_huffman_encode(const void* const* planes, const int64_t* stride,
                      int32_t n_comp, const int32_t* comp_h,
                      const int32_t* comp_v, const int32_t* comp_tid,
                      const uint8_t* slot_comp, const uint8_t* slot_vi,
                      const uint8_t* slot_hi, int32_t bpm, int32_t mcus_x,
                      int64_t n_mcus, int64_t restart_interval,
                      const void* tables, void* bits, void* tile_agg,
                      void* tile_start, void* seg_start, void* scan,
                      void* ff_tile, void* ff_start, int32_t ff_grid,
                      void* out, void* meta, void* stream) {
  if (n_comp < 1 || n_comp > kMaxComp || bpm < 1 || bpm > kMaxSlots ||
      mcus_x < 1 || n_mcus < 1 || restart_interval < 0 || ff_grid < 1 ||
      reinterpret_cast<uintptr_t>(scan) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Scan g{};
  for (int c = 0; c < n_comp; ++c) {
    if (reinterpret_cast<uintptr_t>(planes[c]) % 16 != 0 || stride[c] % 8 != 0 ||
        comp_h[c] < 1 || comp_v[c] < 1 || comp_tid[c] < 0 || comp_tid[c] > 1)
      return static_cast<int>(cudaErrorInvalidValue);
    g.plane[c] = static_cast<const int16_t*>(planes[c]);
    g.stride[c] = stride[c];
    g.comp_h[c] = comp_h[c];
    g.comp_v[c] = comp_v[c];
    g.comp_tid[c] = comp_tid[c];
    g.first_slot[c] = -1;
  }
  for (int s = 0; s < bpm; ++s) {
    const int c = slot_comp[s];
    if (c >= n_comp) return static_cast<int>(cudaErrorInvalidValue);
    g.slot_comp[s] = slot_comp[s];
    g.slot_vi[s] = slot_vi[s];
    g.slot_hi[s] = slot_hi[s];
    if (g.first_slot[c] < 0) g.first_slot[c] = s;
    g.last_slot[c] = s;
  }
  g.bpm = bpm;
  g.mcus_x = mcus_x;
  g.n_mcus = n_mcus;
  g.ri = restart_interval > 0 ? restart_interval : n_mcus;
  g.n_blocks = n_mcus * bpm;
  const long long n_segs = (n_mcus + g.ri - 1) / g.ri;
  const long long n_tiles = (g.n_blocks + kThreads - 1) / kThreads;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* u32_tables = static_cast<const uint32_t*>(tables);
  auto* agg = static_cast<Run*>(tile_agg);
  auto* starts = static_cast<unsigned long long*>(tile_start);
  auto* segs = static_cast<unsigned long long*>(seg_start);
  auto* m = static_cast<unsigned long long*>(meta);
  auto* bytes = static_cast<uint8_t*>(scan);
  auto* ff_agg = static_cast<Run*>(ff_tile);
  auto* ff_starts = static_cast<unsigned long long*>(ff_start);
  auto* o = static_cast<uint8_t*>(out);
  cudaError_t err;

  pack_count_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(
      g, u32_tables, static_cast<uint32_t*>(bits), agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pack_offsets_kernel<<<1, kScanThreads, 0, st>>>(agg, n_tiles, starts, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pack_emit_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(
      g, u32_tables, static_cast<const uint32_t*>(bits), starts,
      reinterpret_cast<uint32_t*>(bytes), segs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pack_ff_count_kernel<<<ff_grid, kByteThreads, 0, st>>>(bytes, m, ff_agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pack_ff_offsets_kernel<<<1, kScanThreads, 0, st>>>(ff_agg, ff_starts, segs,
                                                      n_segs, m, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pack_scatter_kernel<<<ff_grid, kByteThreads, 0, st>>>(bytes, ff_starts, segs,
                                                        n_segs, m, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}

}  // extern "C"
