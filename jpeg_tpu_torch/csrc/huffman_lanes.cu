// K3: lane-per-restart-segment Huffman decoder for Hopper (sm_90a).
//
// Replaces the Pallas kernel jpeg_tpu/entropy/device_window.py::
// _make_window_kernel (launched K times by _compiled_window_chain). It keeps
// that kernel's output contract bit for bit and none of its mechanics: no
// word windows, no select or MXU gathers, no Kronecker LUT split, no VMEM
// frame model. One thread decodes one restart segment ("lane") serially,
// reading its bytes straight from a device copy of the scan data:
//
// - bit stream: the segment's bytes followed by 0xAA fill bytes forever
//   (the reference's tail padding, src/jpeg/huffman.rs:240-250); a 64-bit
//   left-aligned buffer is refilled to >= 57 valid bits before every symbol
//   (a code plus its magnitude is at most 32 bits);
// - symbols: an 11-bit LUT (len | sym << 8) plus the canonical walk over
//   code lengths 12..16 (mincode / maxcode / valptr), as the TPU kernel
//   resolves them; tables for all eight slots live in shared memory;
// - Table F.2 sign extension, per-lane per-component DC prediction,
//   EOB / ZRL with the run capped at the block end;
// - errors: a lane stops at its first invalid prefix; the block being
//   decoded keeps what it wrote so far plus its DC predictor, later blocks
//   stay zero. The flag is set when that happened, or when the lane consumed
//   more than 8 bits past its segment end (cursor > bitend + 8). With no
//   window there is no overflow bit.
//
// Output: coefficients [rows, 64] i32, zigzag order, DC predicted; lane l
// owns rows lane_out[l] .. lane_out[l] + lane_nblk[l] - 1 (MCU stream
// order). The caller zero-fills it. err [lanes] u8.
//
// Bound on the H100: latency. Decoding is bit-serial within a lane, and a
// batch of 8 4K frames has 1,080 lanes: 34 warps of one-thread-per-lane
// across 132 SMs, each thread waiting on its own byte loads and table
// lookups, with heavy divergence inside a warp. Lane parallelism (several
// threads per segment, or self-synchronising sub-lanes) is the first lever.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT11 = 2048;     // primary LUT entries (11-bit peek)
constexpr int kRows = 8;       // 4 DC + 4 AC table slots
constexpr int kThreads = 32;   // one warp per block spreads lanes over SMs
constexpr int kMaxSlots = 10;  // blocks per MCU (JPEG limit)

struct BitReader {
  const uint8_t* p;
  int64_t len;
  int64_t pos;   // bytes moved into buf, fill bytes included
  uint64_t buf;  // valid bits left-aligned
  int cnt;       // valid bits in buf

  __device__ void refill() {
    while (cnt <= 56) {
      const uint64_t byte = pos < len ? p[pos] : 0xAAu;
      buf |= byte << (56 - cnt);
      cnt += 8;
      ++pos;
    }
  }
  __device__ uint32_t peek32() const { return static_cast<uint32_t>(buf >> 32); }
  __device__ void consume(int n) {  // n <= 32
    buf <<= n;
    cnt -= n;
  }
  // Magnitude bits [length, length + nbits) of the buffer, sign-extended per
  // Table F.2 (nbits <= 16, length <= 16).
  __device__ int32_t magnitude(int length, int nbits) const {
    if (nbits == 0) return 0;
    const int32_t raw = static_cast<int32_t>((buf << length) >> (64 - nbits));
    const int32_t base = 1 << (nbits - 1);
    return raw < base ? raw - 2 * base + 1 : raw;
  }
  __device__ int64_t consumed_bits() const { return pos * 8 - cnt; }
};

struct Tables {
  uint16_t lut[kRows * kT11];  // len | sym << 8; 0 = resolve canonically
  uint8_t huffval[kRows * 256];
  int32_t canon[kRows * 15];   // per row: mincode[5], maxcode[5], valptr[5]
};

// One symbol from the top of the buffer: (length, symbol); length 0 marks an
// invalid prefix.
__device__ __forceinline__ void resolve(const Tables& t, int row,
                                        uint32_t peek, int* length,
                                        int* sym) {
  const uint32_t e = t.lut[row * kT11 + (peek >> 21)];
  int len = e & 0x1F;
  int s = (e >> 8) & 0xFF;
  if (len == 0) {
    const int32_t p16 = static_cast<int32_t>(peek >> 16);
    const int32_t* cn = t.canon + row * 15;
    for (int i = 0; i < 5; ++i) {
      if (cn[5 + i] < 0) continue;
      const int32_t code = p16 >> (4 - i);  // 16 - (12 + i)
      if (code >= cn[i] && code <= cn[5 + i]) {
        len = 12 + i;
        s = t.huffval[row * 256 + ((cn[10 + i] + code - cn[i]) & 0xFF)];
        break;
      }
    }
  }
  *length = len;
  *sym = s;
}

__global__ void __launch_bounds__(kThreads)
huffman_lanes_kernel(const uint8_t* __restrict__ data,
                     const int64_t* __restrict__ lane_start,
                     const int32_t* __restrict__ lane_len,
                     const int32_t* __restrict__ lane_nblk,
                     const int64_t* __restrict__ lane_out, int n_lanes,
                     const int32_t* __restrict__ lut11,    // [8, 2048]
                     const int32_t* __restrict__ huffval,  // [8, 256]
                     const int32_t* __restrict__ canon,    // [8, 15]
                     const int32_t* __restrict__ slots,    // [bpm, 3]
                     int bpm, int32_t* __restrict__ coeffs,
                     uint8_t* __restrict__ err_out) {
  __shared__ Tables t;
  __shared__ int s_comp[kMaxSlots], s_dc[kMaxSlots], s_ac[kMaxSlots];
  for (int i = threadIdx.x; i < kRows * kT11; i += blockDim.x)
    t.lut[i] = static_cast<uint16_t>(lut11[i]);
  for (int i = threadIdx.x; i < kRows * 256; i += blockDim.x)
    t.huffval[i] = static_cast<uint8_t>(huffval[i]);
  for (int i = threadIdx.x; i < kRows * 15; i += blockDim.x)
    t.canon[i] = canon[i];
  for (int i = threadIdx.x; i < bpm; i += blockDim.x) {
    s_comp[i] = slots[3 * i];
    s_dc[i] = slots[3 * i + 1];
    s_ac[i] = 4 + slots[3 * i + 2];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  BitReader br{data + lane_start[lane], lane_len[lane], 0, 0, 0};
  int32_t dc[4] = {0, 0, 0, 0};
  int err = 0;
  const int nblk = lane_nblk[lane];
  int32_t* out = coeffs + lane_out[lane] * 64;
  for (int blk = 0; blk < nblk && !err; ++blk, out += 64) {
    const int slot = blk % bpm;
    int length, sym;
    br.refill();
    resolve(t, s_dc[slot], br.peek32(), &length, &sym);
    int32_t diff = 0;
    int k = 64;
    if (length == 0) {
      err = 1;
    } else {
      diff = br.magnitude(length, sym);
      br.consume(length + sym);
      k = 1;
    }
    while (k < 64) {
      br.refill();
      resolve(t, s_ac[slot], br.peek32(), &length, &sym);
      if (length == 0) {
        err = 1;
        break;
      }
      if (sym == 0x00) {  // EOB
        br.consume(length);
        break;
      }
      if (sym == 0xF0) {  // ZRL
        br.consume(length);
        k = min(k + 16, 64);
        continue;
      }
      const int size = sym & 0xF;
      const int32_t val = br.magnitude(length, size);
      br.consume(length + size);
      k += min(sym >> 4, 63 - k);
      out[k] = val;
      ++k;
    }
    const int comp = s_comp[slot];  // DC sums wrap at 32 bits, as in i32
    dc[comp] = static_cast<int32_t>(static_cast<uint32_t>(dc[comp]) +
                                    static_cast<uint32_t>(diff));
    out[0] = dc[comp];
  }
  const int64_t bitend = static_cast<int64_t>(br.len) * 8;
  err_out[lane] = (err != 0 || br.consumed_bits() > bitend + 8) ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch K3 on `stream`. All pointers are device pointers; `coeffs` must be
// zero-filled. Returns cudaGetLastError() after the launch (0 = launched).
int jt_huffman_lanes(const void* data, const void* lane_start,
                     const void* lane_len, const void* lane_nblk,
                     const void* lane_out, int32_t n_lanes, const void* lut11,
                     const void* huffval, const void* canon,
                     const void* slots, int32_t bpm, void* coeffs, void* err,
                     void* stream) {
  if (n_lanes < 1 || bpm < 1 || bpm > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  huffman_lanes_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<const int64_t*>(lane_start),
      static_cast<const int32_t*>(lane_len),
      static_cast<const int32_t*>(lane_nblk),
      static_cast<const int64_t*>(lane_out), n_lanes,
      static_cast<const int32_t*>(lut11), static_cast<const int32_t*>(huffval),
      static_cast<const int32_t*>(canon), static_cast<const int32_t*>(slots),
      bpm, static_cast<int32_t*>(coeffs), static_cast<uint8_t*>(err));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
