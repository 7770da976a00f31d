// K4: word-column Huffman decoder for Hopper (sm_90a).
//
// Replaces the Pallas kernel jpeg_tpu/entropy/device_kernel.py::_make_kernel
// (built by _compiled_kernel4): the v4 tier, which decodes every restart
// segment ("lane") in lockstep over lane-private word columns, one MCU per
// grid step. It keeps that kernel's layout and output contract bit for bit,
// flagged lanes included, and none of its TPU mechanics (select-reduce
// gathers over [T, S], the Kronecker MXU split, the sequential grid with
// VMEM scratch). One thread decodes one lane serially:
//
// - input: words [W, S] int32, big-endian 32-bit words of each lane's
//   segment, 0xAA fill up to W words, lane-minor, so the threads of a warp
//   that read the same word index touch one line; a word index >= W reads 0
//   (the TPU kernel's gather matches no row there);
// - the TPU kernel's 96-bit register (hi, mi, lo) with its bookkeeping: two
//   words appended whenever it holds <= 32 bits, shifts of 32 giving 0 as
//   XLA's do. The TPU kernel decodes a symbol only while the register holds
//   >= 31 bits; a refill leaves >= 33 and a symbol takes at most 32, so that
//   mask is always true here and has no branch;
// - symbols: an 11-bit LUT (len | sym << 8) plus the canonical walk over
//   code lengths 12..16 (mincode / maxcode / valptr), tables of all eight
//   slots in shared memory; Table F.2 sign extension; per-component DC
//   prediction with 32-bit wrap; EOB / ZRL with the run capped at the block
//   end; at most kMaxSteps AC symbols per block;
// - errors: a lane stops at its first invalid prefix or at a block still
//   open after kMaxSteps; that block keeps what it wrote plus its DC
//   predictor, later blocks are zeros. The flag is also set when the lane
//   consumed more than 8 bits past its segment end (cursor > bitend + 8).
//
// Output: out [max_mcus, bpm, 64, S] int32, zigzag order, DC predicted,
// every element written (zeros for inactive lanes and blocks past a lane's
// nblk). A block is staged in shared memory, one column per thread, then
// the warp stores it: the 32 lanes of one (m, slot, k) are 128 contiguous
// bytes. err [S] u8.
//
// Bound on the H100: latency, as K3. Decoding is bit-serial within a lane,
// and a batch of 8 4K frames has 1,080 lanes (34 warps on 132 SMs). Against
// K3 it loads a 32-bit word per 32 bits of stream instead of a byte per 8,
// and its output is 4 B per coefficient for every (lane, block) slot of the
// grid, dense and coalesced. Lane parallelism is the first lever.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT11 = 2048;     // primary LUT entries (11-bit peek)
constexpr int kRows = 8;       // 4 DC + 4 AC table slots
constexpr int kThreads = 32;   // one warp per block spreads lanes over SMs
constexpr int kMaxSlots = 10;  // blocks per MCU (JPEG limit)
constexpr int kMaxSteps = 70;  // AC symbols per block before a lane is flagged

__device__ __forceinline__ uint32_t shr(uint32_t x, int a) {  // a in [0, 32]
  return a >= 32 ? 0u : x >> a;
}
__device__ __forceinline__ uint32_t shl(uint32_t x, int a) {  // a in [0, 32]
  return a >= 32 ? 0u : x << a;
}

// The lane's register: the next `cnt` stream bits, left-aligned in hi:mi:lo,
// zeros after them; `wi` is the next word to append.
struct Register {
  const uint32_t* col;  // words + lane: word i at col[i * stride]
  int64_t stride, n_words;
  int64_t wi;
  int cnt;
  uint32_t hi, mi, lo;

  __device__ uint32_t word(int64_t i) const {
    return i < n_words ? col[i * stride] : 0u;
  }
  __device__ void refill() {
    if (cnt > 32) return;
    const uint32_t w0 = word(wi), w1 = word(wi + 1);
    const int inv = 32 - cnt;
    hi |= shr(w0, cnt);
    mi |= shl(w0, inv) | shr(w1, cnt);
    lo |= shl(w1, inv);
    wi += 2;
    cnt += 64;
  }
  __device__ void consume(int d) {  // d in [0, 32]
    hi = shl(hi, d) | shr(mi, 32 - d);
    mi = shl(mi, d) | shr(lo, 32 - d);
    lo = shl(lo, d);
    cnt -= d;
  }
  // Bits [length, length + nbits) of the register top, sign-extended per
  // Table F.2 (length + nbits <= 32, nbits <= 16).
  __device__ int32_t magnitude(int length, int nbits) const {
    if (nbits == 0) return 0;
    const int32_t raw = static_cast<int32_t>(
        shr(hi, 32 - length - nbits) & ((1u << nbits) - 1));
    const int32_t base = 1 << (nbits - 1);
    return raw < base ? raw - 2 * base + 1 : raw;
  }
  __device__ int64_t cursor() const { return wi * 32 - cnt; }
};

struct Tables {
  uint16_t lut[kRows * kT11];  // len | sym << 8; 0 = resolve canonically
  uint8_t huffval[kRows * 256];
  int32_t canon[kRows * 15];   // per row: mincode[5], maxcode[5], valptr[5]
};

// One symbol from the register top, as the TPU kernel's resolve: the LUT
// entry, else the canonical walk (a code index past the 256 values reads
// symbol 0). Returns the code length (0 = invalid prefix) and sets *sym.
__device__ __forceinline__ int resolve(const Tables& t, int row, uint32_t hi,
                                       int* sym) {
  const uint32_t e = t.lut[row * kT11 + (hi >> 21)];
  if (e & 0x1F) {
    *sym = (e >> 8) & 0xFF;
    return e & 0x1F;
  }
  const int32_t p16 = static_cast<int32_t>(hi >> 16);
  const int32_t* cn = t.canon + row * 15;
  int len = 0, idx = 0;
  for (int i = 0; i < 5; ++i) {
    const int32_t code = p16 >> (4 - i);  // 16 - (12 + i)
    if (cn[5 + i] >= 0 && len == 0 && code >= cn[i] && code <= cn[5 + i]) {
      len = 12 + i;
      idx = cn[10 + i] + code - cn[i];
    }
  }
  *sym = idx < 256 ? t.huffval[row * 256 + idx] : 0;
  return len;
}

__global__ void __launch_bounds__(kThreads)
huffman_words_kernel(const uint32_t* __restrict__ words, int n_words, int S,
                     const int32_t* __restrict__ luts,      // [8, 2048]
                     const int32_t* __restrict__ huffvals,  // [8, 256]
                     const int32_t* __restrict__ canon,     // [8, 15]
                     const int32_t* __restrict__ slots,     // [bpm, 3]
                     int bpm, const int32_t* __restrict__ nblk,
                     const int32_t* __restrict__ bitend, int max_mcus,
                     int32_t* __restrict__ out, uint8_t* __restrict__ err_out) {
  __shared__ Tables t;
  __shared__ int32_t blk[64][kThreads];  // the block being decoded, by column
  __shared__ int s_comp[kMaxSlots], s_dc[kMaxSlots], s_ac[kMaxSlots];
  for (int i = threadIdx.x; i < kRows * kT11; i += blockDim.x)
    t.lut[i] = static_cast<uint16_t>(luts[i]);
  for (int i = threadIdx.x; i < kRows * 256; i += blockDim.x)
    t.huffval[i] = static_cast<uint8_t>(huffvals[i]);
  for (int i = threadIdx.x; i < kRows * 15; i += blockDim.x)
    t.canon[i] = canon[i];
  for (int i = threadIdx.x; i < bpm; i += blockDim.x) {
    s_comp[i] = slots[3 * i];
    s_dc[i] = slots[3 * i + 1];
    s_ac[i] = 4 + slots[3 * i + 2];
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kThreads + tid;
  const bool live = lane < S;  // dead threads still join the warp's stores
  Register r{words + (live ? lane : 0), S, n_words, 2, 64, 0, 0, 0};
  if (live) {
    r.hi = r.word(0);
    r.mi = r.word(1);
  }
  const int n = live ? nblk[lane] : 0;
  int32_t dc[4] = {0, 0, 0, 0};
  bool err = false;
  for (int m = 0; m < max_mcus; ++m) {
    for (int slot = 0; slot < bpm; ++slot) {
      for (int i = 0; i < 64; ++i) blk[i][tid] = 0;
      if (!err && m * bpm + slot < n) {
        int sym;
        r.refill();
        int len = resolve(t, s_dc[slot], r.hi, &sym);
        int coef = 64;
        if (len == 0) {
          err = true;
        } else {
          blk[0][tid] = r.magnitude(len, sym);
          r.consume(len + sym);
          coef = 1;
        }
        for (int step = 0; step < kMaxSteps && coef < 64; ++step) {
          r.refill();
          len = resolve(t, s_ac[slot], r.hi, &sym);
          if (len == 0) {
            err = true;
            break;
          }
          if (sym == 0x00) {  // EOB
            r.consume(len);
            coef = 64;
          } else if (sym == 0xF0) {  // ZRL
            r.consume(len);
            coef = min(coef + 16, 64);
          } else {
            const int size = sym & 0xF;
            const int32_t val = r.magnitude(len, size);
            r.consume(len + size);
            coef += min(sym >> 4, 63 - coef);
            blk[coef][tid] = val;
            ++coef;
          }
        }
        if (coef < 64) err = true;
        const int comp = s_comp[slot];  // DC sums wrap at 32 bits, as in i32
        dc[comp] = static_cast<int32_t>(static_cast<uint32_t>(dc[comp]) +
                                        static_cast<uint32_t>(blk[0][tid]));
        blk[0][tid] = dc[comp];
      }
      __syncwarp();
      if (live) {
        int32_t* dst = out + (static_cast<int64_t>(m) * bpm + slot) * 64 * S + lane;
        for (int i = 0; i < 64; ++i) dst[static_cast<int64_t>(i) * S] = blk[i][tid];
      }
      __syncwarp();
    }
  }
  if (live)
    err_out[lane] =
        (err || r.cursor() > static_cast<int64_t>(bitend[lane]) + 8) ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch K4 on `stream`. All pointers are device pointers; `out` is written
// in full. Returns cudaGetLastError() after the launch (0 = launched).
int jt_huffman_words(const void* words, int32_t n_words, int32_t S,
                     const void* luts, const void* huffvals, const void* canon,
                     const void* slots, int32_t bpm, const void* nblk,
                     const void* bitend, int32_t max_mcus, void* out,
                     void* err, void* stream) {
  if (n_words < 2 || S < 1 || bpm < 1 || bpm > kMaxSlots || max_mcus < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (S + kThreads - 1) / kThreads;
  huffman_words_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, S,
      static_cast<const int32_t*>(luts), static_cast<const int32_t*>(huffvals),
      static_cast<const int32_t*>(canon), static_cast<const int32_t*>(slots),
      bpm, static_cast<const int32_t*>(nblk),
      static_cast<const int32_t*>(bitend), max_mcus,
      static_cast<int32_t*>(out), static_cast<uint8_t*>(err));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
