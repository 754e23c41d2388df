// Block-parallel canonical Huffman decode walks for NVIDIA Hopper (sm_90a):
// walk_kernel, the hot/escape walk of the GOP codec's entropy decoder, and
// canon_walk_kernel (below it), the full canonical walk of the intra and
// adaptive video codecs.
//
// walk_kernel replaces the walk of ivclab_tpu/ops/bitpack.py::decode_blocks_hot,
// which is not a Pallas kernel: a jax.lax.while_loop on the device whose bound is
// the device value max(counts), each step one symbol of every block at
// once (boundary compares, table selects, a shift of every block's
// register). Its PyTorch twin, ops/bitpack.py::decode_blocks_hot_plain,
// needs the bound on the host, so it reads the device once a call and
// issues some 60 small launches a step. Here each thread walks one block
// to that block's own count: nothing bounds the walk on the host, and the
// call is one launch.
//
// What it computes, for block b with stream local[b, 0..LW) (32-bit words,
// MSB first, words past LW read as zero) and count n = clamp(counts[b], 0,
// max_syms), symbol by symbol from bit 0:
//   win   = the 32 bits at the block's bit position;
//   L     = min_len + #{k < n_lj : win > lj[k]}   (left-justified bounds);
//   fc,go = first_code[L], group_offset[L] where 0 <= L <= max_len, else 0;
//   code  = win >> (32 - L) where that shift is in [0, 32), else 0;
//   rank  = int32(go + (code - fc) mod 2^32), clamped to [0, n_ranks - 1];
//   value = raw payload ((win << L, 0 unless 0 <= L < 32) >> (32 - raw_bits)) if
//           rank == esc_rank, else alpha_of_rank[rank];
//   advance by L (+ raw_bits on an escape) taken mod 2^32: an advance of
//   exactly 32 moves a whole word, any other keeps its low five bits, as
//   the JAX register shift does.
// out[b, i] is the i-th value for i < n and 0 from n to max_syms. Every
// integer equals the plain walk's, on corrupt streams too.
//
// What bounds it on the H100: bytes. Each block's row is read only as far
// as its bits reach (the 32-byte sectors of ceil(bits / 32) int64 words),
// its count once (B * 4) and its output row written once (B * max_syms *
// 4). A 1080p 8-frame GOP is B = 261,120 blocks of some 36 bits on
// average, at LW = 8 and max_syms = 64: the output row dominates.
// utils/timing.py::decode_walk_bound counts these bytes from a run's own
// block bit totals. The arithmetic, some 40 integer instructions a symbol
// for a mean of under 10 symbols a block, is small beside that.
//
// Design (a first, simple one):
//  - one thread per block, 128 threads a CTA: 2,040 CTAs at 1080p, about
//    all resident at once on 132 SMs, so the walk takes about as long as
//    the longest block's chain of dependent reads;
//  - the boundary, first-code and group-offset tables (at most 64 entries
//    each) in shared memory; the rank-to-symbol table, of any size, read
//    through the read-only cache (__ldg);
//  - each thread keeps a 64-bit bit position into its block's words and
//    builds the window from the two words it spans, as the plain walk does;
//  - the output is written in passes of 32 columns: each thread puts its
//    block's next 32 values (zeros past its count) in a shared tile, and
//    each warp then writes the tile's rows, one 128-byte row segment a
//    store, so every store is coalesced (a thread writing its own row
//    would store 4 bytes 256 bytes away from its neighbours').
// No host-side bound, no reduction and no synchronisation.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;    // output columns a pass: one warp-wide store
constexpr int MAX_TAB = 64;  // boundary entries, and max_len + 1
constexpr int MAX_CODE = 32;  // the canonical format's longest code, in bits

struct Tables {
  const long long* lj;  // [n_lj] left-justified code bounds (int64 compare)
  const long long* fc;  // [max_len + 1] first code of each length (low 32 bits)
  const long long* go;  // [max_len + 1] rank of each length's first code (low 32 bits)
  const long long* ar;  // [n_ranks] alphabet index of each rank (low 32 bits)
  int n_lj;
  int max_len;
  int n_ranks;
  int min_len;
  int esc_rank;  // -1 where the caller's escape rank is no rank of the table
  int raw_bits;
};

__device__ __forceinline__ int low32(long long v) {
  return static_cast<int>(static_cast<uint32_t>(static_cast<unsigned long long>(v)));
}

__global__ void __launch_bounds__(THREADS)
    walk_kernel(const long long* __restrict__ local, int B, int LW,
                const int* __restrict__ counts, Tables t, int max_syms, int* __restrict__ out) {
  __shared__ long long s_lj[MAX_TAB];
  __shared__ uint32_t s_fc[MAX_TAB];
  __shared__ uint32_t s_go[MAX_TAB];
  __shared__ int s_out[THREADS][CHUNK + 1];  // +1: a warp's column writes hit 32 banks
  for (int k = threadIdx.x; k < t.n_lj; k += THREADS) s_lj[k] = t.lj[k];
  for (int k = threadIdx.x; k <= t.max_len; k += THREADS) {
    s_fc[k] = static_cast<uint32_t>(low32(t.fc[k]));
    s_go[k] = static_cast<uint32_t>(low32(t.go[k]));
  }
  __syncthreads();

  // every thread of the CTA takes part in each pass's barriers; one past
  // the last block walks nothing
  const size_t b0 = static_cast<size_t>(blockIdx.x) * THREADS;
  const int rows = B - static_cast<int>(b0) < THREADS ? B - static_cast<int>(b0) : THREADS;
  const int b = static_cast<int>(b0) + threadIdx.x;
  const int cnt = b < B ? counts[b] : 0;
  const int n = cnt < 0 ? 0 : (cnt < max_syms ? cnt : max_syms);
  const long long* row = local + static_cast<size_t>(b) * LW;  // read only below n
  const unsigned long long lw = static_cast<unsigned long long>(LW);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  unsigned long long pos = 0;  // bit position into the block's words
  for (int c0 = 0; c0 < max_syms; c0 += CHUNK) {
    int* tile = s_out[threadIdx.x];
    const int end = n < c0 + CHUNK ? n : c0 + CHUNK;
    int i = c0;
    for (; i < end; ++i) {
      const unsigned long long w = pos >> 5;
      const uint32_t sh = static_cast<uint32_t>(pos & 31);
      const uint32_t w1 = w < lw ? static_cast<uint32_t>(row[w]) : 0u;
      const uint32_t w2 = w + 1 < lw ? static_cast<uint32_t>(row[w + 1]) : 0u;
      const uint32_t win = sh ? (w1 << sh) | (w2 >> (32 - sh)) : w1;

      int past = 0;
      for (int k = 0; k < t.n_lj; ++k) past += static_cast<long long>(win) > s_lj[k];
      const long long L = static_cast<long long>(t.min_len) + past;
      const bool in_tab = L >= 0 && L <= t.max_len;
      const uint32_t fcv = in_tab ? s_fc[L] : 0u;
      const uint32_t gov = in_tab ? s_go[L] : 0u;
      const long long s = 32 - L;
      const uint32_t code_val = (s >= 0 && s < 32) ? win >> s : 0u;
      int rank = static_cast<int>(gov + (code_val - fcv));  // int32 wrap
      rank = rank < 0 ? 0 : (rank > t.n_ranks - 1 ? t.n_ranks - 1 : rank);
      const bool is_esc = rank == t.esc_rank;
      const uint32_t shifted = (L >= 0 && L < 32) ? win << L : 0u;
      const uint32_t raw = static_cast<uint32_t>(static_cast<unsigned long long>(shifted) >>
                                                 (32 - t.raw_bits));
      tile[i - c0] = is_esc ? static_cast<int>(raw) : low32(__ldg(t.ar + rank));
      const uint32_t lu = static_cast<uint32_t>(L + (is_esc ? t.raw_bits : 0));
      pos += lu == 32u ? 32u : (lu & 31u);
    }
    for (; i < c0 + CHUNK; ++i) tile[i - c0] = 0;
    __syncthreads();
    const int width = max_syms - c0 < CHUNK ? max_syms - c0 : CHUNK;
    if (lane < width) {
      for (int r = warp; r < rows; r += WARPS) {
        out[(b0 + r) * max_syms + c0 + lane] = s_out[r][lane];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// canon_walk_kernel: the full canonical walk of one global word stream.
//
// Replaces ivclab_tpu/ops/bitpack.py::decode_blocks_device, also a
// jax.lax.while_loop on the device (not a Pallas kernel) bounded by the
// device value min(max(counts), max_syms), each step one symbol of every
// block. Its PyTorch twin, ops/bitpack.py::decode_blocks_device_plain, needs
// that bound on the host and issues some 15 small launches a step: 2,306
// launches for one 1080p RGB intra decode. Here each thread walks one block
// to its own count, in one launch.
//
// What it computes, for block b with count n = clamp(counts[b], 0, max_syms)
// from the int32 bit position p = offs[b], symbol by symbol:
//   w     = p >> 5 (arithmetic), sh = p & 31; the window's two words are
//           words[idx(w)] and words[idx(min(w + 1, n_words - 1))], where
//           idx(k) adds n_words to a negative k once and then clamps it to
//           [0, n_words - 1] (the rule of JAX's gather);
//   win   = the 32 bits from bit sh of the first word on;
//   L     = min_len + #{k < max_len - 1 : win > lj[k]}
//           + (32 - max_len) * (win > lj[max_len - 1])   (left-justified
//           bounds; those past max_len repeat the last one, so this equals
//           JAX's 31 compares on any code's tables);
//   code  = win >> (32 - L) where 1 <= L <= 32, else 0;
//   idx   = int32(group_offset[min(L, 32)] + uint32(code - first_code[min(L, 32)])),
//           both sums mod 2^32, clamped to [0, n_sym - 1];
//   value = sorted_syms[idx]; p advances by L, mod 2^32 as an int32.
// out[b, i] is the i-th value for i < n and 0 from n to max_syms. Every
// integer equals the plain walk's (and JAX's), on corrupt streams too:
// negative offsets, offsets whose walk crosses 2^31, reads past the stream.
//
// What bounds it on the H100: bytes. The walk must read the 32-byte sectors
// of the int64 words its blocks' bits lie in, each block's offset and count
// (8 B) and write each output row once (B * max_syms * 4).
// utils/timing.py::canon_walk_bound counts these from a run's own offsets
// and bits walked. At 1080p RGB (B = 97,920 blocks, 48 outputs a block) the
// output rows dominate; above the bound the walk waits on the longest
// block's chain of dependent reads (each window's words depend on the
// previous code's length).
//
// Design (a first, simple one, walk_kernel's):
//  - one thread per block, 128 threads a CTA; the blocks of a group are
//    neighbouring threads, so their words share L1 and L2 lines;
//  - the bounds, first codes and group offsets (at most 32, 33 and 33
//    entries) in shared memory; the symbol table, of any size, and the
//    stream's words through the read-only cache (__ldg);
//  - the bit position kept as a uint32, so its int32 wrap is unsigned
//    arithmetic, not signed overflow;
//  - the output staged 32 columns a pass in a shared tile and written by
//    warps as 128-byte row segments, as walk_kernel does.
// No host-side bound, no reduction and no synchronisation.

struct CanonTables {
  const long long* lj;  // [>= max_len] left-justified code bounds (low 32 bits)
  const long long* fc;  // [33] first code of each length (low 32 bits)
  const long long* go;  // [33] rank of each length's first code (low 32 bits)
  const long long* ss;  // [n_sym] symbol of each rank (low 32 bits)
  long long n_sym;
  int max_len;
  int min_len;
};

// JAX's gather index into an n-word stream: a negative index gets n added
// once, then the index is clamped to [0, n - 1].
__device__ __forceinline__ long long stream_index(long long k, long long n) {
  if (k < 0) k += n;
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

__global__ void __launch_bounds__(THREADS)
    canon_walk_kernel(const long long* __restrict__ words, long long n_words,
                      const int* __restrict__ offs, const int* __restrict__ counts, int B,
                      CanonTables t, int max_syms, int* __restrict__ out) {
  __shared__ uint32_t s_lj[MAX_CODE];
  __shared__ uint32_t s_fc[MAX_CODE + 1];
  __shared__ uint32_t s_go[MAX_CODE + 1];
  __shared__ int s_out[THREADS][CHUNK + 1];  // +1: a warp's column writes hit 32 banks
  for (int k = threadIdx.x; k < t.max_len; k += THREADS) {
    s_lj[k] = static_cast<uint32_t>(low32(t.lj[k]));
  }
  for (int k = threadIdx.x; k <= MAX_CODE; k += THREADS) {
    s_fc[k] = static_cast<uint32_t>(low32(t.fc[k]));
    s_go[k] = static_cast<uint32_t>(low32(t.go[k]));
  }
  __syncthreads();
  const int n_head = t.max_len - 1;
  const uint32_t tail = s_lj[t.max_len - 1];
  const int tail_weight = MAX_CODE - t.max_len;

  // every thread of the CTA takes part in each pass's barriers; one past
  // the last block walks nothing
  const size_t b0 = static_cast<size_t>(blockIdx.x) * THREADS;
  const int rows = B - static_cast<int>(b0) < THREADS ? B - static_cast<int>(b0) : THREADS;
  const int b = static_cast<int>(b0) + threadIdx.x;
  const int cnt = b < B ? counts[b] : 0;
  const int n = cnt < 0 ? 0 : (cnt < max_syms ? cnt : max_syms);
  uint32_t pos = b < B ? static_cast<uint32_t>(offs[b]) : 0u;  // int32 bits, wrapping
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int c0 = 0; c0 < max_syms; c0 += CHUNK) {
    int* tile = s_out[threadIdx.x];
    const int end = n < c0 + CHUNK ? n : c0 + CHUNK;
    int i = c0;
    for (; i < end; ++i) {
      const long long w = static_cast<long long>(static_cast<int32_t>(pos) >> 5);
      const uint32_t sh = pos & 31u;
      const long long w_next = w + 1 < n_words - 1 ? w + 1 : n_words - 1;
      const uint32_t w1 = static_cast<uint32_t>(__ldg(words + stream_index(w, n_words)));
      const uint32_t w2 = static_cast<uint32_t>(__ldg(words + stream_index(w_next, n_words)));
      const uint32_t win = sh ? (w1 << sh) | (w2 >> (32 - sh)) : w1;

      int past = 0;
      for (int k = 0; k < n_head; ++k) past += win > s_lj[k];
      past += win > tail ? tail_weight : 0;
      const int L = t.min_len + past;  // in [0, 63]
      const int Lc = L < MAX_CODE ? L : MAX_CODE;
      const uint32_t code_val = (L >= 1 && L <= MAX_CODE) ? win >> (MAX_CODE - L) : 0u;
      const int idx = static_cast<int>(s_go[Lc] + (code_val - s_fc[Lc]));  // int32 wrap
      long long k = idx < 0 ? 0 : idx;
      k = k < t.n_sym - 1 ? k : t.n_sym - 1;
      tile[i - c0] = low32(__ldg(t.ss + k));
      pos += static_cast<uint32_t>(L);
    }
    for (; i < c0 + CHUNK; ++i) tile[i - c0] = 0;
    __syncthreads();
    const int width = max_syms - c0 < CHUNK ? max_syms - c0 : CHUNK;
    if (lane < width) {
      for (int r = warp; r < rows; r += WARPS) {
        out[(b0 + r) * max_syms + c0 + lane] = s_out[r][lane];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// local: [B, LW] int64 words (low 32 bits used); counts: [B] int32; lj:
// [n_lj] int64; first_code, group_offset: [max_len + 1] int64; alpha_of_rank:
// [n_ranks] int64; out: [B, max_syms] int32. All on one device, contiguous.
// Returns 0, or a cudaError_t: cudaErrorInvalidValue for sizes the kernel
// does not take, else the launch's error.
extern "C" int ivc_decode_blocks_hot(const long long* local, int B, int LW, const int* counts,
                                     const long long* lj, int n_lj, const long long* first_code,
                                     const long long* group_offset, int max_len,
                                     const long long* alpha_of_rank, int n_ranks, int min_len,
                                     int esc_rank, int max_syms, int raw_bits, int* out,
                                     void* stream) {
  if (B < 0 || LW < 0 || max_syms < 0 || n_lj < 0 || n_lj > MAX_TAB || max_len < 0 ||
      max_len + 1 > MAX_TAB || n_ranks < 1 || raw_bits < 1 || raw_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || max_syms == 0) return 0;
  Tables t{lj, first_code, group_offset, alpha_of_rank, n_lj, max_len, n_ranks, min_len,
           (esc_rank >= 0 && esc_rank < n_ranks) ? esc_rank : -1, raw_bits};
  const unsigned grid = static_cast<unsigned>((B + THREADS - 1) / THREADS);
  walk_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(local, B, LW, counts, t,
                                                                        max_syms, out);
  return static_cast<int>(cudaGetLastError());
}

// words: [n_words] int64 (low 32 bits used); offs, counts: [B] int32; lj:
// [>= max_len] int64; first_code, group_offset: [33] int64; sorted_syms:
// [n_sym] int64; out: [B, max_syms] int32. All on one device, contiguous.
// Returns 0, or a cudaError_t: cudaErrorInvalidValue for sizes the kernel
// does not take (max_len outside [1, 32], min_len outside [0, 32], no
// symbol, or no word to walk), else the launch's error.
extern "C" int ivc_decode_blocks_device(const long long* words, long long n_words,
                                        const int* offs, const int* counts, int B,
                                        const long long* lj, int max_len,
                                        const long long* first_code,
                                        const long long* group_offset,
                                        const long long* sorted_syms, long long n_sym,
                                        int min_len, int max_syms, int* out, void* stream) {
  if (B < 0 || max_syms < 0 || max_len < 1 || max_len > MAX_CODE || min_len < 0 ||
      min_len > MAX_CODE || n_sym < 1 || n_words < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || max_syms == 0) return 0;
  if (n_words < 1) return static_cast<int>(cudaErrorInvalidValue);
  CanonTables t{lj, first_code, group_offset, sorted_syms, n_sym, max_len, min_len};
  const unsigned grid = static_cast<unsigned>((B + THREADS - 1) / THREADS);
  canon_walk_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      words, n_words, offs, counts, B, t, max_syms, out);
  return static_cast<int>(cudaGetLastError());
}
