// Block-parallel canonical Huffman decode walks for NVIDIA Hopper (sm_90a):
// walk_kernel, the hot/escape walk of the GOP codec's entropy decoder, and
// canon_walk_kernel (below it), the full canonical walk of the intra and
// adaptive video codecs. Both share one design (after the two definitions).
//
// walk_kernel replaces the walk of ivclab_tpu/ops/bitpack.py::decode_blocks_hot,
// which is not a Pallas kernel: a jax.lax.while_loop on the device whose bound is
// the device value max(counts), each step one symbol of every block at
// once (boundary compares, table selects, a shift of every block's
// register). Its PyTorch twin, ops/bitpack.py::decode_blocks_hot_plain,
// needs the bound on the host, so it reads the device once a call and
// issues some 60 small launches a step. Here each lane walks one block
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
// canon_walk_kernel replaces ivclab_tpu/ops/bitpack.py::decode_blocks_device,
// also a jax.lax.while_loop on the device (not a Pallas kernel) bounded by
// min(max(counts), max_syms). Its twin, decode_blocks_device_plain, issues
// some 15 small launches a step: 2,306 for one 1080p RGB intra decode.
// What it computes, for block b with count n = clamp(counts[b], 0,
// max_syms) from the int32 bit position p = offs[b], symbol by symbol:
//   w     = p >> 5 (arithmetic), sh = p & 31; the window's two words are
//           words[idx(w)] and words[idx(min(w + 1, n_words - 1))], where
//           idx(k) adds n_words to a negative k once and then clamps it to
//           [0, n_words - 1] (the rule of JAX's gather);
//   win   = the 32 bits from bit sh of the first word on;
//   L     = min_len + #{k < max_len - 1 : win > lj[k]}
//           + (32 - max_len) * (win > lj[max_len - 1])   (those bounds past
//           max_len repeat the last one, so this equals JAX's 31 compares);
//   code  = win >> (32 - L) where 1 <= L <= 32, else 0;
//   idx   = int32(group_offset[min(L, 32)] + uint32(code - first_code[min(L, 32)])),
//           both sums mod 2^32, clamped to [0, n_sym - 1];
//   value = sorted_syms[idx]; p advances by L, mod 2^32 as an int32.
// out[b, i] as above. Every integer equals the plain walk's (and JAX's):
// negative offsets, offsets whose walk crosses 2^31, reads past the stream.
//
// What bounds them on the H100: bytes, and the longest block's chain.
//  - Bytes: each output row is written once (B * max_syms * 4), the words
//    each block's bits lie in are read once, and each block's count (and
//    offset) once. The output rows dominate: 66.8 of 76.2 MB for the 1080p
//    GOP's residual walk (B = 261,120 blocks, LW = 16, max_syms = 64), 18.8
//    of 20.4 MB for the 1088x1920 RGB intra walk (B = 97,920, 48 outputs).
//    utils/timing.py::decode_walk_bound and canon_walk_bound count them from
//    a run's own bits.
//  - The chain: each symbol's window depends on the previous code's length,
//    so a warp takes as long as its longest block's dependent steps (46
//    symbols on the intra walk). The kernels' first design spent most
//    of a step in a linear scan of up to 63 boundaries (64-bit compares in
//    walk_kernel), and its CTAs waited at two barriers a 32-column pass for
//    their longest block; their stores and walks never overlapped.
//
// Design:
//  - A prefix table instead of the boundary scan. Each CTA builds, in its
//    prologue, a table of 2^PREFIX_BITS entries indexed by the window's top
//    bits: the count of boundaries below the prefix's range (what the
//    compares give for every window in it) and the boundaries that lie
//    inside it. A boundary v flips the compare between the windows v and
//    v + 1, so the count is constant over a prefix's windows [lo, hi) when
//    no boundary lies in [lo, hi - 2]; where some do, the entry names them
//    and the lane compares its window against those alone (a canonical
//    code has one or two in such a prefix, of lengths past PREFIX_BITS).
//    The rule holds for any tables: unsorted, duplicate, negative or
//    >= 2^32 boundaries (those count always or never), and the canonical
//    tail's weight of 32 - max_len. ops/bitpack.py::prefix_table states it
//    in plain PyTorch. The table comes from a histogram of the boundaries'
//    prefixes and one scan in shared memory, once a CTA.
//  - Where no boundary lies inside a prefix and its code is no longer than
//    PREFIX_BITS (or is 0), the prefix decides the symbol: the prologue
//    stores the advance and the symbol beside the entry (walk_kernel: or
//    that it is the escape, whose raw field the window holds). Most
//    symbols then cost two shared loads and, in the SASS listing of the
//    sm_90a build (cuobjdump -sass), about 30 instructions where no word is
//    crossed; the others take the count, then the per-count tables (first
//    code, group offset, shifts; one 16-byte shared entry) as before.
//  - 32-bit state: walk_kernel keeps its word index and bit phase as
//    uint32 and three words of its row in registers, loading the one after
//    next when the phase crosses a word, so the load leaves the chain (rows
//    are read through L1, never staged: a block reads about one of its 16
//    words). canon_walk_kernel keeps p as a uint32 (its int32 wrap is
//    unsigned arithmetic) and its three words the same way.
//  - canon_walk_kernel's words in shared memory: each warp copies the
//    STAGE words from its first walking block's first word on (coalesced,
//    the low halves), which cover its 32 neighbouring blocks of a real
//    stream; a word outside that span (corrupt or long blocks, negative or
//    wrapping offsets, reads past the stream) comes from global memory by
//    JAX's index rule. Its first group's counts, offsets and span are read
//    before the prologue, so their latency runs under it.
//  - Warp-private output: a warp walks 32 blocks, one a lane, four symbols
//    to a 16-byte chunk of its tile (one 32-column band of its 32 rows,
//    laid out in the TMA's 128-byte swizzle, which keeps the lanes' chunk
//    writes free of bank conflicts), zeros past each count. Only
//    __syncwarp: a warp waits for its own longest block. Bands past that
//    block are not walked. Where max_syms is a multiple of 4 the copy
//    engine (TMA) stores each walked band from the tile and the bands past
//    the longest count from a zero tile, beside the walk; else the lanes
//    store the rows themselves (see WarpOut).
//  - The grid is capped at what is resident (CTAs an SM times SMs), and
//    each warp strides over the groups of 32 blocks, so the prologue is
//    paid once a resident CTA however large B is.
// No host-side bound, no reduction, no CTA barrier after the prologue.

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BAND = 32;               // output columns a band, 128 bytes of a row
constexpr int TILE_WORDS = 32 * BAND;  // a tile: 32 rows of one band
constexpr int DYN_SMEM = (WARPS + 1) * TILE_WORDS * 4 + 1024;  // tiles, zero tile, alignment
constexpr int MAX_TAB = 64;   // boundary entries, and max_len + 1
constexpr int MAX_CODE = 32;  // the canonical format's longest code, in bits
constexpr int STAGE = 64;     // stream words a warp stages (canon_walk_kernel)
constexpr int PREFIX_BITS = 10;  // faster on the main paths than 8, 9 and 11 (tools/walk_ab.py)
constexpr int PREFIX_N = 1 << PREFIX_BITS;
constexpr int PREFIX_SHIFT = 32 - PREFIX_BITS;
constexpr uint32_t PREFIX_MASK = (1u << PREFIX_SHIFT) - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t RESOLVED = 1u << 31;  // a prefix table entry that decides the code
constexpr uint32_t ESCAPE = 1u << 8;     // walk_kernel: the decided code is the escape
static_assert(PREFIX_N >= THREADS && PREFIX_N % THREADS == 0, "the scan gives each thread whole entries");

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

struct CanonTables {
  const long long* lj;  // [>= max_len] left-justified code bounds (low 32 bits)
  const long long* fc;  // [33] first code of each length (low 32 bits)
  const long long* go;  // [33] rank of each length's first code (low 32 bits)
  const long long* ss;  // [n_sym] symbol of each rank (low 32 bits)
  long long n_sym;
  int max_len;
  int min_len;
};

__device__ __forceinline__ uint32_t low32(long long v) {
  return static_cast<uint32_t>(static_cast<unsigned long long>(v));
}

// The prefix table of one CTA (see the source note).
struct Prefix {
  // entry[p]: bits 0-7 the weight of the boundaries below prefix p's range,
  // bits 8-15 how many lie inside it, bits 16-23 where they start in inner;
  // or, with RESOLVED set, what the prefix alone decides (see each kernel)
  uint32_t entry[PREFIX_N];
  uint32_t value[PREFIX_N];  // the symbol of a RESOLVED prefix
  uint32_t inner[MAX_TAB];   // thresholds (boundary + 1) inside a prefix's range
  uint32_t weight[MAX_TAB];  // and their weights
  int key[MAX_TAB];          // the prefix of each inner boundary, else -1 (build only)
  uint32_t warp_total[WARPS];
};

// Every thread of the CTA calls this. Thread k < n passes boundary k as its
// threshold thr = boundary + 1 in [0, 2^32] (a window exceeds the boundary
// when it is >= thr) and its weight. Windows from 0 to 2^32 - 1 meet a
// threshold of 0 always and one of 2^32 never.
__device__ void build_prefix(Prefix& px, int n, unsigned long long thr, uint32_t w) {
  constexpr int ITEMS = PREFIX_N / THREADS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < PREFIX_N; i += THREADS) px.entry[i] = 0;
  if (tid < MAX_TAB) px.key[tid] = -1;
  __syncthreads();
  // histogram: the weight counts from the prefix after the threshold's
  // (from its own where the threshold opens the range); the low half
  // counts weights, the high half inner boundaries (at most 64 of each)
  int key = -1;
  if (tid < n && w != 0 && thr < (1ull << 32)) {
    const uint32_t t = static_cast<uint32_t>(thr);
    const int tb = static_cast<int>(t >> PREFIX_SHIFT);
    const int inside = (t & PREFIX_MASK) != 0;
    if (tb + inside < PREFIX_N) atomicAdd(&px.entry[tb + inside], w);
    if (inside) {
      atomicAdd(&px.entry[tb], 1u << 16);
      key = tb;
      px.key[tid] = tb;
    }
  }
  __syncthreads();
  // inclusive scan, ITEMS consecutive entries a thread
  uint32_t h[ITEMS];
  uint32_t run = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    h[j] = px.entry[tid * ITEMS + j];
    run += h[j];
  }
  uint32_t incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) px.warp_total[warp] = incl;
  __syncthreads();
  uint32_t acc = incl - run;
  for (int k = 0; k < warp; ++k) acc += px.warp_total[k];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    acc += h[j];
    const uint32_t cnt = h[j] >> 16;
    px.entry[tid * ITEMS + j] = (acc & 0xffu) | (cnt << 8) | (((acc >> 16) - cnt) << 16);
  }
  __syncthreads();
  if (key >= 0) {  // its slot among its prefix's inner boundaries, by index
    int slot = static_cast<int>(px.entry[key] >> 16);
    for (int k = 0; k < tid; ++k) slot += px.key[k] == key;
    px.inner[slot] = static_cast<uint32_t>(thr);
    px.weight[slot] = w;
  }
  __syncthreads();
}

// The weight of the boundaries that win exceeds, from the entry e of its
// prefix (not RESOLVED): the table's count, plus the compares against the
// boundaries inside the prefix, if any.
__device__ __forceinline__ int prefix_count(const Prefix& px, uint32_t e, uint32_t win) {
  int past = static_cast<int>(e & 0xffu);
  const int first = static_cast<int>(e >> 16);
  const int last = first + static_cast<int>((e >> 8) & 0xffu);
  for (int k = first; k < last; ++k) past += win >= px.inner[k] ? static_cast<int>(px.weight[k]) : 0;
  return past;
}

// ---------------------------------------------------------------------------
// Output. A warp's tile holds one band (BAND = 32 columns, 128 bytes) of
// its 32 rows in the layout of the TMA's 128-byte swizzle: the 16-byte
// chunk k of row r sits at r * BAND + 4 * (k ^ (r & 7)) words, so a
// quarter-warp's chunk writes (lane = row) fall in 8 distinct bank groups.
// The walk writes each lane's row a chunk (4 symbols) at a time, zeros past
// its count.
__device__ __forceinline__ int* tile_chunk(int* tile, int r, int k) {
  return tile + r * BAND + ((k ^ (r & 7)) << 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A warp's output. Where max_syms is a multiple of 4 (rows on 16-byte
// boundaries), it goes by TMA, run by the copy engine beside the walk (rows
// past B are clipped): lane 0 stores each walked band from the warp's tile
// and waits, before the walk writes the tile again, until the copy engine
// has read it; the bands past the group's longest count are stored from the
// CTA's zero tile, by lane 0 after the walked bands (walk_kernel, whose
// stores outweigh its walk: issued earlier they would queue ahead of the
// tile's) or by lane 1, on its own bulk groups, as soon as the count is
// known (canon_walk_kernel, whose walk outweighs its stores). Elsewhere the
// lanes store each band's rows from the tile, 128-byte row segments, zeros
// included.
struct WarpOut {
  const CUtensorMap* map;  // out as [B, max_syms] int32, boxes of 32 x BAND, 128-byte swizzle
  int* tile;
  const int* zero;
  int* out;
  int max_syms;
  int lane;
  bool tma;

  __device__ __forceinline__ void store(const int* src, int c0, long long row0) const {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
            reinterpret_cast<unsigned long long>(map)),
        "r"(smem_addr(src)), "r"(c0), "r"(static_cast<int>(row0))
        : "memory");
  }

  // before the walk writes the tile: the last store has read it
  __device__ __forceinline__ void acquire() const {
    if (tma && lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();
  }

  // band c0 of rows [row0, row0 + rows), walked to column c0 + pass_end
  __device__ __forceinline__ void band(long long row0, int rows, int c0, int pass_end) const {
    if (tma) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the walk's writes, to the copy engine
      __syncwarp();
      if (lane == 0) {
        store(tile, c0, row0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      return;
    }
    __syncwarp();
    const int width = max_syms - c0 < BAND ? max_syms - c0 : BAND;
    if (lane < width) {
      for (int r = 0; r < rows; ++r) {
        out[(row0 + r) * max_syms + c0 + lane] =
            lane < pass_end ? tile_chunk(tile, r, lane >> 2)[lane & 3] : 0;
      }
    }
    __syncwarp();
  }

  // the bands from column c0 on, all zeros, stored by lane `by` (TMA only:
  // the row stores take them through band())
  __device__ __forceinline__ void zero_bands(long long row0, int c0, int by) const {
    if (tma && lane == by && c0 < max_syms) {
      for (; c0 < max_syms; c0 += BAND) store(zero, c0, row0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }

  __device__ __forceinline__ void finish() const {
    if (tma && lane < 2) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
};

// The CTA's tiles in dynamic shared memory, on a 1024-byte boundary: one a
// warp, then the zero tile, which the threads clear (call before the CTA's
// first barrier).
__device__ __forceinline__ int* cta_tiles() {
  extern __shared__ unsigned char dyn[];
  int* tiles = reinterpret_cast<int*>(dyn + ((1024 - (smem_addr(dyn) & 1023)) & 1023));
  for (int i = threadIdx.x; i < TILE_WORDS / 4; i += THREADS) {
    reinterpret_cast<int4*>(tiles + WARPS * TILE_WORDS)[i] = make_int4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  return tiles;
}

// Walk one group's bands into the warp's tile and store them: next(i) is
// symbol i of the lane's block (0 past its count), advancing the walk.
// Returns the first band not walked.
template <typename Next>
__device__ __forceinline__ int walk_bands(const WarpOut& o, long long row0, int rows, int n_max,
                                          Next&& next) {
  int c0 = 0;
  for (; c0 < (o.tma ? n_max : o.max_syms); c0 += BAND) {
    const int pass_end = n_max - c0 < 0 ? 0 : (n_max - c0 < BAND ? n_max - c0 : BAND);
    o.acquire();
    int k = 0;
    for (; k < (pass_end + 3) >> 2; ++k) {
      const int i = c0 + 4 * k;
      const int v0 = next(i), v1 = next(i + 1), v2 = next(i + 2), v3 = next(i + 3);
      *reinterpret_cast<int4*>(tile_chunk(o.tile, o.lane, k)) = make_int4(v0, v1, v2, v3);
    }
    for (; k < BAND / 4; ++k) {
      *reinterpret_cast<int4*>(tile_chunk(o.tile, o.lane, k)) = make_int4(0, 0, 0, 0);
    }
    o.band(row0, rows, c0, pass_end);
  }
  return c0;
}

__global__ void __launch_bounds__(THREADS)
    walk_kernel(const long long* __restrict__ local, int B, int LW,
                const int* __restrict__ counts, Tables t, int max_syms, int* __restrict__ out,
                const __grid_constant__ CUtensorMap out_map, bool tma) {
  __shared__ Prefix px;
  __shared__ uint4 s_len[MAX_TAB + 1];  // per count: fc, go, L, code | raw shift << 8
  const int tid = threadIdx.x;
  int* tiles = cta_tiles();
  unsigned long long thr = 0;
  if (tid < t.n_lj) {
    const long long v = t.lj[tid];
    thr = v < 0 ? 0ull : (v >= 0xFFFFFFFFll ? 1ull << 32 : static_cast<unsigned long long>(v) + 1);
  }
  if (tid <= t.n_lj) {
    const long long L = static_cast<long long>(t.min_len) + tid;
    const bool in_tab = L >= 0 && L <= t.max_len;
    const uint32_t code_sh = (L >= 1 && L <= 32) ? static_cast<uint32_t>(32 - L) : 32u;
    const uint32_t raw_sh = (L >= 0 && L < 32) ? static_cast<uint32_t>(L) : 32u;
    s_len[tid] = make_uint4(in_tab ? low32(t.fc[L]) : 0u, in_tab ? low32(t.go[L]) : 0u,
                            low32(L), code_sh | (raw_sh << 8));
  }
  build_prefix(px, t.n_lj, thr, 1u);
  // a prefix with no boundary inside decides the code where L <= PREFIX_BITS
  // or the code is 0 (L outside [1, 32]): its advance, whether it is the
  // escape (then its raw field's shift), else its symbol
  for (int i = tid; i < PREFIX_N; i += THREADS) {
    const uint32_t e = px.entry[i];
    const int past = static_cast<int>(e & 0xffu);
    const long long L = static_cast<long long>(t.min_len) + past;
    if (((e >> 8) & 0xffu) == 0 && !(L > PREFIX_BITS && L <= 32)) {
      const uint4 d = s_len[past];
      const uint32_t code = (L >= 1 && L <= 32) ? static_cast<uint32_t>(i) >> (PREFIX_BITS - L) : 0u;
      int rank = static_cast<int>(d.y + (code - d.x));  // int32 wrap
      rank = rank < 0 ? 0 : (rank > t.n_ranks - 1 ? t.n_ranks - 1 : rank);
      const bool esc = rank == t.esc_rank;
      const uint32_t lu = d.z + (esc ? static_cast<uint32_t>(t.raw_bits) : 0u);
      px.value[i] = esc ? 0u : low32(__ldg(t.ar + rank));
      px.entry[i] = RESOLVED | (lu == 32u ? 32u : (lu & 31u)) | (esc ? ESCAPE : 0u) |
                    ((d.w >> 8) << 16);
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const WarpOut o{&out_map, tiles + warp * TILE_WORDS, tiles + WARPS * TILE_WORDS, out,
                  max_syms, lane, tma};
  const uint32_t lw = static_cast<uint32_t>(LW);
  const uint32_t raw_shift = static_cast<uint32_t>(32 - t.raw_bits);
  const long long n_groups = (static_cast<long long>(B) + 31) / 32;
  for (long long g = static_cast<long long>(blockIdx.x) * WARPS + warp; g < n_groups;
       g += static_cast<long long>(gridDim.x) * WARPS) {
    const long long row0 = g * 32;
    const int rows = B - row0 < 32 ? static_cast<int>(B - row0) : 32;
    const int cnt = lane < rows ? counts[row0 + lane] : 0;
    const int n = cnt < 0 ? 0 : (cnt < max_syms ? cnt : max_syms);
    const int n_max = __reduce_max_sync(FULL, n);
    // the low halves of the block's int64 words, read only below n
    const uint32_t* row = reinterpret_cast<const uint32_t*>(local + (row0 + lane) * LW);
    uint32_t a = 0, nxt = 0, nn = 0;  // words w, w + 1 and w + 2 of the row (0 past LW)
    uint32_t w = 0, sh = 0;           // word index and bit phase
    if (n > 0) {
      a = lw > 0 ? row[0] : 0u;
      nxt = lw > 1 ? row[2] : 0u;
      nn = lw > 2 ? row[4] : 0u;
    }
    const int c_end = walk_bands(o, row0, rows, n_max, [&](int i) -> int {
      const bool act = i < n;
      const uint32_t win = __funnelshift_l(nxt, a, sh);
      const uint32_t pfx = win >> PREFIX_SHIFT;
      const uint32_t e = px.entry[pfx];
      uint32_t value = px.value[pfx];
      uint32_t step = e & 0xffu;
      if (!(e & RESOLVED)) {
        if (act) {
          const uint4 d = s_len[prefix_count(px, e, win)];
          const uint32_t code = __funnelshift_rc(win, 0u, d.w & 0xffu);
          int rank = static_cast<int>(d.y + (code - d.x));  // int32 wrap
          rank = rank < 0 ? 0 : (rank > t.n_ranks - 1 ? t.n_ranks - 1 : rank);
          const bool esc = rank == t.esc_rank;
          value = esc ? __funnelshift_lc(0u, win, d.w >> 8) >> raw_shift : low32(__ldg(t.ar + rank));
          const uint32_t lu = d.z + (esc ? static_cast<uint32_t>(t.raw_bits) : 0u);
          step = lu == 32u ? 32u : (lu & 31u);
        }
      } else if (e & ESCAPE) {
        value = __funnelshift_lc(0u, win, (e >> 16) & 0xffu) >> raw_shift;
      }
      const uint32_t s = sh + (act ? step : 0u);
      if (s >= 32u) {  // one word on (an advance is at most 32 bits); the load
        ++w;           // of the word after next leaves the chain
        a = nxt;
        nxt = nn;
        nn = w + 2 < lw ? row[2 * static_cast<size_t>(w + 2)] : 0u;
      }
      sh = s & 31u;
      return act ? static_cast<int>(value) : 0;
    });
    o.zero_bands(row0, c_end, 0);
  }
  o.finish();
}

// JAX's gather index into an n-word stream: a negative index gets n added
// once, then the index is clamped to [0, n - 1].
__device__ __forceinline__ long long stream_index(long long k, long long n) {
  if (k < 0) k += n;
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

__global__ void __launch_bounds__(THREADS)
    canon_walk_kernel(const long long* __restrict__ words, long long n_words,
                      const int* __restrict__ offs, const int* __restrict__ counts, int B,
                      CanonTables t, int max_syms, int* __restrict__ out,
                      const __grid_constant__ CUtensorMap out_map, bool tma) {
  __shared__ Prefix px;
  __shared__ uint4 s_len[MAX_CODE + 1];  // per count: fc, go, L, code shift
  __shared__ uint32_t s_words[WARPS][STAGE];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long n_groups = (static_cast<long long>(B) + 31) / 32;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  // a group's counts and offsets, then the STAGE words from its first
  // walking block's first word on (the low halves), read before they are
  // needed (the first group's before the prologue)
  int f_cnt = 0;
  uint32_t f_off = 0;
  auto fetch = [&](long long g) {
    const long long r = g * 32 + lane;
    const bool in = g < n_groups && r < B;
    f_cnt = in ? counts[r] : 0;
    f_off = in ? static_cast<uint32_t>(offs[r]) : 0u;
  };
  int base = 0, n_staged = 0;
  uint32_t sw0 = 0, sw1 = 0;
  auto stage = [&](int n_max) {
    const int n = f_cnt < 0 ? 0 : (f_cnt < max_syms ? f_cnt : max_syms);
    const int lo = __reduce_min_sync(FULL, n > 0 ? static_cast<int32_t>(f_off) >> 5 : INT_MAX);
    base = lo < 0 ? 0 : (lo < n_words ? lo : static_cast<int>(n_words));
    n_staged = n_max == 0 ? 0 : (n_words - base < STAGE ? static_cast<int>(n_words - base) : STAGE);
    sw0 = lane < n_staged ? low32(words[base + lane]) : 0u;
    sw1 = lane + 32 < n_staged ? low32(words[base + lane + 32]) : 0u;
  };
  static_assert(STAGE == 64, "two staged words a lane");
  long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
  fetch(g);
  auto group_max = [&]() {
    return __reduce_max_sync(FULL, f_cnt < 0 ? 0 : (f_cnt < max_syms ? f_cnt : max_syms));
  };
  int n_max = group_max();
  stage(n_max);

  int* tiles = cta_tiles();
  unsigned long long thr = 0;
  uint32_t weight = 0;
  if (tid < t.max_len) {
    thr = static_cast<unsigned long long>(low32(t.lj[tid])) + 1;
    weight = tid < t.max_len - 1 ? 1u : static_cast<uint32_t>(MAX_CODE - t.max_len);
  }
  if (tid <= MAX_CODE) {  // counts reach 31: max_len - 1 ones and the tail's 32 - max_len
    const int L = t.min_len + tid;
    const int Lc = L < MAX_CODE ? L : MAX_CODE;
    s_len[tid] = make_uint4(low32(t.fc[Lc]), low32(t.go[Lc]), static_cast<uint32_t>(L),
                            (L >= 1 && L <= MAX_CODE) ? static_cast<uint32_t>(MAX_CODE - L) : 32u);
  }
  build_prefix(px, t.max_len, thr, weight);
  const int last = t.n_sym - 1 < INT_MAX ? static_cast<int>(t.n_sym - 1) : INT_MAX;  // idx <= INT_MAX
  // a prefix with no boundary inside decides the code where L <=
  // PREFIX_BITS or L > 32 (code 0): its L and its symbol
  for (int i = tid; i < PREFIX_N; i += THREADS) {
    const uint32_t e = px.entry[i];
    const int past = static_cast<int>(e & 0xffu);
    const int L = t.min_len + past;
    if (((e >> 8) & 0xffu) == 0 && (L <= PREFIX_BITS || L > MAX_CODE)) {
      const uint4 d = s_len[past];
      const uint32_t code = (L >= 1 && L <= PREFIX_BITS) ? static_cast<uint32_t>(i) >> (PREFIX_BITS - L) : 0u;
      const int idx = static_cast<int>(d.y + (code - d.x));  // int32 wrap
      px.value[i] = low32(__ldg(t.ss + (idx < 0 ? 0 : (idx < last ? idx : last))));
      px.entry[i] = RESOLVED | static_cast<uint32_t>(L);
    }
  }
  __syncthreads();

  const WarpOut o{&out_map, tiles + warp * TILE_WORDS, tiles + WARPS * TILE_WORDS, out,
                  max_syms, lane, tma};
  uint32_t* staged = s_words[warp];
  for (; g < n_groups; g += stride) {
    const long long row0 = g * 32;
    const int rows = B - row0 < 32 ? static_cast<int>(B - row0) : 32;
    const int n = f_cnt < 0 ? 0 : (f_cnt < max_syms ? f_cnt : max_syms);
    uint32_t p = f_off;  // int32, wrapping
    o.zero_bands(row0, (n_max + BAND - 1) & ~(BAND - 1), 1);
    __syncwarp();  // the last group's reads of the span are done
    staged[lane] = sw0;
    staged[lane + 32] = sw1;
    __syncwarp();
    const int span = base, span_n = n_staged, walk_max = n_max;
    // word k of the stream by JAX's index rule, from the staged span where it lies there
    auto word = [&](int k) -> uint32_t {
      const unsigned rel = static_cast<unsigned>(k - span);
      return rel < static_cast<unsigned>(span_n)
                 ? staged[rel]
                 : low32(__ldg(words + stream_index(k, n_words)));
    };
    int w = static_cast<int32_t>(p) >> 5;
    uint32_t a = 0, nxt = 0, nn = 0;  // words w, w + 1 and w + 2
    if (n > 0) {
      a = word(w);
      nxt = word(w + 1);
      nn = word(w + 2);
    }
    walk_bands(o, row0, rows, walk_max, [&](int i) -> int {
      const bool act = i < n;
      const uint32_t win = __funnelshift_l(nxt, a, p);  // shifts by p & 31
      const uint32_t pfx = win >> PREFIX_SHIFT;
      const uint32_t e = px.entry[pfx];
      uint32_t value = px.value[pfx];
      uint32_t L = e & 0xffu;
      if (!(e & RESOLVED) && act) {
        const int past = prefix_count(px, e, win);
        L = static_cast<uint32_t>(t.min_len + past);
        const uint4 d = s_len[past];
        const uint32_t code = __funnelshift_rc(win, 0u, d.w);
        const int idx = static_cast<int>(d.y + (code - d.x));  // int32 wrap
        value = low32(__ldg(t.ss + (idx < 0 ? 0 : (idx < last ? idx : last))));
      }
      p += act ? L : 0u;
      const int wn = static_cast<int32_t>(p) >> 5;
      if (wn == w + 1) {  // one word on: the load of the word after next leaves the chain
        a = nxt;
        nxt = nn;
        nn = word(wn + 2);
      } else if (wn != w) {  // two words on, or a wrap at 2^31
        a = word(wn);
        nxt = word(wn + 1);
        nn = word(wn + 2);
      }
      w = wn;
      return act ? static_cast<int>(value) : 0;
    });
    if (g + stride < n_groups) {  // the next group's inputs
      fetch(g + stride);
      n_max = group_max();
      stage(n_max);
    }
  }
  o.finish();
}

// cuTensorMapEncodeTiled of libcuda, found once through the CUDA runtime
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of out ([B, max_syms] int32, max_syms a multiple of 4) that the
// walks store to: boxes of 32 rows x BAND columns in the 128-byte swizzle.
bool out_map(CUtensorMap* map, int* out, int B, int max_syms) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(max_syms), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(max_syms) * 4};
  const cuuint32_t box[2] = {BAND, 32};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, out, dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per kernel and device, found once a process: the dynamic shared-memory
// opt-in and the CTAs one SM holds times the SMs.
template <typename Kernel>
int resident_ctas(Kernel kernel, unsigned* ctas) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<unsigned> cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  unsigned v = cache[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, DYN_SMEM);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    v = static_cast<unsigned>(sms * per_sm);
    cache[dev].store(v, std::memory_order_relaxed);
  }
  *ctas = v;
  return 0;
}

// The grid (at most what is resident) and the output map for B blocks.
template <typename Kernel>
int prepare(Kernel kernel, int B, int* out, int max_syms, unsigned* grid, CUtensorMap* map,
            bool* tma) {
  unsigned cap = 0;
  const int rc = resident_ctas(kernel, &cap);
  if (rc != 0) return rc;
  const long long ctas = ((static_cast<long long>(B) + 31) / 32 + WARPS - 1) / WARPS;
  *grid = ctas < cap ? static_cast<unsigned>(ctas) : cap;
  *tma = (max_syms & 3) == 0;
  if (*tma && !out_map(map, out, B, max_syms)) return static_cast<int>(cudaErrorNotSupported);
  return 0;
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
  unsigned grid = 0;
  CUtensorMap map{};
  bool tma = false;
  const int rc = prepare(walk_kernel, B, out, max_syms, &grid, &map, &tma);
  if (rc != 0) return rc;
  walk_kernel<<<grid, THREADS, DYN_SMEM, static_cast<cudaStream_t>(stream)>>>(
      local, B, LW, counts, t, max_syms, out, map, tma);
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
  unsigned grid = 0;
  CUtensorMap map{};
  bool tma = false;
  const int rc = prepare(canon_walk_kernel, B, out, max_syms, &grid, &map, &tma);
  if (rc != 0) return rc;
  canon_walk_kernel<<<grid, THREADS, DYN_SMEM, static_cast<cudaStream_t>(stream)>>>(
      words, n_words, offs, counts, B, t, max_syms, out, map, tma);
  return static_cast<int>(cudaGetLastError());
}
