// The GOP codec's pack for NVIDIA Hopper (sm_90a), in two kernels: map_kernel
// turns quantised blocks into the codes, lengths and counts of a hot/escape
// code (what ops/transform.py::map_gop_hot_plain computes), and pack_kernel
// deposits codes and lengths into word-aligned group substreams (what
// ops/bitpack.py::pack_codes_grouped_dense_plain computes). Both read their
// input once and write their output once.
//
// ---- map_kernel: zero-run, code lookup and pack extents in one pass
//
// It replaces ivclab_tpu/models/fastvideo.py::_map_gop_hot over
// ivclab_tpu/ops/zerorun.py::zerorun_encode_blocks_dense,
// ivclab_tpu/ops/transform.py::map_codes_hot and pack_extents, which are not
// Pallas kernels: XLA operations (one-hot deposits, a compare against every
// hot value, reductions). Their PyTorch twin issues about 90 launches over
// [N, cap] int32 and int64 tensors (a cumsum and a flipped cummin whose
// indices are thrown away, three scatter_add_ deposits, table lookups,
// reductions): 9.6 ms for a 1080p GOP (N = 261,120 blocks) on an H100, 60-120
// times its bytes.
//
// What it computes, for block b (row b of qsyms [N, 64] int32, scan order):
//   nz     = the non-zero positions; last = the last of them (-1: none);
//   a run start is a zero p <= last whose predecessor is non-zero (or p = 0);
//   off(p) = the symbols of the positions before p: 1 a non-zero, 2 a run start;
//   total  = off(64); the block's symbols are its non-zero values at off(p),
//   for a run start a 0 at off(p) and the run's length at off(p) + 1, and EOB
//   at total; slots at or past cap are dropped, the rest of the cap slots
//   are 0; valid[b] = total + 1, also where that exceeds cap;
//   each slot's symbol s - lower_bound (int32, wrapping) maps to its code:
//   in [0, 2^raw_bits) and among the hot values, (F >> 6, F & 63) with F the
//   32-bit sum of the fused entries of every hot value equal to it; else the
//   escape word ((esc_code << raw_bits) | (sym mod 2^32)) mod 2^32 on
//   esc_len + raw_bits bits; codes[b, j] for every slot, lens[b, j] 0 from
//   slot valid[b] on;
//   bw_max = ceil(the most bits of a block / 32), gw_max = the same of a
//   16-block group, cap_ok = the largest valid <= cap (0-d tensors).
//
// What bounds it on the H100: bytes. 64 int32 symbols a block are read once;
// cap int64 codes, cap int32 lengths and a count a block are written once:
// 268 MB for the 1080p GOP at cap 64, 469 MB at cap 128 (0.080 / 0.140 ms;
// utils/timing.py::hot_map_bound). The integer work is a few dozen
// instructions a block and a binary search a coded slot.
//
// Design:
//  - One warp per 16-block group, from its first block to its last, the grid
//    capped at what is resident; the group's bits stay in a register, and
//    the largest block bits, group bits and count are kept per warp, per CTA
//    in shared memory, per CTA in scratch, and reduced by a one-CTA second
//    launch into the three 0-d outputs. No fill, no host read.
//  - A block is two coalesced 128-byte loads, lane l holding positions l and
//    l + 32; the next block's loads are issued before the current one is
//    coded. Two ballots give the 64-bit non-zero mask; the last non-zero,
//    run starts, each position's slot and each run's length come from
//    __clzll, __popcll and __ffsll on it: no scan, no index tensor.
//  - Each lane writes its positions' symbols into the warp's row of cap
//    ints in shared memory; lanes then read the row slot by slot (clearing it
//    for the next block) and write codes and lengths as whole cap-wide rows,
//    zeros included, by coalesced stores.
//  - The hot table is built once a CTA in shared memory: the hot values in
//    [0, 2^raw_bits), each once, sorted, with their fused entries summed.
//    A slot's symbol is found by a binary search of fixed depth over it, for
//    every raw_bits (1-24) alike; symbol 0, most of the slots, is looked up
//    once a warp.
//
// ---- pack_kernel: the grouped deposit
//
// It replaces the deposit of ivclab_tpu/ops/bitpack.py::pack_codes_grouped_dense
// and pack_codes_grouped_dense2, which are not Pallas kernels: XLA operations
// (a while_loop of one-hot masked adds over the slots, a dense phase shift,
// binary roll chains). Their PyTorch twin, pack_codes_grouped_dense_plain,
// issues about 60 int64 launches over [N, S] (two prefix sums, two
// scatter_add_ deposits into [N, BW + 1], the phase shift, a placement
// scatter into a zero-filled arena): 8.1 ms for a 1080p GOP (N = 261,120
// blocks, S = 128 slots) on an H100, about 55 times its bytes.
//
// What it computes, for group g of gs blocks (rows g*gs .. g*gs + gs - 1
// of codes/lens, [N, S]), with BW = block_words, wpg = words_per_group and
// pad_w = next_pow2(wpg + BW + 2):
//   M      = the most slots with a length > 0 in any block of the call;
//   off    = a slot's exclusive prefix sum of its block's lengths (int32);
//   O_b    = block b's exclusive prefix sum of the group's block bits;
//   a slot j < M with L > 0 deposits lj = uint32(code) << ((32 - L) & 31) at
//   bit off of its block's BW-word buffer: p1 = lj >> (off & 31) at word
//   w = off >> 5 where w < BW, p2 = lj << (32 - (off & 31)) (0 at phase 0)
//   at w + 1 where w + 1 < BW;
//   the buffer shifts right by s = O_b & 31 into BW + 1 words, and word k
//   of those is added at (O_b >> 5 + k) & (pad_w - 1) of the group where
//   that is < wpg; every sum is taken mod 2^32.
// Outputs: words [G, wpg] (int64 holding 32-bit words), group_bits [G]
// (int32 of the group's bits), block_offsets [N] (int32 of g*wpg*32 + O_b).
// Within a block the slots' bit fields are disjoint (lj holds at most 32
// bits, at off .. off + 31, and the next slot starts at off + L), so a
// buffer word is the sum of its pieces with no carry, its shift is the sum
// of the pieces' shifts, and each piece can be placed alone: 32-bit adds of
// the placed pieces give the plain version's add-then-mask in every case,
// blocks past BW words, groups past wpg and wrapped arenas included.
// Lengths are taken in [0, 32], the format's (codes are below 2^32); any
// non-negative lengths below 2^31 whose block sums fit an int32 give the
// same words.
//
// What bounds it on the H100: bytes. Codes (8 B) and lengths (4 or 8 B) are
// read once: 401 MB for the 1080p GOP; words (8 B), group bits and offsets
// are written once: G * wpg * 8 B, 134 MB at wpg 1024 (utils/timing.py::
// grouped_pack_bound). The integer work, a few dozen instructions a coded
// slot, and the shared-memory adds are far below that: the codec's blocks
// code a few slots of their 128, so most slots cost a load and a ballot.
//
// Design:
//  - One warp per group, from the first block to the last: the group's
//    offsets O_b come from the running sum of its block totals, so no
//    second pass over the lengths is needed. The grid is capped at what is
//    resident, and warps stride over the groups.
//  - Slots in tiles of 128: lane l loads slots l, l + 32, l + 64, l + 96 of
//    the block (each load instruction 256 or 128 contiguous bytes of the
//    warp), and the next tile's loads are issued before the current one is
//    deposited, so two tiles a warp are in flight.
//  - In-block offsets by a warp scan of each 32 lengths (shuffles) carried
//    across the tile; a block's coded-slot count and last coded slot by
//    ballots. A chunk of 32 slots with no coded slot deposits nothing.
//  - The group's wpg words are a tile in shared memory, zeroed by the warp,
//    filled by 32-bit shared atomicAdd (each piece split as above), and
//    written out whole, zeros included, by coalesced stores (256 contiguous
//    bytes a warp instruction): the output needs no fill. CTAs hold 4
//    warps, fewer where 4 tiles exceed the shared memory a CTA may opt
//    into; wpg is at most MAX_WPG (the codecs' groups take 64-2048 words).
//  - The slot limit M: a group whose every block codes exactly its first
//    count slots (lengths > 0 there, 0 after) has no coded slot at or past
//    M, so the first pass packs it whole. It marks any other group and
//    leaves a per-CTA maximum of the counts; a second launch of the same
//    kernel reads the maxima and repacks the marked groups only. In the
//    codecs' packs a block's slots past its symbol count have length 0, so
//    unless a code gives some symbol length 0 the second launch reads a
//    flag a group and deposits nothing.
// No host-side bound, no fill, no CTA barrier inside the loop.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int CHUNKS = 4;              // chunks of 32 slots a tile
constexpr int TILE_SLOTS = 32 * CHUNKS;
constexpr int WARPS = 4;               // warps a CTA where their tiles fit
constexpr int MAX_PARTS = 8192;        // CTAs at most: per-CTA maxima in scratch
constexpr int MAX_WPG = 48 * 1024;     // words a group: a 192 KB tile, one warp a CTA
constexpr int STATIC_RESERVE = 1024;  // bytes of the opt-in left to static shared memory
constexpr unsigned FULL = 0xffffffffu;

template <typename LenT>
struct Args {
  const long long* __restrict__ codes;  // [N, S]
  const LenT* __restrict__ lens;        // [N, S]
  long long* __restrict__ words;        // [G, wpg]
  int* __restrict__ group_bits;         // [G]
  int* __restrict__ block_offsets;      // [N]
  int* __restrict__ flags;              // [G] scratch: 1 where the second launch repacks
  int* __restrict__ parts;              // [gridDim.x] scratch: per-CTA most coded slots
  long long G;
  long long arena_mask;                 // pad_w - 1
  int S, gs, wpg, bw;
};

// A lane's four slots of a tile; int64 lengths are narrowed to int32 as
// they load (lengths lie in [0, 32]).
struct Slots {
  long long code[CHUNKS];
  int len[CHUNKS];
};

template <typename LenT>
__device__ __forceinline__ void load(Slots& t, const Args<LenT>& a, long long row, int first,
                                     int lane) {
  const long long base = row * a.S;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int j = first + c * 32 + lane;
    if (j < a.S) {
      t.code[c] = __ldcs(a.codes + base + j);
      t.len[c] = static_cast<int>(__ldcs(a.lens + base + j));
    } else {
      t.code[c] = 0;
      t.len[c] = 0;
    }
  }
}

// Adds v at shifted word k of a block placed at word P of its group.
__device__ __forceinline__ void place(uint32_t* tile, long long k, uint32_t v, long long mask,
                                      int wpg) {
  if (v == 0) return;
  const long long t = k & mask;
  if (t < wpg) atomicAdd(tile + t, v);
}

// One coded slot: L bits of code at in-block bit off, of a block at group
// bit O (P = O >> 5, s = O & 31); each piece under the plain version's rules.
__device__ __forceinline__ void deposit(uint32_t* tile, const long long code, int L, int off,
                                        long long P, int s, int bw, long long mask, int wpg) {
  const uint32_t lj = static_cast<uint32_t>(code) << ((32 - L) & 31);
  const int w = off >> 5;
  const int sh = off & 31;
  const uint32_t p1 = lj >> sh;
  const uint32_t p2 = sh ? lj << (32 - sh) : 0u;
  const bool v1 = w < bw;
  const bool v2 = w + 1 < bw;
  const uint32_t a0 = v1 ? p1 >> s : 0u;
  const uint32_t a1 = (v1 && s ? p1 << (32 - s) : 0u) + (v2 ? p2 >> s : 0u);
  const uint32_t a2 = v2 && s ? p2 << (32 - s) : 0u;
  place(tile, P + w, a0, mask, wpg);
  place(tile, P + w + 1, a1, mask, wpg);
  place(tile, P + w + 2, a2, mask, wpg);
}

// FIX = false: the first launch, every group (offsets, bits, flags, per-CTA
// maxima; the words of the groups it does not mark). FIX = true: the
// second, the marked groups' words under the slot limit M.
template <typename LenT, bool FIX>
__global__ void __launch_bounds__(WARPS * 32) pack_kernel(const Args<LenT> a) {
  extern __shared__ uint32_t smem[];
  __shared__ int cta_max;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpc = blockDim.x >> 5;
  if (!FIX) {
    if (threadIdx.x == 0) cta_max = 0;
    __syncthreads();
  }
  const int tpb = (a.S + TILE_SLOTS - 1) / TILE_SLOTS;  // tiles a block
  const int n_tiles = a.gs * tpb;
  int warp_max = 0;  // the most coded slots of a block this warp packed
  int lim = INT_MAX;  // FIX: the slot limit M, read at the first marked group
  bool have_lim = false;
  for (long long g = static_cast<long long>(blockIdx.x) * wpc + warp; g < a.G;
       g += static_cast<long long>(gridDim.x) * wpc) {
    if (FIX) {
      if (a.flags[g] == 0) continue;
      if (!have_lim) {
        int m = 0;
        for (int i = lane; i < static_cast<int>(gridDim.x); i += 32) m = max(m, a.parts[i]);
        lim = __reduce_max_sync(FULL, m);
        have_lim = true;
      }
    }
    long long* row_out = a.words + g * a.wpg;
    uint32_t* tile = smem + static_cast<long long>(warp) * a.wpg;
    for (int t = lane; t < a.wpg; t += 32) tile[t] = 0u;
    __syncwarp();

    long long O = 0;        // the block's in-group bit offset
    bool regular = true;    // every block codes exactly its first count slots
    int carry = 0, count = 0, last = 0;
    const long long row0 = g * a.gs;
    Slots cur, nxt;
    load(cur, a, row0, 0, lane);
    for (int u = 0; u < n_tiles; ++u) {
      const int b = u / tpb;
      const int first = (u - b * tpb) * TILE_SLOTS;
      if (u + 1 < n_tiles) {
        const int b2 = (u + 1) / tpb;
        load(nxt, a, row0 + b2, (u + 1 - b2 * tpb) * TILE_SLOTS, lane);
      }
      if (first == 0) {
        carry = 0;
        count = 0;
        last = 0;
      }
      const long long P = O >> 5;
      const int s = static_cast<int>(O & 31);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int L = cur.len[c];
        const bool coded = L > 0;
        const unsigned m = __ballot_sync(FULL, coded);
        if (m == 0) continue;  // uniform: no coded slot, no bits, nothing to add
        int x = L;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(FULL, x, d);
          if (lane >= d) x += y;
        }
        const int off = carry + x - L;
        carry += __shfl_sync(FULL, x, 31);
        const int j = first + c * 32 + lane;
        count += __popc(m);
        last = first + c * 32 + 32 - __clz(m);
        if (coded && j < lim) {
          deposit(tile, cur.code[c], L, off, P, s, a.bw, a.arena_mask, a.wpg);
        }
      }
      if (first + TILE_SLOTS >= a.S) {  // the block's last tile
        if (!FIX && lane == 0) {
          a.block_offsets[row0 + b] = static_cast<int>(g * a.wpg * 32LL + O);
        }
        regular = regular && count == last;
        warp_max = max(warp_max, count);
        O += carry;
      }
      if (u + 1 < n_tiles) cur = nxt;
    }
    if (!FIX && lane == 0) {
      a.group_bits[g] = static_cast<int>(O);
      a.flags[g] = regular ? 0 : 1;
    }
    __syncwarp();
    if (FIX || regular) {
      for (int t = lane; t < a.wpg; t += 32) row_out[t] = tile[t];
    }
    __syncwarp();
  }
  if (!FIX) {
    if (lane == 0) atomicMax(&cta_max, warp_max);
    __syncthreads();
    if (threadIdx.x == 0) a.parts[blockIdx.x] = cta_max;
  }
}

// The dynamic shared memory a CTA may opt into, less room for the static.
int shared_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *bytes -= STATIC_RESERVE;
  return static_cast<int>(err);
}

// CTAs one SM holds, per device, kernel, CTA size and dynamic shared memory,
// and the opt-in to the device's largest dynamic shared memory, once a
// process each.
struct Residency {
  const void* kernel;
  int dev;
  int threads;
  int smem;
  int ctas;  // CTAs an SM times SMs
};

int resident_ctas(const void* kernel, int threads, int smem, int* ctas) {
  static std::mutex mu;
  static Residency cache[64];
  static int n_cache = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cache; ++i) {
    if (cache[i].kernel == kernel && cache[i].dev == dev && cache[i].threads == threads &&
        cache[i].smem == smem) {
      *ctas = cache[i].ctas;
      return 0;
    }
  }
  int optin = 0, sms = 0, per_sm = 0;
  err = static_cast<cudaError_t>(shared_optin(&optin));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (n_cache < 64) cache[n_cache++] = Residency{kernel, dev, threads, smem, sms * per_sm};
  *ctas = sms * per_sm;
  return 0;
}

template <typename LenT>
int pack(const long long* codes, const LenT* lens, long long N, int S, int gs, int wpg, int bw,
         long long* words, int* group_bits, int* block_offsets, int* scratch, void* stream) {
  const long long G = N / gs;
  long long pad_w = 1;
  while (pad_w < static_cast<long long>(wpg) + bw + 2) pad_w <<= 1;
  const Args<LenT> args{codes, lens, words, group_bits, block_offsets, scratch, scratch + G, G,
                        pad_w - 1, S, gs, wpg, bw};
  int optin = 0;
  int rc = shared_optin(&optin);
  if (rc != 0) return rc;
  const int tile = wpg * 4;
  if (tile > optin) return static_cast<int>(cudaErrorInvalidValue);
  int warps = WARPS;
  while (warps > 1 && warps * tile > optin) --warps;
  const int smem = warps * tile;
  const void* first = reinterpret_cast<const void*>(pack_kernel<LenT, false>);
  const void* second = reinterpret_cast<const void*>(pack_kernel<LenT, true>);
  int cap = 0, cap2 = 0;
  rc = resident_ctas(first, warps * 32, smem, &cap);
  if (rc == 0) rc = resident_ctas(second, warps * 32, smem, &cap2);
  if (rc != 0) return rc;
  long long ctas = (G + warps - 1) / warps;
  ctas = ctas < cap ? ctas : cap;
  ctas = ctas < cap2 ? ctas : cap2;
  ctas = ctas < MAX_PARTS ? ctas : MAX_PARTS;
  const unsigned grid = static_cast<unsigned>(ctas);
  const auto st = static_cast<cudaStream_t>(stream);
  pack_kernel<LenT, false><<<grid, warps * 32, smem, st>>>(args);
  pack_kernel<LenT, true><<<grid, warps * 32, smem, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// ---- map_kernel

constexpr int MAP_WARPS = 8;        // warps a CTA
constexpr int MAP_GROUP = 16;       // blocks a group (the pack's group)
constexpr int MAX_MAP_CAP = 1024;   // slots a block at most
constexpr int MAX_HOT = 4096;       // hot entries at most
constexpr int MAP_PARTS = 3;        // per-CTA maxima: block bits, group bits, count

struct MapArgs {
  const int* __restrict__ qsyms;             // [N, 64]
  const long long* __restrict__ hot_values;  // [K]
  const long long* __restrict__ hot_fused;   // [K]
  long long* __restrict__ codes;             // [N, cap]
  int* __restrict__ lens;                    // [N, cap]
  int* __restrict__ valid;                   // [N]
  int* __restrict__ parts;                   // [gridDim.x * MAP_PARTS] scratch
  long long G;                               // groups
  int cap, K, raw_bits, lower_bound, eob, esc_bits;
  unsigned esc_high;                         // (esc_code << raw_bits) mod 2^32
};

// The hot table: U distinct values in [0, 2^raw_bits), ascending, with the
// 32-bit sum of their fused entries; top the largest power of two <= U.
struct HotTable {
  const int* value;
  const unsigned* fused;
  int U, top;
};

// The code and length of symbol sym (length before the count mask).
__device__ __forceinline__ void lookup(int sym, const HotTable& h, const MapArgs& a,
                                       unsigned& code, int& len) {
  if (sym >= 0 && sym < (1 << a.raw_bits)) {
    int pos = 0;  // the entries below sym
    for (int step = h.top; step > 0; step >>= 1) {
      if (pos + step <= h.U && h.value[pos + step - 1] < sym) pos += step;
    }
    if (pos < h.U && h.value[pos] == sym) {
      const unsigned f = h.fused[pos];
      code = f >> 6;
      len = static_cast<int>(f & 63u);
      return;
    }
  }
  code = a.esc_high | static_cast<unsigned>(sym);
  len = a.esc_bits;
}

// A lane's position p (value x) into the warp's row: a value at its slot, a
// run start's length after its marker (the marker is the row's 0).
__device__ __forceinline__ void place(int* row, int x, int p, unsigned long long M,
                                      unsigned long long R, int cap) {
  const unsigned long long below = (1ull << p) - 1ull;
  const int off = __popcll(M & below) + 2 * __popcll(R & below);
  if ((M >> p) & 1ull) {
    if (off < cap) row[off] = x;
  } else if ((R >> p) & 1ull) {
    if (off + 1 < cap) row[off + 1] = __ffsll(static_cast<long long>(M >> p)) - 1;
  }
}

__global__ void __launch_bounds__(MAP_WARPS * 32) map_kernel(const MapArgs a) {
  extern __shared__ __align__(8) unsigned char map_smem[];
  __shared__ int n_hot;
  __shared__ int cta_max[MAP_PARTS];
  long long* raw_v = reinterpret_cast<long long*>(map_smem);  // [K]
  unsigned* raw_f = reinterpret_cast<unsigned*>(raw_v + a.K);  // [K]
  int* first = reinterpret_cast<int*>(raw_f + a.K);            // [K]
  int* tab_v = first + a.K;                                     // [K]
  unsigned* tab_f = reinterpret_cast<unsigned*>(tab_v + a.K);   // [K]
  int* rows = reinterpret_cast<int*>(tab_f + a.K);              // [MAP_WARPS, cap]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long n = 1LL << a.raw_bits;

  for (int i = tid; i < a.K; i += blockDim.x) {
    raw_v[i] = a.hot_values[i];
    raw_f[i] = static_cast<unsigned>(a.hot_fused[i]);
  }
  for (int t = tid; t < MAP_WARPS * a.cap; t += blockDim.x) rows[t] = 0;
  if (tid == 0) n_hot = 0;
  if (tid < MAP_PARTS) cta_max[tid] = 0;
  __syncthreads();
  // the first entry of each value in [0, 2^raw_bits)
  int mine = 0;
  for (int i = tid; i < a.K; i += blockDim.x) {
    const long long v = raw_v[i];
    bool f = v >= 0 && v < n;
    for (int j = 0; f && j < i; ++j) f = raw_v[j] != v;
    first[i] = f;
    mine += f;
  }
  if (mine) atomicAdd(&n_hot, mine);
  __syncthreads();
  // each first entry at its rank, with the sum of its value's entries
  for (int i = tid; i < a.K; i += blockDim.x) {
    if (!first[i]) continue;
    const long long v = raw_v[i];
    int rank = 0;
    unsigned sum = 0;
    for (int j = 0; j < a.K; ++j) {
      rank += first[j] && raw_v[j] < v;
      sum += raw_v[j] == v ? raw_f[j] : 0u;
    }
    tab_v[rank] = static_cast<int>(v);
    tab_f[rank] = sum;
  }
  __syncthreads();
  const int U = n_hot;
  const HotTable h{tab_v, tab_f, U, U ? 1 << (31 - __clz(U)) : 0};
  unsigned zero_code;  // symbol 0 of a row: most slots
  int zero_len;
  lookup(static_cast<int>(0u - static_cast<unsigned>(a.lower_bound)), h, a, zero_code, zero_len);

  int* row = rows + warp * a.cap;
  int max_block = 0, max_group = 0, max_count = 0;
  const long long stride = static_cast<long long>(gridDim.x) * MAP_WARPS;
  long long g = static_cast<long long>(blockIdx.x) * MAP_WARPS + warp;
  int nx0 = 0, nx1 = 0;
  if (g < a.G) {
    const int* q = a.qsyms + g * MAP_GROUP * 64;
    nx0 = __ldcs(q + lane);
    nx1 = __ldcs(q + 32 + lane);
  }
  for (; g < a.G; g += stride) {
    int group_bits = 0;
    for (int b = 0; b < MAP_GROUP; ++b) {
      const long long r = g * MAP_GROUP + b;
      const int x0 = nx0, x1 = nx1;
      const long long next = b + 1 < MAP_GROUP ? r + 1
                             : (g + stride < a.G ? (g + stride) * MAP_GROUP : -1);
      if (next >= 0) {
        nx0 = __ldcs(a.qsyms + next * 64 + lane);
        nx1 = __ldcs(a.qsyms + next * 64 + 32 + lane);
      }
      const unsigned lo = __ballot_sync(FULL, x0 != 0);
      const unsigned hi = __ballot_sync(FULL, x1 != 0);
      const unsigned long long M = (static_cast<unsigned long long>(hi) << 32) | lo;
      unsigned long long R = 0;
      int total = 0;
      if (M) {
        const int last = 63 - __clzll(static_cast<long long>(M));
        const unsigned long long in_range = last == 63 ? ~0ull : (2ull << last) - 1ull;
        R = ~M & ((M << 1) | 1ull) & in_range;
        total = __popcll(M) + 2 * __popcll(R);
      }
      place(row, x0, lane, M, R, a.cap);
      place(row, x1, lane + 32, M, R, a.cap);
      if (lane == 0 && total < a.cap) row[total] = a.eob;
      __syncwarp();
      const int count = total + 1;
      long long* codes = a.codes + r * a.cap;
      int* lens = a.lens + r * a.cap;
      int bits = 0;
      for (int j = lane; j < a.cap; j += 32) {
        const int s = row[j];
        row[j] = 0;
        unsigned code = zero_code;
        int len = zero_len;
        if (s != 0) {
          lookup(static_cast<int>(static_cast<unsigned>(s) - static_cast<unsigned>(a.lower_bound)),
                 h, a, code, len);
        }
        len = j < count ? len : 0;
        codes[j] = static_cast<long long>(code);
        lens[j] = len;
        bits += len;
      }
      bits = __reduce_add_sync(FULL, bits);
      if (lane == 0) a.valid[r] = count;
      group_bits += bits;
      max_block = max(max_block, bits);
      max_count = max(max_count, count);
      __syncwarp();
    }
    max_group = max(max_group, group_bits);
  }
  if (lane == 0) {
    atomicMax(&cta_max[0], max_block);
    atomicMax(&cta_max[1], max_group);
    atomicMax(&cta_max[2], max_count);
  }
  __syncthreads();
  if (tid < MAP_PARTS) a.parts[static_cast<long long>(blockIdx.x) * MAP_PARTS + tid] = cta_max[tid];
}

// One CTA: the maxima of the map's n_parts CTAs into bw_max, gw_max, cap_ok.
__global__ void __launch_bounds__(256) map_extents_kernel(const int* __restrict__ parts,
                                                          int n_parts, int cap,
                                                          long long* bw_max, long long* gw_max,
                                                          unsigned char* cap_ok) {
  __shared__ int best[MAP_PARTS][8];
  int m[MAP_PARTS] = {0, 0, 0};
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < MAP_PARTS; ++k) m[k] = max(m[k], parts[i * MAP_PARTS + k]);
  }
#pragma unroll
  for (int k = 0; k < MAP_PARTS; ++k) m[k] = __reduce_max_sync(FULL, m[k]);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < MAP_PARTS; ++k) best[k][warp] = m[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
#pragma unroll
      for (int k = 0; k < MAP_PARTS; ++k) m[k] = max(m[k], best[k][w]);
    }
    *bw_max = (m[0] + 31) / 32;
    *gw_max = (m[1] + 31) / 32;
    *cap_ok = m[2] <= cap ? 1 : 0;
  }
}

}  // namespace

// codes: [N, S] int64 (low 32 bits used); lens: [N, S] int32 (len_bytes 4)
// or int64 (8); words: [N / group_size, words_per_group] int64;
// group_bits: [N / group_size] int32; block_offsets: [N] int32; scratch:
// [N / group_size + 8192] int32. All on one device, contiguous; the outputs
// need no initial value. Returns 0, or a cudaError_t: cudaErrorInvalidValue
// for sizes the kernel does not take (N, S, group_size, words_per_group or
// block_words below 1, words_per_group past 49,152, N not a multiple of
// group_size, other length widths), else the launch's error. Runs on
// `stream` without synchronising.
extern "C" int ivc_pack_grouped(const long long* codes, const void* lens, int len_bytes,
                                long long N, int S, int group_size, int words_per_group,
                                int block_words, long long* words, int* group_bits,
                                int* block_offsets, int* scratch, void* stream) {
  if (N < 1 || S < 1 || group_size < 1 || words_per_group < 1 || words_per_group > MAX_WPG ||
      block_words < 1 || N % group_size != 0 || (len_bytes != 4 && len_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (len_bytes == 4) {
    return pack(codes, static_cast<const int*>(lens), N, S, group_size, words_per_group,
                block_words, words, group_bits, block_offsets, scratch, stream);
  }
  return pack(codes, static_cast<const long long*>(lens), N, S, group_size, words_per_group,
              block_words, words, group_bits, block_offsets, scratch, stream);
}

// The scratch ints ivc_pack_grouped needs beyond one a group.
extern "C" int ivc_pack_grouped_parts() { return MAX_PARTS; }

// qsyms: [N, 64] int32; hot_values, hot_fused: [K] int64; codes: [N, cap]
// int64; lens: [N, cap] int32; valid: [N] int32; bw_max, gw_max: 0-d int64;
// cap_ok: 0-d bool (one byte); scratch: [3 * 8192] int32. All on one device,
// contiguous; the outputs need no initial value. esc_high is (esc_code <<
// raw_bits) mod 2^32. Returns 0, or a cudaError_t: cudaErrorInvalidValue for
// sizes the kernel does not take (N below 16 or not a multiple of 16, cap
// outside [1, 1024], K outside [0, 4096], raw_bits outside [1, 24], esc_len
// outside [0, 63 - raw_bits]), else the launch's error. Runs on `stream`
// without synchronising: two launches, map_kernel and map_extents_kernel.
extern "C" int ivc_map_gop_hot(const int* qsyms, long long N, int cap,
                               const long long* hot_values, const long long* hot_fused, int K,
                               int lower_bound, int eob, unsigned esc_high, int esc_len,
                               int raw_bits, long long* codes, int* lens, int* valid,
                               long long* bw_max, long long* gw_max, unsigned char* cap_ok,
                               int* scratch, void* stream) {
  if (N < MAP_GROUP || N % MAP_GROUP != 0 || cap < 1 || cap > MAX_MAP_CAP || K < 0 ||
      K > MAX_HOT || raw_bits < 1 || raw_bits > 24 || esc_len < 0 || esc_len > 63 - raw_bits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long G = N / MAP_GROUP;
  const MapArgs args{qsyms, hot_values, hot_fused, codes, lens, valid, scratch, G, cap, K,
                     raw_bits, lower_bound, eob, esc_len + raw_bits, esc_high};
  const int smem = K * 24 + MAP_WARPS * cap * 4;
  int ctas = 0;
  const int rc = resident_ctas(reinterpret_cast<const void*>(map_kernel), MAP_WARPS * 32, smem,
                               &ctas);
  if (rc != 0) return rc;
  long long grid = (G + MAP_WARPS - 1) / MAP_WARPS;
  grid = grid < ctas ? grid : ctas;
  grid = grid < MAX_PARTS ? grid : MAX_PARTS;
  const auto st = static_cast<cudaStream_t>(stream);
  map_kernel<<<static_cast<unsigned>(grid), MAP_WARPS * 32, smem, st>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  map_extents_kernel<<<1, 256, 0, st>>>(scratch, static_cast<int>(grid), cap, bw_max, gw_max,
                                        cap_ok);
  return static_cast<int>(cudaGetLastError());
}
