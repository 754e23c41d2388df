// The grouped pack's deposit for NVIDIA Hopper (sm_90a): pack_kernel, what
// ops/bitpack.py::pack_codes_grouped_dense_plain computes, in one pass over
// the codes.
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
