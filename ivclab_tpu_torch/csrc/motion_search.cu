// Full-search 8x8 block motion estimation for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of ivclab_tpu/ops/motion_pallas.py:
// _me_kernel (reached through motion_search_pallas, whole frames) and
// _me_tile_kernel (reached through motion_search_tile_pallas, one row band
// of a taller frame with its halo rows). Both compute the same thing: for
// every 8x8 block of the current frame, the SSD against each of the
// (2*sr+1)^2 displaced reference blocks, out-of-frame candidates skipped
// (the reference masks them to +inf, which never wins a strict <), and the
// argmin by strict < in scan order (dy outer, dx inner), written as the
// packed index (dy+sr)*(2*sr+1) + (dx+sr).
//
// What bounds it on the H100: FP32 arithmetic on the CUDA cores. Every
// block costs (2*sr+1)^2 * 64 subtract/multiply/add triples, while the
// input is one read of two frames. At sr=4:
//   1088x1920 frame: 32,640 blocks * 81 * 64 * 3 = 507.6 M FP32 operations,
//     7.58 us at the 67 TFLOP/s peak (16.8 MB read: 5.0 us at 3.35 TB/s);
//   272x1920 band:   8,160 blocks, 126.9 M operations, 1.89 us (4.3 MB).
// The peak counts an FMA as two operations. The SSD may not contract its
// multiply and add into an FMA (that would round once instead of twice and
// move near-ties), so each pair costs three issued instructions, and the
// issue floor at 132 SMs * 128 lanes * 1.98 GHz is 15.2 us for the frame
// and 3.8 us for the band.
//
// Tensor cores are not used. The SSD as sum(c^2) + sum(r^2) - 2 sum(c*r)
// on wgmma or mma.sync rounds its operands (TF32 keeps 10 mantissa bits,
// and squared differences of 8-bit frames reach 65,025), which is why the
// TPU kernel needed Precision.HIGHEST; an int8 path would need integer
// frames, and the reference frame is a float reconstruction.
//
// Design. The first version of this kernel (one thread per block, 64-thread
// CTAs, scalar staging) reached about half of the issue floor; what held it
// back, and what this version does about each:
//  1. Too few threads. A CTA owns a tile of 2x16 blocks (16x128 pixels) and
//     has one warp per dy (2*sr+1 warps, 288 threads at sr=4); each lane
//     takes one block of the tile and scans that dy's 2*sr+1 dx candidates
//     in order, keeping its first strict minimum over the valid ones. The
//     warps' minima meet in shared memory and warp 0 combines them in dy
//     order by strict <, which is the strict < scan of the whole candidate
//     list: a dy whose candidates are all out of the frame offers +inf and
//     never wins. That is 9x the threads: 293,760 for a frame, 73,440 for a
//     band. At most 56 registers a thread at sr=4 keep 4 CTAs (36 warps) on
//     an SM.
//  2. Staging that waited. A CTA is persistent (tiles blockIdx.x,
//     + gridDim.x, ...) with two tile buffers. One thread stages a tile as
//     four 2-D copies on the copy engine (TMA, cp.async.bulk.tensor, one
//     tensor map per plane): box A, the 8+2*sr reference rows that the
//     tile's first block row reads; box B, the same for its second block
//     row; boxes C and D, the current rows of each block row. The engine
//     fills cells outside the plane with zeros, so ragged edges, the rows
//     above and below a frame and a band's halo need no code and no read
//     goes outside a tensor; only masked candidates and blocks outside the
//     frame read such cells. Each box comes in two halves on two mbarriers:
//     the early half (2*sr+4 reference rows, 4 current rows) is all that
//     rows 0..3 of a block read, so the search of a CTA's first tile starts
//     when two thirds of it have landed, and its late half is issued then.
//     The next tile's halves are issued as soon as the current tile's early
//     half has landed and fly while it is searched. 27,136 bytes a buffer at
//     sr=4 (dynamic shared memory, above 48 KB).
//  3. Shared-memory bank conflicts. A 16-byte load is served in 8-lane
//     phases; windows of adjacent blocks 32 bytes apart put lanes 0 and 4 of
//     a phase on the same banks. Here the lanes of a phase are blocks 0-3
//     of the tile's first block row (lanes 0-3, reading boxes A and C) and
//     blocks 0-3 of its second (lanes 4-7, boxes B and D), then blocks 4-7
//     (lanes 8-15), and so on. Boxes B and D start one float4 further left
//     than A and C, every box on a 128-byte boundary with its partner's row
//     pitch, so lanes 4-7 read the odd bank quads where lanes 0-3 read even
//     ones: every window and current-row load is one wavefront per phase.
//  4. A grid that leaves SMs idle. 16-block-wide tiles divide 1920 (240
//     blocks) exactly and 2-block-tall tiles divide a 272-row band (34
//     block rows), so no CTA row is half empty: a band is 15 x 17 = 255
//     tiles, one each for 255 of the 528 resident CTA slots (2 or 1 per
//     SM, every SM busy); a frame is 15 x 68 = 1,020 tiles on 528
//     persistent CTAs, at most 8 tiles per SM against 7.73 on average.
// The row loop issues 227 instructions for its 216 FP32 operations; what
// is left above the issue floor is the first tile's load, the last tiles
// of an SM running with fewer warps, and the per-tile combine.
//  5. Search ranges 8..15 (up to 31 warps and 992 threads a CTA, which
//     leaves a thread 64 registers). A lane cannot hold 2*sr+1
//     accumulators beside its window, so it scans its dy's candidates in
//     passes of at most 8 dx over the block's rows, carrying its strict-<
//     minimum from pass to pass in dx order; each SSD is summed exactly as
//     in one pass. The halo is sr rounded up to a multiple of 4 columns, and
//     a CTA's two buffers take up to 139 KB of shared memory at sr = 15
//     (one CTA per SM there, two at sr = 8).
//  6. Every other search range (sr = 0, and sr >= 16, where one warp per dy
//     would need more than 32 warps a CTA) runs a second kernel,
//     wide_kernel, with sr a runtime argument. It replaces both TPU kernels
//     (_me_kernel, _me_tile_kernel) at those ranges, through both entry
//     points. At sr >= 16 it is bound by operations like me_kernel
//     (blocks * (2*sr+1)^2 * 64 * 3: 0.102 ms at 67 TFLOP/s for a
//     1088x1920 frame at sr = 16, 0.395 ms at sr = 32), and since the SSD
//     may not fuse, by the issue floor above (0.204 and 0.790 ms); at
//     sr = 0 by the bytes (5.0 us). What it does about that:
//     a. A CTA owns a 16x2-block tile, as me_kernel does, with me_kernel's
//        lane map (one lane, one block; free of bank conflicts, note 3),
//        and is persistent over tiles (blockIdx.x, + gridDim.x, ...): a
//        frame is 1,020 tiles on 3 CTAs of 8 warps per SM, a band 255.
//     b. The tile's candidates (clipped to those some block of the tile
//        can take, so chunks wholly outside the frame are never read) are
//        cut into chunks of at most 8 dy rows by 72 dx columns, each from a
//        column on a 16-byte boundary, up to 3 masked columns before the
//        first candidate (a box started off that boundary stopped the
//        kernel with an illegal-instruction fault on the H100). One thread
//        stages a chunk by TMA into one of two buffers while the CTA
//        searches the other: the 16 x 204 reference window of each block
//        row (planes A and B, B from 4 columns further left as in note 3)
//        and the tile's current rows (C and D), 34,816 bytes. Shared memory
//        is 71,696 bytes at every sr: every range up to the int32 limit
//        runs the same kernel at the same occupancy.
//     c. A work unit is one dy and one pass of up to 8 dx: each lane loads
//        a window row as four float4s once and feeds 8 accumulators from
//        it (6 shared loads per 192 FP32 operations), with the row loop as
//        in search_passes, unrolled by 2 (3% faster than 1, as fast as 4,
//        on the H100 at sr 16 and 32). The warps stride over a chunk's
//        units; the last pass of a dy runs a kernel body compiled for just
//        the dx left (1..7), so no accumulator sums a column past dx = +sr
//        (where it would alias a candidate of the next dy) and no lane
//        time is spent on it. No integer divide runs per candidate.
//     d. The order of chunks and warps is free: each lane keeps the
//        lexicographic (SSD, packed index) minimum of its units (keep_min),
//        and warp 0 combines the 8 warps' minima per tile the same way.
//        That is the strict-< scan's choice whatever the order: the first
//        index of the smallest finite SSD. +inf and NaN never win, and a
//        block with no winner gets index 0, the scan's initial best.
//     e. sr = 0 runs the same path: one dy, one pass of one dx.
//     On the H100 (700 W) a 1088x1920 frame takes 9.3 us / 0.31 ms /
//     1.13 ms at sr 0 / 16 / 32, 0.67 and 0.70 of the issue floor at sr
//     16 and 32 (the one-CTA-per-block version it replaced: 43 us / 0.78 ms
//     / 1.9 ms). Above the floor, by count and not timed one by one: a
//     row's 6 loads, pointer steps and branch beside its 192 FP32
//     instructions, each unit's masks and minimum, the tail of 1,020
//     tiles on 396 CTAs (8 tiles on some SMs, 7.73 on average), and the
//     sync at each chunk.
// Each candidate's SSD is summed as before: rows r = 0..7 outer, columns
// k = 0..7 inner, __fsub_rn, __fmul_rn and __fadd_rn from 0.f, so the
// indices equal the one-thread-per-block kernel's on every finite input.
// ptxas reports the registers and spills of each instantiation (-Xptxas -v).
//
// Determinism: no atomics, a fixed summation order and separate rounding,
// so the output is the same on every run. On integer-valued frames every
// SSD is an exact float32 integer (64 * 255^2 < 2^24), so the result equals
// the plain PyTorch version exactly, ties included; the kernel-order plain
// version (ops/motion.py) repeats the summation and equals it on any input.
//
// Row window: the reference tensor map covers the whole plane the caller
// passed (a frame, or a band's [H + 2*sr, W] halo-extended reference), and
// `ref_off` is its row that holds row 0 of `cur` (0 for a frame, sr for a
// band). Candidate validity uses the global rows row0 + r: a candidate is
// valid when its rows lie in [0, total_h) and its columns in [0, W). A
// whole frame (ivc_motion_search) is row0 = 0, total_h = H; a band
// (ivc_motion_search_tile) passes its global first row as row0 and the
// frame height as total_h, so its halo rows count where they exist in the
// frame and are masked where they fall outside it.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int BLK = 8;
constexpr int TBX = 16;                 // blocks per tile, x
constexpr int TBY = 2;                  // blocks per tile, y
constexpr int TILE_W = TBX * BLK;       // 128 pixels
constexpr int HALF = BLK / 2;           // rows of a block searched per stage
constexpr int CUR_BOX_W = TILE_W + 8;   // columns of a current box (>= TILE_W + 4)
constexpr int CUR_HALF_BYTES = HALF * CUR_BOX_W * 4;  // a multiple of 128
constexpr int CUR_BOX_BYTES = 2 * CUR_HALF_BYTES;

constexpr int MAX_SR = 15;              // me_kernel<1..MAX_SR>; wide_kernel takes the rest
constexpr int SM_SMEM = 233472;         // shared memory of one SM (228 KB)
constexpr int CTA_SMEM_RESERVED = 1024; // the runtime's share of each resident CTA

template <int SR>
struct Geometry {
  static constexpr int TOTAL = 2 * SR + 1;               // dx (and dy) candidates
  static constexpr int THREADS = 32 * TOTAL;             // one warp per dy
  static constexpr int PADX = (SR + 3) / 4 * 4;          // halo columns: SR rounded up to a multiple of 4
  // A reference box is the BLK + 2*SR rows that one block row of the tile
  // reads, REF_BOX_W >= TILE_W + 2*PADX + 4 columns, in two copies: the
  // first 2*SR + HALF rows (what rows 0..3 of its blocks read), then HALF
  // rows; each copy lands on a 128-byte boundary
  static constexpr int REF_BOX_H = BLK + 2 * SR;
  static constexpr int REF_EARLY = 2 * SR + HALF;
  static constexpr int REF_BOX_W = SR <= 4 ? TILE_W + 16 : (TILE_W + 2 * PADX + 4 + 31) / 32 * 32;
  static constexpr int REF_BOX_BYTES = REF_BOX_H * REF_BOX_W * 4;
  // one tile's buffer: reference boxes A (first block row) and B (second),
  // current boxes C and D
  static constexpr int OFF_B = REF_BOX_BYTES;
  static constexpr int OFF_C = 2 * REF_BOX_BYTES;
  static constexpr int OFF_D = OFF_C + CUR_BOX_BYTES;
  static constexpr int STAGE_BYTES = OFF_D + CUR_BOX_BYTES;
  static constexpr unsigned EARLY_TX = 2u * REF_EARLY * REF_BOX_W * 4 + 2u * CUR_HALF_BYTES;
  static constexpr unsigned LATE_TX = 2u * HALF * REF_BOX_W * 4 + 2u * CUR_HALF_BYTES;
  static_assert(REF_BOX_W >= TILE_W + 2 * PADX + 4 && REF_BOX_W <= 256, "reference box width");
  static_assert(REF_EARLY * REF_BOX_W * 4 % 128 == 0 && REF_BOX_BYTES % 128 == 0,
                "every copy must land on a 128-byte boundary");
  static constexpr int SMEM_BYTES = 2 * STAGE_BYTES + 4 * 8 + TOTAL * 32 * 8;
  // Resident CTAs per SM the kernel is compiled for (__launch_bounds__):
  // what the shared memory of two tile buffers allows, and no more than
  // leave each thread 56 registers; the tuned sr <= 7 kernels keep 4 and 2
  static constexpr int SMEM_FIT = SM_SMEM / (SMEM_BYTES + CTA_SMEM_RESERVED);
  static constexpr int REG_FIT = 65536 / (56 * THREADS);
  static constexpr int FIT = SMEM_FIT < REG_FIT ? SMEM_FIT : REG_FIT;
  static constexpr int MIN_CTAS = SR <= 4 ? 4 : SR <= 7 ? 2 : (FIT > 1 ? FIT : 1);
  static_assert(SMEM_FIT >= MIN_CTAS, "the shared memory must hold MIN_CTAS CTAs");
  // Candidates a lane searches per pass over a block's rows: all 2*SR+1 up
  // to SR = 7; from SR = 8 the dx range is cut into passes of at most 8
  // (2*SR+1 accumulators, the window and the current row would not fit in
  // the registers 2*SR+1 warps leave a thread: 64 at SR = 15)
  static constexpr int PASSES = TOTAL <= 15 ? 1 : (TOTAL + 7) / 8;
  static constexpr int DXC = (TOTAL + PASSES - 1) / PASSES;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy the box at column x, row y of `map` into shared memory at `dst` on
// the copy engine (TMA); cells outside the tensor are filled with zeros, and
// the copy completes all of the box's bytes on the mbarrier `bar`.
__device__ __forceinline__ void box_copy(unsigned dst, const CUtensorMap* map, int x, int y,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One thread stages half `late` of tile (tx, ty) into the buffer at shared
// address `buf`, counted on the mbarrier `bar`. Box A is reference rows
// y0 - SR .. y0 + 7 + SR from column x0 - PADX, box B the same 8 rows lower
// from column x0 - PADX - 4, box C current rows y0 .. y0 + 7 from column
// x0, box D current rows y0 + 8 .. y0 + 15 from column x0 - 4. The early
// half is what rows 0..3 of the tile's blocks read (the first 2*SR + 4 rows
// of A and B, 4 of C and D), the late half the rest. `ref_off` is the row
// of the reference tensor that holds frame-relative row 0 of `cur`.
template <int SR>
__device__ __forceinline__ void stage(unsigned buf, unsigned bar, bool late, int tx, int ty,
                                      const CUtensorMap* ref_early, const CUtensorMap* ref_late,
                                      const CUtensorMap* cur_map, int ref_off) {
  using G = Geometry<SR>;
  const int x0 = tx * TILE_W;
  const int y0 = ty * 2 * BLK;
  const int ref_y = ref_off + y0 - SR + (late ? G::REF_EARLY : 0);
  const int ref_at = late ? G::REF_EARLY * G::REF_BOX_W * 4 : 0;
  const int cur_y = y0 + (late ? HALF : 0);
  const int cur_at = late ? CUR_HALF_BYTES : 0;
  const CUtensorMap* ref_map = late ? ref_late : ref_early;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(late ? G::LATE_TX : G::EARLY_TX)
               : "memory");
  box_copy(buf + ref_at, ref_map, x0 - G::PADX, ref_y, bar);
  box_copy(buf + G::OFF_B + ref_at, ref_map, x0 - G::PADX - 4, ref_y + BLK, bar);
  box_copy(buf + G::OFF_C + cur_at, cur_map, x0, cur_y, bar);
  box_copy(buf + G::OFF_D + cur_at, cur_map, x0 - 4, cur_y + BLK, bar);
}

// Pass PASS of one lane's search: the candidates dx = D0 - SR .. D0 + ND - 1
// - SR of its dy, each SSD summed over the block's rows r = 0..7 (outer) and
// columns k = 0..7 (inner) from 0.f with __fsub_rn, __fmul_rn and __fadd_rn,
// then each valid candidate offered, in dx order, to the lane's strict-<
// minimum (best, best_idx), which earlier passes (smaller dx) have set.
// `cur` and `ref` are the lane's current row and reference window (row 0,
// this dy) in the tile buffer; rows 4..7 wait for the late half on `late`.
template <int SR, int PASS = 0>
__device__ __forceinline__ void search_passes(const unsigned char* cur, const unsigned char* ref,
                                              unsigned late, unsigned parity, bool valid_y,
                                              int bx, int W, int warp, float& best,
                                              int& best_idx) {
  using G = Geometry<SR>;
  if constexpr (PASS < G::PASSES) {
    constexpr int D0 = PASS * G::DXC;
    constexpr int ND = G::TOTAL - D0 < G::DXC ? G::TOTAL - D0 : G::DXC;
    constexpr int C0 = G::PADX - SR + D0;          // first window column this pass reads
    constexpr int Q0 = C0 / 4;                     // the float4 that holds it
    constexpr int NQ = (C0 + ND + 6) / 4 - Q0 + 1; // float4s through the last column read
    const float4* crow = reinterpret_cast<const float4*>(cur);
    const float4* rrow = reinterpret_cast<const float4*>(ref) + Q0;
    float acc[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[d] = 0.f;

#pragma unroll 1
    for (int r = 0; r < BLK; ++r, crow += CUR_BOX_W / 4, rrow += G::REF_BOX_W / 4) {
      if (r == HALF) wait_parity(late, parity);  // the late half has landed
      const float4 c0 = crow[0];
      const float4 c1 = crow[1];
      const float c[BLK] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      // w[i] = window column 4*Q0 + i of this row
      float w[4 * NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 v = rrow[q];
        w[4 * q + 0] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int d = 0; d < ND; ++d) {  // dx = D0 + d - SR
#pragma unroll
        for (int k = 0; k < BLK; ++k) {
          const float diff = __fsub_rn(c[k], w[C0 - 4 * Q0 + d + k]);
          acc[d] = __fadd_rn(acc[d], __fmul_rn(diff, diff));
        }
      }
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int dx = D0 + d - SR;
      const bool valid = valid_y && bx + dx >= 0 && bx + dx + BLK <= W;
      if (valid && acc[d] < best) {  // strict: first in scan order wins ties
        best = acc[d];
        best_idx = warp * G::TOTAL + D0 + d;
      }
    }
    search_passes<SR, PASS + 1>(cur, ref, late, parity, valid_y, bx, W, warp, best, best_idx);
  }
}

template <int SR>
__global__ void __launch_bounds__(Geometry<SR>::THREADS, Geometry<SR>::MIN_CTAS)
me_kernel(const __grid_constant__ CUtensorMap ref_early,
          const __grid_constant__ CUtensorMap ref_late, const __grid_constant__ CUtensorMap cur_map,
          int* __restrict__ out, int H, int W, int ref_off, int row0, int total_h, int tiles_x,
          int n_tiles) {
  using G = Geometry<SR>;
  // two tile buffers, their halves' mbarriers, then the dy rows' minima
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + 2 * G::STAGE_BYTES);
  float* s_best = reinterpret_cast<float*>(bars + 4);
  int* s_idx = reinterpret_cast<int*>(s_best + G::TOTAL * 32);
  const unsigned buf0 = smem_addr(smem);
  const unsigned bar0 = smem_addr(bars);  // half h of buffer b: bar0 + 8 * (2 * b + h)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dy = warp - SR;
  // lanes 0-3: blocks 0-3 of the tile's first block row, lanes 4-7: blocks
  // 0-3 of its second, lanes 8-11: blocks 4-7 of the first, ...
  const int lbx = (lane & 3) | ((lane >> 3) << 2);
  const int lby = (lane >> 2) & 1;
  const int wb = W / BLK;
  const int hb = H / BLK;
  // this lane's window and current row in its block row's boxes: box B and
  // D start 4 columns further left, so its blocks sit one float4 further on
  const int ref_at = (lby ? G::OFF_B : 0) + 16 * (2 * lbx + lby) + (dy + SR) * G::REF_BOX_W * 4;
  const int cur_at = (lby ? G::OFF_D : G::OFF_C) + 16 * (2 * lbx + lby);

  if (threadIdx.x == 0) {
    for (int j = 0; j < 4; ++j) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar0 + 8 * j), "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int t = blockIdx.x;  // this CTA's tiles: blockIdx.x, + gridDim.x, ...
  if (threadIdx.x == 0) {  // the first tile's early half alone: the search starts on it
    stage<SR>(buf0, bar0, false, t % tiles_x, t / tiles_x, &ref_early, &ref_late, &cur_map,
              ref_off);
  }
  for (int i = 0; t < n_tiles; ++i, t += gridDim.x) {
    const int b = i & 1;
    const unsigned parity = (i >> 1) & 1;
    const unsigned bar_b = bar0 + 16 * b;
    wait_parity(bar_b, parity);  // the early half of tile t has landed in buffer b
    __syncthreads();  // and every thread is done with the other buffer
    const int next = t + gridDim.x;
    if (threadIdx.x == 0) {
      if (i == 0) {
        stage<SR>(buf0, bar0 + 8, true, t % tiles_x, t / tiles_x, &ref_early, &ref_late,
                  &cur_map, ref_off);
      }
      if (next < n_tiles) {  // prefetch while this tile is searched
        const unsigned nbuf = buf0 + (b ^ 1) * G::STAGE_BYTES;
        for (int h = 0; h < 2; ++h) {
          stage<SR>(nbuf, bar0 + 16 * (b ^ 1) + 8 * h, h == 1, next % tiles_x, next / tiles_x,
                    &ref_early, &ref_late, &cur_map, ref_off);
        }
      }
    }

    const unsigned char* buf = smem + b * G::STAGE_BYTES;
    const int bxi = (t % tiles_x) * TBX + lbx;
    const int byi = (t / tiles_x) * TBY + lby;
    const int bx = bxi * BLK;
    const int gby = row0 + byi * BLK;  // global first row of this block
    const bool valid_y = gby + dy >= 0 && gby + dy + BLK <= total_h;
    float best = __int_as_float(0x7f800000);  // +inf
    int best_idx = 0;
    search_passes<SR>(buf + cur_at, buf + ref_at, bar_b + 8, parity, valid_y, bx, W, warp, best,
                      best_idx);
    s_best[warp * 32 + lane] = best;
    s_idx[warp * 32 + lane] = best_idx;
    __syncthreads();

    if (warp == 0) {  // combine the dy rows in scan order
      float bmin = __int_as_float(0x7f800000);
      int bi = 0;
#pragma unroll
      for (int v = 0; v < G::TOTAL; ++v) {
        const float s = s_best[v * 32 + lane];
        if (s < bmin) {
          bmin = s;
          bi = s_idx[v * 32 + lane];
        }
      }
      if (bxi < wb && byi < hb) out[static_cast<long long>(byi) * wb + bxi] = bi;
    }
  }
}

// The search of every range me_kernel is not built for (design note 6).
// Candidate validity, ref_off, row0 and total_h are as in me_kernel.
constexpr int WIDE_THREADS = 256;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int WIDE_MIN_CTAS = 3;                       // resident CTAs per SM
constexpr int DXP = 8;                                 // dx of a full pass
constexpr int CHUNK_DY = 8;                            // dy rows of a chunk
constexpr int CHUNK_DX = 9 * DXP;                      // dx columns of a chunk
constexpr int WIN_H = CHUNK_DY + BLK;                  // window rows of a block row (15 read)
constexpr int WIN_W = TILE_W + CHUNK_DX + 4;           // window columns; plane B starts 4 left
constexpr int WIN_BYTES = WIN_H * WIN_W * 4;
constexpr int WCUR_BYTES = BLK * CUR_BOX_W * 4;        // the current rows of one block row
constexpr int W_OFF_B = WIN_BYTES;
constexpr int W_OFF_C = 2 * WIN_BYTES;
constexpr int W_OFF_D = W_OFF_C + WCUR_BYTES;
constexpr int W_STAGE_BYTES = W_OFF_D + WCUR_BYTES;
// two chunk buffers, their mbarriers, then each thread's minimum
constexpr int WIDE_SMEM_BYTES = 2 * W_STAGE_BYTES + 2 * 8 + WIDE_THREADS * 8;
static_assert(WIN_W <= 256 && WIN_W * 4 % 16 == 0, "a window row is one TMA box row");
static_assert(WIN_BYTES % 128 == 0 && WCUR_BYTES % 128 == 0,
              "every copy must land on a 128-byte boundary");
static_assert(WIDE_MIN_CTAS * (WIDE_SMEM_BYTES + CTA_SMEM_RESERVED) <= SM_SMEM,
              "the shared memory must hold WIDE_MIN_CTAS CTAs");

__device__ __forceinline__ void keep_min(float& best, int& best_idx, float s, int idx) {
  if (s < best || (s == best && idx < best_idx)) {
    best = s;
    best_idx = idx;
  }
}

// What one tile of wide_kernel searches: its first pixel column x0 and row
// y0 in cur, the first candidate dy_lo, dx_min that any of its blocks in
// the frame can take, and ny x nx candidates from dy_lo and dx_lo, in
// chunks of CHUNK_DY rows by CHUNK_DX columns (ncx a row, n_chunks in all;
// dy outer). dx_lo is dx_min rounded down to a multiple of 4: a TMA box
// starts on a 16-byte boundary of the row, and the up to 3 columns before
// dx_min are masked.
struct WideTile {
  int x0, y0, dy_lo, dx_min, dx_lo, ny, nx, ncx, n_chunks;
};

__device__ __forceinline__ WideTile wide_tile(int t, int tiles_x, int H, int W, int row0,
                                              int total_h, int sr) {
  WideTile w;
  const int ty = t / tiles_x;
  w.x0 = (t - ty * tiles_x) * TILE_W;
  w.y0 = ty * TBY * BLK;
  const int last_bx = min(w.x0 + TILE_W, W) - BLK;      // its last block column in the frame
  const int last_by = min(w.y0 + TBY * BLK, H) - BLK;   // and row
  // a block at global row g takes -g <= dy <= total_h - 8 - g, at column x
  // -x <= dx <= W - 8 - x: over the tile's blocks, one interval each way,
  // which holds dy = dx = 0
  w.dy_lo = max(-sr, -(row0 + last_by));
  w.ny = min(sr, total_h - BLK - (row0 + w.y0)) - w.dy_lo + 1;
  w.dx_min = max(-sr, -last_bx);
  w.dx_lo = w.dx_min & ~3;
  w.nx = min(sr, W - BLK - w.x0) - w.dx_lo + 1;
  w.ncx = (w.nx + CHUNK_DX - 1) / CHUNK_DX;
  w.n_chunks = w.ncx * ((w.ny + CHUNK_DY - 1) / CHUNK_DY);
  return w;
}

// One thread stages chunk c of tile w into the buffer at shared address
// `buf`, counted on the mbarrier `bar`: plane A, the WIN_H x WIN_W
// reference rows and columns that the tile's first block row reads for
// the chunk's candidates; plane B, the same 8 rows lower from 4 columns
// further left; C and D, the current rows of the two block rows (D from 4
// columns further left). Cells outside a plane are filled with zeros.
__device__ __forceinline__ void wide_stage(unsigned buf, unsigned bar, const WideTile& w, int c,
                                           const CUtensorMap* ref_map, const CUtensorMap* cur_map,
                                           int ref_off) {
  const int cy = c / w.ncx;
  const int x = w.x0 + w.dx_lo + (c - cy * w.ncx) * CHUNK_DX;
  const int y = ref_off + w.y0 + w.dy_lo + cy * CHUNK_DY;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(W_STAGE_BYTES)
               : "memory");
  box_copy(buf, ref_map, x, y, bar);
  box_copy(buf + W_OFF_B, ref_map, x - 4, y + BLK, bar);
  box_copy(buf + W_OFF_C, cur_map, w.x0, w.y0, bar);
  box_copy(buf + W_OFF_D, cur_map, w.x0 - 4, w.y0 + BLK, bar);
}

// One work unit of a lane: the ND candidates dx .. dx + ND - 1 of one dy,
// `cur` its block's current row 0 and `win` its window's row 0 and column 0
// for them. Each SSD is summed over rows r = 0..7 (outer) and columns
// k = 0..7 (inner) from 0.f with __fsub_rn, __fmul_rn and __fadd_rn; the
// candidates d_lo <= d <= d_hi are valid, and their first strict minimum
// (packed index base + d) goes to the lane's (best, best_idx) by keep_min.
template <int ND>
__device__ __forceinline__ void wide_pass(const unsigned char* cur, const unsigned char* win,
                                          int d_lo, int d_hi, int base, float& best,
                                          int& best_idx) {
  constexpr int NQ = (ND + BLK - 1 + 3) / 4;  // float4s through window column ND + 6
  const float4* crow = reinterpret_cast<const float4*>(cur);
  const float4* wrow = reinterpret_cast<const float4*>(win);
  float acc[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d] = 0.f;

#pragma unroll 2
  for (int r = 0; r < BLK; ++r, crow += CUR_BOX_W / 4, wrow += WIN_W / 4) {
    const float4 c0 = crow[0];
    const float4 c1 = crow[1];
    const float c[BLK] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    float w[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 v = wrow[q];
      w[4 * q + 0] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
#pragma unroll
      for (int k = 0; k < BLK; ++k) {
        const float diff = __fsub_rn(c[k], w[d + k]);
        acc[d] = __fadd_rn(acc[d], __fmul_rn(diff, diff));
      }
    }
  }
  float ub = __int_as_float(0x7f800000);  // +inf
  int ui = -1;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (d >= d_lo && d <= d_hi && acc[d] < ub) {  // strict: the first in dx order
      ub = acc[d];
      ui = d;
    }
  }
  if (ui >= 0) keep_min(best, best_idx, ub, base + ui);
}

__global__ void __launch_bounds__(WIDE_THREADS, WIDE_MIN_CTAS)
wide_kernel(const __grid_constant__ CUtensorMap ref_map, const __grid_constant__ CUtensorMap cur_map,
            int* __restrict__ out, int H, int W, int ref_off, int row0, int total_h, int sr,
            int tiles_x, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + 2 * W_STAGE_BYTES);
  float* s_best = reinterpret_cast<float*>(bars + 2);
  int* s_idx = reinterpret_cast<int*>(s_best + WIDE_THREADS);
  const unsigned buf0 = smem_addr(smem);
  const unsigned bar0 = smem_addr(bars);  // buffer b's: bar0 + 8 * b

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lbx = (lane & 3) | ((lane >> 3) << 2);  // me_kernel's lane map
  const int lby = (lane >> 2) & 1;
  const int lane_at = 16 * (2 * lbx + lby);
  const int win_at = (lby ? W_OFF_B : 0) + lane_at;
  const int cur_at = (lby ? W_OFF_D : W_OFF_C) + lane_at;
  const int total = 2 * sr + 1;
  const int wb = W / BLK;
  const int hb = H / BLK;
  const float inf = __int_as_float(0x7f800000);

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar0 + 8 * j), "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this CTA's work: chunks 0.. of tiles blockIdx.x, + gridDim.x, ...
  int t = blockIdx.x;
  int c = 0;
  WideTile tile = wide_tile(t, tiles_x, H, W, row0, total_h, sr);
  if (threadIdx.x == 0) wide_stage(buf0, bar0, tile, 0, &ref_map, &cur_map, ref_off);
  float best = inf;
  int best_idx = INT_MAX;
  for (int i = 0; t < n_tiles; ++i) {
    const int b = i & 1;
    const bool last = c + 1 == tile.n_chunks;  // the tile's last chunk
    const int next_t = last ? t + gridDim.x : t;
    const int next_c = last ? 0 : c + 1;
    wait_parity(bar0 + 8 * b, (i >> 1) & 1);  // chunk c of tile t has landed in buffer b
    __syncthreads();                          // and every thread is done with the other buffer
    if (threadIdx.x == 0 && next_t < n_tiles) {  // prefetch while this chunk is searched
      const WideTile nt = last ? wide_tile(next_t, tiles_x, H, W, row0, total_h, sr) : tile;
      wide_stage(buf0 + (b ^ 1) * W_STAGE_BYTES, bar0 + 8 * (b ^ 1), nt, next_c, &ref_map,
                 &cur_map, ref_off);
    }

    const int bxi = tile.x0 / BLK + lbx;
    const int byi = tile.y0 / BLK + lby;
    const bool in_frame = bxi < wb && byi < hb;
    const int bx = bxi * BLK;
    const int gby = row0 + byi * BLK;  // global first row of this lane's block
    const int cy = c / tile.ncx;
    const int cx = c - cy * tile.ncx;
    const int dy0 = tile.dy_lo + cy * CHUNK_DY;
    const int dx0 = tile.dx_lo + cx * CHUNK_DX;
    const int rows = min(CHUNK_DY, tile.ny - cy * CHUNK_DY);
    const int cols = min(CHUNK_DX, tile.nx - cx * CHUNK_DX);
    const int passes = (cols + DXP - 1) / DXP;
    const unsigned char* buf = smem + b * W_STAGE_BYTES;
    for (int u = warp; u < rows * passes; u += WIDE_WARPS) {  // u = (dy row j, pass p)
      const int j = u / passes;
      const int p = u - j * passes;
      const int dy = dy0 + j;
      const int dx = dx0 + p * DXP;
      const int nd = min(DXP, cols - p * DXP);  // the last pass stops at the chunk's last dx
      const bool valid_y = in_frame && gby + dy >= 0 && gby + dy + BLK <= total_h;
      const int d_lo = max(0, max(tile.dx_min, -bx) - dx);
      const int d_hi = valid_y ? min(nd - 1, W - BLK - bx - dx) : -1;
      if (!__any_sync(0xffffffffu, d_lo <= d_hi)) continue;  // no lane has a valid candidate
      const unsigned char* cur = buf + cur_at;
      const unsigned char* win = buf + win_at + j * (WIN_W * 4) + p * (DXP * 4);
      const int base = (dy + sr) * total + dx + sr;
      switch (nd) {
        case 8: wide_pass<8>(cur, win, d_lo, d_hi, base, best, best_idx); break;
        case 7: wide_pass<7>(cur, win, d_lo, d_hi, base, best, best_idx); break;
        case 6: wide_pass<6>(cur, win, d_lo, d_hi, base, best, best_idx); break;
        case 5: wide_pass<5>(cur, win, d_lo, d_hi, base, best, best_idx); break;
        case 4: wide_pass<4>(cur, win, d_lo, d_hi, base, best, best_idx); break;
        case 3: wide_pass<3>(cur, win, d_lo, d_hi, base, best, best_idx); break;
        case 2: wide_pass<2>(cur, win, d_lo, d_hi, base, best, best_idx); break;
        default: wide_pass<1>(cur, win, d_lo, d_hi, base, best, best_idx); break;
      }
    }

    if (last) {  // combine the warps' minima of this tile
      s_best[threadIdx.x] = best;
      s_idx[threadIdx.x] = best_idx;
      __syncthreads();
      if (warp == 0) {
        float m = s_best[lane];
        int mi = s_idx[lane];
#pragma unroll
        for (int v = 1; v < WIDE_WARPS; ++v) keep_min(m, mi, s_best[v * 32 + lane], s_idx[v * 32 + lane]);
        if (in_frame) out[static_cast<long long>(byi) * wb + bxi] = m < inf ? mi : 0;
      }
      best = inf;
      best_idx = INT_MAX;
      if (next_t < n_tiles) tile = wide_tile(next_t, tiles_x, H, W, row0, total_h, sr);
    }
    t = next_t;
    c = next_c;
  }
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
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

// A map of the float32 [rows, W] plane at `base` read in boxes of
// box_h x box_w, zeros outside the plane.
bool plane_map(CUtensorMap* map, const float* base, int rows, int W, int box_w, int box_h) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per device and search range: the dynamic shared-memory opt-in (above
// 48 KB) and how many CTAs of the kernel one SM holds.
constexpr int MAX_DEVICES = 64;

template <int SR>
int launch(const float* ref, int ref_rows, int ref_off, const float* cur, int* out, int H, int W,
           int row0, int total_h, cudaStream_t stream) {
  using G = Geometry<SR>;
  static int ctas_on_device[MAX_DEVICES];  // 0 until configured
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (ctas_on_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(me_kernel<SR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM_BYTES);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, me_kernel<SR>, G::THREADS,
                                                          G::SMEM_BYTES);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    ctas_on_device[dev] = sms * per_sm;
  }
  CUtensorMap ref_early, ref_late, cur_map;
  if (!plane_map(&ref_early, ref, ref_rows, W, G::REF_BOX_W, G::REF_EARLY) ||
      !plane_map(&ref_late, ref, ref_rows, W, G::REF_BOX_W, HALF) ||
      !plane_map(&cur_map, cur, H, W, CUR_BOX_W, HALF)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const int tiles_x = (W / BLK + TBX - 1) / TBX;
  const int n_tiles = tiles_x * ((H / BLK + TBY - 1) / TBY);
  const int grid = n_tiles < ctas_on_device[dev] ? n_tiles : ctas_on_device[dev];
  me_kernel<SR><<<grid, G::THREADS, G::SMEM_BYTES, stream>>>(
      ref_early, ref_late, cur_map, out, H, W, ref_off, row0, total_h, tiles_x, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const float* ref, int ref_rows, int ref_off, const float* cur, int* out, int H,
                int W, int sr, int row0, int total_h, cudaStream_t stream) {
  static int ctas_on_device[MAX_DEVICES];  // 0 until configured
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (ctas_on_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WIDE_SMEM_BYTES);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wide_kernel, WIDE_THREADS,
                                                          WIDE_SMEM_BYTES);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    ctas_on_device[dev] = sms * per_sm;
  }
  const long long tiles_x = (W / BLK + TBX - 1) / TBX;
  const long long n_tiles = tiles_x * ((H / BLK + TBY - 1) / TBY);
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ref_map, cur_map;
  if (!plane_map(&ref_map, ref, ref_rows, W, WIN_W, WIN_H) ||
      !plane_map(&cur_map, cur, H, W, CUR_BOX_W, BLK)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const int grid = n_tiles < ctas_on_device[dev] ? static_cast<int>(n_tiles) : ctas_on_device[dev];
  wide_kernel<<<grid, WIDE_THREADS, WIDE_SMEM_BYTES, stream>>>(
      ref_map, cur_map, out, H, W, ref_off, row0, total_h, sr, static_cast<int>(tiles_x),
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// A search range the kernels take: sr >= 0 with (2*sr+1)^2 candidates in an int.
bool sr_ok(int sr) { return sr >= 0 && (2LL * sr + 1) * (2LL * sr + 1) <= INT_MAX; }

bool is_wide(int sr) { return sr < 1 || sr > MAX_SR; }

int search(const float* ref, int ref_rows, int ref_off, const float* cur, int* out, int H, int W,
           int sr, int row0, int total_h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sr_ok(sr)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_wide(sr)) return launch_wide(ref, ref_rows, ref_off, cur, out, H, W, sr, row0, total_h, s);
  static_assert(MAX_SR == 15, "instantiate launch<1..MAX_SR> below");
  switch (sr) {
    case 1: return launch<1>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 2: return launch<2>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 3: return launch<3>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 4: return launch<4>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 5: return launch<5>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 6: return launch<6>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 7: return launch<7>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 8: return launch<8>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 9: return launch<9>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 10: return launch<10>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 11: return launch<11>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 12: return launch<12>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 13: return launch<13>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 14: return launch<14>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    case 15: return launch<15>(ref, ref_rows, ref_off, cur, out, H, W, row0, total_h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool frame_ok(int H, int W) { return H > 0 && W > 0 && H % BLK == 0 && W % BLK == 0; }

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 on
// success), or, without launching, cudaErrorInvalidValue for arguments the
// kernels do not take and cudaErrorNotSupported where
// cuTensorMapEncodeTiled cannot describe the planes to the copy engine. Each launches me_kernel<sr> for
// sr 1..MAX_SR and wide_kernel for every other sr >= 0 whose (2*sr+1)^2
// fits in an int.

// 1 when a search at range sr launches wide_kernel, else 0 (me_kernel, or
// a range no kernel takes).
extern "C" int ivc_motion_search_wide(int sr) { return sr_ok(sr) && is_wide(sr) ? 1 : 0; }

// Whole frame: ref and cur are [H, W].
extern "C" int ivc_motion_search(const float* ref, const float* cur, int* out, int H, int W,
                                 int sr, void* stream) {
  if (!frame_ok(H, W)) return static_cast<int>(cudaErrorInvalidValue);
  return search(ref, H, 0, cur, out, H, W, sr, 0, H, stream);
}

// One row band of a frame of total_h rows: ref_ext is [ext_rows, W] with
// ext_rows = Ht + 2*sr (the band plus sr halo rows above and below), cur is
// [Ht, W], and row0 is the frame row of the band's first row, a multiple of
// 8 with row0 + Ht <= total_h.
extern "C" int ivc_motion_search_tile(const float* ref_ext, int ext_rows, const float* cur,
                                      int* out, int Ht, int W, int sr, int row0, int total_h,
                                      void* stream) {
  if (!frame_ok(Ht, W) || !sr_ok(sr) || ext_rows != Ht + 2LL * sr || row0 < 0 ||
      row0 % BLK != 0 || row0 > total_h - Ht) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return search(ref_ext, ext_rows, sr, cur, out, Ht, W, sr, row0, total_h, stream);
}
