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
//  5. Wide search ranges (sr = 8..15, up to 31 warps and 992 threads a CTA,
//     which leaves a thread 64 registers). A lane cannot hold 2*sr+1
//     accumulators beside its window, so it scans its dy's candidates in
//     passes of at most 8 dx over the block's rows, carrying its strict-<
//     minimum from pass to pass in dx order; each SSD is summed exactly as
//     in one pass. The halo is sr rounded up to a multiple of 4 columns, and
//     a CTA's two buffers take up to 139 KB of shared memory at sr = 15
//     (one CTA per SM there, two at sr = 8).
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

namespace {

constexpr int BLK = 8;
constexpr int TBX = 16;                 // blocks per tile, x
constexpr int TBY = 2;                  // blocks per tile, y
constexpr int TILE_W = TBX * BLK;       // 128 pixels
constexpr int HALF = BLK / 2;           // rows of a block searched per stage
constexpr int CUR_BOX_W = TILE_W + 8;   // columns of a current box (>= TILE_W + 4)
constexpr int CUR_HALF_BYTES = HALF * CUR_BOX_W * 4;  // a multiple of 128
constexpr int CUR_BOX_BYTES = 2 * CUR_HALF_BYTES;

constexpr int MAX_SR = 15;              // the largest search range instantiated
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

int search(const float* ref, int ref_rows, int ref_off, const float* cur, int* out, int H, int W,
           int sr, int row0, int total_h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
// kernel does not take and cudaErrorNotSupported where the driver cannot
// describe the planes to the copy engine.

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
  if (!frame_ok(Ht, W) || sr < 1 || sr > MAX_SR || ext_rows != Ht + 2 * sr || row0 < 0 ||
      row0 % BLK != 0 || row0 > total_h - Ht) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return search(ref_ext, ext_rows, sr, cur, out, Ht, W, sr, row0, total_h, stream);
}
