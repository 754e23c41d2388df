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
// What bounds it on the H100: compute on the CUDA cores. Every output block
// costs (2*sr+1)^2 * 64 subtract/multiply/add triples (81*64 at sr=4), while
// the input is one read of each frame. The design keeps device-memory
// traffic near that single read: each CTA owns a 4x16-block tile
// (32x128 pixels), stages the reference tile plus its halo (sr rows above
// and below, 8 columns left and right) in shared memory once, and all 64
// threads of the CTA reuse it for every candidate. One thread owns one
// block: its 64 current pixels live in registers, and for each candidate
// row it pulls a 24-float reference window out of shared memory with six
// aligned 16-byte loads, which covers all 2*sr+1 horizontal shifts.
//
// Determinism: no atomics, fixed summation order (row by row, column by
// column), products and sums rounded separately (no FMA contraction), so the
// output is the same on every run. On integer-valued frames every SSD is an
// exact float32 integer (64 * 255^2 < 2^24), so the result equals the plain
// PyTorch version exactly, ties included; on other inputs a different
// summation order can only flip a near-tie.
//
// Row window: the kernel reads `ref` through a pointer aligned with row 0 of
// `cur`. Relative row r of `ref` is read only when -sr <= r < H + sr and
// 0 <= row0 + r < total_h, and candidate validity uses the global rows
// row0 + r. A whole frame (ivc_motion_search) is row0 = 0, total_h = H. A
// band (ivc_motion_search_tile) passes its global first row as row0, the
// frame height as total_h, and a pointer sr rows into its [H + 2*sr, W]
// halo-extended reference, so the halo rows are read where they exist in
// the frame and masked where they fall outside it.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 8;
constexpr int TILE_BX = 16;                 // blocks per CTA, x
constexpr int TILE_BY = 4;                  // blocks per CTA, y
constexpr int TILE_W = TILE_BX * BLK;       // 128 pixels
constexpr int TILE_H = TILE_BY * BLK;       // 32 pixels
constexpr int PAD_X = 8;                    // >= max sr; keeps 16-byte alignment
constexpr int SMEM_W = TILE_W + 2 * PAD_X;  // 144 floats per shared row
constexpr int WIN = BLK + 2 * PAD_X;        // 24-float reference window

template <int SR>
__global__ void __launch_bounds__(TILE_BX * TILE_BY)
me_kernel(const float* __restrict__ ref, const float* __restrict__ cur,
          int* __restrict__ out, int H, int W, int row0, int total_h) {
  constexpr int SMEM_H = TILE_H + 2 * SR;
  constexpr int TOTAL = 2 * SR + 1;
  __shared__ __align__(16) float s_ref[SMEM_H * SMEM_W];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE_BX + tx;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;

  // s_ref[r][c] = ref[y0 - SR + r][x0 - PAD_X + c]; cells outside the
  // readable window hold 0 and are only read by candidates masked below.
  for (int i = tid; i < SMEM_H * SMEM_W; i += TILE_BX * TILE_BY) {
    const int r = i / SMEM_W;
    const int c = i - r * SMEM_W;
    const int gy = y0 - SR + r;
    const int gx = x0 - PAD_X + c;
    float v = 0.f;
    if (gy < H + SR && row0 + gy >= 0 && row0 + gy < total_h && gx >= 0 && gx < W) {
      v = ref[static_cast<long long>(gy) * W + gx];
    }
    s_ref[i] = v;
  }
  __syncthreads();

  const int wb = W / BLK;
  const int hb = H / BLK;
  const int bxi = blockIdx.x * TILE_BX + tx;
  const int byi = blockIdx.y * TILE_BY + ty;
  if (bxi >= wb || byi >= hb) return;  // ragged edge; after the only barrier

  float c[BLK][BLK];
  const float* cp = cur + static_cast<long long>(byi * BLK) * W + bxi * BLK;
#pragma unroll
  for (int r = 0; r < BLK; ++r) {
#pragma unroll
    for (int k = 0; k < BLK; ++k) c[r][k] = cp[static_cast<long long>(r) * W + k];
  }

  const int gby = row0 + byi * BLK;  // global first row of this block
  const int bx = bxi * BLK;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_idx = 0;

#pragma unroll 1
  for (int dy = -SR; dy <= SR; ++dy) {
    float acc[TOTAL];
#pragma unroll
    for (int d = 0; d < TOTAL; ++d) acc[d] = 0.f;

#pragma unroll
    for (int r = 0; r < BLK; ++r) {
      // tile columns bx_local - 8 .. bx_local + 15 of reference row r + dy
      const float4* rowp = reinterpret_cast<const float4*>(
          &s_ref[(ty * BLK + r + dy + SR) * SMEM_W + tx * BLK]);
      float w[WIN];
#pragma unroll
      for (int q = 0; q < WIN / 4; ++q) {
        const float4 v = rowp[q];
        w[4 * q + 0] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int d = 0; d < TOTAL; ++d) {  // dx = d - SR
#pragma unroll
        for (int k = 0; k < BLK; ++k) {
          const float diff = __fsub_rn(c[r][k], w[PAD_X - SR + d + k]);
          acc[d] = __fadd_rn(acc[d], __fmul_rn(diff, diff));
        }
      }
    }

    const bool valid_y = gby + dy >= 0 && gby + dy + BLK <= total_h;
#pragma unroll
    for (int d = 0; d < TOTAL; ++d) {
      const int dx = d - SR;
      const bool valid = valid_y && bx + dx >= 0 && bx + dx + BLK <= W;
      if (valid && acc[d] < best) {  // strict: first in scan order wins ties
        best = acc[d];
        best_idx = (dy + SR) * TOTAL + d;
      }
    }
  }
  out[byi * wb + bxi] = best_idx;
}

template <int SR>
void launch(const float* ref, const float* cur, int* out, int H, int W, int row0,
            int total_h, cudaStream_t stream) {
  const dim3 block(TILE_BX, TILE_BY);
  const dim3 grid((W / BLK + TILE_BX - 1) / TILE_BX, (H / BLK + TILE_BY - 1) / TILE_BY);
  me_kernel<SR><<<grid, block, 0, stream>>>(ref, cur, out, H, W, row0, total_h);
}

int search(const float* ref, const float* cur, int* out, int H, int W, int sr, int row0,
           int total_h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sr) {
    case 1: launch<1>(ref, cur, out, H, W, row0, total_h, s); break;
    case 2: launch<2>(ref, cur, out, H, W, row0, total_h, s); break;
    case 3: launch<3>(ref, cur, out, H, W, row0, total_h, s); break;
    case 4: launch<4>(ref, cur, out, H, W, row0, total_h, s); break;
    case 5: launch<5>(ref, cur, out, H, W, row0, total_h, s); break;
    case 6: launch<6>(ref, cur, out, H, W, row0, total_h, s); break;
    case 7: launch<7>(ref, cur, out, H, W, row0, total_h, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool frame_ok(int H, int W) { return H > 0 && W > 0 && H % BLK == 0 && W % BLK == 0; }

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue, without launching, for arguments the
// kernel does not take.

// Whole frame: ref and cur are [H, W].
extern "C" int ivc_motion_search(const float* ref, const float* cur, int* out, int H, int W,
                                 int sr, void* stream) {
  if (!frame_ok(H, W)) return static_cast<int>(cudaErrorInvalidValue);
  return search(ref, cur, out, H, W, sr, 0, H, stream);
}

// One row band of a frame of total_h rows: ref_ext is [ext_rows, W] with
// ext_rows = Ht + 2*sr (the band plus sr halo rows above and below), cur is
// [Ht, W], and row0 is the frame row of the band's first row, a multiple of
// 8 with row0 + Ht <= total_h.
extern "C" int ivc_motion_search_tile(const float* ref_ext, int ext_rows, const float* cur,
                                      int* out, int Ht, int W, int sr, int row0, int total_h,
                                      void* stream) {
  if (!frame_ok(Ht, W) || sr < 1 || sr > 7 || ext_rows != Ht + 2 * sr || row0 < 0 ||
      row0 % BLK != 0 || row0 > total_h - Ht) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return search(ref_ext + static_cast<long long>(sr) * W, cur, out, Ht, W, sr, row0, total_h,
                stream);
}
