// Serial entropy-coding engine: canonical Huffman bitstream pack/unpack,
// the Huffman tree's depths and their length limit, and zero-run block
// coding.
//
// Role in the framework (SURVEY.md §7 step 3): the correctness oracle and
// host-side engine beside the tensor implementations in
// ivclab_tpu_torch/ops/bitpack.py and ivclab_tpu_torch/ops/zerorun.py. The
// bitstream format is identical to the tensor packer: MSB-first bits in
// big-endian u32 words. A copy of ivclab_tpu/runtime/native/entropy.cpp,
// plus the length limit (ivc_limit_lengths), which the JAX package runs
// as a Python loop: both packages build their own, and the two give the
// same outputs.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC, at first use, by
// ivclab_tpu_torch/runtime/cuda_build.py::build_host (see runtime/native.py).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Optimal prefix-code depths for ASCENDING-sorted positive leaf weights
// (two-queue method). Bit-for-bit the same merge order and tie-breaking
// as the numpy loop in entropy/codebook.py (_huffman_depths_np):
// leaves win ties against packages, package
// weights accumulate in identical IEEE-double order — so the resulting
// trees (and therefore canonical codes) are identical. Writes the depth
// of each sorted leaf to out_depth. Returns 0, or -1 on n < 1.
int64_t ivc_huffman_depths(const double* leaf_w, int64_t n,
                           int32_t* out_depth) {
  if (n < 1) return -1;
  if (n == 1) { out_depth[0] = 1; return 0; }
  std::vector<int64_t> parent(2 * n - 1, -1);
  std::vector<double> pkg_w(n - 1);
  int64_t li = 0, pi = 0, np_pkgs = 0;
  auto take = [&](double* w) -> int64_t {
    if (li < n && (pi >= np_pkgs || leaf_w[li] <= pkg_w[pi])) {
      *w = leaf_w[li];
      return li++;
    }
    *w = pkg_w[pi];
    return n + pi++;
  };
  for (int64_t k = 0; k < n - 1; ++k) {
    double wa, wb;
    const int64_t a = take(&wa);
    const int64_t b = take(&wb);
    const int64_t node = n + k;
    parent[a] = node;
    parent[b] = node;
    pkg_w[k] = wa + wb;
    ++np_pkgs;
  }
  std::vector<int32_t> depth(2 * n - 1, 0);
  for (int64_t node = 2 * n - 3; node >= 0; --node)
    depth[node] = depth[parent[node]] + 1;
  std::memcpy(out_depth, depth.data(), sizeof(int32_t) * n);
  return 0;
}

// Length limit of a prefix code (libjpeg's adjustment) on its length
// histogram `bits[0..top]`, in place: bit-for-bit the same loop, in the
// same order, as the numpy loop in entropy/codebook.py (_limit_bits_np).
// While a length i > max_len holds codes, a pair of them moves up: one
// becomes a code of length i-1, the other the sibling of the deepest leaf
// j <= i-2, which splits into two leaves of length j+1. Returns the number
// of pair moves, or -1 where no leaf of length >= 1 is left to split (more
// symbols than 2^max_len).
int64_t ivc_limit_lengths(int64_t* bits, int32_t top, int32_t max_len) {
  int64_t moves = 0;
  for (int32_t i = top; i > max_len; --i) {
    while (bits[i] > 0) {
      int32_t j = i - 2;
      while (j >= 1 && bits[j] == 0) --j;
      if (j < 1) return -1;
      bits[i] -= 2;
      bits[i - 1] += 1;
      bits[j + 1] += 2;
      bits[j] -= 1;
      ++moves;
    }
  }
  return moves;
}

// Pack n codewords (right-aligned `codes`, bit lengths `lens`, 0 = skip)
// into `out_words` (caller-zeroed, capacity >= ceil(total_bits/32)+1).
// Returns total bits written.
int64_t ivc_pack_bits(const uint32_t* codes, const int32_t* lens, int64_t n,
                      uint32_t* out_words) {
  uint64_t bitpos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t len = lens[i];
    if (len <= 0) continue;
    const uint32_t lj = (len >= 32) ? codes[i] : (codes[i] << (32 - len));
    const uint64_t w = bitpos >> 5;
    const uint32_t sh = static_cast<uint32_t>(bitpos & 31);
    out_words[w] |= (sh ? (lj >> sh) : lj);
    if (sh) out_words[w + 1] |= (lj << (32 - sh));
    bitpos += static_cast<uint64_t>(len);
  }
  return static_cast<int64_t>(bitpos);
}

// Canonical decode of `num_symbols` symbols starting at bit `start_bit`.
// Tables follow ivclab_tpu_torch/entropy/codebook.py: lj_next_minus1[32] (group
// end boundaries, left-justified, minus one), first_code[33], group
// offsets[33], sorted symbol indices[n]. Writes 0-based alphabet indices.
// Returns consumed bits, or -1 on table overrun.
int64_t ivc_decode_symbols(const uint32_t* words, int64_t num_words,
                           int64_t start_bit, int64_t num_symbols,
                           const uint32_t* lj_next_minus1,
                           const uint32_t* first_code,
                           const int32_t* group_offset,
                           const int32_t* sorted_syms, int32_t alphabet,
                           int32_t min_len, int32_t* out_sym_idx) {
  uint64_t bitpos = static_cast<uint64_t>(start_bit);
  const uint64_t total_bits = static_cast<uint64_t>(num_words) * 32;
  for (int64_t i = 0; i < num_symbols; ++i) {
    if (bitpos >= total_bits) return -1;
    const uint64_t w = bitpos >> 5;
    const uint32_t sh = static_cast<uint32_t>(bitpos & 31);
    uint32_t window = words[w] << sh;
    if (sh && w + 1 < static_cast<uint64_t>(num_words))
      window |= words[w + 1] >> (32 - sh);
    int32_t len = min_len;
    while (len < 32 && window > lj_next_minus1[len - 1]) ++len;
    const uint32_t code_val = (len >= 32) ? window : (window >> (32 - len));
    const int64_t pos = static_cast<int64_t>(group_offset[len]) +
                        static_cast<int64_t>(code_val - first_code[len]);
    if (pos < 0 || pos >= alphabet) return -1;
    out_sym_idx[i] = sorted_syms[pos];
    bitpos += static_cast<uint64_t>(len);
  }
  return static_cast<int64_t>(bitpos) - start_bit;
}

// Zero-run encode of `nblocks` scan-ordered coefficient blocks.
// Grammar identical to reference ivclab/entropy/zerorun.py:10-41.
// `out` capacity must be >= nblocks * (block_size/2*3 + 1).
// Returns total symbols written.
int64_t ivc_zerorun_encode(const int32_t* blocks, int64_t nblocks,
                           int32_t block_size, int32_t eob, int32_t* out) {
  int64_t k = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    const int32_t* blk = blocks + b * block_size;
    int32_t last_nz = block_size - 1;
    while (last_nz >= 0 && blk[last_nz] == 0) --last_nz;
    int32_t i = 0;
    while (i <= last_nz) {
      if (blk[i] == 0) {
        int32_t run = 1;
        while (i + run <= last_nz && blk[i + run] == 0) ++run;
        out[k++] = 0;
        out[k++] = run;
        i += run;
      } else {
        out[k++] = blk[i++];
      }
    }
    out[k++] = eob;
  }
  return k;
}

// Zero-run decode into `out_blocks` (caller-zeroed, nblocks*block_size).
// Returns number of symbols consumed, or -1 on malformed input.
int64_t ivc_zerorun_decode(const int32_t* symbols, int64_t nsym,
                           int64_t nblocks, int32_t block_size, int32_t eob,
                           int32_t* out_blocks) {
  int64_t i = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    int32_t* blk = out_blocks + b * block_size;
    int32_t filled = 0;
    for (;;) {
      if (i >= nsym) return -1;
      const int32_t s = symbols[i++];
      if (s == eob) break;
      if (s == 0) {
        if (i >= nsym) return -1;
        const int32_t run = symbols[i++];
        if (run <= 0 || filled + run > block_size) return -1;
        filled += run;  // buffer pre-zeroed
      } else {
        if (filled >= block_size) return -1;
        blk[filled++] = s;
      }
    }
  }
  return i;
}

}  // extern "C"
