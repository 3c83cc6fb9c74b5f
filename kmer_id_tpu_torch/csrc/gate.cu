// Window gate for the classifier's short-read batches, for sm_90a.
//
// Replaces, in one pass over each read row, the chain that turned a batch
// into Bloom-passing windows: the 2-bit unpack with its exception scatter
// (kmer_id_tpu/engine/fpclassify.py:unpack_codes), the canonical key words
// and window validity (kmer_id_tpu/ops/extract.py:extract_kmers), the
// block-Bloom test (kmer_id_tpu/ops/lookup.py:bloom_pass) and the rank
// compaction of the passing windows to a budget of K per read with the key
// words as payloads (the Pallas TPU kernel behind compact_ranks_pallas,
// kmer_id_tpu/ops/compact.py:_compact_kernel).  Bit for bit, it writes what
// that chain writes: wpos (window index, SENT past the last pass), whi and
// wlo (0 pad) as [B, K], and npass [B], the full count past the budget.
//
// A second entry point, extract mode, writes the full (hi, lo, valid)
// planes [B, P] instead (no Bloom test, no compaction) for the callers that
// probe every window: the dense path, the overflow replay, a DB without a
// Bloom filter and the legacy engine.  On request (a non-null pointer) it
// also writes fstrand [B, P]: the forward key strictly below the reverse
// complement, which the legacy engine's verify replay reads (a 30-mer can
// be its own reverse complement, so the canonical key cannot give it).
//
// What bounds it on the H100: bytes.  At classify-nx shapes (8192 rows of
// 160 bases, P = 131 windows) the valid windows each read one 16-byte
// Bloom row at a random place in a 67 MB filter: <= 8192 x 121 x 16 B
// ~ 15.9 MB, plus 0.33 MB of packed words and ~1.2 MB of outputs, ~17.5 MB
// or ~5.2 us at 3.35 TB/s.  The filter is larger than the 50 MB L2, and a
// random 16-byte row uses half of each 32-byte sector, so ~2x that bound is
// the fair target.  The design keeps everything else on chip:
//
// * One warp owns one row.  The row's packed words are staged in shared
//   memory, with its bad bases as a bitmask (positions past the length,
//   exception-list entries, code bytes >= 4).  The exception list is not
//   assumed sorted: each block scans all of it (EXC_CAP entries, resident
//   in L2) and keeps the entries of its own rows.
// * Base i sits at bits 2(i & 15) of word i >> 4, LSB first, so the 64 bits
//   starting at bit 2s hold window s's codes in order.  Two funnel shifts
//   take them; the reverse complement is ~W & (2^60 - 1) and the forward
//   key is W's 30 two-bit groups reversed, swap_pairs(brev64(W) >> 4).  No
//   30-term loop, and an exception base counts as code 0 as in the plain
//   version (its two bits are cleared here, whatever the feeder packed).
// * Hashes are native 32-bit multiplies.  Each valid window makes one
//   16-byte __ldg of its Bloom row; four chunks of 32 windows issue their
//   loads before any is tested, so a warp keeps four rows in flight.
// * Ranks as in compact.cu: a __ballot_sync per 32-window chunk and a
//   popcount below the lane.  The whole row is scanned past the budget,
//   because the total count decides the engine's dense branch.
//
// Plain C interface (bound with ctypes): the caller allocates the outputs,
// the launch goes on the caller's stream, and the return value is
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// arguments the kernel does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kKsize = 30;
constexpr int kUnroll = 4;  // chunks of 32 windows whose Bloom loads overlap
constexpr int32_t kSent = 0x7FFFFFFF;
constexpr uint64_t kM60 = (1ull << 60) - 1;
constexpr uint64_t kOdd = 0x5555555555555555ull;

struct Params {
  const uint32_t* packed;  // [rows, n_words] 2-bit words, or null
  const int32_t* exc;      // [n_exc] flat row * len + pos, -1 pad
  const uint8_t* codes;    // [rows, len] code plane, when packed is null
  const int32_t* lengths;  // [rows]
  const uint4* bloom;      // [nblk] 128-bit blocks (gate mode)
  int32_t* wpos;           // gate mode outputs: [rows, k], [rows, k], ...
  int32_t* whi;
  int32_t* wlo;
  int32_t* npass;          // [rows]
  int32_t* hi;             // extract mode outputs: [rows, P]
  int32_t* lo;
  uint8_t* valid;
  uint8_t* fstrand;        // or null: not written
  int rows, len, n_words, n_exc, k;
  int nw, nbw;             // shared words per row: codes, bad-base mask
  uint32_t nblk_mask, s4, s5;
};

__device__ __forceinline__ uint32_t fp_mix(uint32_t a, uint32_t b, uint32_t s1,
                                           uint32_t s2) {
  uint32_t x = a ^ (b * s1);
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  x *= s2;
  return x ^ (x >> 16);
}

// Stages the block's rows in shared memory (`words` [kWarps, nw] and `bad`
// [kWarps, nbw]): each warp its row's code words and bad-base mask, then
// the whole block the exception list.  Every thread of the block must call
// it (it holds two __syncthreads).
template <bool kPacked>
__device__ void stage_rows(const Params& p, uint32_t* words, uint32_t* bad) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + wid;
  if (row < p.rows) {
    const int n = p.lengths[row];
    uint32_t* my_words = words + wid * p.nw;
    uint32_t* my_bad = bad + wid * p.nbw;
    if (kPacked) {
      const uint32_t* src = p.packed + static_cast<size_t>(row) * p.n_words;
      for (int w = lane; w < p.nw; w += 32) my_words[w] = w < p.n_words ? src[w] : 0u;
    }
    for (int m = lane; m < p.nbw; m += 32) {
      const int i0 = m * 32;
      uint32_t mask = n <= i0 ? ~0u : (n >= i0 + 32 ? 0u : ~0u << (n - i0));
      if (!kPacked) {
        const uint8_t* src = p.codes + static_cast<size_t>(row) * p.len;
        uint32_t w0 = 0, w1 = 0;
        for (int j = 0; j < 32; ++j) {
          const int i = i0 + j;
          const uint32_t c = i < p.len ? src[i] : 0u;
          if (c >= 4) mask |= 1u << j;
          if (j < 16) w0 |= (c & 3u) << (2 * j);
          else w1 |= (c & 3u) << (2 * (j - 16));
        }
        my_words[2 * m] = w0;
        my_words[2 * m + 1] = w1;
      }
      my_bad[m] = mask;
    }
  }
  if (!kPacked) return;  // uniform: no exception list with the code plane
  __syncthreads();
  const int64_t total = static_cast<int64_t>(p.rows) * p.len;
  const int row0 = blockIdx.x * kWarps;
  for (int e = threadIdx.x; e < p.n_exc; e += blockDim.x) {
    const int32_t v = p.exc[e];
    if (v < 0) continue;
    // an entry past the plane lands on its last base, as the plain
    // version's clamp does
    const int64_t f = v < total ? static_cast<int64_t>(v) : total - 1;
    const int r = static_cast<int>(f / p.len);
    const int i = static_cast<int>(f - static_cast<int64_t>(r) * p.len);
    const int wr = r - row0;
    if (wr < 0 || wr >= kWarps) continue;
    atomicOr(&bad[wr * p.nbw + (i >> 5)], 1u << (i & 31));
    atomicAnd(&words[wr * p.nw + (i >> 4)], ~(3u << (2 * (i & 15))));
  }
  __syncthreads();
}

// Canonical key words, validity and strand (forward key < reverse
// complement) of window s of a staged row.
__device__ __forceinline__ void window_key(const uint32_t* words,
                                           const uint32_t* bad, int s,
                                           uint32_t& hi, uint32_t& lo,
                                           bool& ok, bool& fwd) {
  const int w = s >> 4;
  const int sh = 2 * (s & 15);
  const uint32_t a = __funnelshift_r(words[w], words[w + 1], sh);
  const uint32_t b = __funnelshift_r(words[w + 1], words[w + 2], sh);
  const uint64_t win = (static_cast<uint64_t>(b) << 32) | a;
  const uint64_t rc = ~win & kM60;
  uint64_t fw = __brevll(win) >> 4;
  fw = ((fw >> 1) & kOdd) | ((fw & kOdd) << 1);
  fwd = fw < rc;
  const uint64_t key = fwd ? fw : rc;
  hi = static_cast<uint32_t>(key >> 32);
  lo = static_cast<uint32_t>(key);
  const int m = s >> 5;
  ok = (__funnelshift_r(bad[m], bad[m + 1], s & 31) & 0x3FFFFFFFu) == 0;
}

__device__ __forceinline__ bool bloom_test(const Params& p, uint32_t hi,
                                           uint32_t lo) {
  const uint32_t blk = fp_mix(hi ^ 0x243F6A88u, lo, p.s4, p.s5) & p.nblk_mask;
  const uint32_t m = fp_mix(lo ^ 0xB7E15162u, hi, p.s5, p.s4);
  const uint4 row = __ldg(p.bloom + blk);
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t bit = (m >> (7 * j)) & 127u;
    const uint32_t word = (bit & 64u) ? ((bit & 32u) ? row.w : row.z)
                                      : ((bit & 32u) ? row.y : row.x);
    ok = ok && ((word >> (bit & 31u)) & 1u);
  }
  return ok;
}

template <bool kPacked>
__global__ void __launch_bounds__(kWarps * 32)
window_gate_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + wid;
  stage_rows<kPacked>(p, smem, smem + kWarps * p.nw);
  if (row >= p.rows) return;
  __syncwarp();
  const uint32_t* words = smem + wid * p.nw;
  const uint32_t* bad = smem + kWarps * p.nw + wid * p.nbw;
  const int n_win = p.len - kKsize + 1;
  const size_t out0 = static_cast<size_t>(row) * p.k;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
  for (int c0 = 0; c0 < n_win; c0 += 32 * kUnroll) {
    bool pass[kUnroll];
    uint32_t khi[kUnroll], klo[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = c0 + 32 * u + lane;
      bool ok = false, fwd;
      khi[u] = klo[u] = 0;
      if (s < n_win) window_key(words, bad, s, khi[u], klo[u], ok, fwd);
      pass[u] = ok && bloom_test(p, khi[u], klo[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, pass[u]);
      if (pass[u]) {
        const int r = base + __popc(ballot & below);
        if (r < p.k) {
          p.wpos[out0 + r] = c0 + 32 * u + lane;
          p.whi[out0 + r] = static_cast<int32_t>(khi[u]);
          p.wlo[out0 + r] = static_cast<int32_t>(klo[u]);
        }
      }
      base += __popc(ballot);
    }
  }
  for (int j = base + lane; j < p.k; j += 32) {
    p.wpos[out0 + j] = kSent;
    p.whi[out0 + j] = 0;
    p.wlo[out0 + j] = 0;
  }
  if (lane == 0) p.npass[row] = base;
}

template <bool kPacked>
__global__ void __launch_bounds__(kWarps * 32)
window_extract_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + wid;
  stage_rows<kPacked>(p, smem, smem + kWarps * p.nw);
  if (row >= p.rows) return;
  __syncwarp();
  const uint32_t* words = smem + wid * p.nw;
  const uint32_t* bad = smem + kWarps * p.nw + wid * p.nbw;
  const int n_win = p.len - kKsize + 1;
  const size_t out0 = static_cast<size_t>(row) * n_win;
  for (int s = lane; s < n_win; s += 32) {
    uint32_t hi, lo;
    bool ok, fwd;
    window_key(words, bad, s, hi, lo, ok, fwd);
    p.hi[out0 + s] = static_cast<int32_t>(hi);
    p.lo[out0 + s] = static_cast<int32_t>(lo);
    p.valid[out0 + s] = ok ? 1 : 0;
    if (p.fstrand != nullptr) p.fstrand[out0 + s] = fwd ? 1 : 0;
  }
}

// Fills the shape fields of p and launches; returns a cudaError_t value.
int launch(Params p, bool gate, void* stream) {
  if (p.rows < 0 || p.len < kKsize) return static_cast<int>(cudaErrorInvalidValue);
  if (p.packed != nullptr && p.n_words * 16 < p.len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.rows == 0) return 0;
  p.nbw = (p.len + 31) / 32 + 1;
  p.nw = 2 * p.nbw;
  if (p.packed != nullptr && p.n_words + 2 > p.nw) p.nw = p.n_words + 2;
  const size_t smem = sizeof(uint32_t) * kWarps * (p.nw + p.nbw);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool packed = p.packed != nullptr;
  if (gate && packed) window_gate_kernel<true><<<grid, block, smem, s>>>(p);
  else if (gate) window_gate_kernel<false><<<grid, block, smem, s>>>(p);
  else if (packed) window_extract_kernel<true><<<grid, block, smem, s>>>(p);
  else window_extract_kernel<false><<<grid, block, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Gate mode.  Exactly one of `packed` (with `exc`, n_exc entries) and
// `codes` is given.  `bloom` is [nblk, 4] uint32, 16-byte aligned, nblk a
// power of two.
extern "C" int kmer_window_gate(const uint32_t* packed, int n_words,
                                const int32_t* exc, int n_exc,
                                const uint8_t* codes, const int32_t* lengths,
                                int rows, int len, const uint32_t* bloom,
                                uint32_t nblk, uint32_t s4, uint32_t s5, int k,
                                int32_t* wpos, int32_t* whi, int32_t* wlo,
                                int32_t* npass, void* stream) {
  if (k < 1 || nblk == 0 || (nblk & (nblk - 1)) != 0 ||
      (reinterpret_cast<uintptr_t>(bloom) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.packed = packed;
  p.n_words = n_words;
  p.exc = exc;
  p.n_exc = n_exc;
  p.codes = codes;
  p.lengths = lengths;
  p.rows = rows;
  p.len = len;
  p.bloom = reinterpret_cast<const uint4*>(bloom);
  p.nblk_mask = nblk - 1;
  p.s4 = s4;
  p.s5 = s5;
  p.k = k;
  p.wpos = wpos;
  p.whi = whi;
  p.wlo = wlo;
  p.npass = npass;
  return launch(p, true, stream);
}

// Extract mode: the full (hi, lo, valid) planes [rows, len - 29], and
// fstrand of the same shape unless it is null.
extern "C" int kmer_window_extract(const uint32_t* packed, int n_words,
                                   const int32_t* exc, int n_exc,
                                   const uint8_t* codes,
                                   const int32_t* lengths, int rows, int len,
                                   int32_t* hi, int32_t* lo, uint8_t* valid,
                                   uint8_t* fstrand, void* stream) {
  Params p = {};
  p.packed = packed;
  p.n_words = n_words;
  p.exc = exc;
  p.n_exc = n_exc;
  p.codes = codes;
  p.lengths = lengths;
  p.rows = rows;
  p.len = len;
  p.hi = hi;
  p.lo = lo;
  p.valid = valid;
  p.fstrand = fstrand;
  return launch(p, false, stream);
}
