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
// What bounds it on the H100.  At classify-nx shapes (8192 rows of 160
// bases, P = 131 windows) each valid window reads one 16-byte row at a
// random place in a 67 MB filter, larger than the 50 MB L2: <= 8192 x 121
// x 16 B ~ 15.9 MB, plus 0.33 MB of packed words and ~1.2 MB of outputs,
// ~5.2 us at 3.35 TB/s; ~9.9 us if each row costs a 32-byte sector (the
// sector floor).  Measured (tools/gate_ab.py, PERF.md): the same rows on a
// filter of 64 KB, every row on chip, take about 60% of the call's time,
// so the per-window work (key, validity, two hashes, four bit tests, the
// ranks) and its latency set as much as the rows do.  What a row costs at
// the DRAM has not been profiled; neither a 32-byte L2 fetch limit nor a
// persisting L2 window on the filter paid.  The design keeps the
// per-window work small and the loads in flight:
//
// * A block is 8 warps; a row gets G of them (1, 2, 4 or 8, from the row
//   count and the width: ops/gate.py:gate_group), so 2048 rows of 512
//   bases fill the card as 8192 rows of 160 do.  The row's windows are
//   walked in steps of G x U chunks of 32 windows (U = kChunks = 4 per
//   warp), the step's chunks dealt to the row's warps in turn (warp g
//   takes chunks (st * U + u) * G + g), so a short read's chunks spread
//   over them, and the walk stops at the read's own last window
//   (lengths[row] - 29), not the plane's.  One step of one warp covers a
//   150-bp read's 121 windows.
// * All U Bloom loads of a warp are issued before any is tested; a window
//   holds only its row and bit selector across the wait, and a placed
//   window's key is computed again for its output.  The passing count
//   carries across steps in a register and across the row's warps through
//   shared memory (each warp's count per chunk, one named barrier per step
//   and row, double-buffered by step parity).
// * The row's packed words are staged in shared memory with its bad bases
//   as a bitmask (positions past the length, code bytes >= 4).  The
//   exception list (not assumed sorted) is read into registers, one entry
//   per thread per 256 (with one warp per row as the kernel starts, else
//   after the first Bloom loads are issued), and merged into the masks of
//   the block's rows behind the first step's Bloom loads; an entry outside
//   the block's rows costs a compare.  A window whose bases hold an
//   exception is invalid, so its key (computed before the merge, from the
//   bits as packed) is never written in gate mode, and its load was only
//   wasted; the mask is read again only in blocks an exception reached.
//   Extract mode merges first, since it writes every window's key (an
//   exception base as code 0, as the plain version unpacks it).  A row
//   from the code plane (no exception list) is staged 16 bases a thread
//   and waits only for its own warps, not the block.
// * Base i sits at bits 2(i & 15) of word i >> 4, LSB first, so the 64 bits
//   starting at bit 2s hold window s's codes in order.  Two funnel shifts
//   take them; the reverse complement is ~W & (2^60 - 1) and the forward
//   key is W's 30 two-bit groups reversed, swap_pairs(brev64(W) >> 4).
// * Hashes are native 32-bit multiplies; ranks a __ballot_sync per chunk
//   and a popcount below the lane.  The whole read is scanned past the
//   budget, because the total count decides the engine's dense branch.
//
// Plain C interface (bound with ctypes): the caller allocates the outputs,
// the launch goes on the caller's stream, and the return value is
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// arguments the kernel does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;      // warps per block
constexpr int kKsize = 30;
constexpr int kChunks = 4;     // chunks of 32 windows per warp per step
constexpr int kExcRegs = 4;    // exception entries each thread reads ahead
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
  int group;               // warps per row (power of two <= kWarps)
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

// The block's view of itself: which row this warp works on, its place in
// the row's group, and where the block's rows sit in shared memory.
struct Rows {
  int lane, g, rg, row, per_block;
  uint32_t* words;  // this row's [nw] code words
  uint32_t* bad;    // this row's [nbw] bad-base mask
  uint32_t* all_words;
  uint32_t* all_bad;
};

__device__ __forceinline__ Rows block_rows(const Params& p, uint32_t* smem) {
  Rows r;
  r.lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  r.per_block = kWarps / p.group;
  r.rg = wid / p.group;
  r.g = wid - r.rg * p.group;
  r.row = blockIdx.x * r.per_block + r.rg;
  r.all_words = smem;
  r.all_bad = smem + r.per_block * p.nw;
  r.words = r.all_words + r.rg * p.nw;
  r.bad = r.all_bad + r.rg * p.nbw;
  return r;
}

// Stages one row (by the row's G warps): its code words and bad-base mask
// (positions past the length; from the code plane, also bytes >= 4).  The
// code plane goes 16 bases a thread, one 16-byte load where the row holds
// them aligned: a code word and half a mask word each.
template <bool kPacked>
__device__ void stage_row(const Params& p, const Rows& r) {
  if (r.row >= p.rows) return;
  const int t = r.g * 32 + r.lane;
  const int nt = p.group * 32;
  const int n = p.lengths[r.row];
  if (kPacked) {
    const uint32_t* src = p.packed + static_cast<size_t>(r.row) * p.n_words;
    for (int w = t; w < p.nw; w += nt) r.words[w] = w < p.n_words ? __ldg(src + w) : 0u;
    for (int m = t; m < p.nbw; m += nt) {
      const int i0 = m * 32;
      r.bad[m] = n <= i0 ? ~0u : (n >= i0 + 32 ? 0u : ~0u << (n - i0));
    }
    return;
  }
  const uint8_t* row = p.codes + static_cast<size_t>(r.row) * p.len;
  uint16_t* bad16 = reinterpret_cast<uint16_t*>(r.bad);  // little-endian halves
  for (int w = t; w < 2 * p.nbw; w += nt) {
    const int i0 = w * 16;
    uint32_t mask = n <= i0 ? 0xFFFFu : (n >= i0 + 16 ? 0u : (0xFFFFu << (n - i0)) & 0xFFFFu);
    const uint8_t* src = row + i0;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i0 + 16 <= p.len && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      v = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
      for (int j = 0; j < 16 && i0 + j < p.len; ++j)
        vw[j >> 2] |= static_cast<uint32_t>(src[j]) << (8 * (j & 3));
    }
    const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t c = (vs[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      if (c >= 4) mask |= 1u << j;
      word |= (c & 3u) << (2 * j);
    }
    r.words[w] = word;
    bad16[w] = static_cast<uint16_t>(mask);
  }
}

// Reads this thread's share of the exception list into registers.
__device__ __forceinline__ void read_exceptions(const Params& p, int32_t (&ev)[kExcRegs]) {
#pragma unroll
  for (int j = 0; j < kExcRegs; ++j) {
    const int e = threadIdx.x + j * blockDim.x;
    ev[j] = e < p.n_exc ? __ldg(p.exc + e) : -1;
  }
}

// Marks one exception entry's base bad in the block's rows (and clears its
// two code bits where `clear`; sets *hit where given); entries of other
// blocks' rows are skipped by a compare, before any division.
__device__ __forceinline__ void merge_exception(const Params& p, const Rows& r, int32_t v,
                                                bool clear, int* hit) {
  if (v < 0) return;
  const int64_t total = static_cast<int64_t>(p.rows) * p.len;
  // an entry past the plane lands on its last base, as the plain
  // version's clamp does
  const int64_t f = v < total ? static_cast<int64_t>(v) : total - 1;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * r.per_block * p.len;
  if (f < first || f >= first + static_cast<int64_t>(r.per_block) * p.len) return;
  const int at = static_cast<int>(f - first);
  const int wr = at / p.len;
  const int i = at - wr * p.len;
  atomicOr(&r.all_bad[wr * p.nbw + (i >> 5)], 1u << (i & 31));
  if (clear) atomicAnd(&r.all_words[wr * p.nw + (i >> 4)], ~(3u << (2 * (i & 15))));
  if (hit != nullptr) *hit = 1;
}

__device__ void merge_exceptions(const Params& p, const Rows& r,
                                 const int32_t (&ev)[kExcRegs], bool clear, int* hit) {
#pragma unroll
  for (int j = 0; j < kExcRegs; ++j) merge_exception(p, r, ev[j], clear, hit);
  for (int e = threadIdx.x + kExcRegs * blockDim.x; e < p.n_exc; e += blockDim.x)
    merge_exception(p, r, __ldg(p.exc + e), clear, hit);
}

// Canonical key words and strand (forward key < reverse complement) of
// window s of a staged row.
__device__ __forceinline__ void window_key(const uint32_t* words, int s, uint32_t& hi,
                                           uint32_t& lo, bool& fwd) {
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
}

// Window s holds no bad base.
__device__ __forceinline__ bool window_ok(const uint32_t* bad, int s) {
  const int m = s >> 5;
  return (__funnelshift_r(bad[m], bad[m + 1], s & 31) & 0x3FFFFFFFu) == 0;
}

// The four bits of selector m are set in a Bloom row.
__device__ __forceinline__ bool bloom_bits(const uint4 row, uint32_t m) {
  uint32_t all = 1u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t bit = (m >> (7 * j)) & 127u;
    const uint32_t word = (bit & 64u) ? ((bit & 32u) ? row.w : row.z)
                                      : ((bit & 32u) ? row.y : row.x);
    all &= word >> (bit & 31u);
  }
  return all & 1u;
}

// Barrier of one row's G warps (named barrier 1 + the row's place).
__device__ __forceinline__ void row_sync(const Params& p, const Rows& r) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + r.rg), "r"(p.group * 32) : "memory");
}

// Waits until the row is staged: the row's own warps where no exception
// list may reach another row (the code plane), else the whole block.
template <bool kPacked>
__device__ __forceinline__ void staged(const Params& p, const Rows& r) {
  if (kPacked) __syncthreads();
  else if (p.group == 1) __syncwarp();
  else row_sync(p, r);
}

// Window index of lane 0 of this warp's chunk u in step st: the step's
// chunks go to the row's warps in turn (chunk (st * U + u) * G + g), so a
// short read's chunks spread over all of them.
__device__ __forceinline__ int chunk_start(const Params& p, const Rows& r, int st, int u) {
  return ((st * kChunks + u) * p.group + r.g) * 32;
}

// One step's windows of this warp: for each window valid by the staged
// mask, its Bloom row, loaded before any is tested, and its bit selector.
struct Step {
  uint4 row[kChunks];
  uint32_t m[kChunks];
  bool cand[kChunks];
};

__device__ __forceinline__ void issue_step(const Params& p, const Rows& r, int st, int nwin,
                                           Step& q) {
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    q.cand[u] = false;
    const int s = chunk_start(p, r, st, u) + r.lane;
    if (s >= nwin || !window_ok(r.bad, s)) continue;
    uint32_t hi, lo;
    bool fwd;
    window_key(r.words, s, hi, lo, fwd);
    q.cand[u] = true;
    const uint32_t blk = fp_mix(hi ^ 0x243F6A88u, lo, p.s4, p.s5) & p.nblk_mask;
    q.m[u] = fp_mix(lo ^ 0xB7E15162u, hi, p.s5, p.s4);
    q.row[u] = __ldg(p.bloom + blk);
  }
}

// kOne: one warp per row, the group's code compiled out, and the exception
// entries read as the kernel starts, beside the staging loads (with more
// warps per row they are read after the first Bloom loads are issued).
template <bool kPacked, bool kOne>
__global__ void __launch_bounds__(kWarps * 32)
window_gate_kernel(Params p) {
  extern __shared__ uint32_t smem[];
  // each warp's passes per chunk of a step, by step parity
  __shared__ int counts[2][kChunks][kWarps];
  __shared__ int hit;  // an exception landed in the block's rows
  if (kOne) p.group = 1;
  const Rows r = block_rows(p, smem);
  if (threadIdx.x == 0) hit = 0;
  int32_t ev[kExcRegs];
  if (kPacked && kOne) read_exceptions(p, ev);
  stage_row<kPacked>(p, r);
  staged<kPacked>(p, r);
  const bool live = r.row < p.rows;
  const int n = live ? min(max(p.lengths[r.row], 0), p.len) : 0;
  const int nwin = max(n - kKsize + 1, 0);
  const int per_step = p.group * kChunks * 32;
  const int steps = (nwin + per_step - 1) / per_step;
  Step q;
  if (steps > 0) issue_step(p, r, 0, nwin, q);
  if (kPacked) {  // while the first Bloom rows are on their way
    if (!kOne) read_exceptions(p, ev);
    merge_exceptions(p, r, ev, false, &hit);
    __syncthreads();
  }
  const bool recheck = kPacked && hit;
  const size_t out0 = static_cast<size_t>(r.row) * p.k;
  const unsigned below = (1u << r.lane) - 1u;
  const int wid = threadIdx.x >> 5;
  int base = 0;
  for (int st = 0; st < steps; ++st) {
    if (st > 0) issue_step(p, r, st, nwin, q);
    unsigned ballot[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      // the mask now holds the exceptions too
      const int s = chunk_start(p, r, st, u) + r.lane;
      const bool pass = q.cand[u] && (!recheck || window_ok(r.bad, s)) &&
                        bloom_bits(q.row[u], q.m[u]);
      ballot[u] = __ballot_sync(0xFFFFFFFFu, pass);
    }
    int rank[kChunks];  // passes before each of this warp's chunks
    int run = base;
    if (kOne) {
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        rank[u] = run;
        run += __popc(ballot[u]);
      }
    } else {
      if (r.lane == 0) {
#pragma unroll
        for (int u = 0; u < kChunks; ++u)
          counts[st & 1][u][wid] = __popc(ballot[u]);
      }
      row_sync(p, r);
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        rank[u] = run;
        for (int j = 0; j < p.group; ++j) {
          const int c = counts[st & 1][u][r.rg * p.group + j];
          if (j == r.g) rank[u] = run;
          run += c;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      if (!((ballot[u] >> r.lane) & 1u)) continue;
      const int at = rank[u] + __popc(ballot[u] & below);
      if (at < p.k) {  // a placed window's key again, from the same words
        const int s = chunk_start(p, r, st, u) + r.lane;
        uint32_t hi, lo;
        bool fwd;
        window_key(r.words, s, hi, lo, fwd);
        p.wpos[out0 + at] = s;
        p.whi[out0 + at] = static_cast<int32_t>(hi);
        p.wlo[out0 + at] = static_cast<int32_t>(lo);
      }
    }
    base = run;
  }
  if (!live) return;
  for (int j = base + r.g * 32 + r.lane; j < p.k; j += p.group * 32) {
    p.wpos[out0 + j] = kSent;
    p.whi[out0 + j] = 0;
    p.wlo[out0 + j] = 0;
  }
  if (r.g == 0 && r.lane == 0) p.npass[r.row] = base;
}

template <bool kPacked>
__global__ void __launch_bounds__(kWarps * 32)
window_extract_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  const Rows r = block_rows(p, smem);
  int32_t ev[kExcRegs];
  if (kPacked) read_exceptions(p, ev);
  stage_row<kPacked>(p, r);
  if (kPacked) {  // the list may reach any row of the block
    __syncthreads();
    merge_exceptions(p, r, ev, true, nullptr);
  }
  staged<kPacked>(p, r);
  if (r.row >= p.rows) return;
  const int n_win = p.len - kKsize + 1;
  const size_t out0 = static_cast<size_t>(r.row) * n_win;
  for (int s = r.g * 32 + r.lane; s < n_win; s += p.group * 32) {
    uint32_t hi, lo;
    bool fwd;
    window_key(r.words, s, hi, lo, fwd);
    p.hi[out0 + s] = static_cast<int32_t>(hi);
    p.lo[out0 + s] = static_cast<int32_t>(lo);
    p.valid[out0 + s] = window_ok(r.bad, s) ? 1 : 0;
    if (p.fstrand != nullptr) p.fstrand[out0 + s] = fwd ? 1 : 0;
  }
}

// Fills the shape fields of p and launches; returns a cudaError_t value.
int launch(Params p, bool gate, void* stream) {
  if (p.rows < 0 || p.len < kKsize) return static_cast<int>(cudaErrorInvalidValue);
  if (p.packed != nullptr && p.n_words * 16 < p.len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.group < 1 || p.group > kWarps || (p.group & (p.group - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.rows == 0) return 0;
  p.nbw = (p.len + 31) / 32 + 1;
  p.nw = 2 * p.nbw;
  if (p.packed != nullptr && p.n_words + 2 > p.nw) p.nw = p.n_words + 2;
  const int per_block = kWarps / p.group;
  const size_t smem = sizeof(uint32_t) * per_block * (p.nw + p.nbw);
  // 48 KB of shared memory without opting in, less the gate's step counts
  if (smem + sizeof(int) * (2 * kChunks * kWarps + 1) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.rows + per_block - 1) / per_block);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool packed = p.packed != nullptr;
  const bool one = p.group == 1;
  if (gate && packed && one) window_gate_kernel<true, true><<<grid, block, smem, s>>>(p);
  else if (gate && packed) window_gate_kernel<true, false><<<grid, block, smem, s>>>(p);
  else if (gate && one) window_gate_kernel<false, true><<<grid, block, smem, s>>>(p);
  else if (gate) window_gate_kernel<false, false><<<grid, block, smem, s>>>(p);
  else if (packed) window_extract_kernel<true><<<grid, block, smem, s>>>(p);
  else window_extract_kernel<false><<<grid, block, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params inputs(const uint32_t* packed, int n_words, const int32_t* exc, int n_exc,
              const uint8_t* codes, const int32_t* lengths, int rows, int len,
              int group) {
  Params p = {};
  p.packed = packed;
  p.n_words = n_words;
  p.exc = exc;
  p.n_exc = n_exc;
  p.codes = codes;
  p.lengths = lengths;
  p.rows = rows;
  p.len = len;
  p.group = group;
  return p;
}

}  // namespace

// Gate mode.  Exactly one of `packed` (with `exc`, n_exc entries) and
// `codes` is given.  `bloom` is [nblk, 4] uint32, 16-byte aligned, nblk a
// power of two.  `group` warps per row (1, 2, 4 or 8).
extern "C" int kmer_window_gate(const uint32_t* packed, int n_words,
                                const int32_t* exc, int n_exc,
                                const uint8_t* codes, const int32_t* lengths,
                                int rows, int len, int group,
                                const uint32_t* bloom, uint32_t nblk, uint32_t s4,
                                uint32_t s5, int k, int32_t* wpos, int32_t* whi,
                                int32_t* wlo, int32_t* npass, void* stream) {
  if (k < 1 || nblk == 0 || (nblk & (nblk - 1)) != 0 ||
      (reinterpret_cast<uintptr_t>(bloom) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = inputs(packed, n_words, exc, n_exc, codes, lengths, rows, len, group);
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
// fstrand of the same shape unless it is null; `group` as in gate mode.
extern "C" int kmer_window_extract(const uint32_t* packed, int n_words,
                                   const int32_t* exc, int n_exc,
                                   const uint8_t* codes,
                                   const int32_t* lengths, int rows, int len,
                                   int group, int32_t* hi, int32_t* lo,
                                   uint8_t* valid, uint8_t* fstrand, void* stream) {
  Params p = inputs(packed, n_words, exc, n_exc, codes, lengths, rows, len, group);
  p.hi = hi;
  p.lo = lo;
  p.valid = valid;
  p.fstrand = fstrand;
  return launch(p, false, stream);
}
