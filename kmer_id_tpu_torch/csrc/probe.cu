// Probe + verify for the classifier's Bloom path, for sm_90a.
//
// Replaces, in one pass over each read's Bloom-passing windows, the chain
// between the window gate and the final call: the L1 and two L2
// fingerprint probes (kmer_id_tpu/ops/lookup.py:fp_candidates, :224), the
// rank compaction of the candidates in (window, plane) order (the
// verify-tier call of the Pallas TPU kernel behind compact_ranks_pallas,
// kmer_id_tpu/ops/compact.py:101), the key verify against `rec`, the
// (node, tout) lookup in `tinfo` and the `seen` marks
// (kmer_id_tpu/engine/fpclassify.py:_cv_tier, :92), and the per-read
// deepest-hit and consistency reduction of _compact_verify (:246-255).
// Only the gate's [B, K] windows are read and only the per-read planes are
// written: no candidate plane reaches device memory.
//
// It writes, at the first max_hits candidate ranks of each read: cand (slot
// id), ver, tin, depth (from the candidate's rec row), tout and t (from
// tinfo, for verified hits; 0 elsewhere), and 0 / false at unplaced ranks;
// per read: nh, deepest and dtgt (the first deepest verified hit, else rank
// 0's slot and 0), consistent and overflow.  Bit for bit what the plain
// chain writes, except tin/tout/depth where ver is false, which nothing
// downstream reads.
//
// What bounds it on the H100: bytes, and their latency.  Each valid window
// reads three 16-byte rows at random places (one in the L1 table, ~134 MB
// at 33M probes, past the 50 MB L2; two in the small L2 table), each placed
// candidate one 12-byte rec row (~500 MB), each verified hit an 8-byte
// tinfo row (L2-resident).  The design:
//
// * One warp owns one read; lane j < K owns window j.  The hashes are
//   native 32-bit multiplies (the plain version builds them from 16-bit
//   halves in int64).
// * The three row loads are issued before any is tested, then the rec
//   loads of the lane's (up to three) placed candidates before any is
//   compared, so a lane keeps its random loads in flight together.
// * A ballot per plane gives each candidate its rank: the popcounts of the
//   lower lanes' ballots plus the lane's own earlier planes.
// * Each verified hit stores 1 to its `seen` byte; every store writes 1, so
//   duplicates need no atomic and unverified lanes no sink element.
// * The per-read fields are warp reductions: a max over (depth + 1, 63 -
//   rank) keys picks the first deepest verified hit (rank 0 when none is
//   verified), whose lane broadcasts its slot, tin and target; __all_sync
//   gives the consistency test.
//
// Shard mode (kmer_probe_hits) is the same pass for one rank of the
// sharded engine's (data x db) grid: the shard's part of local_hits
// (kmer_id_tpu/parallel/fpsharded.py:304-346, whose two compactions are
// the Pallas kernel's calls at :289 and :324).  The rank holds the L1
// buckets [b0, b0 + nbloc) of the global table (nb1 buckets, whose mask the
// L1 hash takes) and the whole L2; a window's L1 candidate counts only when
// its bucket lies in that range, its L2 candidates only on the rank that
// owns L2 (db rank 0).  Slot ids are local: L1 (b1 - b0) * 8 + i, L2
// nbloc * 8 + c * 8 + s.  It writes the rank's narrow hit plane at the
// first sh ranks (posk: the window position of a verified hit, kSent
// elsewhere; cand; tgt, tin and td = (tout & 0xFFFFFF) | (depth << 24) of
// verified hits, 0 elsewhere; ver), the per-read candidate count ncand,
// and the seen marks; the per-read summary comes after the grid's merge.
// An out-of-range window reads no L1 row.
//
// Plain C interface (bound with ctypes): the caller allocates the outputs,
// the launch goes on the caller's stream, and the return value is
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// arguments the kernel does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // reads per block
constexpr int kPlanes = 3;
constexpr int32_t kSent = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Params {
  const int32_t* wpos;  // [rows, k] window positions, kSent past the last
  const uint32_t* whi;  // [rows, k] key words
  const uint32_t* wlo;
  const uint4* fptab;   // [nb1] L1 buckets: 8 16-bit fingerprints each
  const uint4* fptab2;  // [nb2] L2 buckets
  const uint32_t* rec;  // [(nb1 + nb2) * 8, 3] (key hi, key lo, tin | depth << 24)
  const int32_t* tinfo; // [n_nodes, 2] (node, tout) by tin
  int8_t* seen;         // [>= n_slots] or null
  int32_t* cand;        // [rows, mh] outputs
  uint8_t* ver;
  int32_t* tin;
  int32_t* tout;
  int32_t* depth;
  int32_t* t;
  int32_t* nh;          // [rows] outputs
  int32_t* deepest;
  int32_t* dtgt;
  uint8_t* consistent;
  uint8_t* overflow;
  int rows, k, mh, n_nodes;
  uint32_t nb1, nb1_mask, nb2_mask;
  uint32_t s1, s2, s3, s4, s5;
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

// Index of the first 16-bit fingerprint of a bucket equal to fp, in the
// order low halves of words 0-3, then high halves (half * 4 + word); -1 if
// none.
__device__ __forceinline__ int bucket_match(uint4 row, uint32_t fp) {
  const uint32_t w[4] = {row.x, row.y, row.z, row.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (((w[i & 3] >> (16 * (i >> 2))) & 0xFFFFu) == fp) return i;
  }
  return -1;
}

__global__ void __launch_bounds__(kWarps * 32) probe_verify_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // the whole warp: one read per warp
  const size_t in0 = static_cast<size_t>(row) * p.k;
  bool live = false;
  uint32_t hi = 0, lo = 0;
  if (lane < p.k) {
    live = p.wpos[in0 + lane] < kSent;
    hi = p.whi[in0 + lane];
    lo = p.wlo[in0 + lane];
  }
  // L1 bucket and fingerprint (salts s1, s2, s3), L2 buckets (s4, s5)
  const uint32_t b1 = fp_mix(hi, lo, p.s1, p.s2) & p.nb1_mask;
  const uint32_t m = fp_mix(hi ^ 0x6A09E667u, lo, p.s3, p.s1);
  uint32_t fp = (m ^ (m >> 16)) & 0xFFFFu;
  if (fp == 0) fp = 1;
  const uint32_t c1 = fp_mix(hi, lo, p.s4, p.s5) & p.nb2_mask;
  const uint32_t c2 = fp_mix(lo, hi, p.s5, p.s4) & p.nb2_mask;
  uint4 brow[kPlanes] = {};
  if (live) {
    brow[0] = __ldg(p.fptab + b1);
    brow[1] = __ldg(p.fptab2 + c1);
    brow[2] = __ldg(p.fptab2 + c2);
  }
  // bucket numbers: L2 buckets follow the nb1 L1 buckets in slot-id order
  const uint32_t bucket[kPlanes] = {b1, p.nb1 + c1, p.nb1 + c2};
  bool valid[kPlanes];
  uint32_t slot[kPlanes];
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    const int s = bucket_match(brow[q], fp);
    valid[q] = live && s >= 0;
    slot[q] = bucket[q] * 8u + static_cast<uint32_t>(s < 0 ? 0 : s);
  }
  valid[2] = valid[2] && c2 != c1;

  // ranks in (window, plane) order
  const unsigned below = (1u << lane) - 1u;
  int rank[kPlanes];
  int r = 0, ncand = 0;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    const unsigned bal = __ballot_sync(kFull, valid[q]);
    r += __popc(bal & below);
    ncand += __popc(bal);
  }
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    rank[q] = r;
    r += valid[q] ? 1 : 0;
  }

  // verify the placed candidates: every rec load issued before any compare
  bool placed[kPlanes];
  uint32_t w0[kPlanes], w1[kPlanes], w2[kPlanes];
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    placed[q] = valid[q] && rank[q] < p.mh;
    w0[q] = w1[q] = w2[q] = 0;
    if (placed[q]) {
      const uint32_t* rr = p.rec + static_cast<size_t>(slot[q]) * 3;
      w0[q] = __ldg(rr);
      w1[q] = __ldg(rr + 1);
      w2[q] = __ldg(rr + 2);
    }
  }
  const size_t out0 = static_cast<size_t>(row) * p.mh;
  unsigned best = 0;  // this lane's best (depth + 1, 63 - rank) key
  int best_cand = 0, best_tin = 0, best_t = 0;
  int my_tin[kPlanes], my_tout[kPlanes];
  bool my_ver[kPlanes];
  int n_ver = 0;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    my_ver[q] = placed[q] && w0[q] == hi && w1[q] == lo;
    my_tin[q] = static_cast<int>(w2[q] & 0xFFFFFFu);
    my_tout[q] = 0;
    if (!placed[q]) continue;
    const int dep = static_cast<int>(w2[q] >> 24);
    int node = 0;
    if (my_ver[q]) {
      if (my_tin[q] < p.n_nodes) {
        node = __ldg(p.tinfo + 2 * static_cast<size_t>(my_tin[q]));
        my_tout[q] = __ldg(p.tinfo + 2 * static_cast<size_t>(my_tin[q]) + 1);
      }
      if (p.seen != nullptr) p.seen[slot[q]] = 1;
      ++n_ver;
    }
    const size_t o = out0 + rank[q];
    p.cand[o] = static_cast<int32_t>(slot[q]);
    p.ver[o] = my_ver[q] ? 1 : 0;
    p.tin[o] = my_tin[q];
    p.depth[o] = dep;
    p.tout[o] = my_tout[q];
    p.t[o] = node;
    const unsigned key =
        (static_cast<unsigned>(my_ver[q] ? dep + 1 : 0) << 6) | (63u - rank[q]);
    if (key > best) {
      best = key;
      best_cand = static_cast<int>(slot[q]);
      best_tin = my_tin[q];
      best_t = node;
    }
  }
  const int placed_n = ncand < p.mh ? ncand : p.mh;
  for (int j = placed_n + lane; j < p.mh; j += 32) {
    const size_t o = out0 + j;
    p.cand[o] = 0;
    p.ver[o] = 0;
    p.tin[o] = 0;
    p.depth[o] = 0;
    p.tout[o] = 0;
    p.t[o] = 0;
  }

  // per-read fields
  const int nh = __reduce_add_sync(kFull, n_ver);
  const unsigned top = __reduce_max_sync(kFull, best);
  int deepest = 0, dtin = 0, dtgt = 0;
  if (top != 0) {
    const int src = __ffs(__ballot_sync(kFull, best == top)) - 1;
    deepest = __shfl_sync(kFull, best_cand, src);
    dtin = __shfl_sync(kFull, best_tin, src);
    dtgt = __shfl_sync(kFull, best_t, src);
  }
  bool ok = true;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    if (my_ver[q]) ok = ok && my_tin[q] <= dtin && dtin <= my_tout[q];
  }
  const bool consistent = __all_sync(kFull, ok);
  if (lane == 0) {
    p.nh[row] = nh;
    p.deepest[row] = deepest;
    p.dtgt[row] = dtgt;
    p.consistent[row] = consistent ? 1 : 0;
    p.overflow[row] = ncand > p.mh ? 1 : 0;
  }
}

struct ShardParams {
  const int32_t* wpos;  // [rows, k] window positions, kSent past the last
  const uint32_t* whi;  // [rows, k] key words
  const uint32_t* wlo;
  const uint4* fptab;   // [nbloc] the rank's L1 buckets
  const uint4* fptab2;  // [nb2] L2 buckets
  const uint32_t* rec;  // [(nbloc + nb2) * 8, 3] local slots
  const int32_t* tinfo; // [n_nodes, 2] (node, tout) by tin
  int8_t* seen;         // [>= local slots] or null
  int32_t* posk;        // [rows, sh] outputs
  int32_t* cand;
  int32_t* tgt;
  int32_t* tin;
  int32_t* td;
  uint8_t* ver;
  int32_t* ncand;       // [rows]
  int rows, k, sh, n_nodes, own2;
  uint32_t nb1_mask, nb2_mask, b0, nbloc;
  uint32_t s1, s2, s3, s4, s5;
};

__global__ void __launch_bounds__(kWarps * 32) probe_hits_kernel(const ShardParams p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // the whole warp: one read per warp
  const size_t in0 = static_cast<size_t>(row) * p.k;
  bool live = false;
  int32_t pos = kSent;
  uint32_t hi = 0, lo = 0;
  if (lane < p.k) {
    pos = p.wpos[in0 + lane];
    live = pos < kSent;
    hi = p.whi[in0 + lane];
    lo = p.wlo[in0 + lane];
  }
  const uint32_t bl = (fp_mix(hi, lo, p.s1, p.s2) & p.nb1_mask) - p.b0;
  const bool inr = bl < p.nbloc;  // b0 <= b1 < b0 + nbloc (unsigned wrap)
  const uint32_t m = fp_mix(hi ^ 0x6A09E667u, lo, p.s3, p.s1);
  uint32_t fp = (m ^ (m >> 16)) & 0xFFFFu;
  if (fp == 0) fp = 1;
  const uint32_t c1 = fp_mix(hi, lo, p.s4, p.s5) & p.nb2_mask;
  const uint32_t c2 = fp_mix(lo, hi, p.s5, p.s4) & p.nb2_mask;
  uint4 brow[kPlanes] = {};
  const bool l1 = live && inr, l2 = live && p.own2 != 0;
  if (l1) brow[0] = __ldg(p.fptab + bl);
  if (l2) {
    brow[1] = __ldg(p.fptab2 + c1);
    brow[2] = __ldg(p.fptab2 + c2);
  }
  const uint32_t bucket[kPlanes] = {bl, p.nbloc + c1, p.nbloc + c2};
  bool valid[kPlanes];
  uint32_t slot[kPlanes];
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    const int s = bucket_match(brow[q], fp);
    valid[q] = (q == 0 ? l1 : l2) && s >= 0;
    slot[q] = bucket[q] * 8u + static_cast<uint32_t>(s < 0 ? 0 : s);
  }
  valid[2] = valid[2] && c2 != c1;

  // ranks in (window, plane) order
  const unsigned below = (1u << lane) - 1u;
  int rank[kPlanes];
  int r = 0, ncand = 0;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    const unsigned bal = __ballot_sync(kFull, valid[q]);
    r += __popc(bal & below);
    ncand += __popc(bal);
  }
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    rank[q] = r;
    r += valid[q] ? 1 : 0;
  }

  // verify the placed candidates: every rec load made before any compare
  bool placed[kPlanes];
  uint32_t w0[kPlanes], w1[kPlanes], w2[kPlanes];
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    placed[q] = valid[q] && rank[q] < p.sh;
    w0[q] = w1[q] = w2[q] = 0;
    if (placed[q]) {
      const uint32_t* rr = p.rec + static_cast<size_t>(slot[q]) * 3;
      w0[q] = __ldg(rr);
      w1[q] = __ldg(rr + 1);
      w2[q] = __ldg(rr + 2);
    }
  }
  const size_t out0 = static_cast<size_t>(row) * p.sh;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    if (!placed[q]) continue;
    const bool ver = w0[q] == hi && w1[q] == lo;
    const size_t o = out0 + rank[q];
    int node = 0, tin = 0, td = 0;
    if (ver) {
      tin = static_cast<int>(w2[q] & 0xFFFFFFu);
      int tout = 0;
      if (tin < p.n_nodes) {
        node = __ldg(p.tinfo + 2 * static_cast<size_t>(tin));
        tout = __ldg(p.tinfo + 2 * static_cast<size_t>(tin) + 1);
      }
      td = static_cast<int>((static_cast<uint32_t>(tout) & 0xFFFFFFu) | (w2[q] & 0xFF000000u));
      if (p.seen != nullptr) p.seen[slot[q]] = 1;
    }
    p.posk[o] = ver ? pos : kSent;
    p.cand[o] = static_cast<int32_t>(slot[q]);
    p.tgt[o] = node;
    p.tin[o] = tin;
    p.td[o] = td;
    p.ver[o] = ver ? 1 : 0;
  }
  const int placed_n = ncand < p.sh ? ncand : p.sh;
  for (int j = placed_n + lane; j < p.sh; j += 32) {
    const size_t o = out0 + j;
    p.posk[o] = kSent;
    p.cand[o] = 0;
    p.tgt[o] = 0;
    p.tin[o] = 0;
    p.td[o] = 0;
    p.ver[o] = 0;
  }
  if (lane == 0) p.ncand[row] = ncand;
}

}  // namespace

// `fptab` [nb1, 4] and `fptab2` [nb2, 4] uint32, 16-byte aligned, row counts
// powers of two with (nb1 + nb2) * 8 < 2^31; `rec` [(nb1 + nb2) * 8, 3];
// `tinfo` [n_nodes, 2]; `seen` may be null.  1 <= k <= 32 windows per read
// and 1 <= mh <= 32 output ranks.
extern "C" int kmer_probe_verify(const int32_t* wpos, const uint32_t* whi,
                                 const uint32_t* wlo, int rows, int k,
                                 const uint32_t* fptab, uint32_t nb1,
                                 const uint32_t* fptab2, uint32_t nb2,
                                 const uint32_t* rec, const int32_t* tinfo,
                                 int n_nodes, uint32_t s1, uint32_t s2,
                                 uint32_t s3, uint32_t s4, uint32_t s5,
                                 int8_t* seen, int mh, int32_t* cand,
                                 uint8_t* ver, int32_t* tin, int32_t* tout,
                                 int32_t* depth, int32_t* t, int32_t* nh,
                                 int32_t* deepest, int32_t* dtgt,
                                 uint8_t* consistent, uint8_t* overflow,
                                 void* stream) {
  const bool pow2 = nb1 != 0 && nb2 != 0 && (nb1 & (nb1 - 1)) == 0 &&
                    (nb2 & (nb2 - 1)) == 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(fptab) |
                         reinterpret_cast<uintptr_t>(fptab2)) & 15) == 0;
  if (rows < 0 || k < 1 || k > 32 || mh < 1 || mh > 32 || !pow2 || !aligned ||
      (static_cast<uint64_t>(nb1) + nb2) * 8 > 0x7FFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  Params p = {};
  p.wpos = wpos;
  p.whi = whi;
  p.wlo = wlo;
  p.fptab = reinterpret_cast<const uint4*>(fptab);
  p.fptab2 = reinterpret_cast<const uint4*>(fptab2);
  p.rec = rec;
  p.tinfo = tinfo;
  p.seen = seen;
  p.cand = cand;
  p.ver = ver;
  p.tin = tin;
  p.tout = tout;
  p.depth = depth;
  p.t = t;
  p.nh = nh;
  p.deepest = deepest;
  p.dtgt = dtgt;
  p.consistent = consistent;
  p.overflow = overflow;
  p.rows = rows;
  p.k = k;
  p.mh = mh;
  p.n_nodes = n_nodes;
  p.nb1 = nb1;
  p.nb1_mask = nb1 - 1;
  p.nb2_mask = nb2 - 1;
  p.s1 = s1;
  p.s2 = s2;
  p.s3 = s3;
  p.s4 = s4;
  p.s5 = s5;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  probe_verify_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Shard mode.  `fptab` [nbloc, 4] (the rank's L1 buckets [b0, b0 + nbloc)
// of nb1) and `fptab2` [nb2, 4] uint32, 16-byte aligned; nb1 and nb2 powers
// of two, b0 + nbloc <= nb1 and (nbloc + nb2) * 8 < 2^31; `rec`
// [(nbloc + nb2) * 8, 3]; `tinfo` [n_nodes, 2]; `seen` may be null; own2 is
// 1 on the rank that owns L2.  1 <= k <= 32 windows per read and
// 1 <= sh <= 32 output ranks.
extern "C" int kmer_probe_hits(const int32_t* wpos, const uint32_t* whi,
                               const uint32_t* wlo, int rows, int k,
                               const uint32_t* fptab, uint32_t nb1, uint32_t b0,
                               uint32_t nbloc, const uint32_t* fptab2,
                               uint32_t nb2, int own2, const uint32_t* rec,
                               const int32_t* tinfo, int n_nodes, uint32_t s1,
                               uint32_t s2, uint32_t s3, uint32_t s4,
                               uint32_t s5, int8_t* seen, int sh,
                               int32_t* posk, int32_t* cand, int32_t* tgt,
                               int32_t* tin, int32_t* td, uint8_t* ver,
                               int32_t* ncand, void* stream) {
  const bool pow2 = nb1 != 0 && nb2 != 0 && (nb1 & (nb1 - 1)) == 0 &&
                    (nb2 & (nb2 - 1)) == 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(fptab) |
                         reinterpret_cast<uintptr_t>(fptab2)) & 15) == 0;
  if (rows < 0 || k < 1 || k > 32 || sh < 1 || sh > 32 || !pow2 || !aligned ||
      nbloc == 0 || static_cast<uint64_t>(b0) + nbloc > nb1 ||
      (static_cast<uint64_t>(nbloc) + nb2) * 8 > 0x7FFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  ShardParams p = {};
  p.wpos = wpos;
  p.whi = whi;
  p.wlo = wlo;
  p.fptab = reinterpret_cast<const uint4*>(fptab);
  p.fptab2 = reinterpret_cast<const uint4*>(fptab2);
  p.rec = rec;
  p.tinfo = tinfo;
  p.seen = seen;
  p.posk = posk;
  p.cand = cand;
  p.tgt = tgt;
  p.tin = tin;
  p.td = td;
  p.ver = ver;
  p.ncand = ncand;
  p.rows = rows;
  p.k = k;
  p.sh = sh;
  p.n_nodes = n_nodes;
  p.own2 = own2;
  p.nb1_mask = nb1 - 1;
  p.nb2_mask = nb2 - 1;
  p.b0 = b0;
  p.nbloc = nbloc;
  p.s1 = s1;
  p.s2 = s2;
  p.s3 = s3;
  p.s4 = s4;
  p.s5 = s5;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  probe_hits_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
