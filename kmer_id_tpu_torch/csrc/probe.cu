// Probe + verify for the fingerprint classifier, for sm_90a: one pass over
// the windows of each read, any number of them (the Bloom path's <= 32
// gated windows, or every window of a read).
//
// Replaces the chain between the window gate (or extract) and the final
// call: the L1 and two L2 fingerprint probes
// (kmer_id_tpu/ops/lookup.py:fp_candidates, :224), the rank compaction of
// the candidates in (window, plane) order (the verify-tier call of the
// Pallas TPU kernel behind compact_ranks_pallas,
// kmer_id_tpu/ops/compact.py:101, or compact_sort on the dense path), the
// key verify against `rec`, the (node, tout) lookup in `tinfo` and the
// `seen` marks (kmer_id_tpu/engine/fpclassify.py:_cv_tier, :92), and the
// per-read deepest-hit and consistency reduction of _compact_verify
// (:246-255).  Only the window planes are read and only the per-read
// planes are written: no candidate plane reaches device memory.  Its
// callers: the Bloom path's gated windows; every window of a read on the
// dense path of a Bloom DB (fpclassify.py:dense_path, :226) and for a DB
// without a filter (_tiered, :173-191); and, in shard mode, a grid rank's
// gated windows or every window of a rank without a filter.
//
// Verify mode writes, at the first max_hits candidate ranks of each read:
// cand (slot id), ver, tin, depth (from the candidate's rec row), tout and
// t (from tinfo, for verified hits; 0 elsewhere), and 0 / false at
// unplaced ranks; per read: nh, deepest and dtgt (the first deepest
// verified hit, else rank 0's slot and 0), consistent and overflow.  Bit
// for bit what the plain chain writes, except tin/tout/depth where ver is
// false, which nothing downstream reads, and the fast tier's padding: the
// kernel ranks straight to max_hits.
//
// What bounds it on the H100: bytes, and their latency.  Each valid window
// reads three 16-byte rows at random places (one in the L1 table, ~134 MB
// at 33M probes, past the 50 MB L2; two in the small L2 table), each placed
// candidate one 12-byte rec row (~500 MB), each verified hit an 8-byte
// tinfo row (L2-resident).  The design:
//
// * One warp owns one read; lane j owns window w0 + j of a 32-window tile
//   (the gate's windows are one tile).  The hashes are native 32-bit
//   multiplies (the plain version builds them from 16-bit halves in int64).
// * A step takes U tiles (U = 1 or 2: the caller's choice), issuing all of
//   their window loads, then all of their 3U bucket row loads, before
//   ranking any; then the rec loads of a lane's (up to three) placed
//   candidates before any is compared.  What sets the time is how many
//   random row loads the card keeps in flight, not the length of a read's
//   chain of steps: at 8192 reads one tile per step (32-40 registers, the
//   most warps per SM) is fastest, at 2048 reads (~15 warps per SM) two
//   tiles per step are, and four were slower than one or two at every
//   engine shape (tools/probe_ab.py's sweep).
// * A ballot per plane gives each candidate its rank in the tile: the
//   popcounts of the lower lanes' ballots plus the lane's own earlier
//   planes; a running base carries the candidates of the tiles before.
// * A candidate whose rank is below mh is placed: its rec row is verified,
//   its (node, tout) read, its seen byte set (every store writes 1, so
//   duplicates need no atomic), and its fields staged in shared memory at
//   its rank.  After the last tile lane j < mh writes column j (coalesced).
// * The per-read fields are warp reductions over the staged ranks: a max
//   over (depth + 1, 63 - rank) keys picks the first deepest verified hit
//   (rank 0 when none is verified), whose lane broadcasts its slot, tin and
//   target; __all_sync gives the consistency test.
// * Verify mode's only count output is overflow = ncand > mh, so it stops
//   after the tile where the count first passes mh: every rank below mh
//   has been placed by then.  Shard mode counts every candidate.
// * The windows come as extract's planes (key words and a valid byte; the
//   window position is the column) or as the gate's (key words and wpos,
//   kSent past a read's last passing window).
//
// Shard mode is the same pass for one rank of the sharded engine's
// (data x db) grid: the shard's part of local_hits
// (kmer_id_tpu/parallel/fpsharded.py:304-346, whose two compactions are the
// Pallas kernel's calls at :289 and :324; without a filter, :301-330).  The
// rank holds the L1 buckets [b0, b0 + nbloc) of the global table (nb1
// buckets, whose mask the L1 hash takes) and the whole L2; a window's L1
// candidate counts only when its bucket lies in that range, its L2
// candidates only on the rank that owns L2 (db rank 0).  Slot ids are
// local: L1 (b1 - b0) * 8 + i, L2 nbloc * 8 + c * 8 + s.  It writes the
// rank's narrow hit plane at the first sh ranks (posk: the window position
// of a verified hit, kSent elsewhere; cand; tgt, tin and td = (tout &
// 0xFFFFFF) | (depth << 24) of verified hits, 0 elsewhere; ver), the
// per-read candidate count ncand, and the seen marks; the per-read summary
// comes after the grid's merge.  Verify mode is shard mode's arithmetic at
// b0 = 0, nbloc = nb1, own2 = 1, whose local slot ids are the global ones.
//
// Slots mode (kmer_probe_slots): the exact per-window replay of reads past
// the candidate budget and of the grid's long reads (fp_slots,
// kmer_id_tpu/engine/fpclassify.py:363; the probe half of step_targets,
// kmer_id_tpu/parallel/fpsharded.py:414-457): every window's verified slot
// and its rec tin, one thread per window, nothing ranked.
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

// The tables every mode probes: a grid rank's part of them, or the whole of
// them at b0 = 0, nbloc = nb1, own2 = 1 (local slot ids are then the global
// ones).
struct Tables {
  const uint4* fptab;   // [nbloc] L1 buckets [b0, b0 + nbloc) of nb1
  const uint4* fptab2;  // [nb2] L2 buckets
  const uint32_t* rec;  // [(nbloc + nb2) * 8, 3] (key hi, key lo, tin | depth << 24)
  uint32_t nb1_mask, nb2_mask, b0, nbloc;
  int own2;             // 1 on the rank that owns L2
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

// One window's three probes: its fingerprint, its local bucket numbers (the
// L2 buckets follow the nbloc L1 buckets in slot-id order) and the bucket
// rows it probes (zero where it probes none).
struct Probe {
  uint4 row[kPlanes];
  uint32_t bucket[kPlanes];
  uint32_t fp;
  bool l1, l2, same;  // probes its L1 row, probes L2, c1 == c2
};

// The hashes of a window's key words (L1 bucket and fingerprint: salts s1,
// s2, s3; L2 buckets: s4, s5) and its row loads, issued before any is
// tested.  A window whose L1 bucket lies outside [b0, b0 + nbloc) reads no
// L1 row.
__device__ __forceinline__ Probe probe_rows(const Tables& tb, uint32_t hi, uint32_t lo,
                                            bool live) {
  Probe pr;
  const uint32_t bl = (fp_mix(hi, lo, tb.s1, tb.s2) & tb.nb1_mask) - tb.b0;
  const uint32_t m = fp_mix(hi ^ 0x6A09E667u, lo, tb.s3, tb.s1);
  pr.fp = (m ^ (m >> 16)) & 0xFFFFu;
  if (pr.fp == 0) pr.fp = 1;
  const uint32_t c1 = fp_mix(hi, lo, tb.s4, tb.s5) & tb.nb2_mask;
  const uint32_t c2 = fp_mix(lo, hi, tb.s5, tb.s4) & tb.nb2_mask;
  pr.l1 = live && bl < tb.nbloc;  // b0 <= b1 < b0 + nbloc (unsigned wrap)
  pr.l2 = live && tb.own2 != 0;
  pr.same = c1 == c2;
  pr.row[0] = pr.row[1] = pr.row[2] = make_uint4(0, 0, 0, 0);
  if (pr.l1) pr.row[0] = __ldg(tb.fptab + bl);
  if (pr.l2) {
    pr.row[1] = __ldg(tb.fptab2 + c1);
    pr.row[2] = __ldg(tb.fptab2 + c2);
  }
  pr.bucket[0] = bl;
  pr.bucket[1] = tb.nbloc + c1;
  pr.bucket[2] = tb.nbloc + c2;
  return pr;
}

// A window's candidates: plane q is one where its bucket row holds the
// fingerprint (plane 2 only where c2 != c1), at local slot id slot[q].
__device__ __forceinline__ void candidates(const Probe& pr, bool (&cand)[kPlanes],
                                           uint32_t (&slot)[kPlanes]) {
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    const int s = bucket_match(pr.row[q], pr.fp);
    cand[q] = (q == 0 ? pr.l1 : pr.l2) && s >= 0;
    slot[q] = pr.bucket[q] * 8u + static_cast<uint32_t>(s < 0 ? 0 : s);
  }
  cand[2] = cand[2] && !pr.same;
}

// ------------------------------------------------------------ probe pass

struct ProbeParams {
  const uint32_t* hi;     // [rows, p] key words
  const uint32_t* lo;
  const uint8_t* valid;   // [rows, p] valid bytes, the position the column; or
  const int32_t* wpos;    // [rows, p] positions, kSent where not valid
  Tables tb;
  const int32_t* tinfo;   // [n_nodes, 2] (node, tout) by tin
  int8_t* seen;           // [>= local slots] or null
  // [rows, mh] outputs of both modes
  int32_t* cand;
  uint8_t* ver;
  int32_t* tin;
  // verify mode: [rows, mh] tout, depth, t; [rows] nh, deepest, dtgt,
  // consistent, overflow
  int32_t* tout;
  int32_t* depth;
  int32_t* t;
  int32_t* nh;
  int32_t* deepest;
  int32_t* dtgt;
  uint8_t* consistent;
  uint8_t* overflow;
  // shard mode: [rows, mh] posk, tgt, td; [rows] ncand
  int32_t* posk;
  int32_t* tgt;
  int32_t* td;
  int32_t* ncand;
  int rows, p, mh, n_nodes;
};

// Staged fields of a placed candidate, by rank: verify mode (cand, ver,
// tin, depth, tout, t), shard mode (cand, ver, tin, posk, td, tgt).
constexpr int kStaged = 6;

template <bool kShard, int U>
__global__ void __launch_bounds__(kWarps * 32) probe_kernel(const ProbeParams p) {
  __shared__ int32_t stage[kWarps][kStaged][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.rows) return;  // the whole warp: one read per warp
  int32_t(*st)[32] = stage[warp];
  const size_t in0 = static_cast<size_t>(row) * p.p;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;  // candidates of the tiles ranked so far
  bool done = false;
  for (int w0 = 0; w0 < p.p && !done; w0 += 32 * U) {
    // U tiles' window loads, then their bucket rows: every load of the
    // step issued before any is tested
    uint32_t hi[U], lo[U];
    int32_t pos[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * 32 + lane;
      live[u] = false;
      pos[u] = kSent;
      hi[u] = lo[u] = 0;
      if (w < p.p) {
        if (p.wpos != nullptr) {
          pos[u] = p.wpos[in0 + w];
          live[u] = pos[u] < kSent;
        } else {
          pos[u] = w;
          live[u] = p.valid[in0 + w] != 0;
        }
        hi[u] = p.hi[in0 + w];
        lo[u] = p.lo[in0 + w];
      }
    }
    Probe pr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) pr[u] = probe_rows(p.tb, hi[u], lo[u], live[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (w0 + u * 32 >= p.p) break;  // the whole warp
      bool valid[kPlanes];
      uint32_t slot[kPlanes];
      candidates(pr[u], valid, slot);
      // ranks in (window, plane) order, after the tiles before
      int r = base, total = 0;
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) {
        const unsigned bal = __ballot_sync(kFull, valid[q]);
        r += __popc(bal & below);
        total += __popc(bal);
      }
      if (base < p.mh) {  // the whole warp: a rank of this tile may place
        bool placed[kPlanes];
        int rank[kPlanes];
        uint32_t w0r[kPlanes], w1r[kPlanes], w2r[kPlanes];
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) {
          rank[q] = r;
          r += valid[q] ? 1 : 0;
          placed[q] = valid[q] && rank[q] < p.mh;
          w0r[q] = w1r[q] = w2r[q] = 0;
          if (placed[q]) {
            const uint32_t* rr = p.tb.rec + static_cast<size_t>(slot[q]) * 3;
            w0r[q] = __ldg(rr);
            w1r[q] = __ldg(rr + 1);
            w2r[q] = __ldg(rr + 2);
          }
        }
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) {
          if (!placed[q]) continue;
          const bool ver = w0r[q] == hi[u] && w1r[q] == lo[u];
          const int tin = static_cast<int>(w2r[q] & 0xFFFFFFu);
          int node = 0, tout = 0;
          if (ver) {
            if (tin < p.n_nodes) {
              node = __ldg(p.tinfo + 2 * static_cast<size_t>(tin));
              tout = __ldg(p.tinfo + 2 * static_cast<size_t>(tin) + 1);
            }
            if (p.seen != nullptr) p.seen[slot[q]] = 1;
          }
          const int o = rank[q];
          st[0][o] = static_cast<int32_t>(slot[q]);
          st[1][o] = ver ? 1 : 0;
          if (kShard) {
            st[2][o] = ver ? tin : 0;
            st[3][o] = ver ? pos[u] : kSent;
            st[4][o] = ver ? static_cast<int32_t>((static_cast<uint32_t>(tout) & 0xFFFFFFu) |
                                                  (w2r[q] & 0xFF000000u))
                           : 0;
          } else {
            st[2][o] = tin;
            st[3][o] = static_cast<int32_t>(w2r[q] >> 24);
            st[4][o] = tout;
          }
          st[5][o] = node;
        }
      }
      base += total;
      if (!kShard && base > p.mh) {  // overflow is known and every rank placed
        done = true;
        break;
      }
    }
  }
  __syncwarp();

  // lane j writes output column j, then the per-read fields
  const int placed_n = base < p.mh ? base : p.mh;
  const bool have = lane < placed_n;
  int32_t v[kStaged] = {};
#pragma unroll
  for (int i = 0; i < kStaged; ++i) v[i] = have ? st[i][lane] : 0;
  const size_t o = static_cast<size_t>(row) * p.mh + lane;
  if (kShard) {
    if (lane < p.mh) {
      p.posk[o] = have ? v[3] : kSent;
      p.cand[o] = v[0];
      p.tgt[o] = v[5];
      p.tin[o] = v[2];
      p.td[o] = v[4];
      p.ver[o] = static_cast<uint8_t>(v[1]);
    }
    if (lane == 0) p.ncand[row] = base;
    return;
  }
  if (lane < p.mh) {
    p.cand[o] = v[0];
    p.ver[o] = static_cast<uint8_t>(v[1]);
    p.tin[o] = v[2];
    p.depth[o] = v[3];
    p.tout[o] = v[4];
    p.t[o] = v[5];
  }
  const bool ver = v[1] != 0;
  // the first deepest verified hit: a max over (depth + 1, 63 - rank) keys,
  // rank 0 when none is verified
  const unsigned key =
      have ? (static_cast<unsigned>(ver ? v[3] + 1 : 0) << 6) | (63u - lane) : 0u;
  const unsigned top = __reduce_max_sync(kFull, key);
  int deepest = 0, dtin = 0, dtgt = 0;
  if (top != 0) {
    const int src = __ffs(__ballot_sync(kFull, key == top)) - 1;
    deepest = __shfl_sync(kFull, v[0], src);
    dtin = __shfl_sync(kFull, v[2], src);
    dtgt = __shfl_sync(kFull, v[5], src);
  }
  const bool consistent = __all_sync(kFull, !ver || (v[2] <= dtin && dtin <= v[4]));
  const int nh = __popc(__ballot_sync(kFull, ver));
  if (lane == 0) {
    p.nh[row] = nh;
    p.deepest[row] = deepest;
    p.dtgt[row] = dtgt;
    p.consistent[row] = consistent ? 1 : 0;
    p.overflow[row] = base > p.mh ? 1 : 0;
  }
}

// ------------------------------------------------------------ slots mode

struct SlotParams {
  const uint32_t* hi;     // [n] key words of every window
  const uint32_t* lo;
  const uint8_t* valid;   // [n]
  Tables tb;
  int32_t* slot;          // [n] outputs: verified local slot, -1 on a miss
  int32_t* tin;           // [n] its rec tin, 0 on a miss
  size_t n;
};

// One thread per window: its three probes, the rec rows of its candidates
// (all loads issued before any compare), the last plane that verifies.
__global__ void __launch_bounds__(256) probe_slots_kernel(const SlotParams p) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < p.n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const uint32_t hi = p.hi[i], lo = p.lo[i];
    const Probe pr = probe_rows(p.tb, hi, lo, p.valid[i] != 0);
    bool cand[kPlanes];
    uint32_t slot[kPlanes], w0[kPlanes], w1[kPlanes], w2[kPlanes];
    candidates(pr, cand, slot);
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) {
      w0[q] = w1[q] = w2[q] = 0;
      if (cand[q]) {
        const uint32_t* rr = p.tb.rec + static_cast<size_t>(slot[q]) * 3;
        w0[q] = __ldg(rr);
        w1[q] = __ldg(rr + 1);
        w2[q] = __ldg(rr + 2);
      }
    }
    int32_t out_slot = -1, out_tin = 0;
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) {
      if (cand[q] && w0[q] == hi && w1[q] == lo) {
        out_slot = static_cast<int32_t>(slot[q]);
        out_tin = static_cast<int32_t>(w2[q] & 0xFFFFFFu);
      }
    }
    p.slot[i] = out_slot;
    p.tin[i] = out_tin;
  }
}

// The tables' arguments as both C entries take them, checked: nb1 and nb2
// powers of two, b0 + nbloc <= nb1, (nbloc + nb2) * 8 < 2^31, the bucket
// tables 16-byte aligned.
bool tables(Tables& tb, const uint32_t* fptab, uint32_t nb1, uint32_t b0, uint32_t nbloc,
            const uint32_t* fptab2, uint32_t nb2, int own2, const uint32_t* rec, uint32_t s1,
            uint32_t s2, uint32_t s3, uint32_t s4, uint32_t s5) {
  const bool pow2 = nb1 != 0 && nb2 != 0 && (nb1 & (nb1 - 1)) == 0 &&
                    (nb2 & (nb2 - 1)) == 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(fptab) |
                         reinterpret_cast<uintptr_t>(fptab2)) & 15) == 0;
  if (!pow2 || !aligned || nbloc == 0 || static_cast<uint64_t>(b0) + nbloc > nb1 ||
      (static_cast<uint64_t>(nbloc) + nb2) * 8 > 0x7FFFFFFFull)
    return false;
  tb.fptab = reinterpret_cast<const uint4*>(fptab);
  tb.fptab2 = reinterpret_cast<const uint4*>(fptab2);
  tb.rec = rec;
  tb.nb1_mask = nb1 - 1;
  tb.nb2_mask = nb2 - 1;
  tb.b0 = b0;
  tb.nbloc = nbloc;
  tb.own2 = own2;
  tb.s1 = s1;
  tb.s2 = s2;
  tb.s3 = s3;
  tb.s4 = s4;
  tb.s5 = s5;
  return true;
}

}  // namespace

// Probe pass, both modes, for `rows` reads of `p` >= 1 windows: key words
// `hi`, `lo` [rows, p] uint32, and either `valid` [rows, p] bytes
// (extract's planes: the window position is the column) or `wpos` [rows, p]
// (the gate's planes: positions, kSent where not valid), the other null.
// Tables: `fptab` [nbloc, 4] (the L1 buckets [b0, b0 + nbloc) of nb1) and
// `fptab2` [nb2, 4] uint32 as tables() checks them; `rec`
// [(nbloc + nb2) * 8, 3]; own2 1 on the rank that owns L2 (b0 = 0,
// nbloc = nb1 and own2 = 1 for the whole tables); `tinfo` [n_nodes, 2];
// `seen` may be null.  1 <= mh <= 32 output ranks; unroll (tiles per step)
// 1 or 2.  shard = 0 writes the verify outputs (cand to overflow; posk,
// tgt, td and ncand null), shard = 1 the hit plane (cand, ver, tin, posk,
// tgt, td, ncand; the others null).
extern "C" int kmer_probe(const uint32_t* hi, const uint32_t* lo, const uint8_t* valid,
                          const int32_t* wpos, int rows, int p, const uint32_t* fptab,
                          uint32_t nb1, uint32_t b0, uint32_t nbloc, const uint32_t* fptab2,
                          uint32_t nb2, int own2, const uint32_t* rec, uint32_t s1,
                          uint32_t s2, uint32_t s3, uint32_t s4, uint32_t s5,
                          const int32_t* tinfo, int n_nodes, int8_t* seen, int mh,
                          int unroll, int shard, int32_t* cand, uint8_t* ver, int32_t* tin,
                          int32_t* tout, int32_t* depth, int32_t* t, int32_t* nh,
                          int32_t* deepest, int32_t* dtgt, uint8_t* consistent,
                          uint8_t* overflow, int32_t* posk, int32_t* tgt, int32_t* td,
                          int32_t* ncand, void* stream) {
  ProbeParams d = {};
  const bool outs = cand && ver && tin &&
                    (shard ? posk && tgt && td && ncand
                           : tout && depth && t && nh && deepest && dtgt && consistent &&
                                 overflow);
  if (!tables(d.tb, fptab, nb1, b0, nbloc, fptab2, nb2, own2, rec, s1, s2, s3, s4, s5) ||
      rows < 0 || p < 1 || mh < 1 || mh > 32 || (unroll != 1 && unroll != 2) ||
      (valid == nullptr) == (wpos == nullptr) || !outs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  d.hi = hi;
  d.lo = lo;
  d.valid = valid;
  d.wpos = wpos;
  d.tinfo = tinfo;
  d.seen = seen;
  d.cand = cand;
  d.ver = ver;
  d.tin = tin;
  d.tout = tout;
  d.depth = depth;
  d.t = t;
  d.nh = nh;
  d.deepest = deepest;
  d.dtgt = dtgt;
  d.consistent = consistent;
  d.overflow = overflow;
  d.posk = posk;
  d.tgt = tgt;
  d.td = td;
  d.ncand = ncand;
  d.rows = rows;
  d.p = p;
  d.mh = mh;
  d.n_nodes = n_nodes;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shard && unroll == 1) {
    probe_kernel<true, 1><<<grid, block, 0, s>>>(d);
  } else if (shard) {
    probe_kernel<true, 2><<<grid, block, 0, s>>>(d);
  } else if (unroll == 1) {
    probe_kernel<false, 1><<<grid, block, 0, s>>>(d);
  } else {
    probe_kernel<false, 2><<<grid, block, 0, s>>>(d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Slots mode: every window's verified slot (-1 on a miss) and its rec tin
// (0 on a miss), from `hi`, `lo` and `valid` [rows, p] as kmer_probe takes
// them; the tables as kmer_probe takes them.
extern "C" int kmer_probe_slots(const uint32_t* hi, const uint32_t* lo,
                                const uint8_t* valid, int rows, int p,
                                const uint32_t* fptab, uint32_t nb1, uint32_t b0,
                                uint32_t nbloc, const uint32_t* fptab2, uint32_t nb2,
                                int own2, const uint32_t* rec, uint32_t s1, uint32_t s2,
                                uint32_t s3, uint32_t s4, uint32_t s5, int32_t* slot,
                                int32_t* tin, void* stream) {
  SlotParams d = {};
  if (!tables(d.tb, fptab, nb1, b0, nbloc, fptab2, nb2, own2, rec, s1, s2, s3, s4, s5) ||
      rows < 0 || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  d.hi = hi;
  d.lo = lo;
  d.valid = valid;
  d.slot = slot;
  d.tin = tin;
  d.n = static_cast<size_t>(rows) * p;
  const size_t blocks = (d.n + 255) / 256;
  const dim3 grid(static_cast<unsigned>(blocks < 65536 ? blocks : 65536));
  probe_slots_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(d);
  return static_cast<int>(cudaGetLastError());
}
