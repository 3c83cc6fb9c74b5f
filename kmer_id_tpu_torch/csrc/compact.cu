// Rank compaction for the classifier's candidate planes, for sm_90a.
//
// Replaces kmer_id_tpu/ops/compact.py:_compact_kernel (the Pallas TPU
// kernel behind compact_ranks_pallas).  For each row of a [B, C] plane it
// writes the first `mh` valid columns, in column order: their window
// position (SENT past the last one), candidate id (0 pad), up to two extra
// int32 payloads (0 pad), and the row's total valid count, which may exceed
// mh (the engine's overflow flag reads it).
//
// What bounds it on the H100: the bytes of the validity plane (B * C, read
// once), the payloads of the placed columns (at most mh per row) and the
// outputs.  At the engine's sizes (0.1-3 MB of valid bytes) that is a few
// microseconds of HBM time, so a wave of dependent load latency costs as
// much as the bytes: the design keeps every row to one round of loads and
// one scan.
//
// * Valid plane, 16 bytes per lane.  A row's bytes are covered by the
//   aligned 16-byte chunks of the plane's own address grid (the plane may
//   start at any byte); lane l of the row's group loads chunk l as one
//   uint4, tests each byte for != 0 and clears the bits of bytes outside
//   the row, giving a 16-bit mask.  A chunk that is not wholly inside the
//   plane (its first or last chunk when the plane is not 16-byte aligned at
//   that end) is read byte by byte, inside the row only: no load leaves the
//   plane's bytes.
// * Threads fit the width.  A row touches at most nch = (C + 14) / 16 + 1
//   chunks.  The host (ops/compact.py:kernel_group) gives each row a group
//   of `group` lanes: 8, 16 or 32 (the least power of two >= nch, several
//   rows to a warp) when nch <= 32, i.e. C <= 497; else one CTA of
//   32 * ceil(nch / 32) lanes, at most 4 warps (C <= 2017 in one pass).
//   The row count only sets the grid: at the engine's shapes this gives
//   2,048-8,192 warps (legacy nx [8192 x 131]: 16 lanes; dense nx
//   [8192 x 393]: a warp; dense lane [2048 x 1449]: 3-warp CTAs, 6,144
//   warps), each lane one load.
//   Wider rows walk the row in passes of `group` chunks, each one round of
//   loads and one scan, the running count carried in a register.  Blocks of
//   256 threads hold 256 / group rows; a CTA group is its own block.
// * One scan.  Each lane's popcount goes through an exclusive scan over its
//   group (__shfl_up_sync within the width of the group; across the warps
//   of a CTA group through shared memory), which gives each lane the rank
//   of its first valid column and the row's total.
// * Payloads only for placed columns, read in place.  A lane walks its own
//   mask in column order and, for each column of rank < mh, reads cand,
//   pos and the extras and writes them at that rank.  A payload plane is
//   (pointer, row stride, column divisor): value = ptr[row * stride +
//   col / div], so a broadcast row (stride 0) and a [B, C / 3] key-word
//   plane read at the interleaved column's window (div 3) are never copied
//   to [B, C].
// * Ranks from total to mh are padded (SENT / 0) with adjacent lanes on
//   adjacent ranks (where mh is wider than a narrow group, the warp pads
//   its rows one after the other, all 32 lanes on each); the group's first
//   lane writes the count.
//
// Plain C interface (bound with ctypes): the caller allocates the outputs,
// the launch goes on the caller's stream, and the return value is
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kMaxGroupWarps = 4;
constexpr int32_t kSent = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Where a payload plane holds (row, col): ptr[row * row_stride + col / div].
// col / div is one multiply-high by magic = 2^32 / div + 1, exact for
// col * div <= 2^32 (the launch checks cols * div <= 2^32): a runtime
// integer division is some twenty dependent instructions on every placed
// column, in the loop that the payload loads wait on.
struct Layout {
  long long row_stride;  // elements; 0 = one row broadcast
  int div;               // column divisor
  unsigned magic;

  __device__ __forceinline__ long long at(int row, int col) const {
    const int c = div == 1 ? col : static_cast<int>(__umulhi(static_cast<unsigned>(col), magic));
    return static_cast<long long>(row) * row_stride + c;
  }
};

Layout make_layout(long long row_stride, int div) {
  return {row_stride, div,
          div > 1 ? static_cast<unsigned>((1ull << 32) / static_cast<unsigned>(div) + 1) : 0u};
}

// Bit i set where byte i of the 16 is nonzero.
__device__ __forceinline__ unsigned nonzero_bytes(const uint4 w) {
  const unsigned v[4] = {__vcmpne4(w.x, 0u), __vcmpne4(w.y, 0u), __vcmpne4(w.z, 0u),
                         __vcmpne4(w.w, 0u)};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned b = ((v[k] >> 7) & 1u) | ((v[k] >> 14) & 2u) | ((v[k] >> 21) & 4u) |
                       ((v[k] >> 28) & 8u);
    m |= b << (4 * k);
  }
  return m;
}

template <int kExtras>
__global__ void __launch_bounds__(kBlockThreads)
compact_ranks_kernel(const int32_t* __restrict__ cand, const uint8_t* __restrict__ valid,
                     const int32_t* __restrict__ pos, const int32_t* __restrict__ e0,
                     const int32_t* __restrict__ e1, Layout lp, Layout l0, Layout l1,
                     int32_t* __restrict__ pos_out, int32_t* __restrict__ cand_out,
                     int32_t* __restrict__ n_out, int32_t* __restrict__ eo0,
                     int32_t* __restrict__ eo1, int rows, int cols, int mh, int group,
                     int nch) {
  __shared__ int warp_sum[kMaxGroupWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const bool cta_group = group > 32;
  const int gl = cta_group ? t : (lane & (group - 1));  // lane within the row's group
  const int row = cta_group ? blockIdx.x : blockIdx.x * (kBlockThreads / group) + t / group;
  const bool active = row < rows;  // inactive lanes still take part in the shuffles

  const uintptr_t plane0 = reinterpret_cast<uintptr_t>(valid);
  const uintptr_t plane1 = plane0 + static_cast<size_t>(rows) * cols;
  const uintptr_t rs = plane0 + static_cast<size_t>(active ? row : 0) * cols;
  const uintptr_t re = rs + cols;
  const uintptr_t first = rs & ~static_cast<uintptr_t>(15);
  const size_t in0 = static_cast<size_t>(row) * cols;
  const size_t out0 = static_cast<size_t>(row) * mh;

  int base = 0;  // valid columns before this pass
  for (int s0 = 0; s0 < nch; s0 += group) {
    // one chunk per lane: its 16 bytes as a mask of valid row columns
    const uintptr_t c0 = first + 16 * static_cast<uintptr_t>(s0 + gl);
    unsigned mask = 0;
    if (active && c0 < re) {
      if (c0 >= plane0 && c0 + 16 <= plane1) {
        mask = nonzero_bytes(__ldg(reinterpret_cast<const uint4*>(c0)));
      } else {  // the plane's ragged first or last chunk
        for (int i = 0; i < 16; ++i) {
          const uintptr_t a = c0 + i;
          if (a >= rs && a < re && *reinterpret_cast<const uint8_t*>(a) != 0) mask |= 1u << i;
        }
      }
      const int lo = rs > c0 ? static_cast<int>(rs - c0) : 0;
      const int hi = re < c0 + 16 ? static_cast<int>(re - c0) : 16;
      mask &= ((1u << hi) - 1u) & ~((1u << lo) - 1u);
    }
    const int cnt = __popc(mask);

    // inclusive scan over the group's lanes
    int x = cnt;
    const int width = cta_group ? 32 : group;
    for (int d = 1; d < width; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d, width);
      if ((lane & (width - 1)) >= d) x += y;
    }
    int before, total;
    if (cta_group) {
      const int w = t >> 5;
      if (lane == 31) warp_sum[w] = x;
      __syncthreads();
      before = 0;
      total = 0;
      for (int k = 0; k < group / 32; ++k) {
        const int s = warp_sum[k];
        if (k < w) before += s;
        total += s;
      }
      __syncthreads();  // warp_sum is written again by the next pass
    } else {
      before = 0;
      total = __shfl_sync(kFull, x, group - 1, group);
    }

    // place this lane's columns of rank < mh, in column order; a column's
    // payloads are all loaded before any is stored, so their latencies
    // overlap (__restrict__: no output aliases an input)
    int r = base + before + x - cnt;
    while (mask != 0 && r < mh) {
      const int i = __ffs(mask) - 1;
      mask &= mask - 1;
      const int col = static_cast<int>(c0 + i - rs);
      const int32_t vp = __ldg(pos + lp.at(row, col));
      const int32_t vc = __ldg(cand + in0 + col);
      const int32_t v0 = kExtras > 0 ? __ldg(e0 + l0.at(row, col)) : 0;
      const int32_t v1 = kExtras > 1 ? __ldg(e1 + l1.at(row, col)) : 0;
      const size_t o = out0 + r;
      pos_out[o] = vp;
      cand_out[o] = vc;
      if (kExtras > 0) eo0[o] = v0;
      if (kExtras > 1) eo1[o] = v1;
      ++r;
    }
    base += total;
  }
  if (active && gl == 0) n_out[row] = base;
  // pad ranks base..mh-1 with adjacent lanes on adjacent ranks: a group
  // pads its own row, unless the budget is wider than a narrow group; then
  // the warp pads its rows in turn with all 32 lanes, so that every store
  // still covers a run of the output rather than a group's few ranks
  const bool by_warp = group < 32 && mh > group;
  const int span = by_warp ? 32 : group;
  const int rows_here = by_warp ? 32 / group : 1;
  const int row0 = row - (by_warp ? lane / group : 0);
  for (int q = 0; q < rows_here; ++q) {
    const int rq = row0 + q;
    const int bq = by_warp ? __shfl_sync(kFull, base, q * group) : base;
    if (rq >= rows) break;  // uniform across the lanes that pad row rq
    const size_t o = static_cast<size_t>(rq) * mh;
    for (int j = bq + (by_warp ? lane : gl); j < mh; j += span) {
      pos_out[o + j] = kSent;
      cand_out[o + j] = 0;
      if (kExtras > 0) eo0[o + j] = 0;
      if (kExtras > 1) eo1[o + j] = 0;
    }
  }
}

bool payload_ok(const int32_t* p, long long row_stride, int div, int cols) {
  return p != nullptr && row_stride >= 0 && div >= 1 &&
         static_cast<unsigned long long>(cols) * static_cast<unsigned>(div) <= (1ull << 32) &&
         reinterpret_cast<uintptr_t>(p) % alignof(int32_t) == 0;
}

}  // namespace

extern "C" int kmer_compact_ranks(const int32_t* cand, const uint8_t* valid,
                                  const int32_t* pos, long long pos_stride, int pos_div,
                                  const int32_t* e0, long long e0_stride, int e0_div,
                                  const int32_t* e1, long long e1_stride, int e1_div,
                                  int n_extra, int32_t* pos_out, int32_t* cand_out,
                                  int32_t* n_out, int32_t* eo0, int32_t* eo1, int rows,
                                  int cols, int mh, int group, void* stream) {
  const bool group_ok = group == 8 || group == 16 || group == 32 ||
                        (group % 32 == 0 && group <= 32 * kMaxGroupWarps);
  if (rows < 0 || cols < 0 || mh < 1 || !group_ok || n_extra < 0 || n_extra > 2 ||
      !payload_ok(pos, pos_stride, pos_div, cols) ||
      (n_extra > 0 && !payload_ok(e0, e0_stride, e0_div, cols)) ||
      (n_extra > 1 && !payload_ok(e1, e1_stride, e1_div, cols)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int nch = (cols + 14) / 16 + 1;  // chunks a row can touch, at any alignment
  const bool cta_group = group > 32;
  const dim3 grid(cta_group ? rows : (rows + kBlockThreads / group - 1) / (kBlockThreads / group));
  const dim3 block(cta_group ? group : kBlockThreads);
  const Layout lp = make_layout(pos_stride, pos_div), l0 = make_layout(e0_stride, e0_div),
               l1 = make_layout(e1_stride, e1_div);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_extra) {
    case 0:
      compact_ranks_kernel<0><<<grid, block, 0, s>>>(cand, valid, pos, e0, e1, lp, l0, l1,
                                                     pos_out, cand_out, n_out, eo0, eo1, rows,
                                                     cols, mh, group, nch);
      break;
    case 1:
      compact_ranks_kernel<1><<<grid, block, 0, s>>>(cand, valid, pos, e0, e1, lp, l0, l1,
                                                     pos_out, cand_out, n_out, eo0, eo1, rows,
                                                     cols, mh, group, nch);
      break;
    default:
      compact_ranks_kernel<2><<<grid, block, 0, s>>>(cand, valid, pos, e0, e1, lp, l0, l1,
                                                     pos_out, cand_out, n_out, eo0, eo1, rows,
                                                     cols, mh, group, nch);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
