// Native builder kernels: genome decode, canonical k-mer extraction,
// radix sort/unique, entropy filter, emission walk — the builder's hot
// loops behind a C ABI for ctypes (no pybind11 in this image).
//
// This is the DB-builder's native runtime, the analog of the reference
// builder's C++ scan loops (kmer_build_vf6.cpp:305-404,460-640): the NumPy
// formulations in db/build.py + db/entropy.py + core/codec.py define the
// behavioral contract and remain the fallback; tests assert this
// implementation produces identical arrays (tests/test_builder_native.py).
//
// Semantics mirrored exactly:
//  * genome normalization (io/fastx.load_genome_gz/_concat_genome): '>'
//    lines contribute one 'N'; lowercase normalized; non-ACGT(U) -> 'N';
//    contig variant strips all whitespace and drops lines of length <= 1;
//  * rolling canonical 30-mers (core/codec.canonical_kmers): keyF/keyR,
//    reset on invalid base, canonical = min, fwd = keyF < keyR, position =
//    0-based index of the k-mer's LAST base;
//  * entropy filter (db/entropy.check_entropy_keys): the per-(count,group)
//    f-terms arrive as a caller-built table COMPUTED WITH np.log10, and the
//    summation order replicates NumPy's pairwise axis-1 sum + sequential
//    class accumulation, so acceptance is bit-identical to the NumPy path;
//  * emission chain walk (db/build.build_probes pass 3): same hop rules
//    (cap -> run skip, unknown-entropy candidates emit optimistically).
//
// Build: g++ -O3 -shared -fPIC kmer_native.cpp -o libkmer.so -lz

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int KSIZE = 30;

// -------------------------------------------------------------- genome load

struct Genome {
  std::vector<uint8_t> codes;  // 0..3, 4 = invalid ('N')
};

uint8_t g_code[2][256];
bool g_code_init = false;

void init_code_luts() {
  if (g_code_init) return;
  for (int v = 0; v < 2; v++)
    for (int c = 0; c < 256; c++) g_code[v][c] = 4;
  const char* b = "ACGT";
  for (int i = 0; i < 4; i++) {
    g_code[0][(unsigned char)b[i]] = i;
    g_code[0][(unsigned char)(b[i] + 32)] = i;
    g_code[1][(unsigned char)b[i]] = i;
    g_code[1][(unsigned char)(b[i] + 32)] = i;
  }
  g_code[1]['U'] = 3;
  g_code[1]['u'] = 3;
  g_code_init = true;
}

// Read a whole file (gz-transparent) into memory.
bool slurp(const char* path, bool gz, std::string* out) {
  out->clear();
  if (gz) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    char buf[1 << 16];
    int n;
    while ((n = gzread(f, buf, sizeof(buf))) > 0) out->append(buf, n);
    gzclose(f);
    return n == 0;
  }
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) out->append(buf, n);
  fclose(f);
  return true;
}

// kind 0: gz/plain FASTA, load_genome_gz semantics (empty lines skipped,
//         '>' line -> one N, body normalized per-char).
// kind 1: plain contigs, load_genome_contigs semantics (whitespace stripped,
//         post-strip lines of length <= 1 dropped entirely).
Genome* load_genome(const char* path, int kind, int u_is_t) {
  init_code_luts();
  std::string raw;
  if (!slurp(path, kind == 0, &raw)) return nullptr;
  const uint8_t* lut = g_code[u_is_t ? 1 : 0];
  Genome* g = new Genome();
  g->codes.reserve(raw.size());
  size_t i = 0, n = raw.size();
  std::string stripped;
  while (i < n) {
    size_t eol = raw.find('\n', i);
    if (eol == std::string::npos) eol = n;
    size_t end = eol;
    if (end > i && raw[end - 1] == '\r') end--;
    if (kind == 1) {
      // strip ALL whitespace within the line; drop if length <= 1
      stripped.clear();
      for (size_t j = i; j < end; j++) {
        unsigned char c = raw[j];
        if (c != ' ' && c != '\t' && c != '\v' && c != '\f' && c != '\r')
          stripped.push_back((char)c);
      }
      if (stripped.size() > 1) {
        if (stripped[0] == '>') {
          g->codes.push_back(4);
        } else {
          for (char c : stripped) g->codes.push_back(lut[(unsigned char)c]);
        }
      }
    } else {
      if (end > i) {
        if (raw[i] == '>') {
          g->codes.push_back(4);
        } else {
          for (size_t j = i; j < end; j++)
            g->codes.push_back(lut[(unsigned char)raw[j]]);
        }
      }
    }
    i = eol + 1;
  }
  return g;
}

// ---------------------------------------------------------------- radix sort

// LSB radix sort of keys with an optional parallel payload array.
// 16-bit digits: the 65537-entry count table stays L2-resident and a
// 60-bit key sorts in <= 4 passes (vs 8 at 8-bit digits).
template <typename P>
void radix_sort_u64(uint64_t* keys, P* payload, int64_t n) {
  if (n <= 1) return;
  std::vector<uint64_t> kbuf(n);
  std::vector<P> pbuf(payload ? n : 0);
  std::vector<int64_t> count(65537);
  uint64_t ormask = 0;
  for (int64_t i = 0; i < n; i++) ormask |= keys[i];
  uint64_t *src = keys, *dst = kbuf.data();
  P *psrc = payload, *pdst = pbuf.data();
  for (int pass = 0; pass < 4; pass++) {
    int shift = pass * 16;
    if (((ormask >> shift) & 0xFFFF) == 0 && pass > 0) continue;
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; i++) count[((src[i] >> shift) & 0xFFFF) + 1]++;
    if (count[(int)((src[0] >> shift) & 0xFFFF) + 1] == n) continue;  // single bucket
    for (int b = 0; b < 65536; b++) count[b + 1] += count[b];
    if (payload) {
      for (int64_t i = 0; i < n; i++) {
        int64_t o = count[(src[i] >> shift) & 0xFFFF]++;
        dst[o] = src[i];
        pdst[o] = psrc[i];
      }
      std::swap(psrc, pdst);
    } else {
      for (int64_t i = 0; i < n; i++) dst[count[(src[i] >> shift) & 0xFFFF]++] = src[i];
    }
    std::swap(src, dst);
  }
  if (src != keys) memcpy(keys, src, n * sizeof(uint64_t));
  if (payload && psrc != payload) memcpy(payload, psrc, n * sizeof(P));
}

}  // namespace

extern "C" {

void* km_load_genome(const char* path, int kind, int u_is_t) {
  return load_genome(path, kind, u_is_t);
}

int64_t km_genome_len(void* h) {
  return h ? (int64_t)((Genome*)h)->codes.size() : -1;
}

void km_free_genome(void* h) { delete (Genome*)h; }

// Canonical k-mers of the loaded genome, KEY-SORTED UNIQUE.
//   mode 0: fill uk[] + counts[] (occurrences per distinct key)
//   mode 1: fill uk[] + pos[] + fwd[] of each key's FIRST genome occurrence
//           (pos = 0-based index of the k-mer's last base)
// Caller allocates capacity genome_len (-KSIZE+1) for every array.
// Returns the number of distinct keys.
int64_t km_extract_unique(void* h, int mode, uint64_t* uk, int32_t* aux,
                          uint8_t* fwd) {
  Genome* g = (Genome*)h;
  const int64_t n = (int64_t)g->codes.size();
  if (n < KSIZE) return 0;
  const uint64_t mask = (1ULL << (2 * KSIZE)) - 1;
  std::vector<uint64_t> keys;
  keys.reserve(n);
  std::vector<int32_t> pos;
  std::vector<uint8_t> fvec;
  if (mode == 1) {
    pos.reserve(n);
    fvec.reserve(n);
  }
  uint64_t keyF = 0, keyR = 0;
  int cpos = 0;
  const uint8_t* c = g->codes.data();
  for (int64_t i = 0; i < n; i++) {
    uint8_t code = c[i];
    if (code >= 4) {
      cpos = 0;
      keyF = keyR = 0;
      continue;
    }
    keyF = ((keyF << 2) | code) & mask;
    keyR = (keyR >> 2) | ((uint64_t)(3 - code) << (2 * (KSIZE - 1)));
    if (++cpos >= KSIZE) {
      cpos = KSIZE;  // sliding window: every subsequent position emits
      bool f = keyF < keyR;
      keys.push_back(f ? keyF : keyR);
      if (mode == 1) {
        pos.push_back((int32_t)i);
        fvec.push_back(f ? 1 : 0);
      }
    }
  }
  int64_t m = (int64_t)keys.size();
  if (m == 0) return 0;
  if (mode == 0) {
    radix_sort_u64<uint32_t>(keys.data(), nullptr, m);
    int64_t out = 0;
    int64_t run = 1;
    for (int64_t i = 1; i <= m; i++) {
      if (i < m && keys[i] == keys[i - 1]) {
        run++;
      } else {
        uk[out] = keys[i - 1];
        aux[out] = (int32_t)(run > INT32_MAX ? INT32_MAX : run);
        out++;
        run = 1;
      }
    }
    return out;
  }
  // mode 1: stable radix keeps genome order within runs -> first of each
  // run is the first occurrence
  std::vector<uint32_t> idx(m);
  for (int64_t i = 0; i < m; i++) idx[i] = (uint32_t)i;
  radix_sort_u64<uint32_t>(keys.data(), idx.data(), m);
  int64_t out = 0;
  for (int64_t i = 0; i < m; i++) {
    if (i == 0 || keys[i] != keys[i - 1]) {
      uk[out] = keys[i];
      aux[out] = pos[idx[i]];
      fwd[out] = fvec[idx[i]];
      out++;
    }
  }
  return out;
}

void km_sort_u64(uint64_t* a, int64_t n) { radix_sort_u64<uint32_t>(a, nullptr, n); }

// Stable ascending argsort of uint64 keys (radix with index payload).
void km_argsort_u64(const uint64_t* a, int64_t n, int64_t* order) {
  std::vector<uint64_t> keys(a, a + n);
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; i++) idx[i] = i;
  radix_sort_u64<int64_t>(keys.data(), idx.data(), n);
  memcpy(order, idx.data(), n * sizeof(int64_t));
}

// Stable ascending argsort of non-negative int32 values (4x8-bit radix on
// the value with an int64 index payload).
void km_argsort_i32(const int32_t* a, int64_t n, int64_t* order) {
  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; i++) keys[i] = (uint64_t)(uint32_t)a[i];
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; i++) idx[i] = i;
  radix_sort_u64<int64_t>(keys.data(), idx.data(), n);
  memcpy(order, idx.data(), n * sizeof(int64_t));
}

// 30-char base strings (MSB base first), 30 bytes per key, no separators.
void km_keys_to_str(const uint64_t* keys, int64_t n, char* out) {
  static const char B[4] = {'A', 'C', 'G', 'T'};
  for (int64_t i = 0; i < n; i++) {
    uint64_t k = keys[i];
    char* o = out + i * KSIZE;
    for (int j = KSIZE - 1; j >= 0; j--) {
      o[j] = B[k & 3];
      k >>= 2;
    }
  }
}

// Entropy filter (db/entropy.check_entropy_keys twin).
//   fterm: double[3][32] — fterm[g][c] = -((c/T_g) * log10(c/T_g)) computed
//          by the CALLER with np.log10 for T_g in {19, 14, 10} (groups
//          mod2/mod3/mod5 with +4 pseudocount totals); c = count + 1.
//   log10_4: np.log10(4.0), passed in for bit-identity.
// Summation replicates NumPy: per class, pairwise axis-1 sum
// (t0+t1)+(t2+t3); classes accumulate sequentially; then /ncls /log10_4.
void km_entropy(const uint64_t* keys, int64_t n, const double* fterm,
                double log10_4, double min_entropy, int32_t max_run,
                uint8_t* ok) {
  static const int NGROUP = 3;
  static const int NCLS[NGROUP] = {2, 3, 5};
  for (int64_t i = 0; i < n; i++) {
    uint8_t codes[KSIZE];
    uint64_t k = keys[i];
    for (int j = KSIZE - 1; j >= 0; j--) {
      codes[j] = (uint8_t)(k & 3);
      k >>= 2;
    }
    // homopolymer run
    int run = 1, best = 1;
    for (int j = 1; j < KSIZE; j++) {
      run = (codes[j] == codes[j - 1]) ? run + 1 : 1;
      if (run > best) best = run;
    }
    bool pass = best <= max_run;
    if (pass) {
      for (int gidx = 0; gidx < NGROUP && pass; gidx++) {
        const int ncls = NCLS[gidx];
        const double* f = fterm + gidx * 32;
        double ent_sum = 0.0;
        for (int cls = 0; cls < ncls; cls++) {
          int cnt[4] = {0, 0, 0, 0};
          for (int j = cls; j < KSIZE; j += ncls) cnt[codes[j]]++;
          double t0 = f[cnt[0] + 1], t1 = f[cnt[1] + 1];
          double t2 = f[cnt[2] + 1], t3 = f[cnt[3] + 1];
          ent_sum += (t0 + t1) + (t2 + t3);
        }
        double e = ent_sum / (double)ncls / log10_4;
        if (e < min_entropy) pass = false;
      }
    }
    ok[i] = pass ? 1 : 0;
  }
}

// K-way merge of sorted (keys, counts, targets) runs with saturating count
// sum and tree-LCA target folding — the native twin of
// db/build.TableBuilder._consolidate (sort + reduceat + segmented_lca).
// LCA fold: pairwise tree LCA via parent/depth walks; pairwise folding of a
// segment equals the exact set-LCA (the meet of a tree semilattice), the
// same value segmented_lca computes (tests assert).  Saturating-sum cap is
// associative for non-negative counts, so batchwise capping matches too.
static inline int32_t tree_lca(int32_t x, int32_t y, const int32_t* parent,
                               const int32_t* depth) {
  while (depth[x] > depth[y]) x = parent[x];
  while (depth[y] > depth[x]) y = parent[y];
  while (x != y) {
    x = parent[x];
    y = parent[y];
  }
  return x;
}

namespace {

struct Run {
  const uint64_t* k;
  const int32_t* c;
  const int32_t* t;
  int64_t n;
  // ownership of intermediate ladder buffers (null for caller arrays);
  // new[] default-initialization leaves POD arrays UNINITIALIZED — a
  // std::vector here would memset gigabytes per ladder pass
  std::shared_ptr<uint64_t[]> kb;
  std::shared_ptr<int32_t[]> cb_, tb_;
};

// Two-pointer merge of two sorted runs with saturating count sum and
// tree-LCA target fold (saturating add and LCA are associative, so any
// merge order yields the segmented-reduction result).
int64_t merge2(const Run& A, const Run& B, const int32_t* parent,
               const int32_t* depth, int32_t maxrep, uint64_t* ok,
               int32_t* oc, int32_t* ot) {
  const uint64_t *ka = A.k, *kb = B.k;
  const int32_t *ca = A.c, *cb = B.c;
  const int32_t *ta = A.t, *tb = B.t;
  int64_t na = A.n, nb = B.n, ia = 0, ib = 0, out = 0;
  // hot loop: distinct keys advance branch-free (cmov selects) — the
  // a<b direction is data-random, so a branchy merge mispredicts ~50%;
  // the equal-key combine (rare: cross-genome shared k-mers) stays a
  // predictable branch.
  while (ia < na && ib < nb) {
    uint64_t a = ka[ia], b = kb[ib];
    if (a == b) {
      int64_t cnt = (int64_t)ca[ia] + cb[ib];
      if (cnt > maxrep) cnt = maxrep;
      ok[out] = a;
      oc[out] = (int32_t)cnt;
      ot[out] = (ta[ia] == tb[ib]) ? ta[ia]
                                   : tree_lca(ta[ia], tb[ib], parent, depth);
      ia++; ib++; out++;
      continue;
    }
    bool la = a < b;
    ok[out] = la ? a : b;
    oc[out] = la ? ca[ia] : cb[ib];
    ot[out] = la ? ta[ia] : tb[ib];
    ia += la;
    ib += !la;
    out++;
  }
  for (; ia < na; ia++, out++) {
    ok[out] = ka[ia]; oc[out] = ca[ia]; ot[out] = ta[ia];
  }
  for (; ib < nb; ib++, out++) {
    ok[out] = kb[ib]; oc[out] = cb[ib]; ot[out] = tb[ib];
  }
  return out;
}

}  // namespace

// Ladder k-way merge: pairwise 2-way passes (n*log2(k) linear merge steps
// beat a heap's comparator overhead ~4x at builder scale).
int64_t km_merge_runs(int32_t nruns, const uint64_t** keys,
                      const int32_t** counts, const int32_t** targets,
                      const int64_t* lens, const int32_t* parent,
                      const int32_t* depth, int32_t maxrep,
                      uint64_t* out_keys, int32_t* out_counts,
                      int32_t* out_targets) {
  std::vector<Run> cur;
  for (int32_t r = 0; r < nruns; r++) {
    if (lens[r] > 0)
      cur.push_back({keys[r], counts[r], targets[r], lens[r], {}, {}, {}});
  }
  if (cur.empty()) return 0;
  while (cur.size() > 2) {
    size_t pairs = cur.size() / 2;
    std::vector<Run> nxt(pairs);
    // pair merges are independent: run them on 2 threads (the build hosts
    // have 2 cores; the prefetch worker idles during consolidation)
    auto work = [&](size_t start) {
      for (size_t j = start; j < pairs; j += 2) {
        const Run &A = cur[2 * j], &B = cur[2 * j + 1];
        int64_t cap = A.n + B.n;
        std::shared_ptr<uint64_t[]> kb(new uint64_t[cap]);
        std::shared_ptr<int32_t[]> cb(new int32_t[cap]);
        std::shared_ptr<int32_t[]> tb(new int32_t[cap]);
        int64_t n = merge2(A, B, parent, depth, maxrep, kb.get(), cb.get(),
                           tb.get());
        nxt[j] = {kb.get(), cb.get(), tb.get(), n, kb, cb, tb};
      }
    };
    if (pairs > 1) {
      std::thread t1(work, 1);
      work(0);
      t1.join();
    } else {
      work(0);
    }
    if (cur.size() & 1) nxt.push_back(cur.back());
    cur.swap(nxt);
  }
  if (cur.size() == 2)
    return merge2(cur[0], cur[1], parent, depth, maxrep, out_keys,
                  out_counts, out_targets);
  memcpy(out_keys, cur[0].k, cur[0].n * sizeof(uint64_t));
  memcpy(out_counts, cur[0].c, cur[0].n * sizeof(int32_t));
  memcpy(out_targets, cur[0].t, cur[0].n * sizeof(int32_t));
  return cur[0].n;
}

// Pass-3 per-genome candidate prep (db/build.build_probes): galloping
// sorted-vs-sorted lookup of the genome's first-occurrence keys in the
// consolidated table, destructive consume, fresh/emittable gating, and
// genome-position reordering — one call replacing searchsorted + four
// boolean compressions + the position argsort.
int64_t km_pass3_candidates(const uint64_t* tk, int64_t T, uint8_t* consumed,
                            const uint8_t* emittable, const uint64_t* uk,
                            const int32_t* up, const uint8_t* uf, int64_t n,
                            uint64_t* ck, int32_t* cp, uint8_t* cf,
                            int64_t* cti) {
  int64_t out = 0;
  int64_t lo = 0;
  for (int64_t i = 0; i < n; i++) {
    uint64_t k = uk[i];
    // gallop forward from the previous match position (queries are sorted)
    int64_t step = 1, hi = lo;
    while (hi < T && tk[hi] < k) {
      lo = hi + 1;
      hi = lo + step;
      step <<= 1;
    }
    if (hi > T) hi = T;
    // binary search in (lo-1, hi]
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (tk[mid] < k) lo = mid + 1;
      else hi = mid;
    }
    if (lo < T && tk[lo] == k) {
      bool fresh = !consumed[lo];
      consumed[lo] = 1;  // destructive getHash: consumed on ANY query
      if (fresh && emittable[lo]) {
        ck[out] = k;
        cp[out] = up[i];
        cf[out] = uf[i];
        cti[out] = lo;
        out++;
      }
    }
  }
  // reorder by genome position (radix argsort on cp, then permute)
  if (out > 1) {
    std::vector<uint64_t> keys(out);
    std::vector<int64_t> idx(out);
    for (int64_t i = 0; i < out; i++) {
      keys[i] = (uint64_t)(uint32_t)cp[i];
      idx[i] = i;
    }
    radix_sort_u64<int64_t>(keys.data(), idx.data(), out);
    std::vector<uint64_t> tck(ck, ck + out);
    std::vector<int32_t> tcp(cp, cp + out);
    std::vector<uint8_t> tcf(cf, cf + out);
    std::vector<int64_t> tcti(cti, cti + out);
    for (int64_t i = 0; i < out; i++) {
      int64_t j = idx[i];
      ck[i] = tck[j];
      cp[i] = tcp[j];
      cf[i] = tcf[j];
      cti[i] = tcti[j];
    }
  }
  return out;
}

// Probe-text emission (db/probes.write_probes_text twin, plain-text only):
// "KMERSTR,target,org,position,strand,count\n" per row.  Returns 0 on
// success, -1 on open/write failure.
int32_t km_write_probes(const char* path, const uint64_t* keys,
                        const int32_t* target, const int32_t* org,
                        const int32_t* position, const uint8_t* fstrand,
                        const int32_t* count, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  static const char B[4] = {'A', 'C', 'G', 'T'};
  std::vector<char> buf(1 << 20);
  setvbuf(f, buf.data(), _IOFBF, buf.size());
  char line[128];
  for (int64_t i = 0; i < n; i++) {
    uint64_t k = keys[i];
    for (int j = KSIZE - 1; j >= 0; j--) {
      line[j] = B[k & 3];
      k >>= 2;
    }
    int m = snprintf(line + KSIZE, sizeof(line) - KSIZE, ",%d,%d,%d,%c,%d\n",
                     target[i], org[i], position[i], fstrand[i] ? 'F' : 'R',
                     count[i]);
    if (fwrite(line, 1, KSIZE + m, f) != (size_t)(KSIZE + m)) {
      fclose(f);
      return -1;
    }
  }
  return fclose(f) == 0 ? 0 : -1;
}

// Emission chain walk (db/build.build_probes pass-3 inner loop).
// pcount is MUTATED (caller passes its trial copy).  Returns emit count.
int64_t km_emit_walk(const int32_t* ctarg, const int64_t* nxt,
                     const int64_t* run_next, const int8_t* ent_known,
                     int32_t* pcount, int32_t cap, int64_t n,
                     int64_t* emit_js) {
  int64_t out = 0;
  int64_t j = 0;
  while (j < n) {
    int32_t t = ctarg[j];
    if (pcount[t] >= cap) {
      j = run_next[j];
      continue;
    }
    if (ent_known[j] != 0) {
      emit_js[out++] = j;
      pcount[t]++;
      j = nxt[j];
      continue;
    }
    j++;
  }
  return out;
}

}  // extern "C"
