// Native host decode path: FASTQ/FASTA (gz or plain) -> trimmed, 2-bit-packed
// fixed-shape batches, exposed through a C ABI for ctypes.
//
// This is the framework's native IO runtime (the reference's C++ IO layer
// analog — SURVEY.md §2 "Languages present"): the Python fallback parsers in
// io/fastx.py define the behavioral contract (themselves mirroring the
// reference parsers' record semantics, e.g. newkmer_10nx.cpp:762-913 and
// kmer_read_vf6.cpp:831-870), and tests assert this implementation produces
// identical batches.  Per record:
//   * parse according to the format's quirks (4-phase counter that skips
//     empty lines, first-token vs full-line fields, stale-token reuse),
//   * PHRED trim (newkmer_10nx.cpp:714-760 loop semantics, exactly),
//   * gate (FASTQ: trimmed length > KSIZE via stop-start >= KSIZE;
//     FASTA: sequence length > KSIZE),
//   * encode the trimmed subsequence to 2-bit codes (4 = invalid) into the
//     caller's [B, L] plane, left-justified,
//   * pack the row's codes into the device's transfer form in the same pass,
//     while the row is in cache: the [B, ceil(L/16)] uint32 plane of 2-bit
//     words (code & 3, 16 a word, low bits first; padding packs as 0) and
//     the exception list of flat row * L + pos of every non-ACGT code within
//     the row's length, carried with its count across calls (entries stop at
//     the list's capacity, the count does not),
//   * stash the accession and trimmed sequence text (saved-read capture).
// Reads longer than L report their full length; the caller rebuilds them
// from the stashed text for the chunked long-read path.  Their truncated
// codes pack as any row's, and they add no exceptions (their device length
// is 0).  The words and the list equal io/batch.py:pack_codes of the code
// plane at each row's device length.
//
// The stream is read ahead on a worker thread per open file (LineReader), so
// inflating overlaps the parse; batches do not depend on where its blocks
// end.
//
// Build: g++ -O3 -shared -fPIC -pthread fastx_native.cpp -o libfastx.so -lz

#include <zlib.h>

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr int KSIZE = 30;
constexpr char CUTOFF = 49;  // '1' = 33 + 16? no: 32 + 17 (newkmer_10nx.cpp:718)
constexpr int WINDOW = 4;
constexpr int WINDOW_CUT = 49 * 4;

enum Format : int {
  FASTQ_GZ = 0,
  FASTQ_PLAIN = 1,
  FASTA_GZ = 2,
  FASTA_PLAIN = 3,
};

// The read-ahead: one worker thread per open file owns its gzFile or FILE*
// and reads the stream, inflating it where it is gzip, into a ring of kRing
// preallocated blocks of kBlock bytes while the calling thread parses.  A
// read that returns <= 0 ends the stream, as a direct read did: a truncated
// or corrupt .gz stops at the same byte.  Plain files take the same worker.
constexpr int kBlock = 1 << 20;
constexpr int kRing = 4;

struct LineReader {
  gzFile gz = nullptr;
  FILE* fp = nullptr;
  std::string buf;
  size_t pos = 0;
  bool eof_ = false;
  // The ring: slots [head, head + count) mod kRing hold filled blocks, in
  // stream order; the worker writes the next slot only while count < kRing,
  // so the slot the fill copies from stays its own until it hands it back.
  std::unique_ptr<char[]> ring;
  int len[kRing] = {};
  int head = 0, count = 0;
  bool ended = false;  // the worker read the stream's end
  bool stop = false;   // close: the worker returns at its next check
  std::mutex mu;
  std::condition_variable filled, freed;
  std::thread worker;
  // Blocks the fill took, how many of them it waited for and the
  // nanoseconds it waited, since the batch call that reset them.
  int64_t blocks = 0, waits = 0, wait_ns = 0;

  ~LineReader() { close(); }  // a joinable std::thread must not be destroyed

  bool open(const char* path, bool gzip) {
    if (gzip) {
      gz = gzopen(path, "rb");
      if (!gz) return false;
    } else {
      fp = fopen(path, "rb");
      if (!fp) return false;
    }
    ring.reset(new char[(size_t)kRing * kBlock]);
    try {
      worker = std::thread(&LineReader::run, this);
    } catch (const std::system_error&) {
      close();
      return false;
    }
    return true;
  }

  // Stops and joins the worker, then closes the stream it owned.
  void close() {
    if (worker.joinable()) {
      {
        std::lock_guard<std::mutex> lk(mu);
        stop = true;
      }
      freed.notify_all();
      filled.notify_all();
      worker.join();
    }
    if (gz) gzclose(gz);
    if (fp) fclose(fp);
    gz = nullptr;
    fp = nullptr;
  }

  // The worker: fills the ring's free slots in order until the stream ends
  // or close stops it.
  void run() {
    for (int tail = 0;; tail = (tail + 1) % kRing) {
      {
        std::unique_lock<std::mutex> lk(mu);
        freed.wait(lk, [&] { return stop || count < kRing; });
        if (stop) return;
      }
      char* dst = ring.get() + (size_t)tail * kBlock;
      int n = gz ? gzread(gz, dst, kBlock) : (int)fread(dst, 1, kBlock, fp);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (n > 0) {
          len[tail] = n;
          count++;
        } else {
          ended = true;
        }
      }
      filled.notify_one();
      if (n <= 0) return;
    }
  }

  // Appends the ring's next block to buf (after dropping the lines already
  // taken), waiting for the worker where the ring is empty; false at the
  // stream's end.
  bool fill() {
    int slot;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (count == 0 && !ended) {
        auto t0 = std::chrono::steady_clock::now();
        filled.wait(lk, [&] { return count > 0 || ended; });
        if (count > 0) {
          waits++;
          wait_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                         std::chrono::steady_clock::now() - t0)
                         .count();
        }
      }
      if (count == 0) {
        eof_ = true;
        return false;
      }
      slot = head;
    }
    buf.erase(0, pos);
    pos = 0;
    buf.append(ring.get() + (size_t)slot * kBlock, len[slot]);
    {
      std::lock_guard<std::mutex> lk(mu);
      head = (head + 1) % kRing;
      count--;
    }
    freed.notify_one();
    blocks++;
    return true;
  }

  // Next line without trailing \n / \r\n; false at EOF.
  bool next(std::string* line) {
    for (;;) {
      size_t nl = buf.find('\n', pos);
      if (nl != std::string::npos) {
        line->assign(buf, pos, nl - pos);
        pos = nl + 1;
        if (!line->empty() && line->back() == '\r') line->pop_back();
        return true;
      }
      if (eof_) {
        if (pos < buf.size()) {
          line->assign(buf, pos, buf.size() - pos);
          pos = buf.size();
          if (!line->empty() && line->back() == '\r') line->pop_back();
          return true;
        }
        return false;
      }
      fill();
    }
  }
};

struct Record {
  std::string acc;
  std::string seq;   // trimmed
  bool ok = false;
};

uint8_t g_lut[2][256];
bool g_lut_init = false;

void init_luts() {
  if (g_lut_init) return;
  for (int v = 0; v < 2; v++)
    for (int c = 0; c < 256; c++) g_lut[v][c] = 4;
  const char* b = "ACGT";
  for (int i = 0; i < 4; i++) {
    g_lut[0][(unsigned char)b[i]] = i;
    g_lut[0][(unsigned char)(b[i] + 32)] = i;
    g_lut[1][(unsigned char)b[i]] = i;
    g_lut[1][(unsigned char)(b[i] + 32)] = i;
  }
  g_lut[1]['U'] = 3;
  g_lut[1]['u'] = 3;
  g_lut_init = true;
}

// process_qual trim (newkmer_10nx.cpp:714-760); returns keep.
bool trim(const std::string& seq, const std::string& qual, int* start_out,
          int* stop_out) {
  int len = (int)seq.size();
  if (len == 0) return false;
  int stop = len - 1;
  int start = 0;
  auto q = [&](int i) -> int {
    return i < (int)qual.size() ? (unsigned char)qual[i] : 0;
  };
  while (q(start) < CUTOFF && start < stop) start++;
  while (q(stop) < CUTOFF && stop > start) stop--;
  if (start < stop - WINDOW) {
    int wv = q(start) + q(start + 1) + q(start + 2) + q(start + 3);
    while (wv < WINDOW_CUT && start < stop - WINDOW) {
      wv += q(start + 4) - q(start);
      start++;
    }
  }
  if (start < stop - WINDOW) {
    int wv = q(stop) + q(stop - 1) + q(stop - 2) + q(stop - 3);
    while (wv < WINDOW_CUT && start < stop - WINDOW) {
      wv += q(stop - 4) - q(stop);
      stop--;
    }
  }
  *start_out = start;
  *stop_out = stop;
  return (stop - start) >= KSIZE;
}

struct Reader {
  LineReader lr;
  Format fmt;
  int mod4 = 0;
  std::string acc, seq, tok;
  std::vector<std::string> fa_parts;
  std::string fa_acc;
  bool done = false;
  Record pending;
  bool has_pending = false;

  static std::string first_token(const std::string& line, std::string* sticky) {
    size_t i = 0;
    while (i < line.size() && isspace((unsigned char)line[i])) i++;
    size_t j = i;
    while (j < line.size() && !isspace((unsigned char)line[j])) j++;
    if (j > i) *sticky = line.substr(i, j - i);
    return *sticky;  // stale-token quirk: reuse previous on failed extraction
  }

  // Returns false at end of file.  Fills rec (rec->ok false => record
  // dropped by gates, but still consumed).
  bool next_record(Record* rec) {
    rec->ok = false;
    std::string line;
    switch (fmt) {
      case FASTQ_GZ:
      case FASTQ_PLAIN: {
        const bool tokenized = (fmt == FASTQ_PLAIN);
        while (lr.next(&line)) {
          std::string field;
          if (tokenized) {
            field = first_token(line, &tok);
          } else {
            field = line;
          }
          if (field.empty()) continue;  // phase does not advance
          if (mod4 == 0) acc = field;
          else if (mod4 == 1) seq = field;
          else if (mod4 == 3) {
            mod4 = 0;
            int start, stop;
            if (trim(seq, field, &start, &stop)) {
              rec->ok = true;
              rec->acc = acc;
              rec->seq = seq.substr(start, stop - start + 1);
            }
            return true;
          }
          if (mod4 != 0) mod4 = (mod4 + 1) % 4;
          else mod4 = 1;
        }
        return false;
      }
      case FASTA_GZ:
      case FASTA_PLAIN: {
        const bool tokenized = (fmt == FASTA_PLAIN);
        while (lr.next(&line)) {
          std::string field;
          if (tokenized) {
            field = first_token(line, &tok);
            if (field.empty()) continue;
          } else {
            field = line;
            if (field.empty()) continue;
          }
          if (field[0] == '>') {
            std::string prev_acc = fa_acc;
            std::string s;
            for (auto& p : fa_parts) s += p;
            fa_parts.clear();
            fa_acc = field.substr(1);
            if ((int)s.size() > KSIZE) {
              rec->ok = true;
              rec->acc = prev_acc;
              rec->seq = s;
              return true;
            }
            // dropped record: keep scanning
          } else {
            fa_parts.push_back(field);
          }
        }
        if (!done) {
          done = true;
          std::string s;
          for (auto& p : fa_parts) s += p;
          fa_parts.clear();
          if ((int)s.size() > KSIZE) {
            rec->ok = true;
            rec->acc = fa_acc;
            rec->seq = s;
            return true;
          }
        }
        return false;
      }
    }
    return false;
  }
};

// 8 codes (one per byte, each < 8) -> their 2-bit fields, low code first.
inline uint32_t pack8(uint64_t x) {
  x &= 0x0303030303030303ULL;
  x |= x >> 6;   // byte j: code j | code j+1 << 2
  x |= x >> 12;  // bytes 0 and 4: four codes each
  return (uint32_t)(x & 0xFF) | (uint32_t)((x >> 24) & 0xFF00);
}

inline uint32_t pack16(const uint8_t* c) {
  uint64_t lo, hi;
  memcpy(&lo, c, 8);
  memcpy(&hi, c + 8, 8);
  return pack8(lo) | (pack8(hi) << 16);
}

}  // namespace

extern "C" {

void* fx_open(const char* path, int format, int u_is_t) {
  init_luts();
  Reader* r = new Reader();
  r->fmt = (Format)format;
  bool gz = (format == FASTQ_GZ || format == FASTA_GZ);
  if (!r->lr.open(path, gz)) {
    delete r;
    return nullptr;
  }
  (void)u_is_t;  // encoding variant chosen per batch call
  return r;
}

void fx_close(void* h) {
  delete (Reader*)h;  // ~LineReader stops the worker and closes the stream
}

// Fill rows [row0, B) of a [B, L] code plane and of its [B, ceil(L/16)]
// plane of packed words; append the rows' exceptions to exc[*n_exc...]
// (entries written below exc_cap, *n_exc counts them all).
// Returns number of rows filled this call; *eof set when the file is done.
// Text blobs: acc/seq bytes appended with (B+1)-length offset arrays
// (caller guarantees capacity; on overflow returns -1).
// ring[0..2]: the read-ahead blocks this call took, how many of them it
// waited for, and the nanoseconds it waited.
int fx_next_batch_packed(void* h, int row0, int batch, int max_len, int u_is_t,
                         uint8_t* codes, int32_t* lengths, uint32_t* packed,
                         int32_t* exc, int32_t exc_cap, int32_t* n_exc,
                         char* acc_buf, int64_t acc_cap, int64_t* acc_off,
                         char* seq_buf, int64_t seq_cap, int64_t* seq_off,
                         int32_t* eof, int64_t* ring) {
  Reader* r = (Reader*)h;
  r->lr.blocks = r->lr.waits = r->lr.wait_ns = 0;
  const uint8_t* lut = g_lut[u_is_t ? 1 : 0];
  const int words = (max_len + 15) / 16;
  const int full = max_len / 16;  // words with all 16 codes inside the row
  *eof = 0;
  int row = row0;
  int32_t nexc = *n_exc;
  if (row == 0) {
    acc_off[0] = 0;
    seq_off[0] = 0;
  }
  Record rec;
  while (row < batch) {
    if (r->has_pending) {
      rec = r->pending;
      r->has_pending = false;
    } else if (!r->next_record(&rec)) {
      *eof = 1;
      break;
    }
    if (!rec.ok) continue;
    int64_t apos = acc_off[row];
    int64_t spos = seq_off[row];
    if (apos + (int64_t)rec.acc.size() > acc_cap ||
        spos + (int64_t)rec.seq.size() > seq_cap) {
      // blob full: stash the record and let the caller flush/grow
      r->pending = rec;
      r->has_pending = true;
      break;
    }
    memcpy(acc_buf + apos, rec.acc.data(), rec.acc.size());
    memcpy(seq_buf + spos, rec.seq.data(), rec.seq.size());
    acc_off[row + 1] = apos + rec.acc.size();
    seq_off[row + 1] = spos + rec.seq.size();
    int n = (int)rec.seq.size();
    lengths[row] = n;
    uint8_t* out = codes + (int64_t)row * max_len;
    int ncopy = n < max_len ? n : max_len;
    uint8_t any_bad = 0;
    for (int i = 0; i < ncopy; i++) {
      uint8_t c = lut[(unsigned char)rec.seq[i]];
      out[i] = c;
      any_bad |= c;
    }
    for (int i = ncopy; i < max_len; i++) out[i] = 4;
    if ((any_bad & 4) && n <= max_len) {
      const int32_t base = (int32_t)((int64_t)row * max_len);
      for (int i = 0; i < ncopy; i++) {
        if (out[i] >= 4) {
          if (nexc < exc_cap) exc[nexc] = base + i;
          nexc++;
        }
      }
    }
    uint32_t* pw = packed + (int64_t)row * words;
    for (int w = 0; w < full; w++) pw[w] = pack16(out + 16 * w);
    if (full < words) {
      uint8_t tail[16] = {0};
      memcpy(tail, out + 16 * full, max_len - 16 * full);
      pw[full] = pack16(tail);
    }
    row++;
  }
  *n_exc = nexc;
  ring[0] = r->lr.blocks;
  ring[1] = r->lr.waits;
  ring[2] = r->lr.wait_ns;
  return row - row0;
}

}  // extern "C"
