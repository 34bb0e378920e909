// kmer_io — native host runtime for the k-mer counting engine.
//
// C++ replacements for the hot host-side paths, exposed through a plain C
// ABI consumed via ctypes (kmer_counter/io/native.py):
//
//   * FASTQ chunk reader: streams a FASTQ file and fills dense row-major
//     [max_reads, line_length] uint8 matrices — the native twin of
//     kmer_counter.io.fastq.FASTQReader (itself the re-design of the
//     reference's FASTQFileReader.cpp:49-89 getline loop).  Strict 4-line
//     parsing; CR stripped; short rows zero-padded.
//   * K-way merge of sorted record runs: the native twin of
//     kmer_counter.io.spill.merge_runs (reference:
//     KMerFileMerger.cpp:49-135 + SortedKMerFile.cpp:29-82), using a
//     loser-tree-ish binary heap instead of the reference's linear scan.
//
// Record format (SURVEY.md §2.2): ceil(k/32) uint64 little-endian key words
// (MSB-first 2-bit bases) followed by a uint32 count.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t kReadBlock = 8u << 20;

struct FastqReader {
  FILE* f = nullptr;
  std::vector<unsigned char> buf;   // unparsed bytes
  size_t buf_pos = 0;               // parse cursor
  long line_length = 0;
  long phase = 0;                   // line index mod 4
  bool eof = false;
  long long abs_base = 0;           // file offset of buf[0]
  long long limit = -1;             // stop at first header at/past this
  bool done = false;                // byte range exhausted
};

// Read more bytes into buf (compacting consumed prefix). Returns false at EOF
// with nothing new.
bool refill(FastqReader* r) {
  if (r->buf_pos > 0) {
    r->buf.erase(r->buf.begin(), r->buf.begin() + r->buf_pos);
    r->abs_base += r->buf_pos;
    r->buf_pos = 0;
  }
  if (r->eof) return false;
  size_t old = r->buf.size();
  r->buf.resize(old + kReadBlock);
  size_t got = fread(r->buf.data() + old, 1, kReadBlock, r->f);
  r->buf.resize(old + got);
  if (got == 0) {
    r->eof = true;
    // final unterminated line counts as a line
    if (!r->buf.empty() && r->buf.back() != '\n') r->buf.push_back('\n');
    return !r->buf.empty();
  }
  return true;
}

// Next complete line [start, end) within buf, or false if none buffered.
bool next_line(FastqReader* r, size_t* start, size_t* end) {
  const unsigned char* base = r->buf.data();
  size_t avail = r->buf.size() - r->buf_pos;
  const void* nl = memchr(base + r->buf_pos, '\n', avail);
  if (nl == nullptr) return false;
  *start = r->buf_pos;
  *end = static_cast<const unsigned char*>(nl) - base;
  r->buf_pos = *end + 1;
  if (*end > *start && base[*end - 1] == '\r') --*end;  // strip CR
  return true;
}

// Absolute offset of the first record header at/after `start`, or -1 when
// none exists.  A record header is a line starting with '@' whose line+2
// starts with '+' (rejecting '@'-leading quality lines) — the same resync
// rule as kmer_counter.io.fastq.FASTQReader._seek_to_record, so the
// native and Python parsers shard a file identically.
long long find_record_start(FILE* f, long long start) {
  if (start <= 0) return 0;
  // Read from start-1 so every line start is identified by the newline
  // before it (a header exactly at `start` is then found).
  long long base = start - 1;
  if (fseek(f, static_cast<long>(base), SEEK_SET) != 0) return -1;
  std::vector<unsigned char> window;
  std::vector<size_t> nls;
  size_t scanned = 0;
  while (true) {
    size_t old = window.size();
    window.resize(old + kReadBlock);
    size_t got = fread(window.data() + old, 1, kReadBlock, f);
    window.resize(old + got);
    for (size_t i = scanned; i < window.size(); ++i)
      if (window[i] == '\n') nls.push_back(i);
    scanned = window.size();
    bool need_more = false;
    for (size_t j = 0; j < nls.size(); ++j) {
      size_t ls = nls[j] + 1;
      if (ls >= window.size() || window[ls] != '@') continue;
      if (j + 2 >= nls.size()) {
        need_more = true;  // candidate pending the '+' line
        break;
      }
      size_t plus = nls[j + 2] + 1;
      if (plus < window.size() && window[plus] == '+')
        return base + static_cast<long long>(ls);
    }
    if (got == 0) return -1;  // no record begins in the remainder
    (void)need_more;
  }
}

}  // namespace

extern "C" {

void* kc_open(const char* path) {
  FastqReader* r = new FastqReader();
  r->f = fopen(path, "rb");
  if (r->f == nullptr) {
    delete r;
    return nullptr;
  }
  // Probe the first record's sequence line for the fixed read length
  // (FASTQFileReader.cpp:28-38 semantics).
  while (true) {
    size_t s, e;
    if (next_line(r, &s, &e)) {
      if (r->phase == 0 && (e == s || r->buf[s] != '@')) {
        fclose(r->f);
        delete r;
        return nullptr;
      }
      if (r->phase == 1) {
        r->line_length = static_cast<long>(e - s);
        break;
      }
      ++r->phase;
      continue;
    }
    if (!refill(r)) break;
  }
  if (r->line_length <= 0) {
    fclose(r->f);
    delete r;
    return nullptr;
  }
  // rewind: simplest is to reopen
  fclose(r->f);
  r->f = fopen(path, "rb");
  if (r->f == nullptr) {
    delete r;
    return nullptr;
  }
  r->buf.clear();
  r->buf_pos = 0;
  r->phase = 0;
  r->eof = false;
  r->abs_base = 0;
  return r;
}

// kc_open restricted to records whose header line begins in [start, end):
// adjacent ranges partition a file exactly (byte-range ingest sharding
// across hosts; the native twin of io.fastq.FASTQReader(byte_range=...)).
void* kc_open_range(const char* path, long long start, long long end) {
  FastqReader* r = static_cast<FastqReader*>(kc_open(path));
  if (r == nullptr) return nullptr;
  r->limit = end;
  if (start > 0) {
    long long hs = find_record_start(r->f, start);
    if (hs < 0 || hs >= end) {
      r->done = true;  // no record in this range; line_length still valid
      return r;
    }
    if (fseek(r->f, static_cast<long>(hs), SEEK_SET) != 0) {
      fclose(r->f);
      delete r;
      return nullptr;
    }
    r->abs_base = hs;
    r->buf.clear();
    r->buf_pos = 0;
    r->phase = 0;
    r->eof = false;
  }
  return r;
}

long kc_line_length(void* h) {
  return static_cast<FastqReader*>(h)->line_length;
}

// Fill out[max_reads * line_length] row-major; returns reads delivered
// (0 at EOF, -1 on error).  Rows shorter than line_length are zero-padded;
// longer rows are an error (fixed-line-length contract).
long kc_read_chunk(void* h, unsigned char* out, long max_reads) {
  FastqReader* r = static_cast<FastqReader*>(h);
  const long L = r->line_length;
  long delivered = 0;
  memset(out, 0, static_cast<size_t>(max_reads) * L);
  while (delivered < max_reads && !r->done) {
    size_t s, e;
    if (!next_line(r, &s, &e)) {
      if (!refill(r)) {
        // True EOF mid-record: the file is truncated — fail loudly
        // instead of silently dropping the partial record (range mode
        // excepted: ranges legitimately cut inside the buffered tail).
        if (r->limit < 0 && (r->phase & 3) != 0) return -1;
        break;
      }
      continue;
    }
    if ((r->phase & 3) == 0 && r->limit >= 0 &&
        r->abs_base + static_cast<long long>(s) >= r->limit) {
      // First record header at/past the byte limit: range exhausted
      // (records belong to the shard whose range holds their header).
      r->done = true;
      break;
    }
    // Structural validation (matches io.fastq.FASTQReader._parse_block):
    // phase tracking alone would desync on a malformed file.  Headers
    // must start with '@', separators with '+'; empty lines fail both.
    if ((r->phase & 3) == 0 && (e == s || r->buf[s] != '@')) return -1;
    if ((r->phase & 3) == 2 && (e == s || r->buf[s] != '+')) return -1;
    bool is_seq = (r->phase & 3) == 1;
    r->phase = (r->phase + 1) & 3;
    if (!is_seq) continue;
    long len = static_cast<long>(e - s);
    if (len > L) return -1;
    memcpy(out + static_cast<size_t>(delivered) * L, r->buf.data() + s, len);
    ++delivered;
  }
  return delivered;
}

void kc_close(void* h) {
  FastqReader* r = static_cast<FastqReader*>(h);
  if (r->f != nullptr) fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------------------
// K-way merge of sorted record runs.

namespace {

struct RunCursor {
  FILE* f = nullptr;
  std::vector<uint64_t> words;  // buffered records: n * W words
  std::vector<uint32_t> counts;
  size_t pos = 0;
  int W = 0;

  bool fill() {
    pos = 0;
    words.clear();
    counts.clear();
    if (f == nullptr) return false;
    constexpr size_t kRecs = 1u << 16;
    size_t rec_bytes = W * 8 + 4;
    std::vector<unsigned char> raw(kRecs * rec_bytes);
    size_t got = fread(raw.data(), 1, raw.size(), f);
    size_t n = got / rec_bytes;
    if (n == 0) {
      fclose(f);
      f = nullptr;
      return false;
    }
    words.resize(n * W);
    counts.resize(n);
    for (size_t i = 0; i < n; ++i) {
      memcpy(&words[i * W], &raw[i * rec_bytes], W * 8);
      memcpy(&counts[i], &raw[i * rec_bytes + W * 8], 4);
    }
    return true;
  }

  bool next(const uint64_t** key, uint64_t* count) {
    if (pos >= counts.size() && !fill()) return false;
    *key = &words[pos * W];
    *count = counts[pos];
    ++pos;
    return true;
  }
};

inline int cmp_key(const uint64_t* a, const uint64_t* b, int W) {
  for (int w = 0; w < W; ++w) {
    if (a[w] < b[w]) return -1;
    if (a[w] > b[w]) return 1;
  }
  return 0;
}

struct HeapItem {
  std::vector<uint64_t> key;
  uint64_t count;
  int src;
};

struct HeapCmp {
  int W;
  bool operator()(const HeapItem& a, const HeapItem& b) const {
    return cmp_key(a.key.data(), b.key.data(), W) > 0;  // min-heap
  }
};

}  // namespace

// Merge n sorted run files into out_path; duplicate keys' counts are summed
// (saturating at uint32 max). Returns records written, or -1 on error.
long kc_merge_runs(const char** paths, int n, const char* out_path, int k) {
  const int W = (k + 31) / 32;
  std::vector<RunCursor> runs(n);
  for (int i = 0; i < n; ++i) {
    runs[i].W = W;
    runs[i].f = fopen(paths[i], "rb");
    if (runs[i].f == nullptr) return -1;
  }
  FILE* out = fopen(out_path, "wb");
  if (out == nullptr) return -1;

  HeapCmp cmp{W};
  std::vector<HeapItem> heap;
  for (int i = 0; i < n; ++i) {
    const uint64_t* key;
    uint64_t c;
    if (runs[i].next(&key, &c)) {
      heap.push_back({std::vector<uint64_t>(key, key + W), c, i});
    }
  }
  std::make_heap(heap.begin(), heap.end(), cmp);

  const size_t rec_bytes = W * 8 + 4;
  std::vector<unsigned char> obuf;
  obuf.reserve((1u << 16) * rec_bytes);
  std::vector<uint64_t> cur_key(W);
  uint64_t cur_count = 0;
  bool have_cur = false;
  long written = 0;

  bool write_failed = false;
  auto emit = [&]() {
    size_t off = obuf.size();
    obuf.resize(off + rec_bytes);
    memcpy(&obuf[off], cur_key.data(), W * 8);
    uint32_t c32 =
        cur_count > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<uint32_t>(cur_count);
    memcpy(&obuf[off + W * 8], &c32, 4);
    ++written;
    if (obuf.size() >= (1u << 16) * rec_bytes) {
      if (fwrite(obuf.data(), 1, obuf.size(), out) != obuf.size())
        write_failed = true;  // e.g. disk full; surfaced as -1 below
      obuf.clear();
    }
  };

  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    HeapItem item = std::move(heap.back());
    heap.pop_back();
    if (have_cur && cmp_key(item.key.data(), cur_key.data(), W) == 0) {
      cur_count += item.count;
    } else {
      if (have_cur) emit();
      memcpy(cur_key.data(), item.key.data(), W * 8);
      cur_count = item.count;
      have_cur = true;
    }
    const uint64_t* key;
    uint64_t c;
    if (runs[item.src].next(&key, &c)) {
      memcpy(item.key.data(), key, W * 8);
      item.count = c;
      heap.push_back(std::move(item));
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
  }
  if (have_cur) emit();
  if (!obuf.empty() &&
      fwrite(obuf.data(), 1, obuf.size(), out) != obuf.size())
    write_failed = true;
  if (fclose(out) != 0) write_failed = true;
  return write_failed ? -1 : written;
}

}  // extern "C"
