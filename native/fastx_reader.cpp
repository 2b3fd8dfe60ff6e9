// Native FASTA/FASTQ(.gz) batch reader for ntedit_tpu.
//
// Plays the role the reference fills with native readers: kseq over zlib
// for the draft (/root/reference/ntedit.cpp:42, lib/kseq.h) and
// btllib::SeqReader for reads in the BF builder
// (/root/reference/src/ntedit_make_genome_bf.cpp:26-29).  This is a
// from-scratch block reader, not a port: it scans decompressed blocks
// with memchr and returns RECORD BATCHES through a flat C ABI (one
// concatenated sequence buffer + offset arrays), which is the shape the
// Python/numpy side wants — per-record Python objects are what make the
// pure-Python reader slow, so the batch boundary is the design point.
//
// Build: make -C native libntpu_io.so   (zlib only dependency)

#include <zlib.h>

#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t kBlock = 1 << 20;

constexpr size_t kNoMark = static_cast<size_t>(-1);

struct Reader {
  gzFile gz = nullptr;
  std::vector<uint8_t> buf;   // decoded pending bytes
  size_t pos = 0;             // consume cursor into buf
  size_t mark = kNoMark;      // start of the record being parsed: kept
                              // buffered so an overflowing record can be
                              // re-read whole by the next call
  bool eof = false;
  int fmt = 0;                // 0 unknown, '>' fasta, '@' fastq
  std::string err;

  bool fill() {
    if (eof) return pos < buf.size();
    size_t drop = mark == kNoMark ? pos : (mark < pos ? mark : pos);
    if (drop > 0) {
      buf.erase(buf.begin(), buf.begin() + static_cast<long>(drop));
      pos -= drop;
      if (mark != kNoMark) mark -= drop;
    }
    size_t old = buf.size();
    buf.resize(old + kBlock);
    int n = gzread(gz, buf.data() + old, kBlock);
    if (n < 0) {
      err = "gzread failed";
      eof = true;
      buf.resize(old);
      return false;
    }
    buf.resize(old + static_cast<size_t>(n));
    if (n == 0) eof = true;
    return buf.size() > pos;
  }

  // Return pointer/len of the next full line (without newline); nullptr if
  // no complete line is buffered and the file is exhausted.
  const uint8_t* line(size_t* len) {
    for (;;) {
      const uint8_t* base = buf.data() + pos;
      size_t avail = buf.size() - pos;
      const void* nl = memchr(base, '\n', avail);
      if (nl != nullptr) {
        size_t l = static_cast<size_t>(static_cast<const uint8_t*>(nl) - base);
        *len = (l > 0 && base[l - 1] == '\r') ? l - 1 : l;
        pos += l + 1;
        return base;
      }
      if (eof) {
        if (avail == 0) return nullptr;
        *len = avail;  // final unterminated line
        pos += avail;
        return base;
      }
      if (!fill()) {
        if (buf.size() == pos) return nullptr;
      }
    }
  }

  // Peek the first non-empty byte.
  int peek() {
    for (;;) {
      while (pos < buf.size()) {
        uint8_t c = buf[pos];
        if (c == '\n' || c == '\r') {
          ++pos;
          continue;
        }
        return c;
      }
      if (eof) return -1;
      if (!fill() && pos >= buf.size()) return -1;
    }
  }
};

}  // namespace

extern "C" {

void* ntpu_fastx_open(const char* path) {
  gzFile gz = gzopen(path, "rb");
  if (gz == nullptr) return nullptr;
  gzbuffer(gz, kBlock);
  auto* r = new Reader();
  r->gz = gz;
  return r;
}

void ntpu_fastx_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (r != nullptr) {
    if (r->gz != nullptr) gzclose(r->gz);
    delete r;
  }
}

// Read up to max_rec records.  Sequence bytes are concatenated into
// seq_buf (capacity seq_cap) with seq_offs[0..n] boundaries; headers
// (name + ' ' + comment, kseq whitespace split preserved verbatim after
// the tag byte) go to hdr_buf/hdr_offs likewise; FASTQ qualities land in
// qual_buf at the same offsets as the sequence (equal lengths enforced).
// Returns the number of records delivered; 0 on EOF; -1 on malformed
// input; -2 if a single record exceeds the buffer capacity (caller
// retries with bigger buffers).  A record that does not fit is not
// consumed: the next call starts at its header.  *is_fastq is set to 1
// for FASTQ.
long ntpu_fastx_next(void* h, uint8_t* seq_buf, long seq_cap, long* seq_offs,
                     uint8_t* hdr_buf, long hdr_cap, long* hdr_offs,
                     uint8_t* qual_buf, int* is_fastq, long max_rec) {
  auto* r = static_cast<Reader*>(h);
  if (r->fmt == 0) {
    int c = r->peek();
    if (c < 0) return 0;
    if (c != '>' && c != '@') return -1;
    r->fmt = c;
  }
  *is_fastq = r->fmt == '@' ? 1 : 0;
  long n = 0;
  long sw = 0, hw = 0;  // write cursors
  seq_offs[0] = 0;
  hdr_offs[0] = 0;
  // a record that outgrows a buffer is rewound to its header
  auto overflow = [&]() -> long {
    r->pos = r->mark;
    r->mark = kNoMark;
    return n > 0 ? n : -2;
  };
  while (n < max_rec) {
    int c = r->peek();
    if (c < 0) break;
    r->mark = r->pos;
    size_t len = 0;
    const uint8_t* l = r->line(&len);
    if (l == nullptr) break;
    if (l[0] != r->fmt) return -1;
    if (hw + static_cast<long>(len) - 1 > hdr_cap) return overflow();
    memcpy(hdr_buf + hw, l + 1, len - 1);
    hw += static_cast<long>(len) - 1;

    long seq_start = sw;
    if (r->fmt == '>') {
      for (;;) {
        int nx = r->peek();
        if (nx < 0 || nx == '>') break;
        l = r->line(&len);
        if (l == nullptr) break;
        if (sw + static_cast<long>(len) > seq_cap) return overflow();
        memcpy(seq_buf + sw, l, len);
        sw += static_cast<long>(len);
      }
    } else {
      l = r->line(&len);  // sequence line (single-line FASTQ)
      if (l == nullptr) return -1;
      if (sw + static_cast<long>(len) > seq_cap) return overflow();
      memcpy(seq_buf + sw, l, len);
      sw += static_cast<long>(len);
      long seq_len = sw - seq_offs[n];
      l = r->line(&len);  // '+'
      if (l == nullptr || l[0] != '+') return -1;
      l = r->line(&len);  // quality
      if (l == nullptr || static_cast<long>(len) != seq_len) return -1;
      memcpy(qual_buf + seq_offs[n], l, len);
    }
    ++n;
    seq_offs[n] = sw;
    hdr_offs[n] = hw;
    (void)seq_start;
  }
  r->mark = kNoMark;
  return n;
}

const char* ntpu_fastx_error(void* h) {
  auto* r = static_cast<Reader*>(h);
  return r->err.c_str();
}

// 2-bit base codes packed 16 per uint32 word (little-endian bit order:
// code j of word w covers draft position 16*w + j at bits [2j, 2j+2)):
// ACGT/acgt -> 0..3; every other byte is an "exception" — coded 0, its
// position appended to exc (capacity exc_cap).  Returns the total
// exception count (callers re-call with a larger buffer if it exceeds
// exc_cap).  need must be a multiple of 16; positions in [m, need) pad
// as code 0.  Single sequential pass — the numpy fallback in
// engine.flag._encode_packed needs ~5 memory passes for the same job.
long ntpu_encode_2bit(const uint8_t* seq, long m, long need,
                      uint32_t* packed, long* exc, long exc_cap) {
  static const auto tab = [] {
    std::array<uint8_t, 256> t{};
    t.fill(255);
    const char* b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      t[static_cast<uint8_t>(b[i])] = static_cast<uint8_t>(i);
      t[static_cast<uint8_t>(b[i] + 32)] = static_cast<uint8_t>(i);
    }
    return t;
  }();
  long nexc = 0;
  const long nw = need / 16;
  const long full = (m < need ? m : need) / 16;  // words with all 16 in-range
  for (long w = 0; w < full; ++w) {
    const uint8_t* p = seq + w * 16;
    uint32_t word = 0;
    for (int j = 0; j < 16; ++j) {
      uint8_t c = tab[p[j]];
      if (__builtin_expect(c == 255, 0)) {
        if (nexc < exc_cap) exc[nexc] = w * 16 + j;
        ++nexc;
        c = 0;
      }
      word |= static_cast<uint32_t>(c) << (2 * j);
    }
    packed[w] = word;
  }
  for (long w = full; w < nw; ++w) {  // tail: partial or padding words
    uint32_t word = 0;
    for (int j = 0; j < 16; ++j) {
      const long pos = w * 16 + j;
      if (pos >= m) break;
      uint8_t c = tab[seq[pos]];
      if (c == 255) {
        if (nexc < exc_cap) exc[nexc] = pos;
        ++nexc;
        c = 0;
      }
      word |= static_cast<uint32_t>(c) << (2 * j);
    }
    packed[w] = word;
  }
  return nexc;
}

}  // extern "C"
