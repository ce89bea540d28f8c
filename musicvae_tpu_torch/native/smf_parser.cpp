// Native SMF (Standard MIDI File) parser and corpus tensorizer, the port's
// copy of the JAX package's musicvae_tpu/native/smf_parser.cpp.
//
// Parses SMF bytes into int32 note triples, quantizes them to the step grid
// and rasterizes whole corpora into uint8 rolls, with several threads.
// Semantics are normative in musicvae_tpu/midi/SEMANTICS.md §1-§4 and MUST
// match musicvae_tpu_torch/midi/smf.py and midi/tensorize.py (the
// pure-Python path) exactly; tests/test_torch_tensorize.py holds the two
// paths and the JAX package's against each other.
//
// Build: musicvae_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC at
// first use). Exposed via ctypes: plain C ABI.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <functional>

namespace {

struct Note {
  int32_t start, end, pitch, vel;
};

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool ok = true;

  uint8_t u8() {
    if (pos >= n) { ok = false; return 0; }
    return p[pos++];
  }
  uint32_t u16() { uint32_t a = u8(), b = u8(); return (a << 8) | b; }
  uint32_t u32() { uint32_t a = u16(), b = u16(); return (a << 16) | b; }
  uint32_t varlen() {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      uint8_t b = u8();
      if (!ok) return 0;
      v = (v << 7) | (b & 0x7F);
      if (!(b & 0x80)) return v;
    }
    ok = false;  // varlen too long
    return 0;
  }
  void skip(size_t k) {
    if (pos + k > n) { ok = false; pos = n; } else pos += k;
  }
};

}  // namespace

extern "C" {

// ABI version stamp: bumped whenever any exported signature changes.
// The ctypes loader refuses (and rebuilds) a .so whose version differs —
// mtime comparison alone cannot catch a stale cached library whose
// source file carries an older archive mtime (wheel installs preserve
// them), and calling a new signature into old code corrupts memory.
int32_t mvae_abi_version() { return 2; }

// Error codes (negative) or number of notes written (>= 0).
//  -1 bad header / not SMF        -4 unknown status byte
//  -2 SMPTE division unsupported  -5 note overflow (> max_notes)
//  -3 truncated event             -6 unsupported format
//  -7 tick overflow (> INT32_MAX; midi/smf.py enforces the same limit so
//     the two parsers keep acceptance parity on extreme inputs)
//  -8 time signature mismatch (corpus functions under strict_timesig)
//
// out_timesig (nullable): [9] int32 — [0] = count of DISTINCT 0x58 time
// signatures across all tracks (0 = none declared ⇒ SMF default 4/4),
// then up to four (numerator, denominator) pairs in order of appearance.
// A denominator exponent > 15 is recorded as den = 0 (nonsensical meta;
// fails any strict check). Mirrors midi/smf.py MidiFile.time_signatures.
int32_t mvae_parse_smf(const uint8_t* data, int64_t len,
                       int32_t* out_notes /* [max_notes * 4]: s,e,pitch,vel */,
                       int32_t max_notes,
                       int32_t* out_tpq,
                       int32_t* out_tempo_us,
                       int32_t* out_timesig) {
  Reader r{data, static_cast<size_t>(len)};
  if (len < 14 || std::memcmp(data, "MThd", 4) != 0) return -1;
  r.pos = 4;
  uint32_t hlen = r.u32();
  uint32_t fmt = r.u16();
  uint32_t ntrks = r.u16();
  uint32_t division = r.u16();
  if (!r.ok || hlen < 6) return -1;
  if (division & 0x8000) return -2;
  if (division == 0) return -1;
  if (fmt > 1) return -6;
  r.pos = 8 + hlen;

  std::vector<Note> notes;
  notes.reserve(256);
  int32_t tempo = -1;
  int32_t ts_num[4], ts_den[4];
  int32_t n_ts = 0;  // distinct time signatures seen (stores first 4)

  for (uint32_t trk = 0; trk < ntrks; ++trk) {
    if (r.pos + 8 > r.n) break;  // tolerate fewer tracks than declared
    if (std::memcmp(data + r.pos, "MTrk", 4) != 0) return -1;
    r.pos += 4;
    uint32_t tlen = r.u32();
    size_t tend = r.pos + tlen;
    if (tend > r.n) return -3;
    // bound all event reads to the declared track extent: an event that
    // straddles tend is malformed (matches midi/smf.py, which parses a
    // hard slice of exactly tlen bytes)
    size_t file_end = r.n;
    r.n = tend;

    int64_t tick = 0, last_tick = 0;
    uint8_t running = 0;
    // FIFO of open (tick, vel) per pitch (SEMANTICS.md §1)
    std::vector<std::pair<int64_t, uint8_t>> open_fifo[128];

    while (r.pos < tend && r.ok) {
      tick += r.varlen();
      // a delta-time that ends exactly at the track boundary leaves no
      // status byte to read: malformed ("truncated event" in midi/smf.py).
      // Without this check the status read below is a buffer overread.
      if (!r.ok || r.pos >= tend) { r.ok = false; break; }
      if (tick > INT32_MAX) return -7;
      last_tick = tick;
      uint8_t status = data[r.pos];
      if (status & 0x80) {
        ++r.pos;
        if (status < 0xF0) running = status;
      } else {
        if (running == 0) return -3;
        status = running;
      }
      uint8_t kind = status & 0xF0;
      if (kind == 0x80 || kind == 0x90) {
        uint8_t pitch = r.u8(), vel = r.u8();
        // both data bytes must have the high bit clear (acceptance parity
        // with the Python parser's pitch+velocity checks)
        if (!r.ok || pitch > 127 || vel > 127) return -3;
        bool is_on = (kind == 0x90) && vel > 0;
        if (is_on) {
          open_fifo[pitch].emplace_back(tick, vel);
        } else if (!open_fifo[pitch].empty()) {
          auto [start, v] = open_fifo[pitch].front();
          open_fifo[pitch].erase(open_fifo[pitch].begin());
          if (tick > start)
            notes.push_back({static_cast<int32_t>(start),
                             static_cast<int32_t>(tick), pitch, v});
        }
      } else if (kind == 0xA0 || kind == 0xB0 || kind == 0xE0) {
        r.skip(2);
      } else if (kind == 0xC0 || kind == 0xD0) {
        r.skip(1);
      } else if (status == 0xFF) {
        uint8_t mt = r.u8();
        uint32_t mlen = r.varlen();
        if (!r.ok || r.pos + mlen > tend) return -3;
        if (mt == 0x51 && mlen == 3 && tempo < 0)
          tempo = (data[r.pos] << 16) | (data[r.pos + 1] << 8)
                  | data[r.pos + 2];
        if (mt == 0x58 && mlen >= 2) {
          int32_t num = data[r.pos];
          int32_t dd = data[r.pos + 1];
          int32_t den = dd <= 15 ? (1 << dd) : 0;
          bool seen = false;
          for (int32_t i = 0; i < n_ts && i < 4; ++i)
            if (ts_num[i] == num && ts_den[i] == den) { seen = true; break; }
          if (!seen) {
            if (n_ts < 4) { ts_num[n_ts] = num; ts_den[n_ts] = den; }
            ++n_ts;
          }
        }
        bool eot = (mt == 0x2F);
        r.skip(mlen);
        if (eot) break;
      } else if (status == 0xF0 || status == 0xF7) {
        uint32_t slen = r.varlen();
        r.skip(slen);
      } else {
        return -4;
      }
    }
    if (!r.ok) return -3;

    // close notes left open at end of track (§1)
    for (int pitch = 0; pitch < 128; ++pitch)
      for (auto& [start, v] : open_fifo[pitch])
        if (last_tick > start)
          notes.push_back({static_cast<int32_t>(start),
                           static_cast<int32_t>(last_tick),
                           pitch, v});
    r.n = file_end;
    r.pos = tend;
  }

  // stable: ties on (start, pitch, end) keep insertion order, matching the
  // Python codec's stable list.sort (velocity can differ between ties)
  std::stable_sort(notes.begin(), notes.end(),
                   [](const Note& a, const Note& b) {
    if (a.start != b.start) return a.start < b.start;
    if (a.pitch != b.pitch) return a.pitch < b.pitch;
    return a.end < b.end;
  });

  if (static_cast<int32_t>(notes.size()) > max_notes) return -5;
  for (size_t i = 0; i < notes.size(); ++i) {
    out_notes[i * 4 + 0] = notes[i].start;
    out_notes[i * 4 + 1] = notes[i].end;
    out_notes[i * 4 + 2] = notes[i].pitch;
    out_notes[i * 4 + 3] = notes[i].vel;
  }
  *out_tpq = static_cast<int32_t>(division);
  *out_tempo_us = tempo < 0 ? 500000 : tempo;
  if (out_timesig) {
    out_timesig[0] = n_ts;
    for (int32_t i = 0; i < 4; ++i) {
      out_timesig[1 + 2 * i] = i < n_ts ? ts_num[i] : 0;
      out_timesig[2 + 2 * i] = i < n_ts ? ts_den[i] : 0;
    }
  }
  return static_cast<int32_t>(notes.size());
}

// Quantize + pad a parsed note array into tensorizer events
// (SEMANTICS.md §2): step(t) = (2*t*spq + tpq) / (2*tpq) in exact integer
// arithmetic; end = max(end, start+1). Returns bar-padded total steps.
int32_t mvae_quantize_events(const int32_t* notes /* [n*4] */, int32_t n,
                             int32_t tpq, int32_t spq, int32_t steps_per_bar,
                             int32_t* out_events /* [max_events*3] */,
                             int32_t max_events) {
  if (n > max_events) return -5;
  int64_t max_off = 0;
  for (int32_t i = 0; i < n; ++i) {
    int64_t s = (2LL * notes[i * 4 + 0] * spq + tpq) / (2LL * tpq);
    int64_t e = (2LL * notes[i * 4 + 1] * spq + tpq) / (2LL * tpq);
    if (e < s + 1) e = s + 1;
    out_events[i * 3 + 0] = static_cast<int32_t>(s);
    out_events[i * 3 + 1] = static_cast<int32_t>(e);
    out_events[i * 3 + 2] = notes[i * 4 + 2];
    if (e > max_off) max_off = e;
  }
  for (int32_t i = n; i < max_events; ++i) {
    out_events[i * 3 + 0] = 0;
    out_events[i * 3 + 1] = 0;
    out_events[i * 3 + 2] = 0;
  }
  int64_t bars = (max_off + steps_per_bar - 1) / steps_per_bar;
  if (bars < 1) bars = 1;
  return static_cast<int32_t>(bars * steps_per_bar);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-corpus tensorization: parse + quantize + rasterize, multithreaded.
// The production data-loader path (musicvae_tpu/native/__init__.py
// tensorize_corpus): one native call turns a packed blob of SMF files into
// binary uint8 rolls, bar-padded per SEMANTICS.md §2–§4. Two-phase API so
// the caller allocates exact-size output:
//   phase 1: mvae_corpus_totals   → bar-padded steps per file
//   phase 2: mvae_corpus_rasterize → rolls written at caller offsets
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

namespace {

// Every recorded time signature must imply the config's bar length:
// spq * 4 * num == steps_per_bar * den (exact integer cross-multiply, so
// equivalent meters like 8/8 vs 4/4 pass). ts: the [9] out_timesig array.
// More than 4 distinct signatures (unverifiable tail) fails closed.
bool timesig_ok(const int32_t* ts, int32_t spq, int32_t steps_per_bar) {
  int32_t n = ts[0];
  if (n > 4) return false;
  for (int32_t i = 0; i < n; ++i) {
    int64_t num = ts[1 + 2 * i], den = ts[2 + 2 * i];
    if (num <= 0 || den <= 0) return false;
    if (static_cast<int64_t>(spq) * 4 * num
        != static_cast<int64_t>(steps_per_bar) * den) return false;
  }
  return true;
}

// Re-parse one file and rasterize into out (uint8 [total_steps, 128],
// caller-zeroed). Returns <0 on error, else 0.
int32_t rasterize_one(const uint8_t* data, int64_t len, int32_t spq,
                      int32_t steps_per_bar, int32_t max_notes,
                      int32_t strict_timesig,
                      uint8_t* out, int64_t total_steps) {
  std::vector<int32_t> notes(static_cast<size_t>(max_notes) * 4);
  int32_t tpq = 0, tempo = 0, ts[9];
  int32_t n = mvae_parse_smf(data, len, notes.data(), max_notes,
                             &tpq, &tempo, ts);
  if (n < 0) return n;
  if (strict_timesig && !timesig_ok(ts, spq, steps_per_bar)) return -8;
  for (int32_t i = 0; i < n; ++i) {
    int64_t s = (2LL * notes[i * 4 + 0] * spq + tpq) / (2LL * tpq);
    int64_t e = (2LL * notes[i * 4 + 1] * spq + tpq) / (2LL * tpq);
    if (e < s + 1) e = s + 1;
    if (s < 0) s = 0;
    if (e > total_steps) e = total_steps;
    int32_t pitch = notes[i * 4 + 2];
    for (int64_t t = s; t < e; ++t) out[t * 128 + pitch] = 1;
  }
  return 0;
}

void parallel_for(int32_t n, int32_t num_threads,
                  const std::function<void(int32_t)>& fn) {
  if (num_threads <= 1 || n <= 1) {
    for (int32_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int32_t> next{0};
  auto worker = [&] {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> threads;
  int32_t k = std::min(num_threads, n);
  threads.reserve(k);
  for (int32_t i = 0; i < k; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Phase 1: bar-padded total steps per file (>=1 bar each). Returns 0 or the
// first error code encountered (negative, see mvae_parse_smf).
int32_t mvae_corpus_totals(const uint8_t* blob, const int64_t* offsets,
                           int32_t n_files, int32_t spq,
                           int32_t steps_per_bar, int32_t max_notes,
                           int32_t num_threads, int32_t strict_timesig,
                           int64_t* totals_out) {
  std::atomic<int32_t> err{0};
  parallel_for(n_files, num_threads, [&](int32_t f) {
    std::vector<int32_t> notes(static_cast<size_t>(max_notes) * 4);
    int32_t tpq = 0, tempo = 0, ts[9];
    int32_t n = mvae_parse_smf(blob + offsets[f],
                               offsets[f + 1] - offsets[f],
                               notes.data(), max_notes, &tpq, &tempo, ts);
    if (n >= 0 && strict_timesig && !timesig_ok(ts, spq, steps_per_bar))
      n = -8;
    if (n < 0) {
      int32_t expected = 0;
      err.compare_exchange_strong(expected, n);
      totals_out[f] = 0;
      return;
    }
    int64_t max_off = 0;
    for (int32_t i = 0; i < n; ++i) {
      int64_t s = (2LL * notes[i * 4 + 0] * spq + tpq) / (2LL * tpq);
      int64_t e = (2LL * notes[i * 4 + 1] * spq + tpq) / (2LL * tpq);
      if (e < s + 1) e = s + 1;
      if (e > max_off) max_off = e;
    }
    int64_t bars = (max_off + steps_per_bar - 1) / steps_per_bar;
    if (bars < 1) bars = 1;
    totals_out[f] = bars * steps_per_bar;
  });
  return err.load();
}

// Phase 2: rasterize each file into rolls_out (uint8, caller-zeroed) at
// roll_offsets[f] * 128. Returns 0 or the first error code.
int32_t mvae_corpus_rasterize(const uint8_t* blob, const int64_t* offsets,
                              int32_t n_files, int32_t spq,
                              int32_t steps_per_bar, int32_t max_notes,
                              int32_t num_threads, int32_t strict_timesig,
                              const int64_t* roll_offsets,
                              uint8_t* rolls_out) {
  std::atomic<int32_t> err{0};
  parallel_for(n_files, num_threads, [&](int32_t f) {
    int64_t total = roll_offsets[f + 1] - roll_offsets[f];
    int32_t rc = rasterize_one(blob + offsets[f],
                               offsets[f + 1] - offsets[f],
                               spq, steps_per_bar, max_notes,
                               strict_timesig,
                               rolls_out + roll_offsets[f] * 128, total);
    if (rc < 0) {
      int32_t expected = 0;
      err.compare_exchange_strong(expected, rc);
    }
  });
  return err.load();
}

}  // extern "C"
