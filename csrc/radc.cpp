// Native helpers for the RAD codec.
//
// The record-boundary walk is the only sequential step in decoding a RAD
// chunk: each record is [num_aln:u32][read fields][num_aln x aln fields]
// so the offset of record i+1 depends on record i's num_aln.  Everything
// else in the decoder is vectorized host/NumPy or device/JAX work.
//
// Build: make -C csrc   (produces libradc.so, loaded via ctypes)

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <thread>
#include <utility>
#include <vector>

// splitmix64 mixer used by the open-addressing hash tables below.
static inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

extern "C" {

// Walk records across multiple chunk regions of `buf`.
// Returns total number of records walked, or -1 on overrun.
int64_t radc_walk_records(const uint8_t* buf, int64_t buf_len,
                          const int64_t* region_starts,
                          const int64_t* region_counts, int64_t n_regions,
                          int64_t read_bytes, int64_t aln_bytes,
                          int64_t* rec_starts_out, int64_t* num_aln_out) {
  int64_t i = 0;
  for (int64_t r = 0; r < n_regions; ++r) {
    int64_t off = region_starts[r];
    const int64_t count = region_counts[r];
    for (int64_t k = 0; k < count; ++k) {
      if (off + 4 > buf_len) return -1;
      uint32_t na;
      std::memcpy(&na, buf + off, 4);
      rec_starts_out[i] = off;
      num_aln_out[i] = static_cast<int64_t>(na);
      off += 4 + read_bytes + static_cast<int64_t>(na) * aln_bytes;
      if (off > buf_len) return -1;
      ++i;
    }
  }
  return i;
}

// Threaded record walk: chunk regions are independent (each region's
// record count is known up front), so region ranges split across
// threads with output offsets from a prefix sum of the counts.
extern "C" int64_t radc_walk_records_mt(
    const uint8_t* buf, int64_t buf_len, const int64_t* region_starts,
    const int64_t* region_counts, int64_t n_regions, int64_t read_bytes,
    int64_t aln_bytes, int64_t* rec_starts_out, int64_t* num_aln_out,
    int32_t n_threads) {
  std::vector<int64_t> out_off(static_cast<size_t>(n_regions) + 1, 0);
  for (int64_t r = 0; r < n_regions; ++r)
    out_off[r + 1] = out_off[r] + region_counts[r];
  const int64_t total = out_off[n_regions];
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n_regions < 2 || total < (1 << 16)) {
    return radc_walk_records(buf, buf_len, region_starts, region_counts,
                             n_regions, read_bytes, aln_bytes, rec_starts_out,
                             num_aln_out);
  }
  if (n_threads > n_regions) n_threads = static_cast<int32_t>(n_regions);
  std::vector<int64_t> errs(static_cast<size_t>(n_threads), 0);
  // balance by record count, not region count: split points are the
  // regions whose cumulative counts cross t/n_threads of the total
  std::vector<int64_t> bounds(static_cast<size_t>(n_threads) + 1, 0);
  bounds[n_threads] = n_regions;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t target = total * t / n_threads;
    bounds[t] = std::lower_bound(out_off.begin(), out_off.begin() + n_regions,
                                 target) -
                out_off.begin();
  }
  auto work = [&](int t) {
    const int64_t r0 = bounds[t], r1 = bounds[t + 1];
    if (r0 >= r1) return;
    errs[t] = radc_walk_records(
        buf, buf_len, region_starts + r0, region_counts + r0, r1 - r0,
        read_bytes, aln_bytes, rec_starts_out + out_off[r0],
        num_aln_out + out_off[r0]);
  };
  std::vector<std::thread> ts;
  ts.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) ts.emplace_back(work, t);
  work(0);
  for (auto& th : ts) th.join();
  for (int t = 0; t < n_threads; ++t)
    if (errs[t] < 0) return -1;
  return total;
}

// Extract all record fields in one pass.
//
// rec_starts/num_aln come from radc_walk_records.  read_widths has
// n_read_fields entries; aln_widths has n_aln_fields entries.  Outputs
// are dense u64 column arrays: read_cols[f][i] for record i, and
// aln_cols[f][j] for flat alignment j (alignments in record order).
int64_t radc_extract_fields(const uint8_t* buf, int64_t buf_len,
                            const int64_t* rec_starts, int64_t n_recs,
                            const int64_t* num_aln,
                            const int64_t* read_widths, int64_t n_read_fields,
                            const int64_t* aln_widths, int64_t n_aln_fields,
                            uint64_t** read_cols, uint64_t** aln_cols) {
  int64_t aln_idx = 0;
  for (int64_t i = 0; i < n_recs; ++i) {
    int64_t off = rec_starts[i] + 4;
    for (int64_t f = 0; f < n_read_fields; ++f) {
      uint64_t v = 0;
      const int64_t w = read_widths[f];
      if (off + w > buf_len) return -1;
      std::memcpy(&v, buf + off, w);
      read_cols[f][i] = v;
      off += w;
    }
    const int64_t na = num_aln[i];
    for (int64_t a = 0; a < na; ++a) {
      for (int64_t f = 0; f < n_aln_fields; ++f) {
        uint64_t v = 0;
        const int64_t w = aln_widths[f];
        if (off + w > buf_len) return -1;
        std::memcpy(&v, buf + off, w);
        aln_cols[f][aln_idx] = v;
        off += w;
      }
      ++aln_idx;
    }
  }
  return aln_idx;
}

// Encode records (inverse of extract): writes [num_aln u32][read
// fields][aln fields...] at the provided record starts.
int64_t radc_encode_records(uint8_t* buf, int64_t buf_len,
                            const int64_t* rec_starts, int64_t n_recs,
                            const int64_t* num_aln,
                            const int64_t* read_widths, int64_t n_read_fields,
                            const int64_t* aln_widths, int64_t n_aln_fields,
                            const uint64_t** read_cols,
                            const uint64_t** aln_cols) {
  int64_t aln_idx = 0;
  for (int64_t i = 0; i < n_recs; ++i) {
    int64_t off = rec_starts[i];
    const uint32_t na32 = static_cast<uint32_t>(num_aln[i]);
    if (off + 4 > buf_len) return -1;
    std::memcpy(buf + off, &na32, 4);
    off += 4;
    for (int64_t f = 0; f < n_read_fields; ++f) {
      const int64_t w = read_widths[f];
      if (off + w > buf_len) return -1;
      std::memcpy(buf + off, &read_cols[f][i], w);
      off += w;
    }
    const int64_t na = num_aln[i];
    for (int64_t a = 0; a < na; ++a) {
      for (int64_t f = 0; f < n_aln_fields; ++f) {
        const int64_t w = aln_widths[f];
        if (off + w > buf_len) return -1;
        std::memcpy(buf + off, &aln_cols[f][aln_idx], w);
        off += w;
      }
      ++aln_idx;
    }
  }
  return aln_idx;
}

// Per-record count of alignments surviving the orientation filter.
//
// The ref field of each alignment entry carries the orientation in bit
// 31 of its (little-endian) value (reference: MappedFragmentOrientation
// packing, libradicl; used by the collate orientation filter,
// src/collate.rs scatter path).  ori_mode: 1 = keep bit set (fw),
// 2 = keep bit clear (rc).  Returns total kept alignments, -1 on overrun.
int64_t radc_ori_counts(const uint8_t* buf, int64_t buf_len,
                        const int64_t* rec_starts, int64_t n_recs,
                        const int64_t* num_aln, int64_t read_bytes,
                        int64_t aln_bytes, int64_t ref_off,
                        int32_t ori_mode, int64_t* kept_out) {
  const uint32_t want = (ori_mode == 1) ? 1u : 0u;
  int64_t total = 0;
  for (int64_t i = 0; i < n_recs; ++i) {
    const int64_t na = num_aln[i];
    int64_t off = rec_starts[i] + 4 + read_bytes + ref_off;
    if (off + (na > 0 ? (na - 1) * aln_bytes + 4 : 0) > buf_len) return -1;
    int64_t kept = 0;
    for (int64_t a = 0; a < na; ++a) {
      uint32_t v;
      std::memcpy(&v, buf + off, 4);
      kept += ((v >> 31) == want);
      off += aln_bytes;
    }
    kept_out[i] = kept;
    total += kept;
  }
  return total;
}

// Byte-level collation emit: gather whole records in the given order,
// patch the corrected barcode in place, drop alignments failing the
// orientation filter, and frame the output into chunks (one per cell).
//
// order[n_out] indexes into rec_starts/num_aln/corrected_bc; records for
// one output chunk are consecutive in `order`, with chunk_counts[c]
// records in chunk c (zero-count chunks are skipped — no header).
// ori_mode: 0 = keep all alignments, 1 = keep fw, 2 = keep rc.
// Returns bytes written, or -1 on overrun.
int64_t radc_collate_emit(const uint8_t* buf, int64_t buf_len,
                          const int64_t* rec_starts, const int64_t* num_aln,
                          const uint64_t* corrected_bc, const int64_t* order,
                          int64_t n_out, int64_t read_bytes, int64_t aln_bytes,
                          int64_t bc_off, int64_t bc_width, int64_t ref_off,
                          int32_t ori_mode, const int64_t* chunk_counts,
                          int64_t n_chunks, uint8_t* out, int64_t out_cap) {
  const uint32_t want = (ori_mode == 1) ? 1u : 0u;
  int64_t p = 0;
  int64_t cursor = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t k = chunk_counts[c];
    if (k == 0) continue;
    const int64_t hdr_pos = p;
    if (p + 8 > out_cap) return -1;
    p += 8;
    for (int64_t r = 0; r < k; ++r) {
      if (cursor >= n_out) return -1;
      const int64_t i = order[cursor++];
      const int64_t src = rec_starts[i];
      const int64_t na = num_aln[i];
      if (src + 4 + read_bytes + na * aln_bytes > buf_len) return -1;
      if (ori_mode == 0) {
        const int64_t sz = 4 + read_bytes + na * aln_bytes;
        if (p + sz > out_cap) return -1;
        std::memcpy(out + p, buf + src, sz);
        std::memcpy(out + p + 4 + bc_off, &corrected_bc[i], bc_width);
        p += sz;
      } else {
        const int64_t na_pos = p;
        if (p + 4 + read_bytes > out_cap) return -1;
        p += 4;
        std::memcpy(out + p, buf + src + 4, read_bytes);
        std::memcpy(out + p + bc_off, &corrected_bc[i], bc_width);
        p += read_bytes;
        uint32_t kept = 0;
        int64_t aoff = src + 4 + read_bytes;
        for (int64_t a = 0; a < na; ++a) {
          uint32_t v;
          std::memcpy(&v, buf + aoff + ref_off, 4);
          if ((v >> 31) == want) {
            if (p + aln_bytes > out_cap) return -1;
            std::memcpy(out + p, buf + aoff, aln_bytes);
            p += aln_bytes;
            ++kept;
          }
          aoff += aln_bytes;
        }
        std::memcpy(out + na_pos, &kept, 4);
      }
    }
    const uint32_t nbytes = static_cast<uint32_t>(p - hdr_pos);
    const uint32_t nrec = static_cast<uint32_t>(k);
    std::memcpy(out + hdr_pos, &nbytes, 4);
    std::memcpy(out + hdr_pos + 4, &nrec, 4);
  }
  return p;
}

// Parallel byte-level collation emit.  Like radc_collate_emit, but the
// caller precomputes per-chunk record ranges (order_offsets) and output
// byte offsets (out_offsets, both n_chunks+1), making every chunk
// independent — threads split the chunk list by output bytes.
// Returns 0 on success, -1 on overrun/size mismatch.
int64_t radc_collate_emit2(const uint8_t* buf, int64_t buf_len,
                           const int64_t* rec_starts, const int64_t* num_aln,
                           const uint64_t* corrected_bc, const int64_t* order,
                           const int64_t* order_offsets,
                           const int64_t* out_offsets, int64_t n_chunks,
                           int64_t read_bytes, int64_t aln_bytes,
                           int64_t bc_off, int64_t bc_width, int64_t ref_off,
                           int32_t ori_mode, uint8_t* out, int64_t out_cap,
                           int32_t n_threads) {
  const uint32_t want = (ori_mode == 1) ? 1u : 0u;
  if (n_chunks > 0 && out_offsets[n_chunks] > out_cap) return -1;
  auto work = [&](int64_t c0, int64_t c1, int64_t* err) {
    for (int64_t c = c0; c < c1; ++c) {
      const int64_t k = order_offsets[c + 1] - order_offsets[c];
      if (k == 0) continue;
      int64_t p = out_offsets[c];
      const int64_t p_end = out_offsets[c + 1];
      const int64_t hdr_pos = p;
      p += 8;
      for (int64_t r = order_offsets[c]; r < order_offsets[c + 1]; ++r) {
        const int64_t i = order[r];
        const int64_t src = rec_starts[i];
        const int64_t na = num_aln[i];
        if (src + 4 + read_bytes + na * aln_bytes > buf_len || p > p_end) {
          *err = -1;
          return;
        }
        if (ori_mode == 0) {
          const int64_t sz = 4 + read_bytes + na * aln_bytes;
          if (p + sz > p_end) {
            *err = -1;
            return;
          }
          std::memcpy(out + p, buf + src, sz);
          std::memcpy(out + p + 4 + bc_off, &corrected_bc[i], bc_width);
          p += sz;
        } else {
          const int64_t na_pos = p;
          if (p + 4 + read_bytes > p_end) {
            *err = -1;
            return;
          }
          p += 4;
          std::memcpy(out + p, buf + src + 4, read_bytes);
          std::memcpy(out + p + bc_off, &corrected_bc[i], bc_width);
          p += read_bytes;
          uint32_t kept = 0;
          int64_t aoff = src + 4 + read_bytes;
          for (int64_t a = 0; a < na; ++a) {
            uint32_t v;
            std::memcpy(&v, buf + aoff + ref_off, 4);
            if ((v >> 31) == want) {
              if (p + aln_bytes > p_end) {
                *err = -1;
                return;
              }
              std::memcpy(out + p, buf + aoff, aln_bytes);
              p += aln_bytes;
              ++kept;
            }
            aoff += aln_bytes;
          }
          std::memcpy(out + na_pos, &kept, 4);
        }
      }
      if (p != p_end) {
        *err = -1;
        return;
      }
      const uint32_t nbytes = static_cast<uint32_t>(p - hdr_pos);
      const uint32_t nrec = static_cast<uint32_t>(k);
      std::memcpy(out + hdr_pos, &nbytes, 4);
      std::memcpy(out + hdr_pos + 4, &nrec, 4);
    }
  };
  if (n_threads < 1) n_threads = 1;
  std::vector<int64_t> errs(static_cast<size_t>(n_threads), 0);
  if (n_threads == 1 || n_chunks < 2) {
    work(0, n_chunks, &errs[0]);
  } else {
    const int64_t total = out_offsets[n_chunks] - out_offsets[0];
    std::vector<std::thread> ts;
    int64_t c_prev = 0;
    for (int t = 1; t < n_threads; ++t) {
      const int64_t target = out_offsets[0] + total * t / n_threads;
      int64_t c = c_prev;
      while (c < n_chunks && out_offsets[c] < target) ++c;
      ts.emplace_back(work, c_prev, c, &errs[t]);
      c_prev = c;
    }
    work(c_prev, n_chunks, &errs[0]);
    for (auto& th : ts) th.join();
  }
  for (int t = 0; t < n_threads; ++t)
    if (errs[static_cast<size_t>(t)] < 0) return -1;
  return 0;
}

// Parallel field extraction: like radc_extract_fields but with the
// per-record flat alignment offsets precomputed so record ranges are
// independent across threads.
int64_t radc_extract_fields2(const uint8_t* buf, int64_t buf_len,
                             const int64_t* rec_starts, int64_t n_recs,
                             const int64_t* num_aln, const int64_t* aln_offs,
                             const int64_t* read_widths, int64_t n_read_fields,
                             const int64_t* aln_widths, int64_t n_aln_fields,
                             uint64_t** read_cols, uint64_t** aln_cols,
                             int32_t n_threads) {
  // a null column pointer means "skip this field" (callers that don't
  // need a column avoid the memory traffic of materializing it)
  auto work = [&](int64_t i0, int64_t i1, int64_t* err) {
    for (int64_t i = i0; i < i1; ++i) {
      int64_t off = rec_starts[i] + 4;
      for (int64_t f = 0; f < n_read_fields; ++f) {
        const int64_t w = read_widths[f];
        if (off + w > buf_len) {
          *err = -1;
          return;
        }
        if (read_cols[f]) {
          uint64_t v = 0;
          std::memcpy(&v, buf + off, w);
          read_cols[f][i] = v;
        }
        off += w;
      }
      const int64_t na = num_aln[i];
      int64_t aln_idx = aln_offs[i];
      for (int64_t a = 0; a < na; ++a) {
        for (int64_t f = 0; f < n_aln_fields; ++f) {
          const int64_t w = aln_widths[f];
          if (off + w > buf_len) {
            *err = -1;
            return;
          }
          if (aln_cols[f]) {
            uint64_t v = 0;
            std::memcpy(&v, buf + off, w);
            aln_cols[f][aln_idx] = v;
          }
          off += w;
        }
        ++aln_idx;
      }
    }
  };
  if (n_threads < 1) n_threads = 1;
  std::vector<int64_t> errs(static_cast<size_t>(n_threads), 0);
  if (n_threads == 1 || n_recs < 2) {
    work(0, n_recs, &errs[0]);
  } else {
    std::vector<std::thread> ts;
    int64_t i_prev = 0;
    for (int t = 1; t < n_threads; ++t) {
      const int64_t i = n_recs * t / n_threads;
      ts.emplace_back(work, i_prev, i, &errs[t]);
      i_prev = i;
    }
    work(i_prev, n_recs, &errs[0]);
    for (auto& th : ts) th.join();
  }
  for (int t = 0; t < n_threads; ++t)
    if (errs[static_cast<size_t>(t)] < 0) return -1;
  return 0;
}

// Batched Hamming<=1 (substitution) neighbor search over 2-bit packed
// barcodes: for each query, count distinct members of the sorted
// `kept` array within Hamming distance <= 1 and report the smallest
// hit.  Mirrors BarcodeLookupMap::find_neighbors as used by the
// unfiltered-list rescue (src/cellfilter.rs:198-233).
void radc_find_neighbors(const uint64_t* queries, int64_t n_q,
                         const uint64_t* kept, int64_t n_k, int64_t bc_len,
                         int64_t* counts_out, uint64_t* rep_out) {
  // membership hash set over the kept barcodes (sentinel = all-ones;
  // a 32-base all-T barcode IS all-ones, so its membership is kept in
  // a flag beside the table)
  uint64_t cap = 16;
  while (cap < static_cast<uint64_t>(n_k) * 2) cap <<= 1;
  const uint64_t mask = cap - 1;
  const uint64_t kEmpty = ~0ull;
  std::vector<uint64_t> table(cap, kEmpty);
  bool has_all_ones = false;
  for (int64_t i = 0; i < n_k; ++i) {
    if (kept[i] == kEmpty) {
      has_all_ones = true;
      continue;
    }
    uint64_t h = mix64(kept[i]) & mask;
    while (table[h] != kEmpty && table[h] != kept[i]) h = (h + 1) & mask;
    table[h] = kept[i];
  }
  auto lookup = [&table, mask, kEmpty, has_all_ones](uint64_t v) -> bool {
    if (v == kEmpty) return has_all_ones;
    uint64_t h = mix64(v) & mask;
    uint64_t t;
    while ((t = table[h]) != kEmpty && t != v) h = (h + 1) & mask;
    return t == v;
  };
  auto work = [&](int64_t q0, int64_t q1) {
    for (int64_t qi = q0; qi < q1; ++qi) {
      const uint64_t q = queries[qi];
      int64_t count = 0;
      uint64_t rep = ~0ull;
      if (lookup(q)) {
        count = 1;
        rep = q;
      }
      for (int64_t pos = 0; pos < bc_len; ++pos) {
        const int shift = 2 * static_cast<int>(pos);
        const uint64_t cur = (q >> shift) & 3ull;
        const uint64_t cleared = q & ~(3ull << shift);
        for (uint64_t b = 0; b < 4; ++b) {
          if (b == cur) continue;
          const uint64_t v = cleared | (b << shift);
          if (lookup(v)) {
            ++count;
            if (v < rep) rep = v;
          }
        }
      }
      counts_out[qi] = count;
      rep_out[qi] = (count > 0) ? rep : 0ull;
    }
  };
  const unsigned hw = std::thread::hardware_concurrency();
  const int n_threads =
      (n_q > 8192 && hw > 1) ? static_cast<int>(hw > 8 ? 8 : hw) : 1;
  if (n_threads == 1) {
    work(0, n_q);
    return;
  }
  std::vector<std::thread> ts;
  int64_t prev = 0;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t q = n_q * t / n_threads;
    ts.emplace_back(work, prev, q);
    prev = q;
  }
  work(prev, n_q);
  for (auto& th : ts) th.join();
}

// Batched u64 map lookup via a transient open-addressing hash table
// (splitmix64 mixer, linear probing, load factor <= 0.5).  Replaces a
// per-query binary search: the collate hot path does one lookup per
// read against the barcode-correction map (reference: the DashMap /
// HashMap probes in src/collate.rs:700-710).
// hit_out[i] = 1 and val_out[i] = mapped value on hit, else 0/0.
// Returns the number of hits.
int64_t radc_lookup_u64(const uint64_t* keys, const uint64_t* vals,
                        int64_t n_map, const uint64_t* queries, int64_t n_q,
                        uint8_t* hit_out, uint64_t* val_out) {
  uint64_t cap = 16;
  while (cap < static_cast<uint64_t>(n_map) * 2) cap <<= 1;
  const uint64_t mask = cap - 1;
  // slot = index+1 into keys/vals; 0 = empty
  std::vector<uint32_t> slots(cap, 0u);
  for (int64_t i = 0; i < n_map; ++i) {
    uint64_t h = mix64(keys[i]) & mask;
    while (slots[h]) {
      if (keys[slots[h] - 1] == keys[i]) break;  // duplicate key: first wins
      h = (h + 1) & mask;
    }
    if (!slots[h]) slots[h] = static_cast<uint32_t>(i + 1);
  }
  int64_t hits = 0;
  for (int64_t i = 0; i < n_q; ++i) {
    const uint64_t q = queries[i];
    uint64_t h = mix64(q) & mask;
    uint32_t s;
    while ((s = slots[h]) != 0 && keys[s - 1] != q) h = (h + 1) & mask;
    if (s) {
      hit_out[i] = 1;
      val_out[i] = vals[s - 1];
      ++hits;
    } else {
      hit_out[i] = 0;
      val_out[i] = 0;
    }
  }
  return hits;
}

// Gather little-endian unsigned ints of `width` bytes at `starts` from
// a byte buffer (threaded).  Replaces a width-pass shift-or numpy loop.
int64_t radc_gather_uint(const uint8_t* buf, int64_t buf_len,
                         const int64_t* starts, int64_t n, int64_t width,
                         uint64_t* out, int32_t n_threads) {
  if (width > 8) return -1;
  auto work = [&](int64_t i0, int64_t i1, int64_t* err) {
    for (int64_t i = i0; i < i1; ++i) {
      const int64_t s = starts[i];
      if (s < 0 || s + width > buf_len) {
        *err = -1;
        return;
      }
      uint64_t v = 0;
      std::memcpy(&v, buf + s, width);
      out[i] = v;
    }
  };
  if (n_threads < 1) n_threads = 1;
  std::vector<int64_t> errs(static_cast<size_t>(n_threads), 0);
  if (n_threads == 1 || n < (1 << 16)) {
    work(0, n, &errs[0]);
  } else {
    std::vector<std::thread> ts;
    int64_t prev = 0;
    for (int t = 1; t < n_threads; ++t) {
      const int64_t i = n * t / n_threads;
      ts.emplace_back(work, prev, i, &errs[t]);
      prev = i;
    }
    work(prev, n, &errs[0]);
    for (auto& th : ts) th.join();
  }
  for (int t = 0; t < n_threads; ++t)
    if (errs[static_cast<size_t>(t)] < 0) return -1;
  return n;
}

// Sort u64 keys independently within each segment, threaded across
// segments.  The quant hot path produces keys whose high bits (the
// cell index) are already nondecreasing in collated-file order, so the
// global lexicographic sort the reference does per cell
// (pugutils.rs:663-671 sort of (umi, gene) triplets) degenerates into
// many small per-segment sorts — O(sum n_i log n_i) with tiny n_i.
void radc_sort_u64_segments(uint64_t* keys, const int64_t* seg_offsets,
                            int64_t n_segs, int32_t n_threads) {
  if (n_segs <= 0) return;
  if (n_threads < 1) n_threads = 1;
  auto work = [keys, seg_offsets](int64_t s0, int64_t s1) {
    for (int64_t s = s0; s < s1; ++s) {
      uint64_t* a = keys + seg_offsets[s];
      const int64_t n = seg_offsets[s + 1] - seg_offsets[s];
      // tiny segments dominate (1-2 alignments per read): branch fast
      if (n <= 1) continue;
      if (n == 2) {
        if (a[0] > a[1]) std::swap(a[0], a[1]);
        continue;
      }
      if (n <= 24) {  // insertion sort beats introsort at this size
        for (int64_t i = 1; i < n; ++i) {
          const uint64_t v = a[i];
          int64_t j = i - 1;
          while (j >= 0 && a[j] > v) {
            a[j + 1] = a[j];
            --j;
          }
          a[j + 1] = v;
        }
        continue;
      }
      std::sort(a, a + n);
    }
  };
  if (n_threads == 1 || n_segs < 2) {
    work(0, n_segs);
    return;
  }
  // split segments so each thread gets about equal total elements
  const int64_t total = seg_offsets[n_segs] - seg_offsets[0];
  std::vector<std::thread> ts;
  int64_t s_prev = 0;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t target = seg_offsets[0] + total * t / n_threads;
    int64_t s = s_prev;
    while (s < n_segs && seg_offsets[s] < target) ++s;
    ts.emplace_back(work, s_prev, s);
    s_prev = s;
  }
  work(s_prev, n_segs);
  for (auto& th : ts) th.join();
}

// Fused segmented sort + run-length encode.  Threads take contiguous
// segment ranges; each sorts its segments in place and writes the
// (unique key, run length) pairs compacted to the start of its range's
// region of uniq_out/cnt_out.  range_starts_out[t] / range_counts_out[t]
// tell the caller where each thread's compacted output lives (it glues
// <= n_threads slices).  Replaces sort -> compare -> flatnonzero ->
// diff chains over multi-million-row arrays.
void radc_sort_rle_u64_segments(uint64_t* keys, const int64_t* seg_offsets,
                                int64_t n_segs, uint64_t* uniq_out,
                                int64_t* cnt_out, int64_t* range_starts_out,
                                int64_t* range_counts_out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t s0, int64_t s1, int t) {
    const int64_t base = (s0 < n_segs) ? seg_offsets[s0] : 0;
    int64_t w = base;
    for (int64_t s = s0; s < s1; ++s) {
      uint64_t* a = keys + seg_offsets[s];
      const int64_t n = seg_offsets[s + 1] - seg_offsets[s];
      if (n <= 0) continue;
      if (n == 2) {
        if (a[0] > a[1]) std::swap(a[0], a[1]);
      } else if (n <= 24) {
        for (int64_t i = 1; i < n; ++i) {
          const uint64_t v = a[i];
          int64_t j = i - 1;
          while (j >= 0 && a[j] > v) {
            a[j + 1] = a[j];
            --j;
          }
          a[j + 1] = v;
        }
      } else if (n > 2) {
        std::sort(a, a + n);
      }
      uint64_t cur = a[0];
      int64_t run = 1;
      for (int64_t i = 1; i < n; ++i) {
        if (a[i] == cur) {
          ++run;
        } else {
          uniq_out[w] = cur;
          cnt_out[w] = run;
          ++w;
          cur = a[i];
          run = 1;
        }
      }
      uniq_out[w] = cur;
      cnt_out[w] = run;
      ++w;
    }
    range_starts_out[t] = base;
    range_counts_out[t] = w - base;
  };
  if (n_threads == 1 || n_segs < 2) {
    work(0, n_segs, 0);
    for (int t = 1; t < n_threads; ++t) {
      range_starts_out[t] = 0;
      range_counts_out[t] = 0;
    }
    return;
  }
  const int64_t total = seg_offsets[n_segs] - seg_offsets[0];
  std::vector<std::thread> ts;
  std::vector<std::pair<int64_t, int64_t>> ranges;
  int64_t s_prev = 0;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t target = seg_offsets[0] + total * t / n_threads;
    int64_t s = s_prev;
    while (s < n_segs && seg_offsets[s] < target) ++s;
    ranges.emplace_back(s_prev, s);
    s_prev = s;
  }
  ranges.emplace_back(s_prev, n_segs);
  for (size_t t = 1; t < ranges.size(); ++t)
    ts.emplace_back(work, ranges[t].first, ranges[t].second,
                    static_cast<int>(t));
  work(ranges[0].first, ranges[0].second, 0);
  for (auto& th : ts) th.join();
}

// Global lexicographic sort + run-length encode + column unpack of
// rows packed into TWO u64 words (the ATAC (chr, start, frag_len,
// barcode) row layout, atac/sort.rs:45-62 ordering).  Sorts (w0, w1)
// pairs (halved + merged across 2 threads past 64k rows), then one
// RLE pass emits each distinct row's unpacked int64 columns — column
// c of row r lands at out_cols[c * n + r] — and its multiplicity.
// Returns the distinct-row count.  Replaces an np.lexsort + compare +
// flatnonzero + per-column shift/mask chain over megarow arrays (the
// measured bulk of the ATAC sort/dedup host stages).
int64_t radc_sort2_rle_unpack(const uint64_t* w0, const uint64_t* w1,
                              int64_t n, const int32_t* word_idx,
                              const int32_t* shifts, const int32_t* widths,
                              int32_t n_cols, int64_t* out_cols,
                              int64_t* cnt_out, int32_t n_threads) {
  if (n <= 0) return 0;
  std::vector<std::pair<uint64_t, uint64_t>> v(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) v[static_cast<size_t>(i)] = {w0[i], w1[i]};
  if (n_threads >= 2 && n > (1 << 16)) {
    const int64_t mid = n / 2;
    std::thread th([&] { std::sort(v.begin(), v.begin() + mid); });
    std::sort(v.begin() + mid, v.end());
    th.join();
    std::inplace_merge(v.begin(), v.begin() + mid, v.end());
  } else {
    std::sort(v.begin(), v.end());
  }
  int64_t w = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (i > 0 && v[static_cast<size_t>(i)] == v[static_cast<size_t>(i - 1)]) {
      ++cnt_out[w];
      continue;
    }
    ++w;
    cnt_out[w] = 1;
    for (int32_t c = 0; c < n_cols; ++c) {
      const uint64_t word = word_idx[c] == 0 ? v[static_cast<size_t>(i)].first
                                             : v[static_cast<size_t>(i)].second;
      const uint64_t m =
          widths[c] >= 64 ? ~0ULL : ((1ULL << widths[c]) - 1ULL);
      out_cols[static_cast<int64_t>(c) * n + w] =
          static_cast<int64_t>((word >> shifts[c]) & m);
    }
  }
  return w + 1;
}

// Hash-based distinct counting of u64 keys (open addressing, linear
// probing).  Returns the number of distinct keys; uniq_out/cnt_out
// receive them in table order (caller sorts the small result).
// cap_hint sizes the table (pass an upper bound on distinct keys, e.g.
// n).  Replaces sort-based np.unique on the barcode histogram path
// (reference: DashMap barcode histogramming, cellfilter.rs:1283-1420).
int64_t radc_count_u64(const uint64_t* keys, int64_t n, int64_t cap_hint,
                       uint64_t* uniq_out, uint64_t* cnt_out) {
  uint64_t cap = 16;
  while (cap < static_cast<uint64_t>(cap_hint) * 2) cap <<= 1;
  const uint64_t mask = cap - 1;
  std::vector<uint64_t> tkey(cap);
  std::vector<uint64_t> tcnt(cap, 0);
  std::vector<uint8_t> used(cap, 0);
  int64_t n_distinct = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t k = keys[i];
    uint64_t h = mix64(k) & mask;
    while (used[h] && tkey[h] != k) h = (h + 1) & mask;
    if (!used[h]) {
      used[h] = 1;
      tkey[h] = k;
      ++n_distinct;
    }
    ++tcnt[h];
  }
  int64_t j = 0;
  for (uint64_t h = 0; h < cap; ++h) {
    if (used[h]) {
      uniq_out[j] = tkey[h];
      cnt_out[j] = tcnt[h];
      ++j;
    }
  }
  return j;
}

// Full cr-like winner-take-all resolution with the non-USA
// gene-unique rule, one threaded pass (reference semantics:
// resolve_num_molecules_crlike_from_vec, src/pugutils.rs:644-749, with
// the unique-tie-set counting rule of src/quant.rs:541-589).
//
// Per cell (reads [cell_read_offsets[c], cell_read_offsets[c+1])):
// project each read's alignments to genes and dedup within the read,
// aggregate (umi, gene) multiplicities, take per-umi argmax tie sets,
// and count +1 at (cell, gene) for every singleton tie set.  Cells are
// independent, so threads take contiguous cell ranges and write
// compacted (cell*n_rows+gene, count) pairs at their range's input
// read offset; range_starts/range_counts (n_threads each) tell the
// caller where each thread's slice lives.
//
// gbits must satisfy (max umi) < 2^(64-gbits); caller checks.
//
// usa_mode == 0: non-USA gene-unique rule (singleton tie sets count).
// usa_mode == 1: USA slotting of the tie set (utils.rs:656-739 /
// quant.rs:541-589): the gene id space interleaves spliced (even) /
// unspliced (odd) ids; a resolved UMI lands in the spliced block
// (g>>1), the unspliced block (+unspliced_off) or the ambiguous block
// (+ambig_off) — len-1 direct, len-2 same-gene -> ambiguous else the
// single spliced gene, len 3..10 single-spliced rule, len > 10 drop.
void radc_crlike_wta_unique(
    const int64_t* cell_ids, const int64_t* cell_read_offsets,
    int64_t n_cells, const int64_t* aln_offsets, const uint32_t* refs,
    const uint64_t* umi, const uint32_t* tid_to_gid, int64_t n_rows,
    int64_t gbits, int32_t usa_mode, int64_t unspliced_off,
    int64_t ambig_off, uint64_t* out_key, int64_t* out_cnt,
    int64_t* range_starts, int64_t* range_counts, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  const uint64_t gmask = (gbits >= 64) ? ~0ull : ((1ull << gbits) - 1);
  auto work = [&](int64_t c0, int64_t c1, int t) {
    const int64_t base = (c0 < n_cells) ? cell_read_offsets[c0] : 0;
    int64_t w = base;
    std::vector<uint64_t> pairs;
    std::vector<uint32_t> winners;  // resolved slot per UMI
    std::vector<uint32_t> genes;
    std::vector<uint32_t> tie;
    for (int64_t c = c0; c < c1; ++c) {
      const int64_t r0 = cell_read_offsets[c];
      const int64_t r1 = cell_read_offsets[c + 1];
      pairs.clear();
      winners.clear();
      for (int64_t r = r0; r < r1; ++r) {
        genes.clear();
        for (int64_t a = aln_offsets[r]; a < aln_offsets[r + 1]; ++a) {
          const uint32_t g = tid_to_gid[refs[a]];
          bool seen = false;
          for (uint32_t gg : genes)
            if (gg == g) {
              seen = true;
              break;
            }
          if (!seen) genes.push_back(g);
        }
        const uint64_t u = umi[r] << gbits;
        for (uint32_t g : genes) pairs.push_back(u | g);
      }
      std::sort(pairs.begin(), pairs.end());
      const int64_t n = static_cast<int64_t>(pairs.size());
      int64_t i = 0;
      while (i < n) {
        const uint64_t ucur = pairs[i] >> gbits;
        int64_t best = 0;
        tie.clear();
        int64_t j = i;
        while (j < n && (pairs[j] >> gbits) == ucur) {
          int64_t k = j;
          while (k < n && pairs[k] == pairs[j]) ++k;
          const int64_t cnt = k - j;
          const uint32_t g = static_cast<uint32_t>(pairs[j] & gmask);
          if (cnt > best) {
            best = cnt;
            tie.clear();
            tie.push_back(g);
          } else if (cnt == best) {
            tie.push_back(g);
          }
          j = k;
        }
        if (!usa_mode) {
          if (tie.size() == 1) winners.push_back(tie[0]);
        } else {
          // tie is ascending (pairs sorted); apply the USA rules
          const size_t L = tie.size();
          if (L == 1) {
            const uint32_t g = tie[0];
            winners.push_back(
                (g & 1) ? static_cast<uint32_t>(unspliced_off + (g >> 1))
                        : (g >> 1));
          } else if (L == 2) {
            const uint32_t g1 = tie[0], g2 = tie[1];
            const bool sp1 = (g1 & 1) == 0, sp2 = (g2 & 1) == 0;
            if ((g1 & ~1u) == (g2 & ~1u)) {
              winners.push_back(static_cast<uint32_t>(ambig_off + (g1 >> 1)));
            } else if (sp1 && !sp2) {
              winners.push_back(g1 >> 1);
            } else if (!sp1 && sp2) {
              winners.push_back(g2 >> 1);
            }  // else dropped
          } else if (L <= 10) {
            // single-spliced rule
            uint32_t sgene = 0;
            int nspl = 0;
            for (uint32_t g : tie)
              if ((g & 1) == 0) {
                sgene = g;
                ++nspl;
              }
            if (nspl == 1) {
              bool partner = false;
              for (uint32_t g : tie)
                if ((g & 1) && (g & ~1u) == (sgene & ~1u)) partner = true;
              winners.push_back(
                  partner ? static_cast<uint32_t>(ambig_off + (sgene >> 1))
                          : (sgene >> 1));
            }
          }  // L > 10: dropped
        }
        i = j;
      }
      std::sort(winners.begin(), winners.end());
      const uint64_t cell_base =
          static_cast<uint64_t>(cell_ids[c]) * static_cast<uint64_t>(n_rows);
      size_t wi = 0;
      while (wi < winners.size()) {
        size_t wj = wi;
        while (wj < winners.size() && winners[wj] == winners[wi]) ++wj;
        out_key[w] = cell_base + winners[wi];
        out_cnt[w] = static_cast<int64_t>(wj - wi);
        ++w;
        wi = wj;
      }
    }
    range_starts[t] = base;
    range_counts[t] = w - base;
  };
  if (n_threads == 1 || n_cells < 2) {
    work(0, n_cells, 0);
    for (int t = 1; t < n_threads; ++t) {
      range_starts[t] = 0;
      range_counts[t] = 0;
    }
    return;
  }
  const int64_t total_reads = cell_read_offsets[n_cells] - cell_read_offsets[0];
  std::vector<std::thread> ts;
  std::vector<std::pair<int64_t, int64_t>> ranges;
  int64_t c_prev = 0;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t target =
        cell_read_offsets[0] + total_reads * t / n_threads;
    int64_t c = c_prev;
    while (c < n_cells && cell_read_offsets[c] < target) ++c;
    ranges.emplace_back(c_prev, c);
    c_prev = c;
  }
  ranges.emplace_back(c_prev, n_cells);
  for (size_t t = 1; t < ranges.size(); ++t)
    ts.emplace_back(work, ranges[t].first, ranges[t].second,
                    static_cast<int>(t));
  work(ranges[0].first, ranges[0].second, 0);
  for (auto& th : ts) th.join();
}

// Format integer COO triplets as "r c v\n" lines (MatrixMarket body).
// out must have room for n * 62 bytes; returns bytes written.
int64_t radc_format_triplets(const int64_t* rows, const int64_t* cols,
                             const int64_t* vals, int64_t n, char* out) {
  char* p = out;
  auto emit = [&p](int64_t v) {
    char tmp[20];
    int k = 0;
    if (v < 0) {
      *p++ = '-';
      v = -v;
    }
    do {
      tmp[k++] = static_cast<char>('0' + (v % 10));
      v /= 10;
    } while (v);
    while (k) *p++ = tmp[--k];
  };
  for (int64_t i = 0; i < n; ++i) {
    emit(rows[i]);
    *p++ = ' ';
    emit(cols[i]);
    *p++ = ' ';
    emit(vals[i]);
    *p++ = '\n';
  }
  return p - out;
}

// Emit one f32 the way Rust's `Display` does — shortest round-trip
// decimal digits (std::to_chars shortest == Ryu, the algorithm Rust
// uses), rendered positionally (never scientific), NaN/inf spelled
// Rust-style.  Advances p; needs up to 63 bytes.
static void radc_emit_f32(char*& p, float v) {
  char tmp[48];
  {
    if (std::isnan(v)) {
      std::memcpy(p, "NaN", 3);
      p += 3;
    } else if (std::isinf(v)) {
      if (v < 0) *p++ = '-';
      std::memcpy(p, "inf", 3);
      p += 3;
    } else {
      float a = v;
      if (std::signbit(v)) {
        *p++ = '-';
        a = -v;
      }
      auto res = std::to_chars(tmp, tmp + sizeof(tmp), a,
                               std::chars_format::scientific);
      // parse "d[.ddd]e±xx" -> digits + decimal exponent of d0
      const char* q = tmp;
      char digits[24];
      int nd = 0;
      digits[nd++] = *q++;
      if (*q == '.') {
        ++q;
        while (q < res.ptr && *q != 'e') digits[nd++] = *q++;
      }
      int exp = 0, esign = 1;
      if (q < res.ptr && *q == 'e') {
        ++q;
        if (*q == '-') {
          esign = -1;
          ++q;
        } else if (*q == '+') {
          ++q;
        }
        while (q < res.ptr) exp = exp * 10 + (*q++ - '0');
        exp *= esign;
      }
      if (exp >= nd - 1) {
        // integral: all digits then zero padding
        std::memcpy(p, digits, nd);
        p += nd;
        for (int z = nd - 1; z < exp; ++z) *p++ = '0';
      } else if (exp >= 0) {
        std::memcpy(p, digits, exp + 1);
        p += exp + 1;
        *p++ = '.';
        std::memcpy(p, digits + exp + 1, nd - exp - 1);
        p += nd - exp - 1;
      } else {
        *p++ = '0';
        *p++ = '.';
        for (int z = 0; z < -exp - 1; ++z) *p++ = '0';
        std::memcpy(p, digits, nd);
        p += nd;
      }
    }
  }
}

int64_t radc_format_f32(const float* vals, int64_t n, char* out) {
  char* p = out;
  for (int64_t i = 0; i < n; ++i) {
    radc_emit_f32(p, vals[i]);
    *p++ = '\n';
  }
  return p - out;
}

// Format COO triplets with FLOAT values as "r c v\n" MatrixMarket
// body lines, matching the Python fallback byte-for-byte: a value
// that is exactly an int64 prints as an integer, anything else prints
// Rust-Display-f32 (shortest round-trip, positional).  out needs
// n * 105 bytes; returns bytes written.
int64_t radc_format_triplets_f32(const int64_t* rows, const int64_t* cols,
                                 const float* vals, int64_t n, char* out) {
  char* p = out;
  auto emit_i = [&p](int64_t v) {
    char tmp[20];
    int k = 0;
    if (v < 0) {
      *p++ = '-';
      v = -v;
    }
    do {
      tmp[k++] = static_cast<char>('0' + (v % 10));
      v /= 10;
    } while (v);
    while (k) *p++ = tmp[--k];
  };
  for (int64_t i = 0; i < n; ++i) {
    emit_i(rows[i]);
    *p++ = ' ';
    emit_i(cols[i]);
    *p++ = ' ';
    const float v = vals[i];
    const int64_t iv = static_cast<int64_t>(v);
    if (std::isfinite(v) && v > -9.2e18f && v < 9.2e18f &&
        v == static_cast<float>(iv)) {
      emit_i(iv);
    } else {
      radc_emit_f32(p, v);
    }
    *p++ = '\n';
  }
  return p - out;
}

// Scan the RAD header's ref-name region: `count` names, each
// [len:u16][utf8 bytes], starting at buf[0].  Fills starts_out
// (count+1 entries: starts_out[i] = byte offset of name i's utf8
// payload; starts_out[count] = end_of_region + 2 so that
// len_i = starts_out[i+1] - starts_out[i] - 2 holds for every i).
// Returns the total byte length of the region, or -1 if the buffer
// ends mid-region (caller should read more bytes and retry).
int64_t radc_scan_names(const uint8_t* buf, int64_t buf_len, int64_t count,
                        int64_t* starts_out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < count; ++i) {
    if (pos + 2 > buf_len) return -1;
    uint16_t nlen;
    std::memcpy(&nlen, buf + pos, 2);
    starts_out[i] = pos + 2;
    pos += 2 + static_cast<int64_t>(nlen);
    if (pos > buf_len) return -1;
  }
  starts_out[count] = pos + 2;
  return pos;
}

// Stable counting sort of small-domain keys: fills order[] with indices
// of keys grouped by key value (ascending), preserving input order
// within a key, and counts[] with per-key occupancy.  O(n + n_keys) —
// replaces the O(n log n) argsort on collate's cell-rank column.
void radc_counting_sort(const int64_t* keys, int64_t n, int64_t n_keys,
                        int64_t* order, int64_t* counts) {
  for (int64_t k = 0; k < n_keys; ++k) counts[k] = 0;
  for (int64_t i = 0; i < n; ++i) ++counts[keys[i]];
  std::vector<int64_t> pos(static_cast<size_t>(n_keys));
  int64_t acc = 0;
  for (int64_t k = 0; k < n_keys; ++k) {
    pos[static_cast<size_t>(k)] = acc;
    acc += counts[k];
  }
  for (int64_t i = 0; i < n; ++i) order[pos[static_cast<size_t>(keys[i])]++] = i;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parsimonious UMI graph (PUG) resolution, whole-batch, threaded over cells.
//
// Semantics mirror ops/pug.py (itself a re-implementation of the
// reference's pugutils.rs:65-1331) EXACTLY, including adjacency
// insertion order and the visited-marking rule of the BFS (a neighbor
// is marked visited even when the transcript-membership test fails),
// because both affect which cover is found:
//   * per cell, eqclasses keyed by the verbatim refs slice
//     (transcript level) or the sorted unique gene projection (gene
//     level); per class, UMIs sorted + RLE'd into (umi, freq) nodes;
//   * edges: within a class all UMI pairs at Hamming<=1 (2-bit packed),
//     across classes sharing >=1 transcript; direction freq(x) >
//     2*freq(y)-1 (pugutils.rs:76-99); exact mode keeps only d==0;
//   * union-find components; singleton shortcut; components larger
//     than large_graph_thresh take the streaming cr-like fallback;
//   * greedy cover: repeatedly pick the largest monochromatic
//     arborescence over uncovered vertices (ascending vertex id,
//     first-strictly-larger wins), intersect covered labels, project
//     to genes, bump the per-cell gene-eqclass count.
//
// Output: per cell, eqclasses ordered by (label length, label bytes);
// counts/label lens compacted at the cell's read offset, labels at the
// cell's alignment offset (both are proven upper bounds).
namespace pugk {

static inline int hamming2bit(uint64_t a, uint64_t b) {
  uint64_t x = a ^ b;
  uint64_t two = (x | (x >> 1)) & 0x5555555555555555ull;
  const int pc = __builtin_popcountll(two);
  return pc > 2 ? 2 : pc;
}

struct CellOut {
  std::vector<int64_t> counts;
  std::vector<int64_t> lens;
  std::vector<uint32_t> labels;
  int64_t n_eqc = 0;
  int used_alt = 0;
};

struct LabelKeyLess {
  bool operator()(const std::vector<uint32_t>& a,
                  const std::vector<uint32_t>& b) const {
    if (a.size() != b.size()) return a.size() < b.size();
    const int c = std::memcmp(a.data(), b.data(), a.size() * 4);
    return c < 0;
  }
};

// Per-cell eqclass/node tables (stages 1-2 of the resolver): classes
// keyed by the refs slice / gene projection, per-class sorted UMI RLE
// nodes, node -> class mapping.
struct Tables {
  std::vector<std::vector<uint32_t>> eq_sorted;  // per class: sorted label
  std::vector<std::vector<uint64_t>> eq_u;       // per class: distinct UMIs
  std::vector<std::vector<int64_t>> eq_c;        // per class: UMI freqs
  std::vector<int64_t> node_base;                // class -> first node id
  std::vector<int32_t> node_eq;                  // node -> class
  int64_t nec = 0;
  int64_t nv = 0;
};

static void build_tables(const uint64_t* umi, const uint32_t* refs,
                         const int64_t* aln_offsets, int64_t r0, int64_t r1,
                         const uint32_t* tid_to_gid, int gene_level,
                         Tables& T) {
  const int64_t n_reads = r1 - r0;
  std::vector<std::vector<uint32_t>> eq_key;  // identity key
  std::vector<std::vector<uint64_t>> eq_umis_raw;
  {
    uint64_t cap = 16;
    while (cap < static_cast<uint64_t>(n_reads) * 2) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int32_t> slot(cap, -1);
    std::vector<uint32_t> keybuf;
    for (int64_t r = r0; r < r1; ++r) {
      keybuf.clear();
      if (gene_level) {
        for (int64_t a = aln_offsets[r]; a < aln_offsets[r + 1]; ++a)
          keybuf.push_back(tid_to_gid[refs[a]]);
        std::sort(keybuf.begin(), keybuf.end());
        keybuf.erase(std::unique(keybuf.begin(), keybuf.end()), keybuf.end());
      } else {
        for (int64_t a = aln_offsets[r]; a < aln_offsets[r + 1]; ++a)
          keybuf.push_back(refs[a]);
      }
      uint64_t h = 1469598103934665603ull;
      for (uint32_t v : keybuf) h = (h ^ v) * 1099511628211ull;
      h = mix64(h ^ (uint64_t)keybuf.size()) & mask;
      int32_t e = -1;
      while (slot[h] >= 0) {
        const auto& k = eq_key[static_cast<size_t>(slot[h])];
        if (k.size() == keybuf.size() &&
            std::memcmp(k.data(), keybuf.data(), k.size() * 4) == 0) {
          e = slot[h];
          break;
        }
        h = (h + 1) & mask;
      }
      if (e < 0) {
        e = static_cast<int32_t>(eq_key.size());
        slot[h] = e;
        eq_key.push_back(keybuf);
        auto sorted = keybuf;
        if (!gene_level) {
          std::sort(sorted.begin(), sorted.end());
          sorted.erase(std::unique(sorted.begin(), sorted.end()),
                       sorted.end());
        }
        T.eq_sorted.push_back(std::move(sorted));
        eq_umis_raw.emplace_back();
      }
      eq_umis_raw[static_cast<size_t>(e)].push_back(umi[r]);
    }
  }
  T.nec = static_cast<int64_t>(eq_key.size());
  T.eq_u.resize(static_cast<size_t>(T.nec));
  T.eq_c.resize(static_cast<size_t>(T.nec));
  T.node_base.assign(static_cast<size_t>(T.nec) + 1, 0);
  for (int64_t e = 0; e < T.nec; ++e) {
    auto& raw = eq_umis_raw[static_cast<size_t>(e)];
    std::sort(raw.begin(), raw.end());
    auto& us = T.eq_u[static_cast<size_t>(e)];
    auto& cs = T.eq_c[static_cast<size_t>(e)];
    for (size_t i = 0; i < raw.size();) {
      size_t j = i;
      while (j < raw.size() && raw[j] == raw[i]) ++j;
      us.push_back(raw[i]);
      cs.push_back(static_cast<int64_t>(j - i));
      i = j;
    }
    T.node_base[e + 1] = T.node_base[e] + static_cast<int64_t>(us.size());
  }
  T.nv = T.node_base[static_cast<size_t>(T.nec)];
  T.node_eq.resize(static_cast<size_t>(T.nv));
  for (int64_t e = 0; e < T.nec; ++e)
    for (int64_t v = T.node_base[e]; v < T.node_base[e + 1]; ++v)
      T.node_eq[static_cast<size_t>(v)] = static_cast<int32_t>(e);
}

// Stage 3-4: inverted transcript index + edges (adjacency insertion
// order matches ops/pug.py).
static void build_adj(const Tables& T, int exact,
                      std::vector<std::vector<int32_t>>& adj) {
  const int64_t nec = T.nec;
  const int64_t nv = T.nv;
  std::vector<std::vector<int32_t>> inv_lists;
  uint64_t icap = 16;
  {
    int64_t tot = 0;
    for (auto& s : T.eq_sorted) tot += static_cast<int64_t>(s.size());
    while (icap < static_cast<uint64_t>(tot) * 2 + 2) icap <<= 1;
  }
  const uint64_t imask = icap - 1;
  std::vector<uint32_t> ikey(icap, 0xFFFFFFFFu);
  std::vector<int32_t> ival(icap, -1);
  auto inv_find = [&](uint32_t t) -> int32_t {
    uint64_t h = mix64(t) & imask;
    while (ival[h] >= 0 && ikey[h] != t) h = (h + 1) & imask;
    return (ival[h] >= 0) ? ival[h] : -1;
  };
  for (int64_t e = 0; e < nec; ++e) {
    for (uint32_t t : T.eq_sorted[static_cast<size_t>(e)]) {
      uint64_t h = mix64(t) & imask;
      while (ival[h] >= 0 && ikey[h] != t) h = (h + 1) & imask;
      if (ival[h] < 0) {
        ikey[h] = t;
        ival[h] = static_cast<int32_t>(inv_lists.size());
        inv_lists.emplace_back();
      }
      inv_lists[static_cast<size_t>(ival[h])].push_back(
          static_cast<int32_t>(e));
    }
  }

  adj.assign(static_cast<size_t>(nv), {});
  auto add_pair = [&](int64_t x, int64_t y, int d, int64_t cx, int64_t cy) {
    if (exact) {
      if (d != 0) return;
      adj[static_cast<size_t>(x)].push_back(static_cast<int32_t>(y));
      adj[static_cast<size_t>(y)].push_back(static_cast<int32_t>(x));
      return;
    }
    if (d == 0) {
      adj[static_cast<size_t>(x)].push_back(static_cast<int32_t>(y));
      adj[static_cast<size_t>(y)].push_back(static_cast<int32_t>(x));
    } else if (d == 1) {
      if (cx > 2 * cy - 1) {
        adj[static_cast<size_t>(x)].push_back(static_cast<int32_t>(y));
      } else if (cy > 2 * cx - 1) {
        adj[static_cast<size_t>(y)].push_back(static_cast<int32_t>(x));
      } else {
        adj[static_cast<size_t>(x)].push_back(static_cast<int32_t>(y));
        adj[static_cast<size_t>(y)].push_back(static_cast<int32_t>(x));
      }
    }
  };
  std::vector<uint8_t> seen(static_cast<size_t>(nec), 0);
  std::vector<int32_t> seen_touched;
  for (int64_t e = 0; e < nec; ++e) {
    const auto& ux = T.eq_u[static_cast<size_t>(e)];
    const auto& cx = T.eq_c[static_cast<size_t>(e)];
    const int64_t bx = T.node_base[e];
    for (size_t i = 0; i + 1 < ux.size(); ++i)
      for (size_t j = i + 1; j < ux.size(); ++j)
        add_pair(bx + static_cast<int64_t>(i), bx + static_cast<int64_t>(j),
                 hamming2bit(ux[i], ux[j]), cx[i], cx[j]);
    seen_touched.clear();
    for (uint32_t t : T.eq_sorted[static_cast<size_t>(e)]) {
      const int32_t li = inv_find(t);
      if (li < 0) continue;
      for (int32_t e2 : inv_lists[static_cast<size_t>(li)]) {
        if (e2 <= e || seen[static_cast<size_t>(e2)]) continue;
        seen[static_cast<size_t>(e2)] = 1;
        seen_touched.push_back(e2);
        const auto& uy = T.eq_u[static_cast<size_t>(e2)];
        const auto& cy = T.eq_c[static_cast<size_t>(e2)];
        const int64_t by = T.node_base[e2];
        for (size_t i = 0; i < ux.size(); ++i)
          for (size_t j = 0; j < uy.size(); ++j) {
            const int d = hamming2bit(ux[i], uy[j]);
            if (d <= (exact ? 0 : 1))
              add_pair(bx + static_cast<int64_t>(i),
                       by + static_cast<int64_t>(j), d, cx[i], cy[j]);
          }
      }
    }
    for (int32_t e2 : seen_touched) seen[static_cast<size_t>(e2)] = 0;
  }
}

// Stage 6-7: resolve each component (greedy monochromatic-arborescence
// cover; components larger than large_thresh fall back to streaming
// cr-like), emit gene eqclasses in (label length, bytes) order.
static void resolve_components(const Tables& T,
                               const std::vector<std::vector<int32_t>>& adj,
                               const std::vector<std::vector<int32_t>>& comps,
                               int64_t large_thresh,
                               const uint32_t* tid_to_gid, int gene_level,
                               CellOut& out) {
  const int64_t nv = T.nv;
  std::map<std::vector<uint32_t>, int64_t, LabelKeyLess> gene_eqc;
  auto project = [&](const std::vector<uint32_t>& lab,
                     std::vector<uint32_t>& out_genes) {
    out_genes.clear();
    if (gene_level) {
      out_genes = lab;
      return;
    }
    for (uint32_t t : lab) out_genes.push_back(tid_to_gid[t]);
    std::sort(out_genes.begin(), out_genes.end());
    out_genes.erase(std::unique(out_genes.begin(), out_genes.end()),
                    out_genes.end());
  };
  std::vector<uint32_t> genes_buf;
  std::vector<int32_t> visited_stamp(static_cast<size_t>(nv), -1);
  int32_t stamp = 0;
  std::vector<int32_t> bfs_q;
  std::vector<uint8_t> covered(static_cast<size_t>(nv), 0);

  for (auto& comp : comps) {
    if (comp.size() == 1) {
      const int32_t tv = comp[0];
      const auto& tl = T.eq_sorted[static_cast<size_t>(T.node_eq[tv])];
      project(tl, genes_buf);
      ++gene_eqc[genes_buf];
      continue;
    }
    if (static_cast<int64_t>(comp.size()) > large_thresh) {
      out.used_alt = 1;
      std::vector<std::pair<uint64_t, std::pair<uint32_t, int64_t>>> trips;
      std::vector<uint32_t> gset;
      for (int32_t vtx : comp) {
        const int32_t e = T.node_eq[static_cast<size_t>(vtx)];
        const int64_t rank = vtx - T.node_base[e];
        const uint64_t u = T.eq_u[static_cast<size_t>(e)][(size_t)rank];
        const int64_t c = T.eq_c[static_cast<size_t>(e)][(size_t)rank];
        project(T.eq_sorted[static_cast<size_t>(e)], gset);
        for (uint32_t g : gset) trips.push_back({u, {g, c}});
      }
      std::sort(trips.begin(), trips.end(),
                [](const auto& a, const auto& b) {
                  if (a.first != b.first) return a.first < b.first;
                  if (a.second.first != b.second.first)
                    return a.second.first < b.second.first;
                  return a.second.second < b.second.second;
                });
      uint64_t curr_umi = 0;
      uint32_t curr_gn = 0;
      int64_t max_count = 0, count_aggr = 0;
      std::vector<uint32_t> best;
      bool first = true;
      auto commit = [&]() { ++gene_eqc[best]; };
      for (size_t idx = 0; idx < trips.size(); ++idx) {
        const uint64_t u = trips[idx].first;
        const uint32_t g = trips[idx].second.first;
        const int64_t c = trips[idx].second.second;
        if (first) {
          curr_umi = u;
          curr_gn = g;
          count_aggr = max_count = c;
          best.assign(1, g);
          first = false;
        } else if (u != curr_umi) {
          commit();
          curr_umi = u;
          curr_gn = g;
          best.assign(1, g);
          count_aggr = max_count = c;
        } else {
          if (g == curr_gn) {
            count_aggr += c;
          } else {
            count_aggr = c;
            curr_gn = g;
          }
          if (count_aggr > max_count) {
            max_count = count_aggr;
            if (!(best.size() == 1 && best[0] == g)) best.assign(1, g);
          } else if (count_aggr == max_count) {
            best.push_back(g);
          }
        }
        if (idx + 1 == trips.size()) commit();
      }
      continue;
    }
    int64_t n_uncovered = static_cast<int64_t>(comp.size());
    for (int32_t v : comp) covered[static_cast<size_t>(v)] = 0;
    std::vector<int32_t> best_mcc, cand;
    while (n_uncovered > 0) {
      best_mcc.clear();
      for (int32_t v : comp) {
        if (covered[static_cast<size_t>(v)]) continue;
        const auto& vlab =
            T.eq_sorted[static_cast<size_t>(T.node_eq[(size_t)v])];
        bool saturated = false;
        for (uint32_t t : vlab) {
          ++stamp;
          visited_stamp[static_cast<size_t>(v)] = stamp;
          cand.clear();
          bfs_q.clear();
          bfs_q.push_back(v);
          size_t qh = 0;
          while (qh < bfs_q.size()) {
            const int32_t cv = bfs_q[qh++];
            cand.push_back(cv);
            for (int32_t nxt : adj[static_cast<size_t>(cv)]) {
              if (covered[static_cast<size_t>(nxt)] ||
                  visited_stamp[static_cast<size_t>(nxt)] == stamp)
                continue;
              visited_stamp[static_cast<size_t>(nxt)] = stamp;
              const auto& lab =
                  T.eq_sorted[static_cast<size_t>(T.node_eq[(size_t)nxt])];
              if (std::binary_search(lab.begin(), lab.end(), t))
                bfs_q.push_back(nxt);
            }
          }
          if (cand.size() > best_mcc.size()) best_mcc = cand;
          if (static_cast<int64_t>(cand.size()) == n_uncovered) {
            saturated = true;
            break;
          }
        }
        if (saturated) break;
      }
      const auto& lab0 =
          T.eq_sorted[static_cast<size_t>(T.node_eq[(size_t)best_mcc[0]])];
      std::vector<uint32_t> inter(lab0.begin(), lab0.end());
      inter.erase(std::unique(inter.begin(), inter.end()), inter.end());
      std::vector<uint32_t> tmp;
      for (size_t i = 1; i < best_mcc.size() && !inter.empty(); ++i) {
        const auto& lab =
            T.eq_sorted[static_cast<size_t>(T.node_eq[(size_t)best_mcc[i]])];
        tmp.clear();
        for (uint32_t t : inter)
          if (std::binary_search(lab.begin(), lab.end(), t))
            tmp.push_back(t);
        inter.swap(tmp);
      }
      project(inter, genes_buf);
      ++gene_eqc[genes_buf];
      for (int32_t vtx : best_mcc) {
        covered[static_cast<size_t>(vtx)] = 1;
        --n_uncovered;
      }
    }
  }

  out.n_eqc = static_cast<int64_t>(gene_eqc.size());
  for (auto& kv : gene_eqc) {
    out.counts.push_back(kv.second);
    out.lens.push_back(static_cast<int64_t>(kv.first.size()));
    out.labels.insert(out.labels.end(), kv.first.begin(), kv.first.end());
  }
}

// Group component members from per-node component labels (any
// canonical label works; grouping is by first occurrence in ascending
// vertex order, matching the union-find grouping below).
static void comps_from_labels(const int32_t* labels, int64_t nv,
                              std::vector<std::vector<int32_t>>& comps) {
  comps.clear();
  std::vector<int32_t> comp_of_label(static_cast<size_t>(nv), -1);
  for (int64_t v = 0; v < nv; ++v) {
    const int32_t l = labels[v];
    if (comp_of_label[static_cast<size_t>(l)] < 0) {
      comp_of_label[static_cast<size_t>(l)] =
          static_cast<int32_t>(comps.size());
      comps.emplace_back();
    }
    comps[static_cast<size_t>(comp_of_label[static_cast<size_t>(l)])]
        .push_back(static_cast<int32_t>(v));
  }
}

static void resolve_cell(
    const uint64_t* umi, const uint32_t* refs, const int64_t* aln_offsets,
    int64_t r0, int64_t r1, const uint32_t* tid_to_gid, int gene_level,
    int exact, int64_t large_thresh, CellOut& out) {
  Tables T;
  build_tables(umi, refs, aln_offsets, r0, r1, tid_to_gid, gene_level, T);
  std::vector<std::vector<int32_t>> adj;
  build_adj(T, exact, adj);

  // --- 5. connected components (union-find) -------------------------------
  const int64_t nv = T.nv;
  std::vector<int32_t> parent(static_cast<size_t>(nv));
  for (int64_t v = 0; v < nv; ++v) parent[static_cast<size_t>(v)] = (int32_t)v;
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (parent[static_cast<size_t>(x)] != x) {
      parent[static_cast<size_t>(x)] =
          parent[static_cast<size_t>(parent[static_cast<size_t>(x)])];
      x = parent[static_cast<size_t>(x)];
    }
    return x;
  };
  for (int64_t a = 0; a < nv; ++a)
    for (int32_t b : adj[static_cast<size_t>(a)]) {
      const int32_t ra = find(static_cast<int32_t>(a)), rb = find(b);
      if (ra != rb) parent[static_cast<size_t>(rb)] = ra;
    }
  std::vector<int32_t> root_of(static_cast<size_t>(nv));
  for (int64_t v = 0; v < nv; ++v)
    root_of[static_cast<size_t>(v)] = find(static_cast<int32_t>(v));
  std::vector<std::vector<int32_t>> comps;
  comps_from_labels(root_of.data(), nv, comps);

  resolve_components(T, adj, comps, large_thresh, tid_to_gid, gene_level, out);
}

}  // namespace pugk

// Batch PUG resolution over cells.  Outputs are compacted per thread
// range: counts/lens at the range's read offset, labels at the range's
// alignment offset, n_eqc_per_cell / used_alt per cell (exact).
// range_* arrays are (n_threads, 4): [cell0, read_base, label_base,
// n_eq_written]; labels_written goes to label_counts.
extern "C" int64_t radc_pug_resolve(
    const int64_t* cell_read_offsets, int64_t n_cells,
    const uint64_t* umi, const uint32_t* refs, const int64_t* aln_offsets,
    const uint32_t* tid_to_gid, int32_t gene_level, int32_t exact,
    int64_t large_thresh,
    int64_t* n_eqc_per_cell, uint8_t* used_alt_per_cell,
    int64_t* counts_out, int64_t* lens_out, uint32_t* labels_out,
    int64_t* range_info, int64_t* label_counts, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t c0, int64_t c1, int t) {
    const int64_t read_base = (c0 < n_cells) ? cell_read_offsets[c0] : 0;
    const int64_t label_base = (c0 < n_cells) ? aln_offsets[read_base] : 0;
    int64_t w = read_base;
    int64_t lw = label_base;
    pugk::CellOut out;
    for (int64_t c = c0; c < c1; ++c) {
      out.counts.clear();
      out.lens.clear();
      out.labels.clear();
      out.n_eqc = 0;
      out.used_alt = 0;
      pugk::resolve_cell(umi, refs, aln_offsets, cell_read_offsets[c],
                         cell_read_offsets[c + 1], tid_to_gid, gene_level,
                         exact, large_thresh, out);
      n_eqc_per_cell[c] = out.n_eqc;
      used_alt_per_cell[c] = static_cast<uint8_t>(out.used_alt);
      std::memcpy(counts_out + w, out.counts.data(), out.counts.size() * 8);
      std::memcpy(lens_out + w, out.lens.data(), out.lens.size() * 8);
      std::memcpy(labels_out + lw, out.labels.data(), out.labels.size() * 4);
      w += static_cast<int64_t>(out.counts.size());
      lw += static_cast<int64_t>(out.labels.size());
    }
    range_info[t * 4 + 0] = c0;
    range_info[t * 4 + 1] = read_base;
    range_info[t * 4 + 2] = label_base;
    range_info[t * 4 + 3] = w - read_base;
    label_counts[t] = lw - label_base;
  };
  if (n_threads == 1 || n_cells < 2) {
    work(0, n_cells, 0);
    for (int t = 1; t < n_threads; ++t) {
      range_info[t * 4 + 0] = n_cells;
      range_info[t * 4 + 1] = 0;
      range_info[t * 4 + 2] = 0;
      range_info[t * 4 + 3] = 0;
      label_counts[t] = 0;
    }
    return 0;
  }
  const int64_t total = cell_read_offsets[n_cells] - cell_read_offsets[0];
  std::vector<std::thread> ts;
  std::vector<std::pair<int64_t, int64_t>> ranges;
  int64_t c_prev = 0;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t target = cell_read_offsets[0] + total * t / n_threads;
    int64_t c = c_prev;
    while (c < n_cells && cell_read_offsets[c] < target) ++c;
    ranges.emplace_back(c_prev, c);
    c_prev = c;
  }
  ranges.emplace_back(c_prev, n_cells);
  for (size_t t = 1; t < ranges.size(); ++t)
    ts.emplace_back(work, ranges[t].first, ranges[t].second,
                    static_cast<int>(t));
  work(ranges[0].first, ranges[0].second, 0);
  for (auto& th : ts) th.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Snappy block codec + CRC32C (for the snappy framing format used by
// `collate --compress`; spec: google/snappy format_description.txt).
// ---------------------------------------------------------------------------

namespace {

// CRC-32C (Castagnoli), slice-by-8.
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    const uint32_t poly = 0x82f63b78u;
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint8_t* emit_literal(uint8_t* dst, const uint8_t* src, int64_t len) {
  const int64_t n = len - 1;
  if (n < 60) {
    *dst++ = static_cast<uint8_t>(n << 2);
  } else if (n < (1 << 8)) {
    *dst++ = 60 << 2;
    *dst++ = static_cast<uint8_t>(n);
  } else if (n < (1 << 16)) {
    *dst++ = 61 << 2;
    *dst++ = static_cast<uint8_t>(n);
    *dst++ = static_cast<uint8_t>(n >> 8);
  } else if (n < (1 << 24)) {
    *dst++ = 62 << 2;
    *dst++ = static_cast<uint8_t>(n);
    *dst++ = static_cast<uint8_t>(n >> 8);
    *dst++ = static_cast<uint8_t>(n >> 16);
  } else {
    *dst++ = 63 << 2;
    std::memcpy(dst, &n, 4);
    dst += 4;
  }
  std::memcpy(dst, src, static_cast<size_t>(len));
  return dst + len;
}

inline uint8_t* emit_copy2(uint8_t* dst, int64_t offset, int64_t len) {
  *dst++ = static_cast<uint8_t>(((len - 1) << 2) | 2);
  *dst++ = static_cast<uint8_t>(offset);
  *dst++ = static_cast<uint8_t>(offset >> 8);
  return dst;
}

inline uint8_t* emit_copy(uint8_t* dst, int64_t offset, int64_t len) {
  while (len >= 68) {
    dst = emit_copy2(dst, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    dst = emit_copy2(dst, offset, 60);
    len -= 60;
  }
  if (len < 12 && offset < 2048) {
    *dst++ = static_cast<uint8_t>(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
    *dst++ = static_cast<uint8_t>(offset);
    return dst;
  }
  return emit_copy2(dst, offset, len);
}

}  // namespace

extern "C" uint32_t radc_crc32c(const uint8_t* p, int64_t n, uint32_t init) {
  static const Crc32cTables tbl;
  uint32_t crc = init ^ 0xffffffffu;
  while (n >= 8) {
    crc ^= load32(p);
    const uint32_t hi = load32(p + 4);
    crc = tbl.t[7][crc & 0xff] ^ tbl.t[6][(crc >> 8) & 0xff] ^
          tbl.t[5][(crc >> 16) & 0xff] ^ tbl.t[4][crc >> 24] ^
          tbl.t[3][hi & 0xff] ^ tbl.t[2][(hi >> 8) & 0xff] ^
          tbl.t[1][(hi >> 16) & 0xff] ^ tbl.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ tbl.t[0][(crc ^ *p++) & 0xff];
  return crc ^ 0xffffffffu;
}

// Greedy hash-table match finder over one block (callers frame <=64KiB
// chunks).  dst must hold >= radc_snappy_max_compressed(n) bytes.
// Returns bytes written.
extern "C" int64_t radc_snappy_max_compressed(int64_t n) {
  return 32 + n + n / 6;
}

extern "C" int64_t radc_snappy_compress(const uint8_t* src, int64_t n,
                                        uint8_t* dst) {
  uint8_t* d = dst;
  // varint uncompressed length
  uint64_t v = static_cast<uint64_t>(n);
  while (v >= 0x80) {
    *d++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *d++ = static_cast<uint8_t>(v);
  if (n == 0) return d - dst;
  if (n < 16) return emit_literal(d, src, n) - dst;

  constexpr int kHashBits = 14;
  uint16_t table[1 << kHashBits] = {0};
  auto hash = [&](uint32_t x) -> uint32_t {
    return (x * 0x1e35a7bdu) >> (32 - kHashBits);
  };

  const int64_t limit = n - 4;  // last position a 4-byte match can start
  int64_t ip = 0;               // next position to examine
  int64_t lit_start = 0;        // start of pending literal run
  while (ip < limit) {
    // skip ahead faster through incompressible regions (snappy's 1/32
    // per-miss acceleration)
    uint32_t skip = 32;
    int64_t cand = -1;
    int64_t pos = ip;
    while (true) {
      if (pos > limit) {
        pos = -1;
        break;
      }
      const uint32_t cur = load32(src + pos);
      const uint32_t h = hash(cur);
      cand = table[h];
      table[h] = static_cast<uint16_t>(pos);
      if (cand < pos && load32(src + cand) == cur) break;
      pos += (skip++ >> 5);
    }
    if (pos < 0) break;
    // emit pending literal
    if (pos > lit_start) d = emit_literal(d, src + lit_start, pos - lit_start);
    // extend the match
    int64_t mlen = 4;
    while (pos + mlen + 8 <= n) {
      const uint64_t x = load64(src + cand + mlen) ^ load64(src + pos + mlen);
      if (x) {
        mlen += __builtin_ctzll(x) >> 3;
        goto matched;
      }
      mlen += 8;
    }
    while (pos + mlen < n && src[cand + mlen] == src[pos + mlen]) ++mlen;
  matched:
    d = emit_copy(d, pos - cand, mlen);
    ip = pos + mlen;
    lit_start = ip;
    if (ip < limit) {
      // re-prime the table at the end of the match
      table[hash(load32(src + ip - 1))] = static_cast<uint16_t>(ip - 1);
    }
  }
  if (lit_start < n) d = emit_literal(d, src + lit_start, n - lit_start);
  return d - dst;
}

// Decode one snappy block.  Returns bytes written, or -1 on malformed
// input / dst overflow.
extern "C" int64_t radc_snappy_uncompress(const uint8_t* src, int64_t n,
                                          uint8_t* dst, int64_t dst_cap) {
  int64_t pos = 0;
  // varint uncompressed length (validated against dst_cap)
  uint64_t ulen = 0;
  int shift = 0;
  while (true) {
    if (pos >= n || shift > 63) return -1;
    const uint8_t b = src[pos++];
    ulen |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (static_cast<int64_t>(ulen) > dst_cap) return -1;
  int64_t o = 0;
  while (pos < n) {
    const uint8_t tag = src[pos++];
    const int kind = tag & 3;
    if (kind == 0) {
      int64_t len = tag >> 2;
      if (len >= 60) {
        const int nb = static_cast<int>(len) - 59;
        if (pos + nb > n) return -1;
        len = 0;
        std::memcpy(&len, src + pos, nb);
        pos += nb;
      }
      ++len;
      if (pos + len > n || o + len > dst_cap) return -1;
      std::memcpy(dst + o, src + pos, static_cast<size_t>(len));
      pos += len;
      o += len;
    } else {
      int64_t len, off;
      if (kind == 1) {
        if (pos + 1 > n) return -1;
        len = ((tag >> 2) & 0x7) + 4;
        off = (static_cast<int64_t>(tag >> 5) << 8) | src[pos];
        pos += 1;
      } else if (kind == 2) {
        if (pos + 2 > n) return -1;
        len = (tag >> 2) + 1;
        off = src[pos] | (static_cast<int64_t>(src[pos + 1]) << 8);
        pos += 2;
      } else {
        if (pos + 4 > n) return -1;
        len = (tag >> 2) + 1;
        uint32_t o32;
        std::memcpy(&o32, src + pos, 4);
        off = o32;
        pos += 4;
      }
      if (off <= 0 || off > o || o + len > dst_cap) return -1;
      if (off >= len) {
        std::memcpy(dst + o, dst + o - off, static_cast<size_t>(len));
      } else {
        for (int64_t k = 0; k < len; ++k) dst[o + k] = dst[o - off + k];
      }
      o += len;
    }
  }
  return o;
}

// Format BED rows: "<chr>\t<start>\t<end>\t<barcode>\t<count>\n".
// name_bytes/name_offs hold the concatenated reference names; bcs are
// 2-bit packed (first base in the high bits, A=0 C=1 G=2 T=3).
// Returns bytes written (caller sizes `out` for the worst case).
extern "C" int64_t radc_format_bed(
    const uint8_t* name_bytes, const int64_t* name_offs,
    const int64_t* chrs, const int64_t* starts, const int64_t* ends,
    const uint64_t* bcs, int64_t bc_len,
    const int64_t* counts, int64_t n,
    uint8_t* out, int32_t n_threads) {
  static const char kBases[4] = {'A', 'C', 'G', 'T'};
  auto render = [&](int64_t lo, int64_t hi, uint8_t* dst) -> int64_t {
    uint8_t* p = dst;
    auto emit = [&p](int64_t v) {
      char tmp[20];
      int k = 0;
      do {
        tmp[k++] = static_cast<char>('0' + (v % 10));
        v /= 10;
      } while (v);
      while (k) *p++ = static_cast<uint8_t>(tmp[--k]);
    };
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t c = chrs[i];
      const int64_t nb = name_offs[c + 1] - name_offs[c];
      std::memcpy(p, name_bytes + name_offs[c], static_cast<size_t>(nb));
      p += nb;
      *p++ = '\t';
      emit(starts[i]);
      *p++ = '\t';
      emit(ends[i]);
      *p++ = '\t';
      const uint64_t bc = bcs[i];
      for (int64_t k = bc_len - 1; k >= 0; --k)
        *p++ = static_cast<uint8_t>(kBases[(bc >> (2 * k)) & 3]);
      *p++ = '\t';
      emit(counts[i]);
      *p++ = '\n';
    }
    return p - dst;
  };
  if (n_threads <= 1 || n < (1 << 16)) return render(0, n, out);
  // parallel render into slabs, then compact
  const int nt = std::min<int64_t>(n_threads, 16);
  std::vector<int64_t> lo(nt + 1);
  for (int t = 0; t <= nt; ++t) lo[t] = n * t / nt;
  // worst-case bytes per row for slab sizing
  int64_t max_name = 0;
  int64_t nrefs = 0;
  for (int64_t i = 0; i < n; ++i) nrefs = std::max(nrefs, chrs[i] + 1);
  for (int64_t c = 0; c < nrefs; ++c)
    max_name = std::max(max_name, name_offs[c + 1] - name_offs[c]);
  const int64_t per_row = max_name + bc_len + 3 * 20 + 5;
  std::vector<std::vector<uint8_t>> slabs(nt);
  std::vector<int64_t> written(nt);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    slabs[t].resize(static_cast<size_t>((lo[t + 1] - lo[t]) * per_row));
    ts.emplace_back([&, t] { written[t] = render(lo[t], lo[t + 1], slabs[t].data()); });
  }
  for (auto& th : ts) th.join();
  uint8_t* p = out;
  for (int t = 0; t < nt; ++t) {
    std::memcpy(p, slabs[t].data(), static_cast<size_t>(written[t]));
    p += written[t];
  }
  return p - out;
}

// Intern variable-length u64 label sets in first-encounter order.
// ids_out[i] = global id of set i; rep_out[g] = index of the first set
// with id g.  Returns the number of unique sets.
extern "C" int64_t radc_intern_label_sets(const uint64_t* labels,
                                          const int64_t* offs, int64_t n_sets,
                                          int64_t* ids_out, int64_t* rep_out) {
  int64_t cap = 64;
  while (cap < n_sets * 2) cap <<= 1;
  std::vector<int64_t> slot(cap, -1);  // -> global id
  std::vector<int64_t> rep;            // global id -> representative set
  rep.reserve(n_sets);
  const int64_t mask = cap - 1;
  for (int64_t i = 0; i < n_sets; ++i) {
    const int64_t s = offs[i], e = offs[i + 1];
    uint64_t h = 0x243f6a8885a308d3ull;
    for (int64_t j = s; j < e; ++j) h = mix64(h ^ labels[j]);
    int64_t p = static_cast<int64_t>(h) & mask;
    int64_t id = -1;
    while (true) {
      const int64_t g = slot[p];
      if (g < 0) break;
      const int64_t rs = offs[rep[g]], re = offs[rep[g] + 1];
      if (re - rs == e - s &&
          std::memcmp(labels + rs, labels + s,
                      static_cast<size_t>(e - s) * 8) == 0) {
        id = g;
        break;
      }
      p = (p + 1) & mask;
    }
    if (id < 0) {
      id = static_cast<int64_t>(rep.size());
      rep.push_back(i);
      slot[p] = id;
    }
    ids_out[i] = id;
  }
  for (size_t g = 0; g < rep.size(); ++g) rep_out[g] = rep[g];
  return static_cast<int64_t>(rep.size());
}

// Render rows of tab-joined u64 values with a trailing row index:
// "<v0>\t<v1>...\t<row>\n".  Returns bytes written (caller sizes out
// for 21 bytes per value + 22 per row).
extern "C" int64_t radc_format_eqc_rows(const uint64_t* vals,
                                        const int64_t* offs, int64_t n_rows,
                                        uint8_t* out) {
  uint8_t* p = out;
  auto emit = [&p](uint64_t v) {
    char tmp[20];
    int k = 0;
    do {
      tmp[k++] = static_cast<char>('0' + (v % 10));
      v /= 10;
    } while (v);
    while (k) *p++ = static_cast<uint8_t>(tmp[--k]);
  };
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int64_t j = offs[r]; j < offs[r + 1]; ++j) {
      emit(vals[j]);
      *p++ = '\t';
    }
    emit(static_cast<uint64_t>(r));
    *p++ = '\n';
  }
  return p - out;
}

// ---------------------------------------------------------------------------
// Split PUG resolution: native graph build -> (device) connected
// components -> native greedy cover.  The handle keeps the per-cell
// tables and adjacency alive between the two native calls so nothing
// is recomputed; the caller runs batched min-label-propagation CC on
// the accelerator in between (ops/pug_device.py) and passes per-node
// component labels back.  Matches radc_pug_resolve bit-for-bit.
// ---------------------------------------------------------------------------

namespace {

struct PugBatchHandle {
  std::vector<pugk::Tables> tables;                      // per cell
  std::vector<std::vector<std::vector<int32_t>>> adjs;   // per cell (directed)
  std::vector<int64_t> node_offsets;                     // per cell prefix
};

}  // namespace

extern "C" void* radc_pug_graph_build(
    const int64_t* cell_read_offsets, int64_t n_cells,
    const uint64_t* umi, const uint32_t* refs, const int64_t* aln_offsets,
    const uint32_t* tid_to_gid, int32_t gene_level, int32_t exact,
    int64_t* n_nodes_per_cell, int64_t* sym_entries_per_cell,
    int32_t n_threads) {
  auto* h = new PugBatchHandle();
  h->tables.resize(static_cast<size_t>(n_cells));
  h->adjs.resize(static_cast<size_t>(n_cells));
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c) {
      auto& T = h->tables[static_cast<size_t>(c)];
      pugk::build_tables(umi, refs, aln_offsets, cell_read_offsets[c],
                         cell_read_offsets[c + 1], tid_to_gid, gene_level, T);
      auto& adj = h->adjs[static_cast<size_t>(c)];
      pugk::build_adj(T, exact, adj);
      n_nodes_per_cell[c] = T.nv;
      // symmetrized degree sum (sorted-unique union of in/out edges)
      int64_t entries = 0;
      std::vector<std::vector<int32_t>> sym(adj.size());
      for (size_t v = 0; v < adj.size(); ++v)
        for (int32_t w : adj[v]) {
          sym[v].push_back(w);
          sym[static_cast<size_t>(w)].push_back(static_cast<int32_t>(v));
        }
      for (auto& s : sym) {
        std::sort(s.begin(), s.end());
        s.erase(std::unique(s.begin(), s.end()), s.end());
        entries += static_cast<int64_t>(s.size());
      }
      sym_entries_per_cell[c] = entries;
    }
  };
  if (n_threads == 1 || n_cells < 2) {
    work(0, n_cells);
  } else {
    const int64_t total = cell_read_offsets[n_cells] - cell_read_offsets[0];
    std::vector<std::thread> ts;
    std::vector<std::pair<int64_t, int64_t>> ranges;
    int64_t c_prev = 0;
    for (int t = 1; t < n_threads; ++t) {
      const int64_t target = cell_read_offsets[0] + total * t / n_threads;
      int64_t c = c_prev;
      while (c < n_cells && cell_read_offsets[c] < target) ++c;
      ranges.emplace_back(c_prev, c);
      c_prev = c;
    }
    ranges.emplace_back(c_prev, n_cells);
    for (size_t t = 1; t < ranges.size(); ++t)
      ts.emplace_back(work, ranges[t].first, ranges[t].second);
    work(ranges[0].first, ranges[0].second);
    for (auto& th : ts) th.join();
  }
  h->node_offsets.assign(static_cast<size_t>(n_cells) + 1, 0);
  for (int64_t c = 0; c < n_cells; ++c)
    h->node_offsets[c + 1] = h->node_offsets[c] + n_nodes_per_cell[c];
  return h;
}

// Export the symmetrized adjacency: per-node degree (concatenated cell
// order) and the flat neighbor list (cell-local node ids).
extern "C" void radc_pug_graph_export(void* handle, int64_t* deg_out,
                                      int32_t* nbr_out) {
  auto* h = static_cast<PugBatchHandle*>(handle);
  int64_t dpos = 0, npos = 0;
  for (size_t c = 0; c < h->adjs.size(); ++c) {
    const auto& adj = h->adjs[c];
    std::vector<std::vector<int32_t>> sym(adj.size());
    for (size_t v = 0; v < adj.size(); ++v)
      for (int32_t w : adj[v]) {
        sym[v].push_back(w);
        sym[static_cast<size_t>(w)].push_back(static_cast<int32_t>(v));
      }
    for (auto& s : sym) {
      std::sort(s.begin(), s.end());
      s.erase(std::unique(s.begin(), s.end()), s.end());
      deg_out[dpos++] = static_cast<int64_t>(s.size());
      std::memcpy(nbr_out + npos, s.data(), s.size() * 4);
      npos += static_cast<int64_t>(s.size());
    }
  }
}

// Finish resolution from per-node component labels (flat in cell
// order, each label any canonical id within [0, nv_cell)).  Output
// contract identical to radc_pug_resolve.
extern "C" int64_t radc_pug_cover(
    void* handle, const int64_t* cell_read_offsets, int64_t n_cells,
    const int64_t* aln_offsets, const uint32_t* tid_to_gid,
    int32_t gene_level, int64_t large_thresh, const int32_t* comp_labels,
    int64_t* n_eqc_per_cell, uint8_t* used_alt_per_cell,
    int64_t* counts_out, int64_t* lens_out, uint32_t* labels_out,
    int64_t* range_info, int64_t* label_counts, int32_t n_threads) {
  auto* h = static_cast<PugBatchHandle*>(handle);
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t c0, int64_t c1, int t) {
    const int64_t read_base = (c0 < n_cells) ? cell_read_offsets[c0] : 0;
    const int64_t label_base = (c0 < n_cells) ? aln_offsets[read_base] : 0;
    int64_t w = read_base;
    int64_t lw = label_base;
    pugk::CellOut out;
    std::vector<std::vector<int32_t>> comps;
    for (int64_t c = c0; c < c1; ++c) {
      out.counts.clear();
      out.lens.clear();
      out.labels.clear();
      out.n_eqc = 0;
      out.used_alt = 0;
      const auto& T = h->tables[static_cast<size_t>(c)];
      pugk::comps_from_labels(comp_labels + h->node_offsets[c], T.nv, comps);
      pugk::resolve_components(T, h->adjs[static_cast<size_t>(c)], comps,
                               large_thresh, tid_to_gid, gene_level, out);
      n_eqc_per_cell[c] = out.n_eqc;
      used_alt_per_cell[c] = static_cast<uint8_t>(out.used_alt);
      std::memcpy(counts_out + w, out.counts.data(), out.counts.size() * 8);
      std::memcpy(lens_out + w, out.lens.data(), out.lens.size() * 8);
      std::memcpy(labels_out + lw, out.labels.data(), out.labels.size() * 4);
      w += static_cast<int64_t>(out.counts.size());
      lw += static_cast<int64_t>(out.labels.size());
    }
    range_info[t * 4 + 0] = c0;
    range_info[t * 4 + 1] = read_base;
    range_info[t * 4 + 2] = label_base;
    range_info[t * 4 + 3] = w - read_base;
    label_counts[t] = lw - label_base;
  };
  if (n_threads == 1 || n_cells < 2) {
    work(0, n_cells, 0);
    for (int t = 1; t < n_threads; ++t) {
      range_info[t * 4 + 0] = n_cells;
      range_info[t * 4 + 1] = 0;
      range_info[t * 4 + 2] = 0;
      range_info[t * 4 + 3] = 0;
      label_counts[t] = 0;
    }
    return 0;
  }
  const int64_t total = cell_read_offsets[n_cells] - cell_read_offsets[0];
  std::vector<std::thread> ts;
  std::vector<std::pair<int64_t, int64_t>> ranges;
  int64_t c_prev = 0;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t target = cell_read_offsets[0] + total * t / n_threads;
    int64_t c = c_prev;
    while (c < n_cells && cell_read_offsets[c] < target) ++c;
    ranges.emplace_back(c_prev, c);
    c_prev = c;
  }
  ranges.emplace_back(c_prev, n_cells);
  for (size_t t = 1; t < ranges.size(); ++t)
    ts.emplace_back(work, ranges[t].first, ranges[t].second,
                    static_cast<int>(t));
  work(ranges[0].first, ranges[0].second, 0);
  for (auto& th : ts) th.join();
  return 0;
}

extern "C" void radc_pug_free(void* handle) {
  delete static_cast<PugBatchHandle*>(handle);
}

// Gather whole records into a destination buffer at caller-computed
// offsets (the spill-bucket gather: records move by memcpy in sorted
// order, headers are patched by the caller).  Threaded by record range.
extern "C" void radc_gather_records(
    const uint8_t* buf, const int64_t* rec_starts, const int64_t* sizes,
    const int64_t* order, int64_t n, const int64_t* dst_off, uint8_t* out,
    int32_t n_threads) {
  auto work = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const int64_t r = order[i];
      std::memcpy(out + dst_off[i], buf + rec_starts[r],
                  static_cast<size_t>(sizes[r]));
    }
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n < (1 << 14)) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t prev = 0;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t i = n * t / n_threads;
    ts.emplace_back(work, prev, i);
    prev = i;
  }
  work(prev, n);
  for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// BAM record scanner (convert).  Walks decompressed BAM records and
// extracts the columns bam2rad needs: flag, tid, 2-bit packed CR/UR
// tags (single N->A replacement, second N invalidates — the
// reference's rule at convert.rs:525-531), AS score, and a
// same-qname-as-previous flag for read grouping.  Partial trailing
// records are left for the caller to carry over; the previous call's
// last qname is carried in a caller-owned state buffer so grouping
// works across buffer boundaries.
// ---------------------------------------------------------------------------

namespace {

// pack an ASCII sequence 2-bit with the single-N rule.
// returns length, sets *valid, writes packed value.
inline int pack_seq_n(const uint8_t* s, int64_t n, uint64_t* out,
                      int* valid) {
  uint64_t v = 0;
  int n_seen = 0;
  *valid = 1;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t code;
    switch (s[i]) {
      case 'A': case 'a': code = 0; break;
      case 'C': case 'c': code = 1; break;
      case 'G': case 'g': code = 2; break;
      case 'T': case 't': code = 3; break;
      default:
        if (++n_seen > 1) {
          *valid = 0;
          code = 0;
        } else {
          code = 0;  // first N -> A
        }
        break;
    }
    v = (v << 2) | code;
  }
  *out = v;
  return static_cast<int>(n);
}

}  // namespace

// Returns the number of complete records consumed (their columns are
// written to the output arrays, capacity max_recs) and sets
// *bytes_consumed, or -1 on a structurally invalid record (block too
// small for the fixed header, negative lengths, fields overrunning the
// block).  qname_state is a 258-byte caller buffer holding
// [len:u16][bytes...] of the last record's qname (initialize len=0
// before the first call).
extern "C" int64_t radc_bam_scan(
    const uint8_t* buf, int64_t n, uint8_t* qname_state,
    uint16_t* flags_out, int32_t* tid_out,
    uint64_t* bc_out, int32_t* bclen_out, uint8_t* bc_valid_out,
    uint64_t* umi_out, int32_t* umilen_out, uint8_t* umi_valid_out,
    int32_t* as_out, uint8_t* same_qname_out,
    int64_t* bytes_consumed, int64_t max_recs) {
  int64_t pos = 0;
  int64_t rec = 0;
  uint16_t prev_len;
  std::memcpy(&prev_len, qname_state, 2);
  while (pos + 4 <= n && rec < max_recs) {
    uint32_t block_size;
    std::memcpy(&block_size, buf + pos, 4);
    if (block_size < 32) return -1;  // fixed BAM record header is 32 bytes
    if (pos + 4 + static_cast<int64_t>(block_size) > n) break;
    const uint8_t* r = buf + pos + 4;
    int32_t tid, l_read;
    std::memcpy(&tid, r, 4);
    const uint8_t l_qname = r[8];
    uint16_t n_cigar, flag;
    std::memcpy(&n_cigar, r + 12, 2);
    std::memcpy(&flag, r + 14, 2);
    std::memcpy(&l_read, r + 16, 4);
    if (l_read < 0 ||
        32 + static_cast<int64_t>(l_qname) + 4LL * n_cigar +
                (static_cast<int64_t>(l_read) + 1) / 2 + l_read >
            static_cast<int64_t>(block_size)) {
      return -1;  // variable-length fields overrun the record block
    }
    const uint8_t* qname = r + 32;
    // group chain vs the previous KEPT record: unmapped/supplementary
    // records are skipped downstream and must not break a qname run
    // (convert.rs grouping semantics)
    const int64_t qn = l_qname > 0 ? l_qname - 1 : 0;  // strip NUL
    uint8_t same = (prev_len == qn) &&
                   (std::memcmp(qname_state + 2, qname, qn) == 0);
    same_qname_out[rec] = same;
    if ((flag & 0x804) == 0) {  // kept: becomes the comparison anchor
      prev_len = static_cast<uint16_t>(qn);
      std::memcpy(qname_state + 2, qname, prev_len);
      std::memcpy(qname_state, &prev_len, 2);
    }

    flags_out[rec] = flag;
    tid_out[rec] = tid;
    // aux tags start after qname + cigar + seq + qual
    int64_t off = 32 + l_qname + 4LL * n_cigar + (l_read + 1) / 2 + l_read;
    const int64_t end = block_size;
    int32_t as_score = INT32_MIN;
    uint64_t bc = 0, umi = 0;
    int32_t bclen = -1, umilen = -1;
    int bc_valid = 0, umi_valid = 0;
    while (off + 3 <= end) {
      const uint8_t t0 = r[off], t1 = r[off + 1];
      const uint8_t vt = r[off + 2];
      off += 3;
      int64_t adv = -1;
      switch (vt) {
        case 'A': case 'c': case 'C': adv = 1; break;
        case 's': case 'S': adv = 2; break;
        case 'i': case 'I': case 'f': adv = 4; break;
        case 'Z': case 'H': {
          int64_t e = off;
          while (e < end && r[e] != 0) ++e;
          if (t0 == 'C' && t1 == 'R') {
            bclen = pack_seq_n(r + off, e - off, &bc, &bc_valid);
          } else if (t0 == 'U' && t1 == 'R') {
            umilen = pack_seq_n(r + off, e - off, &umi, &umi_valid);
          }
          adv = e - off + 1;
          break;
        }
        case 'B': {
          if (off + 5 > end) { adv = end - off; break; }
          const uint8_t sub = r[off];
          int32_t cnt;
          std::memcpy(&cnt, r + off + 1, 4);
          if (cnt < 0) return -1;
          int sz = (sub == 'c' || sub == 'C') ? 1
                   : (sub == 's' || sub == 'S') ? 2 : 4;
          adv = 5 + static_cast<int64_t>(cnt) * sz;
          break;
        }
        default: adv = end - off; break;  // unknown: stop scanning
      }
      if (t0 == 'A' && t1 == 'S' &&
          (vt == 'c' || vt == 'C' || vt == 's' || vt == 'S' || vt == 'i' ||
           vt == 'I')) {
        int64_t v = 0;
        switch (vt) {
          case 'c': v = static_cast<int8_t>(r[off]); break;
          case 'C': v = r[off]; break;
          case 's': { int16_t x; std::memcpy(&x, r + off, 2); v = x; break; }
          case 'S': { uint16_t x; std::memcpy(&x, r + off, 2); v = x; break; }
          case 'i': { int32_t x; std::memcpy(&x, r + off, 4); v = x; break; }
          case 'I': { uint32_t x; std::memcpy(&x, r + off, 4); v = (int64_t)x; break; }
        }
        as_score = static_cast<int32_t>(v);
      }
      off += adv;
    }
    bc_out[rec] = bc;
    bclen_out[rec] = bclen;
    bc_valid_out[rec] = static_cast<uint8_t>(bc_valid);
    umi_out[rec] = umi;
    umilen_out[rec] = umilen;
    umi_valid_out[rec] = static_cast<uint8_t>(umi_valid);
    as_out[rec] = as_score;
    pos += 4 + block_size;
    ++rec;
  }
  *bytes_consumed = pos;
  return rec;
}

// --- BGZF threaded inflate --------------------------------------------------
//
// BGZF (the BAM container framing) is a series of independent gzip
// members, each <= 64 KB with its compressed size in a BC extra
// subfield; the reference decompresses them with a multithreaded bgzf
// reader (convert.rs:205-220).  Block independence makes the inflate
// embarrassingly parallel: the caller scans block boundaries (cheap)
// and this entry point inflates all payloads concurrently with
// raw-deflate zlib streams.

#include <zlib.h>

// Inflate n_blocks raw-deflate payloads (buf+offs[i], lens[i]) into
// out+out_offs[i], each expected to produce isizes[i] bytes.  Returns 0
// on success or -(i+1) for the first failing block.
extern "C" int64_t radc_bgzf_inflate(
    const uint8_t* buf, const int64_t* offs, const int64_t* lens,
    const int64_t* out_offs, const int64_t* isizes, const uint32_t* crcs,
    int64_t n_blocks, uint8_t* out, int32_t nthreads) {
  if (n_blocks <= 0) return 0;
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt > n_blocks) nt = static_cast<int>(n_blocks);
  std::vector<int64_t> status(nt, 0);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&, t]() {
      z_stream strm;
      for (int64_t i = t; i < n_blocks; i += nt) {
        std::memset(&strm, 0, sizeof(strm));
        if (inflateInit2(&strm, -15) != Z_OK) {
          if (!status[t]) status[t] = -(i + 1);
          return;
        }
        strm.next_in = const_cast<Bytef*>(buf + offs[i]);
        strm.avail_in = static_cast<uInt>(lens[i]);
        strm.next_out = out + out_offs[i];
        strm.avail_out = static_cast<uInt>(isizes[i]);
        int rc = inflate(&strm, Z_FINISH);
        bool ok = (rc == Z_STREAM_END) &&
                  (static_cast<int64_t>(strm.total_out) == isizes[i]);
        inflateEnd(&strm);
        // per-member CRC32 check (the gzip trailer contract the
        // sequential gzip reader enforced; bit flips that still
        // inflate to isize bytes are caught here, in the same worker)
        if (ok && crcs != nullptr) {
          uLong c = crc32(0L, out + out_offs[i],
                          static_cast<uInt>(isizes[i]));
          ok = (static_cast<uint32_t>(c) == crcs[i]);
        }
        if (!ok && !status[t]) {
          status[t] = -(i + 1);
          return;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int t = 0; t < nt; ++t)
    if (status[t]) return status[t];
  return 0;
}

// --- Batched per-cell EM (host path) ----------------------------------------
// Exact C++ port of ops/em.py::em_optimize_cell_np (em.rs:116-294
// semantics): f32 arithmetic with the SAME accumulation order as the
// NumPy reference (element order within each class, class order within
// the cell), so outputs are bit-identical to the Python path.  The
// per-cell working set is confined to the cell's touched label ids
// (plus USA partner positions), so the dense R-wide scratch is zeroed
// once per thread, not per iteration.
//
// Layout: cells ci own classes [ceo[ci], ceo[ci+1]); class e owns
// labels [lo[e], lo[e+1]) (GLOBAL flat offsets).  Outputs: for cell ci
// the nonzero (index, value) pairs are written at out_idx/out_val
// positions [lo[ceo[ci]] .. ) — i.e. each cell writes into its own
// label region (nnz <= #labels always) — with out_nnz[ci] the count.
// usa: uoff/aoff >= 0 selects the 3-section abundance coupling
// (em.rs:94-114); -1 disables.
namespace {

struct EmConsts {
  static constexpr float kMinOut = 0.01f;
  static constexpr float kCheckCutoff = 1e-2f;
  static constexpr float kRelTol = 1e-2f;
  static constexpr int kMinIter = 2;
  static constexpr int kMaxIter = 100;
};

inline float em_abundance(const float* alphas, int64_t idx, int64_t uoff,
                          int64_t aoff) {
  if (uoff < 0) return alphas[idx];
  if (idx >= aoff)
    return alphas[idx - uoff] + alphas[idx - aoff] + alphas[idx];
  if (idx >= uoff) return alphas[idx + uoff] + alphas[idx];
  return alphas[idx + aoff] + alphas[idx];
}

}  // namespace

extern "C" int64_t radc_em_cells(
    const int64_t* ceo, const int64_t* lo, const uint32_t* labels,
    const uint32_t* counts, int64_t n_cells, int64_t R, int64_t uoff,
    int64_t aoff, int32_t init_uniform, int32_t with_last_round,
    int32_t n_threads, int64_t* out_nnz, int64_t* out_idx,
    float* out_val) {
  if (n_cells == 0) return 0;
  if (n_threads < 1) n_threads = 1;

  auto work = [&](int64_t c0, int64_t c1) {
    std::vector<float> alphas_v(static_cast<size_t>(R), 0.0f);
    std::vector<float> out_v(static_cast<size_t>(R), 0.0f);
    float* alphas = alphas_v.data();
    float* out = out_v.data();
    std::vector<int64_t> touched;   // label ids (may repeat; deduped)
    std::vector<int64_t> readset;   // touched + USA partner positions

    for (int64_t ci = c0; ci < c1; ++ci) {
      const int64_t es = ceo[ci], ee = ceo[ci + 1];
      const int64_t base = lo[es];
      // gather touched ids + single/multi structure
      touched.clear();
      bool needs_em = false;
      for (int64_t e = es; e < ee; ++e) {
        const int64_t ls = lo[e], le = lo[e + 1];
        if (le - ls > 1) needs_em = true;
        for (int64_t j = ls; j < le; ++j)
          touched.push_back(static_cast<int64_t>(labels[j]));
      }
      std::sort(touched.begin(), touched.end());
      touched.erase(std::unique(touched.begin(), touched.end()),
                    touched.end());
      readset.assign(touched.begin(), touched.end());
      if (uoff >= 0) {
        for (int64_t t : touched) {
          if (t >= aoff) {
            readset.push_back(t - uoff);
            readset.push_back(t - aoff);
          } else if (t >= uoff) {
            readset.push_back(t + uoff);
          } else {
            readset.push_back(t + aoff);
          }
        }
        std::sort(readset.begin(), readset.end());
        readset.erase(std::unique(readset.begin(), readset.end()),
                      readset.end());
      }

      // seed scatter (single-label classes), in class order
      for (int64_t e = es; e < ee; ++e)
        if (lo[e + 1] - lo[e] == 1)
          alphas[labels[lo[e]]] += static_cast<float>(counts[e - 0]);

      int64_t nnz = 0;
      int64_t* oidx = out_idx + base;
      float* oval = out_val + base;
      if (!needs_em) {
        for (int64_t t : touched)
          if (alphas[t] != 0.0f) {
            oidx[nnz] = t;
            oval[nnz++] = alphas[t];
          }
        out_nnz[ci] = nnz;
        for (int64_t t : readset) alphas[t] = 0.0f;
        continue;
      }

      // init over the read set (values elsewhere are never read:
      // gathers and partner reads are confined to readset)
      if (init_uniform) {
        const float u = 1.0f / static_cast<float>(R);
        for (int64_t t : readset) alphas[t] = u;
      } else {
        for (int64_t t : readset)
          alphas[t] = (alphas[t] + 0.5f) * 1e-3f;
      }

      int it = 0;
      bool last_round = false;
      bool converged = true;
      while (it < EmConsts::kMinIter ||
             (it < EmConsts::kMaxIter && !converged) || last_round) {
        // out := zeros (touched only; out is zero elsewhere)
        for (int64_t t : touched) out[t] = 0.0f;
        for (int64_t e = es; e < ee; ++e) {
          const int64_t ls = lo[e], le = lo[e + 1];
          if (le - ls == 1) out[labels[ls]] += static_cast<float>(counts[e]);
        }
        for (int64_t e = es; e < ee; ++e) {
          const int64_t ls = lo[e], le = lo[e + 1];
          if (le - ls <= 1) continue;
          float denom = 0.0f;
          for (int64_t j = ls; j < le; ++j)
            denom += em_abundance(alphas, labels[j], uoff, aoff);
          if (denom > 0.0f) {
            const float inv = static_cast<float>(counts[e]) / denom;
            for (int64_t j = ls; j < le; ++j)
              out[labels[j]] +=
                  em_abundance(alphas, labels[j], uoff, aoff) * inv;
          }
        }
        converged = true;
        for (int64_t t : touched) {
          if (out[t] > EmConsts::kCheckCutoff &&
              std::fabs(alphas[t] - out[t]) > EmConsts::kRelTol) {
            converged = false;
            break;
          }
        }
        // alphas := out over the READ SET (positions outside touched
        // become zero — matching NumPy's full-array assignment)
        for (int64_t t : readset) alphas[t] = out[t];
        ++it;
        if (last_round) break;
        if (with_last_round && it >= EmConsts::kMinIter && converged) {
          for (int64_t t : readset)
            if (alphas[t] < EmConsts::kMinOut) alphas[t] = 0.0f;
          last_round = true;
        }
        if (!with_last_round && it >= EmConsts::kMinIter && converged)
          break;
      }
      for (int64_t t : touched) {
        float v = alphas[t];
        if (v < EmConsts::kMinOut) v = 0.0f;
        if (v != 0.0f) {
          oidx[nnz] = t;
          oval[nnz++] = v;
        }
      }
      out_nnz[ci] = nnz;
      // reset scratch for the next cell
      for (int64_t t : readset) alphas[t] = 0.0f;
      for (int64_t t : touched) out[t] = 0.0f;
    }
  };

  const int64_t T = std::min<int64_t>(n_threads, n_cells);
  if (T <= 1) {
    work(0, n_cells);
  } else {
    std::vector<std::thread> ts;
    const int64_t per = (n_cells + T - 1) / T;
    for (int64_t t = 1; t < T; ++t) {
      const int64_t s = t * per;
      if (s >= n_cells) break;
      ts.emplace_back(work, s, std::min(n_cells, s + per));
    }
    work(0, std::min(per, n_cells));
    for (auto& th : ts) th.join();
  }
  return 0;
}
