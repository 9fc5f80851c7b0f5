// Native host engine: exact paired-end bulk mapping loop.
//
// This is the C++ runtime layer of the framework (the analog of the
// reference's single-process core, re-scoped): it owns the per-read
// sequential orchestration -- minimizer state machine, index probes,
// candidate clustering, mate rescue, candidate cache, banded Myers
// verification, selection and MAPQ -- while batch-level device kernels
// (Pallas Myers) remain the TPU compute path driven from Python.
//
// Semantics follow the validated Python engines bit-for-bit (which in turn
// reproduce reference chromap 0.3.3-r521 byte-for-byte); every quirk is
// deliberate: uint8/uint32 wraparound, float truncation points, the
// libstdc++ uniform_int_distribution rejection scheme, lane-group
// verification order, and the cache's fingerprint gating.
//
// Scope: paired-end, bulk, non-split, BED-record outputs. Everything else
// routes through the Python engines.

#include <algorithm>
#include <array>
#include <cassert>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>
#include <thread>
#include <atomic>

#include <zlib.h>

namespace {

constexpr uint64_t kU32 = 0xFFFFFFFFull;
constexpr uint64_t kUmax = 0xFFFFFFFFFFFFFFFFull;

uint8_t kCharToCode[256];

struct CodeTableInit {
  CodeTableInit() {
    memset(kCharToCode, 4, sizeof(kCharToCode));
    kCharToCode[(int)'A'] = 0; kCharToCode[(int)'a'] = 0;
    kCharToCode[(int)'C'] = 1; kCharToCode[(int)'c'] = 1;
    kCharToCode[(int)'G'] = 2; kCharToCode[(int)'g'] = 2;
    kCharToCode[(int)'T'] = 3; kCharToCode[(int)'t'] = 3;
  }
} code_table_init;

inline uint64_t Hash64(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

struct Minimizer {
  uint64_t hash;
  uint64_t hit;  // (pos << 1) | strand, sequence index 0 for reads
};

constexpr uint32_t kNoExt = 0xFFFFFFFFu;

struct Candidate {
  uint64_t position;  // rid<<32 | start
  uint8_t count;
  // device-precomputed verification (err<<8 | end_pos), kNoExt when the
  // banded alignment must run natively; split mode packs the 50-bit
  // drop-off results across ext (low 32) and ext2 (high 18)
  uint32_t ext = kNoExt;
  uint32_t ext2 = 0;
};

inline bool CandidateLess(const Candidate& a, const Candidate& b) {
  if (a.count != b.count) return a.count > b.count;
  return a.position < b.position;
}

struct DraftMapping {
  int num_errors;
  uint64_t position;  // rid<<32 | end
};

// ------------------------- minimizer extraction -------------------------

void GenerateMinimizers(const uint8_t* codes, int n, int k, int w,
                        std::vector<Minimizer>& out,
                        uint64_t hit_base = 0, bool append = false,
                        bool final_flush = true) {
  if (!append) out.clear();
  const uint64_t mask = (k < 32) ? ((1ull << (2 * k)) - 1) : kUmax;
  const uint64_t shift = 2 * (k - 1);

  // Blocked three-pass structure: a serial rolling pass fills per-position
  // kmer values, the three Hash64 mixes run as independent auto-vectorized
  // lanes, then the window scan consumes them (exact queue semantics of
  // minimizer_generator.cc:30-139). Blocks bound the working set to a few
  // MB: on this kernel, first-touch page faults on genome-sized scratch
  // arrays cost far more than the hashing itself.
  constexpr int kBlock = 1 << 20;
  static thread_local std::vector<uint64_t> fwd_v, rc_v, hash_v;
  static thread_local std::vector<uint8_t> kind_v;  // 0 ok, 1 invalid,
                                                    // 2 symmetric, 3 short
  const int blk = n < kBlock ? n : kBlock;
  if ((int)fwd_v.size() < blk) {
    fwd_v.resize(blk);
    rc_v.resize(blk);
    hash_v.resize(blk);
    kind_v.resize(blk);
  }

  static thread_local std::vector<std::pair<uint64_t, uint64_t>> buffer;
  buffer.assign(w, {kUmax, kUmax});
  std::pair<uint64_t, uint64_t> min_seed = {kUmax, kUmax};
  int min_position = 0, position_in_buffer = 0, unambiguous_length = 0;
  uint64_t fwd = 0, rc = 0;
  int run = 0;

  for (int b0 = 0; b0 < n; b0 += blk) {
    const int m = std::min(blk, n - b0);
    for (int i = 0; i < m; ++i) {
      uint8_t base = codes[b0 + i];
      if (base < 4) {
        fwd = ((fwd << 2) | base) & mask;
        rc = (rc >> 2) | (((uint64_t)(3 ^ base)) << shift);
        ++run;
        fwd_v[i] = fwd;
        rc_v[i] = rc;
        kind_v[i] = fwd == rc ? 2 : (run >= k ? 0 : 3);
      } else {
        run = 0;
        kind_v[i] = 1;
        fwd_v[i] = 0;
        rc_v[i] = 0;
      }
    }
    {
      uint64_t* fw = fwd_v.data();
      uint64_t* rv = rc_v.data();
      uint64_t* hv = hash_v.data();
#pragma omp simd
      for (int i = 0; i < m; ++i) fw[i] = Hash64(fw[i], mask);
#pragma omp simd
      for (int i = 0; i < m; ++i) rv[i] = Hash64(rv[i], mask);
#pragma omp simd
      for (int i = 0; i < m; ++i) {
        uint64_t hf = fw[i], hr = rv[i];
        uint64_t strand = hf < hr ? 0 : 1;
        hv[i] = (Hash64(strand ? hr : hf, mask) << 1) | strand;
      }
    }

    for (int i = 0; i < m; ++i) {
      uint8_t kind = kind_v[i];
      std::pair<uint64_t, uint64_t> cur = {kUmax, kUmax};
      if (kind != 1) {
        if (kind == 2) {  // symmetric kmer: no slot
          ++unambiguous_length;
          continue;
        }
        ++unambiguous_length;
        if (unambiguous_length >= k) {
          uint64_t hs = hash_v[i];
          cur.first = hs >> 1;
          cur.second = hit_base | (((uint64_t)(b0 + i)) << 1) | (hs & 1);
        }
      } else {
        unambiguous_length = 0;
      }

      buffer[position_in_buffer] = cur;
      if (unambiguous_length == w + k - 1 && min_seed.first != kUmax &&
          min_seed.first < cur.first) {
        for (int j = position_in_buffer + 1; j < w; ++j)
          if (min_seed.first == buffer[j].first &&
              buffer[j].second != min_seed.second)
            out.push_back({buffer[j].first, buffer[j].second});
        for (int j = 0; j < position_in_buffer; ++j)
          if (min_seed.first == buffer[j].first &&
              buffer[j].second != min_seed.second)
            out.push_back({buffer[j].first, buffer[j].second});
      }

      if (cur.first <= min_seed.first) {
        if (unambiguous_length >= w + k && min_seed.first != kUmax)
          out.push_back({min_seed.first, min_seed.second});
        min_seed = cur;
        min_position = position_in_buffer;
      } else if (position_in_buffer == min_position) {
        if (unambiguous_length >= w + k - 1 && min_seed.first != kUmax)
          out.push_back({min_seed.first, min_seed.second});
        min_seed = {kUmax, kUmax};
        for (int j = position_in_buffer + 1; j < w; ++j)
          if (min_seed.first >= buffer[j].first) {
            min_seed = buffer[j];
            min_position = j;
          }
        for (int j = 0; j <= position_in_buffer; ++j)
          if (min_seed.first >= buffer[j].first) {
            min_seed = buffer[j];
            min_position = j;
          }
        if (unambiguous_length >= w + k - 1 && min_seed.first != kUmax) {
          for (int j = position_in_buffer + 1; j < w; ++j)
            if (min_seed.first == buffer[j].first &&
                min_seed.second != buffer[j].second)
              out.push_back({buffer[j].first, buffer[j].second});
          for (int j = 0; j <= position_in_buffer; ++j)
            if (min_seed.first == buffer[j].first &&
                min_seed.second != buffer[j].second)
              out.push_back({buffer[j].first, buffer[j].second});
        }
      }
      if (++position_in_buffer == w) position_in_buffer = 0;
    }
  }
  if (final_flush && min_seed.first != kUmax)
    out.push_back({min_seed.first, min_seed.second});
}

// ------------------------------ index ------------------------------

struct IndexView {
  const uint64_t* hash_keys;
  const uint64_t* offsets;
  const uint32_t* counts;
  int64_t num_keys;
  const uint64_t* occurrences;
  int k, w;

  // Open-addressing probe table over (hash_keys -> offset,count). The
  // reference reaches its (offset,count) through a khash lookup
  // (src/index_utils.h:13-58); a flat power-of-two linear-probe table is
  // the same O(1) access without the vendored macros. Each 16-byte entry
  // holds key+1 (0 = empty) and the value packed as offset<<24 | count,
  // so a hit costs one cache-line touch.
  struct HtEntry {
    uint64_t key1;
    uint64_t val;
  };
  std::vector<HtEntry> ht;
  uint64_t ht_mask = 0;
  static constexpr uint64_t kCntBits = 24;
  static constexpr uint64_t kCntMask = (1ull << kCntBits) - 1;

  void BuildProbeTable() {
    uint64_t cap = 16;
    while (cap < (uint64_t)num_keys + (uint64_t)num_keys / 2) cap <<= 1;
    ht_mask = cap - 1;
    ht.assign(cap, {0, 0});
    constexpr int64_t kPf = 16;  // overlap the random-slot cache misses
    for (int64_t i = 0; i < num_keys; ++i) {
      if (i + kPf < num_keys) {
        uint64_t hp = hash_keys[i + kPf];
        __builtin_prefetch(&ht[((hp * 0x9E3779B97F4A7C15ull) >> 1)
                               & ht_mask], 1);
      }
      uint64_t h = hash_keys[i];
      uint64_t cnt = counts[i] < kCntMask ? counts[i] : kCntMask;
      uint64_t s = (h * 0x9E3779B97F4A7C15ull) >> 1;
      for (s &= ht_mask;; s = (s + 1) & ht_mask) {
        if (ht[s].key1 == 0) {
          ht[s] = {h + 1, (offsets[i] << kCntBits) | cnt};
          break;
        }
      }
    }
  }

  // returns (offset, count) or count==0 if absent
  inline std::pair<int64_t, uint32_t> Lookup(uint64_t h) const {
    if (h + 1 == 0) {  // key would alias the empty marker: exact search
      const uint64_t* lo =
          std::lower_bound(hash_keys, hash_keys + num_keys, h);
      if (lo == hash_keys + num_keys || *lo != h) return {0, 0};
      int64_t i = lo - hash_keys;
      return {(int64_t)offsets[i], counts[i]};
    }
    uint64_t s = (h * 0x9E3779B97F4A7C15ull) >> 1;
    for (s &= ht_mask;; s = (s + 1) & ht_mask) {
      const HtEntry& en = ht[s];
      if (en.key1 == h + 1) {
        uint32_t cnt = (uint32_t)(en.val & kCntMask);
        if (cnt == kCntMask) {  // saturated: fall back to the exact row
          const uint64_t* lo =
              std::lower_bound(hash_keys, hash_keys + num_keys, h);
          int64_t i = lo - hash_keys;
          return {(int64_t)offsets[i], counts[i]};
        }
        return {(int64_t)(en.val >> kCntBits), cnt};
      }
      if (en.key1 == 0) return {0, 0};
    }
  }
};

struct RepStats {
  uint32_t length = 0;
  uint64_t prev = 0x100000000ull;  // > any uint32
  int count = 0;
  int k, w;
  void Update(uint32_t read_position) {
    if (prev > read_position) {
      length += k;
    } else if (read_position < prev + k + w - 1) {
      length += read_position - (uint32_t)prev;
    } else {
      length += k;
    }
    prev = read_position;
    ++count;
  }
};

// -------------------------- seeding per read --------------------------

struct SeedState {
  std::vector<Minimizer> minimizers;
  uint32_t num_minimizers = 0;
  std::vector<uint64_t> positive_hits, negative_hits;
  std::vector<Candidate> positive_candidates, negative_candidates;
  std::vector<Candidate> pos_buf, neg_buf;
  uint32_t repetitive_seed_length = 0;
  void Clear() {
    minimizers.clear();
    num_minimizers = 0;
    positive_hits.clear();
    negative_hits.clear();
    positive_candidates.clear();
    negative_candidates.clear();
    pos_buf.clear();
    neg_buf.clear();
    repetitive_seed_length = 0;
  }
  size_t NumCandidates() const {
    return positive_candidates.size() + negative_candidates.size();
  }
};

struct MappingParams {
  int error_threshold;
  int min_num_seeds;
  int f0, f1;
  int max_num_best_mappings;
  int max_insert_size;
  int min_read_length;
  int drop_repetitive_reads;
  bool trim_adapters;
  bool tagalign_dups;  // unused; records identical for BED/TagAlign
  // SAM mode: positions come from the affine-gap semi-global alignment
  // (with CIGAR) instead of BandedTraceback (mapping_generator.h:729-824)
  bool sam_mode = false;
  // Hi-C split (drop-off) alignment (draft_mapping_generator.cc:410-555)
  bool split_mode = false;
  int match_score = 1;
  int mismatch_penalty = 4;
  int gap_open[2] = {6, 6};
  int gap_ext[2] = {1, 1};
};

int CollectHits(const IndexView& idx, const std::vector<Minimizer>& mzs,
                int max_seed_frequency, int repetitive_seed_frequency,
                std::vector<uint64_t>& pos_hits,
                std::vector<uint64_t>& neg_hits,
                uint32_t& repetitive_seed_length) {
  RepStats rep;
  rep.k = idx.k;
  rep.w = idx.w;
  for (const auto& m : mzs) {  // overlap the probe-table cache misses
    uint64_t s0 = ((m.hash * 0x9E3779B97F4A7C15ull) >> 1) & idx.ht_mask;
    __builtin_prefetch(&idx.ht[s0]);
  }
  // Two-pass: probe every minimizer first so the occurrence-array cache
  // misses of hit expansion overlap (random 8-byte touches into a
  // genome-sized array are latency-bound; the table prefetch above only
  // covers the probe itself).
  static thread_local std::vector<std::pair<int64_t, uint32_t>> ocs;
  ocs.resize(mzs.size());
  for (size_t i = 0; i < mzs.size(); ++i) {
    ocs[i] = idx.Lookup(mzs[i].hash);
    if (ocs[i].second) __builtin_prefetch(&idx.occurrences[ocs[i].first]);
  }
  for (size_t mi = 0; mi < mzs.size(); ++mi) {
    const auto& m = mzs[mi];
    auto oc = ocs[mi];
    if (oc.second == 0) continue;
    uint32_t read_pos = (uint32_t)(m.hit >> 1);
    if (oc.second == 1) {
      uint64_t ref_hit = idx.occurrences[oc.first];
      uint32_t ref_pos = (uint32_t)(ref_hit >> 1);
      bool same = (ref_hit & 1) == (m.hit & 1);
      uint64_t rid = ref_hit >> 33;
      uint32_t start = same ? (uint32_t)(ref_pos - read_pos)
                            : (uint32_t)(ref_pos + read_pos - idx.k + 1);
      uint64_t cand = (rid << 32) | start;
      if (same)
        pos_hits.push_back(cand);
      else
        neg_hits.push_back(cand);
      continue;
    }
    if ((int)oc.second < max_seed_frequency) {
      for (uint32_t oi = 0; oi < oc.second; ++oi) {
        uint64_t ref_hit = idx.occurrences[oc.first + oi];
        uint32_t ref_pos = (uint32_t)(ref_hit >> 1);
        bool same = (ref_hit & 1) == (m.hit & 1);
        uint64_t rid = ref_hit >> 33;
        uint32_t start = same ? (uint32_t)(ref_pos - read_pos)
                              : (uint32_t)(ref_pos + read_pos - idx.k + 1);
        uint64_t cand = (rid << 32) | start;
        if (same)
          pos_hits.push_back(cand);
        else
          neg_hits.push_back(cand);
      }
    }
    if ((int)oc.second >= repetitive_seed_frequency) rep.Update(read_pos);
  }
  std::sort(pos_hits.begin(), pos_hits.end());
  std::sort(neg_hits.begin(), neg_hits.end());
  repetitive_seed_length = rep.length;
  return rep.count;
}

void ClusterHits(int error_threshold, int num_seeds_required,
                 uint32_t num_minimizers, std::vector<uint64_t>& hits,
                 std::vector<Candidate>& candidates) {
  hits.push_back(kUmax);
  if (hits.size() <= 1) {
    hits.pop_back();
    return;
  }
  int minimizer_count = 1, equal_count = 1, best_equal_count = 1;
  uint64_t previous_hit = hits[0];
  uint32_t prev_rid = (uint32_t)(previous_hit >> 32);
  uint32_t prev_pos = (uint32_t)previous_hit;
  uint64_t best_local_hit = hits[0];
  for (size_t pi = 1; pi < hits.size(); ++pi) {
    uint64_t cur = hits[pi];
    uint32_t cur_rid = (uint32_t)(cur >> 32);
    uint32_t cur_pos = (uint32_t)cur;
    if (cur_rid != prev_rid ||
        cur_pos > (uint32_t)(prev_pos + error_threshold) ||
        ((uint32_t)minimizer_count >= num_minimizers &&
         cur_pos > (uint32_t)((uint32_t)best_local_hit + error_threshold))) {
      if (minimizer_count >= num_seeds_required)
        candidates.push_back(
            {best_local_hit, (uint8_t)(best_equal_count & 0xFF)});
      minimizer_count = 1;
      equal_count = 1;
      best_equal_count = 1;
      best_local_hit = cur;
    } else {
      if (cur == best_local_hit) {
        ++equal_count;
        ++best_equal_count;
      } else if (cur == previous_hit) {
        ++equal_count;
        if (equal_count > best_equal_count) {
          best_local_hit = previous_hit;
          best_equal_count = equal_count;
        }
      } else {
        equal_count = 1;
      }
      ++minimizer_count;
    }
    previous_hit = cur;
    prev_rid = cur_rid;
    prev_pos = cur_pos;
  }
  hits.pop_back();
}

void GenerateCandidates(const IndexView& idx, const MappingParams& mp,
                        SeedState& st) {
  st.positive_hits.clear();
  st.negative_hits.clear();
  st.repetitive_seed_length = 0;
  int rep_count =
      CollectHits(idx, st.minimizers, mp.f0, mp.f0, st.positive_hits,
                  st.negative_hits, st.repetitive_seed_length);
  bool use_high_frequency = false;
  if (st.positive_hits.empty() && st.negative_hits.empty()) {
    st.repetitive_seed_length = 0;
    rep_count = CollectHits(idx, st.minimizers, mp.f1, mp.f0,
                            st.positive_hits, st.negative_hits,
                            st.repetitive_seed_length);
    use_high_frequency = true;
    if (st.positive_hits.empty() || st.negative_hits.empty())
      use_high_frequency = false;
  }
  int num_required = (int)st.minimizers.size() - rep_count;
  if (num_required < 1) num_required = 1;
  if (num_required > mp.min_num_seeds) num_required = mp.min_num_seeds;
  if (use_high_frequency) num_required = mp.min_num_seeds;
  ClusterHits(mp.error_threshold, num_required, st.minimizers.size(),
              st.positive_hits, st.positive_candidates);
  ClusterHits(mp.error_threshold, num_required, st.minimizers.size(),
              st.negative_hits, st.negative_candidates);
}

// ------------------------ supplement (mate rescue) ------------------------

int RescueOneStrand(const IndexView& idx, const MappingParams& mp,
                    bool strand_negative, uint32_t search_range,
                    const std::vector<Minimizer>& minimizers,
                    const std::vector<Candidate>& mate_candidates,
                    uint32_t& repetitive_seed_length,
                    std::vector<uint64_t>& hits) {
  int max_count = 0, best_candidate_num = 0;
  for (const auto& c : mate_candidates) {
    if (c.count > max_count) {
      max_count = c.count;
      best_candidate_num = 1;
    } else if (c.count == max_count) {
      ++best_candidate_num;
    }
  }
  bool too_many = best_candidate_num >= 300 ||
                  mate_candidates.size() > (size_t)mp.f0;
  bool too_many_low = max_count <= mp.min_num_seeds &&
                      best_candidate_num >= 200;
  if (too_many || too_many_low) return -max_count;

  std::vector<std::pair<uint64_t, uint64_t>> bounds;
  for (const auto& c : mate_candidates)
    if (c.count == max_count) {
      uint64_t s = c.position < search_range ? 0 : c.position - search_range;
      bounds.push_back({s, c.position + search_range});
    }
  if (bounds.empty()) return max_count;
  size_t bs = 1;
  for (size_t bi = 1; bi < bounds.size(); ++bi) {
    if (bounds[bs - 1].second < bounds[bi].first)
      bounds[bs++] = bounds[bi];
    else
      bounds[bs - 1].second = bounds[bi].second;
  }
  bounds.resize(bs);

  RepStats rep;
  rep.k = idx.k;
  rep.w = idx.w;
  bool want_same = !strand_negative;
  for (const auto& m : minimizers) {
    auto oc = idx.Lookup(m.hash);
    if (oc.second == 0) continue;
    uint32_t read_pos = (uint32_t)(m.hit >> 1);
    if (oc.second == 1) {
      uint64_t ref_hit = idx.occurrences[oc.first];
      bool same = (ref_hit & 1) == (m.hit & 1);
      if (same == want_same) {
        uint32_t ref_pos = (uint32_t)(ref_hit >> 1);
        uint64_t rid = ref_hit >> 33;
        uint32_t start = same ? (uint32_t)(ref_pos - read_pos)
                              : (uint32_t)(ref_pos + read_pos - idx.k + 1);
        hits.push_back((rid << 32) | start);
      }
      continue;
    }
    int num_occ = (int)oc.second;
    const uint64_t* occ = idx.occurrences + oc.first;
    int prev_l = 0;
    for (size_t bi = 0; bi < bounds.size(); ++bi) {
      // the reference's manual binary search (index.cc:444-462): its final
      // midpoint can land one entry before the boundary start
      int l = prev_l, m2 = 0, r = num_occ - 1;
      uint64_t boundary = bounds[bi].first;
      while (l <= r) {
        m2 = (l + r) / 2;
        uint64_t cand_pos = occ[m2] >> 1;
        if (cand_pos < boundary)
          l = m2 + 1;
        else if (cand_pos > boundary)
          r = m2 - 1;
        else
          break;
      }
      prev_l = m2;
      for (int oi = m2; oi < num_occ; ++oi) {
        uint64_t ref_hit = occ[oi];
        if ((ref_hit >> 1) > bounds[bi].second) break;
        bool same = (ref_hit & 1) == (m.hit & 1);
        if (same == want_same) {
          uint32_t ref_pos = (uint32_t)(ref_hit >> 1);
          uint64_t rid = ref_hit >> 33;
          uint32_t start = same
                               ? (uint32_t)(ref_pos - read_pos)
                               : (uint32_t)(ref_pos + read_pos - idx.k + 1);
          hits.push_back((rid << 32) | start);
        }
      }
    }
    if (num_occ >= mp.f0) rep.Update(read_pos);
  }
  std::sort(hits.begin(), hits.end());
  repetitive_seed_length = rep.length;
  return max_count;
}

void MergeCandidates(int error_threshold, std::vector<Candidate>& c1,
                     std::vector<Candidate>& c2,
                     std::vector<Candidate>& buffer) {
  if (c1.empty()) {
    c1.swap(c2);
    return;
  }
  buffer.clear();
  size_t i = 0, j = 0;
  auto push = [&](const Candidate& c) {
    if (buffer.empty() ||
        c.position > buffer.back().position + error_threshold)
      buffer.push_back(c);
  };
  while (i < c1.size() && j < c2.size()) {
    if (c1[i].position == c2[j].position) {
      if (buffer.empty() ||
          c1[i].position > buffer.back().position + error_threshold)
        buffer.push_back(c1[i].count > c2[j].count ? c1[i] : c2[j]);
      ++i;
      ++j;
    } else if (c1[i].position < c2[j].position) {
      push(c1[i]);
      ++i;
    } else {
      push(c2[j]);
      ++j;
    }
  }
  while (i < c1.size()) push(c1[i++]);
  while (j < c2.size()) push(c2[j++]);
  c1.swap(buffer);
}

int SupplementCandidates(const IndexView& idx, const MappingParams& mp,
                         uint32_t search_range, SeedState& s1,
                         SeedState& s2) {
  std::vector<Candidate> aug_p1, aug_n1, aug_p2, aug_n2;
  int ret = 0;
  for (int mate = 0; mate <= 1; ++mate) {
    SeedState& st = mate == 0 ? s1 : s2;
    SeedState& mt = mate == 0 ? s2 : s1;
    std::vector<Candidate>& aug_pos = mate == 0 ? aug_p1 : aug_p2;
    std::vector<Candidate>& aug_neg = mate == 0 ? aug_n1 : aug_n2;

    uint32_t mm_count = st.minimizers.size();
    bool augment = true;
    for (const auto& c : st.positive_candidates)
      if (c.count >= mm_count / 2) {
        augment = false;
        break;
      }
    if (augment)
      for (const auto& c : st.negative_candidates)
        if (c.count >= mm_count / 2) {
          augment = false;
          break;
        }
    if (!augment) continue;

    st.positive_hits.clear();
    st.negative_hits.clear();
    int pos_res = 0, neg_res = 0;
    if (!mt.positive_candidates.empty()) {
      pos_res = RescueOneStrand(idx, mp, true, search_range, st.minimizers,
                                mt.positive_candidates,
                                st.repetitive_seed_length, st.negative_hits);
      ClusterHits(mp.error_threshold, 1, mm_count, st.negative_hits, aug_neg);
    }
    if (!mt.negative_candidates.empty()) {
      neg_res = RescueOneStrand(idx, mp, false, search_range, st.minimizers,
                                mt.negative_candidates,
                                st.repetitive_seed_length, st.positive_hits);
      ClusterHits(mp.error_threshold, 1, mm_count, st.positive_hits, aug_pos);
    }
    if (((pos_res < 0 && neg_res > 0 && -pos_res >= neg_res) ||
         (pos_res > 0 && neg_res < 0 && pos_res <= -neg_res)) &&
        st.positive_candidates.size() + st.negative_candidates.size() == 0)
      ret = 1;
  }
  if (!aug_p1.empty())
    MergeCandidates(mp.error_threshold, s1.positive_candidates, aug_p1,
                    s1.pos_buf);
  if (!aug_n1.empty())
    MergeCandidates(mp.error_threshold, s1.negative_candidates, aug_n1,
                    s1.neg_buf);
  if (!aug_p2.empty())
    MergeCandidates(mp.error_threshold, s2.positive_candidates, aug_p2,
                    s2.pos_buf);
  if (!aug_n2.empty())
    MergeCandidates(mp.error_threshold, s2.negative_candidates, aug_n2,
                    s2.neg_buf);
  return ret;
}

void ReduceOneDirection(uint32_t dist, const std::vector<Candidate>& c1,
                        const std::vector<Candidate>& c2,
                        std::vector<Candidate>& f1,
                        std::vector<Candidate>& f2) {
  size_t i1 = 0, i2 = 0;
  int nu1 = 0, nu2 = 0;
  const int threshold = 5;
  int mc1 = 6, mc2 = 6;
  size_t prev_end_i2 = 0;
  while (i1 < c1.size() && i2 < c2.size()) {
    if (c1[i1].position > c2[i2].position + dist) {
      if (i2 >= prev_end_i2 && nu2 < threshold &&
          (c1[i1].position >> 32) == (c2[i2].position >> 32) &&
          c2[i2].count >= mc2) {
        f2.push_back(c2[i2]);
        ++nu2;
      }
      ++i2;
    } else if (c2[i2].position > c1[i1].position + dist) {
      if (nu1 < threshold &&
          (c1[i1].position >> 32) == (c2[i2].position >> 32) &&
          c1[i1].count >= mc1) {
        f1.push_back(c1[i1]);
        ++nu1;
      }
      ++i1;
    } else {
      f1.push_back(c1[i1]);
      if (c1[i1].count > mc1) mc1 = c1[i1].count;
      size_t cur_i2 = i2;
      while (cur_i2 < c2.size() &&
             c2[cur_i2].position <= c1[i1].position + dist) {
        if (cur_i2 >= prev_end_i2) {
          f2.push_back(c2[cur_i2]);
          if (c2[cur_i2].count > mc2) mc2 = c2[cur_i2].count;
        }
        ++cur_i2;
      }
      prev_end_i2 = cur_i2;
      ++i1;
    }
  }
}

// ------------------------------ cache ------------------------------

constexpr int kFingerPrintSize = 103;
constexpr uint32_t kHeadMmSize = 1u << 22;
constexpr uint32_t kHeadMmMask = kHeadMmSize - 1;

struct CacheSlot {
  std::vector<uint64_t> minimizers;
  std::vector<uint8_t> strands;
  std::vector<int> offsets;
  std::vector<Candidate> positive_candidates, negative_candidates;
  uint32_t repetitive_seed_length = 0;
  int weight = 0;
  uint16_t finger_print_cnt[kFingerPrintSize] = {0};
  int finger_print_cnt_sum = 0;
  int activated = 0;
};

struct MMCache {
  int64_t cache_size;
  int kmer_length;
  bool debug = false;  // --debug-cache (mmcache.hpp:300-330 verbose mode)
  // sparse: only touched slots materialize (the reference eagerly allocates
  // all slots, which is where its multi-second startup goes)
  std::unordered_map<int64_t, CacheSlot> slots;
  std::vector<uint64_t> head_mm;

  MMCache(int64_t size, int k)
      : cache_size(size), kmer_length(k), head_mm(kHeadMmSize, 0) {}

  int Match(const CacheSlot& s, const std::vector<Minimizer>& mzs) const {
    if (s.minimizers.size() != mzs.size() || s.minimizers.empty()) return 0;
    int size = (int)mzs.size();
    int i, j;
    for (i = 0; i < size; ++i)
      if (s.minimizers[i] != mzs[i].hash ||
          (mzs[i].hit & 1) != s.strands[i])
        break;
    if (i >= size) {
      for (i = 0; i < size - 1; ++i)
        if (s.offsets[i] != (int)(mzs[i + 1].hit >> 1) -
                                (int)(mzs[i].hit >> 1))
          break;
      if (i >= size - 1) return 1;
    }
    for (i = 0, j = size - 1; i < size; ++i, --j)
      if (s.minimizers[i] != mzs[j].hash ||
          (mzs[j].hit & 1) == s.strands[i])
        break;
    if (i >= size) {
      for (i = 0, j = size - 1; i < size - 1; ++i, --j)
        if (s.offsets[i] !=
            (int)(mzs[j].hit >> 1) - (int)(mzs[j - 1].hit >> 1))
          break;
      if (i >= size - 1) return -1;
    }
    return 0;
  }

  int Query(const std::vector<Minimizer>& mzs, uint32_t read_len,
            std::vector<Candidate>& pos, std::vector<Candidate>& neg,
            uint32_t& rep_len) {
    int msize = (int)mzs.size();
    if (msize == 0) return -1;
    uint64_t h0 = mzs[0].hash;
    if ((head_mm[(h0 >> 6) & kHeadMmMask] & (1ull << (h0 & 0x3f))) == 0)
      return -1;
    uint64_t h = msize == 1 ? h0 : h0 + mzs[msize - 1].hash;
    int64_t hidx = (int64_t)(h % (uint64_t)cache_size);
    auto it = slots.find(hidx);
    if (it == slots.end()) return -1;
    const CacheSlot& s = it->second;
    int dir = Match(s, mzs);
    if (dir == 0) return -1;
    if (dir == 1) {
      int shift = (int)(mzs[0].hit >> 1);
      pos = s.positive_candidates;
      for (auto& c : pos) {
        uint64_t rid = c.position >> 32;
        int rpos = (int)(uint32_t)c.position;
        c.position = (rid << 32) + (uint32_t)(rpos - shift);
      }
      neg = s.negative_candidates;
      for (auto& c : neg) c.position += (uint64_t)shift;
      rep_len = s.repetitive_seed_length;
      return (int)hidx;
    }
    int shift = (int)read_len - (int)(mzs[msize - 1].hit >> 1) - 1 +
                kmer_length - 1;
    pos = s.negative_candidates;
    for (auto& c : pos) {
      uint64_t rid = c.position >> 32;
      int rpos = (int)(uint32_t)c.position;
      c.position = (rid << 32) + (uint32_t)(rpos + shift - (int)read_len + 1);
    }
    neg = s.positive_candidates;
    for (auto& c : neg)
      c.position = c.position - (uint64_t)shift + read_len - 1;
    rep_len = s.repetitive_seed_length;
    return (int)hidx;
  }

  void Update(const std::vector<Minimizer>& mzs,
              const std::vector<Candidate>& pos,
              const std::vector<Candidate>& neg, uint32_t rep_len) {
    int msize = (int)mzs.size();
    if (msize == 0) return;
    uint64_t h0 = mzs[0].hash;
    uint64_t h, f;
    if (msize == 1) {
      h = f = h0;
    } else {
      h = h0 + mzs[msize - 1].hash;
      f = h0 ^ mzs[msize - 1].hash;
    }
    int64_t hidx = (int64_t)(h % (uint64_t)cache_size);
    int fp = (int)(f % kFingerPrintSize);
    CacheSlot& s = slots[hidx];
    ++s.finger_print_cnt[fp];
    ++s.finger_print_cnt_sum;
    if (s.finger_print_cnt_sum > 100) return;
    if (s.finger_print_cnt_sum < 10 ||
        (int)s.finger_print_cnt[fp] * 5 < s.finger_print_cnt_sum)
      return;
    int dir = Match(s, mzs);
    if (dir != 0)
      ++s.weight;
    else
      --s.weight;
    s.activated = 1;
    if (s.weight >= 0) return;
    s.weight = 1;
    int shift = (int)(mzs[0].hit >> 1);
    for (const auto& c : pos)
      if ((int)(uint32_t)c.position < kmer_length + shift) {
        s.offsets.clear();
        s.strands.clear();
        s.minimizers.clear();
        return;
      }
    int last_pos = (int)(mzs[msize - 1].hit >> 1);
    for (const auto& c : neg)
      if ((int)(uint32_t)c.position - last_pos < kmer_length + shift) {
        s.offsets.clear();
        s.strands.clear();
        s.minimizers.clear();
        return;
      }
    s.minimizers.resize(msize);
    s.strands.resize(msize);
    s.offsets.resize(msize - 1);
    for (int i = 0; i < msize; ++i) {
      s.minimizers[i] = mzs[i].hash;
      s.strands[i] = (uint8_t)(mzs[i].hit & 1);
    }
    for (int i = 0; i < msize - 1; ++i)
      s.offsets[i] = (int)(mzs[i + 1].hit >> 1) - (int)(mzs[i].hit >> 1);
    s.positive_candidates = pos;
    s.negative_candidates = neg;
    for (auto& c : s.positive_candidates) c.position += (uint64_t)shift;
    for (auto& c : s.negative_candidates) c.position -= (uint64_t)shift;
    s.repetitive_seed_length = rep_len;
    if (debug) {
      // candidate-stored trace, mmcache.hpp:300-330 format
      printf("[DEBUG][CACHE][1] hidx = %lld\n", (long long)hidx);
      printf("[DEBUG][CACHE][2] pos.size() = %zu , neg.size() = %zu , "
             "msize = %d\n", s.positive_candidates.size(),
             s.negative_candidates.size(), msize);
      printf("[DEBUG][CACHE][3] ");
      for (const auto& mz : mzs) printf("%llu ", (unsigned long long)mz.hash);
      printf("\n");
      for (const auto& c : s.positive_candidates)
        printf("[DEBUG][CACHE][+] hidx = %lld , cand_ref_seq = %u , "
               "cand_ref_pos = %u , support = %u\n", (long long)hidx,
               (uint32_t)(c.position >> 32), (uint32_t)c.position,
               (unsigned)c.count);
      for (const auto& c : s.negative_candidates)
        printf("[DEBUG][CACHE][-] hidx = %lld , cand_ref_seq = %u , "
               "cand_ref_pos = %u , support = %u\n", (long long)hidx,
               (uint32_t)(c.position >> 32), (uint32_t)c.position,
               (unsigned)c.count);
    }
    uint64_t hl = mzs[msize - 1].hash;
    head_mm[(h0 >> 6) & kHeadMmMask] |= (1ull << (h0 & 0x3f));
    head_mm[(hl >> 6) & kHeadMmMask] |= (1ull << (hl & 0x3f));
  }

  // Per-slot stats dump (mmcache.hpp:371-386): weight, fingerprint-count
  // sum, candidate count, activated, max fingerprint count, then every
  // fingerprint bin. Untouched (never-materialized) slots print as zeros.
  void PrintStats() const {
    static const CacheSlot kEmpty;
    for (int64_t i = 0; i < cache_size; ++i) {
      auto it = slots.find(i);
      const CacheSlot& s = it == slots.end() ? kEmpty : it->second;
      printf("%d %d %d %d ", s.weight, s.finger_print_cnt_sum,
             (int)(s.positive_candidates.size() +
                   s.negative_candidates.size()),
             s.activated);
      int tmp = 0;
      for (int j = 0; j < kFingerPrintSize; ++j)
        if ((int)s.finger_print_cnt[j] > tmp) tmp = s.finger_print_cnt[j];
      printf("%d", tmp);
      for (int j = 0; j < kFingerPrintSize; ++j)
        printf(" %u", (unsigned)s.finger_print_cnt[j]);
      printf("\n");
    }
  }
};

// --------------------------- Myers verification ---------------------------

// Multi-candidate Myers: NL reference windows (one per lane) against one
// read, u32 band words in auto-vectorized lanes (the VPU-lane analog of
// the reference's 4/8-pattern SSE kernels, alignment.cc:378-655 -- wider
// here: AVX2 fits 8 u32 lanes where the reference packed 8 int16). Lanes
// whose boundary count ever exceeds 3e report e+1, exactly like the
// scalar early exit; their end positions are unused by callers.
template <int NL>
static void BandedAlignLanes(int e, const char* const* pats,
                             const char* text, int L, int* errs,
                             int* ends) {
  uint32_t peq[5][NL];
  for (int c = 0; c < 5; ++c)
    for (int l = 0; l < NL; ++l) peq[c][l] = 0;
  for (int i = 0; i < 2 * e; ++i)
    for (int l = 0; l < NL; ++l)
      peq[kCharToCode[(uint8_t)pats[l][i]]][l] |= 1u << i;
  const uint32_t highest = 1u << (2 * e);
  const int32_t limit = 3 * e;
  uint32_t vp[NL], vn[NL], dead[NL];
  int32_t nerr[NL];
  for (int l = 0; l < NL; ++l) {
    vp[l] = vn[l] = dead[l] = 0;
    nerr[l] = 0;
  }
  uint8_t pcs[NL];
  for (int i = 0; i < L; ++i) {
    for (int l = 0; l < NL; ++l)
      pcs[l] = kCharToCode[(uint8_t)pats[l][i + 2 * e]];
    for (int c = 0; c < 5; ++c) {
      uint32_t* pq = peq[c];
#pragma omp simd
      for (int l = 0; l < NL; ++l)
        pq[l] |= (pcs[l] == (uint8_t)c) ? highest : 0u;
    }
    const uint32_t* pq = peq[kCharToCode[(uint8_t)text[i]]];
#pragma omp simd
    for (int l = 0; l < NL; ++l) {
      uint32_t x = pq[l] | vn[l];
      uint32_t d0 = ((vp[l] + (x & vp[l])) ^ vp[l]) | x;
      uint32_t hn = vp[l] & d0;
      uint32_t hp = vn[l] | ~(vp[l] | d0);
      uint32_t x2 = d0 >> 1;
      vn[l] = x2 & hp;
      vp[l] = hn | ~(x2 | hp);
      nerr[l] += 1 - (int32_t)(d0 & 1);
      dead[l] |= (uint32_t)(nerr[l] > limit);
    }
    for (int c = 0; c < 5; ++c) {
      uint32_t* q = peq[c];
#pragma omp simd
      for (int l = 0; l < NL; ++l) q[l] >>= 1;
    }
    if ((i & 15) == 15) {
      uint32_t all = 1;
      for (int l = 0; l < NL; ++l) all &= dead[l];
      if (all) break;
    }
  }
  const int band_start = L - 1;
  for (int l = 0; l < NL; ++l) {
    if (dead[l]) {
      errs[l] = e + 1;
      ends[l] = band_start;
      continue;
    }
    int num_err = nerr[l];
    int min_err = num_err;
    int end = band_start;
    for (int i = 0; i < 2 * e; ++i) {
      num_err += (vp[l] >> i) & 1;
      num_err -= (vn[l] >> i) & 1;
      if (num_err < min_err || (num_err == min_err && i + 1 == e)) {
        min_err = num_err;
        end = band_start + 1 + i;
      }
    }
    errs[l] = min_err;
    ends[l] = end;
  }
}

// Band word W: uint32_t holds 2e+1 <= 31 band bits (e < 16, the
// reference's only case, alignment.cc:144-150); uint64_t extends the
// scalar kernels to e <= 31 where the reference falls back to nothing.
template <typename W>
static int BandedAlignT(int e, const char* pattern, const char* text, int L,
                        int* end_position) {
  W peq[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 2 * e; ++i)
    peq[kCharToCode[(uint8_t)pattern[i]]] |= (W)1 << i;
  W highest = (W)1 << (2 * e);
  W vp = 0, vn = 0;
  int num_err = 0;
  for (int i = 0; i < L; ++i) {
    peq[kCharToCode[(uint8_t)pattern[i + 2 * e]]] |= highest;
    W x = peq[kCharToCode[(uint8_t)text[i]]] | vn;
    W d0 = ((vp + (x & vp)) ^ vp) | x;
    W hn = vp & d0;
    W hp = vn | ~(vp | d0);
    x = d0 >> 1;
    vn = x & hp;
    vp = hn | ~(x | hp);
    num_err += 1 - (int)(d0 & 1);
    if (num_err > 3 * e) return e + 1;
    for (int ai = 0; ai < 5; ++ai) peq[ai] >>= 1;
  }
  int band_start = L - 1;
  int min_err = num_err;
  *end_position = band_start;
  for (int i = 0; i < 2 * e; ++i) {
    num_err += (int)((vp >> i) & 1);
    num_err -= (int)((vn >> i) & 1);
    if (num_err < min_err || (num_err == min_err && i + 1 == e)) {
      min_err = num_err;
      *end_position = band_start + 1 + i;
    }
  }
  return min_err;
}

int BandedAlign(int e, const char* pattern, const char* text, int L,
                int* end_position) {
  if (e < 16) return BandedAlignT<uint32_t>(e, pattern, text, L,
                                            end_position);
  return BandedAlignT<uint64_t>(e, pattern, text, L, end_position);
}

template <typename W>
static void BandedTracebackT(int e, int min_num_errors, const char* pattern,
                             const char* text, int L, int* start_position) {
  if (min_num_errors == 0) {
    *start_position = e;
    return;
  }
  int error_count = 0;
  for (int i = 0; i < L; ++i)
    if (pattern[i + e] != text[i]) ++error_count;
  if (error_count == min_num_errors) {
    *start_position = e;
    return;
  }
  W peq[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 2 * e; ++i)
    peq[kCharToCode[(uint8_t)pattern[L - 1 + 2 * e - i]]] |= (W)1 << i;
  W highest = (W)1 << (2 * e);
  W vp = 0, vn = 0;
  int num_err = 0;
  for (int i = 0; i < L; ++i) {
    peq[kCharToCode[(uint8_t)pattern[L - 1 - i]]] |= highest;
    W x = peq[kCharToCode[(uint8_t)text[L - 1 - i]]] | vn;
    W d0 = ((vp + (x & vp)) ^ vp) | x;
    W hn = vp & d0;
    W hp = vn | ~(vp | d0);
    x = d0 >> 1;
    vn = x & hp;
    vp = hn | ~(x | hp);
    num_err += 1 - (int)(d0 & 1);
    for (int ai = 0; ai < 5; ++ai) peq[ai] >>= 1;
  }
  *start_position = 2 * e;
  for (int i = 0; i < 2 * e; ++i) {
    num_err += (int)((vp >> i) & 1);
    num_err -= (int)((vn >> i) & 1);
    if (num_err == min_num_errors) {
      *start_position = 2 * e - (1 + i);
      if (i + 1 == e) return;
    }
  }
}

void BandedTraceback(int e, int min_num_errors, const char* pattern,
                     const char* text, int L, int* start_position) {
  if (e < 16)
    BandedTracebackT<uint32_t>(e, min_num_errors, pattern, text, L,
                               start_position);
  else
    BandedTracebackT<uint64_t>(e, min_num_errors, pattern, text, L,
                               start_position);
}

// ------------------------- verification per read -------------------------

struct VerifyState {
  std::vector<DraftMapping> positive_mappings, negative_mappings;
  // split mode: packed (actual_errors<<24 | gap<<16 | read_mapping_length)
  // parallel to the mapping lists (mapping_metadata.h:144-165)
  std::vector<uint32_t> positive_split_sites, negative_split_sites;
  int min_num_errors, num_best_mappings, second_min_num_errors,
      num_second_best_mappings;
  void Reset(int e) {
    positive_mappings.clear();
    negative_mappings.clear();
    positive_split_sites.clear();
    negative_split_sites.clear();
    min_num_errors = e + 1;
    num_best_mappings = 0;
    second_min_num_errors = e + 1;
    num_second_best_mappings = 0;
  }
  size_t NumDraft() const {
    return positive_mappings.size() + negative_mappings.size();
  }
};

struct RefView {
  const char* bytes;
  const int64_t* offsets;  // num_refs + 1
  int32_t num_refs;
  inline const char* Seq(uint32_t rid) const { return bytes + offsets[rid]; }
  inline int64_t Len(uint32_t rid) const {
    return offsets[rid + 1] - offsets[rid];
  }
};

// ------------------- semi-global alignment with CIGAR -------------------
// Affine-gap banded semi-global DP with free leading/trailing reference
// gaps, query = reference window, target = read; direction-matrix
// backtrack. Same recurrence and tie-breaking as the SAM path oracle
// (mapping/ksw.py, itself equivalent to the vendored klib ksw_semi_global3,
// ksw.cc:505-633).

constexpr int kMinusInf = -0x40000000;

inline void PushCigar(std::vector<uint32_t>& cigar, uint32_t op,
                      uint32_t length) {
  if (cigar.empty() || (cigar.back() & 0xF) != op)
    cigar.push_back(length << 4 | op);
  else
    cigar.back() += length << 4;
}

struct KswScratch {
  std::vector<uint8_t> z, qcodes;
  std::vector<int> h, e;
  std::vector<uint32_t> rev;
};

static void KswSemiGlobal3(int qlen, const char* query, int tlen,
                           const char* target, const MappingParams& mp,
                           int w, KswScratch& ks,
                           std::vector<uint32_t>& cigar, int* start_pos,
                           int* end_pos) {
  const int o_del = mp.gap_open[0], o_ins = mp.gap_open[1];
  const int e_del = mp.gap_ext[0], e_ins = mp.gap_ext[1];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int n_col = qlen < 2 * w + 1 ? qlen : 2 * w + 1;
  ks.z.resize((size_t)n_col * tlen);
  ks.h.assign(qlen + 2, kMinusInf);
  ks.e.assign(qlen + 2, kMinusInf);
  ks.h[0] = 0;
  int lim = qlen < w ? qlen : w;
  for (int j = 1; j <= lim; ++j) ks.h[j] = 0;

  // hoist the per-cell decode/compare chain: query codes once per call,
  // match/mismatch/ambiguous as one 5x5 table lookup per cell
  ks.qcodes.resize(qlen);
  for (int j = 0; j < qlen; ++j)
    ks.qcodes[j] = kCharToCode[(uint8_t)query[j]];
  int16_t score_tbl[25];
  for (int a = 0; a < 5; ++a)
    for (int b = 0; b < 5; ++b)
      score_tbl[a * 5 + b] =
          (a == 4 || b == 4) ? 0
          : (a == b ? (int16_t)mp.match_score
                    : (int16_t)-mp.mismatch_penalty);

  // split row passes: the (m, e) recurrences depend only on the previous
  // row and auto-vectorize over the band; the serial pass carries only
  // the short f/h1 chain. Bit-exact with the classic single loop (the
  // traceback byte's tie directions are preserved); measured 1.8x on
  // the 100x18 bands SAM mode uses.
  int mbuf[256], hme[256];
  uint8_t dflag[256];
  for (int i = 0; i < tlen; ++i) {
    int beg = i;
    int end = i + w + 1 < qlen ? i + w + 1 : qlen;
    const int width = end - beg;  // <= w+1 = 2e+2 <= 64 (e <= 31)
    assert(width <= 256);
    uint8_t* zi = ks.z.data() + (size_t)i * n_col;
    const int16_t* srow = score_tbl + 5 * kCharToCode[(uint8_t)target[i]];
    const uint8_t* qv = ks.qcodes.data() + beg;
    int* hrow = ks.h.data() + beg;
    int* erow = ks.e.data() + beg;
#pragma omp simd
    for (int j = 0; j < width; ++j) {
      int m = hrow[j] + srow[qv[j]];
      int e = erow[j];
      int ge = e > m;
      mbuf[j] = m;
      hme[j] = ge ? e : m;
      int t1 = m - oe_del;
      int e2 = e - e_del;
      int ke = e2 > t1;
      erow[j] = ke ? e2 : t1;
      dflag[j] = (uint8_t)(ge | (ke << 2));
    }
    int f = kMinusInf;
    int h1 = beg == 0 ? -(o_del + e_del * (i + 1)) : kMinusInf;
    for (int j = 0; j < width; ++j) {
      int hh = hme[j];
      int gf = f > hh;
      int d = dflag[j];
      d = gf ? (2 | (d & 4)) : d;
      hh = gf ? f : hh;
      hrow[j] = h1;
      h1 = hh;
      int t2 = mbuf[j] - oe_ins;
      int f2 = f - e_ins;
      int kf = f2 > t2;
      f = kf ? f2 : t2;
      zi[j] = (uint8_t)(d | (kf << 5));
    }
    hrow[width] = h1;
    erow[width] = kMinusInf;
  }

  int score = ks.h[qlen];
  int max_score_position = qlen;
  for (int j = 1; j < w; ++j)
    if (ks.h[qlen - j] > score) {
      score = ks.h[qlen - j];
      max_score_position = qlen - j;
    }

  ks.rev.clear();
  int i = tlen - 1, k = max_score_position - 1, which = 0;
  while (i >= 0 && k >= 0) {
    which = (ks.z[(size_t)i * n_col + (k - i)] >> (which << 1)) & 3;
    if (which == 0) {
      PushCigar(ks.rev, 0, 1);
      --i;
      --k;
    } else if (which == 1) {
      PushCigar(ks.rev, 1, 1);
      --i;
    } else {
      PushCigar(ks.rev, 2, 1);
      --k;
    }
  }
  if (i >= 0) PushCigar(ks.rev, 1, i + 1);
  *start_pos = k + 1;
  *end_pos = max_score_position;
  cigar.assign(ks.rev.rbegin(), ks.rev.rend());
}

// NM / MD tag generation from the CIGAR (alignment.cc:85-139)
static int GenerateNMMD(const char* reference, const char* read,
                        int64_t mapping_start_position,
                        const std::vector<uint32_t>& cigar,
                        std::string& md) {
  int nm = 0;
  int num_matches = 0;
  int64_t read_position = 0;
  int64_t reference_position = mapping_start_position;
  md.clear();
  auto bases_equal = [](uint8_t rb, uint8_t qb) {
    if (rb == qb) return true;
    return rb >= 0x61 && rb <= 0x7A && (uint8_t)(rb - 0x20) == qb;
  };
  for (uint32_t c : cigar) {
    uint32_t op = c & 0xF, oplen = c >> 4;
    if (op == 0) {
      for (uint32_t x = 0; x < oplen; ++x) {
        if (bases_equal((uint8_t)reference[reference_position],
                        (uint8_t)read[read_position])) {
          ++num_matches;
        } else {
          ++nm;
          md += std::to_string(num_matches);
          num_matches = 0;
          md += reference[reference_position];
        }
        ++reference_position;
        ++read_position;
      }
    } else if (op == 1) {
      nm += oplen;
      read_position += oplen;
    } else if (op == 2) {
      nm += oplen;
      md += std::to_string(num_matches);
      num_matches = 0;
      md += '^';
      for (uint32_t x = 0; x < oplen; ++x)
        md += reference[reference_position++];
    }
  }
  md += std::to_string(num_matches);
  return nm;
}

// ---------------- split (drop-off) alignment kernels ----------------
// Ports of the reference's 5'/3' drop-off Myers variants
// (alignment.cc:197-376), gap-beginning extension (:24-83) and
// longest-match scan (:7-22), matching the host oracle
// (mapping/verify.py, mapping/select.py) exactly.

template <typename W>
static void BandedAlignDropoffT(int e, const char* pattern, const char* text,
                               int read_length, int* min_errors_out,
                               int* end_position_out,
                               int* read_mapping_length_out) {
  W peq[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 2 * e; ++i)
    peq[kCharToCode[(uint8_t)pattern[i]]] |= (W)1 << i;
  W highest = (W)1 << (2 * e);
  W vp = 0, vn = 0, prev_vp = 0, prev_vn = 0;
  int num_errors = 0, prev_num_errors = 0;
  bool fail_beginning = false;
  int i = 0;
  for (; i < read_length; ++i) {
    peq[kCharToCode[(uint8_t)pattern[i + 2 * e]]] |= highest;
    W x = peq[kCharToCode[(uint8_t)text[i]]] | vn;
    W d0 = ((vp + (x & vp)) ^ vp) | x;
    W hn = vp & d0;
    W hp = vn | ~(vp | d0);
    x = d0 >> 1;
    prev_vn = vn;
    prev_vp = vp;
    vn = x & hp;
    vp = hn | ~(x | hp);
    prev_num_errors = num_errors;
    num_errors += 1 - (int)(d0 & 1);
    if (num_errors > 2 * e) {
      if (i < 4 * e && i < read_length / 2) fail_beginning = true;
      break;
    }
    for (int ai = 0; ai < 5; ++ai) peq[ai] >>= 1;
  }
  if (i < read_length) {
    num_errors = prev_num_errors;
    vn = prev_vn;
    vp = prev_vp;
  } else {
    i = read_length;
  }
  int band_start = i - 1;
  int min_errors = num_errors;
  int read_mapping_length = i;
  int end_position = band_start;
  for (int j = 0; j < 2 * e; ++j) {
    num_errors += (int)((vp >> j) & 1);
    num_errors -= (int)((vn >> j) & 1);
    if (num_errors < min_errors ||
        (num_errors == min_errors && j + 1 == e)) {
      min_errors = num_errors;
      end_position = band_start + 1 + j;
    }
  }
  if (fail_beginning ||
      (read_length > 60 && end_position + 1 - e - min_errors < 30))
    end_position = -end_position;
  *min_errors_out = min_errors;
  *end_position_out = end_position;
  *read_mapping_length_out = read_mapping_length;
}

static void BandedAlignDropoff(int e, const char* pattern, const char* text,
                   int read_length, int* min_errors_out,
                   int* end_position_out, int* read_mapping_length_out) {
  if (e < 16)
    BandedAlignDropoffT<uint32_t>(e, pattern, text, read_length, min_errors_out,
                      end_position_out, read_mapping_length_out);
  else
    BandedAlignDropoffT<uint64_t>(e, pattern, text, read_length, min_errors_out,
                      end_position_out, read_mapping_length_out);
}

template <typename W>
static void BandedAlignDropoff3EndT(int e, const char* pattern,
                                   const char* text, int read_length,
                                   int* min_errors_out,
                                   int* end_position_out,
                                   int* read_mapping_length_out) {
  W peq[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 2 * e; ++i)
    peq[kCharToCode[(uint8_t)pattern[read_length + 2 * e - 1 - i]]] |=
        (W)1 << i;
  W highest = (W)1 << (2 * e);
  W vp = 0, vn = 0, prev_vp = 0, prev_vn = 0;
  int num_errors = 0, prev_num_errors = 0;
  bool fail_beginning = false;
  int i = 0;
  for (; i < read_length; ++i) {
    peq[kCharToCode[(uint8_t)pattern[read_length - 1 - i]]] |= highest;
    W x = peq[kCharToCode[(uint8_t)text[read_length - 1 - i]]] | vn;
    W d0 = ((vp + (x & vp)) ^ vp) | x;
    W hn = vp & d0;
    W hp = vn | ~(vp | d0);
    x = d0 >> 1;
    prev_vn = vn;
    prev_vp = vp;
    vn = x & hp;
    vp = hn | ~(x | hp);
    prev_num_errors = num_errors;
    num_errors += 1 - (int)(d0 & 1);
    if (num_errors > 2 * e) {
      if (i < 4 * e && i < read_length / 2) fail_beginning = true;
      break;
    }
    for (int ai = 0; ai < 5; ++ai) peq[ai] >>= 1;
  }
  if (i < read_length) {
    num_errors = prev_num_errors;
    vn = prev_vn;
    vp = prev_vp;
  } else {
    i = read_length;
  }
  int band_start = i - 1;
  int min_errors = num_errors;
  int read_mapping_length = i;
  int end_position = band_start;
  for (int j = 0; j < 2 * e; ++j) {
    num_errors += (int)((vp >> j) & 1);
    num_errors -= (int)((vn >> j) & 1);
    if (num_errors < min_errors ||
        (num_errors == min_errors && j + 1 == e)) {
      min_errors = num_errors;
      end_position = band_start + 1 + j;
    }
  }
  if (fail_beginning ||
      (read_length > 60 && end_position + 1 - e - min_errors < 30))
    end_position = -end_position;
  *min_errors_out = min_errors;
  *end_position_out = end_position;
  *read_mapping_length_out = read_mapping_length;
}

static void BandedAlignDropoff3End(int e, const char* pattern, const char* text,
                   int read_length, int* min_errors_out,
                   int* end_position_out, int* read_mapping_length_out) {
  if (e < 16)
    BandedAlignDropoff3EndT<uint32_t>(e, pattern, text, read_length, min_errors_out,
                      end_position_out, read_mapping_length_out);
  else
    BandedAlignDropoff3EndT<uint64_t>(e, pattern, text, read_length, min_errors_out,
                      end_position_out, read_mapping_length_out);
}

static int GetLongestMatchLength(const char* pattern, const char* text,
                                 int read_length) {
  // the reference never resets tmp on mismatch (alignment.cc:7-22)
  int max_match = 0, tmp = 0;
  for (int i = 0; i < read_length; ++i) {
    if (kCharToCode[(uint8_t)pattern[i]] == kCharToCode[(uint8_t)text[i]])
      ++tmp;
    else if (tmp > max_match)
      max_match = tmp;
  }
  return tmp > max_match ? tmp : max_match;
}

inline bool BaseEqualLc(uint8_t read_b, uint8_t ref_b) {
  if (read_b == ref_b) return true;
  return ref_b >= 0x61 && ref_b <= 0x7A && read_b == (uint8_t)(ref_b - 0x20);
}

// 5'-gap extension by direct comparison (alignment.cc:24-83); returns the
// new gap and writes the moved reference boundary.
static int AdjustGapBeginning(bool strand_negative, const char* ref,
                              int64_t ref_len, const char* read,
                              int read_len, int gap_beginning, int read_end,
                              int64_t ref_start_position,
                              int64_t ref_end_position,
                              int64_t* new_boundary) {
  if (!strand_negative) {
    if (gap_beginning <= 0) {
      *new_boundary = ref_start_position;
      return gap_beginning;
    }
    int i = gap_beginning - 1;
    int64_t j = ref_start_position - 1;
    while (i >= 0 && j >= 0) {
      if (!BaseEqualLc((uint8_t)read[i], (uint8_t)ref[j])) break;
      --i;
      --j;
    }
    *new_boundary = j + 1;
    return i + 1;
  }
  if (gap_beginning <= 0) {
    *new_boundary = ref_end_position;
    return gap_beginning;
  }
  int i = read_end + 1;
  int64_t j = ref_end_position + 1;
  while (i < read_len && j < ref_len) {
    if (!BaseEqualLc((uint8_t)read[i], (uint8_t)ref[j])) break;
    ++i;
    ++j;
  }
  *new_boundary = j - 1;
  return gap_beginning + i - (read_end + 1);
}

inline void UpdateCounters(VerifyState& vs, int num_errors) {
  if (num_errors < vs.min_num_errors) {
    vs.second_min_num_errors = vs.min_num_errors;
    vs.num_second_best_mappings = vs.num_best_mappings;
    vs.min_num_errors = num_errors;
    vs.num_best_mappings = 1;
  } else if (num_errors == vs.min_num_errors) {
    ++vs.num_best_mappings;
  } else if (num_errors == vs.second_min_num_errors) {
    ++vs.num_second_best_mappings;
  } else if (num_errors < vs.second_min_num_errors) {
    vs.num_second_best_mappings = 1;
    vs.second_min_num_errors = num_errors;
  }
}

bool TryShortcut(const MappingParams& mp, const RefView& ref,
                 const SeedState& st, int read_length, VerifyState& vs) {
  if (st.NumCandidates() != 1) return false;
  uint32_t num_minimizers = st.num_minimizers;
  int num_hits = 0;
  const Candidate* cand = nullptr;
  bool neg = false;
  for (const auto& c : st.positive_candidates)
    if (c.count == num_minimizers) {
      cand = &c;
      ++num_hits;
    }
  for (const auto& c : st.negative_candidates)
    if (c.count == num_minimizers) {
      cand = &c;
      neg = true;
      ++num_hits;
    }
  if (num_hits != 1) return false;
  vs.min_num_errors = 0;
  vs.num_best_mappings = 1;
  vs.num_second_best_mappings = 0;
  uint32_t rid = (uint32_t)(cand->position >> 32);
  uint32_t position = (uint32_t)cand->position;
  if (neg) position = (uint32_t)(position - read_length + 1);
  int64_t rl = rid < (uint32_t)ref.num_refs ? ref.Len(rid) : 0;
  if (position < (uint32_t)mp.error_threshold || position >= rl ||
      position + read_length + mp.error_threshold >= rl)
    return false;
  if (neg)
    vs.negative_mappings.push_back({0, cand->position});
  else
    vs.positive_mappings.push_back(
        {0, cand->position + (uint64_t)read_length - 1});
  return true;
}

struct ExtVerify {
  const int32_t* errors;
  const int32_t* ends;
  int64_t cursor;
};

// Device-seeded batch view (ops/device_seed.py download format). Rows are
// interleaved (r1 of pair 0, r2 of pair 0, r1 of pair 1, ...). read_meta
// packs mm_count | rep_len<<8 | flags<<24 | n_pos<<32 | n_neg<<40;
// cand_meta packs count | err<<8 | end<<16.
struct DevSeedView {
  const uint64_t* read_meta;
  const uint64_t* cand_pos;
  const uint32_t* cand_meta;
  // split mode: per-candidate packed drop-off results
  // (2 x (err:7 | sign:1 | |end|:9 | rml:8), primary then gap-retry)
  const uint64_t* cand_split = nullptr;
};

constexpr uint64_t kDevFlagFallback = 1;
constexpr uint64_t kDevFlagAugment = 2;

// optional per-end outputs (PAF/pairs/SAM record construction)
struct PEExtOut {
  uint32_t* rs1;
  uint32_t* re1;
  uint32_t* rs2;
  uint32_t* re2;
  uint8_t* err1;
  uint8_t* err2;
  uint8_t* mapq1;
  uint8_t* mapq2;
  int32_t* rid2;  // split pairs may land ends on different chromosomes
  uint8_t* dir2;  // 1 = second end positive
};

// Unpacks one device-seeded read into a SeedState (minus minimizers).
static void LoadDevSeed(const DevSeedView& dev, uint64_t meta,
                        int64_t cursor, SeedState& st, uint32_t* mm_count) {
  *mm_count = (uint32_t)(meta & 0xFF);
  st.repetitive_seed_length = (uint32_t)((meta >> 8) & 0xFFFF);
  int n_pos = (int)((meta >> 32) & 0xFF);
  int n_neg = (int)((meta >> 40) & 0xFF);
  st.positive_candidates.resize(n_pos);
  st.negative_candidates.resize(n_neg);
  const bool sp = dev.cand_split != nullptr;
  for (int i = 0; i < n_pos; ++i) {
    uint32_t m = dev.cand_meta[cursor + i];
    uint32_t ext = (((m >> 8) & 0xFF) << 8) | ((m >> 16) & 0xFF);
    uint64_t sx = sp ? dev.cand_split[cursor + i] : 0;
    st.positive_candidates[i] = {dev.cand_pos[cursor + i],
                                 (uint8_t)(m & 0xFF),
                                 sp ? (uint32_t)sx : ext,
                                 sp ? (uint32_t)(sx >> 32) : 0u};
  }
  for (int i = 0; i < n_neg; ++i) {
    uint32_t m = dev.cand_meta[cursor + n_pos + i];
    uint32_t ext = (((m >> 8) & 0xFF) << 8) | ((m >> 16) & 0xFF);
    uint64_t sx = sp ? dev.cand_split[cursor + n_pos + i] : 0;
    st.negative_candidates[i] = {dev.cand_pos[cursor + n_pos + i],
                                 (uint8_t)(m & 0xFF),
                                 sp ? (uint32_t)sx : ext,
                                 sp ? (uint32_t)(sx >> 32) : 0u};
  }
}

void VerifyCandidates(const MappingParams& mp, const RefView& ref,
                      const char* read, const char* neg_read, int read_length,
                      SeedState& st, VerifyState& vs,
                      ExtVerify* ext = nullptr) {
  vs.Reset(mp.error_threshold);
  if (TryShortcut(mp, ref, st, read_length, vs)) return;
  std::sort(st.positive_candidates.begin(), st.positive_candidates.end(),
            CandidateLess);
  std::sort(st.negative_candidates.begin(), st.negative_candidates.end(),
            CandidateLess);

  int e = mp.error_threshold;
  int num_lanes = e < 8 ? 8 : (e < 16 ? 4 : 0);

  for (int strand = 0; strand < 2; ++strand) {
    bool neg = strand == 1;
    const std::vector<Candidate>& cands =
        neg ? st.negative_candidates : st.positive_candidates;
    std::vector<DraftMapping>& mappings =
        neg ? vs.negative_mappings : vs.positive_mappings;
    const char* text = neg ? neg_read : read;
    bool grouped = num_lanes > 0 && (int)cands.size() >= num_lanes;

    int64_t strand_cursor_start = 0;
    int64_t strand_valid_total = 0;
    if (ext) {
      strand_cursor_start = ext->cursor;
      for (size_t ci = 0; ci < cands.size(); ++ci) {
        const Candidate& c = cands[ci];
        uint32_t rid = (uint32_t)(c.position >> 32);
        uint32_t position = (uint32_t)c.position;
        if (neg) position = (uint32_t)(position - read_length + 1);
        int64_t rl = rid < (uint32_t)ref.num_refs ? ref.Len(rid) : 0;
        if (rid >= (uint32_t)ref.num_refs || position < (uint32_t)e ||
            position >= rl || position + read_length + e >= rl)
          continue;
        ++strand_valid_total;
      }
    }

    uint32_t threshold = 0;
    std::vector<const Candidate*> group;
    for (size_t ci = 0; ci < cands.size(); ++ci) {
      const Candidate& c = cands[ci];
      if (c.count < threshold) break;
      uint32_t rid = (uint32_t)(c.position >> 32);
      uint32_t position = (uint32_t)c.position;
      if (neg) position = (uint32_t)(position - read_length + 1);
      int64_t rl = rid < (uint32_t)ref.num_refs ? ref.Len(rid) : 0;
      if (rid >= (uint32_t)ref.num_refs || position < (uint32_t)e ||
          position >= rl || position + read_length + e >= rl)
        continue;
      if (!grouped) {
        int end_pos = read_length;
        int ne;
        if (ext) {
          ne = ext->errors[ext->cursor];
          end_pos = ext->ends[ext->cursor];
          ++ext->cursor;
        } else if (c.ext != kNoExt) {
          ne = (int)(c.ext >> 8);
          end_pos = (int)(c.ext & 0xFF);
        } else {
          ne = BandedAlign(e, ref.Seq(rid) + position - e, text,
                           read_length, &end_pos);
        }
        if (ne <= e) {
          UpdateCounters(vs, ne);
          uint64_t draft =
              neg ? c.position - read_length + 1 - e + end_pos
                  : c.position - e + end_pos;
          mappings.push_back({ne, draft});
        }
        continue;
      }
      group.push_back(&c);
      if ((int)group.size() < num_lanes) continue;
      // whole-group multi-lane Myers (when nothing precomputed overrides)
      int gerrs[8], gends[8];
      bool lanes_ok = ext == nullptr
                      && (num_lanes == 4 || num_lanes == 8);
      if (lanes_ok)
        for (const Candidate* gc : group)
          if (gc->ext != kNoExt) {
            lanes_ok = false;
            break;
          }
      if (lanes_ok) {
        const char* pats[8];
        for (int gi = 0; gi < num_lanes; ++gi) {
          const Candidate* gc = group[gi];
          uint32_t grid = (uint32_t)(gc->position >> 32);
          uint32_t gpos = (uint32_t)gc->position;
          if (neg) gpos = (uint32_t)(gpos - read_length + 1);
          pats[gi] = ref.Seq(grid) + gpos - e;
        }
        if (num_lanes == 8)
          BandedAlignLanes<8>(e, pats, text, read_length, gerrs, gends);
        else
          BandedAlignLanes<4>(e, pats, text, read_length, gerrs, gends);
      }
      int gi = 0;
      for (const Candidate* gc : group) {
        uint32_t grid = (uint32_t)(gc->position >> 32);
        uint32_t gpos = (uint32_t)gc->position;
        if (neg) gpos = (uint32_t)(gpos - read_length + 1);
        int end_pos = read_length - 1;
        int ne;
        if (lanes_ok) {
          ne = gerrs[gi];
          end_pos = gends[gi];
        } else if (ext) {
          ne = ext->errors[ext->cursor];
          end_pos = ext->ends[ext->cursor];
          ++ext->cursor;
        } else if (gc->ext != kNoExt) {
          ne = (int)(gc->ext >> 8);
          end_pos = (int)(gc->ext & 0xFF);
        } else {
          ne = BandedAlign(e, ref.Seq(grid) + gpos - e, text, read_length,
                           &end_pos);
        }
        ++gi;
        if (ne <= e) {
          UpdateCounters(vs, ne);
          uint64_t draft =
              neg ? gc->position - read_length + 1 - e + end_pos
                  : gc->position - e + end_pos;
          mappings.push_back({ne, draft});
        } else {
          threshold = gc->count;
        }
      }
      group.clear();
    }
    // tail without threshold updates
    for (const Candidate* gc : group) {
      uint32_t grid = (uint32_t)(gc->position >> 32);
      uint32_t gpos = (uint32_t)gc->position;
      if (neg) gpos = (uint32_t)(gpos - read_length + 1);
      int end_pos = read_length - 1;
      int ne;
      if (ext) {
        ne = ext->errors[ext->cursor];
        end_pos = ext->ends[ext->cursor];
        ++ext->cursor;
      } else if (gc->ext != kNoExt) {
        ne = (int)(gc->ext >> 8);
        end_pos = (int)(gc->ext & 0xFF);
      } else {
        ne = BandedAlign(e, ref.Seq(grid) + gpos - e, text, read_length,
                         &end_pos);
      }
      if (ne <= e) {
        UpdateCounters(vs, ne);
        uint64_t draft = neg ? gc->position - read_length + 1 - e + end_pos
                             : gc->position - e + end_pos;
        mappings.push_back({ne, draft});
      }
    }
    group.clear();
    if (ext) ext->cursor = strand_cursor_start + strand_valid_total;
  }
}

// Split (drop-off) verification per strand: align each candidate with the
// drop-off kernels from the matching end, with a 5'-gap retry, encoding
// (actual_errors<<24 | gap<<16 | read_mapping_length) alongside a
// NEGATED-score draft error (draft_mapping_generator.cc:410-555;
// host oracle generate.py:240-364).
static void VerifyCandidatesSplitOneStrand(
    const MappingParams& mp, const RefView& ref, bool strand_negative,
    const char* read, const char* neg_read, int read_length, SeedState& st,
    VerifyState& vs, bool dev_ext = false) {
  int e = mp.error_threshold;
  const std::vector<Candidate>& cands =
      strand_negative ? st.negative_candidates : st.positive_candidates;
  std::vector<DraftMapping>& mappings =
      strand_negative ? vs.negative_mappings : vs.positive_mappings;
  std::vector<uint32_t>& split_sites =
      strand_negative ? vs.negative_split_sites : vs.positive_split_sites;
  const char* text = strand_negative ? neg_read : read;

  uint32_t threshold = 0;
  int best_mapping_longest_match = 0;
  for (const Candidate& c : cands) {
    if (c.count < threshold) break;
    uint32_t rid = (uint32_t)(c.position >> 32);
    uint32_t position = (uint32_t)c.position;
    if (strand_negative) position = (uint32_t)(position - read_length + 1);
    int64_t rl = rid < (uint32_t)ref.num_refs ? ref.Len(rid) : 0;
    if (rid >= (uint32_t)ref.num_refs || position < (uint32_t)e ||
        position >= rl || position + read_length + e >= rl)
      continue;
    const char* refseq = ref.Seq(rid);
    const char* pattern = refseq + position - e;

    int mapping_end_position = read_length;
    int gap_beginning = 0;
    const int allow_gap_beginning = 20 - e;
    const int mapping_length_threshold = 30;
    int actual_num_errors = 0;
    int read_mapping_length = 0;
    int longest_match = 0;
    int num_errors;

    if (dev_ext) {
      // device-computed drop-off results (primary + gap retry packed in
      // ext/ext2); the selection logic below is byte-identical to the
      // kernel-calling branches
      uint64_t v = ((uint64_t)c.ext2 << 32) | c.ext;
      auto unpackv = [](uint64_t x, int* err, int* end, int* rml) {
        *err = (int)(x & 0x7F);
        int mag = (int)((x >> 8) & 0x1FF);
        *end = ((x >> 7) & 1) ? -mag : mag;
        *rml = (int)((x >> 17) & 0xFF);
      };
      unpackv(v & 0x1FFFFFF, &num_errors, &mapping_end_position,
              &read_mapping_length);
      if (mapping_end_position < 0 && allow_gap_beginning > 0) {
        int b_err = num_errors, b_end = -mapping_end_position,
            b_len = read_mapping_length;
        unpackv((v >> 25) & 0x1FFFFFF, &num_errors, &mapping_end_position,
                &read_mapping_length);
        if (num_errors > e || mapping_end_position < 0) {
          num_errors = b_err;
          mapping_end_position = b_end;
          read_mapping_length = b_len;
        } else {
          gap_beginning = allow_gap_beginning;
          mapping_end_position += gap_beginning;
          read_mapping_length += gap_beginning;
        }
      }
    } else if (!strand_negative) {
      BandedAlignDropoff(e, pattern, text, read_length, &num_errors,
                         &mapping_end_position, &read_mapping_length);
      if (mapping_end_position < 0 && allow_gap_beginning > 0) {
        int b_err = num_errors, b_end = -mapping_end_position,
            b_len = read_mapping_length;
        const char* pattern2 = pattern + allow_gap_beginning;
        BandedAlignDropoff(e, pattern2, text + allow_gap_beginning,
                           read_length - allow_gap_beginning, &num_errors,
                           &mapping_end_position, &read_mapping_length);
        if (num_errors > e || mapping_end_position < 0) {
          num_errors = b_err;
          mapping_end_position = b_end;
          read_mapping_length = b_len;
        } else {
          gap_beginning = allow_gap_beginning;
          mapping_end_position += gap_beginning;
          read_mapping_length += gap_beginning;
        }
      }
    } else {
      BandedAlignDropoff3End(e, pattern, text, read_length, &num_errors,
                             &mapping_end_position, &read_mapping_length);
      if (mapping_end_position < 0 && allow_gap_beginning > 0) {
        int b_err = num_errors, b_end = -mapping_end_position,
            b_len = read_mapping_length;
        BandedAlignDropoff3End(e, pattern, text,
                               read_length - allow_gap_beginning,
                               &num_errors, &mapping_end_position,
                               &read_mapping_length);
        if (num_errors > e || mapping_end_position < 0) {
          num_errors = b_err;
          mapping_end_position = b_end;
          read_mapping_length = b_len;
        } else {
          gap_beginning = allow_gap_beginning;
          mapping_end_position += gap_beginning;
          read_mapping_length += gap_beginning;
        }
      }
    }

    if (mapping_end_position + 1 - e - num_errors - gap_beginning >=
        mapping_length_threshold) {
      actual_num_errors = num_errors;
      num_errors =
          -(mapping_end_position - e - num_errors - gap_beginning);
      if (cands.size() > 200) {
        longest_match = GetLongestMatchLength(refseq + position, text,
                                              read_length);
      }
    } else {
      num_errors = e + 1;
      actual_num_errors = e + 1;
    }

    if (num_errors <= e) {
      if (num_errors < vs.min_num_errors) {
        vs.second_min_num_errors = vs.min_num_errors;
        vs.num_second_best_mappings = vs.num_best_mappings;
        vs.min_num_errors = num_errors;
        vs.num_best_mappings = 1;
        if (cands.size() > 50)
          threshold = c.count;
        else
          threshold = c.count / 2;
        if (vs.second_min_num_errors < vs.min_num_errors + e / 2 &&
            best_mapping_longest_match > longest_match &&
            cands.size() > 200)
          vs.second_min_num_errors = vs.min_num_errors;
        best_mapping_longest_match = longest_match;
      } else if (num_errors == vs.min_num_errors) {
        ++vs.num_best_mappings;
      } else if (num_errors == vs.second_min_num_errors) {
        ++vs.num_second_best_mappings;
      } else if (num_errors < vs.second_min_num_errors) {
        vs.num_second_best_mappings = 1;
        vs.second_min_num_errors = num_errors;
      }

      if (!strand_negative) {
        mappings.push_back(
            {num_errors, c.position - e + mapping_end_position});
      } else {
        if (!mp.sam_mode) {
          mappings.push_back({num_errors, c.position - gap_beginning});
        } else {
          mappings.push_back({num_errors, c.position - read_length + 1 - e +
                                              mapping_end_position});
        }
      }
      split_sites.push_back((uint32_t)((actual_num_errors & 0xFF) << 24) |
                            (uint32_t)((gap_beginning & 0xFF) << 16) |
                            (uint32_t)(read_mapping_length & 0xFFFF));
    }
  }
}

static void VerifyCandidatesSplit(const MappingParams& mp, const RefView& ref,
                                  const char* read, const char* neg_read,
                                  int read_length, SeedState& st,
                                  VerifyState& vs, bool dev_ext = false) {
  vs.Reset(mp.error_threshold);
  std::sort(st.positive_candidates.begin(), st.positive_candidates.end(),
            CandidateLess);
  std::sort(st.negative_candidates.begin(), st.negative_candidates.end(),
            CandidateLess);
  VerifyCandidatesSplitOneStrand(mp, ref, false, read, neg_read, read_length,
                                 st, vs, dev_ext);
  VerifyCandidatesSplitOneStrand(mp, ref, true, read, neg_read, read_length,
                                 st, vs, dev_ext);
}

// Collect verification work items (pattern offsets into the concatenated
// reference codes and oriented text codes) for one read; order matches the
// ext-mode consumption order in VerifyCandidates exactly.
void CollectVerification(const MappingParams& mp, const RefView& ref,
                         const int64_t* ref_global_offsets, const char* read,
                         const char* neg_read, int read_length, SeedState& st,
                         std::vector<int64_t>& pattern_starts,
                         std::vector<int32_t>& text_offsets,
                         std::vector<int32_t>& text_lengths,
                         std::vector<uint8_t>& text_codes) {
  VerifyState tmp;
  tmp.Reset(mp.error_threshold);
  if (TryShortcut(mp, ref, st, read_length, tmp)) return;
  std::sort(st.positive_candidates.begin(), st.positive_candidates.end(),
            CandidateLess);
  std::sort(st.negative_candidates.begin(), st.negative_candidates.end(),
            CandidateLess);
  int e = mp.error_threshold;
  for (int strand = 0; strand < 2; ++strand) {
    bool neg = strand == 1;
    const std::vector<Candidate>& cands =
        neg ? st.negative_candidates : st.positive_candidates;
    const char* text = neg ? neg_read : read;
    int32_t text_off = -1;
    for (size_t ci = 0; ci < cands.size(); ++ci) {
      const Candidate& c = cands[ci];
      uint32_t rid = (uint32_t)(c.position >> 32);
      uint32_t position = (uint32_t)c.position;
      if (neg) position = (uint32_t)(position - read_length + 1);
      int64_t rl = rid < (uint32_t)ref.num_refs ? ref.Len(rid) : 0;
      if (rid >= (uint32_t)ref.num_refs || position < (uint32_t)e ||
          position >= rl || position + read_length + e >= rl)
        continue;
      if (text_off < 0) {
        text_off = (int32_t)text_codes.size();
        for (int i = 0; i < read_length; ++i)
          text_codes.push_back(kCharToCode[(uint8_t)text[i]]);
      }
      pattern_starts.push_back(ref_global_offsets[rid] + position - e);
      text_offsets.push_back(text_off);
      text_lengths.push_back(read_length);
    }
  }
}

// ------------------------------ selection ------------------------------

inline int LibstdcppUniformInt(std::mt19937& gen, int a, int b) {
  const uint64_t urngrange = 0xFFFFFFFFull;
  const uint64_t urange = (uint64_t)(b - a);
  if (urngrange > urange) {
    const uint64_t uerange = urange + 1;
    const uint64_t scaling = urngrange / uerange;
    const uint64_t past = uerange * scaling;
    uint64_t ret;
    do {
      ret = gen();
    } while (ret >= past);
    return a + (int)(ret / scaling);
  }
  return a + (int)gen();
}

struct PairedState {
  int min_sum_errors, second_min_sum_errors;
  int num_best_mappings, num_second_best_mappings;
  std::vector<std::pair<uint32_t, uint32_t>> f1r2, f2r1, f1f2, r1r2;
};

// Split-pair enumeration: best1 x best2 regardless of position
// (mapping_generator.h:389-415)
static void EnumeratePairsSplit(
    const VerifyState& vs1, const VerifyState& vs2,
    const std::vector<DraftMapping>& m1, const std::vector<DraftMapping>& m2,
    PairedState& ps, std::vector<std::pair<uint32_t, uint32_t>>& best) {
  if (m1.empty() || m2.empty()) return;
  for (uint32_t i1 = 0; i1 < m1.size(); ++i1) {
    if (m1[i1].num_errors != vs1.min_num_errors) continue;
    for (uint32_t i2 = 0; i2 < m2.size(); ++i2) {
      if (m2[i2].num_errors != vs2.min_num_errors) continue;
      best.push_back({i1, i2});
      ps.min_sum_errors = vs1.min_num_errors + vs2.min_num_errors;
      ++ps.num_best_mappings;
    }
  }
}

void EnumeratePairs(const MappingParams& mp, bool first_negative,
                    int read1_length, int read2_length,
                    const std::vector<DraftMapping>& m1,
                    const std::vector<DraftMapping>& m2, PairedState& ps,
                    std::vector<std::pair<uint32_t, uint32_t>>& best) {
  uint32_t min_overlap = mp.min_read_length;
  size_t i1 = 0, i2 = 0;
  while (i1 < m1.size() && i2 < m2.size()) {
    uint64_t p1 = m1[i1].position, p2 = m2[i2].position;
    if ((first_negative &&
         p1 > p2 + mp.max_insert_size - (uint64_t)read2_length) ||
        (!first_negative &&
         p1 > p2 + (uint64_t)read1_length - min_overlap)) {
      ++i2;
    } else if ((!first_negative &&
                p2 > p1 + mp.max_insert_size - (uint64_t)read1_length) ||
               (first_negative &&
                p2 > p1 + (uint64_t)read2_length - min_overlap)) {
      ++i1;
    } else {
      size_t cur_i2 = i2;
      while (cur_i2 < m2.size()) {
        uint64_t pc2 = m2[cur_i2].position;
        bool in_range =
            (!first_negative &&
             pc2 <= p1 + mp.max_insert_size - (uint64_t)read1_length) ||
            (first_negative &&
             pc2 <= p1 + (uint64_t)read2_length - min_overlap);
        if (!in_range) break;
        int sum = m1[i1].num_errors + m2[cur_i2].num_errors;
        if (sum < ps.min_sum_errors) {
          ps.second_min_sum_errors = ps.min_sum_errors;
          ps.num_second_best_mappings = ps.num_best_mappings;
          ps.min_sum_errors = sum;
          ps.num_best_mappings = 1;
          best.clear();
          best.push_back({(uint32_t)i1, (uint32_t)cur_i2});
        } else if (sum == ps.min_sum_errors) {
          ++ps.num_best_mappings;
          best.push_back({(uint32_t)i1, (uint32_t)cur_i2});
        } else if (sum == ps.second_min_sum_errors) {
          ++ps.num_second_best_mappings;
        } else if (sum < ps.second_min_sum_errors) {
          ps.second_min_sum_errors = sum;
          ps.num_second_best_mappings = 1;
        }
        ++cur_i2;
      }
      ++i1;
    }
  }
}

uint8_t MapqSingleEnd(const MappingParams& mp, int num_errors,
                      uint16_t alignment_length, int read_length,
                      int max_num_error_difference, const VerifyState& vs,
                      uint32_t repetitive_seed_length,
                      int num_candidates_strand = 0) {
  const int mapq_coef_length = 50;
  const int mapq_coef_fraction = (int)log(mapq_coef_length);
  int al = alignment_length;
  if (!mp.split_mode && al < read_length) al = read_length;
  double identity = 1.0 - (double)num_errors / al;
  if (mp.split_mode) {
    // split drafts carry negated mapped-length scores (mg.h:919-1022)
    identity = (double)(-num_errors) / al;
    if (identity > 1) identity = 1.0;
  }
  int mapq = 0;
  int second = vs.second_min_num_errors;
  if (vs.num_best_mappings <= 1) {
    if (second > num_errors + max_num_error_difference)
      second = num_errors + max_num_error_difference;
    double tmp = al < mapq_coef_length ? 1.0
                                       : mapq_coef_fraction / log((double)al);
    tmp *= identity * identity;
    mapq = (int)(5 * 6.02 * (second - num_errors) * tmp * tmp + 0.499);
  }
  if (vs.num_second_best_mappings > 0)
    mapq -= (int)(4.343 * log((double)vs.num_second_best_mappings + 1) +
                  0.499);
  if (mapq > 60) mapq = 60;
  if (mapq < 0) mapq = 0;
  uint32_t rep_len = repetitive_seed_length;
  if (rep_len > 0) {
    double frac_rep = (double)rep_len / read_length;
    if (rep_len >= (uint32_t)read_length) frac_rep = 0.999;
    if (identity <= 0.95)
      mapq = (int)(mapq * (1 - sqrt(frac_rep)) + 0.499);
    else if (identity <= 0.97)
      mapq = (int)(mapq * (1 - frac_rep) + 0.499);
    else if (identity >= 0.999)
      mapq = (int)(mapq * (1 - frac_rep * frac_rep * frac_rep * frac_rep) +
                   0.499);
    else
      mapq = (int)(mapq * (1 - frac_rep * frac_rep) + 0.499);
  }
  if (mp.split_mode && al < read_length - mp.error_threshold &&
      second != num_errors) {
    if (rep_len >= (uint32_t)al && rep_len < (uint32_t)read_length &&
        al < read_length / 3)
      mapq = 0;
    int diff = second - num_errors;
    if (second - num_errors <= mp.error_threshold * 3 / 4 &&
        num_candidates_strand >= 5)
      mapq -= num_candidates_strand / 5 / diff;
    if (mapq < 0) mapq = 0;
    if (vs.num_second_best_mappings > 0 &&
        second - num_errors <= mp.error_threshold * 3 / 4)
      mapq /= vs.num_second_best_mappings / diff + 1;
  }
  return (uint8_t)mapq;
}

void MapqPairedEnd(const MappingParams& mp, int e1, int e2, uint16_t al1,
                   uint16_t al2, int l1, int l2, int force_mapq,
                   const PairedState& ps, const VerifyState& vs1,
                   const VerifyState& vs2, uint32_t rep1, uint32_t rep2,
                   uint8_t* out_mapq, uint8_t* out_mapq1 = nullptr,
                   uint8_t* out_mapq2 = nullptr, int nc1 = 0, int nc2 = 0) {
  uint8_t mapq_pe = 0;
  int min_unpaired = vs1.min_num_errors + vs2.min_num_errors + 3;
  if (ps.num_best_mappings <= 1) {
    int adj_second = ps.second_min_sum_errors < min_unpaired
                         ? ps.second_min_sum_errors
                         : min_unpaired;
    mapq_pe = (uint8_t)(int)(5 * 6.02 * (adj_second - ps.min_sum_errors) / 1 +
                             0.499);
    if (ps.num_second_best_mappings > 0)
      mapq_pe = (uint8_t)(mapq_pe -
                          (int)(4.343 *
                                    log((double)ps.num_second_best_mappings +
                                        1) +
                                0.499));
    if (mapq_pe > 60) mapq_pe = 60;
    uint32_t rep_len = rep1 + rep2;
    if (rep_len > 0) {
      double total = (double)l1 + l2;
      double frac_rep = rep_len / total;
      if (rep_len >= total) frac_rep = 0.999;
      double id1 = 1.0 - (double)e1 / (l1 > al1 ? l1 : al1);
      double id2 = 1.0 - (double)e2 / (l2 > al2 ? l2 : al2);
      double identity = id1 < id2 ? id1 : id2;
      if (identity <= 0.95)
        mapq_pe = (uint8_t)(int)(mapq_pe * (1 - sqrt(frac_rep)) + 0.499);
      else if (identity <= 0.97)
        mapq_pe = (uint8_t)(int)(mapq_pe * (1 - frac_rep) + 0.499);
      else if (identity >= 0.999)
        mapq_pe = (uint8_t)(int)(mapq_pe * (1 - frac_rep * frac_rep *
                                                    frac_rep * frac_rep) +
                                 0.499);
      else
        mapq_pe =
            (uint8_t)(int)(mapq_pe * (1 - frac_rep * frac_rep) + 0.499);
    }
  }
  uint8_t mapq1 = MapqSingleEnd(mp, e1, al1, l1, 2, vs1, rep1, nc1);
  uint8_t mapq2 = MapqSingleEnd(mp, e2, al2, l2, 2, vs2, rep2, nc2);
  if (!mp.split_mode) {  // non-split blend
    if (mapq1 > mapq_pe) {
    } else if (mapq_pe < mapq1 + mapq_pe * 0.65) {
      mapq1 = (uint8_t)(double)mapq_pe;
    } else {
      mapq1 = (uint8_t)(mapq1 + mapq_pe * 0.65);
    }
    if (mapq2 > mapq_pe) {
    } else if (mapq_pe < mapq2 + mapq_pe * 0.65) {
      mapq2 = (uint8_t)(double)mapq_pe;
    } else {
      mapq2 = (uint8_t)(mapq2 + mapq_pe * 0.65);
    }
  }
  mapq1 = (uint8_t)(mapq1 * 1.2);
  if (mapq1 > 60) mapq1 = 60;
  mapq2 = (uint8_t)(mapq2 * 1.2);
  if (mapq2 > 60) mapq2 = 60;
  uint8_t mapq = mapq1 < mapq2 ? mapq1 : mapq2;
  if (mapq < 60 && force_mapq >= 0 && force_mapq < mapq) mapq = force_mapq;
  *out_mapq = mapq;
  if (out_mapq1) *out_mapq1 = mapq1;  // PAF reports per-end mapq unforced
  if (out_mapq2) *out_mapq2 = mapq2;
}

// ------------------------------ trimming ------------------------------

void TrimAdapter(std::vector<char>& r1, std::vector<char>& r2,
                 std::vector<char>& neg1, std::vector<char>& neg2,
                 int min_read_length) {
  bool swapped = r1.size() > r2.size();
  std::vector<char>& a = swapped ? r2 : r1;        // shorter "read1"
  std::vector<char>& negb = swapped ? neg1 : neg2; // rc of longer "read2"
  int read1_length = (int)std::min(r1.size(), r2.size());
  int read2_length = (int)std::max(r1.size(), r2.size());
  int seed_length = min_read_length / 2;
  const int et = 1;

  for (int si = 0; si < et + 1; ++si) {
    if ((si + 1) * seed_length > (int)a.size()) break;
    const char* seed = a.data() + si * seed_length;
    const char* hay = negb.data();
    int hay_len = (int)negb.size();
    int start = 0;
    bool merged = false;
    while (start + seed_length <= hay_len) {
      const char* found = std::search(hay + start, hay + hay_len, seed,
                                      seed + seed_length);
      if (found == hay + hay_len) break;
      int ssp = (int)(found - hay);
      bool before_ok = ssp >= si * seed_length;
      bool overlap_ok =
          read2_length - ssp + seed_length * si >= min_read_length;
      if (!(before_ok && overlap_ok)) {
        start = ssp + 1;
        continue;
      }
      bool can_merge = true;
      int num_errors = 0;
      for (int i = 0; i < seed_length * si; ++i) {
        if (negb[ssp - si * seed_length + i] != a[i]) ++num_errors;
        if (num_errors > et) {
          can_merge = false;
          break;
        }
      }
      if (can_merge) {
        for (int i = seed_length;
             i + ssp < read2_length && si * seed_length + i < read1_length;
             ++i) {
          if (negb[ssp + i] != a[si * seed_length + i]) ++num_errors;
          if (num_errors > et) {
            can_merge = false;
            break;
          }
        }
      }
      if (can_merge) {
        int overlap = read2_length - ssp + si * seed_length;
        int off2 = 0;
        if (overlap > read1_length) {
          off2 = overlap - read1_length;
          overlap = read1_length;
        }
        auto trim = [](std::vector<char>& seq, std::vector<char>& negseq,
                       int keep) {
          if (keep >= (int)seq.size()) return;
          int drop = (int)seq.size() - keep;
          negseq.erase(negseq.begin(), negseq.begin() + drop);
          seq.resize(keep);
        };
        if (!swapped) {
          trim(r1, neg1, overlap);
          trim(r2, neg2, overlap + off2);
        } else {
          trim(r1, neg1, overlap + off2);
          trim(r2, neg2, overlap);
        }
        merged = true;
        break;
      }
      start = ssp + 1;
    }
    if (merged) break;
  }
}

// ------------------------------ context ------------------------------

// per-pair working state for the seed+verify phase; pooled so vectors
// keep their capacity across batches
struct PairScratch {
  SeedState s1, s2;
  VerifyState vs1, vs2;
  std::vector<uint8_t> codes1, codes2;
  std::vector<char> read1, read2, neg1, neg2;
  int l1 = 0, l2 = 0;
  int supplement_result = 0;
  uint8_t status = 0;  // 0 skip, 1 ok
  uint8_t cache_hit = 0;
  uint8_t prep = 0;  // 0 skip, 1 host-seeded, 2 device-seeded
  int64_t n_cand = 0;
  // selection-phase state (see select_prep/select_draw/select_emit):
  // pair enumeration result, reservoir-sampled tied-best indices, and
  // the per-pair report plan, so emission can run on any thread
  PairedState ps;
  std::vector<int> best_idx;
  int to_report = 0;
  int force_mapq = -1;
  int is_unique = 0;
};

// output cursor for one selection-emit range (global arrays on the
// sequential path; per-range local buffers on the parallel path)
struct SelSink {
  int32_t* rid;
  uint32_t* read_id;
  uint32_t* start;
  uint16_t* flen;
  uint8_t* mapq;
  uint8_t* dir;
  uint8_t* uniq;
  uint16_t* posalen;
  uint16_t* negalen;
  int64_t n = 0;
};

// candidate-cache update record for one read end (mm_history analog)
struct HistEntry {
  std::vector<Minimizer> mzs;
  std::vector<Candidate> pos, neg;
  uint32_t rep;
};

// precomputed phase-1 (seed + verify) results for one chunk of pairs;
// selection runs later, in chunk order, so several chunks can hold
// completed phase-1 state while the device seeds other chunks
struct Phase1Chunk {
  std::vector<PairScratch> work;
  std::vector<uint8_t> hist_valid;
  std::vector<std::pair<HistEntry, HistEntry>> history;
  int64_t n = 0;
  int64_t threshold = 0;
};

struct CnContext {
  IndexView idx;
  RefView ref;
  MappingParams mp;
  MMCache cache;
  std::mt19937 generator;
  int num_threads = 1;
  // scratch
  SeedState s1, s2;
  VerifyState vs1, vs2;
  std::vector<uint8_t> codes1, codes2, neg_codes1, neg_codes2;
  std::vector<char> read1, read2, neg1, neg2;
  PairScratch ps;                    // single-thread pair scratch
  std::vector<PairScratch> mt_work;  // per-pair states (threaded phase 1)
  std::vector<PairScratch> win_work;  // window pool (plain-path phasing)
  std::vector<std::pair<HistEntry, HistEntry>> history;

  // SAM-mode per-record alignment outputs (cigar/NM/MD), end1 then end2
  // per emitted row
  std::vector<uint32_t> sam_cigar_buf;
  // native SAM text assembly (cn_sam_text): reference names, rendered
  // line buffer + offsets, and the per-record key fields the Python
  // postprocess (sort/dedup) consumes
  std::vector<char> samref_bytes;
  std::vector<int64_t> samref_off;
  std::vector<char> samtx_text;
  std::vector<int64_t> samtx_off;
  std::vector<int32_t> samtx_rid;
  std::vector<uint32_t> samtx_pos, samtx_mpos, samtx_read_id,
      samtx_refend;
  std::vector<uint16_t> samtx_flag;
  std::vector<uint8_t> samtx_mapq, samtx_uniq;
  std::vector<int64_t> sam_cigar_offsets;
  std::string sam_md_buf;
  std::vector<int64_t> sam_md_offsets;
  std::vector<uint16_t> sam_nm;
  std::vector<uint32_t> sam_tmp_cigar;
  std::string sam_tmp_md;
  KswScratch ksw_scratch;

  // per-pair flags from the last mapping call: bit0 = cache hit on
  // either end (summary CACHEHIT, summary_metadata.h:17-25)
  std::vector<uint8_t> pair_flags;

  // custom chromosome order (chromap.cc:916-923): candidate rids are
  // reranked after paired reduction, before verification
  std::vector<int32_t> rid_rank;

  // recycled phase-1 chunk states (their scratch vectors keep capacity;
  // fresh allocations page-fault at ~200 s/GB on the target VM)
  std::vector<Phase1Chunk*> chunk_pool;

  // per-pair read lengths after adapter trimming (PAF/SAM records carry
  // the trimmed sequence); filled by the last paired mapping call
  std::vector<uint16_t> pair_tl1, pair_tl2;

  // per-barcode summary aggregates from the last native low-memory merge
  // (MAPPED, DUP, LOWMAPQ triples; summary_metadata.h:17-25)
  std::vector<uint64_t> lowmem_sum_keys;
  std::vector<int64_t> lowmem_sum_counts;

  // device-verification work buffers (phase split)
  std::vector<int64_t> wb_pattern_starts;
  std::vector<int32_t> wb_text_offsets;
  std::vector<int32_t> wb_text_lengths;
  std::vector<uint8_t> wb_text_codes;

  bool cache_off = false;  // --device / --no-cache: skip the candidate
                           // cache so output is invariant to which
                           // engine maps each chunk (mmcache hits are
                           // only approximately equal to fresh
                           // generation; see ARCHITECTURE.md)

  CnContext(int64_t cache_size, int k)
      : cache(cache_size, k), generator(11) {}
};

}  // namespace

extern "C" {

CnContext* cn_create(const uint64_t* hash_keys, const uint64_t* offsets,
                     const uint32_t* counts, int64_t num_keys,
                     const uint64_t* occurrences, const char* ref_bytes,
                     const int64_t* ref_offsets, int32_t num_refs, int k,
                     int w, int error_threshold, int min_num_seeds, int f0,
                     int f1, int max_num_best, int max_insert_size,
                     int min_read_length, int drop_repetitive_reads,
                     int64_t cache_size, int trim_adapters) {
  // note: the caller pads ref_bytes with trailing sentinel 'N's -- the
  // traceback window can legitimately read up to e-1 bytes past the last
  // sequence (the reference reads adjacent heap bytes there)
  CnContext* ctx = new CnContext(cache_size, k);
  ctx->idx = {hash_keys, offsets, counts, num_keys, occurrences, k, w};
  ctx->idx.BuildProbeTable();
  ctx->ref = {ref_bytes, ref_offsets, num_refs};
  ctx->mp = {error_threshold, min_num_seeds,       f0,
             f1,              max_num_best,        max_insert_size,
             min_read_length, drop_repetitive_reads,
             trim_adapters != 0, false};
  return ctx;
}

void cn_destroy(CnContext* ctx) {
  for (Phase1Chunk* ch : ctx->chunk_pool) delete ch;
  delete ctx;
}

// Threaded mapping (the analog of the reference's OpenMP taskloop,
// chromap.h:851-1143): phase 1 (seed+verify) fans out over pairs, phase 2
// (selection, RNG, records) stays sequential, so output is byte-identical
// at any thread count -- unlike the reference, whose multi-threaded tie
// sampling is schedule-dependent.
void cn_set_num_threads(CnContext* ctx, int t) {
  ctx->num_threads = t < 1 ? 1 : t;
}

// optional phase profiling (CHROMAP_TPU_NATIVE_PROFILE=1): accumulated
// nanoseconds per pipeline phase, printed by MapPairsCore per call
struct PhaseProf {
  bool on = false;
  uint64_t mz = 0, cand = 0, supp = 0, verify = 0, select = 0;
  PhaseProf() {
    const char* env = getenv("CHROMAP_TPU_NATIVE_PROFILE");
    on = env && env[0] == '1';
  }
  static uint64_t Now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
  }
};
static PhaseProf g_prof;

// Seed one pair into `sc`: read copy, reverse complement, adapter trim,
// and minimizer extraction (or device-seed load). Phase A of the pair
// pipeline; sets sc.prep (0 skip, 1 host, 2 device). Split from the
// candidate/verify phase so the plain single-thread path can run each
// phase over a window of pairs back-to-back (warm code + data caches,
// cross-pair miss overlap) without changing any per-pair ordering.
static void SeedPairPrep(
    CnContext* ctx, int64_t pi, const char* r1_bytes,
    const int64_t* r1_offsets, const char* r2_bytes,
    const int64_t* r2_offsets, const DevSeedView* dev, bool dev_pair,
    uint64_t dmeta1, uint64_t dmeta2, int64_t dcur1, int64_t dcur2,
    PairScratch& sc) {
  const MappingParams& mp = ctx->mp;
  const IndexView& idx = ctx->idx;
  sc.status = 0;
  sc.cache_hit = 0;
  sc.prep = 0;
  sc.n_cand = 0;
    int l1 = (int)(r1_offsets[pi + 1] - r1_offsets[pi]);
    int l2 = (int)(r2_offsets[pi + 1] - r2_offsets[pi]);
    if (l1 < mp.min_read_length || l2 < mp.min_read_length) return;

    // copy reads (trim mutates)
    sc.read1.assign(r1_bytes + r1_offsets[pi],
                      r1_bytes + r1_offsets[pi + 1]);
    sc.read2.assign(r2_bytes + r2_offsets[pi],
                      r2_bytes + r2_offsets[pi + 1]);
    auto make_neg = [](const std::vector<char>& s, std::vector<char>& o) {
      o.resize(s.size());
      static const char code_char[8] = {'A', 'C', 'G', 'T',
                                        'N', 'N', 'N', 'N'};
      for (size_t i = 0; i < s.size(); ++i) {
        uint8_t c = kCharToCode[(uint8_t)s[s.size() - 1 - i]];
        o[i] = code_char[c < 4 ? (3 ^ c) : 7];
      }
    };
    make_neg(sc.read1, sc.neg1);
    make_neg(sc.read2, sc.neg2);
    if (mp.trim_adapters)
      TrimAdapter(sc.read1, sc.read2, sc.neg1, sc.neg2,
                  mp.min_read_length);
    if (dev_pair && ((int)sc.read1.size() != l1 ||
                     (int)sc.read2.size() != l2))
      // adapter trimming changed this pair: the device seeded the raw
      // reads, so re-seed the trimmed pair on the exact host path
      dev_pair = false;
    l1 = (int)sc.read1.size();
    l2 = (int)sc.read2.size();
    sc.l1 = l1;
    sc.l2 = l2;

    sc.codes1.resize(l1);
    sc.codes2.resize(l2);
    for (int i = 0; i < l1; ++i)
      sc.codes1[i] = kCharToCode[(uint8_t)sc.read1[i]];
    for (int i = 0; i < l2; ++i)
      sc.codes2[i] = kCharToCode[(uint8_t)sc.read2[i]];

    SeedState& s1 = sc.s1;
    SeedState& s2 = sc.s2;
    s1.Clear();
    s2.Clear();
    if (dev_pair) {
      LoadDevSeed(*dev, dmeta1, dcur1, s1, &s1.num_minimizers);
      LoadDevSeed(*dev, dmeta2, dcur2, s2, &s2.num_minimizers);
      if (s1.num_minimizers == 0 || s2.num_minimizers == 0) return;
      sc.prep = 2;
    } else {
      uint64_t t0 = g_prof.on ? PhaseProf::Now() : 0;
      GenerateMinimizers(sc.codes1.data(), l1, idx.k, idx.w,
                         s1.minimizers);
      GenerateMinimizers(sc.codes2.data(), l2, idx.k, idx.w,
                         s2.minimizers);
      s1.num_minimizers = (uint32_t)s1.minimizers.size();
      s2.num_minimizers = (uint32_t)s2.minimizers.size();
      if (g_prof.on) g_prof.mz += PhaseProf::Now() - t0;
      if (s1.minimizers.empty() || s2.minimizers.empty()) return;
      sc.prep = 1;
    }
}

// Candidate generation + supplement/reduce + verification for one
// prepped pair (phase B; consumes sc.prep). Cache queries, history
// stores, collect-mode buffers and the ExtVerify cursor all advance in
// pair order, exactly as before the phase split.
static void SeedVerifyRest(
    CnContext* ctx, int64_t pi, int64_t cache_update_threshold,
    uint8_t* hist_valid, const DevSeedView* dev, int collect_mode,
    ExtVerify* ext, PairScratch& sc,
    std::pair<HistEntry, HistEntry>* history_arr = nullptr) {
  const MappingParams& mp = ctx->mp;
  const IndexView& idx = ctx->idx;
  const RefView& ref = ctx->ref;
  if (!sc.prep) return;
  const bool dev_pair = sc.prep == 2;
  SeedState& s1 = sc.s1;
  SeedState& s2 = sc.s2;
  const int l1 = sc.l1;
  const int l2 = sc.l2;
    if (!dev_pair) {
      uint64_t t1 = g_prof.on ? PhaseProf::Now() : 0;
      int q1 = ctx->cache_off
                   ? -1
                   : ctx->cache.Query(s1.minimizers, l1,
                                      s1.positive_candidates,
                                      s1.negative_candidates,
                                      s1.repetitive_seed_length);
      if (q1 == -1) GenerateCandidates(idx, mp, s1);
      int q2 = ctx->cache_off
                   ? -1
                   : ctx->cache.Query(s2.minimizers, l2,
                                      s2.positive_candidates,
                                      s2.negative_candidates,
                                      s2.repetitive_seed_length);
      if (q2 == -1) GenerateCandidates(idx, mp, s2);
      if (q1 >= 0 || q2 >= 0) sc.cache_hit = 1;
      if (g_prof.on) g_prof.cand += PhaseProf::Now() - t1;
    }

    if (pi < cache_update_threshold && !collect_mode && !ctx->cache_off) {
      auto& he = history_arr ? history_arr[pi] : ctx->history[pi];
      he.first.mzs = s1.minimizers;
      he.first.pos = s1.positive_candidates;
      he.first.neg = s1.negative_candidates;
      he.first.rep = s1.repetitive_seed_length;
      he.second.mzs = s2.minimizers;
      he.second.pos = s2.positive_candidates;
      he.second.neg = s2.negative_candidates;
      he.second.rep = s2.repetitive_seed_length;
      hist_valid[pi] = 1;
    }

    uint64_t t2 = g_prof.on ? PhaseProf::Now() : 0;
    // split mode skips mate rescue and paired reduction
    // (chromap.h:1020-1052 gates both on !split)
    int supplement_result =
        (dev_pair || mp.split_mode)
            ? 0
            : SupplementCandidates(idx, mp, 2 * mp.max_insert_size, s1, s2);
    size_t n1 = s1.NumCandidates();
    size_t n2 = s2.NumCandidates();

    if (n1 > 0 && n2 > 0 && !mp.split_mode) {
      // move to buffers and reduce
      s1.pos_buf = std::move(s1.positive_candidates);
      s1.neg_buf = std::move(s1.negative_candidates);
      s2.pos_buf = std::move(s2.positive_candidates);
      s2.neg_buf = std::move(s2.negative_candidates);
      s1.positive_candidates.clear();
      s1.negative_candidates.clear();
      s2.positive_candidates.clear();
      s2.negative_candidates.clear();
      ReduceOneDirection(mp.max_insert_size, s1.pos_buf, s2.neg_buf,
                         s1.positive_candidates, s2.negative_candidates);
      ReduceOneDirection(mp.max_insert_size, s1.neg_buf, s2.pos_buf,
                         s1.negative_candidates, s2.positive_candidates);
      n1 = s1.NumCandidates();
      n2 = s2.NumCandidates();
    }
    if (g_prof.on) g_prof.supp += PhaseProf::Now() - t2;
    if (n1 == 0 || n2 == 0) return;
    sc.n_cand = (int64_t)(n1 + n2);

    if (!ctx->rid_rank.empty()) {
      // --chr-order: rerank candidate rids to the custom order before
      // verification (chromap.h:1060-1074, chromap.cc:916-923)
      auto rerank = [&](std::vector<Candidate>& cands) {
        for (auto& c : cands) {
          uint64_t rid = (uint32_t)(c.position >> 32);
          rid = (uint64_t)(uint32_t)ctx->rid_rank[rid];
          c.position = (c.position & (uint64_t)0xffffffff) | (rid << 32);
        }
      };
      rerank(s1.positive_candidates);
      rerank(s1.negative_candidates);
      rerank(s2.positive_candidates);
      rerank(s2.negative_candidates);
    }

    if (collect_mode) {
      CollectVerification(mp, ref, ref.offsets, sc.read1.data(),
                          sc.neg1.data(), l1, s1, ctx->wb_pattern_starts,
                          ctx->wb_text_offsets, ctx->wb_text_lengths,
                          ctx->wb_text_codes);
      CollectVerification(mp, ref, ref.offsets, sc.read2.data(),
                          sc.neg2.data(), l2, s2, ctx->wb_pattern_starts,
                          ctx->wb_text_offsets, ctx->wb_text_lengths,
                          ctx->wb_text_codes);
      sc.status = 2;
      return;
    }

    uint64_t t3 = g_prof.on ? PhaseProf::Now() : 0;
    if (mp.split_mode) {
      const bool dev_ext = dev_pair && dev && dev->cand_split != nullptr;
      VerifyCandidatesSplit(mp, ref, sc.read1.data(), sc.neg1.data(), l1,
                            s1, sc.vs1, dev_ext);
      VerifyCandidatesSplit(mp, ref, sc.read2.data(), sc.neg2.data(), l2,
                            s2, sc.vs2, dev_ext);
      if (sc.vs1.NumDraft() == 0 || sc.vs2.NumDraft() == 0) return;
      // split drafts keep candidate order: split_sites are parallel and
      // the all-pairs enumeration does not require sorted positions
    } else {
      VerifyCandidates(mp, ref, sc.read1.data(), sc.neg1.data(), l1, s1,
                       sc.vs1, ext);
      VerifyCandidates(mp, ref, sc.read2.data(), sc.neg2.data(), l2, s2,
                       sc.vs2, ext);
      if (sc.vs1.NumDraft() == 0 || sc.vs2.NumDraft() == 0) return;

      auto by_pos = [](const DraftMapping& a, const DraftMapping& b) {
        return a.position < b.position;
      };
      std::sort(sc.vs1.positive_mappings.begin(),
                sc.vs1.positive_mappings.end(), by_pos);
      std::sort(sc.vs1.negative_mappings.begin(),
                sc.vs1.negative_mappings.end(), by_pos);
      std::sort(sc.vs2.positive_mappings.begin(),
                sc.vs2.positive_mappings.end(), by_pos);
      std::sort(sc.vs2.negative_mappings.begin(),
                sc.vs2.negative_mappings.end(), by_pos);
    }
    if (g_prof.on) g_prof.verify += PhaseProf::Now() - t3;
    sc.supplement_result = supplement_result;
    sc.status = 1;

}

// Seed + verify one pair into `sc` (the parallel-safe first half of the
// mapping loop; writes only sc, ctx->history[pi]/hist_valid[pi], and -- in
// collect mode, single-threaded only -- ctx->wb_*). sc.status: 0 skipped,
// 1 mapped state ready, 2 collected.
static void SeedAndVerifyPair(
    CnContext* ctx, int64_t pi, const char* r1_bytes,
    const int64_t* r1_offsets, const char* r2_bytes,
    const int64_t* r2_offsets, int64_t cache_update_threshold,
    uint8_t* hist_valid, const DevSeedView* dev, bool dev_pair,
    uint64_t dmeta1, uint64_t dmeta2, int64_t dcur1, int64_t dcur2,
    int collect_mode, ExtVerify* ext, PairScratch& sc,
    std::pair<HistEntry, HistEntry>* history_arr = nullptr) {
  SeedPairPrep(ctx, pi, r1_bytes, r1_offsets, r2_bytes, r2_offsets, dev,
               dev_pair, dmeta1, dmeta2, dcur1, dcur2, sc);
  SeedVerifyRest(ctx, pi, cache_update_threshold, hist_valid, dev,
                 collect_mode, ext, sc, history_arr);
}

// Returns number of emitted records. stats: [candidates, mappings,
// mapped_reads, uniquely_mapped_reads, cache_hits]
// collect_mode: gather verification work items instead of mapping.
// ext_err/ext_end: precomputed verification results (device kernel).
static int64_t MapPairsCore(
    CnContext* ctx, const char* r1_bytes, const int64_t* r1_offsets,
    const char* r2_bytes, const int64_t* r2_offsets, int64_t num_pairs,
    int64_t base_read_id, int64_t cache_update_threshold, int32_t* out_rid,
    uint32_t* out_read_id, uint32_t* out_start, uint16_t* out_flen,
    uint8_t* out_mapq, uint8_t* out_dir, uint8_t* out_uniq,
    uint16_t* out_posalen, uint16_t* out_negalen, int64_t* stats,
    int collect_mode, const int32_t* ext_err, const int32_t* ext_end,
    const DevSeedView* dev = nullptr, const PEExtOut* xout = nullptr,
    Phase1Chunk* pre = nullptr) {
  const MappingParams& mp = ctx->mp;
  const IndexView& idx = ctx->idx;
  const RefView& ref = ctx->ref;
  int e = mp.error_threshold;
  int64_t out_n = 0;
  int64_t st_cand = 0, st_map = 0, st_mapped = 0, st_uniq = 0, st_hits = 0;

  // history entries are pooled across batches (their vectors keep their
  // capacity); hist_valid gates stale entries
  if (cache_update_threshold > 0 && !collect_mode &&
      (int64_t)ctx->history.size() < num_pairs)
    ctx->history.resize((size_t)num_pairs);
  std::vector<uint8_t> hist_valid(num_pairs, 0);

  ExtVerify ext_state = {ext_err, ext_end, 0};
  ExtVerify* ext = ext_err ? &ext_state : nullptr;
  if (mp.sam_mode) {
    ctx->sam_cigar_buf.clear();
    ctx->sam_cigar_offsets.assign(1, 0);
    ctx->sam_md_buf.clear();
    ctx->sam_md_offsets.assign(1, 0);
    ctx->sam_nm.clear();
  }
  if (collect_mode) {
    ctx->wb_pattern_starts.clear();
    ctx->wb_text_offsets.clear();
    ctx->wb_text_lengths.clear();
    ctx->wb_text_codes.clear();
  }

  std::vector<int> best_indices(mp.max_num_best_mappings);
  ctx->pair_flags.assign((size_t)num_pairs, 0);
  ctx->pair_tl1.assign((size_t)num_pairs, 0);
  ctx->pair_tl2.assign((size_t)num_pairs, 0);

  // device-seed bookkeeping: per-pair flags and candidate cursors (the
  // cursor advances for every pair in order, whichever path handles it)
  std::vector<uint64_t> dmeta;
  std::vector<int64_t> dcurs;
  std::vector<uint8_t> devflag;
  if (dev) {
    dmeta.resize(2 * num_pairs);
    dcurs.resize(2 * num_pairs);
    devflag.resize(num_pairs);
    int64_t cursor = 0;
    for (int64_t pi = 0; pi < num_pairs; ++pi) {
      uint64_t m1 = dev->read_meta[2 * pi];
      uint64_t m2 = dev->read_meta[2 * pi + 1];
      int n1c = (int)((m1 >> 32) & 0xFF) + (int)((m1 >> 40) & 0xFF);
      int n2c = (int)((m2 >> 32) & 0xFF) + (int)((m2 >> 40) & 0xFF);
      dmeta[2 * pi] = m1;
      dmeta[2 * pi + 1] = m2;
      dcurs[2 * pi] = cursor;
      dcurs[2 * pi + 1] = cursor + n1c;
      cursor += n1c + n2c;
      uint64_t f1 = (m1 >> 24) & 0xFF, f2 = (m2 >> 24) & 0xFF;
      bool fb = ((f1 | f2) & kDevFlagFallback) != 0;
      // mate rescue would run (candidate_processor.cc:75-231): exact
      // path (split mode never rescues, chromap.h:1020-1052)
      bool rescue = !mp.split_mode &&
                    (((f1 & kDevFlagAugment) && n2c > 0) ||
                     ((f2 & kDevFlagAugment) && n1c > 0));
      // trim-adapter runs demote individual pairs whose reads the
      // trimmer changed (SeedAndVerifyPair re-seeds those exactly)
      devflag[pi] = (!fb && !rescue) ? 1 : 0;
    }
  }

  // threaded phase 1: seed + verify every pair into pooled per-pair
  // states; selection stays sequential below so the output (including the
  // reservoir-sampling RNG stream) is byte-identical at any thread count.
  const bool mt = ctx->num_threads > 1 && !collect_mode && ext == nullptr
                  && pre == nullptr;
  if (mt) {
    if ((int64_t)ctx->mt_work.size() < num_pairs)
      ctx->mt_work.resize((size_t)num_pairs);
    int T = ctx->num_threads;
    auto run_range = [&](int64_t lo, int64_t hi) {
      for (int64_t pi = lo; pi < hi; ++pi)
        SeedAndVerifyPair(ctx, pi, r1_bytes, r1_offsets, r2_bytes,
                          r2_offsets, cache_update_threshold,
                          hist_valid.data(), dev,
                          dev && devflag[pi], dev ? dmeta[2 * pi] : 0,
                          dev ? dmeta[2 * pi + 1] : 0,
                          dev ? dcurs[2 * pi] : 0,
                          dev ? dcurs[2 * pi + 1] : 0, 0, nullptr,
                          ctx->mt_work[pi]);
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < T; ++t)
      threads.emplace_back(run_range, num_pairs * t / T,
                           num_pairs * (t + 1) / T);
    run_range(0, num_pairs / T);
    for (auto& th : threads) th.join();
  }

  // Selection runs as three phases so record emission can fan out over
  // threads while the reservoir draws stay ONE ordered mt19937 stream
  // (the reference's sampling semantics, mapping_generator.h:124-139,
  // 199-214):
  //   prep: pair enumeration -> sc.ps        (parallel-safe)
  //   draw: stats + reservoir -> sc.best_idx (sequential, pair order;
  //         draws only happen for pairs with more than max_num_best
  //         tied-best mappings, so this pass is cheap)
  //   emit: traceback + MAPQ + record writes (independent per pair;
  //         parallel over contiguous pair ranges into ordered sinks)
  auto select_prep = [&](int64_t pi, PairScratch& sc) {
    sc.to_report = 0;
    ctx->pair_flags[pi] = sc.cache_hit;
    if (sc.status != 1) return;
    ctx->pair_tl1[pi] = (uint16_t)sc.l1;
    ctx->pair_tl2[pi] = (uint16_t)sc.l2;
    PairedState& ps = sc.ps;
    ps.min_sum_errors = 2 * e + 1;
    ps.second_min_sum_errors = 2 * e + 1;
    ps.num_best_mappings = 0;
    ps.num_second_best_mappings = 0;
    ps.f1r2.clear();
    ps.f2r1.clear();
    ps.f1f2.clear();
    ps.r1r2.clear();
    if (mp.split_mode) {
      // split pairs: best1 x best2 over four strand combinations
      // (mapping_generator.h:174-188,389-415)
      EnumeratePairsSplit(sc.vs1, sc.vs2, sc.vs1.positive_mappings,
                          sc.vs2.negative_mappings, ps, ps.f1r2);
      EnumeratePairsSplit(sc.vs1, sc.vs2, sc.vs1.negative_mappings,
                          sc.vs2.positive_mappings, ps, ps.f2r1);
      EnumeratePairsSplit(sc.vs1, sc.vs2, sc.vs1.positive_mappings,
                          sc.vs2.positive_mappings, ps, ps.f1f2);
      EnumeratePairsSplit(sc.vs1, sc.vs2, sc.vs1.negative_mappings,
                          sc.vs2.negative_mappings, ps, ps.r1r2);
    } else {
      EnumeratePairs(mp, false, sc.l1, sc.l2, sc.vs1.positive_mappings,
                     sc.vs2.negative_mappings, ps, ps.f1r2);
      EnumeratePairs(mp, true, sc.l1, sc.l2, sc.vs1.negative_mappings,
                     sc.vs2.positive_mappings, ps, ps.f2r1);
    }

    if (ps.num_best_mappings > mp.drop_repetitive_reads) return;
    if (ps.num_best_mappings == 0) return;
    sc.to_report =
        std::min(mp.max_num_best_mappings, ps.num_best_mappings);
    sc.force_mapq = sc.supplement_result != 0 ? 0 : -1;
    sc.is_unique = (ps.num_best_mappings == 1 ||
                    sc.vs1.num_best_mappings == 1 ||
                    sc.vs2.num_best_mappings == 1)
                       ? 1
                       : 0;
  };

  auto select_draw = [&](int64_t pi, PairScratch& sc) {
    st_hits += sc.cache_hit;
    if (sc.status != 1) return;
    st_cand += sc.n_cand;
    PairedState& ps = sc.ps;
    if (ps.num_best_mappings > mp.drop_repetitive_reads) return;
    if (ps.num_best_mappings == 1) st_uniq += 2;
    st_map += 2 * std::min(ps.num_best_mappings, mp.max_num_best_mappings);
    if (ps.num_best_mappings > 0) st_mapped += 2;
    if (sc.to_report == 0) return;
    std::vector<int>& best_indices = sc.best_idx;
    best_indices.resize(mp.max_num_best_mappings);
    for (int i = 0; i < mp.max_num_best_mappings; ++i) best_indices[i] = i;
    if (ps.num_best_mappings > mp.max_num_best_mappings) {
      for (int i = mp.max_num_best_mappings; i < ps.num_best_mappings; ++i) {
        int j = LibstdcppUniformInt(ctx->generator, 0, i);
        if (j < mp.max_num_best_mappings) best_indices[j] = i;
      }
      std::sort(best_indices.begin(),
                best_indices.begin() + mp.max_num_best_mappings);
    }
  };

  auto select_emit = [&](int64_t pi, PairScratch& sc, SelSink& sink) {
    if (sc.to_report == 0) return;
    uint64_t tsel = g_prof.on ? PhaseProf::Now() : 0;
    PairedState& ps = sc.ps;
    const std::vector<int>& best_indices = sc.best_idx;
    const int to_report = sc.to_report;
    const int force_mapq = sc.force_mapq;
    const int is_unique = sc.is_unique;
    int best_mapping_index = 0, num_reported = 0;
    const int num_directions = mp.split_mode ? 4 : 2;
    static const bool kDirF[4] = {false, true, false, true};
    static const bool kDirS[4] = {true, false, false, true};
    for (int direction = 0; direction < num_directions; ++direction) {
      if (direction > 0 && num_reported == to_report) break;
      bool f_neg = kDirF[direction];
      bool s_neg = kDirS[direction];
      const auto& m1 =
          f_neg ? sc.vs1.negative_mappings : sc.vs1.positive_mappings;
      const auto& m2 =
          s_neg ? sc.vs2.negative_mappings : sc.vs2.positive_mappings;
      const auto& ss1 =
          f_neg ? sc.vs1.negative_split_sites : sc.vs1.positive_split_sites;
      const auto& ss2 =
          s_neg ? sc.vs2.negative_split_sites : sc.vs2.positive_split_sites;
      const auto& best = direction == 0   ? ps.f1r2
                         : direction == 1 ? ps.f2r1
                         : direction == 2 ? ps.f1f2
                                          : ps.r1r2;
      for (const auto& pr : best) {
        const DraftMapping& d1 = m1[pr.first];
        const DraftMapping& d2 = m2[pr.second];
        if (d1.num_errors + d2.num_errors > ps.min_sum_errors) continue;
        if (best_mapping_index == best_indices[num_reported]) {
          // position recovery for both ends
          auto recover = [&](const DraftMapping& d, bool neg, int full_L,
                             const char* fwd_text, const char* neg_text,
                             uint32_t split_packed, uint32_t* rs,
                             uint32_t* re) {
            uint32_t rid = (uint32_t)(d.position >> 32);
            uint32_t ref_position = (uint32_t)d.position;
            int64_t rl = ref.Len(rid);
            int L = full_L;
            int gap_beginning = 0;
            int actual_num_errors = 0;
            int split_site = neg ? full_L : 0;
            if (mp.split_mode) {
              split_site = (int)(split_packed & 0xFFFF);
              gap_beginning = (int)((split_packed >> 16) & 0xFF);
              actual_num_errors = (int)((split_packed >> 24) & 0xFF);
              L = split_site - gap_beginning;
            }
            int64_t vws;
            if ((uint64_t)ref_position + 1 > (uint64_t)(L + e))
              vws = (int64_t)ref_position + 1 - L - e;
            else
              vws = 0;
            if ((uint64_t)ref_position + e >= (uint64_t)rl)
              vws = (int64_t)(uint32_t)(rl - e - L);
            if (vws > rl) vws = 0;
            const char* text = neg ? neg_text : fwd_text;
            if (mp.split_mode) {
              // get_ref_start_end split branches (mapping_generator.h:
              // 655-917, non-SAM)
              const char* refseq = ref.Seq(rid);
              if (!neg) {
                int start_off = e;
                BandedTraceback(e, actual_num_errors, refseq + vws,
                                text + gap_beginning, L, &start_off);
                int64_t start = start_off;
                if (gap_beginning > 0) {
                  int64_t new_ref_start;
                  AdjustGapBeginning(false, refseq, rl, text, full_L,
                                     gap_beginning, L - 1, vws + start,
                                     ref_position, &new_ref_start);
                  start = new_ref_start - vws;
                }
                *rs = (uint32_t)(vws + start);
                *re = ref_position;
                return;
              }
              int read_start_site = full_L - split_site;
              int64_t start = e;
              int end_pos = L;
              BandedAlign(e, refseq + vws, text + read_start_site, L,
                          &end_pos);
              int64_t end = end_pos + 1;
              if (gap_beginning > 0) {
                int64_t new_ref_end;
                AdjustGapBeginning(true, refseq, rl, text + read_start_site,
                                   full_L - read_start_site, gap_beginning,
                                   L - 1, vws + start, vws + end,
                                   &new_ref_end);
                end = new_ref_end - vws + 1;
              }
              *rs = (uint32_t)(vws + start);
              *re = (uint32_t)(vws + end - 1);
              return;
            }
            if (mp.sam_mode) {
              // SAM positions come from the affine semi-global alignment
              // (mapping_generator.h:729-824); CIGAR/NM/MD recorded per end
              int start, endp;
              KswSemiGlobal3(L + 2 * e, ref.Seq(rid) + vws, L, text, mp,
                             2 * e + 1, ctx->ksw_scratch,
                             ctx->sam_tmp_cigar, &start, &endp);
              int nm = GenerateNMMD(ref.Seq(rid), text, vws + start,
                                    ctx->sam_tmp_cigar, ctx->sam_tmp_md);
              ctx->sam_cigar_buf.insert(ctx->sam_cigar_buf.end(),
                                        ctx->sam_tmp_cigar.begin(),
                                        ctx->sam_tmp_cigar.end());
              ctx->sam_cigar_offsets.push_back(
                  (int64_t)ctx->sam_cigar_buf.size());
              ctx->sam_md_buf += ctx->sam_tmp_md;
              ctx->sam_md_offsets.push_back(
                  (int64_t)ctx->sam_md_buf.size());
              ctx->sam_nm.push_back((uint16_t)nm);
              *rs = (uint32_t)(vws + start);
              *re = (uint32_t)(vws + endp - 1);
              return;
            }
            int start_off = e;
            BandedTraceback(e, d.num_errors, ref.Seq(rid) + vws, text, L,
                            &start_off);
            *rs = (uint32_t)(vws + start_off);
            *re = ref_position;
          };
          uint32_t rs1, re1, rs2, re2;
          recover(d1, f_neg, sc.l1, sc.read1.data(), sc.neg1.data(),
                  mp.split_mode ? ss1[pr.first] : 0, &rs1, &re1);
          recover(d2, s_neg, sc.l2, sc.read2.data(), sc.neg2.data(),
                  mp.split_mode ? ss2[pr.second] : 0, &rs2, &re2);
          uint16_t al1 = (uint16_t)(re1 - rs1 + 1);
          uint16_t al2 = (uint16_t)(re2 - rs2 + 1);
          int nc1 = (int)(f_neg ? sc.s1.negative_candidates.size()
                                : sc.s1.positive_candidates.size());
          int nc2 = (int)(s_neg ? sc.s2.negative_candidates.size()
                                : sc.s2.positive_candidates.size());
          uint8_t mapq, mq1 = 0, mq2 = 0;
          MapqPairedEnd(mp, d1.num_errors, d2.num_errors, al1, al2, sc.l1, sc.l2,
                        force_mapq, ps, sc.vs1, sc.vs2,
                        sc.s1.repetitive_seed_length, sc.s2.repetitive_seed_length,
                        &mapq, &mq1, &mq2, nc1, nc2);
          if (xout) {
            xout->rs1[sink.n] = rs1;
            xout->re1[sink.n] = re1;
            xout->rs2[sink.n] = rs2;
            xout->re2[sink.n] = re2;
            xout->err1[sink.n] = (uint8_t)d1.num_errors;
            xout->err2[sink.n] = (uint8_t)d2.num_errors;
            xout->mapq1[sink.n] = mq1;
            xout->mapq2[sink.n] = mq2;
            xout->rid2[sink.n] = (int32_t)(d2.position >> 32);
            xout->dir2[sink.n] = s_neg ? 0 : 1;
          }
          uint32_t frag_start = f_neg ? rs2 : rs1;
          uint16_t frag_len = f_neg ? (uint16_t)(re1 - rs2 + 1)
                                    : (uint16_t)(re2 - rs1 + 1);
          sink.rid[sink.n] = (int32_t)(d1.position >> 32);
          sink.read_id[sink.n] = (uint32_t)(base_read_id + pi);
          sink.start[sink.n] = frag_start;
          sink.flen[sink.n] = frag_len;
          sink.mapq[sink.n] = mapq & 0x3F;
          sink.dir[sink.n] = f_neg ? 0 : 1;
          sink.uniq[sink.n] = (uint8_t)is_unique;
          sink.posalen[sink.n] = f_neg ? al2 : al1;
          sink.negalen[sink.n] = f_neg ? al1 : al2;
          ++sink.n;
          ++num_reported;
          if (num_reported ==
              std::min(mp.max_num_best_mappings, ps.num_best_mappings))
            break;
        }
        ++best_mapping_index;
      }
    }
    if (g_prof.on) g_prof.select += PhaseProf::Now() - tsel;
  };

  SelSink gsink{out_rid, out_read_id, out_start, out_flen, out_mapq,
                out_dir,  out_uniq,    out_posalen, out_negalen, 0};
  if (mt || pre) {
    auto& W = pre ? pre->work : ctx->mt_work;
    const int T = ctx->num_threads;
    // emit is parallel-safe except for the paths that append to shared
    // ctx streams (SAM CIGAR/MD) or write caller side-arrays indexed by
    // the global record counter (xout)
    const bool par_sel = T > 1 && !mp.sam_mode && xout == nullptr;
    if (par_sel) {
      {
        std::vector<std::thread> threads;
        auto prep_range = [&](int64_t lo, int64_t hi) {
          for (int64_t pi = lo; pi < hi; ++pi) select_prep(pi, W[pi]);
        };
        for (int t = 1; t < T; ++t)
          threads.emplace_back(prep_range, num_pairs * t / T,
                               num_pairs * (t + 1) / T);
        prep_range(0, num_pairs / T);
        for (auto& th : threads) th.join();
      }
      for (int64_t pi = 0; pi < num_pairs; ++pi) select_draw(pi, W[pi]);
      // per-range local sinks, merged in range order so records land in
      // pair order exactly as the sequential path emits them
      struct RangeBuf {
        std::vector<int32_t> rid;
        std::vector<uint32_t> read_id, start;
        std::vector<uint16_t> flen, posalen, negalen;
        std::vector<uint8_t> mapq, dir, uniq;
        int64_t n = 0;
      };
      std::vector<RangeBuf> bufs(T);
      auto emit_range = [&](int r, int64_t lo, int64_t hi) {
        RangeBuf& b = bufs[r];
        int64_t cap = 0;
        for (int64_t pi = lo; pi < hi; ++pi) cap += W[pi].to_report;
        b.rid.resize(cap);
        b.read_id.resize(cap);
        b.start.resize(cap);
        b.flen.resize(cap);
        b.posalen.resize(cap);
        b.negalen.resize(cap);
        b.mapq.resize(cap);
        b.dir.resize(cap);
        b.uniq.resize(cap);
        SelSink sink{b.rid.data(), b.read_id.data(), b.start.data(),
                     b.flen.data(), b.mapq.data(),   b.dir.data(),
                     b.uniq.data(), b.posalen.data(), b.negalen.data(),
                     0};
        for (int64_t pi = lo; pi < hi; ++pi)
          select_emit(pi, W[pi], sink);
        b.n = sink.n;
      };
      {
        std::vector<std::thread> threads;
        for (int t = 1; t < T; ++t)
          threads.emplace_back(emit_range, t, num_pairs * t / T,
                               num_pairs * (t + 1) / T);
        emit_range(0, 0, num_pairs / T);
        for (auto& th : threads) th.join();
      }
      for (int r = 0; r < T; ++r) {
        RangeBuf& b = bufs[r];
        if (!b.n) continue;
        memcpy(gsink.rid + gsink.n, b.rid.data(), b.n * sizeof(int32_t));
        memcpy(gsink.read_id + gsink.n, b.read_id.data(),
               b.n * sizeof(uint32_t));
        memcpy(gsink.start + gsink.n, b.start.data(),
               b.n * sizeof(uint32_t));
        memcpy(gsink.flen + gsink.n, b.flen.data(), b.n * sizeof(uint16_t));
        memcpy(gsink.posalen + gsink.n, b.posalen.data(),
               b.n * sizeof(uint16_t));
        memcpy(gsink.negalen + gsink.n, b.negalen.data(),
               b.n * sizeof(uint16_t));
        memcpy(gsink.mapq + gsink.n, b.mapq.data(), b.n);
        memcpy(gsink.dir + gsink.n, b.dir.data(), b.n);
        memcpy(gsink.uniq + gsink.n, b.uniq.data(), b.n);
        gsink.n += b.n;
      }
    } else {
      for (int64_t pi = 0; pi < num_pairs; ++pi) {
        select_prep(pi, W[pi]);
        select_draw(pi, W[pi]);
        select_emit(pi, W[pi], gsink);
      }
    }
  } else {
    // plain path: run each phase over a window of pairs back-to-back
    // (identical per-pair order; see SeedPairPrep)
    constexpr int64_t kWin = 32;
    const int64_t wn = std::min<int64_t>(kWin, num_pairs);
    if ((int64_t)ctx->win_work.size() < wn)
      ctx->win_work.resize((size_t)wn);
    for (int64_t base = 0; base < num_pairs; base += kWin) {
      const int64_t hi = std::min<int64_t>(base + kWin, num_pairs);
      for (int64_t pi = base; pi < hi; ++pi)
        SeedPairPrep(ctx, pi, r1_bytes, r1_offsets, r2_bytes, r2_offsets,
                     dev, dev && devflag[pi], dev ? dmeta[2 * pi] : 0,
                     dev ? dmeta[2 * pi + 1] : 0,
                     dev ? dcurs[2 * pi] : 0, dev ? dcurs[2 * pi + 1] : 0,
                     ctx->win_work[pi - base]);
      for (int64_t pi = base; pi < hi; ++pi)
        SeedVerifyRest(ctx, pi, cache_update_threshold, hist_valid.data(),
                       dev, collect_mode, ext, ctx->win_work[pi - base]);
      for (int64_t pi = base; pi < hi; ++pi) {
        PairScratch& sc = ctx->win_work[pi - base];
        select_prep(pi, sc);
        select_draw(pi, sc);
        select_emit(pi, sc, gsink);
      }
    }
  }
  out_n = gsink.n;

  // cache updates in pair order, end1 then end2
  if (g_prof.on) {
    fprintf(stderr,
            "[native-profile] mz=%.3fs cand=%.3fs supp=%.3fs verify=%.3fs "
            "select=%.3fs\n",
            g_prof.mz / 1e9, g_prof.cand / 1e9, g_prof.supp / 1e9,
            g_prof.verify / 1e9, g_prof.select / 1e9);
    g_prof = PhaseProf();
  }
  {
    auto* hist = pre ? pre->history.data() : ctx->history.data();
    const uint8_t* hv = pre ? pre->hist_valid.data() : hist_valid.data();
    int64_t hn = pre ? std::min((int64_t)pre->history.size(),
                                pre->threshold)
                     : std::min((int64_t)ctx->history.size(),
                                cache_update_threshold);
    for (int64_t pi = 0; !collect_mode && !ctx->cache_off && pi < hn;
         ++pi) {
      if (!hv[pi]) continue;
      auto& he = hist[pi];
      ctx->cache.Update(he.first.mzs, he.first.pos, he.first.neg,
                        he.first.rep);
      ctx->cache.Update(he.second.mzs, he.second.pos, he.second.neg,
                        he.second.rep);
    }
  }

  if (stats) {
    stats[0] = st_cand;
    stats[1] = st_map;
    stats[2] = st_mapped;
    stats[3] = st_uniq;
    stats[4] = st_hits;
  }
  return collect_mode ? (int64_t)ctx->wb_pattern_starts.size() : out_n;
}

int64_t cn_map_pairs(
    CnContext* ctx, const char* r1_bytes, const int64_t* r1_offsets,
    const char* r2_bytes, const int64_t* r2_offsets, int64_t num_pairs,
    int64_t base_read_id, int64_t cache_update_threshold, int32_t* out_rid,
    uint32_t* out_read_id, uint32_t* out_start, uint16_t* out_flen,
    uint8_t* out_mapq, uint8_t* out_dir, uint8_t* out_uniq,
    uint16_t* out_posalen, uint16_t* out_negalen, int64_t* stats) {
  return MapPairsCore(ctx, r1_bytes, r1_offsets, r2_bytes, r2_offsets,
                      num_pairs, base_read_id, cache_update_threshold,
                      out_rid, out_read_id, out_start, out_flen, out_mapq,
                      out_dir, out_uniq, out_posalen, out_negalen, stats, 0,
                      nullptr, nullptr);
}

// Phase-1 only (seed + verify) for one chunk of pairs, into a detached
// chunk state. Lets the CPU work through host chunks while the device
// seeds others; cn_phase1_finish later runs selection in chunk order, so
// the single mt19937 stream (and the output) is preserved.
Phase1Chunk* cn_phase1_run(CnContext* ctx, const char* r1_bytes,
                           const int64_t* r1_offsets, const char* r2_bytes,
                           const int64_t* r2_offsets, int64_t num_pairs,
                           int64_t cache_update_threshold) {
  Phase1Chunk* ch;
  if (!ctx->chunk_pool.empty()) {
    ch = ctx->chunk_pool.back();
    ctx->chunk_pool.pop_back();
  } else {
    ch = new Phase1Chunk;
  }
  ch->n = num_pairs;
  ch->threshold = cache_update_threshold;
  if ((int64_t)ch->work.size() < num_pairs)
    ch->work.resize((size_t)num_pairs);
  ch->hist_valid.assign((size_t)num_pairs, 0);
  if (cache_update_threshold > 0
      && (int64_t)ch->history.size() < num_pairs)
    ch->history.resize((size_t)num_pairs);
  int T = ctx->num_threads;
  auto run_range = [&](int64_t lo, int64_t hi) {
    for (int64_t pi = lo; pi < hi; ++pi)
      SeedAndVerifyPair(ctx, pi, r1_bytes, r1_offsets, r2_bytes,
                        r2_offsets, cache_update_threshold,
                        ch->hist_valid.data(), nullptr, false, 0, 0, 0, 0,
                        0, nullptr, ch->work[pi], ch->history.data());
  };
  if (T > 1) {
    std::vector<std::thread> threads;
    for (int t = 1; t < T; ++t)
      threads.emplace_back(run_range, num_pairs * t / T,
                           num_pairs * (t + 1) / T);
    run_range(0, num_pairs / T);
    for (auto& th : threads) th.join();
  } else {
    run_range(0, num_pairs);
  }
  return ch;
}

// Selection + records for a phase-1 chunk (in chunk order); frees it.
int64_t cn_phase1_finish(
    CnContext* ctx, Phase1Chunk* ch, int64_t base_read_id, int32_t* out_rid,
    uint32_t* out_read_id, uint32_t* out_start, uint16_t* out_flen,
    uint8_t* out_mapq, uint8_t* out_dir, uint8_t* out_uniq,
    uint16_t* out_posalen, uint16_t* out_negalen, int64_t* stats) {
  int64_t r = MapPairsCore(ctx, nullptr, nullptr, nullptr, nullptr, ch->n,
                           base_read_id, ch->threshold, out_rid,
                           out_read_id, out_start, out_flen, out_mapq,
                           out_dir, out_uniq, out_posalen, out_negalen,
                           stats, 0, nullptr, nullptr, nullptr, nullptr,
                           ch);
  ctx->chunk_pool.push_back(ch);
  return r;
}

// Enable SAM mode: alignment scoring for the CIGAR-producing recover path.
void cn_set_sam_params(CnContext* ctx, int match_score, int mismatch,
                       int gap_open_del, int gap_open_ins, int gap_ext_del,
                       int gap_ext_ins) {
  ctx->mp.sam_mode = true;
  ctx->mp.match_score = match_score;
  ctx->mp.mismatch_penalty = mismatch;
  ctx->mp.gap_open[0] = gap_open_del;
  ctx->mp.gap_open[1] = gap_open_ins;
  ctx->mp.gap_ext[0] = gap_ext_del;
  ctx->mp.gap_ext[1] = gap_ext_ins;
}

// Per-pair flags from the last paired mapping call (bit0 = cache hit on
// either end); returns the pair count.
int64_t cn_get_pair_flags(CnContext* ctx, const uint8_t** flags) {
  *flags = ctx->pair_flags.data();
  return (int64_t)ctx->pair_flags.size();
}

// Per-pair read lengths after adapter trimming from the last paired
// mapping call; returns the pair count.
int64_t cn_get_pair_trimmed_lengths(CnContext* ctx, const uint16_t** tl1,
                                    const uint16_t** tl2) {
  *tl1 = ctx->pair_tl1.data();
  *tl2 = ctx->pair_tl2.data();
  return (int64_t)ctx->pair_tl1.size();
}

// Custom chromosome order (--chr-order): rank per original rid
// (chromap.cc:867-914 builds the table; candidates rerank pre-verification)
void cn_set_rid_rank(CnContext* ctx, const int32_t* rank, int32_t n) {
  ctx->rid_rank.assign(rank, rank + n);
}

// Enable Hi-C split (drop-off) alignment.
void cn_set_split_mode(CnContext* ctx) { ctx->mp.split_mode = true; }

// --debug-cache: verbose candidate-cache tracing (mmcache.hpp:300-330).
void cn_set_debug_cache(CnContext* ctx) { ctx->cache.debug = true; }

void cn_set_cache_off(CnContext* ctx) { ctx->cache_off = true; }

// End-of-run per-slot cache stats (mmcache.hpp:371-386; chromap.h:1402).
void cn_cache_print_stats(CnContext* ctx) { ctx->cache.PrintStats(); }

// SAM-mode alignment outputs for the last cn_map_pairs_full call: CIGARs,
// NM and MD per end-record (two per emitted row, end1 then end2).
int64_t cn_get_sam_aux(CnContext* ctx, const uint32_t** cigar_buf,
                       const int64_t** cigar_offsets, const char** md_buf,
                       const int64_t** md_offsets, const uint16_t** nm,
                       int64_t* md_len) {
  *cigar_buf = ctx->sam_cigar_buf.data();
  *cigar_offsets = ctx->sam_cigar_offsets.data();
  *md_buf = ctx->sam_md_buf.data();
  *md_offsets = ctx->sam_md_offsets.data();
  *nm = ctx->sam_nm.data();
  *md_len = (int64_t)ctx->sam_md_buf.size();
  return (int64_t)ctx->sam_nm.size();
}

// ---- native SAM text assembly ------------------------------------------
// The per-record layer of the SAM flow (flags, mate fields, strand
// orientation, CIGAR text, consumed-length trimming, line rendering --
// mapping_writer.cc:310-379 plus the flag logic of the Python
// _map_batch_native_sam loop it replaces). Produces one rendered line per
// end-record (no CB tag, no newline: the writer appends those) plus the
// integer key fields the Python sort/dedup consumes (sam_mapping.h:
// 201-216 orders).

void cn_set_sam_refnames(CnContext* ctx, const char* bytes,
                         const int64_t* offsets, int32_t n) {
  ctx->samref_off.assign(offsets, offsets + n + 1);
  ctx->samref_bytes.assign(bytes, bytes + offsets[n]);
}

static inline void AppendInt(std::vector<char>& out, int64_t v) {
  char tmp[24];
  int len = 0;
  bool neg = v < 0;
  uint64_t u = neg ? (uint64_t)(-v) : (uint64_t)v;
  do {
    tmp[len++] = (char)('0' + (u % 10));
    u /= 10;
  } while (u);
  if (neg) out.push_back('-');
  for (int i = len - 1; i >= 0; --i) out.push_back(tmp[i]);
}

static const char kCigarOpChar[16] = {'M', 'I', 'D', 'N', 'S', 'H',
                                      'P', '=', 'X', '?', '?', '?',
                                      '?', '?', '?', '?'};

int64_t cn_sam_text(
    CnContext* ctx, int64_t n_rec, const uint32_t* rread,
    const uint8_t* rdir, const int32_t* rrid, const uint32_t* rs1,
    const uint32_t* re1, const uint32_t* rs2, const uint32_t* re2,
    const uint8_t* rmapq, const uint8_t* runiq, const uint32_t* cig_buf,
    const int64_t* cig_off, const char* md_buf, const int64_t* md_off,
    const uint16_t* nm_arr, const char* names, const int64_t* name_off,
    const char* s1, const int64_t* o1, const char* s2, const int64_t* o2,
    const char* q1, const int64_t* qo1, const char* q2,
    const int64_t* qo2, const uint16_t* tl1, const uint16_t* tl2,
    const uint32_t* orig_read_id) {
  auto& text = ctx->samtx_text;
  auto& loff = ctx->samtx_off;
  text.clear();
  loff.assign(1, 0);
  const int64_t n2 = 2 * n_rec;
  ctx->samtx_rid.resize(n2);
  ctx->samtx_pos.resize(n2);
  ctx->samtx_mpos.resize(n2);
  ctx->samtx_read_id.resize(n2);
  ctx->samtx_refend.resize(n2);
  ctx->samtx_flag.resize(n2);
  ctx->samtx_mapq.resize(n2);
  ctx->samtx_uniq.resize(n2);
  text.reserve((size_t)n2 * 192);
  std::vector<char> oriented;
  uint32_t prev_read_id = 0;
  bool have_prev = false;
  int occurrence = 0;
  for (int64_t i = 0; i < n_rec; ++i) {
    const int64_t j = (int64_t)rread[i];
    const uint32_t read_id = orig_read_id[j];
    occurrence = (have_prev && read_id == prev_read_id) ? occurrence + 1
                                                        : 0;
    prev_read_id = read_id;
    have_prev = true;
    const bool first_neg = rdir[i] == 0;
    const int64_t tlen = first_neg
                             ? (int64_t)re1[i] - (int64_t)rs2[i] + 1
                             : (int64_t)re2[i] - (int64_t)rs1[i] + 1;
    int flag1 = 3 | 0x40, flag2 = 3 | 0x80;
    if (first_neg) {
      flag1 |= 0x10;
      flag2 |= 0x20;
    } else {
      flag1 |= 0x20;
      flag2 |= 0x10;
    }
    if (occurrence >= 1) {
      flag1 |= 0x100;
      flag2 |= 0x100;
    }
    const int32_t rid = rrid[i];
    for (int end = 0; end < 2; ++end) {
      const int64_t k = 2 * i + end;
      const int flagv = end == 0 ? flag1 : flag2;
      const uint32_t pos = end == 0 ? rs1[i] : rs2[i];
      const uint32_t mpos = end == 0 ? rs2[i] : rs1[i];
      const bool neg = end == 0 ? first_neg : !first_neg;
      const char* seq = end == 0 ? s1 + o1[j] : s2 + o2[j];
      int64_t slen = end == 0 ? o1[j + 1] - o1[j] : o2[j + 1] - o2[j];
      const char* qv = end == 0 ? q1 + qo1[j] : q2 + qo2[j];
      int64_t qlen = end == 0 ? qo1[j + 1] - qo1[j] : qo2[j + 1] - qo2[j];
      if (end == 0 && tl1 && (int64_t)tl1[j] < slen) {
        slen = tl1[j];
        if (qlen > slen) qlen = slen;
      }
      if (end == 1 && tl2 && (int64_t)tl2[j] < slen) {
        slen = tl2[j];
        if (qlen > slen) qlen = slen;
      }
      const uint32_t* cig = cig_buf + cig_off[k];
      const int64_t ncig = cig_off[k + 1] - cig_off[k];
      int64_t ncons = 0, nref = 0;
      for (int64_t c = 0; c < ncig; ++c) {
        const uint32_t op = cig[c] & 0xF;
        const uint32_t ln = cig[c] >> 4;
        if (op == 0 || op == 1 || op == 4) ncons += ln;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
          nref += ln;
      }
      // orient to the mapping strand, then truncate to the
      // query-consumed length (SAMMapping::GetSequenceLength)
      oriented.clear();
      if (neg) {
        oriented.reserve((size_t)(slen + qlen));
        for (int64_t b = slen - 1; b >= 0; --b) {
          const char ch = seq[b];
          char rc;
          switch (ch) {
            case 'A': rc = 'T'; break;
            case 'C': rc = 'G'; break;
            case 'G': rc = 'C'; break;
            case 'T': rc = 'A'; break;
            case 'a': rc = 't'; break;
            case 'c': rc = 'g'; break;
            case 'g': rc = 'c'; break;
            case 't': rc = 'a'; break;
            default: rc = ch;
          }
          oriented.push_back(rc);
        }
        for (int64_t b = qlen - 1; b >= 0; --b) oriented.push_back(qv[b]);
      } else {
        oriented.assign(seq, seq + slen);
        oriented.insert(oriented.end(), qv, qv + qlen);
      }
      const int64_t out_slen = ncons < slen ? ncons : slen;
      const int64_t out_qlen = ncons < qlen ? ncons : qlen;

      // line: name flag refname pos+1 mapq cigar = mpos+1 tlen seq qual
      //       NM:i:x MD:Z:md   (tab-separated; no CB tag, no newline)
      text.insert(text.end(), names + name_off[j], names + name_off[j + 1]);
      text.push_back('\t');
      AppendInt(text, flagv);
      text.push_back('\t');
      text.insert(text.end(),
                  ctx->samref_bytes.data() + ctx->samref_off[rid],
                  ctx->samref_bytes.data() + ctx->samref_off[rid + 1]);
      text.push_back('\t');
      AppendInt(text, (int64_t)pos + 1);
      text.push_back('\t');
      AppendInt(text, rmapq[i]);
      text.push_back('\t');
      if (ncig == 0) {
        text.push_back('*');
      } else {
        for (int64_t c = 0; c < ncig; ++c) {
          AppendInt(text, cig[c] >> 4);
          text.push_back(kCigarOpChar[cig[c] & 0xF]);
        }
      }
      text.push_back('\t');
      text.push_back('=');
      text.push_back('\t');
      AppendInt(text, (int64_t)mpos + 1);
      text.push_back('\t');
      AppendInt(text, neg ? -tlen : tlen);
      text.push_back('\t');
      text.insert(text.end(), oriented.data(), oriented.data() + out_slen);
      text.push_back('\t');
      text.insert(text.end(), oriented.data() + slen,
                  oriented.data() + slen + out_qlen);
      text.insert(text.end(), {'\t', 'N', 'M', ':', 'i', ':'});
      AppendInt(text, nm_arr[k]);
      text.insert(text.end(), {'\t', 'M', 'D', ':', 'Z', ':'});
      text.insert(text.end(), md_buf + md_off[k], md_buf + md_off[k + 1]);
      loff.push_back((int64_t)text.size());

      ctx->samtx_rid[k] = rid;
      ctx->samtx_pos[k] = pos;
      ctx->samtx_mpos[k] = mpos;
      ctx->samtx_read_id[k] = read_id;
      ctx->samtx_refend[k] = pos + (uint32_t)(nref ? nref - 1 : 0) + 1;
      ctx->samtx_flag[k] = (uint16_t)flagv;
      ctx->samtx_mapq[k] = rmapq[i];
      ctx->samtx_uniq[k] = runiq[i];
    }
  }
  return n2;
}

int64_t cn_get_sam_text(CnContext* ctx, const char** text,
                        const int64_t** line_off, const int32_t** rid,
                        const uint32_t** pos, const uint32_t** mpos,
                        const uint32_t** read_id, const uint32_t** refend,
                        const uint16_t** flag, const uint8_t** mapq,
                        const uint8_t** uniq, int64_t* text_len) {
  *text = ctx->samtx_text.data();
  *line_off = ctx->samtx_off.data();
  *rid = ctx->samtx_rid.data();
  *pos = ctx->samtx_pos.data();
  *mpos = ctx->samtx_mpos.data();
  *read_id = ctx->samtx_read_id.data();
  *refend = ctx->samtx_refend.data();
  *flag = ctx->samtx_flag.data();
  *mapq = ctx->samtx_mapq.data();
  *uniq = ctx->samtx_uniq.data();
  *text_len = (int64_t)ctx->samtx_text.size();
  return (int64_t)ctx->samtx_rid.size();
}

// Extended variant: also emits per-end reference start/end, per-end error
// counts, and per-end MAPQ (PAF/pairs/SAM record construction,
// mapping_generator.h:655-917).
int64_t cn_map_pairs_full(
    CnContext* ctx, const char* r1_bytes, const int64_t* r1_offsets,
    const char* r2_bytes, const int64_t* r2_offsets, int64_t num_pairs,
    int64_t base_read_id, int64_t cache_update_threshold, int32_t* out_rid,
    uint32_t* out_read_id, uint32_t* out_start, uint16_t* out_flen,
    uint8_t* out_mapq, uint8_t* out_dir, uint8_t* out_uniq,
    uint16_t* out_posalen, uint16_t* out_negalen, uint32_t* out_rs1,
    uint32_t* out_re1, uint32_t* out_rs2, uint32_t* out_re2,
    uint8_t* out_err1, uint8_t* out_err2, uint8_t* out_mapq1,
    uint8_t* out_mapq2, int32_t* out_rid2, uint8_t* out_dir2,
    int64_t* stats) {
  PEExtOut xout = {out_rs1, out_re1, out_rs2, out_re2,
                   out_err1, out_err2, out_mapq1, out_mapq2,
                   out_rid2, out_dir2};
  return MapPairsCore(ctx, r1_bytes, r1_offsets, r2_bytes, r2_offsets,
                      num_pairs, base_read_id, cache_update_threshold,
                      out_rid, out_read_id, out_start, out_flen, out_mapq,
                      out_dir, out_uniq, out_posalen, out_negalen, stats, 0,
                      nullptr, nullptr, nullptr, &xout);
}

// Device-seeded mapping: candidates + verification results come from the
// TPU front end (ops/device_seed.py); flagged pairs re-run the exact
// native path. The candidate cache is disabled (it is a host-seeding
// memoization; outputs are identical without it).
int64_t cn_map_pairs_dev(
    CnContext* ctx, const char* r1_bytes, const int64_t* r1_offsets,
    const char* r2_bytes, const int64_t* r2_offsets, int64_t num_pairs,
    int64_t base_read_id, const uint64_t* read_meta,
    const uint64_t* cand_pos, const uint32_t* cand_meta, int32_t* out_rid,
    uint32_t* out_read_id, uint32_t* out_start, uint16_t* out_flen,
    uint8_t* out_mapq, uint8_t* out_dir, uint8_t* out_uniq,
    uint16_t* out_posalen, uint16_t* out_negalen, int64_t* stats,
    const uint64_t* cand_split) {
  DevSeedView dev = {read_meta, cand_pos, cand_meta, cand_split};
  return MapPairsCore(ctx, r1_bytes, r1_offsets, r2_bytes, r2_offsets,
                      num_pairs, base_read_id, /*cache_update_threshold=*/0,
                      out_rid, out_read_id, out_start, out_flen, out_mapq,
                      out_dir, out_uniq, out_posalen, out_negalen, stats, 0,
                      nullptr, nullptr, &dev);
}

// Device-seeded extended mapping: cn_map_pairs_dev plus the per-end
// outputs of cn_map_pairs_full (PAF/pairs/SAM flows on the device path).
int64_t cn_map_pairs_dev_full(
    CnContext* ctx, const char* r1_bytes, const int64_t* r1_offsets,
    const char* r2_bytes, const int64_t* r2_offsets, int64_t num_pairs,
    int64_t base_read_id, const uint64_t* read_meta,
    const uint64_t* cand_pos, const uint32_t* cand_meta, int32_t* out_rid,
    uint32_t* out_read_id, uint32_t* out_start, uint16_t* out_flen,
    uint8_t* out_mapq, uint8_t* out_dir, uint8_t* out_uniq,
    uint16_t* out_posalen, uint16_t* out_negalen, uint32_t* out_rs1,
    uint32_t* out_re1, uint32_t* out_rs2, uint32_t* out_re2,
    uint8_t* out_err1, uint8_t* out_err2, uint8_t* out_mapq1,
    uint8_t* out_mapq2, int32_t* out_rid2, uint8_t* out_dir2,
    int64_t* stats, const uint64_t* cand_split) {
  DevSeedView dev = {read_meta, cand_pos, cand_meta, cand_split};
  PEExtOut xout = {out_rs1, out_re1, out_rs2, out_re2,
                   out_err1, out_err2, out_mapq1, out_mapq2,
                   out_rid2, out_dir2};
  return MapPairsCore(ctx, r1_bytes, r1_offsets, r2_bytes, r2_offsets,
                      num_pairs, base_read_id, /*cache_update_threshold=*/0,
                      out_rid, out_read_id, out_start, out_flen, out_mapq,
                      out_dir, out_uniq, out_posalen, out_negalen, stats, 0,
                      nullptr, nullptr, &dev, &xout);
}

// Phase 1 for device verification: collect all verification work items.
int64_t cn_collect_pairs(CnContext* ctx, const char* r1_bytes,
                         const int64_t* r1_offsets, const char* r2_bytes,
                         const int64_t* r2_offsets, int64_t num_pairs,
                         const int64_t** pattern_starts,
                         const int32_t** text_offsets,
                         const int32_t** text_lengths,
                         const uint8_t** text_codes,
                         int64_t* text_codes_len) {
  int64_t n = MapPairsCore(ctx, r1_bytes, r1_offsets, r2_bytes, r2_offsets,
                           num_pairs, 0, 0, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, 1, nullptr, nullptr);
  *pattern_starts = ctx->wb_pattern_starts.data();
  *text_offsets = ctx->wb_text_offsets.data();
  *text_lengths = ctx->wb_text_lengths.data();
  *text_codes = ctx->wb_text_codes.data();
  *text_codes_len = (int64_t)ctx->wb_text_codes.size();
  return n;
}

// Phase 2: consume device-computed (errors, ends) in collection order.
int64_t cn_map_pairs_ext(
    CnContext* ctx, const char* r1_bytes, const int64_t* r1_offsets,
    const char* r2_bytes, const int64_t* r2_offsets, int64_t num_pairs,
    int64_t base_read_id, int64_t cache_update_threshold,
    const int32_t* errors, const int32_t* ends, int32_t* out_rid,
    uint32_t* out_read_id, uint32_t* out_start, uint16_t* out_flen,
    uint8_t* out_mapq, uint8_t* out_dir, uint8_t* out_uniq,
    uint16_t* out_posalen, uint16_t* out_negalen, int64_t* stats) {
  return MapPairsCore(ctx, r1_bytes, r1_offsets, r2_bytes, r2_offsets,
                      num_pairs, base_read_id, cache_update_threshold,
                      out_rid, out_read_id, out_start, out_flen, out_mapq,
                      out_dir, out_uniq, out_posalen, out_negalen, stats, 0,
                      errors, ends);
}


// --------------------------- single-end mapping ---------------------------

static int64_t MapSingleCore(
    CnContext* ctx, const char* r_bytes, const int64_t* r_offsets,
    int64_t num_reads, int64_t base_read_id, int64_t cache_update_threshold,
    int32_t* out_rid, uint32_t* out_read_id, uint32_t* out_start,
    uint16_t* out_flen, uint8_t* out_mapq, uint8_t* out_dir,
    uint8_t* out_uniq, int64_t* stats, const DevSeedView* dev) {
  const MappingParams& mp = ctx->mp;
  const IndexView& idx = ctx->idx;
  const RefView& ref = ctx->ref;
  int e = mp.error_threshold;
  int64_t out_n = 0;

  ctx->history.clear();
  if (cache_update_threshold > 0) ctx->history.resize((size_t)num_reads);
  std::vector<uint8_t> hist_valid(num_reads, 0);
  ctx->pair_flags.assign((size_t)num_reads, 0);

  // device-seed bookkeeping: per-read candidate cursors; fallback-flagged
  // reads re-run the exact path (single-end never mate-rescues, so the
  // AUGMENT flag is irrelevant here)
  std::vector<int64_t> dcurs;
  std::vector<uint8_t> devflag;
  if (dev) {
    dcurs.resize(num_reads);
    devflag.resize(num_reads);
    int64_t cursor = 0;
    for (int64_t pi = 0; pi < num_reads; ++pi) {
      uint64_t m = dev->read_meta[pi];
      dcurs[pi] = cursor;
      cursor += (int64_t)((m >> 32) & 0xFF) + (int64_t)((m >> 40) & 0xFF);
      devflag[pi] = ((m >> 24) & kDevFlagFallback) == 0 ? 1 : 0;
    }
  }

  // Single-end selection draws from a fresh mt19937(11) per read
  // (mapping_generator.h:128), so whole reads parallelize -- including
  // selection -- with ordered per-range output buffers.
  struct SEEmit {
    std::vector<int32_t> rid;
    std::vector<uint32_t> read_id, start;
    std::vector<uint16_t> flen;
    std::vector<uint8_t> mapq, dir, uniq;
    int64_t st_cand = 0, st_map = 0, st_mapped = 0, st_uniq = 0,
            st_hits = 0;
  };
  struct SEScratch {
    SeedState s1;
    VerifyState vs1;
    std::vector<char> read1, neg1;
    std::vector<uint8_t> codes1;
    std::vector<int> best_indices;
  };

  auto process = [&](int64_t pi, SEScratch& sc, SEEmit& em) {
    int l1 = (int)(r_offsets[pi + 1] - r_offsets[pi]);
    if (l1 < mp.min_read_length) return;
    sc.read1.assign(r_bytes + r_offsets[pi], r_bytes + r_offsets[pi + 1]);
    sc.neg1.resize(l1);
    static const char code_char[8] = {'A', 'C', 'G', 'T', 'N', 'N', 'N', 'N'};
    for (int i = 0; i < l1; ++i) {
      uint8_t c = kCharToCode[(uint8_t)sc.read1[l1 - 1 - i]];
      sc.neg1[i] = code_char[c < 4 ? (3 ^ c) : 7];
    }
    sc.codes1.resize(l1);
    for (int i = 0; i < l1; ++i)
      sc.codes1[i] = kCharToCode[(uint8_t)sc.read1[i]];

    SeedState& s1 = sc.s1;
    s1.Clear();
    if (dev && devflag[pi]) {
      LoadDevSeed(*dev, dev->read_meta[pi], dcurs[pi], s1,
                  &s1.num_minimizers);
      if (s1.num_minimizers == 0) return;
    } else {
      GenerateMinimizers(sc.codes1.data(), l1, idx.k, idx.w, s1.minimizers);
      if (s1.minimizers.empty()) return;
      int q1 = ctx->cache.Query(s1.minimizers, l1, s1.positive_candidates,
                                s1.negative_candidates,
                                s1.repetitive_seed_length);
      if (q1 == -1) {
        GenerateCandidates(idx, mp, s1);
      } else {
        ++em.st_hits;
        ctx->pair_flags[pi] = 1;
      }
      if (pi < cache_update_threshold) {
        auto& he = ctx->history[pi];
        he.first.mzs = s1.minimizers;
        he.first.pos = s1.positive_candidates;
        he.first.neg = s1.negative_candidates;
        he.first.rep = s1.repetitive_seed_length;
        hist_valid[pi] = 1;
      }
    }
    if (s1.NumCandidates() == 0) return;
    em.st_cand += (int64_t)s1.NumCandidates();

    VerifyCandidates(mp, ref, sc.read1.data(), sc.neg1.data(), l1, s1,
                     sc.vs1);
    if (sc.vs1.NumDraft() == 0) return;
    VerifyState& vs = sc.vs1;

    em.st_map += std::min(vs.num_best_mappings, mp.max_num_best_mappings);
    ++em.st_mapped;
    if (vs.num_best_mappings == 1) ++em.st_uniq;

    std::vector<int>& best_indices = sc.best_indices;
    best_indices.resize(mp.max_num_best_mappings);
    for (int i = 0; i < mp.max_num_best_mappings; ++i) best_indices[i] = i;
    if (vs.num_best_mappings > mp.max_num_best_mappings) {
      std::mt19937 gen(11);  // fresh per read (mg.h:128)
      for (int i = mp.max_num_best_mappings; i < vs.num_best_mappings; ++i) {
        int j = LibstdcppUniformInt(gen, 0, i);
        if (j < mp.max_num_best_mappings) best_indices[j] = i;
      }
      std::sort(best_indices.begin(),
                best_indices.begin() + mp.max_num_best_mappings);
    }
    int to_report = std::min(vs.num_best_mappings, mp.max_num_best_mappings);
    int is_unique = vs.num_best_mappings == 1 ? 1 : 0;

    int best_mapping_index = 0, num_reported = 0;
    for (int strand = 0; strand < 2 && num_reported != to_report; ++strand) {
      bool neg = strand == 1;
      const auto& mappings = neg ? vs.negative_mappings
                                 : vs.positive_mappings;
      for (const auto& d : mappings) {
        if (d.num_errors > vs.min_num_errors) continue;
        if (best_mapping_index == best_indices[num_reported]) {
          uint32_t rid = (uint32_t)(d.position >> 32);
          uint32_t ref_position = (uint32_t)d.position;
          int64_t rl = ref.Len(rid);
          int64_t vws;
          if ((uint64_t)ref_position + 1 > (uint64_t)(l1 + e))
            vws = (int64_t)ref_position + 1 - l1 - e;
          else
            vws = 0;
          if ((uint64_t)ref_position + e >= (uint64_t)rl)
            vws = (int64_t)(uint32_t)(rl - e - l1);
          if (vws > rl) vws = 0;
          const char* se_text = neg ? sc.neg1.data() : sc.read1.data();
          uint32_t rs, re_sam = ref_position;
          if (mp.sam_mode) {
            int start, endp;
            KswSemiGlobal3(l1 + 2 * e, ref.Seq(rid) + vws, l1, se_text, mp,
                           2 * e + 1, ctx->ksw_scratch, ctx->sam_tmp_cigar,
                           &start, &endp);
            int nm = GenerateNMMD(ref.Seq(rid), se_text, vws + start,
                                  ctx->sam_tmp_cigar, ctx->sam_tmp_md);
            ctx->sam_cigar_buf.insert(ctx->sam_cigar_buf.end(),
                                      ctx->sam_tmp_cigar.begin(),
                                      ctx->sam_tmp_cigar.end());
            ctx->sam_cigar_offsets.push_back(
                (int64_t)ctx->sam_cigar_buf.size());
            ctx->sam_md_buf += ctx->sam_tmp_md;
            ctx->sam_md_offsets.push_back((int64_t)ctx->sam_md_buf.size());
            ctx->sam_nm.push_back((uint16_t)nm);
            rs = (uint32_t)(vws + start);
            re_sam = (uint32_t)(vws + endp - 1);
          } else {
            int start_off = e;
            BandedTraceback(e, d.num_errors, ref.Seq(rid) + vws, se_text,
                            l1, &start_off);
            rs = (uint32_t)(vws + start_off);
          }
          uint16_t alen = (uint16_t)((mp.sam_mode ? re_sam : ref_position)
                                     - rs + 1);
          uint8_t mapq = MapqSingleEnd(mp, d.num_errors, alen, l1, e, vs,
                                       s1.repetitive_seed_length);
          em.rid.push_back((int32_t)rid);
          em.read_id.push_back((uint32_t)(base_read_id + pi));
          em.start.push_back(rs);
          em.flen.push_back(alen);
          em.mapq.push_back(mapq & 0x3F);
          em.dir.push_back(neg ? 0 : 1);
          em.uniq.push_back((uint8_t)is_unique);
          ++num_reported;
          if (num_reported ==
              std::min(mp.max_num_best_mappings, vs.num_best_mappings))
            break;
        }
        ++best_mapping_index;
      }
    }
  };

  // SAM mode appends to shared cigar/MD streams in emission order, so it
  // runs single-threaded (PE does the same: selection is sequential)
  const int T = (ctx->num_threads > 1 && !ctx->mp.sam_mode)
                    ? ctx->num_threads
                    : 1;
  if (ctx->mp.sam_mode) {
    ctx->sam_cigar_buf.clear();
    ctx->sam_cigar_offsets.assign(1, 0);
    ctx->sam_md_buf.clear();
    ctx->sam_md_offsets.assign(1, 0);
    ctx->sam_nm.clear();
  }
  std::vector<SEEmit> emits(T);
  {
    auto run_range = [&](int t) {
      SEScratch sc;
      int64_t lo = num_reads * t / T, hi = num_reads * (t + 1) / T;
      for (int64_t pi = lo; pi < hi; ++pi) process(pi, sc, emits[t]);
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < T; ++t) threads.emplace_back(run_range, t);
    run_range(0);
    for (auto& th : threads) th.join();
  }
  int64_t st_cand = 0, st_map = 0, st_mapped = 0, st_uniq = 0, st_hits = 0;
  for (const auto& em : emits) {
    for (size_t i = 0; i < em.rid.size(); ++i) {
      out_rid[out_n] = em.rid[i];
      out_read_id[out_n] = em.read_id[i];
      out_start[out_n] = em.start[i];
      out_flen[out_n] = em.flen[i];
      out_mapq[out_n] = em.mapq[i];
      out_dir[out_n] = em.dir[i];
      out_uniq[out_n] = em.uniq[i];
      ++out_n;
    }
    st_cand += em.st_cand;
    st_map += em.st_map;
    st_mapped += em.st_mapped;
    st_uniq += em.st_uniq;
    st_hits += em.st_hits;
  }

  for (int64_t pi = 0;
       pi < std::min((int64_t)ctx->history.size(), cache_update_threshold);
       ++pi) {
    if (!hist_valid[pi]) continue;
    auto& he = ctx->history[pi];
    ctx->cache.Update(he.first.mzs, he.first.pos, he.first.neg, he.first.rep);
  }

  if (stats) {
    stats[0] = st_cand;
    stats[1] = st_map;
    stats[2] = st_mapped;
    stats[3] = st_uniq;
    stats[4] = st_hits;
  }
  return out_n;
}

int64_t cn_map_single(
    CnContext* ctx, const char* r_bytes, const int64_t* r_offsets,
    int64_t num_reads, int64_t base_read_id, int64_t cache_update_threshold,
    int32_t* out_rid, uint32_t* out_read_id, uint32_t* out_start,
    uint16_t* out_flen, uint8_t* out_mapq, uint8_t* out_dir,
    uint8_t* out_uniq, int64_t* stats) {
  return MapSingleCore(ctx, r_bytes, r_offsets, num_reads, base_read_id,
                       cache_update_threshold, out_rid, out_read_id,
                       out_start, out_flen, out_mapq, out_dir, out_uniq,
                       stats, nullptr);
}

// Single-end finish from device-computed seeding + verification
// (ops/device_seed.py download, one meta per read, reads in order).
int64_t cn_map_single_dev(
    CnContext* ctx, const char* r_bytes, const int64_t* r_offsets,
    int64_t num_reads, int64_t base_read_id, const uint64_t* read_meta,
    const uint64_t* cand_pos, const uint32_t* cand_meta, int32_t* out_rid,
    uint32_t* out_read_id, uint32_t* out_start, uint16_t* out_flen,
    uint8_t* out_mapq, uint8_t* out_dir, uint8_t* out_uniq,
    int64_t* stats) {
  DevSeedView dev = {read_meta, cand_pos, cand_meta};
  return MapSingleCore(ctx, r_bytes, r_offsets, num_reads, base_read_id, 0,
                       out_rid, out_read_id, out_start, out_flen, out_mapq,
                       out_dir, out_uniq, stats, &dev);
}

}  // extern "C"

// ------------------------------ FASTQ reader ------------------------------

namespace {

struct FastxReader {
  gzFile f;
  FILE* plain = nullptr;  // non-gzip fast path: skip zlib's transparent copy
  std::vector<char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;
  // ping-pong batch buffers: the previous batch stays valid while the
  // next one loads (load/map overlap, the SwapSequenceBatch analog of
  // chromap.h:871-877)
  std::vector<char> seqs_bufs[2];        // concatenated batch sequences
  std::vector<int64_t> offsets_bufs[2];  // n+1
  int cur = 0;

  explicit FastxReader(const char* path) : f(nullptr) {
    buf.resize(1 << 20);
    FILE* probe = fopen(path, "rb");
    if (probe) {
      unsigned char magic[2] = {0, 0};
      size_t got = fread(magic, 1, 2, probe);
      if (got == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
        fclose(probe);
      } else {
        rewind(probe);
        plain = probe;
        setvbuf(plain, nullptr, _IONBF, 0);  // we buffer ourselves
        return;
      }
    }
    f = gzopen(path, "r");
  }
  ~FastxReader() {
    if (f) gzclose(f);
    if (plain) fclose(plain);
  }
  bool ok() const { return f != nullptr || plain != nullptr; }

  bool Refill() {
    if (eof) return false;
    int n = plain ? (int)fread(buf.data(), 1, buf.size(), plain)
                  : gzread(f, buf.data(), (unsigned)buf.size());
    if (n <= 0) {
      eof = true;
      return false;
    }
    len = (size_t)n;
    pos = 0;
    return true;
  }

  // reads one line (without newline) appending to out; returns false on EOF
  bool ReadLine(std::string& out) {
    out.clear();
    while (true) {
      if (pos >= len) {
        if (!Refill()) return !out.empty();
      }
      char* nl = (char*)memchr(buf.data() + pos, '\n', len - pos);
      if (nl) {
        out.append(buf.data() + pos, nl - (buf.data() + pos));
        pos = nl - buf.data() + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(buf.data() + pos, len - pos);
      pos = len;
    }
  }

  // appends one line directly to `sink` (no intermediate string); returns
  // false on EOF with nothing read
  bool ReadLineInto(std::vector<char>& sink) {
    size_t start = sink.size();
    while (true) {
      if (pos >= len) {
        if (!Refill()) return sink.size() != start;
      }
      char* nl = (char*)memchr(buf.data() + pos, '\n', len - pos);
      if (nl) {
        sink.insert(sink.end(), buf.data() + pos, nl);
        pos = nl - buf.data() + 1;
        if (sink.size() != start && sink.back() == '\r') sink.pop_back();
        return true;
      }
      sink.insert(sink.end(), buf.data() + pos, buf.data() + len);
      pos = len;
    }
  }

  // skips one line; returns false on EOF with nothing read
  bool SkipLine() {
    bool any = false;
    while (true) {
      if (pos >= len) {
        if (!Refill()) return any;
      }
      any = true;
      char* nl = (char*)memchr(buf.data() + pos, '\n', len - pos);
      if (nl) {
        pos = nl - buf.data() + 1;
        return true;
      }
      pos = len;
    }
  }

  // kseq-equivalent record parse; returns #records loaded (<= max_n)
  int64_t ReadBatch(int64_t max_n) {
    cur ^= 1;
    std::vector<char>& seqs = seqs_bufs[cur];
    std::vector<int64_t>& offsets = offsets_bufs[cur];
    seqs.clear();
    offsets.clear();
    offsets.push_back(0);
    std::string line, seq;
    int64_t n = 0;
    while (n < max_n) {
      if (!ReadLine(line)) break;
      if (line.empty()) continue;
      if (line[0] == '@') {
        size_t before = seqs.size();
        if (!ReadLineInto(seqs)) break;
        SkipLine();
        SkipLine();
        if (seqs.size() == before) continue;  // kseq skips empty records
        offsets.push_back((int64_t)seqs.size());
        ++n;
      } else if (line[0] == '>') {
        // FASTA record: accumulate until next header
        seq.clear();
        while (true) {
          std::string nxt;
          if (!ReadLine(nxt)) break;
          if (!nxt.empty() && (nxt[0] == '>' || nxt[0] == '@')) {
            // push back: emulate by prepending to buffer is complex; FASTA
            // reads are rare in the mapping path -- handled in Python
            break;
          }
          seq += nxt;
        }
        if (seq.empty()) continue;
        seqs.insert(seqs.end(), seq.begin(), seq.end());
        offsets.push_back((int64_t)seqs.size());
        ++n;
      }
    }
    return n;
  }

  // ---- the named batch: ReadBatch's reads with their names, parsed as
  // the port's Python FastxReader parses them (io/fastx.py), errors
  // included. Its own line readers, so ReadBatch's path is untouched.
  std::vector<char> names_bufs[2];        // concatenated batch names
  std::vector<int64_t> name_offsets_bufs[2];  // n+1
  std::string pending;  // a header line read past the end of a FASTA record
  bool has_pending = false;
  std::string error;    // set by a failed ReadBatchNamed
  int error_kind = 0;   // -1 malformed record, -2 the input ended badly

  static bool IsSpace(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f';
  }

  // Refill that tells a truncated gzip stream from its end
  bool NamedRefill() {
    if (eof) return false;
    int n = plain ? (int)fread(buf.data(), 1, buf.size(), plain)
                  : gzread(f, buf.data(), (unsigned)buf.size());
    if (n > 0) {
      len = (size_t)n;
      pos = 0;
      return true;
    }
    eof = true;
    int errnum = Z_OK;
    const char* msg = plain ? nullptr : gzerror(f, &errnum);
    if (n < 0 || (plain && ferror(plain)) ||
        (!plain && errnum != Z_OK && errnum != Z_STREAM_END)) {
      error = msg && *msg ? msg : "read error";
      error_kind = -2;
    }
    return false;
  }

  // one line without its '\n' and with every trailing '\r' stripped
  // (Python's rstrip(b"\r\n")); false at EOF with nothing read
  bool NamedLine(std::string& out) {
    out.clear();
    bool any = false;
    while (pos < len || NamedRefill()) {
      any = true;
      char* at = buf.data() + pos;
      char* nl = (char*)memchr(at, '\n', len - pos);
      if (nl) {
        out.append(at, nl - at);
        pos = nl - buf.data() + 1;
        break;
      }
      out.append(at, len - pos);
      pos = len;
    }
    while (!out.empty() && out.back() == '\r') out.pop_back();
    return any;
  }

  // NamedLine appended to `sink`
  void NamedLineInto(std::vector<char>& sink) {
    size_t start = sink.size();
    while (pos < len || NamedRefill()) {
      char* at = buf.data() + pos;
      char* nl = (char*)memchr(at, '\n', len - pos);
      if (nl) {
        sink.insert(sink.end(), at, nl);
        pos = nl - buf.data() + 1;
        break;
      }
      sink.insert(sink.end(), at, buf.data() + len);
      pos = len;
    }
    while (sink.size() > start && sink.back() == '\r') sink.pop_back();
  }

  void NamedSkip() {
    while (pos < len || NamedRefill()) {
      char* at = buf.data() + pos;
      char* nl = (char*)memchr(at, '\n', len - pos);
      if (nl) {
        pos = nl - buf.data() + 1;
        return;
      }
      pos = len;
    }
  }

  // kseq's name from the header past its '@' or '>': leading whitespace
  // skipped, cut at the next whitespace (Python's split()[0])
  static void AppendName(const char* b, const char* e, std::vector<char>& out) {
    while (b < e && IsSpace(*b)) ++b;
    const char* j = b;
    while (j < e && !IsSpace(*j)) ++j;
    out.insert(out.end(), b, j);
  }

  // one plain 4-line FASTQ record that lies whole in the buffer, parsed in
  // place: 1 appended, 0 skipped (empty sequence), or -1 where the line
  // parser must take it (a record across the buffer's end, a blank line,
  // FASTA, a malformed record)
  int FastRecord(std::vector<char>& seqs, std::vector<char>& names) {
    char* p = buf.data() + pos;
    char* end = buf.data() + len;
    if (p >= end || *p != '@') return -1;
    char* e1 = (char*)memchr(p, '\n', end - p);
    if (!e1) return -1;
    char* e2 = (char*)memchr(e1 + 1, '\n', end - e1 - 1);
    if (!e2 || e2 + 1 >= end || e2[1] != '+') return -1;
    char* e3 = (char*)memchr(e2 + 1, '\n', end - e2 - 1);
    if (!e3) return -1;
    char* e4 = (char*)memchr(e3 + 1, '\n', end - e3 - 1);
    if (!e4) return -1;
    pos = e4 + 1 - buf.data();
    char* se = e2;
    while (se > e1 + 1 && se[-1] == '\r') --se;
    if (se == e1 + 1) return 0;
    seqs.insert(seqs.end(), e1 + 1, se);
    AppendName(p + 1, e1, names);
    return 1;
  }

  // returns #records loaded (<= max_n; fewer only at the end of the file),
  // or error_kind with `error` set
  int64_t ReadBatchNamed(int64_t max_n) {
    cur ^= 1;
    std::vector<char>& seqs = seqs_bufs[cur];
    std::vector<int64_t>& offsets = offsets_bufs[cur];
    std::vector<char>& names = names_bufs[cur];
    std::vector<int64_t>& name_offsets = name_offsets_bufs[cur];
    seqs.clear();
    offsets.assign(1, 0);
    names.clear();
    name_offsets.assign(1, 0);
    std::string line, aux;
    int64_t n = 0;
    while (n < max_n && !error_kind) {
      if (!has_pending) {
        int got = FastRecord(seqs, names);
        if (got >= 0) {
          if (got) {
            offsets.push_back((int64_t)seqs.size());
            name_offsets.push_back((int64_t)names.size());
            ++n;
          }
          continue;
        }
      }
      if (has_pending) {
        line.swap(pending);
        has_pending = false;
      } else if (!NamedLine(line)) {
        break;
      }
      if (line.empty()) continue;
      size_t before = seqs.size();
      if (line[0] == '@') {
        NamedLineInto(seqs);
        if (!NamedLine(aux) || aux.empty() || aux[0] != '+') {
          if (!error_kind) {
            error = "Malformed FASTQ";
            error_kind = -1;
          }
          break;
        }
        NamedSkip();  // the quality line
      } else if (line[0] == '>') {
        // FASTA: sequence lines up to the next header, which is kept
        while (NamedLine(aux)) {
          if (!aux.empty() && (aux[0] == '>' || aux[0] == '@')) {
            pending.swap(aux);
            has_pending = true;
            break;
          }
          seqs.insert(seqs.end(), aux.begin(), aux.end());
        }
      } else {
        error = "Unrecognized record start";
        error_kind = -1;
        break;
      }
      if (seqs.size() == before) continue;  // kseq skips empty records
      AppendName(line.data() + 1, line.data() + line.size(), names);
      offsets.push_back((int64_t)seqs.size());
      name_offsets.push_back((int64_t)names.size());
      ++n;
    }
    return error_kind ? error_kind : n;
  }
};

// --------------------------- postprocess + write ---------------------------

struct PEOut {
  // parallel arrays of emitted records
  const int32_t* rid;
  const uint32_t* read_id;
  const uint32_t* start;
  const uint16_t* flen;
  const uint8_t* mapq;
  const uint8_t* dir;
  const uint8_t* uniq;
  const uint16_t* posalen;
  const uint16_t* negalen;
  int64_t n;
};

}  // namespace

extern "C" {

// ------------------------- index construction -------------------------
// Native equivalent of Index::Construct (index.cc:12-89): minimizer
// collection per reference sequence, a sort by (hash, hit) matching
// Minimizer::operator< (minimizer.h:34-44), and a unique/count pass that
// yields the same four arrays the Python index stores.

struct IndexBuilder {
  int k, w, num_threads = 1;
  std::vector<Minimizer> mzs;
  int64_t num_keys = 0;
};

IndexBuilder* cn_index_begin(int k, int w, int num_threads) {
  IndexBuilder* b = new IndexBuilder();
  b->k = k;
  b->w = w;
  b->num_threads = num_threads < 1 ? 1 : num_threads;
  return b;
}

void cn_index_add(IndexBuilder* b, const uint8_t* codes, int64_t n,
                  uint32_t seq_index) {
  // append straight into the builder: every page here is a page the final
  // index needs anyway (fresh-page faults dominate genome-scale builds on
  // ballooned kernels, so no scratch copies)
  size_t expect = b->mzs.size() + (size_t)(n / 4 + 64);
  if (b->mzs.capacity() < expect) b->mzs.reserve(expect);
  uint64_t hit_base = ((uint64_t)seq_index) << 33;
  const int T = b->num_threads;
  // the window state machine has bounded memory (one window plus the
  // unambiguous-run counter, both saturating within w+k), so chunks
  // re-derive the exact state from a warmup prefix and keep only the
  // emissions whose position falls inside the chunk; the full (hash, hit)
  // sort afterwards makes emission order irrelevant
  const int64_t kChunk = 16 << 20;
  if (T <= 1 || n <= kChunk + (int64_t)(4 * (b->k + b->w))) {
    GenerateMinimizers(codes, (int)n, b->k, b->w, b->mzs, hit_base,
                       /*append=*/true);
    return;
  }
  const int64_t warmup = 4 * (b->k + b->w);
  int64_t num_chunks = (n + kChunk - 1) / kChunk;
  std::vector<std::vector<Minimizer>> parts(num_chunks);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t c = next.fetch_add(1);
      if (c >= num_chunks) return;
      int64_t lo = c * kChunk;
      int64_t hi = std::min(n, lo + kChunk);
      int64_t scan_lo = std::max<int64_t>(0, lo - warmup);
      int64_t scan_hi = std::min(n, hi + (int64_t)(b->k + b->w));
      std::vector<Minimizer>& out = parts[c];
      out.reserve((size_t)((hi - lo) / 3 + 64));
      GenerateMinimizers(codes + scan_lo, (int)(scan_hi - scan_lo), b->k,
                         b->w, out, 0, false,
                         /*final_flush=*/scan_hi == n);
      size_t kept = 0;
      for (const Minimizer& m : out) {
        int64_t pos = (int64_t)(m.hit >> 1) + scan_lo;
        if (pos >= lo && pos < hi)
          out[kept++] = {m.hash,
                         hit_base | (((uint64_t)pos) << 1) | (m.hit & 1)};
      }
      out.resize(kept);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < T; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  for (const auto& part : parts)
    b->mzs.insert(b->mzs.end(), part.begin(), part.end());
}

// sorts and counts unique keys; returns total minimizers, sets *num_keys
int64_t cn_index_finalize(IndexBuilder* b, int64_t* num_keys) {
  auto less = [](const Minimizer& a, const Minimizer& c) {
    if (a.hash != c.hash) return a.hash < c.hash;
    return a.hit < c.hit;
  };
  const int T = b->num_threads;
  if (T > 1 && b->mzs.size() > (1u << 20)) {
    // chunk sorts + merge tree
    int64_t n = (int64_t)b->mzs.size();
    std::vector<int64_t> bounds;
    for (int t = 0; t <= T; ++t) bounds.push_back(n * t / T);
    std::vector<std::thread> threads;
    for (int t = 1; t < T; ++t)
      threads.emplace_back([&, t]() {
        std::sort(b->mzs.begin() + bounds[t], b->mzs.begin() + bounds[t + 1],
                  less);
      });
    std::sort(b->mzs.begin() + bounds[0], b->mzs.begin() + bounds[1], less);
    for (auto& th : threads) th.join();
    for (int64_t step = 1; step < T; step *= 2)
      for (int64_t t = 0; t + step < T; t += 2 * step) {
        int64_t end = std::min<int64_t>(T, t + 2 * step);
        std::inplace_merge(b->mzs.begin() + bounds[t],
                           b->mzs.begin() + bounds[t + step],
                           b->mzs.begin() + bounds[end], less);
      }
  } else {
    std::sort(b->mzs.begin(), b->mzs.end(), less);
  }
  int64_t keys = 0;
  uint64_t prev = 0;
  bool first = true;
  for (const auto& m : b->mzs) {
    if (first || m.hash != prev) ++keys;
    prev = m.hash;
    first = false;
  }
  b->num_keys = keys;
  *num_keys = keys;
  return (int64_t)b->mzs.size();
}

void cn_index_export(IndexBuilder* b, uint64_t* hash_keys, uint64_t* offsets,
                     uint32_t* counts, uint64_t* occurrences) {
  int64_t ki = -1;
  uint64_t prev = 0;
  bool first = true;
  for (int64_t i = 0; i < (int64_t)b->mzs.size(); ++i) {
    const Minimizer& m = b->mzs[i];
    occurrences[i] = m.hit;
    if (first || m.hash != prev) {
      ++ki;
      hash_keys[ki] = m.hash;
      offsets[ki] = (uint64_t)i;
      counts[ki] = 0;
    }
    ++counts[ki];
    prev = m.hash;
    first = false;
  }
}

void cn_index_destroy(IndexBuilder* b) { delete b; }

FastxReader* cn_fastx_open(const char* path) {
  FastxReader* r = new FastxReader(path);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

void cn_fastx_close(FastxReader* r) { delete r; }

int64_t cn_fastx_read_batch(FastxReader* r, int64_t max_n,
                            const char** seq_bytes,
                            const int64_t** offsets) {
  int64_t n = r->ReadBatch(max_n);
  *seq_bytes = r->seqs_bufs[r->cur].data();
  *offsets = r->offsets_bufs[r->cur].data();
  return n;
}

// cn_fastx_read_batch with the reads' names: n, or -1 (a malformed record)
// or -2 (the input ended badly) with *error set. The batch stays valid
// until the second call after this one.
int64_t cn_fastx_read_batch_named(FastxReader* r, int64_t max_n,
                                  const char** seq_bytes,
                                  const int64_t** offsets,
                                  const char** names,
                                  const int64_t** name_offsets,
                                  const char** error) {
  int64_t n = r->ReadBatchNamed(max_n);
  *seq_bytes = r->seqs_bufs[r->cur].data();
  *offsets = r->offsets_bufs[r->cur].data();
  *names = r->names_bufs[r->cur].data();
  *name_offsets = r->name_offsets_bufs[r->cur].data();
  *error = r->error.c_str();
  return n;
}

// Packs interleaved paired reads (r1 of pair 0, r2 of pair 0, ...) from
// raw ASCII buffers into the device seeding upload format: per read one
// row of W 2-bit-code words followed by WN N-bitmap words, W = (L+15)/16,
// WN = (L+31)/32. out must hold 2*n*(W+WN) uint32 (caller-owned and
// reusable, so the hot loop allocates nothing). Returns 0, or -1 when a
// read length differs from L.
int64_t cn_pack_reads(const char* r1, const int64_t* o1, const char* r2,
                      const int64_t* o2, int64_t n, int32_t L,
                      uint32_t* out) {
  const int W = (L + 15) / 16, WN = (L + 31) / 32;
  const int stride = W + WN;
  for (int64_t p = 0; p < n; ++p) {
    for (int end = 0; end < 2; ++end) {
      const char* s = end ? r2 + o2[p] : r1 + o1[p];
      int64_t len = end ? o2[p + 1] - o2[p] : o1[p + 1] - o1[p];
      if (len != L) return -1;
      uint32_t* row = out + (2 * p + end) * stride;
      memset(row, 0, (size_t)stride * 4);
      for (int i = 0; i < L; ++i) {
        uint8_t c = kCharToCode[(uint8_t)s[i]];
        if (c < 4)
          row[i >> 4] |= (uint32_t)c << (2 * (i & 15));
        else
          row[W + (i >> 5)] |= 1u << (i & 31);
      }
    }
  }
  return 0;
}

// Single-stream variant (single-end runs): one row per read in order.
int64_t cn_pack_reads_se(const char* r, const int64_t* o, int64_t n,
                         int32_t L, uint32_t* out) {
  const int W = (L + 15) / 16, WN = (L + 31) / 32;
  const int stride = W + WN;
  for (int64_t p = 0; p < n; ++p) {
    const char* s = r + o[p];
    if (o[p + 1] - o[p] != L) return -1;
    uint32_t* row = out + p * stride;
    memset(row, 0, (size_t)stride * 4);
    for (int i = 0; i < L; ++i) {
      uint8_t c = kCharToCode[(uint8_t)s[i]];
      if (c < 4)
        row[i >> 4] |= (uint32_t)c << (2 * (i & 15));
      else
        row[W + (i >> 5)] |= 1u << (i & 31);
    }
  }
  return 0;
}

static int64_t steady_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Sort + Tn5 + dedup + mapq-filter + write PE BED/TagAlign records.
// format: 0 = BED, 1 = TagAlign(BEDPE). Returns #records written
// (post-filter). dedup_mode: 0 none, 1 in-memory semantics.
// out_stats[3..5] are steady_clock stamps (ns; CLOCK_MONOTONIC, the clock
// of Python's perf_counter_ns) at the start, after the Tn5 shift and the
// sort, and after the dedup, filter, format and write.
int64_t cn_postprocess_write(
    const char* out_path, int format, int mapq_threshold, int tn5_shift,
    int dedup_mode, int se_mode, const char* ref_names_bytes,
    const int64_t* ref_name_offsets, int32_t num_refs, int32_t* rid,
    uint32_t* read_id, uint32_t* start, uint16_t* flen, uint8_t* mapq,
    uint8_t* dir, uint8_t* uniq, uint16_t* posalen, uint16_t* negalen,
    int64_t n, int64_t* out_stats /*[6]: written, uni, multi, 3 stamps*/) {
  out_stats[3] = steady_ns();
  // Tn5 shift first (in-memory order: Tn5 then dedup, chromap.h:1322-1334)
  if (tn5_shift) {
    for (int64_t i = 0; i < n; ++i) {
      if (se_mode) {  // mapping.h:73-83 (SE: strand-dependent shift)
        if (dir[i]) start[i] += 4;
        else flen[i] = (uint16_t)(flen[i] - 5);
      } else {
        start[i] += 4;
        posalen[i] = (uint16_t)(posalen[i] - 4);
        flen[i] = (uint16_t)(flen[i] - 9);
        negalen[i] = (uint16_t)(negalen[i] - 5);
      }
    }
  }
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (rid[a] != rid[b]) return rid[a] < rid[b];
    if (start[a] != start[b]) return start[a] < start[b];
    if (flen[a] != flen[b]) return flen[a] < flen[b];
    if (mapq[a] != mapq[b]) return mapq[a] < mapq[b];
    if (dir[a] != dir[b]) return dir[a] < dir[b];
    if (uniq[a] != uniq[b]) return uniq[a] < uniq[b];
    if (read_id[a] != read_id[b]) return read_id[a] < read_id[b];
    if (posalen[a] != posalen[b]) return posalen[a] < posalen[b];
    return negalen[a] < negalen[b];
  });
  out_stats[4] = steady_ns();

  FILE* out = fopen(out_path, "w");
  if (!out) return -1;
  std::vector<char> iobuf(1 << 20);
  setvbuf(out, iobuf.data(), _IOFBF, iobuf.size());

  int64_t written = 0, uni = 0, multi = 0;
  auto emit = [&](int64_t idx, uint32_t dups) {
    if (mapq[idx] < mapq_threshold) return;
    uint32_t nd = dups > 255 ? 255 : dups;
    const char* name = ref_names_bytes + ref_name_offsets[rid[idx]];
    int name_len =
        (int)(ref_name_offsets[rid[idx] + 1] - ref_name_offsets[rid[idx]]);
    uint32_t s = start[idx];
    uint32_t e2 = s + flen[idx];
    if (format == 0 || se_mode) {
      fprintf(out, "%.*s\t%u\t%u\tN\t%u\t%c\t%u\n", name_len, name, s, e2,
              (unsigned)mapq[idx], dir[idx] ? '+' : '-', nd);
    } else {
      uint32_t pos_end = s + posalen[idx];
      uint32_t neg_end = s + flen[idx];
      uint32_t neg_start = neg_end - negalen[idx];
      if (dir[idx]) {
        fprintf(out, "%.*s\t%u\t%u\tN\t%u\t+\n%.*s\t%u\t%u\tN\t%u\t-\t%u\n",
                name_len, name, s, pos_end, (unsigned)mapq[idx], name_len,
                name, neg_start, neg_end, (unsigned)mapq[idx], nd);
      } else {
        fprintf(out, "%.*s\t%u\t%u\tN\t%u\t-\n%.*s\t%u\t%u\tN\t%u\t+\t%u\n",
                name_len, name, neg_start, neg_end, (unsigned)mapq[idx],
                name_len, name, s, pos_end, (unsigned)mapq[idx], nd);
      }
    }
    ++written;
    if (uniq[idx])
      ++uni;
    else
      ++multi;
  };

  if (dedup_mode == 0) {
    for (int64_t oi = 0; oi < n; ++oi) emit(order[oi], 1);
  } else {
    // adjacent-equal collapse keeping the last (mapping_processor.h:161-202)
    int64_t group_count = 0;
    for (int64_t oi = 0; oi < n; ++oi) {
      int64_t idx = order[oi];
      ++group_count;
      bool last_of_group =
          oi + 1 >= n ||
          rid[order[oi + 1]] != rid[idx] ||
          start[order[oi + 1]] != start[idx] ||
          (!se_mode && flen[order[oi + 1]] != flen[idx]);
      if (last_of_group) {
        emit(idx, (uint32_t)group_count);
        group_count = 0;
      }
    }
  }
  fclose(out);
  out_stats[5] = steady_ns();
  out_stats[0] = written;
  out_stats[1] = uni;
  out_stats[2] = multi;
  return written;
}


// ---------------------- native low-memory merge (BED) ----------------------
// K-way merge of sorted temp shards (io/lowmem.py CTSH1 format, record tags
// 1 = SE BED, 2 = PE BED) with streaming dedup, Tn5 and BED/TagAlign output
// -- the exact semantics of merge_and_output_low_memory (which ports
// mapping_writer.h:166-376). Cell-level dedup collapses equal dup_key runs
// keeping the max-mapq representative; bulk-level dedup additionally picks
// the best barcode by (num_dups, whitelist abundance)
// (mapping_writer.h:128-165). Per-barcode MAPPED/DUP/LOWMAPQ aggregates are
// stored on the context for the Python summary.

namespace {

struct LmRec {
  uint64_t barcode;
  uint32_t read_id, start;
  uint16_t length, posalen, negalen;
  uint8_t mapq, dir, uniq, dups, hasbc;
};

struct LmShard {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  size_t pos = 0, lim = 0;
  uint64_t rids_left = 0;     // rid groups not yet started
  uint64_t recs_left = 0;     // records left in the current rid group
  int64_t rid = -1;
  int rec_size = 0;
  bool se = false;

  bool Refill(size_t need) {
    if (lim - pos >= need) return true;
    memmove(buf.data(), buf.data() + pos, lim - pos);
    lim -= pos;
    pos = 0;
    lim += fread(buf.data() + lim, 1, buf.size() - lim, f);
    return lim - pos >= need;
  }

  // advance to the next nonempty rid group; false at end of shard
  bool NextGroup() {
    while (rids_left > 0) {
      if (!Refill(8)) return false;
      uint64_t cnt;
      memcpy(&cnt, buf.data() + pos, 8);
      pos += 8;
      --rids_left;
      ++rid;
      if (cnt > 0) {
        recs_left = cnt;
        return true;
      }
    }
    return false;
  }

  bool Next(LmRec& r) {
    if (recs_left == 0 && !NextGroup()) return false;
    if (!Refill((size_t)rec_size)) return false;
    const uint8_t* p = buf.data() + pos;
    memcpy(&r.read_id, p, 4);
    memcpy(&r.barcode, p + 4, 8);
    memcpy(&r.start, p + 12, 4);
    memcpy(&r.length, p + 16, 2);
    r.mapq = p[18];
    r.dir = p[19];
    r.uniq = p[20];
    r.dups = p[21];
    if (se) {
      r.posalen = r.negalen = 0;
      r.hasbc = p[22];
    } else {
      memcpy(&r.posalen, p + 22, 2);
      memcpy(&r.negalen, p + 24, 2);
      r.hasbc = p[26];
    }
    pos += rec_size;
    --recs_left;
    return true;
  }
};

// sort_key comparison (records.py SEBedRecord/PEBedRecord.sort_key)
inline int LmCmp(const LmRec& a, const LmRec& b, bool se) {
#define CN_CMP(f) \
  if (a.f != b.f) return a.f < b.f ? -1 : 1;
  CN_CMP(start)
  CN_CMP(length)
  if (a.hasbc) CN_CMP(barcode)
  CN_CMP(mapq)
  CN_CMP(dir)
  CN_CMP(uniq)
  CN_CMP(read_id)
  if (!se) {
    CN_CMP(posalen)
    CN_CMP(negalen)
  }
#undef CN_CMP
  return 0;
}

}  // namespace

int64_t cn_lowmem_merge_bed(
    CnContext* ctx, const char* out_path, int32_t format /*0 bed, 1 tag*/,
    const char* paths_bytes, const int64_t* path_offsets, int32_t n_shards,
    int32_t mapq_threshold, int32_t tn5, int32_t remove_dups,
    int32_t dedup_bulk, const char* ref_names_bytes,
    const int64_t* ref_name_offsets, int32_t num_refs,
    int32_t cell_barcode_length, const uint64_t* wl_keys,
    const int64_t* wl_counts, int64_t wl_n, int32_t want_summary,
    int64_t* out_stats /*[3]: uni, multi, passing*/) {
  (void)num_refs;
  std::vector<LmShard> shards((size_t)n_shards);
  const size_t kBlock = 1 << 20;
  bool se_mode = false;
  int live = 0;
  auto fail = [&](int64_t code) {  // close everything on early error
    for (auto& sh : shards)
      if (sh.f) {
        fclose(sh.f);
        sh.f = nullptr;
      }
    return code;
  };
  for (int i = 0; i < n_shards; ++i) {
    LmShard& s = shards[i];
    std::string path(paths_bytes + path_offsets[i],
                     paths_bytes + path_offsets[i + 1]);
    s.f = fopen(path.c_str(), "rb");
    if (!s.f) return fail(-1);
    s.buf.resize(kBlock);
    if (!s.Refill(6 + 1 + 8)) {
      fclose(s.f);
      s.f = nullptr;
      continue;
    }
    if (memcmp(s.buf.data() + s.pos, "CTSH1\0", 6) != 0) return fail(-2);
    uint8_t tag = s.buf[s.pos + 6];
    uint64_t num_rids;
    memcpy(&num_rids, s.buf.data() + s.pos + 7, 8);
    s.pos += 15;
    if (tag == 0) {  // empty shard
      fclose(s.f);
      s.f = nullptr;
      continue;
    }
    if (tag != 1 && tag != 2) return fail(-3);
    s.se = tag == 1;
    se_mode = s.se;
    s.rec_size = s.se ? 23 : 27;
    s.rids_left = num_rids;
    s.rid = -1;
    ++live;
  }

  FILE* out = fopen(out_path, "w");
  if (!out) return fail(-1);
  std::vector<char> iobuf(1 << 20);
  setvbuf(out, iobuf.data(), _IOFBF, iobuf.size());

  // heap of shard heads ordered by (rid, sort_key, shard index)
  struct Head {
    LmRec r;
    int64_t rid;
    int si;
  };
  std::vector<Head> heap;
  heap.reserve((size_t)live);
  auto hgt = [&](const Head& a, const Head& b) {  // a after b
    if (a.rid != b.rid) return a.rid > b.rid;
    int c = LmCmp(a.r, b.r, se_mode);
    if (c != 0) return c > 0;
    return a.si > b.si;
  };
  for (int i = 0; i < n_shards; ++i) {
    if (!shards[i].f) continue;
    Head h;
    h.si = i;
    if (shards[i].Next(h.r)) {
      h.rid = shards[i].rid;
      heap.push_back(h);
    }
  }
  std::make_heap(heap.begin(), heap.end(), hgt);

  char bc_str[40];
  auto barcode_str = [&](uint64_t key) -> int {
    if (cell_barcode_length == 0) {
      bc_str[0] = 'N';
      return 1;
    }
    static const char kB[4] = {'A', 'C', 'G', 'T'};
    for (int i = 0; i < cell_barcode_length; ++i)
      bc_str[i] = kB[(key >> (2 * (cell_barcode_length - 1 - i))) & 3];
    return cell_barcode_length;
  };

  auto abundance = [&](uint64_t key) -> int64_t {
    if (!wl_keys || wl_n == 0) return 0;
    int64_t lo = 0, hi = wl_n;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (wl_keys[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    return (lo < wl_n && wl_keys[lo] == key) ? wl_counts[lo] : 0;
  };

  std::unordered_map<uint64_t, std::array<int64_t, 3>> sum;  // M, D, L

  int64_t uni = 0, multi = 0, passing = 0;
  bool have_last = false;
  int64_t last_rid = -1;
  LmRec last;
  uint64_t run = 0;
  struct BulkDup {
    LmRec r;
    uint32_t sel_dups;
  };
  std::vector<BulkDup> bulk_dups;

  auto emit = [&](const LmRec& mr, int64_t rid) {
    LmRec m = mr;  // Tn5 mutates
    const char* name = ref_names_bytes + ref_name_offsets[rid];
    int nl = (int)(ref_name_offsets[rid + 1] - ref_name_offsets[rid]);
    if (tn5) {
      if (se_mode) {
        if (m.dir)
          m.start += 4;
        else
          m.length = (uint16_t)(m.length - 5);
      } else {
        m.start += 4;
        m.posalen = (uint16_t)(m.posalen - 4);
        m.length = (uint16_t)(m.length - 9);
        m.negalen = (uint16_t)(m.negalen - 5);
      }
    }
    uint32_t s = m.start, e2 = m.start + m.length;
    if (se_mode || format == 0) {
      if (m.hasbc) {
        int n2 = barcode_str(m.barcode);
        fprintf(out, "%.*s\t%u\t%u\t%.*s\t%u\n", nl, name, s, e2, n2,
                bc_str, (unsigned)m.dups);
      } else {
        fprintf(out, "%.*s\t%u\t%u\tN\t%u\t%c\t%u\n", nl, name, s, e2,
                (unsigned)m.mapq, m.dir ? '+' : '-', (unsigned)m.dups);
      }
    } else {  // PE TagAlign two-line output (writers.py _append_pe_bed)
      uint32_t pe = m.start + m.posalen;
      uint32_t ne = m.start + m.length;
      uint32_t ns = ne - m.negalen;
      if (m.hasbc) {
        if (m.dir)
          fprintf(out, "%.*s\t%u\t%u\tN\t%u\t+\n%.*s\t%u\t%u\tN\t%u\t-\n",
                  nl, name, s, pe, (unsigned)m.mapq, nl, name, ns, ne,
                  (unsigned)m.mapq);
        else
          fprintf(out, "%.*s\t%u\t%u\tN\t%u\t-\n%.*s\t%u\t%u\tN\t%u\t+\n",
                  nl, name, ns, ne, (unsigned)m.mapq, nl, name, s, pe,
                  (unsigned)m.mapq);
      } else {
        if (m.dir)
          fprintf(out,
                  "%.*s\t%u\t%u\tN\t%u\t+\n%.*s\t%u\t%u\tN\t%u\t-\t%u\n",
                  nl, name, s, pe, (unsigned)m.mapq, nl, name, ns, ne,
                  (unsigned)m.mapq, (unsigned)m.dups);
        else
          fprintf(out,
                  "%.*s\t%u\t%u\tN\t%u\t-\n%.*s\t%u\t%u\tN\t%u\t+\t%u\n",
                  nl, name, ns, ne, (unsigned)m.mapq, nl, name, s, pe,
                  (unsigned)m.mapq, (unsigned)m.dups);
      }
    }
  };

  auto flush_last = [&]() {
    if (!have_last) return;
    LmRec m = last;
    if (dedup_bulk && !bulk_dups.empty()) {
      // FindBestMappingIndexFromDuplicates (mapping_writer.h:128-165):
      // best_abundance tracks the CURRENT best only (reference-faithful)
      size_t best = 0;
      int64_t best_ab = abundance(bulk_dups[0].r.barcode);
      for (size_t i = 1; i < bulk_dups.size(); ++i) {
        int64_t ab = abundance(bulk_dups[i].r.barcode);
        if (bulk_dups[i].sel_dups > bulk_dups[best].sel_dups ||
            (bulk_dups[i].sel_dups == bulk_dups[best].sel_dups &&
             ab > best_ab)) {
          best = i;
          best_ab = ab;
        }
      }
      m = bulk_dups[best].r;
      bulk_dups.clear();
    }
    if (m.mapq >= mapq_threshold) {
      m.dups = (uint8_t)(run > 255 ? 255 : run);
      emit(m, last_rid);
      ++passing;
      if (want_summary) sum[m.barcode][1] += (int64_t)run - 1;  // DUP
    } else if (want_summary) {
      sum[m.barcode][2] += (int64_t)run;  // LOWMAPQ
    }
    if (want_summary) sum[m.barcode][0] += (int64_t)run;  // MAPPED
    if (m.uniq)
      ++uni;
    else
      ++multi;
  };

  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), hgt);
    Head h = heap.back();
    heap.pop_back();
    const LmRec& m = h.r;
    bool dup_cell =
        have_last && m.start == last.start &&
        (se_mode || m.length == last.length) &&
        (!m.hasbc || m.barcode == last.barcode);
    bool dup_pos = have_last && dedup_bulk && m.start == last.start &&
                   (se_mode || m.length == last.length);
    bool is_dup = have_last && last_rid == h.rid && (dup_cell || dup_pos);
    if (remove_dups && is_dup) {
      ++run;
      if (dedup_bulk) {
        // the reference assigns the incoming record then num_dups_ += 1,
        // so the selection count is incoming+1, not accumulated
        if (!bulk_dups.empty() &&
            (!m.hasbc || m.barcode == bulk_dups.back().r.barcode) &&
            m.start == bulk_dups.back().r.start &&
            (se_mode || m.length == bulk_dups.back().r.length)) {
          bulk_dups.back().r = m;
          bulk_dups.back().sel_dups = (uint32_t)m.dups + 1;
        } else {
          bulk_dups.push_back({m, 1});
        }
      }
      if (m.mapq > last.mapq) last = m;
    } else {
      flush_last();
      last = m;
      last_rid = h.rid;
      have_last = true;
      run = 1;
      if (dedup_bulk) {
        bulk_dups.clear();
        bulk_dups.push_back({m, 1});
      }
    }
    // refill this shard's head
    LmShard& s = shards[h.si];
    Head nh;
    nh.si = h.si;
    if (s.Next(nh.r)) {
      nh.rid = s.rid;
      heap.push_back(nh);
      std::push_heap(heap.begin(), heap.end(), hgt);
    }
  }
  flush_last();
  fclose(out);
  for (auto& s : shards)
    if (s.f) fclose(s.f);

  ctx->lowmem_sum_keys.clear();
  ctx->lowmem_sum_counts.clear();
  if (want_summary) {
    ctx->lowmem_sum_keys.reserve(sum.size());
    ctx->lowmem_sum_counts.reserve(sum.size() * 3);
    for (auto& kv : sum) {
      ctx->lowmem_sum_keys.push_back(kv.first);
      ctx->lowmem_sum_counts.push_back(kv.second[0]);
      ctx->lowmem_sum_counts.push_back(kv.second[1]);
      ctx->lowmem_sum_counts.push_back(kv.second[2]);
    }
  }
  out_stats[0] = uni;
  out_stats[1] = multi;
  out_stats[2] = passing;
  return passing;
}


// K-way merge of tag-6 (4DN pairs) shards: fixed 33-byte struct + u16-len
// read name per record (records.py _PAIRS_S). Streaming dedup on
// (rid1, pos1, rid2, pos2) (pairs_mapping.h:44-49), optional bulk-level
// best-barcode selection, mapq filter, and the pairs text rows appended
// after the Python-written header. Summary aggregates land on the
// context like the BED merge's.

namespace {

struct LmPairsRec {
  uint64_t barcode;
  uint32_t read_id, pos1, pos2;
  int32_t rid1, rid2;
  uint8_t strand1, strand2, mapq, uniq, dups;
  std::string name;
};

inline int LmPairsCmp(const LmPairsRec& a, const LmPairsRec& b) {
#define CN_CMP(f) \
  if (a.f != b.f) return a.f < b.f ? -1 : 1;
  CN_CMP(rid1)
  CN_CMP(rid2)
  CN_CMP(pos1)
  CN_CMP(pos2)
  CN_CMP(mapq)
  CN_CMP(read_id)
#undef CN_CMP
  return 0;
}

inline bool LmPairsNext(LmShard& s, LmPairsRec& r) {
  if (s.recs_left == 0 && !s.NextGroup()) return false;
  if (!s.Refill(33 + 2)) return false;
  const uint8_t* p = s.buf.data() + s.pos;
  memcpy(&r.read_id, p, 4);
  memcpy(&r.barcode, p + 4, 8);
  memcpy(&r.rid1, p + 12, 4);
  memcpy(&r.rid2, p + 16, 4);
  memcpy(&r.pos1, p + 20, 4);
  memcpy(&r.pos2, p + 24, 4);
  r.strand1 = p[28];
  r.strand2 = p[29];
  r.mapq = p[30];
  r.uniq = p[31];
  r.dups = p[32];
  uint16_t nlen;
  memcpy(&nlen, p + 33, 2);
  s.pos += 35;
  s.recs_left -= 1;
  if (!s.Refill(nlen)) return false;
  r.name.assign((const char*)s.buf.data() + s.pos, nlen);
  s.pos += nlen;
  return true;
}

}  // namespace

int64_t cn_lowmem_merge_pairs(
    CnContext* ctx, const char* out_path, const char* paths_bytes,
    const int64_t* path_offsets, int32_t n_shards, int32_t mapq_threshold,
    int32_t remove_dups, int32_t dedup_bulk, const char* ref_names_bytes,
    const int64_t* ref_name_offsets, int32_t num_refs,
    const uint64_t* wl_keys, const int64_t* wl_counts, int64_t wl_n,
    int32_t want_summary, int64_t* out_stats /*[3]: uni, multi, passing*/) {
  (void)num_refs;
  std::vector<LmShard> shards((size_t)n_shards);
  const size_t kBlock = 1 << 20;
  auto fail = [&](int64_t code) {
    for (auto& sh : shards)
      if (sh.f) {
        fclose(sh.f);
        sh.f = nullptr;
      }
    return code;
  };
  for (int i = 0; i < n_shards; ++i) {
    LmShard& s = shards[i];
    std::string path(paths_bytes + path_offsets[i],
                     paths_bytes + path_offsets[i + 1]);
    s.f = fopen(path.c_str(), "rb");
    if (!s.f) return fail(-1);
    s.buf.resize(kBlock);
    if (!s.Refill(6 + 1 + 8)) {
      fclose(s.f);
      s.f = nullptr;
      continue;
    }
    if (memcmp(s.buf.data() + s.pos, "CTSH1\0", 6) != 0) return fail(-2);
    uint8_t tag = s.buf[s.pos + 6];
    uint64_t num_rids;
    memcpy(&num_rids, s.buf.data() + s.pos + 7, 8);
    s.pos += 15;
    if (tag == 0) {
      fclose(s.f);
      s.f = nullptr;
      continue;
    }
    if (tag != 6) return fail(-3);
    s.rids_left = num_rids;
    s.rid = -1;
  }

  FILE* out = fopen(out_path, "a");  // the header is already written
  if (!out) return fail(-1);
  std::vector<char> iobuf(1 << 20);
  setvbuf(out, iobuf.data(), _IOFBF, iobuf.size());

  struct Head {
    LmPairsRec r;
    int64_t rid;
    int si;
  };
  std::vector<Head> heap;
  auto hgt = [&](const Head& a, const Head& b) {
    if (a.rid != b.rid) return a.rid > b.rid;
    int c = LmPairsCmp(a.r, b.r);
    if (c != 0) return c > 0;
    return a.si > b.si;
  };
  for (int i = 0; i < n_shards; ++i) {
    if (!shards[i].f) continue;
    Head h;
    h.si = i;
    if (LmPairsNext(shards[i], h.r)) {
      h.rid = shards[i].rid;
      heap.push_back(std::move(h));
    }
  }
  std::make_heap(heap.begin(), heap.end(), hgt);

  auto abundance = [&](uint64_t key) -> int64_t {
    if (!wl_keys || wl_n == 0) return 0;
    int64_t lo = 0, hi = wl_n;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (wl_keys[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    return (lo < wl_n && wl_keys[lo] == key) ? wl_counts[lo] : 0;
  };

  std::unordered_map<uint64_t, std::array<int64_t, 3>> sum;
  int64_t uni = 0, multi = 0, passing = 0;
  bool have_last = false;
  int64_t last_rid = -1;
  LmPairsRec last;
  uint64_t run = 0;
  struct BulkDup {
    LmPairsRec r;
    uint32_t sel_dups;
  };
  std::vector<BulkDup> bulk_dups;

  auto emit = [&](const LmPairsRec& m) {
    const char* n1 = ref_names_bytes + ref_name_offsets[m.rid1];
    int l1 = (int)(ref_name_offsets[m.rid1 + 1] - ref_name_offsets[m.rid1]);
    const char* n2 = ref_names_bytes + ref_name_offsets[m.rid2];
    int l2 = (int)(ref_name_offsets[m.rid2 + 1] - ref_name_offsets[m.rid2]);
    fprintf(out, "%.*s\t%.*s\t%u\t%.*s\t%u\t%c\t%c\tUU\t%u\t%u\n",
            (int)m.name.size(), m.name.data(), l1, n1, m.pos1 + 1, l2, n2,
            m.pos2 + 1, m.strand1 > 0 ? '+' : '-',
            m.strand2 > 0 ? '+' : '-', (unsigned)m.mapq, (unsigned)m.mapq);
  };

  auto same_pos = [](const LmPairsRec& a, const LmPairsRec& b) {
    return a.rid1 == b.rid1 && a.pos1 == b.pos1 && a.rid2 == b.rid2 &&
           a.pos2 == b.pos2;
  };

  auto flush_last = [&]() {
    if (!have_last) return;
    LmPairsRec m = last;
    if (dedup_bulk && !bulk_dups.empty()) {
      size_t best = 0;
      int64_t best_ab = abundance(bulk_dups[0].r.barcode);
      for (size_t i = 1; i < bulk_dups.size(); ++i) {
        int64_t ab = abundance(bulk_dups[i].r.barcode);
        if (bulk_dups[i].sel_dups > bulk_dups[best].sel_dups ||
            (bulk_dups[i].sel_dups == bulk_dups[best].sel_dups &&
             ab > best_ab)) {
          best = i;
          best_ab = ab;
        }
      }
      m = bulk_dups[best].r;
      bulk_dups.clear();
    }
    if (m.mapq >= mapq_threshold) {
      emit(m);
      ++passing;
      if (want_summary) sum[m.barcode][1] += (int64_t)run - 1;
    } else if (want_summary) {
      sum[m.barcode][2] += (int64_t)run;
    }
    if (want_summary) sum[m.barcode][0] += (int64_t)run;
    if (m.uniq)
      ++uni;
    else
      ++multi;
  };

  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), hgt);
    Head h = std::move(heap.back());
    heap.pop_back();
    const LmPairsRec& m = h.r;
    // pairs dup_key == same_position_key (pairs_mapping.h:44-49)
    bool dup = have_last && last_rid == h.rid && same_pos(m, last);
    if (remove_dups && dup) {
      ++run;
      if (dedup_bulk) {
        if (!bulk_dups.empty() && same_pos(m, bulk_dups.back().r)) {
          bulk_dups.back().r = m;
          bulk_dups.back().sel_dups = (uint32_t)m.dups + 1;
        } else {
          bulk_dups.push_back({m, 1});
        }
      }
      if (m.mapq > last.mapq) last = m;
    } else {
      flush_last();
      last = m;
      last_rid = h.rid;
      have_last = true;
      run = 1;
      if (dedup_bulk) {
        bulk_dups.clear();
        bulk_dups.push_back({m, 1});
      }
    }
    LmShard& s = shards[h.si];
    Head nh;
    nh.si = h.si;
    if (LmPairsNext(s, nh.r)) {
      nh.rid = s.rid;
      heap.push_back(std::move(nh));
      std::push_heap(heap.begin(), heap.end(), hgt);
    }
  }
  flush_last();
  fclose(out);
  for (auto& s : shards)
    if (s.f) fclose(s.f);

  ctx->lowmem_sum_keys.clear();
  ctx->lowmem_sum_counts.clear();
  if (want_summary) {
    for (auto& kv : sum) {
      ctx->lowmem_sum_keys.push_back(kv.first);
      ctx->lowmem_sum_counts.push_back(kv.second[0]);
      ctx->lowmem_sum_counts.push_back(kv.second[1]);
      ctx->lowmem_sum_counts.push_back(kv.second[2]);
    }
  }
  out_stats[0] = uni;
  out_stats[1] = multi;
  out_stats[2] = passing;
  return passing;
}

int64_t cn_get_lowmem_summary(CnContext* ctx, const uint64_t** keys,
                              const int64_t** counts) {
  *keys = ctx->lowmem_sum_keys.data();
  *counts = ctx->lowmem_sum_counts.data();
  return (int64_t)ctx->lowmem_sum_keys.size();
}

// One .pairs spill shard from arrays (io/lowmem.py spill_pairs_arrays),
// the same bytes TempMappingShard.write gives for the PairsRecords: rows
// sorted stably by (rid1, PairsRecord.sort_key) = (rid1, rid2, pos1, pos2,
// mapq, read_id); "CTSH1\0", tag 6 (0 for no rows), u64 rid count; per rid
// a u64 row count, then each row's 33 fixed bytes (records.py _PAIRS_S),
// u16 name length and name. `rows` holds the n rows' fixed bytes, row i's
// name is names[name_start[i], + name_len[i]). Returns n, -1 for a rid
// out of [0, num_refs) or a name over 65535 bytes, -2 when the file cannot
// be written.
int64_t cn_spill_pairs(const char* path, int32_t num_refs, int64_t n,
                       const int64_t* rid, const uint8_t* rows,
                       const uint8_t* names, const int64_t* name_start,
                       const int64_t* name_len) {
  struct Key {
    int64_t rid1;
    int32_t rid2;
    uint32_t pos1, pos2;
    uint8_t mapq;
    uint32_t read_id;
    int64_t row;  // emit order: full ties keep it
  };
  std::vector<Key> keys((size_t)n);
  std::vector<uint64_t> counts((size_t)std::max(num_refs, 0), 0);
  for (int64_t i = 0; i < n; ++i) {
    if (rid[i] < 0 || rid[i] >= num_refs || name_len[i] < 0 ||
        name_len[i] > 0xFFFF)
      return -1;
    const uint8_t* p = rows + 33 * i;
    Key& k = keys[(size_t)i];
    k.rid1 = rid[i];
    memcpy(&k.read_id, p, 4);
    memcpy(&k.rid2, p + 16, 4);
    memcpy(&k.pos1, p + 20, 4);
    memcpy(&k.pos2, p + 24, 4);
    k.mapq = p[30];
    k.row = i;
    counts[(size_t)rid[i]] += 1;
  }
  std::sort(keys.begin(), keys.end(), [](const Key& a, const Key& b) {
    if (a.rid1 != b.rid1) return a.rid1 < b.rid1;
    if (a.rid2 != b.rid2) return a.rid2 < b.rid2;
    if (a.pos1 != b.pos1) return a.pos1 < b.pos1;
    if (a.pos2 != b.pos2) return a.pos2 < b.pos2;
    if (a.mapq != b.mapq) return a.mapq < b.mapq;
    if (a.read_id != b.read_id) return a.read_id < b.read_id;
    return a.row < b.row;
  });
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  std::vector<uint8_t> buf;
  buf.reserve(1 << 19);
  bool ok = true;
  auto put = [&](const void* src, size_t len) {
    const uint8_t* q = (const uint8_t*)src;
    buf.insert(buf.end(), q, q + len);
    if (buf.size() >= (1 << 18)) {
      ok = ok && fwrite(buf.data(), 1, buf.size(), f) == buf.size();
      buf.clear();
    }
  };
  const uint8_t tag = n ? 6 : 0;
  const uint64_t refs = (uint64_t)std::max(num_refs, 0);
  put("CTSH1\0", 6);
  put(&tag, 1);
  put(&refs, 8);
  size_t next = 0;
  for (uint64_t r = 0; r < refs; ++r) {
    put(&counts[r], 8);
    for (uint64_t c = 0; c < counts[r]; ++c) {
      const int64_t i = keys[next++].row;
      const uint16_t len = (uint16_t)name_len[i];
      put(rows + 33 * i, 33);
      put(&len, 2);
      put(names + name_start[i], len);
    }
  }
  ok = ok && fwrite(buf.data(), 1, buf.size(), f) == buf.size();
  ok = (fclose(f) == 0) && ok;
  return ok ? n : -2;
}

}  // extern "C"
