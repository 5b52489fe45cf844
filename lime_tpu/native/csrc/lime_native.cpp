// lime-tpu native runtime: multi-string eBWT/LCP/DA index construction.
//
// Replaces the reference's external L0 toolchain (BCR_LCP_GSA + egsa + eGap,
// cloned by Install_tools_preprocessing.sh:14-38) with a single in-process
// builder: SA-IS suffix array over the terminator-augmented concatenation,
// Kasai LCP, and direct eBWT/DA extraction.  Conventions match
// lime_tpu.index.builder (terminator of sequence i sorts before all
// nucleotides and before terminator j>i; lcp never crosses a terminator).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>
#ifdef __AVX2__
#include <immintrin.h>
#endif
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using i64 = int64_t;

// ---------------------------------------------------------------------------
// SA-IS (linear-time suffix array, integer alphabet).
// s[0..n-1] with s[n-1] == 0 the unique smallest sentinel; alphabet [0, K).
// ---------------------------------------------------------------------------

void get_buckets(const i64* s, i64* bkt, i64 n, i64 K, bool end) {
  std::memset(bkt, 0, sizeof(i64) * K);
  for (i64 i = 0; i < n; i++) bkt[s[i]]++;
  i64 sum = 0;
  for (i64 i = 0; i < K; i++) {
    sum += bkt[i];
    bkt[i] = end ? sum : sum - bkt[i];
  }
}

void induce_sa_l(const std::vector<bool>& t, i64* sa, const i64* s, i64* bkt,
                 i64 n, i64 K) {
  get_buckets(s, bkt, n, K, false);
  for (i64 i = 0; i < n; i++) {
    i64 j = sa[i] - 1;
    if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
  }
}

void induce_sa_s(const std::vector<bool>& t, i64* sa, const i64* s, i64* bkt,
                 i64 n, i64 K) {
  get_buckets(s, bkt, n, K, true);
  for (i64 i = n - 1; i >= 0; i--) {
    i64 j = sa[i] - 1;
    if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
  }
}

void sais(const i64* s, i64* sa, i64 n, i64 K) {
  if (n == 1) { sa[0] = 0; return; }

  std::vector<bool> t(n);
  t[n - 1] = true;
  if (n >= 2) t[n - 2] = false;
  for (i64 i = n - 3; i >= 0; i--)
    t[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1]);

  auto is_lms = [&](i64 i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<i64> bkt(K);
  // Stage 1: sort LMS substrings by induced sorting.
  std::fill(sa, sa + n, -1);
  get_buckets(s, bkt.data(), n, K, true);
  for (i64 i = 1; i < n; i++)
    if (is_lms(i)) sa[--bkt[s[i]]] = i;
  induce_sa_l(t, sa, s, bkt.data(), n, K);
  induce_sa_s(t, sa, s, bkt.data(), n, K);

  // Compact sorted LMS suffixes into sa[0..n1).
  i64 n1 = 0;
  for (i64 i = 0; i < n; i++)
    if (is_lms(sa[i])) sa[n1++] = sa[i];

  // Name LMS substrings.
  std::fill(sa + n1, sa + n, -1);
  i64 name = 0, prev = -1;
  for (i64 i = 0; i < n1; i++) {
    i64 pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (i64 d = 0;; d++) {
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
      }
    }
    if (diff) { name++; prev = pos; }
    sa[n1 + pos / 2] = name - 1;
  }
  for (i64 i = n - 1, j = n - 1; i >= n1; i--)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // Stage 2: sort the reduced problem.
  i64* s1 = sa + n - n1;
  i64* sa1 = sa;
  if (name < n1) {
    sais(s1, sa1, n1, name);
  } else {
    for (i64 i = 0; i < n1; i++) sa1[s1[i]] = i;
  }

  // Stage 3: induce the full SA from sorted LMS suffixes.
  std::vector<i64> lms(n1);
  for (i64 i = 1, j = 0; i < n; i++)
    if (is_lms(i)) lms[j++] = i;
  for (i64 i = 0; i < n1; i++) sa1[i] = lms[sa1[i]];
  std::fill(sa + n1, sa + n, -1);
  get_buckets(s, bkt.data(), n, K, true);
  for (i64 i = n1 - 1; i >= 0; i--) {
    i64 j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
  }
  induce_sa_l(t, sa, s, bkt.data(), n, K);
  induce_sa_s(t, sa, s, bkt.data(), n, K);
}

}  // namespace

extern "C" {

// Build the merged-collection index.
//
//   concat      — all sequences back to back, no terminators (u8 bytes)
//   seq_lens    — length of each sequence (num_seqs entries)
//   num_seqs    — number of documents
//   ebwt/lcp/da — caller-allocated outputs of size total = sum(len_i + 1)
//
// Returns 0 on success, negative on error.
int64_t lime_build_index(const uint8_t* concat, const int64_t* seq_lens,
                         int64_t num_seqs, uint8_t* ebwt, uint32_t* lcp,
                         uint32_t* da) {
  if (num_seqs <= 0) return -1;
  i64 total = 0;
  for (i64 i = 0; i < num_seqs; i++) total += seq_lens[i] + 1;

  // Integer string: terminator of seq i -> 1 + i (document order),
  // byte b -> 1 + num_seqs + b; global sentinel 0 appended.
  const i64 n = total + 1;
  const i64 K = 1 + num_seqs + 256;
  std::vector<i64> s(n);
  std::vector<i64> doc_of(n);
  std::vector<bool> seq_start(n, false);
  {
    i64 w = 0, r = 0;
    for (i64 d = 0; d < num_seqs; d++) {
      seq_start[w] = true;
      for (i64 k = 0; k < seq_lens[d]; k++, w++, r++) {
        s[w] = 1 + num_seqs + concat[r];
        doc_of[w] = d;
      }
      s[w] = 1 + d;
      doc_of[w] = d;
      w++;
    }
    s[w] = 0;
    doc_of[w] = num_seqs - 1;
  }

  std::vector<i64> sa(n);
  sais(s.data(), sa.data(), n, K);
  // sa[0] is the global sentinel; rows are sa[1..n).

  // Kasai LCP over the integer string.  Rows exclude the sentinel:
  // row x = sa[x+1]; rank[i] = row index of suffix i; the predecessor of
  // row r is sa[r].  Terminators are pairwise distinct and every suffix
  // hits one before the global sentinel, so the extension loop always
  // terminates in bounds and lcp never crosses a terminator.
  std::vector<i64> rank(total);
  for (i64 i = 1; i < n; i++) rank[sa[i]] = i - 1;
  {
    std::vector<i64> lcp64(total, 0);
    i64 h = 0;
    for (i64 i = 0; i < total; i++) {
      i64 r = rank[i];
      if (r > 0) {
        i64 j = sa[r];
        while (s[i + h] == s[j + h]) h++;
        lcp64[r] = h;
        if (h > 0) h--;
      } else {
        h = 0;
      }
    }
    for (i64 x = 0; x < total; x++)
      lcp[x] = static_cast<uint32_t>(lcp64[x]);
  }

  for (i64 x = 0; x < total; x++) {
    i64 p = sa[x + 1];
    da[x] = static_cast<uint32_t>(doc_of[p]);
    if (seq_start[p]) {
      ebwt[x] = '$';
    } else {
      i64 v = s[p - 1];
      ebwt[x] = (v >= 1 + num_seqs) ? static_cast<uint8_t>(v - 1 - num_seqs)
                                    : '$';
    }
  }
  return 0;
}

// Single-pass fused-pipeline planner with density routing.
//
// Streams the collection index once, detecting alpha-clusters (maximal runs
// of lcp >= alpha extended one row left — reference src/ClusterLCP.cpp:14-43)
// and applying the membership filter (>= 1 read and >= 1 genome row,
// src/ClusterLCP.cpp:220) on the fly.  Each kept cluster is routed by
// genome density:
//
// - genome-rich pure-ACGT clusters of length <= 255 go to the banded device
//   kernel, whose per-position cost is window * G_pad one-hot lanes —
//   efficient exactly when many genome lanes hit;
// - everything else (sparse clusters, where the one-hot would idle most
//   lanes; IUPAC-degenerate clusters, whose leftover waterfall is stateful,
//   src/ClusterBWT_DA.cpp:146-177; clusters longer than the 255 occurrence
//   saturation bound, up to sizeMaxBuf=65,536, src/Tools.h:35) goes to the
//   native SIMD scorer (lime_score_clusters below).
//
//   lcp/da      — index arrays, n positions
//   ebwt        — may be null (document-only scoring, reference EBWT=0)
//   g_dense     — minimum genome positions for banded routing (0 = always banded)
//   dense_min   — when > 0, pure-ACGT clusters with >= dense_min genome
//                 positions route to a third class: the dense histogram-matmul
//                 device path (lime_plan_dense below), which handles any
//                 length up to sizeMaxBuf — the large-G regime where neither
//                 the banded kernel nor the host scorer is economical
//   sym_lut     — 256-entry symbol-rank table (low 4 bits used)
//   deg_lut     — 256-entry IUPAC-degenerate indicator
//   packed      — compacted stream bytes, capacity n
//   doc16/doc32 — compacted doc ids; exactly one non-null, capacity n
//   bad_start/bad_len — host-scored cluster list, capacity n/2 + 1
//   dense_start/dense_len — dense-routed cluster list, capacity n/2 + 1
//                 (may be null when dense_min == 0)
//   meta        — out: [n_compact, window, n_bad, n_dense]
//
// Returns 0 on success, negative on error.
int64_t lime_plan(const uint32_t* lcp, const uint32_t* da, const uint8_t* ebwt,
                  int64_t n, int64_t num_reads, uint32_t alpha,
                  int64_t g_dense, int64_t dense_min,
                  const uint8_t* sym_lut, const uint8_t* deg_lut,
                  uint8_t* packed, uint16_t* doc16, uint32_t* doc32,
                  int64_t* bad_start, int64_t* bad_len,
                  int64_t* dense_start, int64_t* dense_len, int64_t* meta) {
  if (n <= 0 || (!doc16 && !doc32)) return -1;
  if (dense_min > 0 && (!dense_start || !dense_len)) return -4;
  i64 w = 0, nbad = 0, ndense = 0, window = 1;
  const bool prof = std::getenv("LIME_PLAN_PROF") != nullptr;
  auto now = [] {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  };
  double t0 = prof ? now() : 0;

  // Vectorized scan: a per-position branchy state machine runs far below
  // memory bandwidth (branch mispredicts).  Instead:
  // (A) build the in-run byte mask in one auto-vectorized pass, (B) count
  // mask transitions, (C) collect transition indices with a branchless
  // always-store loop.  Since the mask starts at 0, transitions alternate
  // run-start / run-end, so the collected list IS the run list.
  std::vector<uint8_t> m(n);
  for (i64 i = 0; i < n; i++) m[i] = lcp[i] >= alpha;
  // position 0 can never open or continue a run (the reference's
  // skip-leading rule, src/ClusterLCP.cpp:196-202)
  m[0] = 0;
  if (prof) { fprintf(stderr, "[plan] mask %.3fs\n", now() - t0); t0 = now(); }
  i64 n_tr = 0;
  for (i64 i = 1; i < n; i++) n_tr += m[i] ^ m[i - 1];
  std::vector<uint32_t> tr(n_tr + 1);
  {
    i64 k = 0;
    uint32_t* trp = tr.data();
    for (i64 i = 1; i < n; i++) {
      trp[k] = static_cast<uint32_t>(i);
      k += m[i] ^ m[i - 1];
    }
    if (m[n - 1]) tr[k++] = static_cast<uint32_t>(n);
    n_tr = k;
  }
  if (prof) {
    fprintf(stderr, "[plan] transitions %.3fs (n_tr=%lld)\n", now() - t0,
            static_cast<long long>(n_tr));
    t0 = now();
  }
  const uint32_t nr_u32 = static_cast<uint32_t>(num_reads);

  for (i64 p = 0; p + 1 < n_tr; p += 2) {
    const i64 s = tr[p], e = tr[p + 1];
    const i64 ps = s - 1;  // cluster rows = run extended one row left
    const i64 len = e - ps;

    i64 nr = 0;
    for (i64 j = ps; j < e; j++) nr += da[j] < nr_u32;
    const i64 n_g = len - nr;
    if (nr > 0 && n_g > 0) {  // membership filter (src/ClusterLCP.cpp:220)
      bool deg = false;
      if (ebwt) {
        uint8_t acc = 0;
        for (i64 j = ps; j < e; j++) acc |= deg_lut[ebwt[j]];
        deg = acc != 0;
      }
      if (!deg && dense_min > 0 && n_g >= dense_min && len <= 65536) {
        dense_start[ndense] = ps;
        dense_len[ndense] = len;
        ndense++;
      } else if (len > 255 || deg || n_g < g_dense) {
        bad_start[nbad] = ps;
        bad_len[nbad] = len;
        nbad++;
      } else {
        if (len > window) window = len;
        for (i64 j = ps; j < e; j++) {
          uint8_t sym = ebwt ? (sym_lut[ebwt[j]] & 15) : 0;
          packed[w] = sym | static_cast<uint8_t>((j > ps) ? 0x40 : 0);
          if (doc16) {
            doc16[w] = static_cast<uint16_t>(da[j]);
          } else {
            doc32[w] = da[j];
          }
          w++;
        }
      }
    }
  }

  if (prof) fprintf(stderr, "[plan] runs %.3fs\n", now() - t0);
  meta[0] = w;
  meta[1] = window;
  meta[2] = nbad;
  meta[3] = ndense;
  return 0;
}

// Pair-stream planner — the G-independent device scoring path.
//
// At any genome count, almost all alpha-clusters are genome-SPARSE
// (typically one genome document per cluster), so the banded kernel's
// window x G_pad one-hot lanes idle and the dense batched matmul cannot
// amortize.  This pass restructures sparse clusters for a device program
// whose cost does not depend on G: each cluster is re-emitted once per
// distinct genome document it contains (a "copy" = all of the cluster's
// read positions plus that one genome's positions, grouped by document).
// Every emitted row carries one packed byte
//
//   bit6  m       in-run bit (0 on a copy's first row): the device's
//                 same-cluster AND-chain, as in the banded kernel
//   bit5  docrun  0 on the first row of each document group: the chain
//                 for per-(cluster, doc, symbol) occurrence indices
//   bit4  side    1 = genome-side row
//   bits0-3       symbol rank (equality-matched; degenerates are routed
//                 to the exact host scorer before this point)
//
// plus a precomputed int32 scatter index row * g_pad + gcol (gcol = the
// copy's genome column; genome-side rows scatter into the num_reads drop
// row).  The device derives occurrence indices with the docrun chain,
// matches read rows against genome rows of equal (symbol, occ) across
// the band — the occurrence-matching identity for
// t = sum_s min(cnt_r(s), cnt_g(s)), reference src/ClusterBWT_DA.cpp:
// 107-190 — and scatter-adds per-row hit counts: one scalar lane per
// position instead of G_pad one-hot lanes.
//
// Copies are binned into 3 window buckets (copy length <= 16 / 64 / 255)
// so the short-cluster majority never pays a long cluster's band width.
// Routing: clusters with >= dense_min genome positions go to the dense
// histogram-matmul path (dense_start/len; lime_plan_dense); IUPAC-
// degenerate clusters and sparse clusters longer than 255 (where the
// reference's u8 counter wrap/saturation quirks bite,
// src/ClusterBWT_DA.cpp:96,123) go to bad (exact host rescue).
//
//   lcp/da      — index arrays, n positions
//   ebwt        — may be null (document-count variant, reference EBWT=0)
//   g_pad       — genome-lane padding of the similarity matrix; the
//                 caller guarantees (num_reads + 1) * g_pad < 2^31
//   cap         — capacity of packed/flatidx; if the emitted stream is
//                 larger the call returns 1 with meta[0] = needed size
//                 (replication makes the bound data-dependent)
//   packed/flatidx — the bucket-ordered stream (bucket 0, then 1, 2)
//   dense_*/bad_*  — cluster routing lists, capacity n/2 + 1 each
//   meta        — out: [needed, n_dense, n_bad, w0, w1, w2, off1, off2]
//                 (bucket b's rows are [off_b, off_{b+1}) with off0 = 0,
//                 off3 = needed; w_b = that bucket's max copy length)
//
// Returns 0 on success, 1 on insufficient cap, negative on error.
int64_t lime_plan_pairs(const uint32_t* lcp, const uint32_t* da,
                        const uint8_t* ebwt, int64_t n, int64_t num_reads,
                        uint32_t alpha, int64_t dense_min, int64_t g_pad,
                        const uint8_t* sym_lut, const uint8_t* deg_lut,
                        int64_t cap, uint8_t* packed, int32_t* flatidx,
                        int64_t* dense_start, int64_t* dense_len,
                        int64_t* bad_start, int64_t* bad_len,
                        int64_t* meta) {
  if (n <= 0 || num_reads <= 0 || g_pad < 1) return -1;
  if ((num_reads + 1) * g_pad > INT32_MAX) return -2;
  const i64 BUCKET_CAP[3] = {16, 64, 255};
  const int32_t drop_flat = static_cast<int32_t>(num_reads * g_pad);

  // In-run byte mask + transition collection (same vectorized scheme as
  // lime_plan above: branchless passes instead of a per-position state
  // machine).
  std::vector<uint8_t> m(n);
  for (i64 i = 0; i < n; i++) m[i] = lcp[i] >= alpha;
  m[0] = 0;  // skip-leading rule (reference src/ClusterLCP.cpp:196-202)
  i64 n_tr = 0;
  for (i64 i = 1; i < n; i++) n_tr += m[i] ^ m[i - 1];
  std::vector<uint32_t> tr(n_tr + 1);
  {
    i64 k = 0;
    uint32_t* trp = tr.data();
    for (i64 i = 1; i < n; i++) {
      trp[k] = static_cast<uint32_t>(i);
      k += m[i] ^ m[i - 1];
    }
    if (m[n - 1]) tr[k++] = static_cast<uint32_t>(n);
    n_tr = k;
  }

  std::vector<uint8_t> pk[3];
  std::vector<int32_t> fl[3];
  for (int b = 0; b < 3; b++) {
    pk[b].reserve(n / 4);
    fl[b].reserve(n / 4);
  }
  i64 windows[3] = {1, 1, 1};
  i64 nbad = 0, ndense = 0;

  // per-cluster scratch (pair-path clusters are <= 255 rows)
  uint32_t cl_doc[256];
  uint8_t cl_sym[256];
  uint32_t seen_doc[256];
  uint8_t seen_read[256];
  const uint32_t nr_u32 = static_cast<uint32_t>(num_reads);

  for (i64 p = 0; p + 1 < n_tr; p += 2) {
    const i64 s = tr[p], e = tr[p + 1];
    const i64 ps = s - 1;  // cluster rows = run extended one row left
    const i64 len = e - ps;

    i64 nr = 0;
    for (i64 j = ps; j < e; j++) nr += da[j] < nr_u32;
    const i64 n_g = len - nr;
    if (nr == 0 || n_g == 0) continue;  // membership filter

    bool deg = false;
    if (ebwt) {
      uint8_t acc = 0;
      for (i64 j = ps; j < e; j++) acc |= deg_lut[ebwt[j]];
      deg = acc != 0;
    }
    if (!deg && dense_min > 0 && len <= 65536 &&
        (n_g >= dense_min || len > 255)) {
      dense_start[ndense] = ps;
      dense_len[ndense] = len;
      ndense++;
      continue;
    }
    if (deg || len > 255) {
      bad_start[nbad] = ps;
      bad_len[nbad] = len;
      nbad++;
      continue;
    }

    // Distinct documents in first-seen order; genome copy emission.
    i64 n_seen = 0;
    for (i64 j = ps; j < e; j++) {
      const uint32_t d = da[j];
      const uint8_t sym =
          ebwt ? static_cast<uint8_t>(sym_lut[ebwt[j]] & 15) : 0;
      cl_doc[j - ps] = d;
      cl_sym[j - ps] = sym;
      i64 t = 0;
      while (t < n_seen && seen_doc[t] != d) t++;
      if (t == n_seen) {
        seen_doc[n_seen] = d;
        seen_read[n_seen] = d < nr_u32;
        n_seen++;
      }
    }

    for (i64 gi = 0; gi < n_seen; gi++) {
      if (seen_read[gi]) continue;
      const uint32_t g = seen_doc[gi];
      // copy length = all read rows + this genome's rows
      i64 g_rows = 0;
      for (i64 j = 0; j < len; j++) g_rows += cl_doc[j] == g;
      const i64 copy_len = nr + g_rows;
      const int b = copy_len <= BUCKET_CAP[0] ? 0
                    : copy_len <= BUCKET_CAP[1] ? 1 : 2;
      if (copy_len > windows[b]) windows[b] = copy_len;
      const int32_t gcol = static_cast<int32_t>(g - nr_u32);
      bool first_of_copy = true;
      for (i64 t = 0; t < n_seen; t++) {
        const uint32_t d = seen_doc[t];
        const bool is_read = seen_read[t];
        if (!is_read && d != g) continue;
        const int32_t flat =
            is_read ? static_cast<int32_t>(static_cast<i64>(d) * g_pad +
                                           gcol)
                    : drop_flat;
        const uint8_t side = is_read ? 0 : 0x10;
        bool first_of_doc = true;
        for (i64 j = 0; j < len; j++) {
          if (cl_doc[j] != d) continue;
          uint8_t byte = static_cast<uint8_t>(cl_sym[j] | side);
          if (!first_of_copy) byte |= 0x40;
          if (!first_of_doc) byte |= 0x20;
          first_of_copy = false;
          first_of_doc = false;
          pk[b].push_back(byte);
          fl[b].push_back(flat);
        }
      }
    }
  }

  const i64 n0 = static_cast<i64>(pk[0].size());
  const i64 n1 = static_cast<i64>(pk[1].size());
  const i64 n2 = static_cast<i64>(pk[2].size());
  const i64 needed = n0 + n1 + n2;
  meta[0] = needed;
  meta[1] = ndense;
  meta[2] = nbad;
  meta[3] = windows[0];
  meta[4] = windows[1];
  meta[5] = windows[2];
  meta[6] = n0;
  meta[7] = n0 + n1;
  if (needed > cap) return 1;
  i64 off = 0;
  for (int b = 0; b < 3; b++) {
    std::memcpy(packed + off, pk[b].data(), pk[b].size());
    std::memcpy(flatidx + off, fl[b].data(),
                fl[b].size() * sizeof(int32_t));
    off += static_cast<i64>(pk[b].size());
  }
  return 0;
}

namespace {

// Bit-packing state for one window bucket of the packed pair stream
// (lime_plan_pairs_packed below).  Rows are packed 8 at a time: W bits of
// read-row id per lane (W/4 little-endian u32 words per group) plus 5
// metadata bits per lane (5 bytes per group): sym(2) | m | docrun | side.
struct BucketPack {
  std::vector<uint32_t> rows;
  std::vector<uint8_t> bits;
  std::vector<uint16_t> gcol;
  // per finished chunk: {n_rows, words_off, bits_off, gcol_off, gcol_cnt}
  std::vector<std::array<i64, 5>> chunks;
  i64 cur_rows = 0;
  i64 cur_words_off = 0, cur_bits_off = 0, cur_gcol_off = 0;
  uint32_t grp_rows[8];
  uint8_t grp_bits[8];
  int grp_n = 0;
  i64 window = 1;

  void flush_group(int W) {
    if (grp_n == 0) return;
    for (int j = grp_n; j < 8; j++) {  // pad lanes: side=1, m=0 (chain
      grp_rows[j] = 0;                 // break), so pads never match
      grp_bits[j] = 0x10;
    }
    const int nw = W / 4;
    uint32_t w[8] = {0};
    for (int j = 0; j < 8; j++) {
      const int off = W * j;
      w[off >> 5] |= grp_rows[j] << (off & 31);
      if ((off & 31) + W > 32)
        w[(off >> 5) + 1] |= grp_rows[j] >> (32 - (off & 31));
    }
    for (int a = 0; a < nw; a++) rows.push_back(w[a]);
    uint8_t b[5] = {0};
    for (int j = 0; j < 8; j++) {
      const int off = 5 * j;
      b[off >> 3] |= static_cast<uint8_t>(grp_bits[j] << (off & 7));
      if ((off & 7) + 5 > 8)
        b[(off >> 3) + 1] |= static_cast<uint8_t>(grp_bits[j] >>
                                                  (8 - (off & 7)));
    }
    for (int a = 0; a < 5; a++) bits.push_back(b[a]);
    cur_rows += 8;
    grp_n = 0;
  }

  void finish_chunk() {
    chunks.push_back({cur_rows,
                      cur_words_off, cur_bits_off, cur_gcol_off,
                      static_cast<i64>(gcol.size()) - cur_gcol_off});
    cur_words_off = static_cast<i64>(rows.size());
    cur_bits_off = static_cast<i64>(bits.size());
    cur_gcol_off = static_cast<i64>(gcol.size());
    cur_rows = 0;
  }
};

}  // namespace

// Packed-stream pair planner — the transfer-optimal variant of
// lime_plan_pairs.  A slow host<->device link can bound the whole
// pipeline, so the stream ships at 3.125 bytes/row instead of 5: 5
// metadata bits (sym(2)|m|docrun|side) + a W-bit read-row id per row, packed 8 rows per
// group, plus one u16 genome column per copy (broadcast to rows on device
// via a cumsum of copy-start bits + one gather).  Routing and semantics
// are identical to lime_plan_pairs; additionally any cluster containing a
// symbol of rank > 3 (i.e. '\0' -> rank 15 — never produced by FASTA
// input) routes to the host scorer, since sym has 2 bits here.
//
// The planner also CHUNKS each bucket: copies never straddle chunks
// (chunk cuts fall on copy boundaries, groups padded with inert side=1
// rows), middle chunks are exactly chunk_pos rows and the final chunk of
// each bucket is padded up to a power of two >= 65536 — so the device
// program compiles for a handful of static shapes and no single transfer
// exceeds ~chunk_pos * 3.2 bytes.
//
//   row_bits    — W in {20, 24, 28}; caller picks the smallest holding
//                 num_reads (row ids < 2^W; genome rows carry row 0 and
//                 side=1)
//   chunk_pos   — rows per middle chunk (multiple of 8, e.g. 1<<22)
//   chunk_meta  — out, 7 i64 per chunk:
//                 [bucket, owner, n_rows, words_off, bits_off, gcol_off,
//                 gcol_cnt] (owner = dp shard owning the chunk's read
//                 rows; always 0 when dp == 1)
//   meta        — out: [needed_words, needed_bits, needed_gcol, n_chunks,
//                 n_dense, n_bad, w0, w1, w2]
//
// Returns 0 on success, 1 if any capacity is insufficient (meta holds the
// needed sizes; caller re-allocates and retries), negative on error.
int64_t lime_plan_pairs_packed(
    const uint32_t* lcp, const uint32_t* da, const uint8_t* ebwt,
    int64_t n, int64_t num_reads, uint32_t alpha, int64_t dense_min,
    int64_t row_bits, int64_t chunk_pos, int64_t host_num,
    int64_t dp, int64_t rows_local,
    const uint8_t* sym_lut, const uint8_t* deg_lut,
    int64_t cap_words, int64_t cap_bits, int64_t cap_gcol,
    int64_t cap_chunks,
    uint32_t* rows_out, uint8_t* bits_out, uint16_t* gcol_out,
    int64_t* chunk_meta,
    int64_t* dense_start, int64_t* dense_len,
    int64_t* bad_start, int64_t* bad_len, int64_t* meta) {
  if (n <= 0 || num_reads <= 0) return -1;
  if (host_num < 0 || host_num > 256) return -5;
  if (row_bits != 20 && row_bits != 24 && row_bits != 28) return -2;
  if (num_reads > (static_cast<i64>(1) << row_bits)) return -3;
  if (chunk_pos < 65536 || (chunk_pos & 7)) return -4;
  // dp-sliced emission (the SPMD engine's read-row ownership split):
  // each cluster copy is re-emitted once per dp shard owning at least
  // one of its read documents, with only that shard's read docs plus
  // the genome rows — occurrence matching is per-document, so the
  // sub-copy scores are exactly the owner's share of the copy's pairs.
  if (dp < 1 || dp > 1024) return -6;
  if (dp > 1 && rows_local < 1) return -6;
  if (dp == 1) rows_local = num_reads + 1;  // single owner
  const int W = static_cast<int>(row_bits);
  const i64 BUCKET_CAP[3] = {16, 64, 255};

  std::vector<uint8_t> m(n);
  for (i64 i = 0; i < n; i++) m[i] = lcp[i] >= alpha;
  m[0] = 0;  // skip-leading rule (reference src/ClusterLCP.cpp:196-202)
  i64 n_tr = 0;
  for (i64 i = 1; i < n; i++) n_tr += m[i] ^ m[i - 1];
  std::vector<uint32_t> tr(n_tr + 1);
  {
    i64 k = 0;
    uint32_t* trp = tr.data();
    for (i64 i = 1; i < n; i++) {
      trp[k] = static_cast<uint32_t>(i);
      k += m[i] ^ m[i - 1];
    }
    if (m[n - 1]) tr[k++] = static_cast<uint32_t>(n);
    n_tr = k;
  }

  // Run ranges split across OpenMP threads; each thread emits into its
  // own bucket packs + routing lists (the reference's analogue is the
  // per-thread byte-range decomposition, src/ClusterLCP.cpp:100-167 —
  // here the split is at run granularity, so no straddle protocol is
  // needed).  Thread-order concatenation keeps the output deterministic.
  int n_threads = 1;
#ifdef _OPENMP
  n_threads = omp_get_max_threads();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
#endif
  const i64 n_runs = n_tr / 2;
  struct ThreadCtx {
    std::vector<BucketPack> packs;  // [bucket * dp + owner]
    std::vector<i64> den_s, den_l, bd_s, bd_l;
  };
  std::vector<ThreadCtx> ctxs(n_threads);
  for (auto& cx : ctxs) cx.packs.resize(3 * dp);
  const uint32_t nr_u32 = static_cast<uint32_t>(num_reads);

#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
#endif
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    ThreadCtx& cx = ctxs[tid];
    const i64 r0 = n_runs * tid / n_threads;
    const i64 r1 = n_runs * (tid + 1) / n_threads;
    uint32_t cl_doc[256];
    uint8_t cl_sym[256];
    uint32_t seen_doc[256];
    uint8_t seen_read[256];

    for (i64 r = r0; r < r1; r++) {
      const i64 p = 2 * r;
      const i64 s = tr[p], e = tr[p + 1];
      const i64 ps = s - 1;
      const i64 len = e - ps;

      i64 nr = 0;
      for (i64 j = ps; j < e; j++) nr += da[j] < nr_u32;
      const i64 n_g = len - nr;
      if (nr == 0 || n_g == 0) continue;  // membership filter

      // Hybrid host/device split: a deterministic hash of the global run
      // index routes this share of clusters to the host scorer (the
      // adaptive dispatcher picks host_num from the measured link
      // bandwidth — on a degraded interconnect the 2-core SIMD scorer
      // plus a delta-COO uplink beats shipping the stream).  Scatter
      // adds commute, so any split is byte-identical to host_num=0.
      if (host_num &&
          (host_num == 256 ||
           ((static_cast<uint32_t>(r) * 2654435761u) >> 24) <
               static_cast<uint32_t>(host_num))) {
        cx.bd_s.push_back(ps);
        cx.bd_l.push_back(len);
        continue;
      }

      bool deg = false, wide_sym = false;
      if (ebwt) {
        uint8_t acc = 0;
        for (i64 j = ps; j < e; j++) {
          acc |= deg_lut[ebwt[j]];
          wide_sym |= (sym_lut[ebwt[j]] & 15) > 3;
        }
        deg = acc != 0;
      }
      if (!deg && !wide_sym && dense_min > 0 && len <= 65536 &&
          (n_g >= dense_min || len > 255)) {
        // genome-dense clusters AND deep-coverage long clusters (>255
        // rows, e.g. high-coverage read sets) ride the dense matmul path;
        // only degenerates and len > 65536 need the exact host scorer
        cx.den_s.push_back(ps);
        cx.den_l.push_back(len);
        continue;
      }
      if (deg || wide_sym || len > 255) {
        cx.bd_s.push_back(ps);
        cx.bd_l.push_back(len);
        continue;
      }

      i64 n_seen = 0;
      for (i64 j = ps; j < e; j++) {
        const uint32_t d = da[j];
        const uint8_t sym =
            ebwt ? static_cast<uint8_t>(sym_lut[ebwt[j]] & 3) : 0;
        cl_doc[j - ps] = d;
        cl_sym[j - ps] = sym;
        i64 t = 0;
        while (t < n_seen && seen_doc[t] != d) t++;
        if (t == n_seen) {
          seen_doc[n_seen] = d;
          seen_read[n_seen] = d < nr_u32;
          n_seen++;
        }
      }

      // owners present among this cluster's read docs (first-seen
      // order); dp == 1 -> the single owner 0
      i64 own_list[256];
      i64 own_nr[256];  // read rows owned per owner
      i64 n_own = 0;
      for (i64 t = 0; t < n_seen; t++) {
        if (!seen_read[t]) continue;
        const i64 o = seen_doc[t] / rows_local;
        i64 rows_d = 0;
        for (i64 j = 0; j < len; j++) rows_d += cl_doc[j] == seen_doc[t];
        i64 k2 = 0;
        while (k2 < n_own && own_list[k2] != o) k2++;
        if (k2 == n_own) {
          own_list[n_own] = o;
          own_nr[n_own] = 0;
          n_own++;
        }
        own_nr[k2] += rows_d;
      }

      for (i64 gi = 0; gi < n_seen; gi++) {
        if (seen_read[gi]) continue;
        const uint32_t g = seen_doc[gi];
        i64 g_rows = 0;
        for (i64 j = 0; j < len; j++) g_rows += cl_doc[j] == g;
        for (i64 oi = 0; oi < n_own; oi++) {
          const i64 owner = own_list[oi];
          const i64 copy_len = own_nr[oi] + g_rows;
          const int b = copy_len <= BUCKET_CAP[0] ? 0
                        : copy_len <= BUCKET_CAP[1] ? 1 : 2;
          BucketPack& bp = cx.packs[b * dp + owner];
          if (copy_len > bp.window) bp.window = copy_len;
          // close the chunk before this copy if it would overflow
          if (bp.cur_rows + bp.grp_n + copy_len > chunk_pos) {
            bp.flush_group(W);
            while (bp.cur_rows < chunk_pos) {
              bp.grp_n = 8;  // one full pad group
              for (int j = 0; j < 8; j++) {
                bp.grp_rows[j] = 0;
                bp.grp_bits[j] = 0x10;
              }
              bp.flush_group(W);
            }
            bp.finish_chunk();
          }
          bp.gcol.push_back(static_cast<uint16_t>(g - nr_u32));
          // read groups first, genome rows last: the device recovers
          // copy boundaries as (read-side & m=0) rows, so a copy's
          // first row MUST be read-side (pads carry side=1 and never
          // fire the bit)
          bool first_of_copy = true;
          for (int pass = 0; pass < 2; pass++) {
            for (i64 t = 0; t < n_seen; t++) {
              const uint32_t d = seen_doc[t];
              const bool is_read = seen_read[t];
              if (pass == 0
                      ? (!is_read ||
                         static_cast<i64>(d) / rows_local != owner)
                      : (is_read || d != g))
                continue;
              const uint8_t side = is_read ? 0 : 0x10;
              bool first_of_doc = true;
              for (i64 j = 0; j < len; j++) {
                if (cl_doc[j] != d) continue;
                uint8_t b5 = static_cast<uint8_t>(cl_sym[j] | side);
                if (!first_of_copy) b5 |= 0x04;  // m
                if (!first_of_doc) b5 |= 0x08;   // docrun
                first_of_copy = false;
                first_of_doc = false;
                if (bp.grp_n == 8) bp.flush_group(W);
                bp.grp_rows[bp.grp_n] = is_read ? d : 0;
                bp.grp_bits[bp.grp_n] = b5;
                bp.grp_n++;
              }
            }
          }
        }
      }
    }

    // final chunk per bucket: pad rows up to a power of two >= 65536, or
    // past 512K to the next 512K multiple (bounds both the pad waste and
    // the number of compiled shape variants)
    for (i64 b = 0; b < 3 * dp; b++) {
      BucketPack& bp = cx.packs[b];
      bp.flush_group(W);
      if (bp.cur_rows) {
        i64 p2 = 65536;
        while (p2 < bp.cur_rows && p2 < (1 << 19)) p2 <<= 1;
        if (bp.cur_rows > p2)
          p2 = (bp.cur_rows + (1 << 19) - 1) >> 19 << 19;
        while (bp.cur_rows < p2) {
          for (int j = 0; j < 8; j++) {
            bp.grp_rows[j] = 0;
            bp.grp_bits[j] = 0x10;
          }
          bp.grp_n = 8;
          bp.flush_group(W);
        }
        bp.finish_chunk();
      }
    }
  }

  i64 tw = 0, tb = 0, tg = 0, tc = 0, ndense = 0, nbad = 0;
  i64 windows[3] = {1, 1, 1};
  for (const ThreadCtx& cx : ctxs) {
    for (i64 p = 0; p < 3 * dp; p++) {
      const int b = static_cast<int>(p / dp);
      tw += static_cast<i64>(cx.packs[p].rows.size());
      tb += static_cast<i64>(cx.packs[p].bits.size());
      tg += static_cast<i64>(cx.packs[p].gcol.size());
      tc += static_cast<i64>(cx.packs[p].chunks.size());
      if (cx.packs[p].window > windows[b]) windows[b] = cx.packs[p].window;
    }
    ndense += static_cast<i64>(cx.den_s.size());
    nbad += static_cast<i64>(cx.bd_s.size());
  }
  meta[0] = tw;
  meta[1] = tb;
  meta[2] = tg;
  meta[3] = tc;
  meta[4] = ndense;
  meta[5] = nbad;
  meta[6] = windows[0];
  meta[7] = windows[1];
  meta[8] = windows[2];
  if (tw > cap_words || tb > cap_bits || tg > cap_gcol || tc > cap_chunks)
    return 1;
  i64 ow = 0, ob = 0, og = 0, oc = 0, od = 0, ox = 0;
  for (ThreadCtx& cx : ctxs) {
    for (i64 p = 0; p < 3 * dp; p++) {
      const i64 b = p / dp;
      const i64 owner = p % dp;
      BucketPack& bp = cx.packs[p];
      std::memcpy(rows_out + ow, bp.rows.data(),
                  bp.rows.size() * sizeof(uint32_t));
      std::memcpy(bits_out + ob, bp.bits.data(), bp.bits.size());
      std::memcpy(gcol_out + og, bp.gcol.data(),
                  bp.gcol.size() * sizeof(uint16_t));
      for (const auto& c : bp.chunks) {
        chunk_meta[oc * 7 + 0] = b;
        chunk_meta[oc * 7 + 1] = owner;
        chunk_meta[oc * 7 + 2] = c[0];
        chunk_meta[oc * 7 + 3] = ow + c[1];
        chunk_meta[oc * 7 + 4] = ob + c[2];
        chunk_meta[oc * 7 + 5] = og + c[3];
        chunk_meta[oc * 7 + 6] = c[4];
        oc++;
      }
      ow += static_cast<i64>(bp.rows.size());
      ob += static_cast<i64>(bp.bits.size());
      og += static_cast<i64>(bp.gcol.size());
    }
    std::memcpy(dense_start + od, cx.den_s.data(),
                cx.den_s.size() * sizeof(i64));
    std::memcpy(dense_len + od, cx.den_l.data(),
                cx.den_l.size() * sizeof(i64));
    od += static_cast<i64>(cx.den_s.size());
    std::memcpy(bad_start + ox, cx.bd_s.data(),
                cx.bd_s.size() * sizeof(i64));
    std::memcpy(bad_len + ox, cx.bd_l.data(),
                cx.bd_l.size() * sizeof(i64));
    ox += static_cast<i64>(cx.bd_s.size());
  }
  return 0;
}

// Dense histogram-matmul planner — stream emission for genome-dense clusters.
//
// Uses the indicator-feature identity: with phi_r[s,k] = [count_r(s) >= k+1]
// and psi_g[s,k] = [count_g(s) >= k+1] (k < K), the reference's per-cluster
// score sum_s min(count_r(s), count_g(s)) (src/ClusterBWT_DA.cpp:81-191) is
// exactly the inner product phi_r . psi_g whenever every read-side count is
// <= K.  K <= 255 also subsumes the reference's genome-counter saturation
// (ClusterBWT_DA.cpp:96) and read-counter wrap (both unreachable below 256).
// Scoring a cluster batch is then one batched (entries, P_R, F) x
// (clusters, G, F) matmul on the tensor cores, F = nsym*K.
//
// Per cluster this pass emits:
// - up to max_ent *entries* of P_R read lanes each (rid = global read id,
//   pad lanes carry num_reads = the scatter drop row); cmap maps each
//   entry back to its cluster for the device-side psi gather;
// - read triples (rb = global entry id, rpf = lane*F + sym*K + k), one per
//   read-side position (occurrence k of (read, sym));
// - genome triples (gcl = global cluster id, ggf = genome*F + sym*K + k),
//   capped at K per (genome, sym).
//
// Clusters the identity cannot express (a read-side count > K, or more than
// max_ent * P_R distinct reads) get valid[c] = 0 and emit nothing — the
// caller routes them to the exact host scorer.  ent_off/rt_off/gt_off are
// CSR offsets per cluster so the caller can chunk clusters into
// fixed-shape device dispatches.  meta out: [n_entries, n_rt, n_gt].
int64_t lime_plan_dense(const int64_t* starts, const int64_t* lens,
                        int64_t n_clusters, const uint32_t* da,
                        const uint8_t* ebwt, int64_t num_reads,
                        int64_t num_docs, const uint8_t* sym_lut,
                        int64_t K, int64_t PR, int64_t max_ent,
                        int32_t* rid, int32_t* cmap,
                        int32_t* rb, int16_t* rpf,
                        int32_t* gcl, int32_t* ggf,
                        int64_t* ent_off, int64_t* rt_off, int64_t* gt_off,
                        uint8_t* valid, int64_t* meta) {
  if (n_clusters < 0 || num_reads <= 0 || num_docs <= num_reads) return -1;
  if (K < 1 || K > 255 || PR < 1 || max_ent < 1) return -1;
  // rpf holds p*F + sy*K + k in int16
  if (PR * (ebwt ? 4 : 1) * K > 32767) return -1;
  const int nsym = ebwt ? 4 : 1;
  const i64 F = nsym * K;
  std::vector<uint64_t> epoch(num_docs, 0);
  std::vector<uint32_t> cnt(num_docs * nsym, 0);
  std::vector<uint32_t> seen;
  seen.reserve(1 << 16);
  i64 ne = 0, nrt = 0, ngt = 0;
  for (i64 c = 0; c < n_clusters; c++) {
    ent_off[c] = ne;
    rt_off[c] = nrt;
    gt_off[c] = ngt;
    const uint64_t ep = static_cast<uint64_t>(c) + 1;
    seen.clear();
    const i64 s = starts[c], len = lens[c];
    bool ok = len <= 65536;
    i64 n_dr = 0;
    for (i64 j = s; ok && j < s + len; j++) {
      const uint32_t d = da[j];
      const int sym = ebwt ? (sym_lut[ebwt[j]] & 15) : 0;
      if (sym >= nsym) {  // degenerate symbol: stateful waterfall — host
        ok = false;
        break;
      }
      if (epoch[d] != ep) {
        epoch[d] = ep;
        for (int t = 0; t < nsym; t++) cnt[d * nsym + t] = 0;
        seen.push_back(d);
        if (d < num_reads) n_dr++;
      }
      uint32_t& cc = cnt[d * nsym + sym];
      cc++;
      if (d < static_cast<uint32_t>(num_reads) &&
          cc > static_cast<uint32_t>(K))
        ok = false;
    }
    const i64 n_ent = (n_dr + PR - 1) / PR;
    if (!ok || n_ent > max_ent || n_dr == 0) {
      valid[c] = 0;
      continue;
    }
    valid[c] = 1;
    for (i64 b = 0; b < n_ent; b++) {
      cmap[ne + b] = static_cast<int32_t>(c);
      for (i64 p = 0; p < PR; p++)
        rid[(ne + b) * PR + p] = static_cast<int32_t>(num_reads);
    }
    i64 ri = 0;
    for (const uint32_t d : seen) {
      if (d < static_cast<uint32_t>(num_reads)) {
        const i64 b = ne + ri / PR, p = ri % PR;
        rid[b * PR + p] = static_cast<int32_t>(d);
        for (int sy = 0; sy < nsym; sy++) {
          const i64 c0 = cnt[d * nsym + sy];  // <= K, checked above
          for (i64 k = 0; k < c0; k++) {
            rb[nrt] = static_cast<int32_t>(b);
            rpf[nrt] = static_cast<int16_t>(p * F + sy * K + k);
            nrt++;
          }
        }
        ri++;
      } else {
        for (int sy = 0; sy < nsym; sy++) {
          i64 c0 = cnt[d * nsym + sy];
          if (c0 > K) c0 = K;
          for (i64 k = 0; k < c0; k++) {
            gcl[ngt] = static_cast<int32_t>(c);
            ggf[ngt] = static_cast<int32_t>((d - num_reads) * F + sy * K + k);
            ngt++;
          }
        }
      }
    }
    ne += n_ent;
  }
  ent_off[n_clusters] = ne;
  rt_off[n_clusters] = nrt;
  gt_off[n_clusters] = ngt;
  meta[0] = ne;
  meta[1] = nrt;
  meta[2] = ngt;
  return 0;
}

}  // extern "C"

namespace {

// Per-thread flat scratch sized to the reference's sizeMaxBuf cluster cap
// (src/Tools.h:35).  Segments are (cluster, document) groups; histograms
// are materialized once per segment as the u8 views the pair loop needs
// (read counters wrapped mod 256, genome counters saturated at 255 —
// src/ClusterBWT_DA.cpp:96,123), so the hot (read x genome) loop is a
// single 16-wide u8 min+sum the compiler vectorizes.
constexpr i64 kMaxClu = 65536;

struct ClusterScratch {
  std::vector<uint64_t> keys;
  std::vector<uint32_t> seg_doc;
  std::vector<uint32_t> seg_cnt;  // raw position count (EBWT=0 variant)
  std::vector<uint8_t> seg_h8;    // 16 u8 per segment (wrapped/saturated)
  std::vector<uint32_t> seg_h32;  // raw counts (wide path + waterfall)
  std::vector<uint8_t> seg_deg;
  ClusterScratch() {
    keys.resize(kMaxClu);
    seg_doc.resize(kMaxClu);
    seg_cnt.resize(kMaxClu);
    seg_h8.resize(kMaxClu * 16);
    seg_h32.resize(kMaxClu * 16);
    seg_deg.resize(kMaxClu);
  }
};

// Shared inputs of the per-cluster scoring core.
struct ScoreCtx {
  const uint32_t* da;
  const uint8_t* ebwt;  // null selects the EBWT=0 document-count variant
  i64 num_reads;
  const uint8_t* sym_lut;
  const uint8_t* deg_lut;
  const int32_t* wf_pairs;
  i64 n_wf;
};

// Score one alpha-cluster with the reference's exact counter semantics
// (src/ClusterBWT_DA.cpp:81-252):
//
// - per (cluster, document) 16-symbol histograms; genome counters saturate
//   at 255 (Update_ref_symb, ClusterBWT_DA.cpp:96), read counters are
//   unsaturated uchar and wrap mod 256 (ClusterBWT_DA.cpp:123);
// - symbol-aware score t = sum_s min(read_h, ref_h) plus the IUPAC leftover
//   waterfall including its first-block update quirk (the losing counter is
//   zeroed, the winner never decremented — ClusterBWT_DA.cpp:150-161);
// - ebwt == null selects the document-count variant (EBWT=0,
//   ClusterBWT_DA.cpp:192-252): t = min(read_count, ref_count).
//
// The Emit policy receives every (read, genome) pair:
//   em.base(rdoc)      — per-read-row base offset (caller-defined layout)
//   em.reserve(k)      — announce <= k add() calls (batched-flush hook)
//   em.add(base+gdoc, t) — accumulate raw u32 t at that cell
// u8 counter semantics only (the reference's default build): emitters
// wrap t mod 256 (SimArray_ +=, ClusterBWT_DA.cpp:183).  The wide
// (dataTypeNumSim=1) configuration keeps the dense-plane path in
// lime_score_clusters, whose hand-scheduled loop covers both widths.
template <class Emit>
inline void score_one_cluster(const ScoreCtx& cx, i64 s, i64 len,
                              ClusterScratch& sc, Emit& em) {
  const uint32_t* da = cx.da;
  const uint8_t* ebwt = cx.ebwt;
  const i64 num_reads = cx.num_reads;
  if (len > kMaxClu) return;  // guarded upstream (sizeMaxBuf)
  if (ebwt && len <= 32) {
    // Small-cluster fast path (the overwhelming majority: mean
    // cluster length ~7 at the paper scale): no 64-bit key sort, no
    // segment scratch — a linear doc table with the 4 ACGT counts
    // packed into one u32 (counts <= 32 never carry across bytes).
    // Falls through to the general path on any non-ACGT symbol
    // (IUPAC waterfall, reference src/ClusterBWT_DA.cpp:146-177).
    uint32_t docs[32];
    uint32_t hh[32];
    int nd = 0;
    bool pure = true;
    for (i64 j = 0; j < len && pure; j++) {
      const unsigned sy = cx.sym_lut[ebwt[s + j]] & 15;
      pure = sy < 4;
      const uint32_t d = da[s + j];
      int t = 0;
      while (t < nd && docs[t] != d) t++;
      if (t == nd) {
        docs[nd] = d;
        hh[nd] = 0;
        nd++;
      }
      hh[t] += 1u << (8 * sy);
    }
    if (pure) {
      em.reserve(len * len);
      for (int a = 0; a < nd; a++) {
        if (docs[a] >= static_cast<uint32_t>(num_reads)) continue;
        const uint32_t x = hh[a];
        const i64 base = em.base(docs[a]);
        for (int b = 0; b < nd; b++) {
          if (docs[b] < static_cast<uint32_t>(num_reads)) continue;
          const uint32_t y = hh[b];
          uint32_t t = 0;
          for (int x8 = 0; x8 < 32; x8 += 8) {
            const uint32_t rx = (x >> x8) & 0xFF;
            const uint32_t gy = (y >> x8) & 0xFF;
            t += rx < gy ? rx : gy;
          }
          em.add(base + docs[b], t);
        }
      }
      return;
    }
  }
  uint64_t* keys = sc.keys.data();
  bool cluster_deg = false;
  if (ebwt) {
    for (i64 j = 0; j < len; j++) {
      const uint8_t b = ebwt[s + j];
      cluster_deg |= cx.deg_lut[b] != 0;
      keys[j] = (static_cast<uint64_t>(da[s + j]) << 4) |
                (cx.sym_lut[b] & 15);
    }
  } else {
    for (i64 j = 0; j < len; j++)
      keys[j] = static_cast<uint64_t>(da[s + j]) << 4;
  }
  if (len <= 48) {  // insertion sort beats std::sort on tiny clusters
    for (i64 j = 1; j < len; j++) {
      uint64_t key = keys[j];
      i64 k = j - 1;
      while (k >= 0 && keys[k] > key) {
        keys[k + 1] = keys[k];
        k--;
      }
      keys[k + 1] = key;
    }
  } else {
    std::sort(keys, keys + len);
  }

  // Segment walk: reads have smaller doc ids, so read segments come
  // first; [0, n_rseg) reads, [n_rseg, n_seg) genomes.
  const bool fast8 = ebwt && !cluster_deg;
  i64 n_seg = 0, n_rseg = 0, k = 0;
  while (k < len) {
    const uint32_t doc = static_cast<uint32_t>(keys[k] >> 4);
    uint32_t h[16] = {0};
    uint32_t cnt = 0;
    uint8_t dg = 0;
    while (k < len && static_cast<uint32_t>(keys[k] >> 4) == doc) {
      const unsigned sym = keys[k] & 15;
      h[sym]++;
      cnt++;
      dg |= (sym >= 4 && sym <= 14);
      k++;
    }
    const bool is_read = doc < static_cast<uint32_t>(num_reads);
    sc.seg_doc[n_seg] = doc;
    uint8_t* h8 = &sc.seg_h8[n_seg * 16];
    for (int x = 0; x < 16; x++)
      h8[x] = is_read ? static_cast<uint8_t>(h[x])          // wrap
                      : static_cast<uint8_t>(h[x] > 255 ? 255 : h[x]);
    if (!fast8) {  // the hot path never reads these
      sc.seg_cnt[n_seg] = cnt;
      sc.seg_deg[n_seg] = dg;
      uint32_t* h32 = &sc.seg_h32[n_seg * 16];
      for (int x = 0; x < 16; x++) h32[x] = h[x];
    }
    if (is_read) n_rseg++;
    n_seg++;
  }
  if (fast8) {
    // Hot path: t enters mod 256, which is what the u8 accumulate needs
    for (i64 ri = 0; ri < n_rseg; ri++) {
      const i64 base = em.base(sc.seg_doc[ri]);
      const uint8_t* rh8 = &sc.seg_h8[ri * 16];
      em.reserve(n_seg - n_rseg);
      for (i64 gi = n_rseg; gi < n_seg; gi++) {
        const uint8_t* gh8 = &sc.seg_h8[gi * 16];
        uint32_t t = 0;
        for (int x = 0; x < 16; x++)
          t += rh8[x] < gh8[x] ? rh8[x] : gh8[x];
        em.add(base + sc.seg_doc[gi], t);
      }
    }
    return;
  }
  for (i64 ri = 0; ri < n_rseg; ri++) {
    const uint32_t* rh32 = &sc.seg_h32[ri * 16];
    const i64 base = em.base(sc.seg_doc[ri]);
    em.reserve(n_seg - n_rseg);
    for (i64 gi = n_rseg; gi < n_seg; gi++) {
      const uint32_t gdoc = sc.seg_doc[gi];
      uint32_t t = 0;
      if (ebwt) {
        const uint32_t* gh32 = &sc.seg_h32[gi * 16];
        uint32_t u[16], v[16];
        for (int x = 0; x < 16; x++) {
          uint32_t rh = rh32[x] & 0xFF;  // uchar read counters wrap
          uint32_t gh = gh32[x] > 255 ? 255 : gh32[x];  // saturation
          uint32_t m = rh < gh ? rh : gh;
          t += m;
          u[x] = rh - m;
          v[x] = gh - m;
        }
        if (cluster_deg && (sc.seg_deg[ri] || sc.seg_deg[gi])) {
          for (i64 p = 0; p < cx.n_wf; p++) {
            const int iA = cx.wf_pairs[2 * p], a = cx.wf_pairs[2 * p + 1];
            uint32_t va = v[a], ui = u[iA];
            if (va > 0) {
              t += va < ui ? va : ui;
              if (va > ui) u[iA] = 0; else v[a] = 0;
            }
            uint32_t ua = u[a], vi = v[iA];
            if (ua > 0) {
              t += ua < vi ? ua : vi;
              if (ua > vi) {
                u[a] = ua - vi;
                v[iA] = 0;
              } else {
                u[a] = 0;
                v[iA] = vi - ua;
              }
            }
          }
        }
      } else {
        uint32_t rc = sc.seg_cnt[ri] & 0xFF;
        uint32_t gc = sc.seg_cnt[gi] > 255 ? 255 : sc.seg_cnt[gi];
        t = rc < gc ? rc : gc;
      }
      em.add(base + sc.seg_doc[gi], t);
    }
  }
}

}  // namespace

extern "C" {

// Native cluster scorer — the host half of the density-routed scoring pass.
//
// Scores a cluster list into a dense (num_reads x num_refs) similarity
// matrix; semantics in score_one_cluster above.  The matrix accumulates u8
// with wrap (SimArray_ +=, ClusterBWT_DA.cpp:183), or u32 when wide != 0
// (dataTypeNumSim=1).
//
// wf_pairs: the waterfall visit order as (acgt_rank, degenerate_rank) pairs
// (flattened int32), passed in from the Python constants so the table has
// one source of truth.
//
// OpenMP: clusters are scored in parallel into per-thread partial matrices
// merged at the end (threads is clamped so partials stay within mem_cap
// bytes).  Returns 0 on success.
int64_t lime_score_clusters(const int64_t* starts, const int64_t* lens,
                            int64_t n_clusters, const uint32_t* da,
                            const uint8_t* ebwt, int64_t num_reads,
                            int64_t num_refs, const uint8_t* sym_lut,
                            const uint8_t* deg_lut, const int32_t* wf_pairs,
                            int64_t n_wf, int64_t wide, void* sim_out,
                            int64_t threads, int64_t mem_cap,
                            int64_t row_stride) {
  if (n_clusters < 0 || num_reads <= 0 || num_refs <= 0) return -1;
  if (row_stride <= 0) row_stride = num_refs;
  if (row_stride < num_refs) return -3;
  for (i64 c = 0; c < n_clusters; c++)
    if (lens[c] > 65536) return -2;  // reference sizeMaxBuf guard
  const i64 cells = num_reads * num_refs;
  const i64 cell_bytes = wide ? 4 : 1;
  if (threads < 1) threads = 1;
  if (mem_cap > 0) {
    while (threads > 1 && (threads - 1) * cells * cell_bytes > mem_cap)
      threads--;
  }
  // The emitter-template core (score_one_cluster) keeps the u8 counter
  // semantics in one place, but routing the plane path through it costs
  // ~25% (the emitter's cursor lives in memory, and u64 stores into its
  // pair buffer may alias it, defeating register allocation of the hot
  // counters).  The plane
  // path therefore keeps this hand-scheduled loop; tests pin it
  // byte-identical to the template core via lime_plan_score_coo.
  auto score_range = [&](i64 c_lo, i64 c_hi, void* out, ClusterScratch& sc,
                         i64 stride) {
    uint8_t* out8 = static_cast<uint8_t*>(out);
    uint32_t* out32 = static_cast<uint32_t*>(out);
    uint64_t* keys = sc.keys.data();
    // Cross-cluster write batching: the matrix writes are random (one
    // cache miss each), so (cell << 8 | t) pairs accumulate across
    // clusters and flush in a prefetched loop — the misses overlap
    // instead of serializing behind each tiny cluster's math.
    std::vector<uint64_t> pairbuf(kMaxClu);
    i64 np = 0;
    auto flush = [&]() {
      for (i64 p = 0; p < np; p++) {
        if (p + 8 < np)
          __builtin_prefetch(out8 + (pairbuf[p + 8] >> 8), 1, 1);
        const i64 cell = static_cast<i64>(pairbuf[p] >> 8);
        out8[cell] =
            static_cast<uint8_t>(out8[cell] + (pairbuf[p] & 0xFF));
      }
      np = 0;
    };
    for (i64 c = c_lo; c < c_hi; c++) {
      const i64 s = starts[c], len = lens[c];
      if (len > kMaxClu) continue;  // guarded upstream (sizeMaxBuf)
      if (!wide && ebwt && len <= 32) {
        // Small-cluster fast path (the overwhelming majority: mean
        // cluster length ~7 at the paper scale): no 64-bit key sort, no
        // segment scratch — a linear doc table with the 4 ACGT counts
        // packed into one u32 (counts <= 32 never carry across bytes).
        // Falls through to the general path on any non-ACGT symbol
        // (IUPAC waterfall, reference src/ClusterBWT_DA.cpp:146-177).
        uint32_t docs[32];
        uint32_t hh[32];
        int nd = 0;
        bool pure = true;
        for (i64 j = 0; j < len && pure; j++) {
          const unsigned sy = sym_lut[ebwt[s + j]] & 15;
          pure = sy < 4;
          const uint32_t d = da[s + j];
          int t = 0;
          while (t < nd && docs[t] != d) t++;
          if (t == nd) {
            docs[nd] = d;
            hh[nd] = 0;
            nd++;
          }
          hh[t] += 1u << (8 * sy);
        }
        if (pure) {
          if (np + len * len > static_cast<i64>(pairbuf.size())) flush();
          for (int a = 0; a < nd; a++) {
            if (docs[a] >= static_cast<uint32_t>(num_reads)) continue;
            const uint32_t x = hh[a];
            const i64 base =
                static_cast<i64>(docs[a]) * stride - num_reads;
            for (int b = 0; b < nd; b++) {
              if (docs[b] < static_cast<uint32_t>(num_reads)) continue;
              const uint32_t y = hh[b];
              uint32_t t = 0;
              for (int x8 = 0; x8 < 32; x8 += 8) {
                const uint32_t rx = (x >> x8) & 0xFF;
                const uint32_t gy = (y >> x8) & 0xFF;
                t += rx < gy ? rx : gy;
              }
              pairbuf[np++] =
                  (static_cast<uint64_t>(base + docs[b]) << 8) |
                  (t & 0xFF);
            }
          }
          continue;
        }
      }
      bool cluster_deg = false;
      if (ebwt) {
        for (i64 j = 0; j < len; j++) {
          const uint8_t b = ebwt[s + j];
          cluster_deg |= deg_lut[b] != 0;
          keys[j] = (static_cast<uint64_t>(da[s + j]) << 4) |
                    (sym_lut[b] & 15);
        }
      } else {
        for (i64 j = 0; j < len; j++)
          keys[j] = static_cast<uint64_t>(da[s + j]) << 4;
      }
      if (len <= 48) {  // insertion sort beats std::sort on tiny clusters
        for (i64 j = 1; j < len; j++) {
          uint64_t key = keys[j];
          i64 k = j - 1;
          while (k >= 0 && keys[k] > key) {
            keys[k + 1] = keys[k];
            k--;
          }
          keys[k + 1] = key;
        }
      } else {
        std::sort(keys, keys + len);
      }

      // Segment walk: reads have smaller doc ids, so read segments come
      // first; [0, n_rseg) reads, [n_rseg, n_seg) genomes.
      const bool fast8 = !wide && ebwt && !cluster_deg;
      i64 n_seg = 0, n_rseg = 0, k = 0;
      while (k < len) {
        const uint32_t doc = static_cast<uint32_t>(keys[k] >> 4);
        uint32_t h[16] = {0};
        uint32_t cnt = 0;
        uint8_t dg = 0;
        while (k < len && static_cast<uint32_t>(keys[k] >> 4) == doc) {
          const unsigned sym = keys[k] & 15;
          h[sym]++;
          cnt++;
          dg |= (sym >= 4 && sym <= 14);
          k++;
        }
        const bool is_read = doc < static_cast<uint32_t>(num_reads);
        sc.seg_doc[n_seg] = doc;
        uint8_t* h8 = &sc.seg_h8[n_seg * 16];
        for (int x = 0; x < 16; x++)
          h8[x] = is_read ? static_cast<uint8_t>(h[x])          // wrap
                          : static_cast<uint8_t>(h[x] > 255 ? 255 : h[x]);
        if (!fast8) {  // the hot path never reads these
          sc.seg_cnt[n_seg] = cnt;
          sc.seg_deg[n_seg] = dg;
          uint32_t* h32 = &sc.seg_h32[n_seg * 16];
          for (int x = 0; x < 16; x++) h32[x] = h[x];
        }
        if (is_read) n_rseg++;
        n_seg++;
      }
      if (fast8) {
        // Hot path: (cell, t) pairs into the shared cross-cluster batch;
        // t enters mod 256, which is exactly what the u8 accumulate needs
        for (i64 ri = 0; ri < n_rseg; ri++) {
          const i64 base =
              static_cast<i64>(sc.seg_doc[ri]) * stride - num_reads;
          const uint8_t* rh8 = &sc.seg_h8[ri * 16];
          if (np + (n_seg - n_rseg) > static_cast<i64>(pairbuf.size()))
            flush();
          for (i64 gi = n_rseg; gi < n_seg; gi++) {
            const uint8_t* gh8 = &sc.seg_h8[gi * 16];
            uint32_t t = 0;
            for (int x = 0; x < 16; x++)
              t += rh8[x] < gh8[x] ? rh8[x] : gh8[x];
            pairbuf[np++] = (static_cast<uint64_t>(base + sc.seg_doc[gi])
                             << 8) | (t & 0xFF);
          }
        }
        continue;
      }
      for (i64 ri = 0; ri < n_rseg; ri++) {
        const uint32_t rdoc = sc.seg_doc[ri];
        const uint32_t* rh32 = &sc.seg_h32[ri * 16];
        uint8_t* row8 = out8 + static_cast<i64>(rdoc) * stride - num_reads;
        uint32_t* row32 =
            out32 + static_cast<i64>(rdoc) * stride - num_reads;
        for (i64 gi = n_rseg; gi < n_seg; gi++) {
          const uint32_t gdoc = sc.seg_doc[gi];
          uint32_t t = 0;
          if (ebwt) {
            const uint32_t* gh32 = &sc.seg_h32[gi * 16];
            uint32_t u[16], v[16];
            for (int x = 0; x < 16; x++) {
              // uchar read counters wrap; wide (dataTypeNumSim=1) doesn't
              uint32_t rh = wide ? rh32[x] : (rh32[x] & 0xFF);
              uint32_t gh = gh32[x] > 255 ? 255 : gh32[x];  // saturation
              uint32_t m = rh < gh ? rh : gh;
              t += m;
              u[x] = rh - m;
              v[x] = gh - m;
            }
            if (cluster_deg && (sc.seg_deg[ri] || sc.seg_deg[gi])) {
              for (i64 p = 0; p < n_wf; p++) {
                const int iA = wf_pairs[2 * p], a = wf_pairs[2 * p + 1];
                uint32_t va = v[a], ui = u[iA];
                if (va > 0) {
                  t += va < ui ? va : ui;
                  if (va > ui) u[iA] = 0; else v[a] = 0;
                }
                uint32_t ua = u[a], vi = v[iA];
                if (ua > 0) {
                  t += ua < vi ? ua : vi;
                  if (ua > vi) {
                    u[a] = ua - vi;
                    v[iA] = 0;
                  } else {
                    u[a] = 0;
                    v[iA] = vi - ua;
                  }
                }
              }
            }
          } else {
            uint32_t rc = wide ? sc.seg_cnt[ri] : (sc.seg_cnt[ri] & 0xFF);
            uint32_t gc = sc.seg_cnt[gi] > 255 ? 255 : sc.seg_cnt[gi];
            t = rc < gc ? rc : gc;
          }
          if (wide) {
            row32[gdoc] += t;
          } else {
            row8[gdoc] = static_cast<uint8_t>(row8[gdoc] + t);
          }
        }
      }
    }
    flush();
  };

  if (threads == 1 || n_clusters < 64) {
    ClusterScratch sc;
    score_range(0, n_clusters, sim_out, sc, row_stride);
    return 0;
  }

  std::vector<std::vector<uint8_t>> partials(threads - 1);
#pragma omp parallel num_threads(threads)
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    void* out = sim_out;
    if (tid > 0) {
      partials[tid - 1].assign(cells * cell_bytes, 0);
      out = partials[tid - 1].data();
    }
    ClusterScratch sc;
    const i64 chunk = (n_clusters + threads - 1) / threads;
    const i64 lo = tid * chunk;
    const i64 hi = std::min<i64>(n_clusters, lo + chunk);
    if (lo < hi)
      score_range(lo, hi, out, sc, tid > 0 ? num_refs : row_stride);
  }
  // Merge in parallel over row ranges; partials are overwhelmingly zero
  // (nnz is ~1% of cells at the paper scale), so the u8 path skips
  // 8-byte zero words (a serial dense merge was a large share of the
  // call).
#pragma omp parallel num_threads(threads)
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    const i64 r0 = num_reads * tid / threads;
    const i64 r1 = num_reads * (tid + 1) / threads;
    for (auto& part : partials) {
      if (part.empty()) continue;
      if (wide) {
        uint32_t* dst = static_cast<uint32_t*>(sim_out);
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(part.data());
        for (i64 r = r0; r < r1; r++)
          for (i64 g = 0; g < num_refs; g++)
            dst[r * row_stride + g] += src[r * num_refs + g];
      } else {
        uint8_t* dst = static_cast<uint8_t*>(sim_out);
        const uint8_t* src = part.data();
        for (i64 r = r0; r < r1; r++) {
          const uint8_t* sr = src + r * num_refs;
          uint8_t* dr = dst + r * row_stride;
          i64 g = 0;
          for (; g + 8 <= num_refs; g += 8) {
            uint64_t w;
            std::memcpy(&w, sr + g, 8);
            if (!w) continue;
            for (int x = 0; x < 8; x++)
              dr[g + x] = static_cast<uint8_t>(dr[g + x] + sr[g + x]);
          }
          for (; g < num_refs; g++)
            dr[g] = static_cast<uint8_t>(dr[g] + sr[g]);
        }
      }
    }
  }
  return 0;
}

// Minimal cluster planner for the all-host hybrid mode: one parallel scan
// over (lcp, da) emitting every alpha-cluster that passes the membership
// filter (>= 1 read AND >= 1 genome position, reference
// src/ClusterLCP.cpp:220) as (start, len) — nothing else.  The full packed
// planner (lime_plan_pairs_packed) spends ~3x longer materializing run
// masks and stream buffers that an all-host run never uses; this is the
// planning half of the host job-shop (Python schedules one collection per
// worker thread).
//
// Run detection and the skip-leading/read-past-end straddle protocol match
// lime_plan_score_coo above (reference src/ClusterLCP.cpp:196-264).
// Thread-order concatenation keeps the output deterministic; clusters are
// emitted in ascending start order.
//
//   nr_out    — per-cluster read-position counts (the membership count
//               the scan computes anyway; callers use it to route
//               pair-heavy clusters)
//   meta out — [0] cluster count, [1] max cluster len, [2] total positions
//
// Returns 0, or 1 when cap is insufficient (meta[0] = needed).
int64_t lime_plan_clusters(const uint32_t* lcp, const uint32_t* da,
                           int64_t n, int64_t num_reads, uint32_t alpha,
                           int64_t threads, int64_t cap,
                           int64_t* starts_out, int64_t* lens_out,
                           int64_t* nr_out, int64_t* meta) {
  if (n <= 0 || num_reads <= 0) return -1;
  if (threads < 1) threads = 1;
  if (threads > 16) threads = 16;
  const uint32_t nr_u32 = static_cast<uint32_t>(num_reads);
  std::vector<std::vector<i64>> t_s(threads), t_l(threads), t_r(threads);
#ifdef _OPENMP
#pragma omp parallel num_threads(static_cast<int>(threads))
#endif
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    std::vector<i64>& vs = t_s[tid];
    std::vector<i64>& vl = t_l[tid];
    std::vector<i64>& vr = t_r[tid];
    const i64 lo = std::max<i64>(1, 1 + (n - 1) * tid / threads);
    const i64 hi = 1 + (n - 1) * (tid + 1) / threads;
    i64 i = lo;
    if (tid > 0)  // skip-leading (thread 0 owns a run starting at 1)
      while (i < n && lcp[i] >= alpha) i++;
    auto handle = [&](i64 run_s) {
      i64 j = run_s;
      while (j < n && lcp[j] >= alpha) j++;  // may read past hi
      const i64 ps = run_s - 1, len = j - ps;
      i64 nr = 0;
      for (i64 p = ps; p < j; p++) nr += da[p] < nr_u32;
      if (nr > 0 && nr < len) {
        vs.push_back(ps);
        vl.push_back(len);
        vr.push_back(nr);
      }
      return j;
    };
    while (i < hi) {
      if (lcp[i] >= alpha)
        i = handle(i) + 1;
      else
        i++;
    }
    if (i == hi && hi < n && lcp[hi] >= alpha) handle(hi);
  }
  i64 total = 0, max_len = 0, n_pos = 0;
  for (int t = 0; t < threads; t++) total += t_s[t].size();
  meta[0] = total;
  if (total > cap) return 1;
  i64 w = 0;
  for (int t = 0; t < threads; t++) {
    for (size_t k = 0; k < t_s[t].size(); k++) {
      starts_out[w] = t_s[t][k];
      lens_out[w] = t_l[t][k];
      if (nr_out) nr_out[w] = t_r[t][k];
      if (t_l[t][k] > max_len) max_len = t_l[t][k];
      n_pos += t_l[t][k];
      w++;
    }
  }
  meta[1] = max_len;
  meta[2] = n_pos;
  return 0;
}

// Fused planner+scorer for the all-host hybrid mode: ONE pass over
// (lcp, da, ebwt) that detects alpha-clusters (run detection + the
// skip-leading/read-past-end straddle protocol, reference
// src/ClusterLCP.cpp:196-264), applies the both-sides membership filter
// (ClusterLCP.cpp:220), scores every cluster with the reference-exact core
// (score_one_cluster above) and aggregates the resulting (read, genome)
// pair scores directly into ONE delta-COO chain — the dense
// (num_reads x num_refs) SimArray plane (src/ClusterBWT_DA.cpp:606-611) is
// never materialized.  Replaces the planner pass + scorer pass + two
// full-plane compaction scans of the split pipeline with cache-resident
// aggregation:
//
//   phase A (parallel over position ranges): scan + score; (cell, t8)
//     pairs are appended to per-thread per-tile lists (tile = 2^20 cells);
//   phase B (parallel over tiles): each 1 MB u8 tile accumulates its pair
//     lists with u8 wrap (= the SimArray's uchar += semantics), then is
//     swept once, L2-hot, emitting (cell, val) nonzeros in cell order;
//   phase C: serialize entries into the (drow u8, col u16, val u8) chain
//     with bridge entries for row gaps > max_drow.
//
// Memory: ~8 bytes per emitted (read, genome) pair — the same pair count
// the plane path scatters, materialized instead of random-scattered.
//
//   meta out — [0] entry count (or needed capacity when returning 1),
//              [1] base_row of the chain, [2] clusters scored,
//              [3] positions covered by scored clusters
//
// Returns 0 on success, 1 if cap is insufficient (meta[0] = needed),
// -2 on a cluster longer than 65536 (the reference's sizeMaxBuf guard,
// src/ClusterBWT_DA.cpp:558-562), -1 on bad arguments.  Only the !wide
// (u8 counter) configuration is supported — wide runs keep the dense
// plane path.
int64_t lime_plan_score_coo(
    const uint32_t* lcp, const uint32_t* da, const uint8_t* ebwt,
    int64_t n, int64_t num_reads, int64_t num_refs, uint32_t alpha,
    const uint8_t* sym_lut, const uint8_t* deg_lut,
    const int32_t* wf_pairs, int64_t n_wf,
    int64_t threads, int64_t max_drow, int64_t cap,
    uint8_t* drow_out, uint16_t* col_out, uint8_t* val_out,
    int64_t* meta) {
  if (n <= 0 || num_reads <= 0 || num_refs <= 0) return -1;
  if (num_refs > 65536) return -1;  // u16 genome column
  if (max_drow < 1 || max_drow > 255) return -1;
  if (threads < 1) threads = 1;
  if (threads > 16) threads = 16;
  constexpr int kTileShift = 20;
  constexpr i64 kTile = 1 << kTileShift;
  const i64 cells = num_reads * num_refs;
  const i64 n_tiles = (cells + kTile - 1) >> kTileShift;

  struct ACtx {
    std::vector<std::vector<uint64_t>> tiles;
    i64 n_clusters = 0, n_pos = 0;
    int err = 0;
  };
  std::vector<ACtx> actx(threads);
  for (auto& cx : actx) cx.tiles.resize(n_tiles);

  struct CooEmit {
    std::vector<std::vector<uint64_t>>* tiles;
    i64 num_reads, num_refs;
    inline i64 base(uint32_t rdoc) const {
      return static_cast<i64>(rdoc) * num_refs - num_reads;
    }
    inline void reserve(i64) {}
    inline void add(i64 cell, uint32_t t) {
      if (!(t & 0xFF)) return;  // zero adds are no-ops under u8 wrap
      (*tiles)[cell >> kTileShift].push_back(
          (static_cast<uint64_t>(cell) << 8) | (t & 0xFF));
    }
  };
  const ScoreCtx scx{da, ebwt, num_reads, sym_lut, deg_lut,
                     wf_pairs, n_wf};
  const uint32_t nr_u32 = static_cast<uint32_t>(num_reads);
  const bool dbg = std::getenv("LIME_PSC_DEBUG") != nullptr;
  auto now = []() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
  };
  double tA = now();

#ifdef _OPENMP
#pragma omp parallel num_threads(static_cast<int>(threads))
#endif
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    ACtx& acx = actx[tid];
    CooEmit em{&acx.tiles, num_reads, num_refs};
    ClusterScratch sc;
    const i64 lo = std::max<i64>(1, 1 + (n - 1) * tid / threads);
    const i64 hi = 1 + (n - 1) * (tid + 1) / threads;
    // skip-leading: positions with lcp >= alpha at the range head belong
    // to the previous thread's crossing cluster (ClusterLCP.cpp:196-202).
    // Thread 0 has no predecessor: a run starting at position 1 is a real
    // cluster covering row 0 (the m[0]=0 rule), so it must not skip.
    i64 i = lo;
    if (tid > 0)
      while (i < n && lcp[i] >= alpha) i++;
    auto handle = [&](i64 run_s) {
      i64 j = run_s;
      while (j < n && lcp[j] >= alpha) j++;  // may read past hi
      const i64 ps = run_s - 1, len = j - ps;
      i64 nr = 0;
      for (i64 p = ps; p < j; p++) nr += da[p] < nr_u32;
      if (nr > 0 && nr < len) {  // membership filter
        if (len > 65536) {
          acx.err = -2;  // reference sizeMaxBuf guard
        } else {
          score_one_cluster(scx, ps, len, sc, em);
          acx.n_clusters++;
          acx.n_pos += len;
        }
      }
      return j;
    };
    while (i < hi && !acx.err) {
      if (lcp[i] >= alpha)
        i = handle(i) + 1;
      else
        i++;
    }
    // read-past-end epilogue: a run starting exactly at hi is ours (the
    // next thread's skip-leading rule skips it — ClusterLCP.cpp:243-264)
    if (!acx.err && i == hi && hi < n && lcp[hi] >= alpha) handle(hi);
  }
  for (auto& cx : actx)
    if (cx.err) return cx.err;
  double tB = now();
  if (dbg) {
    i64 n_pairs = 0;
    for (auto& cx : actx)
      for (auto& v : cx.tiles) n_pairs += v.size();
    std::fprintf(stderr, "psc: phaseA %.2fs pairs=%lld\n", tB - tA,
                 static_cast<long long>(n_pairs));
  }

  // Phase B: per-tile u8 accumulate + one L2-hot sweep, tiles split
  // across threads in order (entry concatenation stays cell-sorted).
  std::vector<std::vector<uint64_t>> entries(threads);
#ifdef _OPENMP
#pragma omp parallel num_threads(static_cast<int>(threads))
#endif
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    const i64 b0 = n_tiles * tid / threads;
    const i64 b1 = n_tiles * (tid + 1) / threads;
    if (b0 < b1) {
      std::vector<uint8_t> tile(kTile, 0);
      uint8_t* tp = tile.data();
      std::vector<uint64_t>& out = entries[tid];
      for (i64 b = b0; b < b1; b++) {
        i64 n_pairs = 0;
        for (auto& cx : actx) n_pairs += cx.tiles[b].size();
        if (!n_pairs) continue;
        const uint64_t cell_base = static_cast<uint64_t>(b) << kTileShift;
        for (auto& cx : actx) {
          for (uint64_t pr : cx.tiles[b]) {
            const uint32_t local =
                static_cast<uint32_t>((pr >> 8) - cell_base);
            tp[local] = static_cast<uint8_t>(tp[local] + (pr & 0xFF));
          }
          std::vector<uint64_t>().swap(cx.tiles[b]);
        }
        const i64 span = std::min<i64>(kTile, cells - cell_base);
        i64 g = 0;
        for (; g + 8 <= span; g += 8) {
          uint64_t w;
          std::memcpy(&w, tp + g, 8);
          if (!w) continue;
          for (int x = 0; x < 8; x++) {
            const uint8_t v = tp[g + x];
            if (v) out.push_back(((cell_base + g + x) << 8) | v);
          }
          std::memset(tp + g, 0, 8);  // tile ready for the next bucket
        }
        for (; g < span; g++) {
          if (tp[g]) {
            out.push_back(((cell_base + g) << 8) | tp[g]);
            tp[g] = 0;
          }
        }
      }
    }
  }

  if (dbg) std::fprintf(stderr, "psc: phaseB %.2fs\n", now() - tB);
  double tC = now();

  // Phase C: delta-chain serialization (entries are cell-sorted across
  // the thread vectors by construction).  Pass 1 sizes the chain.
  i64 base_row = 0;
  for (auto& ev : entries) {
    if (!ev.empty()) {
      base_row = static_cast<i64>(ev[0] >> 8) / num_refs;
      break;
    }
  }
  i64 total = 0, n_bridges = 0, last_row = base_row;
  for (auto& ev : entries) {
    for (uint64_t e : ev) {
      const i64 row = static_cast<i64>(e >> 8) / num_refs;
      i64 gap = row - last_row;
      while (gap > max_drow) {
        n_bridges++;
        gap -= max_drow;
      }
      total++;
      last_row = row;
    }
  }
  meta[0] = total + n_bridges;
  meta[1] = base_row;
  i64 ncl = 0, npos = 0;
  for (auto& cx : actx) {
    ncl += cx.n_clusters;
    npos += cx.n_pos;
  }
  meta[2] = ncl;
  meta[3] = npos;
  if (total + n_bridges > cap) return 1;
  i64 w = 0;
  last_row = base_row;
  for (auto& ev : entries) {
    for (uint64_t e : ev) {
      const i64 cell = static_cast<i64>(e >> 8);
      const i64 row = cell / num_refs;
      i64 gap = row - last_row;
      while (gap > max_drow) {
        drow_out[w] = static_cast<uint8_t>(max_drow);
        col_out[w] = 0;
        val_out[w] = 0;
        w++;
        gap -= max_drow;
      }
      drow_out[w] = static_cast<uint8_t>(gap);
      col_out[w] = static_cast<uint16_t>(cell - row * num_refs);
      val_out[w] = static_cast<uint8_t>(e & 0xFF);
      w++;
      last_row = row;
    }
  }
  meta[0] = w;
  if (dbg) std::fprintf(stderr, "psc: phaseC %.2fs\n", now() - tC);
  return 0;
}

// Format the final assignment CSV block (reference src/Classify.cpp:722-731).
//
//   types — 0=U 1=C 2=A 3=H per read; taxid/sim only read for C/H rows
//   base  — id of the first read in the block
//   buf   — caller-allocated, >= 64 bytes per row
//
// Returns the number of bytes written.  "%g" matches the reference's
// default-precision ostream<<float (6 significant digits).
int64_t lime_format_csv(const uint8_t* types, const uint32_t* taxid,
                        const float* sim, int64_t n, int64_t base,
                        char* buf) {
  static const char kType[4] = {'U', 'C', 'A', 'H'};
  char* p = buf;
  for (i64 i = 0; i < n; i++) {
    uint8_t t = types[i];
    if (t == 0 || t == 2) {
      p += std::sprintf(p, "%c,%lld,NA,0\n", kType[t],
                        static_cast<long long>(base + i));
    } else {
      p += std::sprintf(p, "%c,%lld,%u,%g\n", kType[t],
                        static_cast<long long>(base + i), taxid[i],
                        static_cast<double>(sim[i]));
    }
  }
  return p - buf;
}

// Compact one dense similarity plane into the delta-COO uplink format.
//
// The hybrid engine scores host-routed clusters into a dense
// (num_reads x num_refs) matrix (the reference's own SimArray footprint,
// src/ClusterBWT_DA.cpp:606-611) and ships only its nonzeros:
// (drow u8, col u16, val u8|u32) per entry, rows delta-encoded in scan
// order.  Gaps > 255 rows emit bridge entries (drow=255, col=0, val=0 —
// val 0 scatter-adds are no-ops on device).  ~4 bytes per nonzero vs
// ~3.45 bytes per *position* for the packed pair stream; measured at the
// paper scale the nonzero count is ~9x smaller than the position count.
//
//   mat        — u8 (wide=0) or u32 (wide=1), row-major with row_stride
//   threads    — row ranges split across this many OpenMP threads; each
//                thread's delta chain starts at base_row = r0 - 1 and its
//                region is a separate uplink chunk
//   seg_meta   — out, 3 i64 per thread: {entry_off, entry_cnt, base_row}
//
// Returns the total entry count, or the NEGATED needed capacity if cap is
// insufficient (caller grows and retries).
int64_t lime_coo_compact(void* mat, int64_t num_reads,
                         int64_t num_refs, int64_t row_stride,
                         int64_t wide, int64_t threads, int64_t cap,
                         int64_t max_drow, int64_t zero_after,
                         uint8_t* drow_out, uint16_t* col_out,
                         void* val_out, int64_t* seg_meta) {
  if (num_reads <= 0 || num_refs <= 0 || row_stride < num_refs) return -1;
  if (max_drow < 1 || max_drow > 255) return -1;
  if (num_refs > 65536) return -2;
  if (threads < 1) threads = 1;
  if (threads > 16) threads = 16;
  uint8_t* m8 = static_cast<uint8_t*>(mat);
  uint32_t* m32 = static_cast<uint32_t*>(mat);
  uint8_t* v8 = static_cast<uint8_t*>(val_out);
  uint32_t* v32 = static_cast<uint32_t*>(val_out);

  // The planes are overwhelmingly zero (nnz ~0.4% of cells at the paper
  // scale), so the scans skip zero regions 32 bytes (AVX2 testz) or 8
  // bytes at a time — the byte-per-cell loop this replaces was the
  // second-largest host cost after scoring.
  auto row_nnz = [&](i64 r) {
    i64 nz = 0;
    if (wide) {
      const uint32_t* p = m32 + r * row_stride;
      i64 g = 0;
      for (; g + 2 <= num_refs; g += 2) {
        uint64_t w;
        std::memcpy(&w, p + g, 8);
        if (w) nz += (p[g] != 0) + (p[g + 1] != 0);
      }
      for (; g < num_refs; g++) nz += p[g] != 0;
    } else {
      const uint8_t* p = m8 + r * row_stride;
      i64 g = 0;
#ifdef __AVX2__
      for (; g + 32 <= num_refs; g += 32) {
        const __m256i v = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(p + g));
        if (_mm256_testz_si256(v, v)) continue;
        for (int x = 0; x < 32; x++) nz += p[g + x] != 0;
      }
#endif
      for (; g + 8 <= num_refs; g += 8) {
        uint64_t w;
        std::memcpy(&w, p + g, 8);
        if (!w) continue;
        for (int x = 0; x < 8; x++) nz += p[g + x] != 0;
      }
      for (; g < num_refs; g++) nz += p[g] != 0;
    }
    return nz;
  };

  std::vector<i64> cnt(threads, 0);
  // pass 1: per-thread entry counts (nonzeros + bridge entries)
#ifdef _OPENMP
#pragma omp parallel for num_threads(static_cast<int>(threads))
#endif
  for (i64 t = 0; t < threads; t++) {
    const i64 r0 = num_reads * t / threads;
    const i64 r1 = num_reads * (t + 1) / threads;
    i64 c = 0, last = r0 - 1;
    for (i64 r = r0; r < r1; r++) {
      const i64 nz = row_nnz(r);
      if (!nz) continue;
      c += (r - last - 1) / max_drow;  // bridges
      c += nz;
      last = r;
    }
    cnt[t] = c;
  }
  i64 total = 0;
  for (i64 t = 0; t < threads; t++) {
    seg_meta[3 * t + 0] = total;
    seg_meta[3 * t + 1] = cnt[t];
    seg_meta[3 * t + 2] = num_reads * t / threads - 1;
    total += cnt[t];
  }
  if (total > cap) return -total;

  // pass 2: fill at offsets.  With zero_after the emitted cells are
  // re-zeroed while cache-hot, so the caller's scratch plane comes back
  // all-zero for the next collection (no separate ~1 GB fill pass).
#ifdef _OPENMP
#pragma omp parallel for num_threads(static_cast<int>(threads))
#endif
  for (i64 t = 0; t < threads; t++) {
    const i64 r0 = num_reads * t / threads;
    const i64 r1 = num_reads * (t + 1) / threads;
    i64 w = seg_meta[3 * t + 0], last = r0 - 1;
    for (i64 r = r0; r < r1; r++) {
      uint8_t* p8 = m8 + r * row_stride;
      uint32_t* p32 = m32 + r * row_stride;
      i64 gap = r - last;
      bool first = true;
      auto emit = [&](i64 g, uint32_t v) {
        if (first) {
          while (gap > max_drow) {
            drow_out[w] = static_cast<uint8_t>(max_drow);
            col_out[w] = 0;
            if (wide) v32[w] = 0; else v8[w] = 0;
            w++;
            gap -= max_drow;
          }
        }
        drow_out[w] = first ? static_cast<uint8_t>(gap) : 0;
        col_out[w] = static_cast<uint16_t>(g);
        if (wide) v32[w] = v; else v8[w] = static_cast<uint8_t>(v);
        first = false;
        w++;
      };
      if (wide) {
        i64 g = 0;
        for (; g + 2 <= num_refs; g += 2) {
          uint64_t wv;
          std::memcpy(&wv, p32 + g, 8);
          if (!wv) continue;
          if (p32[g]) emit(g, p32[g]);
          if (p32[g + 1]) emit(g + 1, p32[g + 1]);
          if (zero_after) std::memset(p32 + g, 0, 8);
        }
        for (; g < num_refs; g++) {
          if (p32[g]) {
            emit(g, p32[g]);
            if (zero_after) p32[g] = 0;
          }
        }
      } else {
        i64 g = 0;
#ifdef __AVX2__
        for (; g + 32 <= num_refs; g += 32) {
          const __m256i v = _mm256_loadu_si256(
              reinterpret_cast<const __m256i*>(p8 + g));
          if (_mm256_testz_si256(v, v)) continue;
          for (int x = 0; x < 32; x++)
            if (p8[g + x]) emit(g + x, p8[g + x]);
          if (zero_after) std::memset(p8 + g, 0, 32);
        }
#endif
        for (; g + 8 <= num_refs; g += 8) {
          uint64_t wv;
          std::memcpy(&wv, p8 + g, 8);
          if (!wv) continue;
          for (int x = 0; x < 8; x++)
            if (p8[g + x]) emit(g + x, p8[g + x]);
          if (zero_after) std::memset(p8 + g, 0, 8);
        }
        for (; g < num_refs; g++) {
          if (p8[g]) {
            emit(g, p8[g]);
            if (zero_after) p8[g] = 0;
          }
        }
      }
      if (!first) last = r;
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// Beyond-RAM index construction (the reference outsources this regime to
// eGap's external-memory merge, Preprocessing.sh:159-196 --em -m 4096).
// Three pieces: per-block in-RAM SA-IS builds (lime_build_index_block),
// a Holt/McMillan-style interleave-refinement merge of the block eBWTs
// on disk (lime_merge_blocks), and a file-backed Kasai LCP pass
// (lime_kasai_files).  Blocks partition the DOCUMENTS contiguously, so
// cross-block suffix ties resolve by block order (stability) exactly as
// the in-RAM builder's ascending terminator ranks do — the merged
// index is bit-identical to a whole-collection in-RAM build.
// ---------------------------------------------------------------------------

// Per-block build: ebwt/da/sa only (no LCP — the merged LCP is computed
// once, after the merge).  sa_out holds LOCAL text offsets (the block's
// docs concatenated with one terminator slot each, sentinel excluded).
int64_t lime_build_index_block(const uint8_t* concat,
                               const int64_t* seq_lens, int64_t num_seqs,
                               uint8_t* ebwt, uint32_t* da,
                               uint32_t* sa_out) {
  if (num_seqs <= 0) return -1;
  i64 total = 0;
  for (i64 i = 0; i < num_seqs; i++) total += seq_lens[i] + 1;
  const i64 n = total + 1;
  const i64 K = 1 + num_seqs + 256;
  std::vector<i64> s(n);
  std::vector<i64> doc_of(n);
  std::vector<bool> seq_start(n, false);
  {
    i64 w = 0, r = 0;
    for (i64 d = 0; d < num_seqs; d++) {
      seq_start[w] = true;
      for (i64 k = 0; k < seq_lens[d]; k++, w++, r++) {
        s[w] = 1 + num_seqs + concat[r];
        doc_of[w] = d;
      }
      s[w] = 1 + d;
      doc_of[w] = d;
      w++;
    }
    s[w] = 0;
    doc_of[w] = num_seqs - 1;
  }
  std::vector<i64> sa(n);
  sais(s.data(), sa.data(), n, K);
  for (i64 x = 0; x < total; x++) {
    const i64 p = sa[x + 1];
    sa_out[x] = static_cast<uint32_t>(p);
    da[x] = static_cast<uint32_t>(doc_of[p]);
    if (seq_start[p]) {
      ebwt[x] = '$';
    } else {
      const i64 v = s[p - 1];
      ebwt[x] = (v >= 1 + num_seqs)
                    ? static_cast<uint8_t>(v - 1 - num_seqs)
                    : '$';
    }
  }
  return 0;
}

namespace {

// Closes every registered FILE* on scope exit (the merge has many
// early error returns; leaking 250 block handles per failed attempt
// would exhaust fds in a retrying process).
struct FileCloser {
  std::vector<FILE*> files;
  FILE* track(FILE* f) {
    if (f) files.push_back(f);
    return f;
  }
  ~FileCloser() {
    for (FILE* f : files)
      if (f) std::fclose(f);
  }
};

bool write_all(const char* path, const void* data, i64 bytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  const bool ok =
      std::fwrite(data, 1, static_cast<size_t>(bytes), f) ==
      static_cast<size_t>(bytes);
  std::fclose(f);
  return ok;
}

}  // namespace

// Merge n_blocks block indexes into the whole-collection index.
//
//   prefix        — block files live at <prefix>.blk<k>.{ebwt,da,sa}
//   block_rows    — rows (positions) per block
//   block_doc_base/block_text_base — global doc id / text offset of each
//                   block's first document (blocks partition documents
//                   contiguously and in order)
//   out_prefix    — writes <out_prefix>.{ebwt,da,sa} (sa = GLOBAL text
//                   offsets, u32 — input to lime_kasai_files)
//
// The interleave (one block-color byte per merged row) refines on disk:
// pass k sorts rows by their first k suffix characters via one stable
// LF-style bucket distribution per pass.  Rows starting with a
// terminator occupy the fixed first region in block order (their
// mutual order is the global document order by construction), so
// '$'-bucket entries are not rescanned — the classic multi-string
// terminator fix.  Iterates to a fixed point; cross-block ties break
// at the shorter side's terminator, so the pass count is bounded by
// the longest cross-block common prefix + 2 (reads across blocks:
// ~read_len; keep genomes within one block).
//
// Returns the number of passes, or negative on error.
int64_t lime_merge_blocks(const char* prefix, int64_t n_blocks,
                          const int64_t* block_rows,
                          const int64_t* block_doc_base,
                          const int64_t* block_text_base,
                          const int64_t* block_nseqs,
                          const char* out_prefix, int64_t max_passes) {
  if (n_blocks < 1 || n_blocks > 250) return -1;
  if (max_passes < 2) max_passes = 1024;
  i64 total = 0, nseq_total = 0;
  for (i64 b = 0; b < n_blocks; b++) {
    total += block_rows[b];
    nseq_total += block_nseqs[b];
  }
  char path[4096];
  FileCloser fc;

  // block eBWTs stay in RAM only as buffered streams
  std::vector<FILE*> feb(n_blocks, nullptr);
  for (i64 b = 0; b < n_blocks; b++) {
    std::snprintf(path, sizeof(path), "%s.blk%lld.ebwt", prefix,
                  static_cast<long long>(b));
    feb[b] = fc.track(std::fopen(path, "rb"));
    if (!feb[b]) return -2;
  }

  // merged symbol histogram -> bucket bases ('$' = 0x24 sorts below
  // every nucleotide byte, matching the integer-alphabet order of the
  // in-RAM builder: terminators < 1+num_seqs <= any sequence byte)
  i64 counts[256] = {0};
  {
    std::vector<uint8_t> buf(1 << 20);
    for (i64 b = 0; b < n_blocks; b++) {
      size_t got;
      while ((got = std::fread(buf.data(), 1, buf.size(), feb[b])) > 0)
        for (size_t i = 0; i < got; i++) counts[buf[i]]++;
      std::rewind(feb[b]);
    }
  }
  if (counts['$'] != nseq_total) return -3;
  i64 base[256];
  {
    i64 acc = 0;
    for (int c = 0; c < 256; c++) {
      base[c] = acc;
      acc += counts[c];
    }
  }

  std::vector<uint8_t> cur(total);
  std::vector<uint8_t> nxt(total);
  {
    i64 w = 0;
    for (i64 b = 0; b < n_blocks; b++)
      for (i64 i = 0; i < block_rows[b]; i++)
        cur[w++] = static_cast<uint8_t>(b);
  }
  // NB: cur/nxt are the only O(total) RAM of the merge (2 bytes/row);
  // a stricter budget could stream them from il0/il1 — at the tested
  // 4 GB cap and 10^8 rows the in-RAM ping-pong (200 MB) is fine.

  std::vector<std::vector<uint8_t>> ebuf(n_blocks);
  std::vector<size_t> epos(n_blocks, 0), elen(n_blocks, 0);
  const size_t EBUF = 1 << 20;
  for (i64 b = 0; b < n_blocks; b++) ebuf[b].resize(EBUF);

  i64 pass = 0;
  bool converged = false;
  for (; pass < max_passes && !converged; pass++) {
    // fixed terminator region
    i64 w = 0;
    for (i64 b = 0; b < n_blocks; b++)
      for (i64 i = 0; i < block_nseqs[b]; i++)
        nxt[w++] = static_cast<uint8_t>(b);
    i64 cursor[256];
    std::memcpy(cursor, base, sizeof(cursor));
    cursor['$'] = -1;  // never written through the scan
    for (i64 b = 0; b < n_blocks; b++) {
      std::rewind(feb[b]);
      epos[b] = elen[b] = 0;
    }
    bool changed = false;
    for (i64 i = 0; i < total; i++) {
      const uint8_t c = cur[i];
      if (epos[c] == elen[c]) {
        elen[c] = std::fread(ebuf[c].data(), 1, EBUF, feb[c]);
        epos[c] = 0;
        if (elen[c] == 0) return -4;
      }
      const uint8_t sym = ebuf[c][epos[c]++];
      if (sym == '$') continue;  // fixed region
      const i64 slot = cursor[sym]++;
      nxt[slot] = c;
    }
    for (i64 i = 0; i < total; i++) {
      if (nxt[i] != cur[i]) {
        changed = true;
        break;
      }
    }
    cur.swap(nxt);
    converged = !changed;
  }
  if (!converged) return -8;

  // final outputs: stream block da/sa files through the interleave
  {
    std::vector<FILE*> fda(n_blocks), fsa(n_blocks);
    for (i64 b = 0; b < n_blocks; b++) {
      std::snprintf(path, sizeof(path), "%s.blk%lld.da", prefix,
                    static_cast<long long>(b));
      fda[b] = fc.track(std::fopen(path, "rb"));
      std::snprintf(path, sizeof(path), "%s.blk%lld.sa", prefix,
                    static_cast<long long>(b));
      fsa[b] = fc.track(std::fopen(path, "rb"));
      std::rewind(feb[b]);
      epos[b] = elen[b] = 0;
      if (!fda[b] || !fsa[b]) return -5;
    }
    std::snprintf(path, sizeof(path), "%s.ebwt", out_prefix);
    FILE* oeb = fc.track(std::fopen(path, "wb"));
    std::snprintf(path, sizeof(path), "%s.da", out_prefix);
    FILE* oda = fc.track(std::fopen(path, "wb"));
    std::snprintf(path, sizeof(path), "%s.sa", out_prefix);
    FILE* osa = fc.track(std::fopen(path, "wb"));
    if (!oeb || !oda || !osa) return -6;
    std::vector<std::vector<uint32_t>> dbuf(n_blocks), sbuf(n_blocks);
    std::vector<size_t> dpos(n_blocks, 0), dlen(n_blocks, 0);
    for (i64 b = 0; b < n_blocks; b++) {
      dbuf[b].resize(EBUF);
      sbuf[b].resize(EBUF);
    }
    std::vector<uint8_t> oeb_b;
    std::vector<uint32_t> oda_b, osa_b;
    oeb_b.reserve(1 << 20);
    oda_b.reserve(1 << 20);
    osa_b.reserve(1 << 20);
    for (i64 i = 0; i < total; i++) {
      const uint8_t c = cur[i];
      if (epos[c] == dlen[c]) {
        // refill all three block streams in lockstep (equal lengths)
        elen[c] = std::fread(ebuf[c].data(), 1, EBUF, feb[c]);
        dlen[c] = std::fread(dbuf[c].data(), 4, EBUF, fda[c]);
        const size_t sl = std::fread(sbuf[c].data(), 4, EBUF, fsa[c]);
        epos[c] = 0;
        if (dlen[c] == 0 || dlen[c] != elen[c] || sl != dlen[c])
          return -7;
      }
      const size_t k = epos[c]++;
      oeb_b.push_back(ebuf[c][k]);
      oda_b.push_back(dbuf[c][k] +
                      static_cast<uint32_t>(block_doc_base[c]));
      osa_b.push_back(sbuf[c][k] +
                      static_cast<uint32_t>(block_text_base[c]));
      if (oeb_b.size() == (1 << 20)) {
        std::fwrite(oeb_b.data(), 1, oeb_b.size(), oeb);
        std::fwrite(oda_b.data(), 4, oda_b.size(), oda);
        std::fwrite(osa_b.data(), 4, osa_b.size(), osa);
        oeb_b.clear();
        oda_b.clear();
        osa_b.clear();
      }
    }
    std::fwrite(oeb_b.data(), 1, oeb_b.size(), oeb);
    std::fwrite(oda_b.data(), 4, oda_b.size(), oda);
    std::fwrite(osa_b.data(), 4, osa_b.size(), osa);
    std::fflush(oeb);
    std::fflush(oda);
    std::fflush(osa);
  }
  return pass;  // FileCloser closes every handle
}

// File-backed Kasai LCP over the merged index.
//
//   text_path — the collection as bytes with 0 at every terminator slot
//               (total bytes; the global sentinel is implicit)
//   sa_path   — u32 global text offsets (lime_merge_blocks output)
//   lcp_path  — output, u32 per row
//
// Semantics match the in-RAM builder exactly: terminators are pairwise
// distinct there, so the h-extension stops whenever either side hits a
// terminator (0 byte here; two DIFFERENT suffixes can never both sit on
// the same terminator position).
int64_t lime_kasai_files(const char* text_path, const char* sa_path,
                         const char* lcp_path, int64_t total) {
  if (total <= 0) return -1;
  std::vector<uint8_t> text(total);
  std::vector<uint32_t> sa(total);
  {
    FILE* f = std::fopen(text_path, "rb");
    if (!f) return -2;
    if (std::fread(text.data(), 1, total, f) !=
        static_cast<size_t>(total)) {
      std::fclose(f);
      return -2;
    }
    std::fclose(f);
    f = std::fopen(sa_path, "rb");
    if (!f) return -3;
    if (std::fread(sa.data(), 4, total, f) !=
        static_cast<size_t>(total)) {
      std::fclose(f);
      return -3;
    }
    std::fclose(f);
  }
  std::vector<uint32_t> rank(total);
  for (i64 r = 0; r < total; r++) rank[sa[r]] = static_cast<uint32_t>(r);
  std::vector<uint32_t> lcp(total, 0);
  i64 h = 0;
  for (i64 i = 0; i < total; i++) {
    const i64 r = rank[i];
    if (r > 0) {
      const i64 j = sa[r - 1];
      while (i + h < total && j + h < total && text[i + h] &&
             text[i + h] == text[j + h])
        h++;
      lcp[r] = static_cast<uint32_t>(h);
      if (h > 0) h--;
    } else {
      h = 0;
    }
  }
  return write_all(lcp_path, lcp.data(), total * 4) ? 0 : -4;
}

}  // extern "C"
