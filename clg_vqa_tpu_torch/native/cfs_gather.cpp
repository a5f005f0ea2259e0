// CFS batch assembly on the host (the port's own copy of the JAX package's
// native gather, clg_vqa_tpu/native/cfs_gather.cpp, made bit-identical to
// the Python path on every option).
//
// Replaces the reference's per-sample Python preprocessing (tensorpack
// MapData worker running BertPreprocessBatch: b64 decode + box normalize +
// pad, gqa_dataset_semantic_code_mix.py:564-657) with a multithreaded,
// zero-copy gather over the mmap'd CFS file. Called through ctypes
// (clg_vqa_tpu_torch/native/cfs_native.py), which releases the GIL for the
// whole batch.
//
// Every value equals data/features.py's process_regions + pad_regions bit
// for bit, the L2 normalization and the global feature included: the squared
// norm is NumPy's float32 pairwise sum (numpy's pairwise_sum: 8 partial sums
// in blocks of up to 128, halves above that), the row is divided by
// max(norm, 1e-12) rather than multiplied by a reciprocal, and the global
// feature sums the rows in order in float32 and divides by the box count.
// Built with -ffp-contract=off, so no product is fused into a sum.
//
// File layout: see clg_vqa_tpu_torch/data/cfs.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Handle {
  const uint8_t* base = nullptr;
  size_t size = 0;
  int fd = -1;
};

struct RecordView {
  uint32_t n_boxes;
  uint32_t feat_dim;
  float img_w, img_h;
  // Raw BYTE pointers: v2 records are not 4-byte aligned (the 1-byte
  // flags field shifts successors), so typed float loads would be UB —
  // every read goes through memcpy (ldf) or a row memcpy.
  const uint8_t* features;  // [n_boxes, feat_dim] f32 bytes
  const uint8_t* boxes;     // [n_boxes, 4] f32 bytes
};

inline float ldf(const uint8_t* p) {
  float v;
  std::memcpy(&v, p, 4);
  return v;
}

inline RecordView parse_record(const uint8_t* base, int64_t offset) {
  const uint8_t* p = base + offset;
  uint32_t id_len;
  std::memcpy(&id_len, p, 4);
  p += 4 + id_len;
  RecordView r;
  std::memcpy(&r.n_boxes, p, 4);
  std::memcpy(&r.feat_dim, p + 4, 4);
  std::memcpy(&r.img_w, p + 8, 4);
  std::memcpy(&r.img_h, p + 12, 4);
  r.features = p + 16;
  r.boxes = r.features + size_t(r.n_boxes) * r.feat_dim * 4;
  return r;
}

// NumPy's float32 pairwise sum (numpy/_core/src/umath/loops_utils.h.src,
// pairwise_sum): what np.add.reduce gives over a contiguous float32 row.
float pairwise_sum(const float* a, int n) {
  if (n < 8) {
    float res = 0.0f;
    for (int i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    float r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// x /= max(||x||, floor) with np.linalg.norm's float32 arithmetic: the
// squares rounded to float32, their pairwise sum, a float32 sqrt.
void l2_normalize(float* x, int n, float floor, float* sq) {
  for (int j = 0; j < n; ++j) sq[j] = x[j] * x[j];
  const float norm = std::max(std::sqrt(pairwise_sum(sq, n)), floor);
  for (int j = 0; j < n; ++j) x[j] /= norm;
}

// One sample: normalize + optional L2 norm + optional global feature + pad.
// Mirrors process_regions/pad_regions (data/features.py), which
// in turn mirror _image_features_reader.py:141-205.
void assemble_one(const RecordView& r, int max_regions_padded, int num_locs,
                  bool norm_embeddings, int add_global, float* feats_out,
                  float* locs_out, int32_t* mask_out) {
  const int fd = int(r.feat_dim);
  const int n = int(r.n_boxes);

  // The reference materializes [global?; boxes...] / [boxes...; global?] and
  // THEN truncates to the padded region count — so with "last" the global row
  // is dropped whenever the detector boxes already fill the window
  // (gqa_dataset_semantic_code_mix.py:213-222 truncation after the reader's
  // concat). Reproduce that exactly.
  const int cap = (add_global == 1) ? max_regions_padded - 1
                                    : max_regions_padded;
  const int keep = std::min(n, cap);
  const bool has_global =
      add_global == 1 || (add_global == 2 && keep < max_regions_padded);
  const int total = keep + (has_global ? 1 : 0);

  // zero padding area
  std::memset(feats_out, 0, size_t(max_regions_padded) * fd * sizeof(float));
  std::memset(locs_out, 0, size_t(max_regions_padded) * num_locs * sizeof(float));
  std::memset(mask_out, 0, size_t(max_regions_padded) * sizeof(int32_t));

  const int det_off = (add_global == 1) ? 1 : 0;  // 1 = "first"

  // locs — bit-identical to process_regions (features.py): area from the
  // RAW coords first (like locs[:, -1] computed before the in-place /=),
  // then coordinate DIVISIONS (not reciprocal multiplies — x/w and
  // x*(1/w) differ in the last ulp)
  const float wh = float(double(r.img_w) * double(r.img_h));
  for (int i = 0; i < keep; ++i) {
    const uint8_t* bp = r.boxes + size_t(i) * 16;
    float b0 = ldf(bp), b1 = ldf(bp + 4), b2 = ldf(bp + 8),
          b3 = ldf(bp + 12);
    float* l = locs_out + size_t(det_off + i) * num_locs;
    if (num_locs >= 5) l[num_locs - 1] = ((b3 - b1) * (b2 - b0)) / wh;
    float x1 = b0 / r.img_w, y1 = b1 / r.img_h;
    float x2 = b2 / r.img_w, y2 = b3 / r.img_h;
    l[0] = x1; l[1] = y1; l[2] = x2; l[3] = y2;
    if (num_locs > 5) { l[4] = x2 - x1; l[5] = y2 - y1; }
  }
  // features (+ optional L2 norm): copy the row first (alignment-safe),
  // then normalize in place on the aligned output
  std::vector<float> sq(std::max(fd, num_locs));
  for (int i = 0; i < keep; ++i) {
    float* dst = feats_out + size_t(det_off + i) * fd;
    std::memcpy(dst, r.features + size_t(i) * fd * 4,
                size_t(fd) * sizeof(float));
    if (norm_embeddings) l2_normalize(dst, fd, 1e-12f, sq.data());
  }
  if (norm_embeddings) {
    for (int i = 0; i < keep; ++i)
      l2_normalize(locs_out + size_t(det_off + i) * num_locs, num_locs, 0.0f,
                   sq.data());
  }
  // global feature = mean over ALL stored boxes (the reference computes it
  // before any truncation, _image_features_reader.py:179-181 — so even when
  // keep < n the mean covers every stored box, post-normalization): rows
  // summed in order in float32, as NumPy's sum over axis 0
  if (has_global) {
    int gslot = (add_global == 1) ? 0 : keep;
    float* gf = feats_out + size_t(gslot) * fd;
    std::vector<float> acc(fd, 0.0f), row(fd);
    for (int i = 0; i < n; ++i) {
      std::memcpy(row.data(), r.features + size_t(i) * fd * 4,
                  size_t(fd) * sizeof(float));     // alignment-safe load
      if (norm_embeddings) l2_normalize(row.data(), fd, 1e-12f, sq.data());
      if (i == 0) {
        acc = row;
      } else {
        for (int j = 0; j < fd; ++j) acc[j] += row[j];
      }
    }
    const float count = float(std::max(n, 1));
    for (int j = 0; j < fd; ++j) gf[j] = acc[j] / count;
    float* gl = locs_out + size_t(gslot) * num_locs;
    gl[0] = 0; gl[1] = 0; gl[2] = 1; gl[3] = 1;
    for (int j = 4; j < num_locs; ++j) gl[j] = 1;
  }
  for (int i = 0; i < total; ++i) mask_out[i] = 1;
}

}  // namespace

extern "C" {

void* cfsg_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* p = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) { ::close(fd); return nullptr; }
  madvise(p, size_t(st.st_size), MADV_WILLNEED);
  auto* h = new Handle;
  h->base = static_cast<const uint8_t*>(p);
  h->size = size_t(st.st_size);
  h->fd = fd;
  return h;
}

void cfsg_close(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  if (!h) return;
  munmap(const_cast<uint8_t*>(h->base), h->size);
  ::close(h->fd);
  delete h;
}

// feats_out [batch, max_regions_padded, feat_dim]
// locs_out  [batch, max_regions_padded, num_locs]
// mask_out  [batch, max_regions_padded]
// add_global: 0 = none, 1 = first, 2 = last
int cfsg_gather(void* hv, const int64_t* offsets, const int64_t* indices,
                int batch, int max_regions_padded, int num_locs, int feat_dim,
                int norm_embeddings, int add_global, int num_threads,
                float* feats_out, float* locs_out, int32_t* mask_out) {
  auto* h = static_cast<Handle*>(hv);
  if (!h) return -1;
  std::vector<std::thread> threads;
  std::atomic<int> bad{0};
  int nt = std::max(1, std::min(num_threads, batch));
  auto work = [&](int t) {
    for (int i = t; i < batch; i += nt) {
      RecordView r = parse_record(h->base, offsets[indices[i]]);
      if (int(r.feat_dim) != feat_dim) {
        // mismatched record: report loudly instead of leaving a silent
        // all-zero row (the Python path raises a shape error here too)
        bad.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      assemble_one(r, max_regions_padded, num_locs, norm_embeddings != 0,
                   add_global,
                   feats_out + size_t(i) * max_regions_padded * feat_dim,
                   locs_out + size_t(i) * max_regions_padded * num_locs,
                   mask_out + size_t(i) * max_regions_padded);
    }
  };
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  return bad.load() ? -2 : 0;
}

}  // extern "C"
