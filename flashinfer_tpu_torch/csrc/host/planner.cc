// A copy of the JAX package's csrc/planner.cc, built for the port by
// flashinfer_tpu_torch/jit (the system C++ compiler) and bound by
// flashinfer_tpu_torch/scheduler/native.py. Its code must stay that file's.
//
// planner.cc — native host-side attention work planner.
//
// Reference parity: include/flashinfer/attention/scheduler.cuh —
// PrefillSplitQOKVIndptr (:496), PrefillPlan (:694), DecodePlan (:426).
// The reference balances (request × qo_tile × kv_chunk) work over GPU SMs
// and serializes it into CUDA-graph-stable padded index arrays; this
// planner produces the same padded, static-shape work descriptors for the
// Pallas run stage (XLA's analogue of graph stability is shape stability).
//
// The algorithm intentionally matches flashinfer_tpu/scheduler/plan.py
// bit-for-bit (the NumPy implementation is the spec; tests compare them).

#include "fi_native.h"

#include <algorithm>
#include <cstring>
#include <new>
#include <vector>

namespace {

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline int64_t round_up(int64_t x, int64_t m) { return cdiv(x, m) * m; }

inline int64_t next_pow2(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

constexpr int64_t kMinWorkCapacity = 8;

}  // namespace

struct FiPlan {
  FiPlanSizes sizes;
  // per-item arrays, length sizes.num_work_items
  std::vector<int32_t> request_indices;
  std::vector<int32_t> qo_tile_indices;
  std::vector<int32_t> kv_tile_indices;
  std::vector<int32_t> qo_start_row;
  std::vector<int32_t> qo_tile_len;
  std::vector<int32_t> kv_start;
  std::vector<int32_t> kv_end;
  std::vector<int32_t> kv_page_start;
  std::vector<int32_t> num_kv_splits;
  std::vector<int32_t> q_pos_base;
  std::vector<int32_t> merge_out_row;  // capacity * tile_q
};

extern "C" {

int64_t fi_native_abi_version(void) { return FI_NATIVE_ABI_VERSION; }

FiPlan* fi_plan_create(
    const int64_t* qo_indptr, int64_t batch,
    const int64_t* kv_lens,
    const int64_t* qo_token_lens,
    int64_t gqa_group,
    const int64_t* kv_indptr,
    int64_t page_size,
    int64_t tile_q,
    int64_t kv_chunk_size,
    int64_t max_kv_chunk_size,
    int64_t min_kv_chunk_size,
    int64_t target_num_items,
    int64_t work_capacity,
    int32_t causal) {
  if (batch < 0 || tile_q <= 0 || gqa_group <= 0 || page_size <= 0)
    return nullptr;

  std::vector<int64_t> qo_lens(batch), tok_lens(batch), num_qo_tiles(batch);
  for (int64_t i = 0; i < batch; ++i) {
    qo_lens[i] = qo_indptr[i + 1] - qo_indptr[i];
    if (qo_lens[i] < 0) return nullptr;
    tok_lens[i] =
        qo_token_lens ? qo_token_lens[i] : qo_lens[i] / gqa_group;
    int64_t t = cdiv(qo_lens[i], tile_q);
    num_qo_tiles[i] = std::max(t, qo_lens[i] > 0 ? int64_t{1} : int64_t{0});
  }

  // Derive kv_chunk_size: smallest power-of-2 in [min,max] such that total
  // items >= target (plan.py's loop; the TPU analogue of scheduler.cuh:573's
  // binary search that fills the 2×SM grid — here the target keeps the DMA
  // pipeline busy and bounds VMEM).
  if (kv_chunk_size <= 0) {
    if (target_num_items <= 0) {
      int64_t total_tiles = 0;
      for (int64_t i = 0; i < batch; ++i) total_tiles += num_qo_tiles[i];
      target_num_items = std::max<int64_t>(8, total_tiles);
    }
    kv_chunk_size = max_kv_chunk_size;
    auto total_items_at = [&](int64_t chunk) {
      int64_t total = 0;
      for (int64_t i = 0; i < batch; ++i)
        total +=
            num_qo_tiles[i] * cdiv(std::max<int64_t>(kv_lens[i], 1), chunk);
      return total;
    };
    while (kv_chunk_size / 2 >= min_kv_chunk_size &&
           total_items_at(kv_chunk_size) < target_num_items)
      kv_chunk_size /= 2;
    // never derive a chunk wider than the longest request (plan.py: dead
    // kernel substeps beyond the item's real kv span cost ~2us each).
    // Empty batches keep the uncapped derivation (plan.py batch==0 path).
    if (batch > 0) {
      int64_t max_len = 1;
      for (int64_t i = 0; i < batch; ++i)
        max_len = std::max(max_len, kv_lens[i]);
      int64_t cap = 1;
      while (cap < max_len) cap <<= 1;
      kv_chunk_size = std::min(kv_chunk_size, cap);
    }
  }
  kv_chunk_size = round_up(std::max(kv_chunk_size, page_size), page_size);

  // Expand (request, qo_tile, kv_chunk) triples with causal pruning.
  struct Item {
    int64_t req, qo_tile, kv_tile, kv_s, kv_e, q_pos_base;
  };
  std::vector<Item> items;
  for (int64_t r = 0; r < batch; ++r) {
    int64_t nkc = cdiv(std::max<int64_t>(kv_lens[r], 1), kv_chunk_size);
    int64_t qpb = kv_lens[r] - tok_lens[r];
    for (int64_t t = 0; t < num_qo_tiles[r]; ++t) {
      int64_t kv_upper = kv_lens[r];
      if (causal) {
        int64_t last_token = (t * tile_q + tile_q - 1) / gqa_group;
        kv_upper = std::min(kv_upper, qpb + last_token + 1);
      }
      for (int64_t c = 0; c < nkc; ++c) {
        int64_t s = c * kv_chunk_size;
        int64_t e = std::min(s + kv_chunk_size, kv_lens[r]);
        // clip to the tile's causal bound: kv above the LAST row's
        // diagonal is invisible to every row in the tile (matches the
        // NumPy spec's kv_end clip)
        if (causal) e = std::min(e, kv_upper);
        if (e <= s) continue;
        items.push_back({r, t, c, s, e, qpb});
      }
    }
  }
  const int64_t num_valid = static_cast<int64_t>(items.size());

  int64_t capacity = work_capacity > 0
                         ? work_capacity
                         : std::max(kMinWorkCapacity, next_pow2(num_valid));
  if (num_valid > capacity) return nullptr;

  FiPlan* plan = new (std::nothrow) FiPlan();
  if (!plan) return nullptr;
  plan->sizes.tile_q = tile_q;
  plan->sizes.kv_chunk_size = kv_chunk_size;
  plan->sizes.num_work_items = capacity;
  plan->sizes.total_rows = batch > 0 ? qo_indptr[batch] : 0;
  plan->sizes.num_valid_items = num_valid;
  plan->sizes.batch_size = batch;
  plan->sizes.page_size = page_size;
  plan->sizes.gqa_group = gqa_group;

  auto fill = [capacity](std::vector<int32_t>& v, int32_t pad) {
    v.assign(static_cast<size_t>(capacity), pad);
  };
  fill(plan->request_indices, -1);
  fill(plan->qo_tile_indices, 0);
  fill(plan->kv_tile_indices, 0);
  fill(plan->qo_start_row, 0);
  fill(plan->qo_tile_len, 0);
  fill(plan->kv_start, 0);
  fill(plan->kv_end, 0);
  fill(plan->kv_page_start, 0);
  fill(plan->num_kv_splits, 1);
  fill(plan->q_pos_base, 0);
  plan->merge_out_row.assign(static_cast<size_t>(capacity * tile_q), -1);

  // splits per (request, qo_tile) group: items are contiguous (row-major).
  for (int64_t i = 0; i < num_valid;) {
    int64_t j = i;
    while (j < num_valid && items[j].req == items[i].req &&
           items[j].qo_tile == items[i].qo_tile)
      ++j;
    for (int64_t k = i; k < j; ++k)
      plan->num_kv_splits[k] = static_cast<int32_t>(j - i);
    i = j;
  }

  for (int64_t i = 0; i < num_valid; ++i) {
    const Item& it = items[i];
    plan->request_indices[i] = static_cast<int32_t>(it.req);
    plan->qo_tile_indices[i] = static_cast<int32_t>(it.qo_tile);
    plan->kv_tile_indices[i] = static_cast<int32_t>(it.kv_tile);
    int64_t start_row = qo_indptr[it.req] + it.qo_tile * tile_q;
    plan->qo_start_row[i] = static_cast<int32_t>(start_row);
    int64_t tl = std::min(tile_q, qo_lens[it.req] - it.qo_tile * tile_q);
    plan->qo_tile_len[i] = static_cast<int32_t>(tl);
    plan->kv_start[i] = static_cast<int32_t>(it.kv_s);
    plan->kv_end[i] = static_cast<int32_t>(it.kv_e);
    int64_t pstart = it.kv_s / page_size;
    if (kv_indptr) pstart += kv_indptr[it.req];
    plan->kv_page_start[i] = static_cast<int32_t>(pstart);
    plan->q_pos_base[i] = static_cast<int32_t>(it.q_pos_base);
    // merge map: partial row (i * tile_q + j) -> output row
    for (int64_t j = 0; j < tl; ++j)
      plan->merge_out_row[i * tile_q + j] =
          static_cast<int32_t>(start_row + j);
  }
  return plan;
}

void fi_plan_sizes(const FiPlan* plan, FiPlanSizes* out) {
  *out = plan->sizes;
}

void fi_plan_export(
    const FiPlan* plan,
    int32_t* request_indices, int32_t* qo_tile_indices,
    int32_t* kv_tile_indices, int32_t* qo_start_row, int32_t* qo_tile_len,
    int32_t* kv_start, int32_t* kv_end, int32_t* kv_page_start,
    int32_t* num_kv_splits, int32_t* q_pos_base, int32_t* merge_out_row) {
  const size_t n = static_cast<size_t>(plan->sizes.num_work_items);
  auto cp = [n](int32_t* dst, const std::vector<int32_t>& src) {
    std::memcpy(dst, src.data(), n * sizeof(int32_t));
  };
  cp(request_indices, plan->request_indices);
  cp(qo_tile_indices, plan->qo_tile_indices);
  cp(kv_tile_indices, plan->kv_tile_indices);
  cp(qo_start_row, plan->qo_start_row);
  cp(qo_tile_len, plan->qo_tile_len);
  cp(kv_start, plan->kv_start);
  cp(kv_end, plan->kv_end);
  cp(kv_page_start, plan->kv_page_start);
  cp(num_kv_splits, plan->num_kv_splits);
  cp(q_pos_base, plan->q_pos_base);
  std::memcpy(merge_out_row, plan->merge_out_row.data(),
              plan->merge_out_row.size() * sizeof(int32_t));
}

void fi_plan_destroy(FiPlan* plan) { delete plan; }

}  // extern "C"
