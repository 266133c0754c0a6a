// A copy of the JAX package's csrc/page_pool.cc, built for the port by
// flashinfer_tpu_torch/jit (the system C++ compiler) and bound by
// flashinfer_tpu_torch/scheduler/native.py. Its code must stay that file's.
//
// page_pool.cc — O(1) paged-KV block allocator for the serving runtime.
//
// The reference delegates KV block allocation to its callers (vLLM/SGLang
// block managers) and consumes the resulting page tables via paged_kv_t
// (include/flashinfer/page.cuh:38).  Our framework ships the serving loop
// too, so the allocator is part of the native runtime: a free-list of pages
// plus per-sequence page vectors, with batch export straight into the
// (kv_indptr, kv_indices, kv_last_page_len) triple the attention planner
// consumes.

#include "fi_native.h"

#include <algorithm>
#include <new>
#include <vector>

struct FiPagePool {
  int64_t page_size;
  std::vector<int32_t> free_list;  // stack of free page ids
  struct Seq {
    bool live = false;
    int64_t len = 0;  // tokens
    std::vector<int32_t> pages;
  };
  std::vector<Seq> seqs;
  std::vector<int64_t> free_slots;
};

extern "C" {

FiPagePool* fi_page_pool_create(int64_t num_pages, int64_t page_size) {
  if (num_pages <= 0 || page_size <= 0) return nullptr;
  FiPagePool* p = new (std::nothrow) FiPagePool();
  if (!p) return nullptr;
  p->page_size = page_size;
  p->free_list.resize(static_cast<size_t>(num_pages));
  // LIFO with low ids on top: fresh sequences get low, mostly-contiguous
  // page ids, which keeps gather DMAs closer together.
  for (int64_t i = 0; i < num_pages; ++i)
    p->free_list[static_cast<size_t>(i)] =
        static_cast<int32_t>(num_pages - 1 - i);
  return p;
}

void fi_page_pool_destroy(FiPagePool* pool) { delete pool; }

int64_t fi_page_pool_free_pages(const FiPagePool* pool) {
  return static_cast<int64_t>(pool->free_list.size());
}

int64_t fi_seq_create(FiPagePool* pool) {
  int64_t slot;
  if (!pool->free_slots.empty()) {
    slot = pool->free_slots.back();
    pool->free_slots.pop_back();
  } else {
    slot = static_cast<int64_t>(pool->seqs.size());
    pool->seqs.emplace_back();
  }
  auto& s = pool->seqs[static_cast<size_t>(slot)];
  s.live = true;
  s.len = 0;
  s.pages.clear();
  return slot;
}

int32_t fi_seq_extend(FiPagePool* pool, int64_t seq, int64_t new_len) {
  if (seq < 0 || seq >= static_cast<int64_t>(pool->seqs.size())) return -1;
  auto& s = pool->seqs[static_cast<size_t>(seq)];
  if (!s.live || new_len < s.len) return -1;
  const int64_t ps = pool->page_size;
  int64_t need = (new_len + ps - 1) / ps;
  int64_t have = static_cast<int64_t>(s.pages.size());
  if (need - have > static_cast<int64_t>(pool->free_list.size())) return -1;
  for (int64_t i = have; i < need; ++i) {
    s.pages.push_back(pool->free_list.back());
    pool->free_list.pop_back();
  }
  s.len = new_len;
  return 0;
}

int32_t fi_seq_truncate(FiPagePool* pool, int64_t seq, int64_t new_len) {
  // Shrink a sequence (speculative-decode rollback: rejected draft tokens'
  // KV rows become dead and their now-unused tail pages return to the free
  // list; the rows themselves are overwritten when the positions are
  // reached again).
  if (seq < 0 || seq >= static_cast<int64_t>(pool->seqs.size())) return -1;
  auto& s = pool->seqs[static_cast<size_t>(seq)];
  if (!s.live || new_len < 0 || new_len > s.len) return -1;
  const int64_t ps = pool->page_size;
  int64_t need = (new_len + ps - 1) / ps;
  while (static_cast<int64_t>(s.pages.size()) > need) {
    pool->free_list.push_back(s.pages.back());
    s.pages.pop_back();
  }
  s.len = new_len;
  return 0;
}

void fi_seq_release(FiPagePool* pool, int64_t seq) {
  if (seq < 0 || seq >= static_cast<int64_t>(pool->seqs.size())) return;
  auto& s = pool->seqs[static_cast<size_t>(seq)];
  if (!s.live) return;
  pool->free_list.insert(pool->free_list.end(), s.pages.rbegin(),
                         s.pages.rend());
  s.live = false;
  s.len = 0;
  s.pages.clear();
  pool->free_slots.push_back(seq);
}

int64_t fi_seq_len(const FiPagePool* pool, int64_t seq) {
  if (seq < 0 || seq >= static_cast<int64_t>(pool->seqs.size())) return -1;
  return pool->seqs[static_cast<size_t>(seq)].len;
}

int64_t fi_seq_num_pages(const FiPagePool* pool, int64_t seq) {
  if (seq < 0 || seq >= static_cast<int64_t>(pool->seqs.size())) return -1;
  return static_cast<int64_t>(
      pool->seqs[static_cast<size_t>(seq)].pages.size());
}

void fi_seq_pages(const FiPagePool* pool, int64_t seq, int32_t* out) {
  const auto& pages = pool->seqs[static_cast<size_t>(seq)].pages;
  std::copy(pages.begin(), pages.end(), out);
}

void fi_batch_export(
    const FiPagePool* pool,
    const int64_t* seqs, int64_t nseq,
    int32_t* kv_indptr, int32_t* kv_indices, int32_t* kv_last_page_len) {
  int32_t off = 0;
  kv_indptr[0] = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    const auto& s = pool->seqs[static_cast<size_t>(seqs[i])];
    std::copy(s.pages.begin(), s.pages.end(), kv_indices + off);
    off += static_cast<int32_t>(s.pages.size());
    kv_indptr[i + 1] = off;
    int64_t rem = s.len % pool->page_size;
    kv_last_page_len[i] =
        static_cast<int32_t>(s.len == 0 ? 0 : (rem == 0 ? pool->page_size : rem));
  }
}

}  // extern "C"
