/* A copy of the JAX package's csrc/fi_native.h (see planner.cc). */
/* fi_native.h — C ABI for flashinfer_tpu's native host runtime.
 *
 * Reference parity: the plan stage of include/flashinfer/attention/
 * scheduler.cuh (PrefillSplitQOKVIndptr :496, PrefillPlan :694, DecodePlan
 * :426) is host-side C++ in the reference for control-path speed; this is
 * the TPU framework's native equivalent.  The page pool mirrors the role of
 * the engine-side KV block allocator the reference delegates to callers
 * (paged_kv_t consumes indices produced by one; page.cuh:38).
 *
 * Everything here is plain C so Python binds via ctypes (no pybind11 in the
 * image).  All arrays are caller-allocated; two-phase protocol:
 *   h = fi_plan_create(...);            // expand + balance work items
 *   fi_plan_sizes(h, &sizes);           // padded capacities to allocate
 *   fi_plan_export(h, ptrs...);         // fill caller buffers
 *   fi_plan_destroy(h);
 */
#ifndef FI_NATIVE_H_
#define FI_NATIVE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define FI_NATIVE_ABI_VERSION 4

typedef struct FiPlan FiPlan;

typedef struct FiPlanSizes {
  int64_t tile_q;
  int64_t kv_chunk_size;
  int64_t num_work_items; /* padded capacity T */
  int64_t total_rows;     /* padded packed qo rows */
  int64_t num_valid_items;
  int64_t batch_size;
  int64_t page_size;
  int64_t gqa_group;
} FiPlanSizes;

int64_t fi_native_abi_version(void);

/* Expand a variable-length attention batch into padded (request, qo_tile,
 * kv_chunk) work items.  Mirrors flashinfer_tpu.scheduler.plan.plan_attention
 * exactly (property-tested against it).
 *
 * qo_indptr:     [batch+1] packed query-row offsets (tile_q-aligned rows).
 * kv_lens:       [batch] valid kv tokens per request.
 * qo_token_lens: [batch] true token counts, or NULL (=> row_count / group).
 * kv_indptr:     [batch+1] page-table offsets, or NULL (ragged identity).
 * kv_chunk_size: fixed chunk, or <=0 to derive (power-of-2 search in
 *                [min_kv_chunk, max_kv_chunk] targeting target_num_items).
 * work_capacity: padded item capacity, or <=0 for power-of-2 bucketing.
 * Returns NULL on invalid arguments or capacity overflow. */
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
    int32_t causal);

void fi_plan_sizes(const FiPlan* plan, FiPlanSizes* out);

/* All output arrays must have length sizes.num_work_items except
 * merge_out_row, which must have length num_work_items * tile_q. */
void fi_plan_export(
    const FiPlan* plan,
    int32_t* request_indices,
    int32_t* qo_tile_indices,
    int32_t* kv_tile_indices,
    int32_t* qo_start_row,
    int32_t* qo_tile_len,
    int32_t* kv_start,
    int32_t* kv_end,
    int32_t* kv_page_start,
    int32_t* num_kv_splits,
    int32_t* q_pos_base,
    int32_t* merge_out_row);

void fi_plan_destroy(FiPlan* plan);

/* ------------------------------------------------------------------ */
/* Page pool: O(1) page allocator for paged KV caches (serving runtime) */

typedef struct FiPagePool FiPagePool;

FiPagePool* fi_page_pool_create(int64_t num_pages, int64_t page_size);
void fi_page_pool_destroy(FiPagePool* pool);
int64_t fi_page_pool_free_pages(const FiPagePool* pool);

/* Register a sequence; returns seq slot id (>=0) or -1 if table full. */
int64_t fi_seq_create(FiPagePool* pool);
/* Extend a sequence to hold new_len tokens; allocates pages as needed.
 * Returns 0 on success, -1 on OOM (state unchanged on failure). */
int32_t fi_seq_extend(FiPagePool* pool, int64_t seq, int64_t new_len);
/* Shrink a sequence to new_len tokens (speculative-decode rollback);
 * frees tail pages that fall out of use.  Returns 0 on success, -1 on a
 * bad handle or new_len > current length. */
int32_t fi_seq_truncate(FiPagePool* pool, int64_t seq, int64_t new_len);
/* Release all pages of a sequence and free the slot. */
void fi_seq_release(FiPagePool* pool, int64_t seq);
int64_t fi_seq_len(const FiPagePool* pool, int64_t seq);
int64_t fi_seq_num_pages(const FiPagePool* pool, int64_t seq);
/* Copy the page list into out (caller-sized via fi_seq_num_pages). */
void fi_seq_pages(const FiPagePool* pool, int64_t seq, int32_t* out);

/* Batch export: build indptr/indices/last_page_len for a set of seqs.
 * indptr has nseq+1 entries; indices needs sum(num_pages) entries. */
void fi_batch_export(
    const FiPagePool* pool,
    const int64_t* seqs, int64_t nseq,
    int32_t* kv_indptr,
    int32_t* kv_indices,
    int32_t* kv_last_page_len);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* FI_NATIVE_H_ */
