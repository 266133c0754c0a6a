// The key tiles an attention CTA walks, from a mask's tile map (uint8
// [map heads or items, 64-row blocks, 64-key tiles]: bit kMapKeep where a
// real row keeps a key that the span, causal and the window allow,
// kMapDrop where the mask drops one; flashinfer_tpu_torch/ops/attention/
// kernels/tile_map.py builds them on the host). Shared by the paged and
// flash kernels.
//
// Without a map a CTA walks every tile of its range. With one, a launch
// before the attention lists, for each CTA, in order, the tiles that a row
// block of it keeps a key of, each with its row blocks' classes
// (list_tiles, a warp a CTA), into a workspace; the CTA's producer and
// consumers iterate its list by index. Their loops keep the shape they
// have without a map (a trip count read from shared memory after a
// barrier, a tile a step), so no branch comes to enclose a wgmma; and the
// attention kernels hold no code that builds a list (built inside them,
// in a branch on the map, it made the unmasked bf16 launches 4-6% slower
// and ptxas serialise the 8-bit decode kernels' wgmma: C7520).

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMapRows = 64, kMapKeys = 64;  // a tile of the tile map
enum MapBits { kMapKeep = 1, kMapDrop = 2 };
// kMapKeep of both row blocks of a CTA's classes (row block b at bit 2b)
constexpr int kMapKeepAny = kMapKeep | kMapKeep << 2;

struct Walk {
  const uint32_t* list;  // t << 4 | classes, or null (no map)
  int t0, n;             // the first tile without a map; tiles to walk
  int bits;              // every tile's classes without a map
  __device__ __forceinline__ int tile(int i) const {
    return list ? int(list[i] >> 4) : t0 + i;
  }
  __device__ __forceinline__ int classes(int i) const {
    return list ? int(list[i] & 15) : bits;
  }
};

// A warp's list of the tiles t of [t0, t1) that a row block keeps a key of
// (class_of(t): the row blocks' bits), in order, as t << 4 | classes, and
// its length in *count: a ballot a 32 tiles.
template <typename ClassOf>
__device__ __forceinline__ void list_tiles(ClassOf class_of, int t0, int t1,
                                           uint32_t* list, int* count,
                                           int lane) {
  int base = 0;
  for (int j0 = t0; j0 < t1; j0 += 32) {
    const int t = j0 + lane;
    const int c = t < t1 ? class_of(t) : 0;
    const unsigned keep = __ballot_sync(0xffffffffu, c & kMapKeepAny);
    if (c & kMapKeepAny)
      list[base + __popc(keep & ((1u << lane) - 1u))] =
          (uint32_t(t) << 4) | uint32_t(c);
    base += __popc(keep);
  }
  if (lane == 0) *count = base;
}

}  // namespace
