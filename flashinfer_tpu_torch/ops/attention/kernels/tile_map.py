"""Tile maps of attention masks: which key tiles of each row block a mask
keeps nothing of, keeps whole, or cuts.

The paged and flash kernels (``csrc/paged_attention.cu``,
``csrc/flash_attention.cu``) read such a map to skip the key tiles that no
row of a CTA keeps a key of, and to run the tiles a mask keeps whole
without reading it. A map is uint8 [N, ceil(rows / 64), ceil(keys / 64)]:
for each 64-row block and 64-key tile, bit ``MAP_KEEP`` where a real row
keeps a key that the span, causal and the window allow ("in reach"), bit
``MAP_DROP`` where the mask drops such a key. So 0 and ``MAP_DROP`` are
empty (skipped), ``MAP_KEEP`` full (unmasked), both partial. The TPU
kernels have no such map: they compute every tile of a masked plan.
"""

from __future__ import annotations

import torch

__all__ = ["MAP_DROP", "MAP_KEEP", "MAP_TILE", "map_classes", "map_counts",
           "mapped_keep", "tile_classes"]

MAP_TILE = 64  # rows and keys a tile of the map
MAP_KEEP, MAP_DROP = 1, 2


def _tiles_any(x: torch.Tensor) -> torch.Tensor:
    """bool [N, R, C] -> [N, R / 64, C / 64] (each padded up to 64): whether
    any entry of each 64 x 64 tile is set."""
    N, R, C = x.shape
    rb, nt = -(-R // MAP_TILE), -(-C // MAP_TILE)
    x = torch.nn.functional.pad(x, (0, nt * MAP_TILE - C, 0,
                                    rb * MAP_TILE - R))
    return x.reshape(N, rb, MAP_TILE, nt, MAP_TILE).any(dim=4).any(dim=2)


def map_classes(reach: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The tile map of bool [N, R, C] masks: ``reach`` the (row, key) pairs
    the rows may see at all, ``keep`` the mask's. uint8 [N, R / 64, C /
    64]."""
    kept = _tiles_any(reach & keep).to(torch.uint8)
    dropped = _tiles_any(reach & ~keep).to(torch.uint8)
    return kept * MAP_KEEP | dropped * MAP_DROP


def map_counts(tile_map: torch.Tensor) -> dict:
    """Tiles of a map by class: empty (no key kept, or none in reach),
    partial, full."""
    m = tile_map.reshape(-1).long()
    keep, drop = (m & MAP_KEEP) != 0, (m & MAP_DROP) != 0
    return dict(empty=int((~keep).sum()), partial=int((keep & drop).sum()),
                full=int((keep & ~drop).sum()))


def tile_classes(tile_map: torch.Tensor, rows: torch.Tensor,
                 keys: torch.Tensor) -> torch.Tensor:
    """The map's class of each (row, key): uint8 [N, len(rows), len(keys)]
    for ``tile_map`` [N, RB, NT]; keys past the map hold nothing (0)."""
    nt = tile_map.shape[2]
    kt = keys // MAP_TILE
    cls = tile_map[:, rows // MAP_TILE][:, :, kt.clamp(max=nt - 1)]
    return torch.where((kt < nt)[None, None, :], cls, 0)


def mapped_keep(keep: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """A mask as a kernel reads it under the map: nothing of a tile with no
    kept key, everything of a tile the mask keeps whole, ``keep`` of a
    tile it cuts."""
    return torch.where((cls & MAP_KEEP) != 0,
                       torch.where((cls & MAP_DROP) != 0, keep, True), False)
