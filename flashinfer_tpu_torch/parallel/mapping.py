"""Parallel topology math: the rank groups of a dp x pp x cp x tp world.

Counterpart of ``flashinfer_tpu/parallel/mapping.py`` (a copy of its rank
arithmetic; no tensors). A ``Mapping`` validates the factorization and
``parallel.mesh.make_mesh`` turns it into ``DeviceMesh`` views whose
process groups carry the collectives. Rank order is row-major over (dp, pp,
cp, tp), and the MoE view refactors the (cp x tp) sub-grid as
(moe_ep x moe_tp):

  * world = dp x pp x cp x tp
  * moe_ep x moe_tp = cp x tp
  * attention reuses tp (attn_tp = tp x cp) or runs data-parallel
    (``enable_attention_dp``)
"""

from __future__ import annotations

import dataclasses
from typing import List

__all__ = ["Mapping"]


@dataclasses.dataclass(frozen=True)
class Mapping:
    world_size: int = 1
    rank: int = 0
    tp_size: int = 1
    pp_size: int = 1
    cp_size: int = 1
    dp_size: int = 0  # explicit data parallel (0/-1 = derive from world)
    moe_tp_size: int = -1  # -1: defaults to tp_size
    moe_ep_size: int = -1  # -1: defaults to 1
    enable_attention_dp: bool = False
    # devices per host — only used for "is local" style helpers
    devices_per_host: int = 4

    def __post_init__(self):
        object.__setattr__(
            self, "moe_ep_size",
            1 if self.moe_ep_size == -1 else self.moe_ep_size,
        )
        object.__setattr__(
            self, "moe_tp_size",
            (self.tp_size * self.cp_size) // self.moe_ep_size
            if self.moe_tp_size == -1
            else self.moe_tp_size,
        )
        dp = self.dp_size
        denom = self.tp_size * self.pp_size * self.cp_size
        if self.world_size % denom != 0:
            raise ValueError(
                f"world_size {self.world_size} not divisible by "
                f"tp*pp*cp = {denom}"
            )
        derived_dp = self.world_size // denom
        if dp in (0, -1):
            object.__setattr__(self, "dp_size", derived_dp)
        elif dp != derived_dp:
            raise ValueError(
                f"dp_size {dp} inconsistent: world {self.world_size} / "
                f"(tp*pp*cp {denom}) = {derived_dp}"
            )
        if self.moe_tp_size * self.moe_ep_size != self.tp_size * self.cp_size:
            raise ValueError(
                "moe_tp_size * moe_ep_size must equal tp_size * cp_size "
                f"({self.moe_tp_size}*{self.moe_ep_size} != "
                f"{self.tp_size}*{self.cp_size})"
            )
        if not (0 <= self.rank < self.world_size):
            raise ValueError(f"rank {self.rank} out of range")

    # --- rank decomposition (row-major: dp, pp, cp, tp) ---------------------

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp_size

    @property
    def cp_rank(self) -> int:
        return (self.rank // self.tp_size) % self.cp_size

    @property
    def pp_rank(self) -> int:
        return (self.rank // (self.tp_size * self.cp_size)) % self.pp_size

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.tp_size * self.cp_size * self.pp_size)

    @property
    def moe_tp_rank(self) -> int:
        return (self.cp_rank * self.tp_size + self.tp_rank) % self.moe_tp_size

    @property
    def moe_ep_rank(self) -> int:
        return (self.cp_rank * self.tp_size + self.tp_rank) // self.moe_tp_size

    # --- attention view ------------------------------------------------------

    @property
    def attn_tp_size(self) -> int:
        """With attention-DP the attention runs data-parallel (tp=1);
        otherwise attention TP folds in CP Ulysses-style
        (reference mapping.py:150-163 attn_tp = tp*cp fallback)."""
        if self.enable_attention_dp:
            return 1
        return self.tp_size * self.cp_size

    @property
    def attn_dp_size(self) -> int:
        if self.enable_attention_dp:
            return self.dp_size * self.tp_size * self.cp_size
        return self.dp_size

    # --- pp helpers (reference mapping.py is_first_pp_rank etc.) ------------

    @property
    def is_first_pp_rank(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last_pp_rank(self) -> bool:
        return self.pp_rank == self.pp_size - 1

    @property
    def prev_pp_rank(self) -> int:
        return self._with_pp((self.pp_rank - 1) % self.pp_size)

    @property
    def next_pp_rank(self) -> int:
        return self._with_pp((self.pp_rank + 1) % self.pp_size)

    def _with_pp(self, pp: int) -> int:
        return (
            self.dp_rank * self.pp_size * self.cp_size * self.tp_size
            + pp * self.cp_size * self.tp_size
            + self.cp_rank * self.tp_size
            + self.tp_rank
        )

    # --- rank groups ---------------------------------------------------------

    def tp_group(self) -> List[int]:
        base = self.rank - self.tp_rank
        return [base + i for i in range(self.tp_size)]

    def cp_group(self) -> List[int]:
        base = self.rank - self.cp_rank * self.tp_size
        return [base + i * self.tp_size for i in range(self.cp_size)]

    def pp_group(self) -> List[int]:
        stride = self.cp_size * self.tp_size
        base = self.rank - self.pp_rank * stride
        return [base + i * stride for i in range(self.pp_size)]

    def dp_group(self) -> List[int]:
        stride = self.pp_size * self.cp_size * self.tp_size
        base = self.rank - self.dp_rank * stride
        return [base + i * stride for i in range(self.dp_size)]

    def moe_ep_group(self) -> List[int]:
        """Ranks sharing moe_tp_rank, spanning ep (within the cp×tp grid)."""
        grid_base = self.rank - (self.cp_rank * self.tp_size + self.tp_rank)
        return [
            grid_base + e * self.moe_tp_size + self.moe_tp_rank
            for e in range(self.moe_ep_size)
        ]

    def moe_tp_group(self) -> List[int]:
        grid_base = self.rank - (self.cp_rank * self.tp_size + self.tp_rank)
        return [
            grid_base + self.moe_ep_rank * self.moe_tp_size + t
            for t in range(self.moe_tp_size)
        ]

    # --- misc ---------------------------------------------------------------

    @property
    def has_tp(self) -> bool:
        return self.tp_size > 1

    @property
    def has_pp(self) -> bool:
        return self.pp_size > 1

    @property
    def has_cp(self) -> bool:
        return self.cp_size > 1

    @property
    def has_moe_ep(self) -> bool:
        return self.moe_ep_size > 1

    def local_rank(self) -> int:
        return self.rank % self.devices_per_host

    def host_index(self) -> int:
        return self.rank // self.devices_per_host
