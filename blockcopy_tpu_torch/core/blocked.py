"""Block-sparse tensor representation and canvas exchange primitives
(counterpart of ``blockcopy_tpu/core/blocked.py``).

* ``split_dense``  -- dense image -> packed executed blocks;
* ``scatter_pack`` -- packed blocks -> persistent block-layout canvas;
* ``halo_gather``  -- padded ``(bs+2p, bs+2p)`` blocks whose halo comes from
  the 8 neighbours: this frame's value where the neighbour executed (it was
  just scattered), the previous frame's otherwise, zeros past the image.

Canvas layout: ``(N*GH*GW + 1, bs, bs, C)``, block-major NHWC; the last row
is a sentinel that stays zero, so image borders and padding slots are plain
gathers.  Canvases are updated in place (``index_copy_``): the carried state
of a clip holds one buffer per layer instead of a copy per frame.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from blockcopy_tpu_torch.ops.kernels.halo import (
    gather_halo_strips,
    halo_gather_canvas,
    halo_gather_canvas_plain,
    halo_gather_strips as halo_gather_strips_kernel,
    halo_gather_strips_plain,
)

# Halo storage and assembly (``blocked.py:52`` of the JAX package):
#   'strips' (default): persist only the 2p edge rows/cols of every block and
#       assemble the halo with the strip entry point of the halo kernel;
#   'full': full-feature canvas, assembly in plain torch ops;
#   'pallas': full-feature canvas, assembly by the canvas entry point of the
#       halo kernel (the name of the JAX mode it mirrors).
HALO_IMPL = os.environ.get("BLOCKCOPY_TPU_HALO", "strips")

# Plain versions under the JAX package's names.
halo_gather = halo_gather_canvas_plain
halo_gather_strips = halo_gather_strips_plain

__all__ = [
    "BlockPack", "ExecCtx", "alloc_canvas", "split_dense",
    "split_block_layout", "dense_to_block_layout", "block_layout_to_dense",
    "scatter_pack", "halo_gather", "alloc_strip_canvas", "scatter_strips",
    "gather_halo_strips", "halo_gather_strips", "is_block", "combine",
    "to_dense",
]


@dataclasses.dataclass(frozen=True)
class BlockPack:
    """Packed executed blocks: ``data[k]`` is block ``idx[k]``.

    ``data``: (capacity, bs, bs, C); ``idx``: (capacity,) int64 flat block
    index in ``[0, N*GH*GW]``, the value ``N*GH*GW`` marking a padding slot.
    """

    data: torch.Tensor
    idx: torch.Tensor
    n: int
    gh: int
    gw: int

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def block_size(self) -> int:
        return self.data.shape[1]

    @property
    def channels(self) -> int:
        return self.data.shape[-1]

    @property
    def total(self) -> int:
        return self.n * self.gh * self.gw

    def with_data(self, data: torch.Tensor) -> "BlockPack":
        return dataclasses.replace(self, data=data)


def is_block(x) -> bool:
    """Whether ``x`` is packed blocks (reference ``blockcopy.is_block``,
    ``core/tensorwrapper.py:24``)."""
    return isinstance(x, BlockPack)


def alloc_canvas(n: int, gh: int, gw: int, bs: int, c: int, dtype,
                 device) -> torch.Tensor:
    """Zero canvas with one extra sentinel row (stays zero forever)."""
    return torch.zeros((n * gh * gw + 1, bs, bs, c), dtype=dtype,
                       device=device)


def dense_to_block_layout(x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(N, H, W, C) -> (N*GH*GW, bs, bs, C)."""
    n, h, w, c = x.shape
    bs_h, bs_w = h // gh, w // gw
    if bs_h != bs_w:
        raise ValueError(f"non-square blocks: {tuple(x.shape)}, {gh}, {gw}")
    x = x.reshape(n, gh, bs_h, gw, bs_w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n * gh * gw, bs_h, bs_w, c)


def block_layout_to_dense(blocks: torch.Tensor, n: int, gh: int,
                          gw: int) -> torch.Tensor:
    """(N*GH*GW[+1], bs, bs, C) -> (N, GH*bs, GW*bs, C); sentinel dropped."""
    bs, c = blocks.shape[1], blocks.shape[-1]
    x = blocks[: n * gh * gw].reshape(n, gh, gw, bs, bs, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, gh * bs, gw * bs, c)


def split_dense(x: torch.Tensor, idx: torch.Tensor, n: int, gh: int,
                gw: int) -> BlockPack:
    """Gather executed blocks from a dense (N, H, W, C) image; padding slots
    (the sentinel ``total``) read zeros, as ``jnp.take(mode="fill")`` does.
    Only the executed blocks are read."""
    _, h, w, c = x.shape
    bs, total = h // gh, n * gh * gw
    i = idx.clamp(max=total - 1)
    data = x.reshape(n, gh, bs, gw, bs, c)[
        i // (gh * gw), (i % (gh * gw)) // gw, :, i % gw]   # (K, bs, bs, C)
    data = torch.where((idx < total).view(-1, 1, 1, 1), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))
    return BlockPack(data=data, idx=idx, n=n, gh=gh, gw=gw)


def split_block_layout(canvas: torch.Tensor, idx: torch.Tensor, n: int,
                       gh: int, gw: int) -> BlockPack:
    """Gather executed blocks straight from a block-layout canvas; the
    sentinel ``total`` reads the canvas's zero row, or zeros where the
    layout has none."""
    total = n * gh * gw
    if canvas.shape[0] > total:
        data = canvas.index_select(0, idx)
    else:
        data = canvas.index_select(0, idx.clamp(max=total - 1))
        data = torch.where((idx < total).view(-1, 1, 1, 1), data,
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
    return BlockPack(data=data, idx=idx, n=n, gh=gh, gw=gw)


def scatter_pack(canvas: torch.Tensor, pack: BlockPack) -> torch.Tensor:
    """Write executed blocks into the canvas in place; padding slots land on
    the sentinel row, which is re-zeroed (duplicate sentinel writes are
    harmless only because of that)."""
    canvas.index_copy_(0, pack.idx, pack.data.to(canvas.dtype))
    canvas[-1].zero_()
    return canvas


def alloc_strip_canvas(n: int, gh: int, gw: int, bs: int, c: int, p: int,
                       dtype, device) -> Dict[str, torch.Tensor]:
    """Edge-strip storage for a halo site: ``rows`` holds [top p; bottom p]
    of every block, ``cols`` [left p; right p]; +1 zero sentinel row each."""
    total = n * gh * gw
    return {
        "rows": torch.zeros((total + 1, 2 * p, bs, c), dtype=dtype,
                            device=device),
        "cols": torch.zeros((total + 1, bs, 2 * p, c), dtype=dtype,
                            device=device),
    }


def scatter_strips(strips: Dict[str, torch.Tensor], pack: BlockPack,
                   p: int) -> Dict[str, torch.Tensor]:
    """Write the executed blocks' edge strips in place; re-zero sentinels."""
    d = pack.data.to(strips["rows"].dtype)
    rows = torch.cat([d[:, :p], d[:, -p:]], dim=1)
    cols = torch.cat([d[:, :, :p], d[:, :, -p:]], dim=2)
    for key, val in (("rows", rows), ("cols", cols)):
        strips[key].index_copy_(0, pack.idx, val)
        strips[key][-1].zero_()
    return strips


@dataclasses.dataclass
class ExecCtx:
    """Execution context threaded through a blocked model.

    ``canvases`` maps a stable layer name to its persistent feature canvas
    (or strip dict); alignment across frames is by name.  ``idx`` is the
    shared flat index vector of executed blocks.  A ``dense`` ctx runs every
    layer densely.  ``building=True`` creates canvases on first use; the
    shape pass of ``FixedCapacityStepper.init_state`` runs so on the meta
    device, where no kernel is launched.
    """

    mode: str  # 'blocked' | 'dense'
    n: int = 1
    gh: int = 0
    gw: int = 0
    idx: Optional[torch.Tensor] = None
    canvases: Dict[str, object] = dataclasses.field(default_factory=dict)
    building: bool = False
    # Multiply-accumulate tally by layer name, from shapes on the host (no
    # device read); shared with the dense views of ``as_dense`` so SPP
    # interiors count into the same tally (``blocked.py:303-309``).
    macs: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Canvas names already stored this frame: a second store through the
    # same name means two call sites silently share one temporal canvas.
    stored_names: set = dataclasses.field(default_factory=set)

    @classmethod
    def dense(cls) -> "ExecCtx":
        return cls(mode="dense")

    def as_dense(self) -> "ExecCtx":
        return dataclasses.replace(self, mode="dense")

    def add_macs(self, count: float, name: str = "") -> None:
        self.macs[name] = self.macs.get(name, 0.0) + float(count)

    @property
    def total_macs(self) -> float:
        return sum(self.macs.values())

    def macs_by_module(self) -> Dict[str, float]:
        """The tally by top-level module (first dot-segment of the layer
        name), the shape of the reference's per-submodule cost tree."""
        out: Dict[str, float] = {}
        for name, v in self.macs.items():
            key = name.split(".", 1)[0] if name else "other"
            out[key] = out.get(key, 0.0) + v
        return out

    @classmethod
    def blocked(cls, idx, n, gh, gw, canvases, building=False) -> "ExecCtx":
        return cls(mode="blocked", n=n, gh=gh, gw=gw, idx=idx,
                   canvases=canvases, building=building)

    @property
    def is_dense(self) -> bool:
        return self.mode == "dense"

    def _missing(self, name: str) -> KeyError:
        return KeyError(
            f"no canvas for layer '{name}'; temporal state was not "
            f"initialized for this model (did the op sequence change?)")

    def canvas_for(self, name: str, like: BlockPack) -> torch.Tensor:
        if name not in self.canvases:
            if not self.building:
                raise self._missing(name)
            self.canvases[name] = alloc_canvas(
                self.n, self.gh, self.gw, like.block_size, like.channels,
                like.data.dtype, like.data.device)
        return self.canvases[name]

    def strip_canvas_for(self, name: str, like: BlockPack,
                         pad: int) -> Dict[str, torch.Tensor]:
        if name not in self.canvases:
            if not self.building:
                raise self._missing(name)
            self.canvases[name] = alloc_strip_canvas(
                self.n, self.gh, self.gw, like.block_size, like.channels,
                pad, like.data.dtype, like.data.device)
        return self.canvases[name]

    def exchange(self, name: str, x: BlockPack, pad: int) -> torch.Tensor:
        """Scatter the current blocks' halo-relevant state into the named
        canvas; return halo-padded blocks ``(K, bs+2p, bs+2p, C)`` in the
        canvas dtype."""
        if HALO_IMPL == "strips":
            store = self.strip_canvas_for(name, x, pad)
            scatter_strips(store, x, pad)
            dtype = store["rows"].dtype
        else:
            store = self.canvas_for(name, x)
            scatter_pack(store, x)
            dtype = store.dtype
        if x.data.is_meta:        # shape pass: no values, no kernel
            k, bs, _, c = x.data.shape
            return x.data.new_empty((k, bs + 2 * pad, bs + 2 * pad, c),
                                    dtype=dtype)
        center = x.data.to(dtype).contiguous()
        if HALO_IMPL == "strips":
            return halo_gather_strips_kernel(store, x.idx, pad, self.n,
                                             self.gh, self.gw, center)
        if HALO_IMPL == "pallas":
            return halo_gather_canvas(store, x.idx, pad, self.n, self.gh,
                                      self.gw, center)
        return halo_gather(store, x.idx, pad, self.n, self.gh, self.gw,
                           center=center)

    def exchange_pieces(self, name: str, x: BlockPack,
                        pad: int) -> Optional[Dict[str, torch.Tensor]]:
        """Like ``exchange`` but returns the 8 halo pieces unassembled;
        ``None`` under the full-canvas modes."""
        if HALO_IMPL != "strips":
            return None
        strips = self.strip_canvas_for(name, x, pad)
        scatter_strips(strips, x, pad)
        return gather_halo_strips(strips, x.idx, pad, self.n, self.gh,
                                  self.gw)

    def store_blocks(self, name: str, x: BlockPack) -> torch.Tensor:
        """Scatter blocks into the named canvas; return it in block layout."""
        if name in self.stored_names:
            raise ValueError(
                f"canvas '{name}' was already stored this frame: two call "
                f"sites are sharing one temporal canvas; pass distinct "
                f"names (skipped blocks would silently receive the other "
                f"site's features)")
        self.stored_names.add(name)
        return scatter_pack(self.canvas_for(name, x), x)

    def store_dense(self, name: str, x: BlockPack) -> torch.Tensor:
        """Scatter blocks into the named canvas and return the dense image."""
        canvas = self.store_blocks(name, x)
        dense = block_layout_to_dense(canvas, self.n, self.gh, self.gw)
        # with one block column the rebuild is a view of the canvas, which
        # the next frame updates in place
        return dense.clone() if dense._is_view() else dense

    def split_like(self, x: torch.Tensor) -> BlockPack:
        """Dense image -> executed blocks with this context's grid (the
        reference's ``to_blocks_like``, ``core/tensorwrapper.py:325-333``)."""
        return split_dense(x, self.idx, self.n, self.gh, self.gw)


def combine(ctx: ExecCtx, name: str, x: BlockPack) -> torch.Tensor:
    """Blocks -> dense image through the named persistent canvas."""
    return ctx.store_dense(name, x)


def to_dense(x, ctx: Optional[ExecCtx] = None, name: str = "out"):
    """Dense tensors pass through; packed blocks are combined through
    ``ctx`` (the reference's ``blockcopy.to_tensor``)."""
    if isinstance(x, BlockPack):
        if ctx is None:
            raise ValueError("combining packed blocks needs an ExecCtx")
        return combine(ctx, name, x)
    return x
