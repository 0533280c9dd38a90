"""Meshes of shards: the counterpart of ``jax.sharding.Mesh`` with
``shard_map``, ``_ring_shift`` and ``sharded_state``
(``njw_tpu/parallel/halo.py:34-44``, ``:117-128``).

A whole-domain state is cut on its last two axes (rows over the mesh's
'y' axis, columns over 'x'; leading axes such as levels stay whole) into
py x px shards. A sharded state is the **list of the shard states this
process holds**, in row-major (iy, ix) order, and every sharded stepper is
written once against that list and ``ring_shift``:

* ``LocalMesh(py, px, device)``: one process holds all py x px shards on
  one device (the JAX tests' 8 virtual CPU devices in one process; on the
  card, every shard on ``cuda:0``). ``ring_shift`` reindexes the list: no
  copy and no host synchronisation.
* ``ProcessMesh(py, px, group)``: one shard per rank of a
  ``torch.distributed`` process group (NCCL with one card per rank, gloo
  on CPU tensors), rank r holding (iy, ix) = divmod(r, px).
  ``ring_shift`` posts the sends and receives of one axis and direction as
  one ``dist.batch_isend_irecv``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.weather.grid import FieldState

AXES = ("y", "x")
Payload = tuple  # the tensors one shard sends in one exchange


def _device(device) -> torch.device:
    """``device`` checked (CUDA raises without a card), a bare 'cuda' as
    the current CUDA device, so that it equals the shards' device."""
    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Mesh:
    """What both meshes share: the (py, px) shape, the coordinates of the
    shards this process holds, and the cut of a state into shards."""

    def __init__(self, py: int, px: int, coords: list, device):
        if py < 1 or px < 1:
            raise ValueError(f"mesh shape ({py}, {px}): both axes >= 1")
        self.shape = (int(py), int(px))
        self.coords = coords
        self.device = device

    @property
    def py(self) -> int:
        return self.shape[0]

    @property
    def px(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.py * self.px

    def axis_size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def axis_index(self, axis: str) -> list[int]:
        """Each local shard's index along ``axis``."""
        i = AXES.index(axis)
        return [c[i] for c in self.coords]

    def shifted(self, coord: tuple, axis: str, shift: int) -> tuple:
        """The coordinate ``shift`` places along ``axis`` from ``coord``
        (a ring)."""
        iy, ix = coord
        if axis == "y":
            return ((iy + shift) % self.py, ix)
        if axis == "x":
            return (iy, (ix + shift) % self.px)
        raise ValueError(f"unknown mesh axis {axis!r}: expected 'y' or 'x'")

    def block_shape(self, ny: int, nx: int) -> tuple[int, int]:
        """(ly, lx) of one shard of an (ny, nx) grid."""
        if ny % self.py or nx % self.px:
            raise ValueError(f"grid {ny}x{nx} not divisible by mesh "
                             f"{self.py}x{self.px}")
        return ny // self.py, nx // self.px

    def shard_state(self, state: FieldState) -> list:
        """The local shards of a whole-domain state, contiguous, on the
        mesh's device."""
        some = next(state.items())[1]
        ly, lx = self.block_shape(*some.shape[-2:])

        def cut(iy, ix):
            return state.map(lambda a: a[..., iy * ly:(iy + 1) * ly,
                                         ix * lx:(ix + 1) * lx]
                             .to(self.device).contiguous())

        return [cut(iy, ix) for iy, ix in self.coords]

    def _assemble(self, blocks: Sequence) -> FieldState:
        """The whole-domain state from all py x px shards in row-major
        order."""
        names = [n for n, _ in blocks[0].items()]
        fields = {}
        for n in names:
            rows = [torch.cat([getattr(blocks[iy * self.px + ix], n)
                               for ix in range(self.px)], dim=-1)
                    for iy in range(self.py)]
            fields[n] = torch.cat(rows, dim=-2)
        return type(blocks[0])(**fields)

    def _check_shards(self, shards: Sequence) -> None:
        if len(shards) != len(self.coords):
            raise ValueError(f"{len(shards)} shards for a process that holds "
                             f"{len(self.coords)}")


class LocalMesh(_Mesh):
    """All py x px shards in this process, on one device (CUDA by
    default; raises without a card unless ``device='cpu'``)."""

    def __init__(self, py: int, px: int = 1, device="cuda"):
        coords = [(iy, ix) for iy in range(py) for ix in range(px)]
        super().__init__(py, px, coords, _device(device))

    def index(self, coord: tuple) -> int:
        return coord[0] * self.px + coord[1]

    def ring_shift(self, payloads: Sequence[Payload], axis: str,
                   shift: int) -> list[Payload]:
        """For each shard i along ``axis``, the payload of shard i - shift
        (mod n): src i -> dst i + shift, as ``_ring_shift``. A reindexing
        of the list; the tensors are the senders' own (views)."""
        if self.axis_size(axis) == 1:
            return list(payloads)
        return [payloads[self.index(self.shifted(c, axis, -shift))]
                for c in self.coords]

    def gather_state(self, shards: Sequence) -> FieldState:
        """The whole-domain state (a new one) from the shards."""
        self._check_shards(shards)
        return self._assemble(shards)


class ProcessMesh(_Mesh):
    """One shard per rank of a ``torch.distributed`` process group (the
    default group when ``group`` is None), which must be initialised and
    hold py x px ranks. ``device``: where this rank's shard lives, CUDA by
    default (the current device: set it per rank first), 'cpu' with gloo.
    """

    _TAG_BASE = {("y", 1): 0, ("y", -1): 16, ("x", 1): 32, ("x", -1): 48}

    def __init__(self, py: int, px: int = 1, group=None, device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: torch.distributed is not "
                               "initialised (init_process_group first)")
        world = dist.get_world_size(group)
        if world != py * px:
            raise ValueError(f"ProcessMesh: {world} ranks for a {py}x{px} "
                             "mesh")
        self.group = group
        self.rank = dist.get_rank(group)
        super().__init__(py, px, [divmod(self.rank, px)], _device(device))

    def _peer(self, coord: tuple) -> int:
        r = coord[0] * self.px + coord[1]
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def ring_shift(self, payloads: Sequence[Payload], axis: str,
                   shift: int) -> list[Payload]:
        """This rank's payload goes to the rank ``shift`` places along
        ``axis``; the one ``shift`` places back arrives (new contiguous
        tensors), in one ``batch_isend_irecv``."""
        if self.axis_size(axis) == 1:
            return list(payloads)
        (payload,) = payloads
        me = self.coords[0]
        dst = self._peer(self.shifted(me, axis, shift))
        src = self._peer(self.shifted(me, axis, -shift))
        tag = self._TAG_BASE[(axis, 1 if shift > 0 else -1)]
        sends = [t.contiguous() for t in payload]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, dst, self.group, tag + i)
               for i, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, src, self.group, tag + i)
                for i, t in enumerate(recvs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [tuple(recvs)]

    def gather_state(self, shards: Sequence) -> FieldState:
        """The whole-domain state on every rank (an all-gather of each
        field)."""
        self._check_shards(shards)
        (mine,) = shards
        gathered = [{} for _ in range(self.size)]
        for name, t in mine.items():
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.group)
            for g, p in zip(gathered, parts):
                g[name] = p
        return self._assemble([type(mine)(**g) for g in gathered])

