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

The exchanges:

* ``ring_shift(payloads, axis, shift)``: ``lax.ppermute`` over a ring.
  ``ring_shift_start`` posts it and returns a handle whose ``wait()`` gives
  the payloads, so that work which needs no halo runs while the sends are
  in flight (on ``LocalMesh`` the handle is complete at once);
  ``ring_shift`` is start, then wait.
* ``ring_pair(to_next, to_prev, axis)``: ``ring_shift`` by +1 and by -1
  as one exchange (on ``ProcessMesh`` one ``all_to_all_single`` of packed
  float32 payloads). ``pair_exchange`` makes it a callable over payloads
  that stay the same tensors, whose buffers ``ProcessMesh`` makes once and
  packs with one strip-copy launch (``ops/halo_strips.py``; the plain
  copies on the CPU): the kernel steppers' halo refresh calls one an
  axis.
* ``all_to_all(blocks, axis, split_dim, concat_dim)``: ``lax.all_to_all(...,
  tiled=False)`` along 'y', 'x' or the combined ('y', 'x') axis (row-major
  index iy * px + ix).
* ``all_reduce_sum(blocks, axis)``: ``lax.psum`` along an axis.

Each moves ``exchanges`` (one a call that moves data) and
``exchange_bytes`` (the payload bytes the shards of this process send):
the port's own counts of its exchanges, which a caller may set to 0.
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import torch
import torch.distributed as dist

from njw_tpu_torch.ops.halo_strips import bind_strips
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.weather.grid import FieldState

AXES = ("y", "x")
Axis = Union[str, tuple]  # 'y', 'x' or the combined ('y', 'x')
Payload = tuple  # the tensors one shard sends in one exchange


class Ready:
    """The handle of an exchange that is complete: ``wait()`` gives its
    payloads."""

    def __init__(self, payloads: list):
        self._payloads = payloads

    def wait(self) -> list:
        return self._payloads


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


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
        self.exchanges = 0
        self.exchange_bytes = 0

    @property
    def py(self) -> int:
        return self.shape[0]

    @property
    def px(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.py * self.px

    def axis_size(self, axis: Axis) -> int:
        if tuple(axis) == AXES:
            return self.size
        return self.shape[self._axis(axis)]

    def axis_index(self, axis: Axis) -> list[int]:
        """Each local shard's index along ``axis`` (along ('y', 'x'):
        iy * px + ix, as ``lax.axis_index(('y', 'x'))``)."""
        if tuple(axis) == AXES:
            return [iy * self.px + ix for iy, ix in self.coords]
        i = self._axis(axis)
        return [c[i] for c in self.coords]

    @staticmethod
    def _axis(axis) -> int:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}: expected 'y', "
                             "'x' or ('y', 'x')")
        return AXES.index(axis)

    def axis_members(self, coord: tuple, axis: Axis) -> list[tuple]:
        """The coordinates of the shards on ``coord``'s ring along
        ``axis``, in the order of their index along it."""
        if tuple(axis) == AXES:
            return [(iy, ix) for iy in range(self.py) for ix in range(self.px)]
        if self._axis(axis) == 0:
            return [(iy, coord[1]) for iy in range(self.py)]
        return [(coord[0], ix) for ix in range(self.px)]

    def ring_shift(self, payloads: Sequence[Payload], axis: str,
                   shift: int) -> list[Payload]:
        """For each local shard, the payload of the shard ``shift`` places
        back along ``axis`` (src i -> dst i + shift, as ``_ring_shift``):
        ``ring_shift_start``, then wait."""
        return self.ring_shift_start(payloads, axis, shift).wait()

    def ring_pair(self, to_next: Sequence[Payload], to_prev: Sequence[Payload],
                  axis: str) -> tuple[list, list]:
        """(``ring_shift(to_next, axis, +1)``, ``ring_shift(to_prev, axis,
        -1)``): for each local shard, what its previous and its next shard
        along ``axis`` send it."""
        return (self.ring_shift(to_next, axis, +1),
                self.ring_shift(to_prev, axis, -1))

    def pair_exchange(self, to_next: Sequence[Payload],
                      to_prev: Sequence[Payload], axis: str) -> Callable:
        """``ring_pair(to_next, to_prev, axis)`` of payloads that are the
        same tensors at every call (views that the caller refills), as a
        callable: each call sends what they hold then and returns what
        arrives, which is valid until the next call. Here each call is
        ``ring_pair``; ``ProcessMesh`` makes its buffers once."""
        return lambda: self.ring_pair(to_next, to_prev, axis)

    def _count(self, tensors) -> None:
        self.exchanges += 1
        self.exchange_bytes += _nbytes(tensors)

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


def _real(t: torch.Tensor) -> torch.Tensor:
    """A complex tensor's real view (its last axis the real and imaginary
    parts); a real tensor as it is."""
    return torch.view_as_real(t) if t.is_complex() else t


def _unreal(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_real`` for a result shaped as ``like``."""
    return torch.view_as_complex(t) if like.is_complex() else t


def _check_split(block: torch.Tensor, split_dim: int, n: int) -> None:
    if block.shape[split_dim] != n:
        raise ValueError(f"all_to_all: dimension {split_dim} of a block of "
                         f"shape {tuple(block.shape)} must be the axis size "
                         f"{n}")


class _Posted:
    """The handle of a posted ``batch_isend_irecv``; holds the send
    buffers until the exchange is done."""

    def __init__(self, works, sends, recvs):
        self._works, self._sends, self._recvs = works, sends, recvs

    def wait(self) -> list:
        for work in self._works:
            work.wait()
        self._works = self._sends = ()
        return [tuple(self._recvs)]


class LocalMesh(_Mesh):
    """All py x px shards in this process, on one device (CUDA by
    default; raises without a card unless ``device='cpu'``)."""

    def __init__(self, py: int, px: int = 1, device="cuda"):
        coords = [(iy, ix) for iy in range(py) for ix in range(px)]
        super().__init__(py, px, coords, _device(device))

    def index(self, coord: tuple) -> int:
        return coord[0] * self.px + coord[1]

    def ring_shift_start(self, payloads: Sequence[Payload], axis: str,
                         shift: int) -> Ready:
        """For each shard i along ``axis``, the payload of shard i - shift
        (mod n): src i -> dst i + shift, as ``_ring_shift``. A reindexing
        of the list; the tensors are the senders' own (views). Complete at
        once."""
        if self.axis_size(axis) == 1:
            return Ready(list(payloads))
        self._count(t for p in payloads for t in p)
        return Ready([payloads[self.index(self.shifted(c, axis, -shift))]
                      for c in self.coords])

    def all_to_all(self, blocks: Sequence[torch.Tensor], axis: Axis,
                   split_dim: int, concat_dim: int) -> list[torch.Tensor]:
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=False)``
        for each local block: block.shape[split_dim] is the axis size n;
        slice j along it goes to the shard of index j along ``axis``, and
        the n slices a shard receives are stacked, in source order, at
        ``concat_dim`` of the result (whose split dimension is gone). A
        reindexing of slice views; the one copy is the stack."""
        n = self.axis_size(axis)
        if n == 1:
            return list(blocks)
        for b in blocks:
            _check_split(b, split_dim, n)
        self._count(blocks)
        return [torch.stack([blocks[self.index(src)].select(split_dim, me)
                             for src in self.axis_members(c, axis)],
                            dim=concat_dim)
                for c, me in zip(self.coords, self.axis_index(axis))]

    def all_reduce_sum(self, blocks: Sequence[torch.Tensor],
                       axis: Axis) -> list[torch.Tensor]:
        """``lax.psum(x, axis)`` for each local block: the sum of the
        blocks on its ring along ``axis``, added in index order, one
        tensor handed to every shard of the ring. Complex blocks are summed
        as their real views (stacked real and imaginary parts, as the JAX
        package reduces them)."""
        n = self.axis_size(axis)
        if n == 1:
            return list(blocks)
        self._count(blocks)
        sums: dict = {}
        out = []
        for c in self.coords:
            members = tuple(self.axis_members(c, axis))
            if members not in sums:
                total = _real(blocks[self.index(members[0])]).clone()
                for m in members[1:]:
                    total += _real(blocks[self.index(m)])
                sums[members] = _unreal(total, blocks[0])
            out.append(sums[members])
        return out

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
    _TAG_SPAN = 16

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
        if self.rank < 0:
            raise ValueError("ProcessMesh: this rank is not a member of "
                             "the process group")
        self._rings: dict = {}
        super().__init__(py, px, [divmod(self.rank, px)], _device(device))

    def _peer(self, coord: tuple) -> int:
        r = coord[0] * self.px + coord[1]
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def ring_shift_start(self, payloads: Sequence[Payload], axis: str,
                         shift: int):
        """Post the exchange: this rank's payload goes to the rank
        ``shift`` places along ``axis``, the one ``shift`` places back
        arrives (new contiguous tensors), in one ``batch_isend_irecv``.
        ``wait()`` on the handle waits for it and gives the payloads. Tag
        ``_TAG_BASE[(axis, sign)] + i`` for the i-th tensor of the payload:
        one exchange of each axis and direction may be in flight at a time
        (the halo pads post the two directions of one axis together)."""
        if self.axis_size(axis) == 1:
            return Ready(list(payloads))
        (payload,) = payloads
        if len(payload) > self._TAG_SPAN:
            raise ValueError(f"{len(payload)} tensors in one exchange; at "
                             f"most {self._TAG_SPAN}")
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
        self._count(sends)
        return _Posted(dist.batch_isend_irecv(ops), sends, recvs)

    def ring_pair(self, to_next: Sequence[Payload], to_prev: Sequence[Payload],
                  axis: str) -> tuple[list, list]:
        """``_Mesh.ring_pair`` as one ``all_to_all_single`` over the group:
        each payload's float32 tensors are packed into one buffer a
        destination (its ``to_next`` part first), and nothing is sent to
        or received from the other ranks. One call and one collective in
        place of two ``batch_isend_irecv`` of a P2P operation a tensor,
        whose host cost paced the sharded steppers on the card."""
        return self.pair_exchange(to_next, to_prev, axis)()

    def pair_exchange(self, to_next: Sequence[Payload],
                      to_prev: Sequence[Payload], axis: str) -> Callable:
        """``_Mesh.pair_exchange`` with its buffers made once
        (``_PairExchange``): a call packs the payloads with one
        strip-copy launch, makes the one ``all_to_all_single`` of
        ``ring_pair`` and returns views of its receive buffer."""
        if self.axis_size(axis) == 1:
            return lambda: (list(to_next), list(to_prev))
        return _PairExchange(self, to_next, to_prev, axis)

    def _axis_group(self, axis: Axis):
        """(process group, this mesh's global ranks of the members of this
        rank's ring along ``axis`` in index order). This rank's ring's group
        is made at its first exchange along the axis, by the ring's members
        alone (``use_local_synchronization``), so the mesh may sit on any
        process group and the ranks outside a ring make no call."""
        members = self.axis_members(self.coords[0], axis)
        ranks = [self._peer(c) for c in members]
        if len(members) == self.size:
            return self.group, ranks
        ring = tuple(sorted(ranks))
        if ring not in self._rings:
            self._rings[ring] = dist.new_group(
                list(ring), use_local_synchronization=True)
        return self._rings[ring], ranks

    def all_to_all(self, blocks: Sequence[torch.Tensor], axis: Axis,
                   split_dim: int, concat_dim: int) -> list[torch.Tensor]:
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=False)``
        (see ``LocalMesh.all_to_all``) as one ``dist.all_to_all`` over the
        ranks of this rank's ring along ``axis``; complex blocks travel as
        their real views."""
        n = self.axis_size(axis)
        if n == 1:
            return list(blocks)
        (block,) = blocks
        _check_split(block, split_dim, n)
        group, ranks = self._axis_group(axis)
        # a group numbers its members in the order of their global ranks
        slot = [sorted(ranks).index(r) for r in ranks]
        sends = [None] * n
        for j in range(n):
            part = block.select(split_dim, j).contiguous()
            sends[slot[j]] = _real(part)
        recvs = [torch.empty_like(t) for t in sends]
        self._count(sends)
        dist.all_to_all(recvs, sends, group=group)
        got = [_unreal(recvs[slot[j]], block) for j in range(n)]
        return [torch.stack(got, dim=concat_dim)]

    def all_reduce_sum(self, blocks: Sequence[torch.Tensor],
                       axis: Axis) -> list[torch.Tensor]:
        """``lax.psum(x, axis)`` (see ``LocalMesh.all_reduce_sum``) as one
        ``dist.all_reduce`` over the ranks of this rank's ring along
        ``axis``; complex blocks travel as their real views."""
        if self.axis_size(axis) == 1:
            return list(blocks)
        (block,) = blocks
        group, _ = self._axis_group(axis)
        total = _real(block).clone(memory_format=torch.contiguous_format)
        self._count([total])
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return [_unreal(total, block)]

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



def _views(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    """Consecutive views of the 1-D ``flat``, shaped as each of ``like``."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class _PairExchange:
    """``ProcessMesh.ring_pair`` of payloads that stay the same tensors:
    the send and receive buffers, and their views shaped as the payloads,
    are made once. A call packs the payloads into the send buffer with the
    strip copy bound once (``bind_strips``: one launch of
    ``csrc/halo_strips.cu`` on CUDA, ``_foreach_copy_`` on the CPU),
    makes the ``all_to_all_single`` and returns views of the receive
    buffer, which the next call overwrites. The collective
    is synchronous on the current stream, so the next pack and the
    caller's reads of the views are ordered after it."""

    def __init__(self, mesh: ProcessMesh, to_next: Sequence[Payload],
                 to_prev: Sequence[Payload], axis: str):
        (nxt,), (prv,) = to_next, to_prev
        if any(t.dtype != torch.float32 for t in (*nxt, *prv)):
            raise ValueError("ring_pair: float32 payloads only")
        me = mesh.coords[0]
        size = dist.get_world_size(mesh.group)

        def rank(coord):   # the group rank of a shard
            return coord[0] * mesh.px + coord[1]

        dst_next = rank(mesh.shifted(me, axis, +1))
        dst_prev = rank(mesh.shifted(me, axis, -1))
        parts: list[list] = [[] for _ in range(size)]
        parts[dst_next] += nxt
        parts[dst_prev] += prv
        self.sources = [t for p in parts for t in p]
        self.counts = [sum(t.numel() for t in p) for p in parts]
        device = self.sources[0].device
        self.send = torch.empty(sum(self.counts), dtype=torch.float32,
                                device=device)
        self.pack = bind_strips(
            list(zip(self.sources, _views(self.send, self.sources))))
        # a shard's previous shard sends it its to_next, the next its
        # to_prev, each shaped as this shard's own
        n_next = sum(t.numel() for t in nxt)
        self.recv_counts = [0] * size
        self.recv_counts[dst_prev] += n_next
        self.recv_counts[dst_next] += sum(t.numel() for t in prv)
        self.recv = torch.empty(sum(self.recv_counts), dtype=torch.float32,
                                device=device)
        starts = [sum(self.recv_counts[:r]) for r in range(size)]
        # a ring of two: one chunk holds both, the to_next part first
        at_next = starts[dst_next] + (n_next if dst_next == dst_prev else 0)
        self.got = ([tuple(_views(self.recv[starts[dst_prev]:], nxt))],
                    [tuple(_views(self.recv[at_next:], prv))])
        self.mesh, self.payload = mesh, [*nxt, *prv]

    def __call__(self) -> tuple[list, list]:
        for copy in self.pack:
            copy()
        self.mesh._count(self.payload)
        dist.all_to_all_single(self.recv, self.send, self.recv_counts,
                               self.counts, group=self.mesh.group)
        return self.got
