"""Panel-pair sharded icosahedral SWE: one shard per rhombus pair.

Counterpart of ``njw_tpu/parallel/icosa.py``. The (10, n, n, ...) panels
regroup as (5, 2, n, n, ...) pairs (``to_pairs``): shard k of a 5-shard
'y' axis holds northern panel k and southern panel k. The 8 edge maps of
``weather/icosa.pad_halo`` become two ring exchanges (everything a shard
needs from k-1 rides one (3, n) message, everything from k+1 another)
plus two local copies (the N_k <-> S_k edges). The physics is the
whole-domain code of ``weather/icosa.py``: its operator generators run
one a shard, in lockstep, and each field they yield is padded here for
all shards at once.

The JAX package's ``fwd`` pairs ((k-1) % 5 -> k) are the port's
``ring_shift(..., shift=+1)`` (source i -> destination i + 1); its
``bwd`` pairs ((k+1) % 5 -> k) are ``shift=-1``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from njw_tpu_torch.weather.integrators import ListRK4
from njw_tpu_torch.weather.icosa import (
    IcosaOperators, IcosaSWEState, _tendency_parts,
)

AXIS = "y"
FROM_PREVIOUS, FROM_NEXT = +1, -1  # ring_shift of the k-1 -> k, k+1 -> k


def to_pairs(f: torch.Tensor) -> torch.Tensor:
    """(10, n, n, ...) -> (5, 2, n, n, ...): axis 0 the shard, index 1
    northern (0) or southern (1) panel k."""
    return torch.stack([f[:5], f[5:]], dim=1)


def from_pairs(f: torch.Tensor) -> torch.Tensor:
    """Inverse of to_pairs."""
    return torch.cat([f[:, 0], f[:, 1]], dim=0)


def pad_halo_pairs(fs: Sequence[torch.Tensor], mesh,
                   axis: str = AXIS) -> list:
    """The halo exchange of each local (2, n, n, ...) panel pair: a new
    (2, n+2, n+2, ...) each. From k-1 the message is [N(0,:), S(0,:),
    S(:,n-1)], from k+1 [N(:,0), N(n-1,:), S(n-1,:)]: the 8 edge maps of
    ``pad_halo``, grouped by source shard; both are posted before either
    is waited for."""
    n = fs[0].shape[1]
    m1_msgs = [(torch.stack([f[0, 0, :], f[1, 0, :], f[1, :, n - 1]]),)
               for f in fs]
    p1_msgs = [(torch.stack([f[0, :, 0], f[0, n - 1, :], f[1, n - 1, :]]),)
               for f in fs]
    from_prev = mesh.ring_shift_start(m1_msgs, axis, FROM_PREVIOUS)
    from_next = mesh.ring_shift_start(p1_msgs, axis, FROM_NEXT)
    out = []
    for f in fs:
        p = f.new_zeros((2, n + 2, n + 2) + tuple(f.shape[3:]))
        p[:, 1:-1, 1:-1] = f
        p[0, 1:-1, -1] = f[1, :, 0]        # (i,n)  = S_k(i,0)      local
        p[1, 1:-1, 0] = f[0, :, n - 1]     # (i,-1) = N_k(i,n-1)    local
        out.append(p)
    for p, (m1,), (p1,) in zip(out, from_prev.wait(), from_next.wait()):
        p[0, 1:-1, 0] = m1[0]              # (i,-1) = N_{k-1}(0,i)
        p[0, 0, 1:-1] = p1[0]              # (-1,j) = N_{k+1}(j,0)
        p[0, -1, 1:-1] = m1[1]             # (n,j)  = S_{k-1}(0,j)
        p[1, 0, 1:-1] = p1[1]              # (-1,j) = N_{k+1}(n-1,j)
        p[1, -1, 1:-1] = m1[2]             # (n,j)  = S_{k-1}(j,n-1)
        p[1, 1:-1, -1] = p1[2]             # (i,n)  = S_{k+1}(n-1,i)
    return out


def _check_mesh(mesh, axis):
    if axis != AXIS or mesh.px != 1 or mesh.axis_size(axis) != 5:
        raise ValueError(
            "icosahedral pair decomposition needs a 5-shard mesh axis "
            f"(a (5, 1) mesh along 'y'; got {mesh.shape} along {axis!r})")


def shard_icosa(ops: IcosaOperators, state: IcosaSWEState, mesh,
                axis: str = AXIS):
    """(local operators, local states): the pairs of this process's
    shards, on the mesh's device."""
    _check_mesh(mesh, axis)
    ks = mesh.axis_index(axis)

    def pair(a, k):
        return torch.stack([a[k], a[5 + k]]).to(mesh.device).contiguous()

    ops_l = [ops.map(lambda name, a, k=k: (
        torch.stack([a[:, k], a[:, 5 + k]], 1).to(mesh.device).contiguous()
        if name == "w" else a.to(mesh.device) if name == "radius"
        else pair(a, k))) for k in ks]
    st_l = [state.map(lambda a, k=k: pair(a, k)) for k in ks]
    return ops_l, st_l


def unshard_state(states: Sequence[IcosaSWEState], mesh) -> IcosaSWEState:
    """The (10, n, n, ...) state from the five pairs (all-gathered across
    the ranks of a ProcessMesh)."""
    if len(states) == 5:
        pairs = {name: [getattr(s, name) for s in states]
                 for name in IcosaSWEState.FIELDS}
    else:
        (mine,) = states
        pairs = {}
        for name, t in mine.items():
            pairs[name] = [torch.empty_like(t) for _ in range(5)]
            dist.all_gather(pairs[name], t.contiguous(), group=mesh.group)
    return IcosaSWEState(**{name: from_pairs(torch.stack(parts))
                            for name, parts in pairs.items()})


def _lockstep(gens: list, pad) -> list:
    """Drive one operator generator a shard together: each round, the
    fields they yield are padded at once by ``pad`` (a list -> list)."""
    xs = [next(g) for g in gens]
    while True:
        padded = pad(xs)
        xs, done = [], []
        for g, p in zip(gens, padded):
            try:
                xs.append(g.send(p))
            except StopIteration as fin:
                done.append(fin.value)
        if done:
            if len(done) != len(gens):
                raise RuntimeError("the shards' operators fell out of step")
            return done


def sharded_icosa_swe_step(ops: Sequence[IcosaOperators], mesh, *,
                           g: float = 9.80616, omega: float,
                           nu: float = 0.0, n_steps: int = 1,
                           axis: str = AXIS) -> ListRK4:
    """The multi-shard icosahedral SWE stepper over a 5-shard mesh axis
    (one rhombus pair a shard): ``step(states, dt)``, ``n_steps`` RK4
    steps of the local panel pairs. ``ops`` and ``states``: the local
    operators and states of ``shard_icosa``."""
    _check_mesh(mesh, axis)
    ops = list(ops)

    def tendency(states):
        return _lockstep([_tendency_parts(s, o, g, omega, nu)
                          for s, o in zip(states, ops)],
                         lambda fs: pad_halo_pairs(fs, mesh, axis))

    return ListRK4("sharded_icosa_swe_rk4", tendency, n_steps)
