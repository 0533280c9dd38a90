"""The halo exchange of the port's sharded kernel steppers on the CPU:
``parallel/halo.py`` ``_Bands`` and ``_Fill`` over ``parallel/mesh.py``
``pair_exchange``, and the strip copies they bind (``ops/halo_strips.py``).

The CUDA kernel ``csrc/halo_strips.cu`` runs only on the card
(``tests/test_torch_cuda.py``). Here the descriptors the wrapper builds
for it are applied by a plain ``as_strided`` gather and scatter and held
to the torch copies of the same pairs, element for element, for every
sharded form's strips. ``ProcessMesh`` over gloo, whose pack the same
binding makes, is held to the whole domain in
``tests/test_torch_weather_mesh.py``.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu_torch import ops  # noqa: E402
from njw_tpu_torch.ops import halo_strips  # noqa: E402
from njw_tpu_torch.ops.halo_strips import (  # noqa: E402
    CHUNK, MAX_STRIPS, StripDesc, bind_strips, copy_strips_cuda,
    copy_strips_plain, strip_descriptors,
)
from njw_tpu_torch.parallel import LocalMesh, halo  # noqa: E402
from njw_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from njw_tpu_torch.weather import GridSpec, PhysicsParams, SimConfig, \
    Simulation  # noqa: E402
from njw_tpu_torch.weather.primitive import pe_initial_state  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# form: (constructor, its keywords, mesh shape, (ny, nx)); the shards are
# ragged (odd widths) and 2-D meshes have 4 or 6 shards
FORMS = {
    "pe_stage_local": ("sharded_pe_step_kernel", {}, (4, 1), (20, 13)),
    "pe_stage_local2d": ("sharded_pe_step_kernel", {}, (2, 2), (14, 18)),
    "pe_stage_local2d_3x2": ("sharded_pe_step_kernel", {}, (3, 2),
                             (21, 10)),
    "swe_rk4_carry": ("sharded_swe_step_kernel", {}, (4, 1), (24, 13)),
    "swe_rk4_local2d": ("sharded_swe_step_kernel", {}, (2, 2), (14, 18)),
    "pe_rk4_carry": ("sharded_pe_step_kernel_fused", {}, (4, 1), (24, 13)),
    "pe_rk4_local2d": ("sharded_pe_step_kernel_fused", {}, (2, 2),
                       (14, 18)),
    "pe_rk4_carry2d": ("sharded_pe_step_kernel_fused_2d", {"carry": True},
                       (2, 2), (14, 18)),
}


def _stepper(form: str):
    """(stepper, mesh, shards) of ``form`` on a CPU LocalMesh."""
    ctor, kw, shape, (ny, nx) = FORMS[form]
    mesh = LocalMesh(*shape, device="cpu")
    if ctor == "sharded_swe_step_kernel":
        cfg = SimConfig(grid_width=nx, grid_height=ny, dt=0.01,
                        coriolis_f=1e-4, device="cpu")
        s0 = Simulation.from_config(cfg, "vortex", strength=2.0).state
        grid, params = cfg.grid_spec(), cfg.physics()
        dt = 0.01
    else:
        grid = GridSpec(nx=nx, ny=ny, levels=3, dx=1e5, dy=1e5)
        params = PhysicsParams(coriolis_f=1e-4)
        s0 = pe_initial_state(grid, device="cpu", u_jet=15.0, perturb=0.5)
        dt = 30.0
    step = getattr(halo, ctor)(grid, params, mesh, dt=dt, n_steps=2, **kw)
    return step, mesh, mesh.shard_state(s0)


def _recording(monkeypatch) -> list:
    """Every pair list the refreshes bind, in order."""
    bound, real = [], halo.bind_strips

    def record(pairs):
        bound.append(list(pairs))
        return real(bound[-1])

    monkeypatch.setattr(halo, "bind_strips", record)
    return bound


def _flat(storage) -> torch.Tensor:
    return torch.empty(0, dtype=torch.float32).set_(storage)


def _storages(pairs) -> dict:
    """{storage address: a flat float32 view of it} of every tensor."""
    return {t.untyped_storage().data_ptr(): _flat(t.untyped_storage())
            for p in pairs for t in p}


def _box(flats: dict, ptr: int, plane: int, row: int, d: StripDesc):
    """The strip at ``ptr`` with the pitches given, as a view of its
    storage made by ``as_strided`` alone."""
    for base, flat in flats.items():
        at = (ptr - base) // 4
        if 0 <= at < flat.numel():
            return flat.as_strided((d.planes, d.rows, d.cols),
                                   (plane, row, 1), at)
    raise AssertionError(f"no storage holds address {ptr}")


def _by_descriptors(pairs) -> None:
    """Each descriptor's strip gathered from its src and scattered into
    its dst, by ``as_strided`` views of the storages."""
    flats = _storages(pairs)
    descs = strip_descriptors(pairs)
    got = [_box(flats, d.src, d.src_plane, d.src_row, d).clone()
           for d in descs]
    for d, g in zip(descs, got):
        _box(flats, d.dst, d.dst_plane, d.dst_row, d).copy_(g)


def _same_moves(pairs) -> None:
    """The descriptors move exactly what the torch copies move: from
    storages of distinct random values, both leave every storage the
    same, element for element."""
    flats = _storages(pairs)
    gen = torch.Generator().manual_seed(5)
    before = {k: torch.randn(f.numel(), generator=gen) for k, f in
              flats.items()}
    for k, f in flats.items():
        f.copy_(before[k])
    copy_strips_plain(pairs)
    want = {k: f.clone() for k, f in flats.items()}
    assert any(not torch.equal(want[k], before[k]) for k in flats)
    for k, f in flats.items():
        f.copy_(before[k])
    _by_descriptors(pairs)
    for k, f in flats.items():
        assert torch.equal(f, want[k])


@pytest.mark.parametrize("form", sorted(FORMS))
def test_strip_descriptors_move_what_the_torch_copies_move(form,
                                                           monkeypatch):
    """Every pair list a form's refresh binds (the neighbours' strips into
    the bands, an axis each), and the same strips packed into a
    contiguous buffer and unpacked from it, as a ProcessMesh binds
    them."""
    bound = _recording(monkeypatch)
    step, mesh, shards = _stepper(form)
    step(shards)
    assert bound
    for pairs in bound:
        descs = strip_descriptors(pairs)
        assert len(descs) == len(pairs)
        assert [d.first for d in descs] == list(np.cumsum(
            [0] + [-(-s.numel() // CHUNK) for s, _ in pairs[:-1]]))
        _same_moves(pairs)
        strips = [s for s, _ in pairs]
        send = torch.empty(sum(s.numel() for s in strips))
        views = mesh_mod._views(send, strips)
        _same_moves(list(zip(strips, views)))
        _same_moves(list(zip(views, [d for _, d in pairs])))


def _corner_views(blocks: list, hy: int, hx: int) -> list:
    """The four halo corners of each padded block."""
    out = []
    for t in blocks:
        for rows in (slice(0, hy), slice(t.shape[-2] - hy, None)):
            for cols in (slice(0, hx), slice(t.shape[-1] - hx, None)):
                out.append(t[..., rows, cols])
    return out


@pytest.mark.parametrize("form", sorted(FORMS))
def test_each_form_sends_the_strips_its_kernel_reads(form, monkeypatch):
    """A refresh of a 2-D form sends x over the interior rows, then y
    over the full padded width, so the corners ride along: after it no
    corner holds what it held. The 1-D forms send y alone. One
    ``pair_exchange`` an axis, made at the first refresh."""
    made = []
    real = mesh_mod.LocalMesh.pair_exchange

    def record(self, to_next, to_prev, axis):
        made.append((axis, to_next, to_prev))
        return real(self, to_next, to_prev, axis)

    monkeypatch.setattr(mesh_mod.LocalMesh, "pair_exchange", record)
    step, mesh, shards = _stepper(form)
    step(shards)
    hy, hx = step.halo
    ly, lx = step.inner
    # one _Bands a padded state: the stage forms' four, the carry forms'
    # two, the others' one
    n_bands = 4 if form.startswith("pe_stage") else (
        2 if "carry" in form else 1)
    assert [a for a, _, _ in made] == (["x", "y"] if hx else ["y"]) * n_bands
    for axis, to_next, to_prev in made:
        for strips in (to_next, to_prev):
            assert len(strips) == mesh.size
            for t in strips[0]:
                assert t.shape[-2:] == ((ly, hx) if axis == "x"
                                        else (hy, lx + 2 * hx))
    if hx:
        blocks = [tuple(torch.randn(*t.shape[:-2], ly + 2 * hy, lx + 2 * hx)
                        for _, t in sh.items()) for sh in shards]
        bands = halo._Bands(blocks, (hy, hx), (ly, lx))
        corners = _corner_views([t for b in blocks for t in b], hy, hx)
        for c in corners:
            c.fill_(float("nan"))
        bands.refresh(mesh)
        assert not any(bool(torch.isnan(c).any()) for c in corners)


def test_a_fill_binds_once_and_again_where_other_tensors_arrive(
        monkeypatch):
    """A ``_Fill`` binds the copy of what its exchange returns at its
    first call, and again only where the exchange returns other tensors
    (as a fault that rolls what arrives does); every call copies what
    arrived then into the bands."""
    binds, real = [], halo.bind_strips

    def counted(pairs):
        binds.append(len(pairs))
        return real(pairs)

    monkeypatch.setattr(halo, "bind_strips", counted)
    src = torch.randn(2, 3, 4)
    bands = [torch.zeros(3, 4), torch.zeros(3, 4)]
    same = ([(src[0],)], [(src[1],)])
    fill = halo._Fill(lambda: same, bands)
    for _ in range(3):
        src.add_(1.0)
        fill()
        assert torch.equal(bands[0], src[0])
        assert torch.equal(bands[1], src[1])
    assert binds == [2]

    rolled = halo._Fill(lambda: ([(torch.roll(src[0], 1, dims=-2),)],
                                 [(src[1] * 2,)]), bands)
    for _ in range(2):
        src.add_(1.0)
        rolled()
        assert torch.equal(bands[0], torch.roll(src[0], 1, dims=-2))
        assert torch.equal(bands[1], src[1] * 2)
    assert binds == [2, 2, 2]


def test_the_descriptors_table_fits_the_kernels_parameters():
    """csrc/halo_strips.cu's Strip and Strips, as ctypes mirrors them
    (the card test holds them to the built library): under the 4 KiB of
    a launch's parameters."""
    assert ctypes.sizeof(halo_strips._Strip) == 48
    assert ctypes.sizeof(halo_strips._Strips) == 8 + 48 * MAX_STRIPS <= 4096


def test_descriptors_of_column_row_and_plane_strips():
    block = torch.zeros(3, 9, 11)
    ps = torch.zeros(9, 11)
    buf = torch.zeros(3 * 7 + 7 + 3 * 9)
    col, row, ps_col = block[:, 1:8, 9:10], block[:, 0:1, 1:10], \
        ps[1:8, 1:2]
    pairs = [(col, buf[:21].view(3, 7, 1)), (ps_col, buf[21:28].view(7, 1)),
             (row, buf[28:].view(3, 1, 9))]
    d = strip_descriptors(pairs)
    assert d[0] == StripDesc(col.data_ptr(), buf.data_ptr(), 99, 11, 7, 1,
                             3, 7, 1, 0)
    assert d[1] == StripDesc(ps_col.data_ptr(), buf.data_ptr() + 21 * 4, 0,
                             11, 0, 1, 1, 7, 1, 1)
    assert d[2] == StripDesc(row.data_ptr(), buf.data_ptr() + 28 * 4, 99,
                             11, 9, 9, 3, 1, 9, 2)
    assert halo_strips.chunks(d) == 3
    big = torch.zeros(2, 1000, 3)
    assert halo_strips.chunks(strip_descriptors(
        [(big[..., 1:2], torch.zeros(2, 1000, 1))])) == 2
    assert strip_descriptors([(torch.zeros(0, 4), torch.zeros(0, 4))]) == []


@pytest.mark.parametrize("src,dst,match", [
    (torch.zeros(3, 4), torch.zeros(4, 3), "target"),
    (torch.zeros(3, 4, dtype=torch.float64),
     torch.zeros(3, 4, dtype=torch.float64), "float32"),
    (torch.zeros(4, 3).t(), torch.zeros(3, 4), "consecutive"),
    (torch.zeros(2, 2, 3, 4), torch.zeros(2, 2, 3, 4), "2-D or 3-D")])
def test_strips_the_kernel_does_not_take_are_refused(src, dst, match):
    with pytest.raises(ValueError, match=match):
        strip_descriptors([(src, dst)])
    with pytest.raises(ValueError, match=match):
        bind_strips([(src, dst)])


def test_copies_on_the_cpu_are_the_torch_copies():
    """The CPU path binds one plain call of any number of strips (the
    kernel would take a launch per MAX_STRIPS); no launch is counted, and
    the CUDA wrapper refuses CPU tensors."""
    src = torch.randn(MAX_STRIPS + 5, 4, 6)
    dst = torch.zeros(MAX_STRIPS + 5, 4, 6)
    pairs = [(src[i, :, 1:2], dst[i, :, 0:1]) for i in range(len(src))]
    before = ops.launch_counts()["halo_strips"]
    (call,) = bind_strips(pairs)
    call()
    assert torch.equal(dst[..., 0], src[..., 1])
    assert torch.equal(dst[..., 1:], torch.zeros(len(src), 4, 5))
    assert bind_strips([]) == ()
    assert ops.launch_counts()["halo_strips"] == before
    assert ops.launch_counters()["halo_strips"] == (copy_strips_cuda,
                                                    "launches")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        copy_strips_cuda(pairs)


def test_local_mesh_counts_what_ring_shift_would():
    """On a LocalMesh a refresh counts one exchange a direction of each
    axis of more than one shard, with the strips' bytes (y over the full
    padded width), and enqueues no collective (no strip launch on the CPU
    either)."""
    step, mesh, shards = _stepper("pe_stage_local2d")
    mesh.exchanges = mesh.exchange_bytes = 0
    step(shards)
    ly, lx = step.inner
    per_stage = 2 * (ly + lx + 2) * (4 * 3 + 1) * 4 * mesh.size
    assert mesh.exchanges == 2 * 4 * 4        # 2 steps x 4 stages x 4
    assert mesh.exchange_bytes == 2 * 4 * per_stage
