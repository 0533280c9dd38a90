"""The tile rules of the stage kernels K5 (csrc/pe_stage.cu) and K3
(csrc/baro_stage.cu), on the CPU: the Python rules against the constants
and static_asserts of the sources, and the launch arguments the wrappers
pass (the launch itself replaced by a recorder; the card tests in
tests/test_torch_cuda.py hold the built kernels to the rules)."""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu_torch.ops import _bound, _build  # noqa: E402
from njw_tpu_torch.ops import baro_stencil as bs  # noqa: E402
from njw_tpu_torch.ops import pe_stencil as ps  # noqa: E402
from njw_tpu_torch.ops.stencil import SMEM_PER_BLOCK  # noqa: E402
from njw_tpu_torch.weather import GridSpec  # noqa: E402
from njw_tpu_torch.weather.primitive import PEState  # noqa: E402

CSRC = Path(_build.CSRC)


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr (?:long long|int) {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, name
    return int(m.group(1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestStageTileRule:
    def test_constants_mirror_the_source(self):
        assert _constant("pe_stage.cu", "kMaxLevels") == ps.STAGE_MAX_LEVELS
        assert _constant("pe_stage.cu", "SLOTS") == ps.STAGE_SLOTS
        assert _constant("pe_stage.cu", "TX") == ps.STAGE_TILE_COLUMNS
        assert "constexpr int PX = TX + 8;" in (CSRC / "pe_stage.cu"
                                                ).read_text()
        assert ps.STAGE_REGION_PITCH == ps.STAGE_TILE_COLUMNS + 8
        assert _constant("pe_stage.cu", "kSmemMax") == SMEM_PER_BLOCK

    @pytest.mark.parametrize("levels", range(1, ps.STAGE_MAX_LEVELS + 1))
    def test_every_level_count_fits_a_block(self, levels):
        rows = ps.stage_tile_rows(levels)
        assert rows in ps.STAGE_TILE_ROWS
        assert ps.stage_smem_bytes(rows, levels) <= SMEM_PER_BLOCK
        # the most threads an SM, the taller on a tie
        best = ps.stage_resident_threads(rows, levels)
        assert best > 0
        for r in ps.STAGE_TILE_ROWS:
            held = ps.stage_resident_threads(r, levels)
            assert held < best or (held == best and r <= rows), r
        assert ps.stage_kernel_fits(levels)

    def test_the_source_asserts_the_same_bounds(self):
        text = (CSRC / "pe_stage.cu").read_text()
        for levels, rows in re.findall(r"tile_rows\((\d+)\) == (\d)", text):
            assert ps.stage_tile_rows(int(levels)) == int(rows), levels
        assert "tile_rows(kMaxLevels) == 1" in text
        assert len(re.findall(r"tile_rows\((\d+)\) == (\d)", text)) >= 6
        assert ps.stage_tile_rows(ps.STAGE_MAX_LEVELS) == 1
        assert "tile_rows(kMaxLevels + 1) == 0" in text

    @pytest.mark.parametrize("levels", [0, -1, ps.STAGE_MAX_LEVELS + 1, 1000])
    def test_refuses_what_the_source_refuses(self, levels):
        with pytest.raises(ValueError):
            ps.stage_tile_rows(levels)
        assert not ps.stage_kernel_fits(levels)

    def test_bytes_match_the_source_formula(self):
        # ring of 5 levels x 4 fields on (rows + 2) x 72, cum, offsets
        assert ps.stage_smem_bytes(4, 40) == (4 * 5 * 4 * 6 * 72
                                              + 4 * 40 * 256 + 12 * 6
                                              + 4 * 66)
        assert ps.stage_smem_bytes(1, 454) == 133804


@contextlib.contextmanager
def _recorded(name: str):
    """Replace ``name``'s bound launch by a recorder of its arguments and
    CUDA's device and stream (``_bound.launch_on``) by a stand-in, so that
    the launch path runs on CPU tensors."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    saved = _build._bound.get(name)
    _build._bound[name] = (launch, lambda err: b"")
    launch_on = _bound.launch_on
    _bound.launch_on = lambda index, entry: entry(0)
    try:
        yield calls
    finally:
        _bound.launch_on = launch_on
        if saved is None:
            _build._bound.pop(name, None)
        else:
            _build._bound[name] = saved


def _state(L, ny, nx, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.uniform(1, 2, shape).astype(np.float32))

    return PEState(u=f(L, ny, nx), v=f(L, ny, nx), T=f(L, ny, nx),
                   q=f(L, ny, nx), ps=f(ny, nx))


class TestStageLaunchArguments:
    def test_whole_domain_takes_the_rule(self):
        for levels in (2, 40, 202, 454):
            grid = GridSpec(nx=6, ny=5, levels=levels)
            s = _state(levels, 5, 6)
            with _recorded("pe_stage") as calls:
                ps._launch_stage(s, (s,), (1.0,), s.map(torch.empty_like),
                                 None, grid, ps.column_constants(grid, 0.0),
                                 1.0, ps.level_constants(levels, "cpu"))
            assert calls[0][-2] == ps.stage_tile_rows(levels)
            assert len(calls[0]) == len(ps._STAGE_ARGTYPES)

    @pytest.mark.parametrize("halo", [(1, 0), (1, 1), (3, 2)])
    def test_padded_forms_take_the_rule(self, halo):
        levels, ly, lx = 40, 7, 9
        hy, hx = halo
        cur = _state(levels, ly + 2 * hy, lx + 2 * hx)
        base = _state(levels, ly, lx, 1)
        args = ps._stage_padded_args(cur, base, halo=halo, c_dt=1.0)
        with _recorded("pe_stage") as calls:
            ps._launch_stage(*args)
        a = calls[0]
        assert a[-2] == ps.stage_tile_rows(levels) == 4
        # the interior's origin and the halo flags
        assert a[8:10] == (hy, hx)
        assert a[-12:-10] == (int(hy > 0), int(hx > 0))

    def test_other_heights_only_where_they_fit(self):
        grid = GridSpec(nx=6, ny=5, levels=300)
        s = _state(300, 5, 6)
        kw = (s, (s,), (1.0,), s.map(torch.empty_like), None, grid,
              ps.column_constants(grid, 0.0), 1.0,
              ps.level_constants(300, "cpu"))
        with _recorded("pe_stage") as calls:
            ps._launch_stage(*kw, tile_rows=2)
            for rows in (4, 3, 8):
                with pytest.raises(ValueError):
                    ps._launch_stage(*kw, tile_rows=rows)
        assert [c[-2] for c in calls] == [2]

    def test_padded_refuses_past_the_reach(self):
        cur = _state(ps.STAGE_MAX_LEVELS + 1, 5, 6)
        base = _state(ps.STAGE_MAX_LEVELS + 1, 3, 6, 1)
        with pytest.raises(ValueError, match="do not fit"):
            ps._stage_padded_args(cur, base, halo=(1, 0), c_dt=1.0)


class TestBaroStripRule:
    def test_strips_mirror_the_source(self):
        text = (CSRC / "baro_stage.cu").read_text()
        m = re.search(r"kStrips\[\]\[2\] = \{(.*?)\};", text, re.S)
        built = tuple(tuple(int(x) for x in pair) for pair in
                      re.findall(r"\{(\d+), (\d+)\}", m.group(1)))
        assert built == bs.BARO_STRIPS

    @pytest.mark.parametrize("nx,aligned,want", [
        (1024, True, (4, 4)), (5, True, (1, 4)), (1026, True, (1, 4)),
        (1024, False, (1, 4)), (8, True, (4, 4))])
    def test_rule(self, nx, aligned, want):
        assert bs.BARO_STRIPS[bs.baro_strip(nx, aligned)] == want

    def test_the_launch_takes_the_rule(self):
        grid = GridSpec(nx=8, ny=5)
        z = torch.zeros(5, 8)
        k = bs.baro_constants(grid, 0.1, 0.0, 0.0)
        with _recorded("baro_stage") as calls:
            bs._launch(z, z, z, torch.empty_like(z), grid, k)
            bs._launch(z, z, z, torch.empty_like(z), grid, k, 1)
        assert [c[-2] for c in calls] == [-1, 1]
        assert all(len(c) == len(bs._ARGTYPES) for c in calls)
