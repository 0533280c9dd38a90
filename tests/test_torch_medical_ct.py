"""The port's CT module held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances, normalised by the largest |value|
of the JAX output: the Radon transform, FBP with each ramp window and
SIRT 1e-5 (float32 gathers and sums in another order: measured 2e-7 to
5e-7); cone-beam projection and FDK 1e-5 (measured 1.3e-6); FDK over
chunks of views against JAX's one sum over all views at the same 1e-5
(only the order of the view sum differs); the chunked projection equal
to the whole one bit for bit (views are independent). The JAX file's own
CT tests run again on the port, parametrised where they repeat.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")


import njw_tpu.geospatial as jgeo  # noqa: E402
import njw_tpu.medical as jm  # noqa: E402
from njw_tpu.medical import ct as jct  # noqa: E402

import njw_tpu_torch.geospatial as tgeo  # noqa: E402
import njw_tpu_torch.medical as tm  # noqa: E402
from njw_tpu_torch.medical import ct as tct  # noqa: E402
from njw_tpu_torch.medical.main_paths import (  # noqa: E402
    ball_volume, disk_phantom, insert_phantom,
)

CPU = "cpu"
REL = 1e-5
SOD, SDD = 48.0, 96.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(jax_out, port_out) -> float:
    a = np.asarray(jax_out, np.float64)
    b = port_out.detach().cpu().numpy().astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _angles(n, span=np.pi):
    return np.linspace(0, span, n, endpoint=False).astype(np.float32)


@pytest.mark.parametrize("name", ["medical", "geospatial"])
def test_subpackage_exports_every_jax_name(name):
    jax_pkg, port_pkg = {"medical": (jm, tm),
                         "geospatial": (jgeo, tgeo)}[name]
    # the exported names (submodules are attributes only once imported)
    names = {n for n in dir(jax_pkg) if not n.startswith("_")
             and not inspect.ismodule(getattr(jax_pkg, n))}
    assert len(names) >= 16
    assert sorted(n for n in names if not hasattr(port_pkg, n)) == []
    assert set(port_pkg.__all__) >= names


class TestAgainstJax:
    @pytest.mark.parametrize("n,n_angles,nd", [(32, 12, 0), (48, 40, 0),
                                               (40, 18, 50)])
    def test_radon(self, n, n_angles, nd):
        img = insert_phantom(n)
        ang = _angles(n_angles)
        assert _rel(jm.radon(img, ang, n_detectors=nd),
                    tm.radon(img, ang, n_detectors=nd, device=CPU)) <= REL

    @pytest.mark.parametrize("kind", ["ramlak", "shepp_logan", "cosine",
                                      "hann"])
    @pytest.mark.parametrize("out", [0, 40])
    def test_fbp(self, kind, out):
        img = insert_phantom(48)
        ang = _angles(40)
        sino = np.asarray(jm.radon(img, ang))
        assert _rel(jm.filtered_backprojection(sino, ang, output_size=out,
                                               filter_kind=kind),
                    tm.filtered_backprojection(sino, ang, output_size=out,
                                               filter_kind=kind,
                                               device=CPU)) <= REL

    @pytest.mark.parametrize("kind", ["ramlak", "shepp_logan", "cosine",
                                      "hann"])
    def test_ramp_filter(self, kind):
        assert _rel(jct._ramp_filter(37, kind),
                    tct._ramp_filter(37, kind)) <= 1e-6

    def test_ramp_filter_refuses_an_unknown_kind(self):
        with pytest.raises(ValueError, match="unknown filter kind"):
            tct._ramp_filter(8, "parzen")

    @pytest.mark.parametrize("iters,relax", [(5, 1.0), (3, 0.5)])
    def test_sirt(self, iters, relax):
        img = insert_phantom(32)
        ang = _angles(24)
        sino = np.asarray(jm.radon(img, ang))
        assert _rel(jm.sirt(sino, ang, n_iterations=iters,
                            relaxation=relax),
                    tm.sirt(sino, ang, n_iterations=iters,
                            relaxation=relax, device=CPU)) <= REL

    def test_cone_beam_project(self):
        vol = ball_volume(24)
        ang = _angles(10, 2 * np.pi)
        assert _rel(jct.cone_beam_project(vol, ang, sod=SOD, sdd=SDD,
                                          det_shape=(20, 28)),
                    tct.cone_beam_project(vol, ang, sod=SOD, sdd=SDD,
                                          det_shape=(20, 28),
                                          device=CPU)) <= REL

    def test_cone_project_chunked_equals_whole(self, monkeypatch):
        vol = torch.from_numpy(ball_volume(24))
        ang = torch.from_numpy(_angles(10, 2 * np.pi))
        whole = tct.cone_beam_project(vol, ang, sod=SOD, sdd=SDD,
                                      det_shape=(24, 24))
        per_view = 36 * 24 * 24          # samples x detector pixels
        for views in (1, 3, 7):
            monkeypatch.setattr(tct, "CHUNK_ELEMENTS", views * per_view)
            assert len(tct._view_chunks(10, per_view)) == -(-10 // views)
            assert torch.equal(whole, tct.cone_beam_project(
                vol, ang, sod=SOD, sdd=SDD, det_shape=(24, 24)))

    @pytest.mark.parametrize("views", [0, 4, 1])
    def test_fdk_whole_and_chunked(self, monkeypatch, views):
        vol = ball_volume(24)
        ang = _angles(10, 2 * np.pi)
        proj = np.asarray(jct.cone_beam_project(vol, ang, sod=SOD, sdd=SDD,
                                                det_shape=(24, 24)))
        want = jct.fdk_reconstruct(proj, ang, sod=SOD, sdd=SDD,
                                   output_size=20)
        if views:
            monkeypatch.setattr(tct, "CHUNK_ELEMENTS", views * 20 ** 3)
        got = tct.fdk_reconstruct(proj, ang, sod=SOD, sdd=SDD,
                                  output_size=20, device=CPU)
        assert _rel(want, got) <= REL

    @pytest.mark.parametrize("method,kw", [
        ("fbp", {}), ("filtered_backprojection", {"filter_kind": "hann"}),
        ("sirt", {"n_iterations": 3}), ("iterative", {"n_iterations": 2})])
    def test_reconstruct_ct(self, method, kw):
        img = insert_phantom(32)
        ang = _angles(30)
        sino = np.asarray(jm.radon(img, ang))
        assert _rel(jm.reconstruct_ct(sino, ang, method, **kw),
                    tm.reconstruct_ct(sino, ang, method, device=CPU,
                                      **kw)) <= REL

    def test_reconstruct_ct_refuses_an_unknown_method(self):
        with pytest.raises(ValueError, match="unknown CT method"):
            tm.reconstruct_ct(np.zeros((4, 8), np.float32), _angles(4),
                              "magic", device=CPU)

    def test_tensor_input_stays_on_its_device(self):
        img = torch.from_numpy(insert_phantom(16))
        out = tm.radon(img, torch.from_numpy(_angles(4)))
        assert out.device == img.device and out.dtype == torch.float32


class TestInvariants:
    """tests/test_medical.py's CT and cone-beam tests, on the port."""

    def test_radon_of_disk_is_symmetric(self):
        angles = _angles(8)
        sino = tm.radon(insert_phantom(64), angles, device=CPU).numpy()
        assert sino.shape == (8, 64)
        sino_d = tm.radon(disk_phantom(64), angles, device=CPU).numpy()
        assert np.std(sino_d, axis=0).max() / sino_d.max() < 0.05

    @pytest.mark.parametrize("kind", ["ramlak", "shepp_logan", "cosine",
                                      "hann"])
    def test_fbp_reconstructs_phantom(self, kind):
        img = insert_phantom(64)
        angles = _angles(90)
        rec = tm.filtered_backprojection(tm.radon(img, angles, device=CPU),
                                         angles, filter_kind=kind).numpy()
        assert rec.shape == img.shape and np.all(np.isfinite(rec))
        if kind == "ramlak":
            assert np.corrcoef(rec.ravel(), img.ravel())[0, 1] > 0.9

    def test_sirt_improves_with_iterations(self):
        img = insert_phantom(32)
        angles = _angles(45)
        sino = tm.radon(img, angles, device=CPU)
        e = [float(((tm.sirt(sino, angles, n_iterations=k) - torch.from_numpy(
            img)) ** 2).mean()) for k in (5, 40)]
        assert e[1] < e[0]

    def test_cone_projection_symmetry(self):
        vol = ((np.mgrid[0:32, 0:32, 0:32].astype(np.float32) - 15.5) ** 2
               ).sum(0) < 36
        proj = tct.cone_beam_project(vol.astype(np.float32),
                                     _angles(8, 2 * np.pi), sod=80.0,
                                     sdd=120.0, det_shape=(48, 48),
                                     device=CPU).numpy()
        assert proj.shape == (8, 48, 48)
        np.testing.assert_allclose(proj[0], proj[4], atol=1e-2)
        cy, cx = np.unravel_index(proj[0].argmax(), proj[0].shape)
        assert abs(cy - 23.5) < 2 and abs(cx - 23.5) < 2

    def test_fdk_reconstructs_ball(self):
        n = 32
        vol = (((np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - 15.5) ** 2
                ).sum(0) < 36).astype(np.float32)
        angles = _angles(36, 2 * np.pi)
        proj = tct.cone_beam_project(vol, angles, sod=80.0, sdd=120.0,
                                     det_shape=(48, 48), device=CPU)
        rec = tct.fdk_reconstruct(proj, angles, sod=80.0, sdd=120.0,
                                  output_size=n).numpy()
        a = (rec - rec.mean()).ravel()
        b = (vol - vol.mean()).ravel()
        assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.8
        c = n // 2
        assert rec[c, c, c] > 3 * abs(rec[2, 2, 2])
