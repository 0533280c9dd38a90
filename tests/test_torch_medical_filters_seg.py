"""The port's filters, segmentation and image IO held against the JAX
package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances: the convolutions, gaussian,
bilateral and NLM filters at 1e-5 of the JAX output's largest |value|
(measured 1e-7 to 4e-7: XLA's and cuDNN's / PyTorch's convolution sums
in another order); the median, every threshold, region growing,
watershed and the MRF labels exactly equal; Otsu's value and
``gaussian_kernel`` bit for bit (NumPy in both). Chan-Vese is held to a
share of differing mask pixels: its level set's curvature term divides
by |grad phi|^3 + 1e-8, which amplifies rounding ~10x an iteration, so
two float32 evaluations part (XLA's sin and PyTorch's differ in the last
bit on 29 of 512 checkerboard arguments) and the masks differ in 0.07% to
0.3% of pixels after 10 iterations and 4% to 6% after 100; the JAX
package against itself on an input one ulp away parts the same way (the
test below), so the bounds are 0.5% at 10 and 8% at 100. The JAX file's
own tests run again on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import njw_tpu.medical as jm  # noqa: E402

import njw_tpu_torch.medical as tm  # noqa: E402
from njw_tpu_torch.medical import convert, filters as tf  # noqa: E402
from njw_tpu_torch.medical.main_paths import (  # noqa: E402
    insert_phantom, two_basins,
)

CPU = "cpu"
REL = 1e-5
CV_SHARE = {10: 5e-3, 100: 8e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(jax_out, port_out) -> float:
    a = np.asarray(jax_out, np.float64)
    b = port_out.detach().cpu().numpy().astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _equal(jax_out, port_out):
    np.testing.assert_array_equal(port_out.cpu().numpy(), np.asarray(jax_out))


def _noisy(n=48, sigma=0.2, seed=1):
    rng = np.random.default_rng(seed)
    return insert_phantom(n) + sigma * rng.standard_normal(
        (n, n)).astype(np.float32)


class TestFiltersAgainstJax:
    @pytest.mark.parametrize("shape", [(3, 3), (4, 5), (2, 2), (1, 7)])
    def test_convolve2d(self, shape):
        k = np.random.default_rng(2).standard_normal(shape).astype(
            np.float32)
        img = _noisy()
        assert _rel(jm.convolve2d(img, k),
                    tm.convolve2d(img, k, device=CPU)) <= REL

    @pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0])
    def test_gaussian(self, sigma):
        from njw_tpu.medical import filters as jf

        np.testing.assert_array_equal(tf.gaussian_kernel(sigma),
                                      jf.gaussian_kernel(sigma))
        img = _noisy()
        assert _rel(jm.gaussian_filter(img, sigma),
                    tm.gaussian_filter(img, sigma, device=CPU)) <= REL

    @pytest.mark.parametrize("size", [3, 5])
    def test_median_equal(self, size):
        img = _noisy()
        _equal(jm.median_filter(img, size),
               tm.median_filter(img, size, device=CPU))

    @pytest.mark.parametrize("size,ss,si", [(5, 2.0, 0.2), (3, 1.0, 0.1)])
    def test_bilateral(self, size, ss, si):
        img = _noisy()
        assert _rel(jm.bilateral_filter(img, size, ss, si),
                    tm.bilateral_filter(img, size, ss, si,
                                        device=CPU)) <= REL

    @pytest.mark.parametrize("sr,pr,h", [(3, 1, 0.3), (2, 2, 0.1)])
    def test_nlm(self, sr, pr, h):
        img = _noisy(32)
        assert _rel(jm.nlm_filter(img, sr, pr, h),
                    tm.nlm_filter(img, sr, pr, h, device=CPU)) <= REL

    @pytest.mark.parametrize("shape", [(24, 20), (3, 24, 20),
                                       (2, 2, 16, 12)])
    @pytest.mark.parametrize("method,kw", [
        ("gaussian", {"sigma": 1.5}), ("median", {"size": 3}),
        ("bilateral", {}), ("nlm", {"search_radius": 2}),
        ("non_local_means", {"search_radius": 1})])
    def test_apply_filter(self, shape, method, kw):
        x = np.random.default_rng(3).random(shape).astype(np.float32)
        assert _rel(jm.apply_filter(x, method, **kw),
                    tm.apply_filter(x, method, device=CPU, **kw)) <= REL

    def test_apply_filter_takes_a_medical_image(self):
        x = _noisy(16)
        img = tm.MedicalImage(torch.from_numpy(x), modality="CT")
        assert _rel(jm.apply_filter(x, "gaussian"),
                    tm.apply_filter(img, "gaussian")) <= REL

    def test_apply_filter_refuses_an_unknown_method(self):
        with pytest.raises(ValueError, match="unknown filter"):
            tm.apply_filter(np.zeros((4, 4), np.float32), "wiener",
                            device=CPU)


class TestSegmentationAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_otsu_bit_equal(self, seed):
        img = _noisy(48, 0.3, seed)
        assert tm.otsu_threshold(img) == jm.otsu_threshold(img)
        assert tm.otsu_threshold(np.ones((4, 4))) == 1.0

    @pytest.mark.parametrize("value,high,low", [(0.5, 1.0, 0.0),
                                                (0.2, 3.0, -1.0)])
    def test_threshold_equal(self, value, high, low):
        img = _noisy()
        _equal(jm.threshold(img, value, high, low),
               tm.threshold(img, value, high, low, device=CPU))

    @pytest.mark.parametrize("offset", [0.0, 0.1])
    def test_adaptive_equal(self, offset):
        from njw_tpu.medical import segmentation as js
        from njw_tpu_torch.medical import segmentation as ts

        img = _noisy()
        _equal(js.adaptive_threshold(img, offset=offset),
               ts.adaptive_threshold(img, offset=offset, device=CPU))

    def test_adaptive_with_a_block_sigma(self):
        """JAX's jitted adaptive_threshold traces block_sigma, and its
        gaussian_kernel needs int(3 * sigma): passing one raises
        (ROADMAP.md section 3). The port takes it, and equals the
        threshold against JAX's gaussian filter at that sigma."""
        import jax
        from njw_tpu.medical import segmentation as js
        from njw_tpu_torch.medical import segmentation as ts

        img = _noisy()
        with pytest.raises(jax.errors.ConcretizationTypeError):
            js.adaptive_threshold(img, 2.0)
        want = np.where(img >= np.asarray(jm.gaussian_filter(img, 2.0))
                        + 0.1, 1.0, 0.0)
        np.testing.assert_array_equal(
            ts.adaptive_threshold(img, 2.0, 0.1, device=CPU).numpy(), want)

    @pytest.mark.parametrize("seed_yx,tol,iters", [((24, 24), 0.5, 64),
                                                   ((10, 30), 0.3, 256)])
    def test_region_growing_equal(self, seed_yx, tol, iters):
        img = _noisy()
        _equal(jm.region_growing(img, seed_yx, tol, iters),
               tm.region_growing(img, seed_yx, tol, iters, device=CPU))

    def test_watershed_equal(self):
        elev, markers = two_basins(32)
        _equal(jm.watershed(elev, markers),
               tm.watershed(elev, markers, device=CPU))
        rng = np.random.default_rng(4)
        rough = rng.random((40, 40)).astype(np.float32)
        rough[::7] = 0.5          # ties between neighbours
        marks = np.zeros((40, 40), np.int32)
        marks[5, 5], marks[30, 30], marks[10, 33] = 1, 2, 3
        _equal(jm.watershed(rough, marks, n_iterations=60),
               tm.watershed(rough, marks, n_iterations=60, device=CPU))

    @pytest.mark.parametrize("beta,iters", [(0.3, 20), (1.0, 5)])
    def test_mrf_equal(self, beta, iters):
        img = _noisy(48, 0.3, 3)
        _equal(jm.mrf_segment(img, 0.5, beta, iters),
               tm.mrf_segment(img, 0.5, beta, iters, device=CPU))

    @pytest.mark.parametrize("iters", [10, 100])
    @pytest.mark.parametrize("n,sigma", [(48, 0.2), (64, 0.0)])
    def test_chan_vese_share(self, iters, n, sigma):
        img = _noisy(n, sigma)
        a = np.asarray(jm.chan_vese(img, iters))
        b = tm.chan_vese(img, iters, device=CPU).numpy()
        assert set(np.unique(b)) <= {0.0, 1.0}
        assert (a != b).mean() <= CV_SHARE[iters]

    def test_jax_chan_vese_parts_from_itself_one_ulp_away(self):
        """The reference's own spread: JAX on the image and on the image
        raised by one ulp differ by a share of the same order as the port
        and JAX do."""
        img = _noisy(64, 0.2)
        up = np.nextafter(img, np.float32(np.inf)).astype(np.float32)
        spread = (np.asarray(jm.chan_vese(img, 100))
                  != np.asarray(jm.chan_vese(up, 100))).mean()
        assert spread > 1e-3

    @pytest.mark.parametrize("method,kw", [
        ("threshold", {}), ("threshold", {"value": 0.4}), ("otsu", {}),
        ("adaptive", {}), ("region_growing", {"seed_yx": (24, 24)}),
        ("graph_cut", {"beta": 0.3}), ("mrf", {"threshold_value": 0.5}),
        ("level_set", {"n_iterations": 3}),
        ("chan_vese", {"n_iterations": 2})])
    def test_apply_segmentation(self, method, kw):
        img = _noisy()
        _equal(jm.apply_segmentation(img, method, **dict(kw)),
               tm.apply_segmentation(img, method, device=CPU, **dict(kw)))

    def test_apply_segmentation_watershed(self):
        elev, markers = two_basins(24)
        _equal(jm.apply_segmentation(elev, "watershed", markers=markers),
               tm.apply_segmentation(elev, "watershed", markers=markers,
                                     device=CPU))

    def test_apply_segmentation_refuses_an_unknown_method(self):
        with pytest.raises(ValueError, match="unknown segmentation"):
            tm.apply_segmentation(np.zeros((4, 4), np.float32), "snake",
                                  device=CPU)


class TestImageIO:
    @pytest.mark.parametrize("ext", [".npz", ".npy"])
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_round_trip_between_packages(self, tmp_path, ext, writer):
        data = _noisy(16)
        path = str(tmp_path / f"a{ext}")
        if writer == "jax":
            jm.save_image(path, jm.MedicalImage(jnp.asarray(data)))
            back = tm.load_image(path, modality="CT", device=CPU)
            assert back.modality == "CT" and back.data.dtype == torch.float32
            np.testing.assert_array_equal(back.data.numpy(), data)
        else:
            tm.save_image(path, tm.MedicalImage(torch.from_numpy(data)))
            back = jm.load_image(path, modality="CT")
            np.testing.assert_array_equal(np.asarray(back.data), data)

    def test_float64_and_int64_load_as_32_bit(self, tmp_path):
        for arr in (np.arange(6.0).reshape(2, 3), np.arange(6).reshape(2, 3)):
            p = str(tmp_path / "x.npy")
            np.save(p, arr)
            j, t = jm.load_image(p), tm.load_image(p, device=CPU)
            assert str(t.data.dtype).split(".")[-1] == str(j.data.dtype)

    def test_png_round_trip(self, tmp_path):
        pytest.importorskip("matplotlib")
        p = str(tmp_path / "a.png")
        tm.save_image(p, torch.from_numpy(insert_phantom(16)))
        back = tm.load_image(p, device=CPU)
        assert back.shape == (16, 16)
        assert float(back.data.max()) > float(back.data.min())

    def test_image_methods_and_statistics(self):
        data = np.random.default_rng(5).random((2, 3, 8, 8)).astype(
            np.float32)
        j = jm.MedicalImage(jnp.asarray(data), (1.0, 0.5, 0.5), "MRI")
        t = tm.MedicalImage(torch.from_numpy(data), (1.0, 0.5, 0.5), "MRI")
        assert t.statistics() == j.statistics()
        assert t.ndim == j.ndim and t.shape == j.shape
        np.testing.assert_array_equal(t.slice2d(4).numpy(),
                                      np.asarray(j.slice2d(4)))
        assert t.astype(torch.float64).data.dtype == torch.float64

    def test_unsupported_format(self, tmp_path):
        with pytest.raises(ValueError):
            tm.load_image(str(tmp_path / "x.dcm"), device=CPU)
        with pytest.raises(ValueError):
            tm.save_image(str(tmp_path / "x.dcm"), np.zeros((2, 2)))

    def test_convert_round_trip(self):
        j = jm.MedicalImage(jnp.asarray(_noisy(8)), (2.0, 1.0, 1.0), "CT",
                            {"id": 3})
        t = convert.image_from(j, device=CPU)
        assert (t.spacing, t.modality, t.metadata) == ((2.0, 1.0, 1.0), "CT",
                                                       {"id": 3})
        back = jm.MedicalImage(**{k: (jnp.asarray(v) if k == "data" else v)
                                  for k, v in convert.image_fields(t).items()})
        np.testing.assert_array_equal(np.asarray(back.data),
                                      np.asarray(j.data))


class TestInvariants:
    """tests/test_medical.py's filter and segmentation tests, on the
    port."""

    def test_gaussian_smooths(self):
        noisy = _noisy(64, 0.3, 0)
        assert float(tm.gaussian_filter(noisy, 1.5, device=CPU).std()) \
            < noisy.std()

    def test_median_removes_salt_pepper(self):
        img = insert_phantom(64)
        noisy = img.copy()
        noisy[::7, ::7] = 5.0
        den = tm.median_filter(noisy, 3, device=CPU).numpy()
        assert ((den - img) ** 2).mean() < ((noisy - img) ** 2).mean() * 0.2

    def test_bilateral_preserves_edges(self):
        img = insert_phantom(64)
        noisy = _noisy(64, 0.05, 1)
        bf = tm.bilateral_filter(noisy, 5, 2.0, 0.2, device=CPU).numpy()
        gf = tm.gaussian_filter(noisy, 2.0, device=CPU).numpy()
        assert ((bf - img) ** 2).mean() < 0.2 * ((gf - img) ** 2).mean()
        assert ((bf - img) ** 2).mean() < ((noisy - img) ** 2).mean()

    def test_nlm_denoises(self):
        img = insert_phantom(48)
        noisy = _noisy(48, 0.2, 2)
        den = tm.nlm_filter(noisy, search_radius=3, h=0.3,
                            device=CPU).numpy()
        assert ((den - img) ** 2).mean() < ((noisy - img) ** 2).mean() * 0.6

    def test_convolve2d_identity(self):
        img = insert_phantom(16)
        k = np.zeros((3, 3), np.float32)
        k[1, 1] = 1.0
        np.testing.assert_allclose(tm.convolve2d(img, k, device=CPU), img,
                                   atol=1e-6)

    def test_otsu_separates_bimodal(self):
        assert 0.1 < tm.otsu_threshold(insert_phantom(64) + 0.01) < 1.1

    def test_region_growing_fills_disk(self):
        seg = tm.region_growing(insert_phantom(64), (32, 32), tolerance=0.5,
                                n_iterations=64, device=CPU).numpy()
        yy, xx = np.mgrid[0:64, 0:64]
        disk = ((yy - 31.5) ** 2 + (xx - 31.5) ** 2 < (0.4 * 64) ** 2)
        assert seg[disk].mean() > 0.5 and seg[~disk].mean() < 0.05

    def test_watershed_labels_two_basins(self):
        elev, markers = two_basins(32)
        labels = tm.watershed(elev, markers, device=CPU).numpy()
        assert labels[16, 4] == 1 and labels[16, 28] == 2
        assert set(np.unique(labels)) <= {0, 1, 2}

    def test_chan_vese_finds_object(self):
        seg = tm.chan_vese(insert_phantom(64), n_iterations=80,
                           device=CPU).numpy()
        yy, xx = np.mgrid[0:64, 0:64]
        disk = ((yy - 31.5) ** 2 + (xx - 31.5) ** 2 < (0.35 * 64) ** 2)
        assert max((seg[disk] > 0.5).mean(), (seg[disk] < 0.5).mean()) > 0.9

    def test_mrf_denoises_labels(self):
        img = _noisy(64, 0.3, 3)
        plain = tm.threshold(img, 0.5, device=CPU).numpy()
        mrf = tm.mrf_segment(img, 0.5, beta=0.3, device=CPU).numpy()
        truth = tm.threshold(insert_phantom(64), 0.5, device=CPU).numpy()
        assert (mrf != truth).mean() < (plain != truth).mean()

    def test_apply_segmentation_facade(self):
        assert tm.apply_segmentation(insert_phantom(64), "otsu",
                                     device=CPU).shape == (64, 64)
