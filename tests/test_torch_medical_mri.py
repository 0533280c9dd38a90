"""The port's MRI module held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances, normalised by the largest |value|
of the JAX output: 1e-5 for every reconstruction (measured 1e-7 to
3e-6: cuFFT/pocketfft and XLA's FFTs, gathers and scatter-adds in
another order; the Kaiser-Bessel kernel's i0 in PyTorch's Cephes form
against XLA's, 1.1e-6 apart); the NumPy helpers (``_kb_beta``,
``_kb_apodization``, the undersampling mask) bit for bit. CG-SENSE is compared where it is
well conditioned (4 coils, R = 2): at R = 4 the float32 rounding of two
evaluations parts by ~10x every few iterations (1.3e-4 after 15), and a
single-coil undersampled solve converges in one step, after which CG
divides rounding by rounding (both packages return noise there). The
JAX file's own MRI tests run again on the port.

The homodyne (partial-Fourier) reconstruction returns |Re(img e^{-i theta})|
with theta the angle of a low-pass phase image. Where that image sits at
the float32 rounding floor, theta is rounding noise, and different FFT
code paths on different CPUs move it (a real phantom with no phase:
|phase_img| 1.8e-5 of its maximum at the worst pixel, 1.3e-5 apart in
the output there). ``_homodyne_close`` holds REL where the reference's
phase is defined (|phase_img| above ``PHASE_DEFINED`` float32 eps of its
maximum, in float64 NumPy from the same input) and, elsewhere, bounds the
difference by |img|, the most an ill-defined angle can move it (or by
REL's floor, where |img| is below it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import njw_tpu.medical as jm  # noqa: E402
from njw_tpu.medical import mri as jmri  # noqa: E402

import njw_tpu_torch.medical as tm  # noqa: E402
from njw_tpu_torch.medical import main_paths as mp  # noqa: E402
from njw_tpu_torch.medical import mri as tmri  # noqa: E402

CPU = "cpu"
REL = 1e-5
PHASE_DEFINED = 1000  # float32 eps of max|phase_img|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(jax_out, port_out) -> float:
    a = np.asarray(jax_out)
    b = port_out.detach().cpu().numpy()
    assert a.shape == b.shape
    a, b = a.astype(np.complex128), b.astype(np.complex128)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _kspace(n=64):
    img = mp.insert_phantom(n)
    return img, np.fft.fftshift(np.fft.fft2(img, norm="ortho")).astype(
        np.complex64)


def _homodyne_images(kspace, fraction):
    """The homodyne reconstruction's phase image and weighted image
    (``reconstruct_partial_fourier``'s formulas) in float64 NumPy."""
    y = np.asarray(kspace).astype(np.complex128)
    ny = y.shape[-2]
    n_acq = int(round(fraction * ny))
    center = ny // 2
    k0 = n_acq - 1 - center
    ky = np.arange(ny, dtype=np.float64)[:, None] - center
    lp = (np.abs(ky) <= k0) * (0.54 + 0.46 * np.cos(np.pi * ky / max(k0, 1)))
    w = np.clip(1.0 - ky / max(k0, 1), 0.0, 2.0)
    w = np.where(ky + center >= n_acq, 0.0, w)

    def ifft_c(k):
        return np.fft.ifft2(np.fft.ifftshift(k, axes=(-2, -1)), norm="ortho")

    return ifft_c(y * lp), ifft_c(y * w)


def _homodyne_close(kspace, fraction, jax_out, port_out) -> None:
    """REL where the reference's phase estimate is defined; elsewhere the
    difference within |img| (or REL's floor)."""
    a = np.asarray(jax_out).astype(np.float64)
    b = port_out.detach().cpu().numpy().astype(np.float64)
    assert a.shape == b.shape
    phase_img, img = _homodyne_images(kspace, fraction)
    mag = np.abs(phase_img)
    defined = mag > PHASE_DEFINED * np.finfo(np.float32).eps * mag.max()
    scale = max(np.abs(a).max(), 1e-30)
    d = np.abs(a - b)
    assert d[defined].max() / scale <= REL
    assert (d[~defined] <= np.maximum(np.abs(img[~defined]),
                                      REL * scale)).all()


def _mask(n=64, r=2, center=6):
    m = np.zeros((n, n), np.float32)
    m[::r, :] = 1.0
    m[n // 2 - center:n // 2 + center, :] = 1.0
    return m


def _coils(n=64, r=2):
    img, _ = _kspace(n)
    yy, xx = np.mgrid[0:n, 0:n] / (n - 1)
    sens = np.stack([np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.35)
                     for cy, cx in [(0, 0), (0, 1), (1, 0), (1, 1)]
                     ]).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(0, keepdims=True))
    mask = _mask(n, r)
    k = (mask[None] * np.fft.fftshift(np.fft.fft2(sens * img[None],
                                                  norm="ortho"),
                                      axes=(-2, -1))).astype(np.complex64)
    return img, sens, mask, k


def _radial(n=32, spokes=48, read=64):
    img = mp.insert_phantom(n)
    coords = mp.radial_trajectory(spokes, read)
    samples = mp.exact_radial_samples(torch.from_numpy(img),
                                      torch.from_numpy(coords)).numpy()
    return img, coords, samples


class TestAgainstJax:
    def test_reconstruct_kspace(self):
        _, k = _kspace()
        assert _rel(jm.reconstruct_kspace(k),
                    tm.reconstruct_kspace(k, device=CPU)) <= REL

    @pytest.mark.parametrize("os_", [1.0, 1.5])
    def test_grid_noncartesian(self, os_):
        rng = np.random.default_rng(1)
        coords = (rng.random((400, 2)) - 0.5).astype(np.float32)
        s = (rng.standard_normal(400) + 1j * rng.standard_normal(400)
             ).astype(np.complex64)
        assert _rel(jm.grid_noncartesian(s, coords, 24, os_),
                    tm.grid_noncartesian(s, coords, 24, os_,
                                         device=CPU)) <= REL

    @pytest.mark.parametrize("width,os_", [(4, 2.0), (6, 1.25), (3, 2.0)])
    def test_kb_numpy_helpers_bit_equal(self, width, os_):
        beta = jmri._kb_beta(width, os_)
        assert tmri._kb_beta(width, os_) == beta
        np.testing.assert_array_equal(tmri._kb_apodization(48, width, beta),
                                      jmri._kb_apodization(48, width, beta))

    def test_kb_kernel(self):
        r = np.linspace(-3, 3, 301).astype(np.float32)
        beta = jmri._kb_beta(4, 2.0)
        assert _rel(jmri._kb_kernel(jnp.asarray(r), 4, beta),
                    tmri._kb_kernel(torch.from_numpy(r), 4, beta)) <= REL

    def test_kb_grid_and_degrid(self):
        img, coords, samples = _radial()
        beta = jmri._kb_beta(4, 2.0)
        w = np.linspace(0.5, 1.5, len(coords)).astype(np.float32)
        jg = jmri._kb_grid(samples, coords, w, 64, 4, beta)
        tg = tmri._kb_grid(torch.from_numpy(samples),
                           torch.from_numpy(coords), torch.from_numpy(w),
                           64, 4, beta)
        assert _rel(jg, tg) <= REL
        g = np.array(jg)
        assert _rel(jmri._kb_degrid(g, coords, 64, 4, beta),
                    tmri._kb_degrid(torch.from_numpy(g),
                                    torch.from_numpy(coords), 64, 4,
                                    beta)) <= REL

    def test_pipe_menon_dcf(self):
        _, coords, _ = _radial()
        assert _rel(jm.pipe_menon_dcf(coords, 32),
                    tm.pipe_menon_dcf(coords, 32, device=CPU)) <= REL

    @pytest.mark.parametrize("dcf", [False, True])
    def test_gridding_reconstruct(self, dcf):
        _, coords, samples = _radial()
        w = np.full(len(coords), 0.7, np.float32) if dcf else None
        assert _rel(jm.gridding_reconstruct(samples, coords, 32, dcf=w),
                    tm.gridding_reconstruct(samples, coords, 32, dcf=w,
                                            device=CPU)) <= REL

    @pytest.mark.parametrize("iters,lam", [(5, 0.0), (15, 0.0), (10, 0.01)])
    def test_cg_sense(self, iters, lam):
        _, sens, mask, k = _coils()
        assert _rel(jm.reconstruct_cg(k, mask, sens, num_iterations=iters,
                                      lam=lam),
                    tm.reconstruct_cg(k, mask, sens, num_iterations=iters,
                                      lam=lam, device=CPU)) <= REL

    def test_cg_infers_the_mask(self):
        _, sens, _, k = _coils()
        assert _rel(jm.reconstruct_cg(k, None, sens, num_iterations=8),
                    tm.reconstruct_cg(k, None, sens, num_iterations=8,
                                      device=CPU)) <= REL

    @pytest.mark.parametrize("mask_given", [True, False])
    def test_primal_dual(self, mask_given):
        _, k = _kspace()
        mask = _mask(r=3)
        m = mask if mask_given else None
        assert _rel(jm.reconstruct_primal_dual(mask * k, m,
                                               num_iterations=30,
                                               tv_weight=0.02),
                    tm.reconstruct_primal_dual(mask * k, m,
                                               num_iterations=30,
                                               tv_weight=0.02,
                                               device=CPU)) <= REL

    @pytest.mark.parametrize("levels", [3, 1])
    def test_compressed_sensing(self, levels):
        _, k = _kspace()
        mask = _mask(r=3)
        assert _rel(jm.reconstruct_compressed_sensing(
            mask * k, mask, num_iterations=20, lam=0.01, levels=levels),
            tm.reconstruct_compressed_sensing(
                mask * k, mask, num_iterations=20, lam=0.01, levels=levels,
                device=CPU)) <= REL

    def test_haar_round_trip(self):
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (16, 32)).astype(np.float32))
        a, cs = tmri._haar2_fwd(x, 2)
        torch.testing.assert_close(tmri._haar2_inv(a, cs), x, rtol=0,
                                   atol=1e-5)

    def test_partial_fourier(self):
        n = 64
        img = mp.insert_phantom(n)
        yy, xx = np.mgrid[0:n, 0:n] / (n - 1)
        k = np.fft.fftshift(np.fft.fft2(img * np.exp(1j * (0.6 * yy + 0.4
                                                           * xx)),
                                        norm="ortho")).astype(np.complex64)
        k[40:] = 0
        _homodyne_close(k, 40 / 64, jm.reconstruct_partial_fourier(k, 40 / 64),
                        tm.reconstruct_partial_fourier(k, 40 / 64,
                                                       device=CPU))

    @pytest.mark.parametrize("method,kw", [
        ("fft", {}), ("cg_sense", {"lam": 0.0}),
        ("iterative_primal_dual", {"tv_weight": 0.02}),
        ("compressed_sensing", {"lam": 0.01}),
        ("partial_fourier", {"fraction": 48 / 64})])
    def test_reconstructor_methods(self, method, kw):
        _, sens, mask, kc = _coils()
        _, k1 = _kspace()
        coil = method == "cg_sense"
        args = (kc, mask) if coil else (k1 * mask, mask)
        if method in ("fft", "partial_fourier"):
            args = (k1,)
        j = jm.MRIReconstructor(method, 6, 2, sens if coil else None)
        t = tm.MRIReconstructor(method, 6, 2, sens if coil else None,
                                device=CPU)
        if method == "partial_fourier":
            _homodyne_close(k1, kw["fraction"], j.process(*args, **kw),
                            t.process(*args, **kw))
            return
        assert _rel(j.process(*args, **kw), t.process(*args, **kw)) <= REL

    def test_reconstructor_partial_fourier_smooth_phase(self):
        """On an input with a smooth phase the estimate is defined over
        the whole image: REL everywhere."""
        n = 64
        img = mp.insert_phantom(n)
        yy, xx = np.mgrid[0:n, 0:n] / (n - 1)
        k = np.fft.fftshift(np.fft.fft2(img * np.exp(1j * (0.6 * yy + 0.4
                                                           * xx)),
                                        norm="ortho")).astype(np.complex64)
        kw = {"fraction": 48 / 64}
        j = jm.MRIReconstructor("partial_fourier", 6, 2)
        t = tm.MRIReconstructor("partial_fourier", 6, 2, device=CPU)
        assert _rel(j.process(k, **kw), t.process(k, **kw)) <= REL

    @pytest.mark.parametrize("r,n", [(1, 32), (2, 64), (4, 48), (3, 50)])
    def test_undersampling_mask_bit_equal(self, r, n):
        j = jm.MRIReconstructor(acceleration_factor=r)
        t = tm.MRIReconstructor(acceleration_factor=r, device=CPU)
        np.testing.assert_array_equal(np.asarray(j.undersampling_mask(n, n)),
                                      t.undersampling_mask(n, n).numpy())

    def test_deep_learning_and_unknown_methods_raise(self):
        _, k = _kspace(16)
        with pytest.raises(NotImplementedError):
            tm.MRIReconstructor("deep_learning", device=CPU).process(k)
        with pytest.raises(ValueError, match="unknown method"):
            tm.MRIReconstructor("bogus", device=CPU).process(k)

    def test_cg_sense_on_the_examples_noisy_kspace(self):
        """mri_cg_256x8's noisy k-space (R = 4, 8 coils, 15 iterations):
        both packages' CG-SENSE error is ~5.5x zero-filled's, far past the
        JAX test's 0.5 (a behaviour of the reference on noisy data,
        ROADMAP.md section 3), and the port's ratio is JAX's."""
        d = mp.IMAGING_PATHS["mri_cg_256x8"].setup(torch.device(CPU))
        img, sens = d["img"].numpy(), d["sens"].numpy()
        ku, mask = d["ku"].numpy(), d["mask"].numpy()
        zf = np.abs((np.conj(sens) * np.fft.ifft2(
            np.fft.ifftshift(ku, axes=(-2, -1)), norm="ortho")).sum(0))
        ezf = np.abs(zf - img).mean()
        j = np.asarray(jm.MRIReconstructor("cg_sense", 15, 4, sens).process(
            ku, mask))
        t = mp._cg_sense(d).numpy()
        rj, rt = np.abs(j - img).mean() / ezf, np.abs(t - img).mean() / ezf
        assert rj > 0.5 and rt == pytest.approx(rj, rel=1e-3)


class TestInvariants:
    """tests/test_medical.py's MRI tests, on the port."""

    def test_kspace_roundtrip(self):
        img = mp.insert_phantom(64)
        k = np.fft.fftshift(np.fft.fft2(img))
        np.testing.assert_allclose(tm.reconstruct_kspace(k, device=CPU),
                                   img, atol=1e-3)

    def test_noncartesian_gridding(self):
        img = mp.insert_phantom(32)
        k = np.fft.fftshift(np.fft.fft2(img.astype(np.complex64)))
        yy, xx = np.mgrid[0:32, 0:32]
        coords = np.stack([yy.ravel() / 31 - 0.5, xx.ravel() / 31 - 0.5], 1)
        rec = tm.grid_noncartesian(k.ravel(), coords, 32, device=CPU)
        assert np.corrcoef(rec.numpy().ravel(), img.ravel())[0, 1] > 0.8

    def test_cg_fully_sampled_matches_fft(self):
        img, k = _kspace()
        rec = tm.reconstruct_cg(k, np.ones((64, 64), np.float32),
                                num_iterations=5, device=CPU)
        np.testing.assert_allclose(rec.numpy(), img, atol=1e-3)

    def test_cg_sense_beats_zero_filled(self):
        img, sens, mask, k = _coils()
        rec = tm.reconstruct_cg(k, mask, sens, num_iterations=15,
                                device=CPU).numpy()
        zf = np.abs((np.conj(sens) * np.fft.ifft2(
            np.fft.ifftshift(k, axes=(-2, -1)), norm="ortho")).sum(0))
        assert np.abs(rec - img).mean() < 0.5 * np.abs(zf - img).mean()

    @pytest.mark.parametrize("method", ["primal_dual", "compressed_sensing"])
    def test_iterative_beats_zero_filled(self, method):
        img, k = _kspace()
        if method == "primal_dual":
            mask, bound = _mask(r=3), 0.7
            rec = tm.reconstruct_primal_dual(mask * k, mask,
                                             num_iterations=80,
                                             tv_weight=0.02, device=CPU)
        else:
            rng = np.random.default_rng(3)
            mask = (rng.random((64, 64)) < 0.35).astype(np.float32)
            mask[28:36, :] = 1.0
            bound = 0.8
            rec = tm.reconstruct_compressed_sensing(
                mask * k, mask, num_iterations=40, lam=0.01, device=CPU)
        zf = np.abs(np.fft.ifft2(np.fft.ifftshift(mask * k), norm="ortho"))
        assert np.abs(rec.numpy() - img).mean() < bound * np.abs(
            zf - img).mean()

    def test_partial_fourier_homodyne(self):
        n = 64
        img = mp.insert_phantom(n)
        yy, xx = np.mgrid[0:n, 0:n] / (n - 1)
        k = np.fft.fftshift(np.fft.fft2(img * np.exp(1j * (0.6 * yy + 0.4
                                                           * xx)),
                                        norm="ortho"))
        k[int(5 / 8 * n):, :] = 0.0
        rec = tm.reconstruct_partial_fourier(k, 5 / 8, device=CPU).numpy()
        zf = np.abs(np.fft.ifft2(np.fft.ifftshift(k), norm="ortho"))
        assert np.abs(rec - img).mean() < 0.7 * np.abs(zf - img).mean()

    def test_kb_gridding_radial_beats_bilinear(self):
        n = 32
        img = mp.insert_phantom(n)
        coords = mp.radial_trajectory(96, 64)
        y_idx, x_idx = np.mgrid[0:n, 0:n]
        phase = np.exp(-2j * np.pi * (
            coords[:, 0:1] * (y_idx.ravel() - n // 2)[None]
            + coords[:, 1:2] * (x_idx.ravel() - n // 2)[None]))
        samples = (phase @ img.ravel().astype(np.complex64)) / n
        kb = tm.gridding_reconstruct(samples, coords, n, device=CPU).numpy()
        corner = samples * np.exp(-2j * np.pi * (n // 2)
                                  * (coords[:, 0] + coords[:, 1]))
        bl = tm.grid_noncartesian(corner, coords, n, device=CPU).numpy()

        def cc(a):
            return np.corrcoef(a.ravel(), img.ravel())[0, 1]

        assert cc(kb) > cc(bl) and cc(kb) > 0.93

    def test_exact_radial_samples_match_the_dft(self):
        img, coords, samples = _radial(16, 8, 16)
        y_idx, x_idx = np.mgrid[0:16, 0:16]
        phase = np.exp(-2j * np.pi * (
            coords[:, 0:1] * (y_idx.ravel() - 8)[None]
            + coords[:, 1:2] * (x_idx.ravel() - 8)[None]))
        np.testing.assert_allclose(samples, phase @ img.ravel() / 16,
                                   rtol=0, atol=1e-5)

    def test_reconstructor_facade(self):
        img, k = _kspace()
        r = tm.MRIReconstructor(method="fft", device=CPU)
        np.testing.assert_allclose(
            r.process(np.fft.fftshift(np.fft.fft2(img))).numpy(), img,
            atol=1e-3)
        r = tm.MRIReconstructor(method="cg_sense", num_iterations=5,
                                acceleration_factor=2, device=CPU)
        mask = r.undersampling_mask(64, 64)
        assert torch.isfinite(r.process(mask.numpy() * k, mask)).all()
