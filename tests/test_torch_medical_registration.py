"""The port's registration module held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances: warps, the metrics and the
B-spline field at 1e-5 of the JAX output's largest |value| (measured
0 to 2e-6); gradients (``torch.autograd.grad`` against ``jax.grad``) at
1e-4 of the largest component (measured 7e-7 of it); the registrations
over 20 iterations: parameters within 1e-4 absolute (Adam) and 2e-3
(plain descent at lr 5, whose steps amplify rounding: measured 3e-4),
histories and warped images within 1e-4 of their largest value; the
deformable registration's control grid within 1e-4 of its largest value
(optax's Adam written out, with optax's float32 bias corrections). The
JAX file's own registration tests run again on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import njw_tpu.medical as jm  # noqa: E402
from njw_tpu.medical import registration as jreg  # noqa: E402

import njw_tpu_torch.medical as tm  # noqa: E402
from njw_tpu_torch.medical import registration as treg  # noqa: E402
from njw_tpu_torch.medical.main_paths import (  # noqa: E402
    insert_phantom, registration_image,
)

CPU = "cpu"
REL = 1e-5
GRAD_REL = 1e-4
RUN_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().cpu() if hasattr(b, "detach") else b,
                   np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _smooth(n=64):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return (np.sin(x / 7) * np.cos(y / 9)
            + np.exp(-((x - n / 2) ** 2 + (y - 0.44 * n) ** 2) / 300)
            ).astype(np.float32)


PARAMS = [[3.0, -2.0, 0.05, 1.0, 1.0], [0.3, 0.7, -0.2, 1.1, 0.9],
          [0.0, 0.0, 0.0, 1.0, 1.0]]


class TestAgainstJax:
    @pytest.mark.parametrize("params", PARAMS)
    def test_warp_image(self, params):
        img = insert_phantom(48)
        assert _rel(jm.warp_image(img, params),
                    tm.warp_image(img, params, device=CPU)) <= REL

    def test_metrics(self):
        a, b = _smooth(), insert_phantom(64)
        assert _rel(jm.mse_metric(a, b), tm.mse_metric(a, b,
                                                       device=CPU)) <= REL
        for bins, sigma in ((32, 0.5), (16, 1.0)):
            assert _rel(jm.mutual_information(a, b, bins, sigma),
                        tm.mutual_information(a, b, bins, sigma,
                                              device=CPU)) <= REL

    @pytest.mark.parametrize("metric", ["mse", "mi"])
    @pytest.mark.parametrize("params", PARAMS[:2])
    def test_metric_gradients(self, metric, params):
        f = _smooth()
        m = np.array(jm.warp_image(f, [2.0, -1.0, 0.04, 1.0, 1.0]))
        p0 = np.asarray(params, np.float32)

        def jloss(p):
            w = jreg.warp_image(jnp.asarray(m), p)
            return (jreg.mse_metric(f, w) if metric == "mse"
                    else -jreg.mutual_information(f, w))

        def tloss(p):
            w = treg._bilinear(torch.from_numpy(m),
                               *treg._affine_grid(64, 64, p))
            return (treg.mse_metric(torch.from_numpy(f), w) if metric == "mse"
                    else -treg.mutual_information(torch.from_numpy(f), w))

        jg = np.asarray(jax.grad(jloss)(jnp.asarray(p0)))
        _, tg = treg._value_and_grad(tloss, torch.from_numpy(p0))
        assert _rel(jg, tg) <= GRAD_REL

    def test_deformable_loss_gradient(self):
        f = _smooth()
        ctrl = np.random.default_rng(0).normal(0, 1.0, (2, 9, 9)).astype(
            np.float32)
        m = np.array(jreg.warp_deformable(f, -ctrl))
        c0 = 0.5 * ctrl

        def jloss(c):
            w = jreg.warp_deformable(m, c)
            d2y = c[:, 2:, :] - 2 * c[:, 1:-1, :] + c[:, :-2, :]
            d2x = c[:, :, 2:] - 2 * c[:, :, 1:-1] + c[:, :, :-2]
            return jreg.mse_metric(f, w) + 0.01 * (jnp.mean(d2y ** 2)
                                                   + jnp.mean(d2x ** 2))

        jv, jg = jax.value_and_grad(jloss)(jnp.asarray(c0))
        tv, tg = treg._value_and_grad(
            lambda c: treg.deformable_loss(torch.from_numpy(f),
                                           torch.from_numpy(m), c),
            torch.from_numpy(c0))
        assert _rel(jv, tv) <= REL
        assert _rel(jg, tg) <= GRAD_REL

    @pytest.mark.parametrize("shape,grid", [((40, 44), (2, 7, 7)),
                                            ((64, 64), (2, 9, 9))])
    def test_bspline_displacement(self, shape, grid):
        ctrl = np.random.default_rng(1).normal(0, 1.5, grid).astype(
            np.float32)
        assert _rel(jreg.bspline_displacement(jnp.asarray(ctrl), shape),
                    treg.bspline_displacement(ctrl, shape,
                                              device=CPU)) <= REL
        img = _smooth()[: shape[0], : shape[1]]
        assert _rel(jreg.warp_deformable(img, ctrl),
                    treg.warp_deformable(img, ctrl, device=CPU)) <= REL

    @pytest.mark.parametrize("optimizer,levels,lr,ptol", [
        ("adam", 1, 0.5, 1e-4), ("adam", 2, 0.5, 1e-4),
        ("gd", 1, 5.0, 2e-3), ("gd", 2, 5.0, 2e-3)])
    def test_register_images(self, optimizer, levels, lr, ptol):
        f = _smooth()
        m = np.array(jm.warp_image(f, [3.0, -2.0, 0.06, 1.0, 1.0]))
        jp, jw, jh = jm.register_images(f, m, n_iterations=20,
                                        pyramid_levels=levels,
                                        optimizer=optimizer,
                                        learning_rate=lr)
        tp, tw, th = tm.register_images(f, m, n_iterations=20,
                                        pyramid_levels=levels,
                                        optimizer=optimizer,
                                        learning_rate=lr, device=CPU)
        assert len(th) == len(jh) == 20
        assert np.abs(tp - jp).max() <= ptol
        assert _rel(jh, np.asarray(th)) <= RUN_REL
        assert _rel(jw, tw) <= RUN_REL

    @pytest.mark.parametrize("method,metric", [("affine", "mse"),
                                               ("rigid", "mi")])
    def test_register_images_affine_and_mi(self, method, metric):
        f = _smooth()
        m = np.array(jm.warp_image(f, [1.0, -1.0, 0.03, 1.02, 0.98]))
        kw = dict(method=method, metric=metric, n_iterations=12,
                  optimizer="adam", learning_rate=0.3)
        jp, _, jh = jm.register_images(f, m, **kw)
        tp, _, th = tm.register_images(f, m, device=CPU, **kw)
        assert np.abs(tp - jp).max() <= 1e-4
        assert _rel(jh, np.asarray(th)) <= RUN_REL

    def test_register_images_refuses_an_unknown_metric(self):
        with pytest.raises(ValueError, match="unknown metric"):
            tm.register_images(_smooth(), _smooth(), metric="ncc",
                               n_iterations=1, device=CPU)

    @pytest.mark.parametrize("metric", ["mse", "mi"])
    def test_register_deformable(self, metric):
        f = _smooth()
        ctrl = np.random.default_rng(0).normal(0, 1.5, (2, 7, 7)).astype(
            np.float32)
        m = np.array(jreg.warp_deformable(f, -ctrl))
        kw = dict(grid_shape=(4, 4), n_iterations=20, learning_rate=1.0,
                  smooth_weight=0.001, metric=metric)
        jc, jw, jh = jreg.register_deformable(f, m, **kw)
        tc, tw, th = treg.register_deformable(f, m, device=CPU, **kw)
        assert _rel(jc, tc) <= RUN_REL
        assert _rel(jh, np.asarray(th)) <= RUN_REL
        assert _rel(jw, tw) <= RUN_REL

    @pytest.mark.parametrize("decay", [0.9, 0.999])
    def test_optax_bias_corrections_in_float32(self, decay):
        """optax's jitted 1 - decay ** count in float32, bit for bit, for
        the counts of a 300-iteration run."""
        bias = jax.jit(lambda c: 1 - decay ** c)
        want = [np.asarray(bias(jnp.int32(c))) for c in range(1, 301)]
        np.testing.assert_array_equal(
            np.asarray(treg.optax_bias_corrections(decay, 300)), want)


class TestInvariants:
    """tests/test_medical.py's registration tests, on the port."""

    def test_warp_identity(self):
        img = insert_phantom(64)
        np.testing.assert_allclose(
            tm.warp_image(img, [0.0, 0.0, 0.0, 1.0, 1.0], device=CPU), img,
            atol=1e-4)

    def test_warp_translation(self):
        img = insert_phantom(64)
        out = tm.warp_image(img, [3.0, 0.0, 0.0, 1.0, 1.0],
                            device=CPU).numpy()
        np.testing.assert_allclose(out[10:60, :], img[7:57, :], atol=1e-3)

    def test_registration_recovers_shift(self):
        fixed = insert_phantom(64)
        moving = tm.warp_image(fixed, [-4.0, 3.0, 0.0, 1.0, 1.0],
                               device=CPU).numpy()
        params, _, hist = tm.register_images(
            fixed, moving, metric="mse", n_iterations=300,
            learning_rate=20.0, device=CPU)
        assert hist[-1] < hist[0] * 0.3
        assert abs(params[0] - 4.0) < 1.0 and abs(params[1] + 3.0) < 1.0

    def test_multiresolution_adam_recovers_large_transform(self):
        y, x = np.mgrid[0:96, 0:96].astype(np.float32)
        fixed = (np.sin(x / 7) * np.cos(y / 9)
                 + np.exp(-((x - 48) ** 2 + (y - 40) ** 2) / 300))
        moving = tm.warp_image(fixed, [4.0, -3.0, 0.08, 1.0, 1.0],
                               device=CPU).numpy()
        params, _, hist = tm.register_images(
            fixed, moving, metric="mse", n_iterations=300, pyramid_levels=3,
            optimizer="adam", learning_rate=0.5, device=CPU)
        assert abs(params[0] + 4.0) < 0.7 and abs(params[1] - 3.0) < 0.7
        assert abs(params[2] + 0.08) < 0.03
        assert hist[-1] < hist[0] * 0.2

    def test_mutual_information_peaks_when_aligned(self):
        img = insert_phantom(64)
        shifted = tm.warp_image(img, [5.0, 5.0, 0.0, 1.0, 1.0], device=CPU)
        assert float(tm.mutual_information(img, img, device=CPU)) > float(
            tm.mutual_information(img, shifted, device=CPU))

    def test_deformable_recovers_smooth_deformation(self):
        y, x = np.mgrid[0:64, 0:64].astype(np.float32)
        img = (np.sin(x / 6.0) * np.cos(y / 7.0)
               + 0.5 * np.exp(-((x - 32) ** 2 + (y - 30) ** 2) / 200))
        true_ctrl = np.random.default_rng(0).normal(0.0, 1.5, (2, 9, 9))
        moving = treg.warp_deformable(img, -true_ctrl.astype(np.float32),
                                      device=CPU).numpy()
        _, warped, hist = treg.register_deformable(
            img, moving, grid_shape=(6, 6), n_iterations=200,
            learning_rate=1.0, smooth_weight=0.001, device=CPU)
        assert hist[-1] < hist[0]
        assert np.mean((warped - img) ** 2) < 0.3 * np.mean(
            (moving - img) ** 2)

    def test_zero_control_is_identity(self):
        img = np.random.default_rng(1).random((32, 48)).astype(np.float32)
        np.testing.assert_allclose(
            treg.warp_deformable(img, np.zeros((2, 8, 8), np.float32),
                                 device=CPU), img, atol=1e-5)

    def test_example_image_deformable_stage_matches_jax(self):
        """registration_256's deformable stage at the example's settings
        (6 x 6, 150 iterations, lr 0.3, smoothing 0.01) at its 256^2: the
        port's MSE ratio is JAX's, and both stay above the JAX test's 0.3
        there (ROADMAP.md section 3; at 96^2 both reach 0.196)."""
        f = registration_image(256)
        ctrl = (1.5 * np.random.default_rng(0).standard_normal(
            (2, 4, 4))).astype(np.float32)
        m = np.array(jreg.warp_deformable(
            np.asarray(jm.warp_image(f, [4.0, -3.0, 0.08, 1.0, 1.0])), ctrl))
        _, jw, _ = jm.register_images(f, m, n_iterations=300,
                                      pyramid_levels=3, optimizer="adam",
                                      learning_rate=0.5)
        start = np.mean((jw - f) ** 2)
        _, jd, _ = jreg.register_deformable(f, jw, grid_shape=(6, 6),
                                            n_iterations=150)
        _, td, _ = treg.register_deformable(f, jw, grid_shape=(6, 6),
                                            n_iterations=150, device=CPU)
        rj = np.mean((jd - f) ** 2) / start
        rt = np.mean((td - f) ** 2) / start
        assert rt == pytest.approx(rj, rel=1e-3) and rj > 0.3
