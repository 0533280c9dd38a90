"""The port's spherical-harmonic transform (njw_tpu_torch.ops.sht) held
against the JAX package's (njw_tpu.ops.sht) on the same NumPy inputs, and
the JAX transform tests (tests/test_weather_spherical.py:47-160) run on
the port.

Every comparison is normalised by the largest |value| of JAX's result and
held to atol 1e-5 (the JAX fold test's bound), at nlat 32 and 64 with
the parity fold off and on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.ops import sht as jsht  # noqa: E402

from njw_tpu_torch.ops import sht as tsht  # noqa: E402
from njw_tpu_torch.ops.sht import (  # noqa: E402
    TABLES, SphericalHarmonicTransform,
)
from njw_tpu_torch.platform import float32_products  # noqa: E402

CPU = "cpu"
CASES = [(32, False), (32, True), (64, False), (64, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE: dict = {}


def _pair(nlat, fold):
    key = (nlat, fold)
    if key not in _CACHE:
        _CACHE[key] = (jsht.SphericalHarmonicTransform(nlat,
                                                       fold_parity=fold),
                       SphericalHarmonicTransform(nlat, fold_parity=fold,
                                                  device=CPU))
    return _CACHE[key]


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("nlat,fold", CASES)
class TestAgainstJax:
    def test_grid_and_tables(self, nlat, fold):
        j, t = _pair(nlat, fold)
        np.testing.assert_array_equal(t.mu, j.mu)
        np.testing.assert_array_equal(t.quad_w, j.quad_w)
        assert t.spec_shape == j.spec_shape and t.trunc == j.trunc
        assert t.fold_parity == j.fold_parity == fold
        np.testing.assert_array_equal(t.lap.numpy(), np.asarray(j._lap))
        np.testing.assert_array_equal(t.inv_lap.numpy(),
                                      np.asarray(j._inv_lap))
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j._valid))
        for name in TABLES:
            if fold:
                for mine, theirs in zip(t.folded[name], j._folded[name]):
                    np.testing.assert_array_equal(mine.numpy(),
                                                  np.asarray(theirs))
            else:
                np.testing.assert_array_equal(
                    t.tables[name].numpy(), np.asarray(getattr(j, "_" + name)))

    def test_analysis_and_synthesis(self, nlat, fold):
        j, t = _pair(nlat, fold)
        rng = np.random.default_rng(nlat)
        f = rng.standard_normal((2, nlat, 2 * nlat)).astype(np.float32)
        a = j.analysis(jnp.asarray(f))
        _close(t.analysis(_t(f)), a)
        _close(t.synthesis(_t(a)), j.synthesis(a))

    @pytest.mark.parametrize("which", TABLES)
    def test_stacks(self, nlat, fold, which):
        j, t = _pair(nlat, fold)
        rng = np.random.default_rng(7)
        q = _cplx(rng, (3,) + t.spec_shape)
        _close(t.syn_stack(_t(q), which), j.syn_stack(jnp.asarray(q), which))
        F = _cplx(rng, (3, nlat, t.trunc + 1))
        _close(t.anal_stack(_t(F), which), j.anal_stack(jnp.asarray(F),
                                                        which))

    def test_winds_divergence_curl(self, nlat, fold):
        j, t = _pair(nlat, fold)
        rng = np.random.default_rng(3)
        psi = np.asarray(j.analysis(jnp.asarray(rng.standard_normal(
            (nlat, 2 * nlat)).astype(np.float32))))
        chi = 0.5 * psi[:, ::-1].copy()
        U, V = t.uv_from_psi_chi(_t(psi), _t(chi))
        jU, jV = j.uv_from_psi_chi(jnp.asarray(psi), jnp.asarray(chi))
        _close(U, jU)
        _close(V, jV)
        A = rng.standard_normal((nlat, 2 * nlat)).astype(np.float32)
        B = rng.standard_normal((nlat, 2 * nlat)).astype(np.float32)
        _close(t.divergence_of(_t(A), _t(B)),
               j.divergence_of(jnp.asarray(A), jnp.asarray(B)))
        _close(t.curl_of(_t(A), _t(B)),
               j.curl_of(jnp.asarray(A), jnp.asarray(B)))

    def test_spectral_mode_and_global_mean(self, nlat, fold):
        j, t = _pair(nlat, fold)
        np.testing.assert_array_equal(t.spectral_mode(3, 5, 2.0).numpy(),
                                      np.asarray(j.spectral_mode(3, 5, 2.0)))
        np.testing.assert_array_equal(t.spectral_mode(0, 2, 2.0).numpy(),
                                      np.asarray(j.spectral_mode(0, 2, 2.0)))
        g = np.random.default_rng(1).standard_normal(
            (nlat, 2 * nlat)).astype(np.float32)
        assert float(t.global_mean(_t(g))) == pytest.approx(
            float(j.global_mean(jnp.asarray(g))), rel=1e-5, abs=1e-7)


class TestTransform:
    """tests/test_weather_spherical.py's TestTransform on the port (T21)."""

    @pytest.fixture(scope="class")
    def sht(self):
        return _pair(32, False)[1]

    @staticmethod
    def _band_limited(sht, seed):
        rng = np.random.default_rng(seed)
        a = rng.normal(size=sht.spec_shape) \
            + 1j * rng.normal(size=sht.spec_shape)
        a = np.where(sht.valid.numpy(), a, 0).astype(np.complex64)
        a[0] = a[0].real  # m = 0 must be real
        return torch.from_numpy(a)

    def test_roundtrip_bandlimited(self, sht):
        a0 = self._band_limited(sht, 0)
        a1 = sht.analysis(sht.synthesis(a0))
        assert float((a1 - a0).abs().max()) < 5e-6

    def test_laplacian_eigenvalue(self, sht):
        m, n = 3, 7
        mode = sht.spectral_mode(m, n)
        g = sht.synthesis(mode)
        lap = sht.synthesis(sht.laplacian(mode))
        expect = -n * (n + 1) / sht.radius ** 2 * g
        rel = (lap - expect).abs().max() / expect.abs().max()
        assert float(rel) < 1e-5

    def test_wind_operators_consistent(self, sht):
        """The curl of the psi-winds is Lap psi; their divergence is 0."""
        psi = sht.inverse_laplacian(self._band_limited(sht, 1))
        U, V = sht.uv_from_psi_chi(psi, torch.zeros_like(psi))
        curl = sht.curl_of(U, V)
        div = sht.divergence_of(U, V)
        scale = float(sht.laplacian(psi).abs().max())
        assert float((curl - sht.laplacian(psi)).abs().max()) < \
            1e-5 * scale + 1e-6
        assert float(div.abs().max()) < 1e-5 * scale + 1e-6

    def test_quadrature_global_mean(self, sht):
        one = torch.ones(sht.nlat, sht.nlon)
        assert abs(float(sht.global_mean(one)) - 1.0) < 1e-6
        g = sht.synthesis(sht.spectral_mode(2, 4))
        assert abs(float(sht.global_mean(g))) < 1e-6

    @pytest.mark.parametrize("which", TABLES)
    def test_fold_matches_unfolded(self, which):
        """The fold is a relowering: the same values to float32 rounding
        (tests/test_weather_spherical.py:114-129)."""
        from njw_tpu_torch.weather.spherical import (
            EARTH_OMEGA, rossby_haurwitz_swe)

        plain, folded = _pair(32, False)[1], _pair(32, True)[1]
        st = rossby_haurwitz_swe(plain, EARTH_OMEGA)
        a = torch.stack([st.zeta, st.div, st.phi])
        f0 = plain.syn_stack(a, which)
        _close(folded.syn_stack(a, which), f0.numpy())
        _close(folded.anal_stack(f0, which), plain.anal_stack(f0, which))


class TestSetup:
    def test_odd_nlat_refuses_the_fold(self):
        with pytest.raises(ValueError, match="even nlat"):
            SphericalHarmonicTransform(33, fold_parity=True, device=CPU)

    def test_truncation_too_high(self):
        with pytest.raises(ValueError, match="truncation"):
            SphericalHarmonicTransform(16, trunc=16, device=CPU)

    def test_fold_by_size(self):
        # on from nlat 512 with even nlat (sht.py:162-163); the rule alone
        # is checked here: the T341 tables are built on the card only
        assert not SphericalHarmonicTransform(32, device=CPU).fold_parity

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SphericalHarmonicTransform(16)

    def test_products_are_float32(self):
        """The contractions run at 'highest' whatever the process set, and
        the setting comes back."""
        prev = torch.get_float32_matmul_precision()
        seen = []
        orig = torch.bmm

        def spy(*a, **k):
            seen.append(torch.get_float32_matmul_precision())
            return orig(*a, **k)

        t = _pair(32, False)[1]
        torch.set_float32_matmul_precision("high")
        try:
            tsht.torch.bmm = spy
            t.syn_stack(t.spectral_mode(1, 2)[None])
            with float32_products():
                inner = torch.get_float32_matmul_precision()
            after = torch.get_float32_matmul_precision()
        finally:
            tsht.torch.bmm = orig
            torch.set_float32_matmul_precision(prev)
        assert seen == ["highest"] and inner == "highest"
        assert after == "high"

    def test_float32_products_sets_and_restores_both_settings(self):
        """The guard turns TF32 off for cuBLAS and cuDNN inside, and puts
        back what the process had, also when the body raises."""
        prev = (torch.get_float32_matmul_precision(),
                torch.backends.cudnn.allow_tf32)
        try:
            torch.set_float32_matmul_precision("high")
            torch.backends.cudnn.allow_tf32 = True
            with pytest.raises(RuntimeError):
                with float32_products():
                    assert torch.get_float32_matmul_precision() == "highest"
                    assert torch.backends.cudnn.allow_tf32 is False
                    raise RuntimeError
            assert torch.get_float32_matmul_precision() == "high"
            assert torch.backends.cudnn.allow_tf32 is True
        finally:
            torch.set_float32_matmul_precision(prev[0])
            torch.backends.cudnn.allow_tf32 = prev[1]

    def test_bf16_tables(self):
        """bf16 storage: the tables hold half the bytes, are upcast at
        each product, and the transform stays within bf16's rounding of
        the float32 one."""
        t32 = _pair(32, False)[1]
        t16 = SphericalHarmonicTransform(32, table_dtype=torch.bfloat16,
                                         device=CPU)
        assert t16.table_bytes("P") * 2 == t32.table_bytes("P")
        f = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (32, 64)).astype(np.float32))
        a32, a16 = t32.analysis(f), t16.analysis(f)
        assert a16.dtype == torch.complex64
        assert float((a16 - a32).abs().max()) < 1e-2 * float(a32.abs().max())
