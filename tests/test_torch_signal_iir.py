"""The port's IIR design and application, median filter and streaming IIR
held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances: the designs bit for bit (both
are float64 NumPy with the same arithmetic); sos_apply at rtol / atol
1e-4 (tests/test_signal.py:271, 284); the streaming filter at atol 1e-5
(:639) against JAX and bit for bit against the port's one-shot scan;
the median filter at atol 1e-6 (:309).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu.signal import elliptic as je  # noqa: E402
from njw_tpu.signal import filters as jf  # noqa: E402

from njw_tpu_torch.signal import convert  # noqa: E402
from njw_tpu_torch.signal import elliptic as te  # noqa: E402
from njw_tpu_torch.signal import filters as tf  # noqa: E402
from njw_tpu_torch.signal.spectral import compute_psd  # noqa: E402

CPU = "cpu"
SOS_TOL = 1e-4          # tests/test_signal.py:271, 284
STREAM_ATOL = 1e-5      # tests/test_signal.py:639
MEDIAN_ATOL = 1e-6      # tests/test_signal.py:309
FS = 1000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tone(freq, n=4096, fs=FS):
    t = np.arange(n) / fs
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def band_power(y, lo, hi):
    f, p = compute_psd(y, fs=FS, nperseg=1024, device=CPU)
    f, p = f.numpy(), p.numpy()
    return float(p[(f >= lo) & (f <= hi)].sum())


def _signal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _sos(order=8, cutoff=0.2, design="butterworth"):
    return np.asarray(jf.IIRFilter(design=design, order=order,
                                   cutoff=cutoff).sos)


class TestDesign:
    @pytest.mark.parametrize("kind", ["butterworth", "chebyshev1",
                                      "chebyshev2", "bessel"])
    @pytest.mark.parametrize("btype,cutoff", [
        ("lowpass", 0.2), ("highpass", 0.35), ("bandpass", (0.2, 0.5))])
    @pytest.mark.parametrize("order", [3, 4])
    def test_families_bit_equal(self, kind, btype, cutoff, order):
        want = jf._design_iir(kind, order, cutoff, btype, 0.5)
        got = tf._design_iir(kind, order, cutoff, btype, 0.5)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()

    @pytest.mark.parametrize("btype", ["lowpass", "highpass"])
    @pytest.mark.parametrize("order", [4, 5])
    def test_elliptic_bit_equal(self, btype, order):
        want = je.elliptic_sos(order, 0.3, btype, rp=0.5, rs=50.0)
        got = te.elliptic_sos(order, 0.3, btype, rp=0.5, rs=50.0)
        assert got.tobytes() == want.tobytes()

    def test_elliptic_prototype_bit_equal(self):
        for got, want in zip(te.ellipap(5, 1.0, 40.0),
                             je.ellipap(5, 1.0, 40.0)):
            np.testing.assert_array_equal(got, want)

    def test_public_designs_bit_equal(self):
        assert (tf.butterworth(5, 0.3, "highpass").tobytes()
                == jf.butterworth(5, 0.3, "highpass").tobytes())
        assert (tf.chebyshev1(4, (0.1, 0.4), "bandpass", 2.0).tobytes()
                == jf.chebyshev1(4, (0.1, 0.4), "bandpass", 2.0).tobytes())

    @pytest.mark.parametrize("design", ["butterworth", "chebyshev1",
                                        "chebyshev2", "bessel", "elliptic"])
    def test_iir_filter_sos_and_response(self, design):
        kw = dict(design=design, order=5, cutoff=0.3, ripple_db=1.0,
                  stopband_db=45.0)
        got, want = tf.IIRFilter(device=CPU, **kw), jf.IIRFilter(**kw)
        assert got.sos.tobytes() == np.asarray(want.sos).tobytes()
        for a, b in zip(got.frequency_response(256),
                        want.frequency_response(256)):
            np.testing.assert_array_equal(a, b)

    def test_refusals(self):
        with pytest.raises(ValueError, match="unsupported IIR family"):
            tf._design_iir("cauer", 4, 0.2, "lowpass")
        with pytest.raises(ValueError, match="unsupported btype"):
            tf._design_iir("butterworth", 4, 0.2, "notch")
        with pytest.raises(ValueError, match="unsupported btype"):
            te.elliptic_sos(4, (0.2, 0.3), "bandpass")

    def test_elliptic_prototype_equiripple(self):
        z, p, g = te.ellipap(5, 1.0, 40.0)
        w = np.linspace(0.001, 4, 4000)
        s = 1j * w
        H = np.abs(g * np.prod(s[:, None] - z[None, :], axis=1)
                   / np.prod(s[:, None] - p[None, :], axis=1))
        pb = 20 * np.log10(H[w <= 1.0])
        assert pb.min() > -1.05 and pb.max() < 0.05
        assert (20 * np.log10(H[w >= 1.35])).max() < -39.5
        assert np.all(np.real(p) < 0)


class TestSosApply:
    @pytest.mark.parametrize("method", ["scan", "parallel"])
    @pytest.mark.parametrize("shape", [(1500,), (3, 700), (2, 2, 300)])
    def test_matches_jax(self, method, shape):
        x = _signal(shape, 7)
        sos = _sos()
        got = tf.sos_apply(x, sos, method, device=CPU)
        want = np.asarray(jf.sos_apply(x, sos, method=method))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=SOS_TOL,
                                   atol=SOS_TOL)

    @pytest.mark.parametrize("design", ["chebyshev1", "chebyshev2",
                                        "bessel", "elliptic"])
    def test_other_families_match_jax(self, design):
        x = _signal((2, 600), 3)
        sos = _sos(order=5, cutoff=0.3, design=design)
        for method in ("scan", "parallel"):
            np.testing.assert_allclose(
                tf.sos_apply(x, sos, method, device=CPU).numpy(),
                np.asarray(jf.sos_apply(x, sos, method=method)),
                rtol=SOS_TOL, atol=SOS_TOL)

    def test_auto_switches_at_4096(self):
        sos = _sos(order=4)
        for n, method in ((4095, "scan"), (4096, "parallel")):
            x = torch.from_numpy(_signal(n, n))
            assert torch.equal(tf.sos_apply(x, sos),
                               tf.sos_apply(x, sos, method))
            assert torch.equal(tf.IIRFilter(sos, device=CPU).apply(x),
                               tf.sos_apply(x, sos, method))

    def test_parallel_matches_scan(self):
        """The doubling scan is the same filter as the per-sample scan
        (tests/test_signal.py:274-284: 8th order, 5000 samples)."""
        x = _signal(5000, 7)
        sos = _sos()
        np.testing.assert_allclose(
            tf.sos_apply(x, sos, "parallel", device=CPU).numpy(),
            tf.sos_apply(x, sos, "scan", device=CPU).numpy(),
            rtol=SOS_TOL, atol=SOS_TOL)

    def test_full_width_parallel_matches_jax_scan(self):
        """iir_8th_1m's 2^20 samples: JAX's doubling scan and the port's
        both hold JAX's per-sample scan (the band of :284)."""
        from njw_tpu_torch.signal.main_paths import ANALYSIS_PATHS

        x, = ANALYSIS_PATHS["iir_8th_1m"].inputs(seed=0, device=CPU)
        sos = _sos()
        want = np.asarray(jf.sos_apply(x.numpy(), sos, method="scan"))
        for got in (np.asarray(jf.sos_apply(x.numpy(), sos,
                                            method="parallel")),
                    tf.sos_apply(x, sos, "parallel").numpy()):
            np.testing.assert_allclose(got, want, rtol=SOS_TOL, atol=SOS_TOL)

    def test_parallel_batched_rows_match_scan(self):
        x = _signal((3, 4096), 8)
        sos = _sos(order=4, cutoff=0.3)
        y = tf.sos_apply(x, sos, "parallel", device=CPU).numpy()
        for i in range(3):
            np.testing.assert_allclose(
                y[i], tf.sos_apply(x[i], sos, "scan", device=CPU).numpy(),
                rtol=SOS_TOL, atol=SOS_TOL)

    def test_reference_biquad(self):
        x = _signal(128, 4)
        sos = np.array([[0.2, 0.3, 0.1, 1.0, -0.5, 0.2]], np.float32)
        y = tf.IIRFilter(sos, device=CPU).apply(x).numpy()
        ref = np.zeros(128)
        for i in range(128):
            ref[i] = (0.2 * x[i] + 0.3 * (x[i - 1] if i > 0 else 0)
                      + 0.1 * (x[i - 2] if i > 1 else 0)
                      + 0.5 * (ref[i - 1] if i > 0 else 0)
                      - 0.2 * (ref[i - 2] if i > 1 else 0))
        np.testing.assert_allclose(y, ref, atol=SOS_TOL)

    def test_sections_as_tensor(self):
        x = _signal((2, 500), 5)
        sos = _sos(order=4)
        for method in ("scan", "parallel"):
            assert torch.equal(
                tf.sos_apply(x, torch.from_numpy(sos), method, device=CPU),
                tf.sos_apply(x, sos, method, device=CPU))

    def test_unknown_method_raises(self):
        with pytest.raises(ValueError, match="unknown method"):
            tf.sos_apply(np.zeros(8, np.float32), _sos(), "fft", device=CPU)

    def test_numpy_input_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tf.sos_apply(np.zeros(8, np.float32), _sos())


class TestIIRResponses:
    """The JAX tests' behaviour checks (tests/test_signal.py:228-257,
    559-581) on the port."""

    def _apply(self, x, **kw):
        return tf.IIRFilter(device=CPU, **kw).apply(x).numpy()

    def test_butterworth_lowpass(self):
        y = self._apply(tone(30.0) + tone(400.0), design="butterworth",
                        order=4, cutoff=0.2)
        assert band_power(y, 20, 40) > 100 * band_power(y, 390, 410)

    def test_butterworth_highpass(self):
        y = self._apply(tone(30.0) + tone(400.0), design="butterworth",
                        order=4, cutoff=0.5, btype="highpass")
        assert band_power(y, 390, 410) > 50 * band_power(y, 20, 40)

    def test_chebyshev_lowpass(self):
        y = self._apply(tone(30.0) + tone(400.0), design="chebyshev1",
                        order=4, cutoff=0.2, ripple_db=1.0)
        assert band_power(y, 20, 40) > 100 * band_power(y, 390, 410)

    def test_bessel_finite(self):
        y = self._apply(tone(30.0), design="bessel", order=4, cutoff=0.3)
        assert np.all(np.isfinite(y))

    def test_dc_gain_unity_lowpass(self):
        _, H = tf.IIRFilter(design="butterworth", order=4, cutoff=0.25,
                            device=CPU).frequency_response()
        assert abs(abs(H[0]) - 1.0) < 0.05

    def test_elliptic_separates_tones(self):
        y = self._apply(tone(30.0) + tone(400.0), design="elliptic",
                        order=5, cutoff=0.2, ripple_db=1.0,
                        stopband_db=40.0)
        assert np.all(np.isfinite(y))
        assert band_power(y, 20, 40) > 100 * band_power(y, 390, 410)

    def test_elliptic_sharper_than_butterworth(self):
        _, He = tf.IIRFilter(design="elliptic", order=5, cutoff=0.3,
                             stopband_db=50.0,
                             device=CPU).frequency_response(2048)
        we, Hb = tf.IIRFilter(design="butterworth", order=5, cutoff=0.3,
                              device=CPU).frequency_response(2048)
        sel = we >= 0.4
        assert np.abs(He[sel]).max() < np.abs(Hb[sel]).max()


class TestMedianFilter:
    @pytest.mark.parametrize("size", [1, 3, 5, 11])
    @pytest.mark.parametrize("shape", [(257,), (3, 100), (2, 2, 31)])
    def test_matches_jax(self, size, shape):
        x = _signal(shape, size)
        got = tf.median_filter(x, size, device=CPU)
        want = np.asarray(jf.median_filter(x, size))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=MEDIAN_ATOL)

    def test_matches_numpy(self):
        x = _signal(257, 9)
        y = tf.median_filter(x, 11, device=CPU).numpy()
        xp = np.pad(x, 5, mode="edge")
        ref = np.array([np.median(xp[i:i + 11]) for i in range(257)])
        np.testing.assert_allclose(y, ref, atol=MEDIAN_ATOL)

    def test_removes_impulse_noise(self):
        x = np.zeros(100, np.float32)
        x[50] = 100.0
        assert abs(float(tf.median_filter(x, 5, device=CPU)[50])) < 1e-6

    def test_even_size_raises(self):
        with pytest.raises(ValueError, match="odd"):
            tf.median_filter(np.zeros(8, np.float32), 4, device=CPU)


class TestStreamingIIR:
    @pytest.mark.parametrize("cuts", [[64, 200, 500], [1, 2, 3], [400]])
    def test_chunks_equal_one_shot_scan(self, cuts):
        x = _signal(800, 21)
        sos = _sos(order=6, cutoff=0.25)
        si = tf.StreamingIIR(sos, device=CPU)
        out = torch.cat([si.process(c) for c in np.split(x, cuts)])
        assert torch.equal(out, tf.sos_apply(x, sos, "scan", device=CPU))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jf.sos_apply(x, sos, method="scan")),
            atol=STREAM_ATOL)

    def test_batched_matches_jax(self):
        x = _signal((3, 600), 22)
        sos = _sos(order=4, cutoff=0.3)
        ours = tf.StreamingIIR(sos, batch=3, device=CPU)
        theirs = jf.StreamingIIR(sos, batch=3)
        for c in np.split(x, [100, 350], axis=1):
            np.testing.assert_allclose(ours.process(c).numpy(),
                                       np.asarray(theirs.process(c)),
                                       atol=STREAM_ATOL)
        np.testing.assert_allclose(ours._z.numpy(), np.asarray(theirs._z),
                                   atol=STREAM_ATOL)

    def test_reset(self):
        si = tf.StreamingIIR(_sos(order=2, cutoff=0.3), device=CPU)
        x = np.ones(50, np.float32)
        a = si.process(x)
        si.reset()
        assert torch.equal(a, si.process(x))


class TestConvert:
    def test_iir_filter_from(self):
        j = jf.IIRFilter(design="chebyshev1", order=5, cutoff=0.2)
        p = convert.iir_filter_from(j, device=CPU)
        assert p.sos.tobytes() == np.asarray(j.sos).tobytes()
        x = _signal(900, 30)
        np.testing.assert_allclose(p.apply(x).numpy(),
                                   np.asarray(j.apply(x)), atol=SOS_TOL)

    def test_stream_half_in_jax_half_in_port(self):
        """A chunked stream run half in JAX and carried into the port
        equals the one-shot result."""
        x = _signal((2, 1000), 31)
        sos = _sos(order=6, cutoff=0.25)
        j = jf.StreamingIIR(sos, batch=2)
        first = [np.asarray(j.process(c))
                 for c in np.split(x[:, :500], [120, 300], axis=1)]
        p = convert.streaming_iir_from(j, device=CPU)
        second = [p.process(c).numpy()
                  for c in np.split(x[:, 500:], [77, 300], axis=1)]
        ref = np.asarray(jf.sos_apply(x, sos, method="scan"))
        np.testing.assert_allclose(np.concatenate(first + second, axis=1),
                                   ref, atol=STREAM_ATOL)

    def test_state_round_trip(self):
        x = _signal((2, 300), 32)
        a = tf.StreamingIIR(_sos(order=4), batch=2, device=CPU)
        a.process(x[:, :100])
        b = convert.streaming_iir_from(convert.streaming_iir_state(a),
                                       device=CPU)
        assert torch.equal(a.process(x[:, 100:]), b.process(x[:, 100:]))

    def test_bad_state_raises(self):
        sos = _sos(order=4)
        with pytest.raises(ValueError, match="state of shape"):
            convert.streaming_iir_from(
                {"sos": sos, "z": np.zeros((3, 2, 1), np.float32)},
                device=CPU)
