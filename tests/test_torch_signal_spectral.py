"""The port's spectral analysis held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances: the transforms, PSD, CSD,
coherence, spectrogram and cepstrum at 1e-5 of the reference's largest
value (float32 FFTs of a few thousand samples; the JAX tests' own
bands are looser: a round trip at atol 1e-4, tests/test_signal.py:46-61);
pitch, peak and harmonic picking equal; the JAX tests' behaviour checks
at their own bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import njw_tpu.signal as J  # noqa: E402
from njw_tpu.signal import spectral as js  # noqa: E402

from njw_tpu_torch.signal import spectral as ts  # noqa: E402

CPU = "cpu"
REL = 1e-5
ROUND_TRIP_ATOL = 1e-4      # tests/test_signal.py:50, 61
FS = 1000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tone(freq, n=4096, fs=FS):
    t = np.arange(n) / fs
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def _signal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel_close(got, want, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


class TestFFT:
    @pytest.mark.parametrize("normalize", [False, True])
    def test_transforms_match_jax(self, normalize):
        x = _signal((3, 256), 0)
        ours, theirs = ts.FFT(normalize, device=CPU), J.FFT(normalize)
        _rel_close(ours.forward(x), theirs.forward(x))
        _rel_close(ours.forward_real(x), theirs.forward_real(x))
        X = np.array(theirs.forward(x))
        _rel_close(ours.inverse(X), theirs.inverse(X))
        R = np.asarray(theirs.forward_real(x))
        _rel_close(ours.inverse_real(R), theirs.inverse_real(R))
        _rel_close(ours.inverse_real(R, n=255), theirs.inverse_real(R, n=255))
        _rel_close(ours.forward2d(x), theirs.forward2d(x))
        _rel_close(ours.inverse2d(X), theirs.inverse2d(X))
        _rel_close(ts.FFT.magnitude(torch.from_numpy(X)), J.FFT.magnitude(X))
        _rel_close(ts.FFT.phase(torch.from_numpy(X)), J.FFT.phase(X))
        _rel_close(ts.FFT.power_db(torch.from_numpy(X)), J.FFT.power_db(X))

    @pytest.mark.parametrize("n", [16, 17])
    def test_inverse_real_ignores_imaginary_dc_and_nyquist(self, n):
        """A user's spectrum whose DC (and, n even, Nyquist) bin has an
        imaginary part: the port computes what pocketfft does."""
        R = (_signal(n // 2 + 1, 1) + 1j * _signal(n // 2 + 1, 2)).astype(
            np.complex64)
        _rel_close(ts.FFT(device=CPU).inverse_real(R, n=n),
                   J.FFT().inverse_real(R, n=n))
        S = ts.hermitian_ends(torch.from_numpy(R), n)
        assert float(S[0].imag) == 0.0
        assert (float(S[n // 2].imag) == 0.0) == (n % 2 == 0)

    def test_round_trip_and_tone_bin(self):
        x = _signal(256, 0)
        f = ts.FFT(device=CPU)
        np.testing.assert_allclose(f.inverse(f.forward(x)).real.numpy(), x,
                                   atol=ROUND_TRIP_ATOL)
        X = f.forward_real(tone(125.0, n=1024)).abs().numpy()
        assert np.argmax(X[1:]) + 1 == 128


class TestFrame:
    @pytest.mark.parametrize("nperseg,step", [(64, 32), (64, 16), (64, 24),
                                              (50, 7), (100, 100), (150, 10)])
    def test_matches_jax(self, nperseg, step):
        x = _signal((2, 150), 3)
        got = ts._frame(torch.from_numpy(x), nperseg, step)
        want = np.asarray(js._frame(jnp.asarray(x), nperseg, step))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


class TestSpectra:
    @pytest.mark.parametrize("nperseg", [256, 255])
    @pytest.mark.parametrize("detrend", [True, False])
    @pytest.mark.parametrize("window", ["hann", "hamming", "blackman"])
    def test_psd(self, nperseg, detrend, window):
        x = _signal((2, 3000), 4)
        for a, b in zip(ts.compute_psd(x, 100.0, nperseg, None, window,
                                       detrend, device=CPU),
                        J.compute_psd(x, 100.0, nperseg, None, window,
                                      detrend)):
            _rel_close(a, b)

    @pytest.mark.parametrize("nperseg,noverlap", [(256, None), (255, 100),
                                                  (128, 0)])
    def test_csd_coherence_spectrogram(self, nperseg, noverlap):
        x, y = _signal((2, 3000), 5), _signal((2, 3000), 6)
        for a, b in zip(ts.compute_csd(x, y, 50.0, nperseg, noverlap,
                                       device=CPU),
                        js.compute_csd(x, y, 50.0, nperseg, noverlap)):
            _rel_close(a, b)
        for a, b in zip(ts.compute_coherence(x, y, 50.0, nperseg, noverlap,
                                             device=CPU),
                        J.compute_coherence(x, y, 50.0, nperseg, noverlap)):
            _rel_close(a, b)
        for a, b in zip(ts.compute_spectrogram(x, 50.0, nperseg, noverlap,
                                               device=CPU),
                        J.compute_spectrogram(x, 50.0, nperseg, noverlap)):
            _rel_close(a, b)

    def test_spectrogram_doubles_whatever_the_parity(self):
        """The JAX quirk kept: bins 1:-1 doubled at odd nperseg too."""
        x = _signal(2000, 7)
        _, _, S = ts.compute_spectrogram(x, nperseg=255, device=CPU)
        _, p = ts.compute_psd(x, nperseg=255, noverlap=127, detrend=False,
                              device=CPU)
        np.testing.assert_allclose(S.mean(-1)[-1].numpy(),
                                   p[-1].numpy() / 2, rtol=1e-5)

    def test_signal_shorter_than_a_window_raises(self):
        with pytest.raises(ValueError, match="shorter than one window"):
            ts.compute_psd(_signal(100, 0), nperseg=256, device=CPU)

    def test_analyzer_matches_jax(self):
        # noise keeps every bin's power well above float32 rounding, so
        # the coherence of the two is well-conditioned
        x = tone(100.0) + tone(250.0) + 0.1 * _signal(4096, 7)
        y = _signal(4096, 8)
        ours = ts.SpectralAnalyzer(fs=FS, nperseg=512, device=CPU)
        theirs = J.SpectralAnalyzer(fs=FS, nperseg=512)
        for name, args in (("psd", (x,)), ("csd", (x, y)),
                           ("coherence", (x, y)), ("spectrogram", (x,))):
            for a, b in zip(getattr(ours, name)(*args),
                            getattr(theirs, name)(*args)):
                _rel_close(a, b)
        for a, b in zip(ours.find_peaks(x), theirs.find_peaks(x)):
            np.testing.assert_allclose(a, b, rtol=REL)
        assert ours.fundamental(x) == pytest.approx(theirs.fundamental(x))


class TestPeaksAndPitch:
    @pytest.mark.parametrize("min_distance,max_peaks", [(1, 16), (5, 3)])
    def test_detect_peaks_equal(self, min_distance, max_peaks):
        x = tone(100.0) + 0.5 * tone(333.0) + 0.1 * _signal(4096, 9)
        f, p = ts.compute_psd(x, fs=FS, nperseg=1024, device=CPU)
        got = ts.detect_peaks(p, f, -50.0, min_distance, max_peaks)
        want = J.detect_peaks(p.numpy(), f.numpy(), -50.0, min_distance,
                              max_peaks)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        idx, vals = ts.detect_peaks(p)
        np.testing.assert_array_equal(vals, p.numpy().astype(np.float64)[idx])

    def test_detect_harmonics_equal(self):
        t = np.arange(8192) / 8000.0
        x = sum(np.sin(2 * np.pi * k * 220.0 * t) / k
                for k in range(1, 6)).astype(np.float32)
        f, p = ts.compute_psd(x, fs=8000.0, nperseg=2048, device=CPU)
        got = ts.detect_harmonics(p, f)
        assert got == J.detect_harmonics(p.numpy(), f.numpy())
        assert abs(got - 220.0) < 5.0
        assert ts.detect_harmonics(torch.zeros(64), torch.arange(64.0)) \
            is None

    @pytest.mark.parametrize("kind", ["real", "power"])
    def test_cepstrum(self, kind):
        x = _signal((2, 2048), 10)
        _rel_close(ts.cepstrum(x, kind, device=CPU), J.cepstrum(x, kind))
        with pytest.raises(ValueError, match="kind"):
            ts.cepstrum(x, "complex", device=CPU)

    def test_pitch_matches_jax(self):
        fs = 8000.0
        t = np.arange(4096) / fs
        xs = np.stack([sum(np.sin(2 * np.pi * k * f0 * t) / k
                           for k in range(1, 6)) for f0 in (150.0, 330.0)]
                      ).astype(np.float32)
        got = ts.pitch_detect(xs, fs, device=CPU)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(J.pitch_detect(xs, fs)))
        assert abs(float(got[0]) - 150.0) / 150.0 < 0.03
        assert abs(float(got[1]) - 330.0) / 330.0 < 0.03

    def test_argmax_takes_the_first_of_a_tie(self):
        """Two equal cepstral peaks in the lag band: the port returns the
        lower quefrency, as JAX's jnp.argmax (spectral.py:238-241) does."""
        fs = 64.0
        c = np.zeros((2, 64), np.float32)
        c[0, [5, 9]] = 1.0
        c[1, [12, 7]] = 2.0
        got = ts.cepstral_pitch(torch.from_numpy(c), fs, fmin=4.0, fmax=32.0)
        q_lo, q_hi = int(fs / 32.0), min(int(fs / 4.0) + 1, 32)
        want = np.float32(fs) / (np.asarray(jnp.argmax(
            c[:, q_lo:q_hi], axis=-1)) + q_lo).astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      np.float32([fs / 5, fs / 7]))


class TestBehaviour:
    """The JAX tests' checks (tests/test_signal.py:64-108, 656-689)."""

    def test_psd_peak_and_batch(self):
        f, p = ts.compute_psd(np.stack([tone(50.0), tone(200.0)]), fs=FS,
                              nperseg=512, device=CPU)
        f, p = f.numpy(), p.numpy()
        assert p.shape[0] == 2
        assert abs(f[p[0].argmax()] - 50.0) < 3.0
        assert abs(f[p[1].argmax()] - 200.0) < 3.0

    def test_coherence_identical_vs_noise(self):
        rng = np.random.default_rng(2)
        x = tone(80.0) + 0.1 * rng.standard_normal(4096).astype(np.float32)
        _, coh = ts.compute_coherence(x, x, fs=FS, nperseg=512, device=CPU)
        assert float(coh.mean()) > 0.99
        y = rng.standard_normal(4096).astype(np.float32)
        _, coh2 = ts.compute_coherence(x, y, fs=FS, nperseg=512, device=CPU)
        assert float(coh2.mean()) < 0.5

    def test_spectrogram_chirp_ridge_moves(self):
        t = np.arange(8192) / FS
        x = np.sin(2 * np.pi * (50 + 30 * t) * t).astype(np.float32)
        f, _, S = ts.compute_spectrogram(x, fs=FS, nperseg=256, device=CPU)
        ridge = f.numpy()[S.numpy().argmax(axis=0)]
        assert ridge[-1] > ridge[0] + 20.0

    def test_two_tone_peaks(self):
        x = tone(100.0) + 0.5 * tone(333.0)
        f, p = ts.compute_psd(x, fs=FS, nperseg=1024, device=CPU)
        idx, _ = ts.detect_peaks(p, threshold_db=-30.0, min_distance=5)
        freqs = f.numpy()[idx]
        assert any(abs(freqs - 100.0) < 3) and any(abs(freqs - 333.0) < 3)
        pf, _ = ts.SpectralAnalyzer(fs=FS, nperseg=512,
                                    device=CPU).find_peaks(tone(100.0))
        assert any(abs(pf - 100.0) < 3)

    def test_cepstrum_peak(self):
        t = np.arange(2048) / 8000.0
        x = sum(np.sin(2 * np.pi * k * 200.0 * t)
                for k in range(1, 5)).astype(np.float32)
        c = ts.cepstrum(x, device=CPU).numpy()
        assert c.shape == (2048,)
        assert abs(int(np.argmax(c[20:200])) + 20 - 40) <= 2
        assert (ts.cepstrum(x, "power", device=CPU).numpy() >= 0).all()
