"""The port's time-frequency analysis, and the signal package's analysis
paths as a whole, held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU, where the batch FIR branch the wavelet
transforms reach runs the fir_band kernel's plain version and JAX's FIR
takes its own CPU path. Tolerances: the transforms at 1e-5 of the
reference's largest value (float32; the JAX tests' bands are looser:
round trips at atol 1e-3, tests/test_signal.py:407, 430, 480); the STFT
inverse at 1e-5 in the interior and 1e-4 of the scale at the edges,
where the window-square normalisation divides by values near 0 (so the
frames overlap by at least half a window); the batch branch of the FIR
(the fir_band kernel's plain version: bf16 terms) at its atol 2e-4
(:158); EMD (float64 NumPy in both) at 1e-12; the JAX tests' behaviour
checks at their own bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import njw_tpu.signal as J  # noqa: E402
from njw_tpu.signal import filters as jfilt  # noqa: E402
from njw_tpu.signal import tf as jtf  # noqa: E402

from njw_tpu_torch.signal import fir_cuda  # noqa: E402
from njw_tpu_torch.signal import tf as ttf  # noqa: E402
from njw_tpu_torch.signal.main_paths import ANALYSIS_PATHS  # noqa: E402
from njw_tpu_torch.signal.spectral import compute_psd  # noqa: E402

CPU = "cpu"
REL = 1e-5
EDGE_REL = 1e-4
RECON_ATOL = 1e-3        # tests/test_signal.py:407, 430, 480
FIR_ATOL = 2e-4          # the fir_band kernel's band: tests/test_signal.py:158
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


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.resolve_conj().numpy()
    return np.asarray(a)


def _rel_close(got, want, rel=REL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _all_close(got, want, rel=REL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _rel_close(a, b, rel)


class TestSTFT:
    @pytest.mark.parametrize("n_fft,hop", [(128, 32), (100, 30), (64, 32)])
    @pytest.mark.parametrize("window", ["hann", "hamming"])
    def test_forward_and_inverse_match_jax(self, n_fft, hop, window):
        x = _signal((2, 1000), 1)
        ours = ttf.STFT(n_fft, hop, window, device=CPU)
        theirs = J.STFT(n_fft, hop, window)
        S = ours.forward(x)
        _rel_close(S, theirs.forward(x))
        got, want = _np(ours.inverse(S, 1000)), np.asarray(
            theirs.inverse(np.asarray(theirs.forward(x)), 1000))
        _rel_close(got[..., n_fft:-n_fft], want[..., n_fft:-n_fft])
        _rel_close(got, want, EDGE_REL)

    def test_inverse_of_a_spectrum_with_imaginary_dc(self):
        """A user's spectrum whose DC and Nyquist bins carry imaginary
        parts: the port reads them as pocketfft does (tf.py:42-64)."""
        st, sj = ttf.STFT(64, 16, device=CPU), J.STFT(64, 16)
        S = _np(st.forward(_signal(640, 2))).copy()
        S[..., 0, :] += 0.5j
        S[..., 32, :] -= 0.25j
        got, want = _np(st.inverse(S)), np.asarray(sj.inverse(S))
        _rel_close(got[64:-64], want[64:-64])
        _rel_close(got, want, EDGE_REL)

    def test_overlap_add_matches_scatter(self):
        frames = _signal((2, 7, 50), 3)
        for hop in (10, 17, 50, 60):
            out_len = 50 + 6 * hop
            want = np.zeros((2, out_len), np.float64)
            for f in range(7):
                want[:, f * hop:f * hop + 50] += frames[:, f]
            np.testing.assert_allclose(
                _np(ttf.overlap_add(torch.from_numpy(frames), hop)), want,
                rtol=0, atol=1e-5)

    def test_round_trip(self):
        x = tone(100.0, n=2048) + 0.3 * tone(250.0, n=2048)
        st = ttf.STFT(n_fft=256, hop=64, device=CPU)
        y = _np(st.inverse(st.forward(x), length=2048))
        np.testing.assert_allclose(y[256:-256], x[256:-256], atol=RECON_ATOL)


class TestCWT:
    @pytest.mark.parametrize("wavelet", ["morlet", "ricker", "mexican_hat"])
    def test_matches_jax(self, wavelet):
        x = _signal(700, 4)
        scales = np.arange(2, 30, 3, dtype=np.float32)
        _rel_close(ttf.CWT(wavelet, device=CPU).forward(x, scales),
                   J.CWT(wavelet).forward(x, scales))

    def test_batched_signal(self):
        x = _signal((3, 300), 5)
        scales = np.array([2.0, 5.0], np.float32)
        C = ttf.CWT(device=CPU).forward(x, scales)
        assert C.shape == (2, 3, 300)
        for i in range(3):
            _rel_close(C[:, i], J.CWT().forward(x[i], scales))

    def test_unknown_wavelet_and_scale_of_tone(self):
        with pytest.raises(ValueError, match="unknown wavelet"):
            ttf.CWT("haar", device=CPU)
        cwt = ttf.CWT("morlet", device=CPU)
        scales = np.arange(2, 40, dtype=np.float32)
        C = cwt.forward(tone(50.0, n=2048), scales).abs().numpy()
        best = scales[(C ** 2).mean(axis=1).argmax()]
        assert abs(cwt.scale_to_frequency(best, fs=FS) - 50.0) < 10.0
        np.testing.assert_array_equal(cwt.scale_to_frequency(scales, FS),
                                      J.CWT().scale_to_frequency(scales, FS))


class TestWavelets:
    @pytest.mark.parametrize("wavelet", ["haar", "db1", "db2", "db4"])
    @pytest.mark.parametrize("shape", [(256,), (3, 200)])
    def test_dwt_matches_jax(self, wavelet, shape):
        x = _signal(shape, 6)
        ours, theirs = ttf.DWT(wavelet, device=CPU), J.DWT(wavelet)
        c = ours.decompose(x, level=3)
        _all_close(c, theirs.decompose(x, level=3))
        _rel_close(ours.reconstruct(c),
                   theirs.reconstruct(theirs.decompose(x, level=3)))

    @pytest.mark.parametrize("mode", ["soft", "hard"])
    @pytest.mark.parametrize("threshold", [None, 0.3])
    def test_denoise_matches_jax(self, mode, threshold):
        x = tone(10.0, n=1024) + 0.5 * _signal(1024, 7)
        _rel_close(ttf.DWT("db4", device=CPU).denoise(x, 4, threshold, mode),
                   J.DWT("db4").denoise(x, 4, threshold, mode))

    def test_unknown_wavelet_raises(self):
        with pytest.raises(ValueError, match="unknown wavelet"):
            ttf.DWT("sym5", device=CPU)

    @pytest.mark.parametrize("wavelet", ["db2", "db4"])
    def test_wpt_and_modwt_match_jax(self, wavelet):
        x = _signal((2, 256), 8)
        ours, theirs = ttf.WPT(wavelet, device=CPU), J.WPT(wavelet)
        leaves = ours.decompose(x, level=2)
        _all_close(leaves, theirs.decompose(x, level=2))
        _rel_close(ours.reconstruct(leaves),
                   theirs.reconstruct(theirs.decompose(x, level=2)))
        np.testing.assert_allclose(ours.energy_map(x[0], 2),
                                   theirs.energy_map(x[0], 2), rtol=REL)
        m, mj = ttf.MODWT(wavelet, device=CPU), J.MODWT(wavelet)
        _all_close(m.decompose(x, level=3), mj.decompose(x, level=3))
        np.testing.assert_allclose(m.energy_decomposition(x[0], 3),
                                   mj.energy_decomposition(x[0], 3),
                                   rtol=REL)

    @pytest.mark.parametrize("k", [2, 8, 31])
    def test_fir_corr_matches_jax(self, k):
        x = _signal((2, 300), 9)
        taps = _signal(k, 10)
        _rel_close(ttf.fir_corr(x, taps, device=CPU), jtf.fir_corr(x, taps))

    def test_modwt_batch_takes_the_fir_band_branch(self, monkeypatch):
        """A batch of 8 rows of 65536 samples: each of a level-4 MODWT's 8
        fir_corr calls goes through fir_batch_lanes (the branch that
        launches fir_band on the card), and the result matches JAX."""
        calls = []
        lanes = fir_cuda.fir_batch_lanes

        def counted(*a, **kw):
            calls.append(a[0].shape)
            return lanes(*a, **kw)

        monkeypatch.setattr(fir_cuda, "fir_batch_lanes", counted)
        x = _signal((8, 1 << 16), 11)
        got = ttf.MODWT("db4", device=CPU).decompose(x, level=4)
        assert len(calls) == 8
        assert all(s[0] == 8 and s[1] >= 1 << 16 for s in calls)
        for a, b in zip(got, J.MODWT("db4").decompose(x, level=4)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=FIR_ATOL)

    def test_perfect_reconstruction_and_denoise(self):
        x = _signal(256, 6)
        for wavelet in ("haar", "db2", "db4"):
            dwt = ttf.DWT(wavelet, device=CPU)
            y = _np(dwt.reconstruct(dwt.decompose(x, level=3)))[:256]
            np.testing.assert_allclose(y, x, atol=RECON_ATOL)
        clean = tone(10.0, n=1024)
        noisy = clean + 0.5 * _signal(1024, 7)
        den = _np(ttf.DWT("db4", device=CPU).denoise(noisy, level=4))
        assert ((den - clean) ** 2).mean() < ((noisy - clean) ** 2).mean() / 2
        wpt = ttf.WPT("db2", device=CPU)
        x = _signal(128, 10)
        leaves = wpt.decompose(x, level=2)
        assert len(leaves) == 4
        np.testing.assert_allclose(_np(wpt.reconstruct(leaves))[:128], x,
                                   atol=RECON_ATOL)
        e = ttf.WPT("db4", device=CPU).energy_map(tone(400.0, n=512), 2)
        assert e[2:].sum() > e[:2].sum()
        coeffs = ttf.MODWT("db2", device=CPU).decompose(tone(50.0, n=256), 3)
        assert len(coeffs) == 4 and all(c.shape == (256,) for c in coeffs)
        e = ttf.MODWT("db2", device=CPU).energy_decomposition(
            tone(50.0, n=256), 3)
        assert e[-1] > 0.5 * e.sum()


class TestWignerVille:
    @pytest.mark.parametrize("n", [256, 255])
    def test_matches_jax(self, n):
        x = _signal(n, 12)
        _rel_close(ttf.WignerVille(device=CPU).forward(x),
                   J.WignerVille().forward(x))
        z = (x + 1j * _signal(n, 13)).astype(np.complex64)
        _rel_close(ttf.WignerVille(device=CPU).forward(torch.from_numpy(z)),
                   J.WignerVille().forward(z))
        _rel_close(ttf._analytic(torch.from_numpy(x)), jtf._analytic(x))

    def test_tone_concentration(self):
        wv = ttf.WignerVille(device=CPU)
        W = _np(wv.forward(tone(100.0, n=256)))
        freqs = wv.frequencies(W.shape[0], fs=FS)
        np.testing.assert_array_equal(freqs,
                                      J.WignerVille().frequencies(256, FS))
        assert abs(freqs[np.abs(W).mean(axis=1).argmax()] - 100.0) < 15.0


class TestEMD:
    def test_matches_jax(self):
        x = tone(5.0, n=1024) + 0.5 * tone(80.0, n=1024) \
            + 0.05 * _signal(1024, 14)
        imfs, res = ttf.EMD(max_imfs=4).decompose(torch.from_numpy(x))
        imfs_j, res_j = J.EMD(max_imfs=4).decompose(x)
        assert len(imfs) == len(imfs_j)
        for a, b in zip(imfs + [res], imfs_j + [res_j]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)

    def test_spline_and_extrema_match_jax(self):
        xi = np.sort(np.random.default_rng(15).uniform(0, 100, 12))
        yi = np.sin(xi / 7.0)
        t = np.linspace(0, 100, 333)
        np.testing.assert_array_equal(ttf._cubic_spline(xi, yi, t),
                                      jtf._cubic_spline(xi, yi, t))
        h = np.sin(np.arange(200) / 5.0)
        for op in (np.greater, np.less):
            np.testing.assert_array_equal(ttf._local_extrema(h, op),
                                          jtf._local_extrema(h, op))

    def test_separates_two_scales(self):
        x = tone(5.0, n=1024) + 0.5 * tone(80.0, n=1024)
        imfs, _ = ttf.EMD(max_imfs=4).decompose(x)
        assert len(imfs) >= 2
        f, p = compute_psd(imfs[0].astype(np.float32), fs=FS, nperseg=512,
                           device=CPU)
        assert abs(float(f[p.argmax()]) - 80.0) < 10


class TestMel:
    @pytest.mark.parametrize("n_mels,n_fft,fs", [(40, 512, 16000.0),
                                                 (26, 400, 8000.0)])
    def test_matches_jax(self, n_mels, n_fft, fs):
        np.testing.assert_array_equal(
            ttf.mel_filterbank(n_mels, n_fft, fs),
            jtf.mel_filterbank(n_mels, n_fft, fs))
        x = tone(440.0, n=4096, fs=fs) + 0.1 * _signal(4096, 16)
        _rel_close(ttf.mel_spectrogram(x, fs, n_fft, None, n_mels,
                                       device=CPU),
                   J.mel_spectrogram(x, fs, n_fft, None, n_mels))
        _rel_close(ttf.mfcc(x, fs, n_fft, None, n_mels, 13, device=CPU),
                   J.mfcc(x, fs, n_fft, None, n_mels, 13))

    def test_shapes(self):
        x = tone(440.0, n=4096, fs=16000.0)
        M = ttf.mel_spectrogram(x, fs=16000.0, n_fft=512, n_mels=40,
                                device=CPU)
        assert M.shape[0] == 40
        C = ttf.mfcc(x, fs=16000.0, n_fft=512, n_mfcc=13, device=CPU)
        assert C.shape[0] == 13 and bool(torch.isfinite(C).all())


def _jax_path(name):
    """The JAX package's call of each analysis path (its measured rows,
    scripts/measure_signal.py:102-190; MODWT on the suite's shape)."""
    if name == "iir_8th_1m":
        sos = np.asarray(J.IIRFilter(design="butterworth", order=8,
                                     cutoff=0.2).sos)
        return lambda x: jfilt.sos_apply(x, sos, method="parallel")
    if name == "lms_64_50k":
        return J.AdaptiveFilter(num_taps=64, method="lms", mu=0.01).apply
    if name == "blms_64_50k":
        return J.AdaptiveFilter(num_taps=64, method="block_lms", mu=0.05,
                                block_size=256).apply
    if name == "upsample_4x_1m":
        return lambda x: J.MultirateFilter(num_taps=64).interpolate(x, 4)
    if name == "downsample_4x_1m":
        return lambda x: J.MultirateFilter(num_taps=64).decimate(x, 4)
    if name == "median_11_1m":
        return lambda x: jfilt.median_filter(x, 11)
    if name == "fft_1024_x1k":
        return J.FFT().forward
    if name == "spectrogram_10s":
        return lambda x: J.compute_spectrogram(x, fs=44100.0, nperseg=1024)
    return lambda x: J.MODWT("db4").decompose(x, level=4)


# each path's inputs cut to a size the CPU runs in well under a second
SMALL = {"iir_8th_1m": [(8192,)], "lms_64_50k": [(3000,), (3000,)],
         "blms_64_50k": [(3000,), (3000,)], "upsample_4x_1m": [(2048,)],
         "downsample_4x_1m": [(8192,)], "median_11_1m": [(8192,)],
         "fft_1024_x1k": [(10, 1024)], "spectrogram_10s": [(8000,)],
         "modwt_16x1m": [(2, 5000)]}


class TestAnalysisPaths:
    def test_the_paths(self):
        assert set(ANALYSIS_PATHS) == set(SMALL)
        assert ANALYSIS_PATHS["iir_8th_1m"].shapes == ((1 << 20,),)
        assert ANALYSIS_PATHS["modwt_16x1m"].shapes == ((16, 1_000_000),)
        assert ANALYSIS_PATHS["spectrogram_10s"].shapes == ((441_000,),)
        assert {n: p.fir_band for n, p in ANALYSIS_PATHS.items()
                if p.fir_band} == {"modwt_16x1m": 8}

    @pytest.mark.parametrize("name", sorted(SMALL))
    def test_path_matches_jax(self, name):
        """The slice as a whole: each path as a user calls it, on the CPU
        at a cut size, against the JAX package's call of the same row
        (2e-4 of the scale: the band of the LMS engines,
        tests/test_signal.py:356-358; the others agree far closer)."""
        p = ANALYSIS_PATHS[name]
        rng = np.random.default_rng(3)
        xs = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
              for s in SMALL[name]]
        got = p.call(CPU)(*xs)
        want = _jax_path(name)(*[x.numpy() for x in xs])
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        want = list(want) if isinstance(want, (tuple, list)) else [want]
        _all_close(got, want, 2e-4)

    def test_inputs_are_seeded(self):
        p = ANALYSIS_PATHS["lms_64_50k"]
        a = p.inputs(seed=1, device=CPU)
        b = p.inputs(seed=1, device=CPU)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        assert not torch.equal(a[0], a[1])
