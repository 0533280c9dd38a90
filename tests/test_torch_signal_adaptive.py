"""The port's AdaptiveFilter held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances: LMS and NLMS on either engine,
and block LMS, at 2e-4 of max|y| for y and e and 5e-4 for w, the band
the JAX tests hold the parallel engine to (tests/test_signal.py:356-358);
system identification at the JAX tests' atol 0.05 (:335, :599).

RLS: its float32 recurrence from P = I / 1e-6 is ill-conditioned over
long runs (ROADMAP.md §3, ``TestRlsConditioning``: against a float64
evaluation of the same update the port parts by 1e-5 of the scale after
512 samples or more on the JAX test's 4-tap system, and within 64 on a
noisy 16-tap one), so
the port is held to JAX on y and e over the first 512 samples at 1e-4
of the scale, and on the final weights of 4000 samples at 1e-4 (the JAX
band is 0.05 from the true system).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu.signal import filters as jf  # noqa: E402

from njw_tpu_torch.signal import filters as tf  # noqa: E402

CPU = "cpu"
Y_REL = 2e-4            # of max|y|: tests/test_signal.py:356-357, 375
W_ATOL = 5e-4           # :358
SYSID_ATOL = 0.05       # :335, :599
RLS_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(n, taps, seed, noise=0.01):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    h = rng.standard_normal(taps).astype(np.float32) * 0.3
    d = (np.convolve(x, h)[:n] + noise * rng.standard_normal(n)).astype(
        np.float32)
    return x, d


def _both(x, d, **kw):
    ours = [a.numpy() for a in tf.AdaptiveFilter(device=CPU, **kw).apply(x, d)]
    theirs = [np.asarray(a) for a in jf.AdaptiveFilter(**kw).apply(x, d)]
    return ours, theirs


def _close(ours, theirs, y_rel=Y_REL, w_atol=W_ATOL):
    (y, e, w), (yj, ej, wj) = ours, theirs
    assert y.shape == yj.shape and e.shape == ej.shape and w.shape == wj.shape
    scale = float(np.abs(yj).max())
    np.testing.assert_allclose(y, yj, atol=y_rel * scale)
    np.testing.assert_allclose(e, ej, atol=y_rel * scale)
    np.testing.assert_allclose(w, wj, atol=w_atol)


class TestAgainstJax:
    @pytest.mark.parametrize("method,mu", [("lms", 0.01), ("nlms", 0.4)])
    @pytest.mark.parametrize("engine", ["scan", "parallel"])
    @pytest.mark.parametrize("chunk", [64, 128])
    def test_lms_nlms(self, method, mu, engine, chunk):
        x, d = _system(1500, 16, 11)
        _close(*_both(x, d, num_taps=16, method=method, mu=mu,
                      engine=engine, chunk=chunk))

    @pytest.mark.parametrize("n", [1023, 1024, 1337])
    def test_auto_engine_and_ragged(self, n):
        """auto takes the parallel engine from 1024 samples, in both; the
        chunks' zero-padded tail rows are exact no-ops."""
        x, d = _system(n, 64, 3, noise=1.0)
        _close(*_both(x, d, num_taps=64, method="lms", mu=0.005))

    @pytest.mark.parametrize("n,block", [(2000, 128), (1000, 64), (200, 64),
                                         (50, 64)])
    def test_block_lms(self, n, block):
        x, d = _system(n, 8, 12)
        _close(*_both(x, d, num_taps=8, method="block_lms", mu=0.05,
                      block_size=block))

    @pytest.mark.parametrize("seed", [5, 6, 7, 8])
    def test_rls_outputs_first_512(self, seed):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(512).astype(np.float32)
        d = np.convolve(x, [0.5, -0.3, 0.2, 0.1])[:512].astype(np.float32)
        _close(*_both(x, d, num_taps=4, method="rls"), y_rel=RLS_REL,
               w_atol=RLS_REL)

    def test_rls_final_weights(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal(4000).astype(np.float32)
        d = np.convolve(x, [0.5, -0.3, 0.2, 0.1])[:4000].astype(np.float32)
        (_, _, w), (_, _, wj) = _both(x, d, num_taps=4, method="rls")
        np.testing.assert_allclose(w, wj, atol=RLS_REL)


def _rls64(x, d, taps: int, lam: float, eps: float):
    """The same RLS update in float64 NumPy (P from I / eps, no
    symmetrisation): (y, w)."""
    xp = np.concatenate([np.zeros(taps - 1), x.astype(np.float64)])
    w = np.zeros(taps)
    P = np.eye(taps) / eps
    y = np.zeros(len(x))
    for t in range(len(x)):
        f = xp[t:t + taps][::-1]
        Pf = P @ f
        k = Pf / (lam + f @ Pf)
        y[t] = w @ f
        w = w + k * (d[t] - y[t])
        P = (P - np.outer(k, Pf)) / lam
    return y, w


class TestRlsConditioning:
    """Why RLS is held over its first 512 samples: the port's float32 RLS
    against a float64 evaluation of the same update (ROADMAP.md §3)."""

    @staticmethod
    def _parting(x, d, taps):
        af = tf.AdaptiveFilter(num_taps=taps, method="rls", device=CPU)
        y, _, w = (a.double().numpy() for a in af.apply(x, d))
        y64, w64 = _rls64(x, d, taps, af.forgetting, af.eps)
        rel = np.abs(y - y64) / np.abs(y64).max()
        return rel, float(np.abs(w - w64).max())

    @pytest.mark.parametrize("seed", [5, 6, 7])
    def test_4_tap_system_holds_float64_past_512(self, seed):
        """The JAX test's noise-free 4-tap system: within 1e-5 of the
        scale over the first 512 samples, final weights within 1e-5."""
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(4096).astype(np.float32)
        d = np.convolve(x, [0.5, -0.3, 0.2, 0.1])[:4096].astype(np.float32)
        rel, w_diff = self._parting(x, d, 4)
        assert rel[:512].max() <= 1e-5
        assert w_diff <= 1e-5

    @pytest.mark.parametrize("seed", [5, 6, 7])
    def test_noisy_16_tap_system_parts_early(self, seed):
        """16 random taps with noise: parts from float64 by 1e-4 of the
        scale within the first 64 samples (the reference's float32 update
        amplifies rounding; JAX's evaluation parts the same way)."""
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(512).astype(np.float32)
        h = rng.standard_normal(16).astype(np.float32) * 0.3
        d = (np.convolve(x, h)[:512]
             + 0.01 * rng.standard_normal(512)).astype(np.float32)
        rel, _ = self._parting(x, d, 16)
        assert (rel[:64] > 1e-4).any()


class TestBehaviour:
    """The JAX tests' checks (tests/test_signal.py:320-376, 583-610)."""

    @pytest.mark.parametrize("method", ["lms", "nlms", "rls"])
    def test_system_identification(self, method):
        rng = np.random.default_rng(5)
        x = rng.standard_normal(4000).astype(np.float32)
        h_true = np.array([0.5, -0.3, 0.2, 0.1], np.float32)
        d = np.convolve(x, h_true)[:4000].astype(np.float32)
        mu = 0.05 if method == "lms" else 0.5
        _, e, w = tf.AdaptiveFilter(num_taps=4, method=method, mu=mu,
                                    device=CPU).apply(x, d)
        assert float((e.numpy()[-500:] ** 2).mean()) < 1e-2
        np.testing.assert_allclose(w.numpy(), h_true, atol=SYSID_ATOL)

    @pytest.mark.parametrize("method,mu", [("lms", 0.01), ("nlms", 0.4)])
    def test_parallel_engine_matches_scan(self, method, mu):
        x, d = _system(5000, 16, 11)
        ys, es, ws = (a.numpy() for a in tf.AdaptiveFilter(
            num_taps=16, method=method, mu=mu, engine="scan",
            device=CPU).apply(x, d))
        yp, ep, wp = (a.numpy() for a in tf.AdaptiveFilter(
            num_taps=16, method=method, mu=mu, engine="parallel", chunk=64,
            device=CPU).apply(x, d))
        scale = float(np.abs(ys).max())
        np.testing.assert_allclose(yp, ys, atol=Y_REL * scale)
        np.testing.assert_allclose(ep, es, atol=Y_REL * scale)
        np.testing.assert_allclose(wp, ws, atol=W_ATOL)

    def test_block_lms_system_identification(self):
        rng = np.random.default_rng(11)
        x = rng.standard_normal(8000).astype(np.float32)
        h_true = np.array([0.5, -0.3, 0.2, 0.1], np.float32)
        d = tf.fir_apply(x, h_true, device=CPU).numpy()
        _, e, w = tf.AdaptiveFilter(num_taps=8, method="block_lms", mu=0.05,
                                    block_size=128, device=CPU).apply(x, d)
        assert np.mean(e.numpy()[-1000:] ** 2) < 0.01 * np.mean(d ** 2)
        np.testing.assert_allclose(w.numpy()[:4], h_true, atol=SYSID_ATOL)

    def test_block_lms_ragged_tail(self):
        x = np.random.default_rng(0).standard_normal(200).astype(np.float32)
        y, e, w = tf.AdaptiveFilter(num_taps=4, method="block_lms",
                                    block_size=64, device=CPU).apply(x, x)
        assert y.shape == (200,) and e.shape == (200,) and w.shape == (4,)

    @pytest.mark.parametrize("L", [1, 3, 64])
    def test_frames_are_jax_shifted_slices(self, L):
        """The unfolded windows equal JAX's L shifted slices of the
        zero-padded signal (filters.py:655-657): frames[t, j] = x[t - j]."""
        x = np.arange(1.0, 101.0, dtype=np.float32)
        xpad = np.concatenate([np.zeros(L - 1, np.float32), x])
        want = np.stack([xpad[L - 1 - j:L - 1 - j + 100] for j in range(L)],
                        axis=1)
        np.testing.assert_array_equal(
            tf.adaptive_frames(torch.from_numpy(x), L).numpy(), want)

    def test_unknown_method_raises(self):
        with pytest.raises(ValueError, match="unknown adaptive method"):
            tf.AdaptiveFilter(method="kalman", device=CPU).apply(
                np.zeros(8, np.float32), np.zeros(8, np.float32))

    def test_tensors_stay_on_their_device(self):
        x = torch.zeros(64)
        y, e, w = tf.AdaptiveFilter(num_taps=4).apply(x, np.zeros(64))
        assert y.device == e.device == w.device == x.device
