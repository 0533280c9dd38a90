"""The PyTorch port's FIR path held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU, where the port's batch-FIR wrappers run their
kernels' plain versions and the JAX Pallas kernels run in interpret mode.
Tolerances: float32 results at rtol/atol 1e-5, bf16 results within one
bf16 ulp, and against the NumPy oracle the JAX tests' own bands
(tests/test_signal.py:146-225).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.signal import filters as jf  # noqa: E402
from njw_tpu.signal import fir_pallas as jp  # noqa: E402
from njw_tpu.signal import windows as jw  # noqa: E402

from njw_tpu_torch.platform.device import spec_for  # noqa: E402
from njw_tpu_torch.signal import convert  # noqa: E402
from njw_tpu_torch.signal import filters as tf  # noqa: E402
from njw_tpu_torch.signal import fir_cuda as fc  # noqa: E402
from njw_tpu_torch.signal import windows as tw  # noqa: E402
from njw_tpu_torch.signal.main_paths import MAIN_PATHS  # noqa: E402

CPU = "cpu"
RTOL = ATOL = 1e-5
ORACLE_ATOL = 2e-4          # tests/test_signal.py:158


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(shape, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    taps = rng.standard_normal(101).astype(np.float32) * 0.1
    return x, taps


def _oracle(x, taps):
    return np.stack([np.convolve(r, taps)[:x.shape[1]] for r in x])


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    _, e = np.frexp(a.astype(np.float32))
    return np.ldexp(np.ones_like(a, np.float32), e - 8)


class TestWindowsAndDesign:
    @pytest.mark.parametrize("name", sorted(jw.WINDOWS))
    @pytest.mark.parametrize("n", [7, 64, 65])
    def test_windows_match(self, name, n):
        np.testing.assert_array_equal(tw.get_window(name, n),
                                      np.asarray(jw.get_window(name, n)))

    def test_unknown_window_raises(self):
        with pytest.raises(ValueError, match="unknown window"):
            tw.get_window("gauss9", 64)

    @pytest.mark.parametrize("kind,cutoff,num_taps,window", [
        ("lowpass", 0.25, 101, "hamming"), ("lowpass", 0.3, 64, "kaiser"),
        ("highpass", 0.5, 101, "hann"), ("bandpass", (0.3, 0.5), 201,
                                         "blackman"),
        ("bandstop", (0.2, 0.4), 65, "hamming")])
    def test_window_designs_match(self, kind, cutoff, num_taps, window):
        kw = dict(num_taps=num_taps, cutoff=cutoff, filter_type=kind,
                  window=window)
        got = tf.FIRFilter(device=CPU, **kw).taps
        want = jf.FIRFilter(**kw).taps
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)

    def test_highpass_needs_odd_taps(self):
        with pytest.raises(ValueError, match="odd"):
            tf.design_fir_highpass(64, 0.3)

    def test_least_squares_and_equiripple_match(self):
        bands, desired = [(0.0, 0.3), (0.42, 1.0)], [1.0, 0.0]
        np.testing.assert_allclose(
            tf.design_fir_least_squares(61, bands, desired),
            jf.design_fir_least_squares(61, bands, desired), rtol=0,
            atol=1e-7)
        np.testing.assert_allclose(
            tf.design_fir_equiripple(61, bands, desired),
            jf.design_fir_equiripple(61, bands, desired), rtol=0, atol=1e-7)

    def test_frequency_response_matches(self):
        kw = dict(num_taps=51, cutoff=0.3)
        f1, h1 = tf.FIRFilter(device=CPU, **kw).frequency_response(256)
        f2, h2 = jf.FIRFilter(**kw).frequency_response(256)
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_allclose(h1, h2, rtol=0, atol=1e-7)


class TestBandMatrices:
    @pytest.mark.parametrize("k", [1, 15, 101, 128])
    def test_band_matrices_match_exactly(self, k):
        taps = np.random.default_rng(k).standard_normal(k).astype(np.float32)
        for got, want in zip(tf._fir_band_matrices(taps),
                             jf._fir_band_matrices(taps)):
            np.testing.assert_array_equal(got, want)

    def test_bands_are_cached_and_split_exactly(self):
        taps = tf.design_fir_lowpass(101, 0.25)
        bands = tf.fir_bands(taps, CPU)
        assert tf.fir_bands(taps.copy(), torch.device(CPU)) is bands
        h0, h1 = tf._fir_band_matrices(taps)
        hcat = np.concatenate([h1, h0])
        t = bands.terms.float().numpy()
        assert bands.terms.dtype == torch.bfloat16
        assert t.shape == (3, 256, 128)
        np.testing.assert_array_equal(bands.h0.numpy(), hcat[128:])
        np.testing.assert_array_equal(bands.h1.numpy(), hcat[:128])
        # three bf16 terms carry the 24 bits of a float32
        np.testing.assert_allclose(t.sum(0), hcat, rtol=2.0 ** -23, atol=0)
        # each term is the bf16 rounding of what the ones before left
        np.testing.assert_array_equal(
            t[0], _t(hcat).to(torch.bfloat16).float().numpy())

    def test_taps_limits(self):
        with pytest.raises(ValueError, match="taps must be <= 128"):
            tf.fir_bands(np.ones(129, np.float32), CPU)
        with pytest.raises(ValueError, match="at least one tap"):
            tf.fir_bands(np.ones(0, np.float32), CPU)


class TestFirApply:
    @pytest.mark.parametrize("shape,k,mode", [
        ((1000,), 31, "causal"), ((1000,), 31, "same"),
        ((3, 500), 101, "causal"), ((3, 500), 101, "same"),
        ((9, 1000), 128, "causal"), ((2, 3, 600), 64, "same"),
        ((700,), 200, "causal"), ((2, 3, 600), 150, "same"),
        ((4, 900), 129, "causal")])
    def test_matches_jax(self, shape, k, mode):
        rng = np.random.default_rng(k)
        x = rng.standard_normal(shape).astype(np.float32)
        taps = rng.standard_normal(k).astype(np.float32) * 0.1
        got = tf.fir_apply(_t(x), taps, mode)
        assert got.shape == shape and got.dtype == torch.float32
        _close(got, jf.fir_apply(x, taps, mode))

    def test_batch_branch_on_cpu_runs_the_plain_version(self):
        x = np.random.default_rng(0).standard_normal(
            (8, 65536)).astype(np.float32)
        taps = jf.design_fir_lowpass(101, 0.25)
        before = fc.fir_band_cuda.launches
        got = tf.fir_apply(_t(x), taps)
        assert fc.fir_band_cuda.launches == before
        # the branch is the kernel's plain version (bf16 x 3), bit for bit
        torch.testing.assert_close(got, fc.fir_band_plain(_t(x), taps,
                                                           passes=3),
                                   rtol=0, atol=0)
        _close(got, jf.fir_apply(x, taps), rtol=0, atol=2e-4)

    def test_bad_mode_raises(self):
        with pytest.raises(ValueError):
            tf.fir_apply(_t(np.zeros(16)), np.ones(3), mode="full")

    def test_tensors_stay_on_their_device_and_numpy_defaults_to_cuda(self):
        x = np.random.default_rng(1).standard_normal(256).astype(np.float32)
        taps = np.ones(5, np.float32) / 5
        assert tf.fir_apply(_t(x), taps).device.type == CPU
        assert tf.fir_apply(x, taps, device=CPU).device.type == CPU
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tf.fir_apply(x, taps)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tf.FIRFilter(taps).apply(x)


class TestLanesWrapper:
    """fir_batch_lanes (K7) against fir_batch_pallas_lanes in interpret
    mode, at the shapes of tests/test_signal.py:174-187."""

    @pytest.mark.parametrize("shape", [(3, 1000), (9, 4096), (2, 300)])
    @pytest.mark.parametrize("passes", [0, 1, 2, 3])
    @pytest.mark.parametrize("scratch", [True, False])
    def test_matches_pallas(self, shape, passes, scratch):
        x, taps = _signal(shape)
        got = fc.fir_batch_lanes(_t(x), taps, passes=passes, scratch=scratch)
        want = jp.fir_batch_pallas_lanes(x, taps, block_rows=8,
                                         block_frames=4, passes=passes,
                                         scratch=scratch, interpret=True)
        _close(got, want)
        if passes in (0, 3):
            _close(got, _oracle(x, taps), rtol=0, atol=ORACLE_ATOL)

    @pytest.mark.parametrize("shape", [(3, 1000), (9, 4096), (2, 300)])
    @pytest.mark.parametrize("scratch", [True, False])
    def test_passes_6_is_bf16_x3(self, shape, scratch):
        """passes=6 is the TPU's Precision.HIGH, which runs bf16 x 3: the
        JAX kernel's explicit three-pass split (passes=3). On the CPU the
        JAX interpreter evaluates HIGH in float32, which the port meets at
        the oracle's band."""
        x, taps = _signal(shape)
        got = fc.fir_batch_lanes(_t(x), taps, passes=6, scratch=scratch)
        _close(got, jp.fir_batch_pallas_lanes(
            x, taps, block_rows=8, block_frames=4, passes=3,
            scratch=scratch, interpret=True))
        _close(got, jp.fir_batch_pallas_lanes(
            x, taps, block_rows=8, block_frames=4, passes=6, scratch=True,
            interpret=True), rtol=0, atol=ORACLE_ATOL)
        _close(got, _oracle(x, taps), rtol=0, atol=ORACLE_ATOL)

    def test_reference_fault_passes_6_without_scratch(self):
        """A fault of the reference that the port does not copy: the JAX
        non-scratch lanes kernel at passes=6 adds x_hi H on top of
        x_hi H + x_lo H (its H terms are the unsplit float32 band), about
        twice the answer. The port's two forms agree with the oracle."""
        x, taps = _signal((3, 1000))
        ref = _oracle(x, taps)
        jax_bad = np.asarray(jp.fir_batch_pallas_lanes(
            x, taps, block_rows=8, block_frames=4, passes=6, scratch=False,
            interpret=True))
        assert np.abs(jax_bad - ref).max() > 1.0
        for scratch in (True, False):
            _close(fc.fir_batch_lanes(_t(x), taps, passes=6,
                                      scratch=scratch), ref, rtol=0,
                   atol=ORACLE_ATOL)

    def test_block_parameters_do_not_change_the_value(self):
        x, taps = _signal((9, 4096))
        a = fc.fir_batch_lanes(_t(x), taps)
        b = fc.fir_batch_lanes(_t(x), taps, block_rows=3, block_frames=1,
                               scratch=False)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class TestBatchAndFlatWrappers:
    @pytest.mark.parametrize("shape", [(3, 1000), (9, 4096), (2, 300)])
    @pytest.mark.parametrize("passes", [1, 2, 3])
    def test_batch_matches_pallas(self, shape, passes):
        x, taps = _signal(shape)
        got = fc.fir_batch(_t(x), taps, passes=passes)
        _close(got, jp.fir_batch_pallas(x, taps, block_rows=8,
                                        block_frames=4, passes=passes,
                                        interpret=True))
        if passes == 3:
            _close(got, _oracle(x, taps), rtol=0, atol=ORACLE_ATOL)

    def test_batch_single_pass_accuracy(self):
        """tests/test_signal.py:213-225: passes=1 within 5e-3 of max|ref|."""
        x = np.random.default_rng(9).standard_normal(
            (2, 2048)).astype(np.float32)
        taps = (np.hanning(64) / np.hanning(64).sum()).astype(np.float32)
        got = fc.fir_batch(_t(x), taps, passes=1).numpy()
        ref = _oracle(x, taps)
        assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-3

    @pytest.mark.parametrize("shape", [(4, 800), (5, 1280)])
    @pytest.mark.parametrize("passes", [1, 2, 3])
    def test_flat_matches_pallas(self, shape, passes):
        """The JAX flat entry patches each row's first k-1 outputs with the
        framed product at XLA's default precision (float32 on the CPU); the
        port computes them at ``passes`` like the rest of the row. The rest
        matches at 1e-5; the heads, at the oracle's band for ``passes``."""
        x, taps = _signal(shape, seed=17)
        k = len(taps)
        got = fc.fir_batch_flat(_t(x), taps, passes=passes).numpy()
        want = np.asarray(jp.fir_batch_pallas_flat(
            x, taps, block_frames=8, passes=passes, interpret=True))
        _close(got[:, k - 1:], want[:, k - 1:])
        ref = _oracle(x, taps)
        head_tol = ORACLE_ATOL if passes == 3 else 5e-3 * np.abs(ref).max()
        _close(got[:, :k - 1], want[:, :k - 1], rtol=0, atol=head_tol)
        if passes == 3:
            _close(got, ref, rtol=0, atol=ORACLE_ATOL)


class TestBf16Wrapper:
    @pytest.mark.parametrize("shape", [(3, 1000), (2, 300), (9, 4096)])
    @pytest.mark.parametrize("taps_passes", [1, 2])
    @pytest.mark.parametrize("scratch", [True, False])
    def test_matches_pallas_within_one_ulp(self, shape, taps_passes,
                                           scratch):
        x, taps = _signal(shape)
        got = fc.fir_batch_bf16(_t(x), taps, taps_passes=taps_passes,
                                scratch=scratch)
        assert got.dtype == torch.bfloat16
        want = np.asarray(jp.fir_batch_pallas_bf16(
            x, taps, block_rows=8, block_frames=4, taps_passes=taps_passes,
            scratch=scratch, interpret=True), np.float32)
        g = got.float().numpy()
        assert (np.abs(g - want) <= _bf16_ulp(want)).all()
        # tests/test_signal.py:205-211
        ref = _oracle(x, taps)
        band = 1.5e-2 if taps_passes == 2 else 3e-2
        assert np.abs(g - ref).max() / np.abs(ref).max() < band

    def test_float32_output_and_bf16_input(self):
        x, taps = _signal((3, 1000))
        xb = _t(x).to(torch.bfloat16)
        got = fc.fir_batch_bf16(xb, taps, taps_passes=2,
                                out_dtype=torch.float32)
        assert got.dtype == torch.float32
        want = jp.fir_batch_pallas_bf16(
            jnp.asarray(x).astype(jnp.bfloat16), taps, block_rows=8,
            block_frames=4, taps_passes=2, out_dtype=jnp.float32,
            interpret=True)
        _close(got, want)


class TestWrapperChecks:
    def test_value_errors(self):
        x, taps = _signal((3, 1000))
        xt = _t(x)
        cases = [
            (lambda: fc.fir_batch_lanes(xt[0], taps), "expects \\(B, n\\)"),
            (lambda: fc.fir_batch_lanes(xt, np.ones(129)), "taps must be"),
            (lambda: fc.fir_batch_lanes(xt, taps, passes=4), "passes"),
            (lambda: fc.fir_batch(xt[None], taps), "expects \\(B, n\\)"),
            (lambda: fc.fir_batch(xt, np.ones(129)), "taps must be"),
            (lambda: fc.fir_batch(xt, taps, passes=0), "passes"),
            (lambda: fc.fir_batch_flat(_t(np.ones((3, 300))), taps),
             "% 128 == 0"),
            (lambda: fc.fir_batch_flat(_t(np.ones((4, 96))), taps),
             "n >= 256"),
            (lambda: fc.fir_batch_flat(_t(np.ones((4, 800))),
                                       np.ones(129)), "taps must be"),
            (lambda: fc.fir_batch_bf16(xt[0], taps), "expects \\(B, n\\)"),
            (lambda: fc.fir_batch_bf16(xt, np.ones(129)), "taps must be"),
            (lambda: fc.fir_batch_bf16(xt, taps, taps_passes=3),
             "taps_passes"),
            (lambda: fc.fir_batch_bf16(xt, taps, out_dtype=torch.float16),
             "out_dtype"),
            (lambda: fc.fir_band_cuda(xt, taps), "CUDA tensors only"),
            (lambda: fc.fir_band_bf16_cuda(xt.to(torch.bfloat16), taps),
             "CUDA tensors only"),
        ]
        for call, match in cases:
            with pytest.raises(ValueError, match=match):
                call()

    def test_jax_raises_alike(self):
        x, taps = _signal((3, 300))
        with pytest.raises(ValueError, match="% 128 == 0"):
            jp.fir_batch_pallas_flat(x, taps, interpret=True)
        with pytest.raises(ValueError, match="taps must be"):
            jp.fir_batch_pallas_lanes(x, np.ones(129), interpret=True)

    def test_kernel_level_checks(self):
        x, taps = _signal((3, 1000))
        with pytest.raises(TypeError, match="float32"):
            fc.fir_band_plain(_t(x).double(), taps)
        with pytest.raises(ValueError, match="contiguous"):
            fc.fir_band_plain(_t(x).t(), taps)
        with pytest.raises(TypeError, match="bfloat16"):
            fc.fir_band_bf16_plain(_t(x), taps)

    def test_empty_batch(self):
        _, taps = _signal((1, 1))
        out = fc.fir_batch_lanes(torch.zeros(0, 500), taps)
        assert out.shape == (0, 500)


class TestStreamingAndMultirate:
    def test_streaming_matches_one_shot(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal(3000).astype(np.float32)
        taps = tf.design_fir_lowpass(31, 0.3)
        sf = tf.StreamingFIR(taps, device=CPU)
        chunks = [sf.process(x[i:i + 700]) for i in range(0, 3000, 700)]
        _close(torch.cat(chunks), tf.fir_apply(_t(x), taps))
        sf.reset()
        assert float(sf._tail.abs().sum()) == 0.0

    def test_streaming_carries_over_from_jax(self):
        rng = np.random.default_rng(6)
        x = rng.standard_normal(2400).astype(np.float32)
        taps = jf.design_fir_lowpass(31, 0.3)
        j = jf.StreamingFIR(taps)
        for i in range(0, 1200, 400):
            j.process(x[i:i + 400])
        sf = convert.streaming_fir_from(j, device=CPU)
        for i in range(1200, 2400, 400):
            _close(sf.process(x[i:i + 400]), j.process(x[i:i + 400]))
        state = convert.streaming_fir_state(sf)
        _close(state["tail"], np.asarray(j._tail), rtol=0, atol=0)
        again = convert.streaming_fir_from(state, device=CPU)
        _close(again.process(x[:400]), j.process(x[:400]))

    def test_streaming_state_shape_is_checked(self):
        with pytest.raises(ValueError, match="tail"):
            convert.streaming_fir_from({"taps": np.ones(5),
                                        "tail": np.zeros(3)}, device=CPU)

    def test_fir_filter_from_jax(self):
        j = jf.FIRFilter(num_taps=101, cutoff=0.25)
        port = convert.fir_filter_from(j, device=CPU)
        x = np.random.default_rng(2).standard_normal((2, 1000)).astype(
            np.float32)
        _close(port(_t(x)), j(x))

    @pytest.mark.parametrize("op,args", [
        ("decimate", (4,)), ("interpolate", (3,)), ("resample", (3, 2))])
    def test_multirate_matches_jax(self, op, args):
        rng = np.random.default_rng(8)
        x = rng.standard_normal((2, 1200)).astype(np.float32)
        got = getattr(tf.MultirateFilter(device=CPU), op)(_t(x), *args)
        want = getattr(jf.MultirateFilter(), op)(x, *args)
        assert tuple(got.shape) == tuple(np.shape(want))
        _close(got, want)


class TestMainPathsAndPlatform:
    def test_main_paths(self):
        assert set(MAIN_PATHS) == {"fir_batch", "fir_suite", "fir_bf16"}
        assert MAIN_PATHS["fir_batch"].shape == (1000, 100_000)
        assert MAIN_PATHS["fir_suite"].shape == (16, 1_000_000)
        for p in MAIN_PATHS.values():
            assert 8 <= p.shape[0] and p.shape[1] >= 1 << 16  # batch branch
            np.testing.assert_array_equal(p.taps(),
                                          jf.design_fir_lowpass(101, 0.25))

    @pytest.mark.parametrize("name", ["fir_batch", "fir_bf16"])
    def test_main_path_call_on_a_small_signal(self, name):
        p = MAIN_PATHS[name]
        x = p.signal(seed=3, device=CPU)[:8, :70000]
        assert x.dtype == p.dtype
        y = p.call(device=CPU)(x)
        ref = jf.fir_apply(x.float().numpy(), p.taps())
        tol = ORACLE_ATOL if p.dtype == torch.float32 else 1.5e-2 * float(
            np.abs(ref).max())
        _close(y.float(), ref, rtol=0, atol=tol)

    @pytest.mark.parametrize("name,peak", [
        ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0),
        ("NVIDIA H100 NVL", 835.0), ("NVIDIA H200", 989.0),
        ("NVIDIA A100-SXM4-80GB", None)])
    def test_tensor_core_peak(self, name, peak):
        assert spec_for(name)[2] == peak


def _source_constant(name: str) -> int:
    import re
    from njw_tpu_torch.ops import _build
    text = (_build.CSRC / "fir_band.cuh").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


class TestKernelLayout:
    """fir_cuda.fir_layout / fir_schedule, the Python mirror of the launch
    geometry in ops/csrc/fir_band.cuh, and the band tiles the kernel keeps
    in registers (the card tests hold the built kernels to the mirror)."""

    def test_constants_match_the_source(self):
        assert _source_constant("F") == tf.FRAME
        assert _source_constant("FR") == fc.TILE_FRAMES
        assert _source_constant("WARPS") * 32 == fc.THREADS
        assert _source_constant("PITCH") == fc.PITCH
        assert _source_constant("BOX") == fc.BOX
        assert _source_constant("SMEM_PER_SM") == fc.SMEM_PER_SM

    # (dtype, passes, output) -> ring stages, blocks an SM, shared bytes:
    # the rule of fir_band.cuh (ring_stages, blocks_per_sm, smem_bytes; a
    # stage holds a tile of x, then of y)
    @pytest.mark.parametrize("dtype,passes,out,stages,bpsm,smem", [
        (torch.float32, 1, None, 2, 2, 2 * 32768 + 17680 + 16),
        (torch.float32, 2, None, 2, 2, 2 * 32768 + 2 * 17680 + 16),
        (torch.float32, 3, None, 2, 2, 2 * 32768 + 2 * 17680 + 16),
        (torch.float32, 6, None, 2, 2, 2 * 32768 + 2 * 17680 + 16),
        (torch.float32, 0, None, 1, 2, 32768 + 3 * 17680 + 8),
        (torch.bfloat16, 1, None, 3, 3, 3 * 16384 + 17680 + 24),
        (torch.bfloat16, 2, torch.bfloat16, 3, 3, 3 * 16384 + 17680 + 24),
        (torch.bfloat16, 1, torch.float32, 2, 2, 2 * 32768 + 17680 + 16)])
    def test_layout_of_each_instantiation(self, dtype, passes, out, stages,
                                          bpsm, smem):
        lay = fc.fir_layout(1000, 100_000, dtype, passes, out_dtype=out)
        assert (lay.stages, lay.blocks_per_sm, lay.smem_bytes) == (
            stages, bpsm, smem)
        assert lay.frames == 64 and lay.threads == 128
        assert bpsm * (smem + 1024) <= fc.SMEM_PER_SM
        assert lay.tiles == 1000 * 13 and lay.grid == bpsm * 132
        assert lay.streamed
        assert fc.fir_layout(1, 100, dtype, passes, sms=7).grid == 1

    @pytest.mark.parametrize("rows,n", [
        (7, 777), (3, 65537), (1, 10**6), (2, 8192), (2, 16384),
        (2, 16384 + 128), (16, 10**6), (1000, 100_000), (1, 1), (5, 1280)])
    @pytest.mark.parametrize("sms", [1, 3, 132])
    def test_schedule_covers_every_frame_once(self, rows, n, sms):
        lay = fc.fir_layout(rows, n, sms=sms)
        sched = fc.fir_schedule(rows, n, lay.grid)
        frames = -(-n // tf.FRAME)
        seen = np.zeros((rows, frames), np.int32)
        assert len(sched) == lay.grid == min(lay.tiles, 2 * sms)
        assert sum(len(b) for b in sched) == lay.tiles
        flat = [t for b in sched for t in b]
        assert flat == sorted(flat)          # contiguous, in row order
        for block in sched:
            assert block                     # no block without a tile
            for i, (row, t0) in enumerate(block):
                f0 = t0 // tf.FRAME
                seen[row, f0:f0 + fc.TILE_FRAMES] += 1
                if i and t0:   # the previous frame is the last tile's last
                    assert block[i - 1] == (row, t0 - fc.TILE_FRAMES
                                            * tf.FRAME)
        assert (seen == 1).all()

    @pytest.mark.parametrize("shape,dtype,offset,streamed", [
        ((1000, 100_000), torch.float32, 0, True),
        ((16, 10**6), torch.float32, 0, True),
        ((1000, 100_000), torch.bfloat16, 0, True),
        ((7, 777), torch.float32, 0, False),        # row stride 3108 B
        ((3, 65537), torch.float32, 0, False),
        ((3, 1000), torch.float32, 4, False),       # a view 4 B in
        ((7, 777), torch.bfloat16, 0, False),
        ((3, 1000), torch.bfloat16, 2, False),
        ((3, 1000), torch.bfloat16, 0, True),       # 2000 B rows
        ((2, 300), torch.float32, 0, True),
        ((2, 200), torch.float32, 0, False),        # shorter than a box
        ((1, 10**6), torch.float32, 0, True),
        ((2, 8192), torch.float32, 0, True)])
    def test_each_shape_takes_the_branch_the_source_says(self, shape, dtype,
                                                         offset, streamed):
        lay = fc.fir_layout(*shape, dtype, data_ptr=4096 + offset)
        assert lay.streamed is streamed

    @pytest.mark.parametrize("k", [1, 16, 101, 128])
    def test_band_tiles_the_kernel_holds(self, k):
        """The kernel keeps only the 16 x 16 tiles (kt = d, jt = 0), d =
        0..8, of each term, as mma.sync B fragments, and uses tile d for
        every (kt, jt) with kt - jt = d >= (129 - k) // 16: every other
        tile of the band must be zero and each used one equal to its d's."""
        taps = np.random.default_rng(k).standard_normal(k).astype(np.float32)
        terms = tf.fir_bands(taps, CPU).terms.float().numpy()
        c = (129 - k) // 16

        def tile(j, kt, jt):
            return terms[j, 16 * kt:16 * kt + 16, 16 * jt:16 * jt + 16]

        # the fragments as the kernel gathers them, lane by lane:
        # b[j][d][half][reg] = rows 16 d + 2 (lane % 4) + 8 reg (+1),
        # column 8 half + lane / 4
        held = np.zeros((3, 9, 16, 16), np.float32)
        for j in range(3):
            for d in range(9):
                for half in range(2):
                    for reg in range(2):
                        for lane in range(32):
                            r = 2 * (lane % 4) + 8 * reg
                            col = 8 * half + lane // 4
                            for e in range(2):
                                held[j, d, r + e, col] = terms[
                                    j, 16 * d + r + e, col]
        for j in range(3):
            for d in range(9):
                np.testing.assert_array_equal(held[j, d], tile(j, d, 0))
            for kt in range(16):
                for jt in range(8):
                    d = kt - jt
                    if c <= d <= 8:
                        np.testing.assert_array_equal(tile(j, kt, jt),
                                                      held[j, d])
                    else:
                        assert not tile(j, kt, jt).any(), (j, kt, jt)
