"""The port's examples (njw_tpu_torch.examples) held against the JAX
package's scripts in examples/, on the CPU.

One case per example, at a small size: the port's ``main(argv)`` with
``--device cpu`` and the JAX script by ``runpy`` with ``sys.argv``
patched, at the same arguments. The numbers each prints are compared,
timings excluded (keys and text that carry ms, seconds, rates or wall
time), within the case's stated tolerance: values the scripts round
(PSNR to 0.01 dB, registration parameters to 1e-3, losses to 1e-5) by
twice that unit; float32 results of the same computation by a relative
1e-3 or tighter (the ports differ from XLA in rounding only), and a
relative drift of float32 energies by 1e-5 absolute (its float32
noise); integers and strings exactly. Where a script draws random numbers through a framework's own
generator, both packages are given the JAX draw: the N-body and MD
factories are patched to return the JAX factory's state (carried across
by ``nbody.convert`` / ``md.convert``), and the Monte-Carlo draws of the
financial example are ``jax.random.normal(PRNGKey(seed), shape)``. The
financial example's efficient frontier is cut to 2 points in both
packages (its NumPy solver is the same code in both and takes a minute
at 10 points; tests/test_torch_financial.py holds it bit for bit).
"""
import contextlib
import io
import json
import math
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

import jax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"

# keys whose values are timings or rates (excluded from the comparison)
TIMING_KEY = re.compile(
    r"(_ms$|^ms$|^ms_|_s$|^seconds$|speedup|per_second|^wall|time_ms|"
    r"^mcups$|^timings$|^report$|^figure$)")
# text that carries a timing, or a path
TIMING_TEXT = [re.compile(p) for p in (
    r"\(\s*[\d.]+ ms\)", r"[\d.]+ ms", r"timings: \{.*\}",
    r"(report|figure|figures): .*$", r"panels \+ psnr\.json in .*$")]
NUMBER = re.compile(r"-?\d[\d,]*\.?\d*(?:[eE][-+]?\d+)?")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(obj, prefix=""):
    """(path, value) of every number, string and None in a JSON value,
    skipping timing keys."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if not TIMING_KEY.search(str(k)):
                yield from _flatten(v, f"{prefix}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def printed_values(text: str) -> list:
    """What an example printed, timings excluded: JSON documents flattened
    to (path, value), the numbers of every other line in order."""
    out, dec = [], json.JSONDecoder()
    lines = text.splitlines(keepends=True)
    pos = 0
    while pos < len(lines):
        chunk = "".join(lines[pos:])
        stripped = chunk.lstrip()
        if stripped[:1] in "{[":
            try:
                obj, end = dec.raw_decode(stripped)
            except json.JSONDecodeError:
                obj = None
            if obj is not None:
                out += list(_flatten(obj))
                consumed = len(chunk) - len(stripped) + end
                pos += chunk[:consumed].count("\n") + 1
                continue
        line = lines[pos]
        pos += 1
        if line.lstrip().startswith("{'"):      # a dict printed by repr
            obj = eval(line, {"__builtins__": {}})  # noqa: S307
            out += list(_flatten(obj))
            continue
        for pat in TIMING_TEXT:
            line = pat.sub("", line)
        words = NUMBER.sub(" ", line).split()
        out.append(("text", " ".join(words)))
        out += [("num", float(m.replace(",", ""))) for m in
                NUMBER.findall(line)]
    return out


def assert_same_values(got, want, rtol, atol):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        if isinstance(b, bool) or isinstance(b, str) or b is None:
            assert a == b, (k, a, b)
        elif isinstance(b, int) and not isinstance(a, float):
            assert a == b, (k, a, b)
        else:
            assert math.isclose(a, b, rel_tol=rtol, abs_tol=atol), (k, a, b)


def run_port(name, argv) -> str:
    import importlib

    mod = importlib.import_module(f"njw_tpu_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv) + ["--device", CPU])
    assert rc == 0
    return buf.getvalue()


def run_jax(name, argv, monkeypatch) -> str:
    script = REPO / "examples" / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(script)] + list(argv))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_path(str(script), run_name="__main__")
        except SystemExit as e:
            assert e.code in (None, 0)
    return buf.getvalue()


def compare(name, argv, monkeypatch, rtol=1e-3, atol=1e-6):
    got = printed_values(run_port(name, argv))
    want = printed_values(run_jax(name, argv, monkeypatch))
    assert len(want) > 0
    assert_same_values(got, want, rtol, atol)
    return got


def _jax_normals(seed, shape, device=None):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), shape, jax.numpy.float32)))


EXAMPLES = sorted(f.stem for f in (REPO / "examples").glob("*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_cuda_without_a_card(name, tmp_path, monkeypatch):
    """Each example runs on the card unless asked for the CPU, and says so
    before it writes anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"njw_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
    assert list(tmp_path.iterdir()) == []


def test_shallow_water_example(tmp_path, monkeypatch):
    base = ["--width", "32", "--height", "32", "--steps", "20"]
    got = compare("shallow_water_example",
                  base + ["--output-dir", str(tmp_path), "--animate"],
                  monkeypatch)
    assert dict(got)[".num_steps"] == 20
    for f in ("height.png", "velocity.png", "vorticity.png", "height.gif"):
        assert (tmp_path / f).stat().st_size > 0
    compare("shallow_water_example", base + ["--compare-methods"],
            monkeypatch, rtol=1e-3, atol=1e-5)


def test_nbody_example(tmp_path, monkeypatch):
    import njw_tpu.nbody as jnb
    from njw_tpu_torch.examples import nbody_example
    from njw_tpu_torch.nbody.convert import system_from

    monkeypatch.setattr(
        nbody_example, "create_galaxy_model",
        lambda n, seed=0, device=CPU: system_from(
            jnb.create_galaxy_model(n, seed=seed), device))
    got = compare("nbody_example",
                  ["--num-particles", "64", "--steps", "20",
                   "--output-dir", str(tmp_path)], monkeypatch,
                  rtol=1e-5, atol=1e-5)
    assert dict(got)[".n"] == 64
    assert (tmp_path / "final.png").stat().st_size > 0


def test_lj_fluid_example(tmp_path, monkeypatch):
    import njw_tpu.md as jmd
    from njw_tpu_torch.examples import lj_fluid_example
    from njw_tpu_torch.md import convert

    def lj_fluid(n, density, T0, device):
        s, t, lj = jmd.create_lj_fluid(n, density=density, T0=T0)
        return (convert.state_from(s, device), convert.topology_from(t, device),
                convert.lj_from(lj, device))

    monkeypatch.setattr(
        lj_fluid_example, "create_lj_fluid",
        lambda n, *, density, T0, device: lj_fluid(n, density, T0, device))
    compare("lj_fluid_example",
            ["--num-atoms", "64", "--steps", "40", "--rdf",
             "--output-dir", str(tmp_path)], monkeypatch,
            rtol=1e-3, atol=2e-3)
    for f in ("energy.png", "final.png", "rdf.png"):
        assert (tmp_path / f).stat().st_size > 0


def test_ct_reconstruction_example(tmp_path, monkeypatch):
    compare("ct_reconstruction_example",
            ["--size", "32", "--angles", "16", "24", "--noise", "0",
             "0.02", "--sirt-iterations", "4", "--cone-beam",
             "--output-dir", str(tmp_path)], monkeypatch,
            rtol=0, atol=0.02)
    for f in ("sinogram.png", "reconstruction.png"):
        assert (tmp_path / f).stat().st_size > 0


def test_mri_reconstruction_example(tmp_path, monkeypatch):
    argv = ["--size", "32", "--cg-iterations", "3", "--pd-iterations",
            "5", "--cs-iterations", "5"]
    got = printed_values(run_port("mri_reconstruction_example", argv + [
        "--output-dir", str(tmp_path / "port")]))
    want = printed_values(run_jax("mri_reconstruction_example", argv + [
        "--output-dir", str(tmp_path / "jax")], monkeypatch))
    assert_same_values(got, want, rtol=0, atol=0.02)
    port_rows = json.loads((tmp_path / "port" / "psnr.json").read_text())
    jax_rows = json.loads((tmp_path / "jax" / "psnr.json").read_text())
    assert_same_values(list(_flatten(port_rows)), list(_flatten(jax_rows)),
                       rtol=0, atol=0.02)
    for r in (2, 4):
        assert (tmp_path / "port" / f"recon_r{r}.png").stat().st_size > 0


def test_image_registration_example(tmp_path, monkeypatch):
    got = compare("image_registration_example",
                  ["--size", "32", "--iterations", "10",
                   "--deformable-iterations", "5", "--json",
                   "--output-dir", str(tmp_path)], monkeypatch,
                  rtol=0, atol=2e-3)
    assert (tmp_path / "registration.png").stat().st_size > 0
    assert dict(got)[".size"] == 32


def test_wavelet_transform_example(monkeypatch):
    compare("wavelet_transform_example", [], monkeypatch, rtol=0,
            atol=0.1)


def test_viewshed_analysis(tmp_path, monkeypatch):
    compare("viewshed_analysis",
            ["--size", "48", "--observers", "2", "--json",
             "--output-dir", str(tmp_path)], monkeypatch, rtol=0,
            atol=1e-4)
    assert (tmp_path / "index.html").exists()
    # --path: the JAX script unpacks least_cost_path's list into two and
    # fails there; the port prints the path's length and cost distance
    out = json.loads(run_port("viewshed_analysis", [
        "--size", "48", "--path", "2", "2", "40", "40", "--json",
        "--output-dir", str(tmp_path / "path")]))
    from njw_tpu.geospatial.dem import DEMProcessor, cost_distance
    from njw_tpu.geospatial.datasets import synthetic_dem

    slope = np.asarray(DEMProcessor(synthetic_dem(
        48, roughness=0.6, relief=200.0, seed=7)).terrain_derivatives()
        ["slope"])
    cost = 1.0 + 10.0 * slope
    want = float(np.asarray(cost_distance(cost, (2, 2)))[40, 40])
    assert out["path_cost"] == pytest.approx(want, rel=1e-4)
    assert out["path_points"] >= 39


def test_global_cores_example(monkeypatch):
    for study in ("rossby", "williamson", "nested"):
        compare("global_cores_example",
                ["--study", study, "--nlat", "16", "--hours", "2",
                 "--steps", "10"], monkeypatch, rtol=1e-3, atol=1e-7)


def test_financial_modeling_example(monkeypatch):
    import njw_tpu.geofinancial as jgf
    from njw_tpu_torch.examples import financial_modeling_example as ex
    from njw_tpu_torch.geofinancial import options, portfolio, risk_metrics

    def three_points(orig):
        return lambda mu, cov, n_points=20, **kw: orig(mu, cov, 2, **kw)

    monkeypatch.setattr(jgf, "efficient_frontier",
                        three_points(jgf.efficient_frontier))
    monkeypatch.setattr(ex, "efficient_frontier",
                        three_points(ex.efficient_frontier))
    for mod in (risk_metrics, options, portfolio):
        monkeypatch.setattr(mod, "standard_normals",
                            lambda shape, seed, device=None:
                            _jax_normals(seed, shape))
    got = compare("financial_modeling_example",
                  ["--assets", "10", "--days", "260", "--mc-samples",
                   "4000", "--json"], monkeypatch, rtol=1e-4, atol=1e-6)
    assert dict(got)[".geo_portfolio.n_assets_held"] >= 1


def test_geofinancial_example(tmp_path, monkeypatch):
    argv = ["--assets", "30", "--dem-size", "64", "--scenario-sets",
            "climate", "economic", "stress", "--regions", "2", "2"]
    got = printed_values(run_port("geofinancial_example", argv + [
        "--output-dir", str(tmp_path / "port")]))
    want = printed_values(run_jax("geofinancial_example", argv + [
        "--output-dir", str(tmp_path / "jax")], monkeypatch))
    assert_same_values(got, want, rtol=0, atol=0)
    assert (tmp_path / "port" / "index.html").read_text() == \
        (tmp_path / "jax" / "index.html").read_text()
