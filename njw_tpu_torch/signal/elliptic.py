"""Elliptic (Cauer) IIR filter design, in float64 NumPy.

Counterpart of ``njw_tpu/signal/elliptic.py``, kept as the port's own copy
with the same arithmetic, so the sections equal the JAX package's bit for
bit: Jacobi elliptic functions by the arithmetic-geometric mean
(Abramowitz & Stegun 16.4), the degree equation solved by bisection, the
analog elliptic prototype (zeros j/(k sn), poles by cd at a complex
argument through the Jacobi addition formulas), then the lowpass or
highpass transform and the bilinear transform of ``signal/filters.py``.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Jacobi elliptic functions (real argument) via AGM, modulus k (not m=k^2)
# ---------------------------------------------------------------------------

def ellipk(k: float) -> float:
    """Complete elliptic integral K(k) via AGM."""
    if k >= 1.0:
        return np.inf
    a, b = 1.0, float(np.sqrt(1.0 - k * k))
    while abs(a - b) > 1e-15:
        a, b = 0.5 * (a + b), np.sqrt(a * b)
    return float(np.pi / (2.0 * a))


def _sn_cn_dn(u: float, k: float):
    """Jacobi sn, cn, dn at real u, modulus k (A&S 16.4 descending AGM)."""
    if k < 1e-12:
        return np.sin(u), np.cos(u), 1.0
    if k > 1.0 - 1e-12:
        return np.tanh(u), 1.0 / np.cosh(u), 1.0 / np.cosh(u)
    a = [1.0]
    b = [float(np.sqrt(1.0 - k * k))]
    c = [k]
    n = 0
    while abs(c[n]) > 1e-15 and n < 60:
        a.append(0.5 * (a[n] + b[n]))
        b.append(float(np.sqrt(a[n] * b[n])))
        c.append(0.5 * (a[n] - b[n]))
        n += 1
    phi = (2.0 ** n) * a[n] * u
    for i in range(n, 0, -1):
        phi = 0.5 * (phi + np.arcsin(
            np.clip(c[i] / a[i] * np.sin(phi), -1.0, 1.0)))
    sn = np.sin(phi)
    cn = np.cos(phi)
    dn = float(np.sqrt(max(1.0 - (k * sn) ** 2, 1e-300)))
    return float(sn), float(cn), dn


def _cd_complex(u: complex, k: float) -> complex:
    """cd(u K(k), k) for complex normalized argument u = x + j y.

    Uses the Jacobi addition formulas with sn/cn/dn of the real part
    (modulus k) and of the imaginary part (complementary modulus k')
    (A&S 16.21)."""
    K = ellipk(k)
    kp = float(np.sqrt(1.0 - k * k))
    x = u.real * K
    y = u.imag * K     # u is normalised by K along both axes
    s, c, d = _sn_cn_dn(x, k)
    s1, c1, d1 = _sn_cn_dn(y, kp)
    denom = c1 * c1 + (k * s * s1) ** 2
    sn = (s * d1 + 1j * c * d * s1 * c1) / denom
    cn = (c * c1 - 1j * s * d * s1 * d1) / denom
    dn = (d * c1 * d1 - 1j * (k * k) * s * c * s1) / denom
    return cn / dn


def _sn_norm(u: float, k: float) -> float:
    """sn(u K(k), k) for real normalized u."""
    return _sn_cn_dn(u * ellipk(k), k)[0]


def _asn_imag(w: float, k: float) -> float:
    """Inverse sn for a purely imaginary value: returns v (in K(k) units)
    with sn(j v K(k), k) = j w. Via the Jacobi imaginary transformation
    sn(j u, k) = j sc(u, k'), i.e. solve sc(v K(k), k') = w by bisection.

    Note the argument scale is K(k) — the normalized coordinate's quarter
    period — while the modulus flips to k'."""
    kp = float(np.sqrt(1.0 - k * k))
    K = ellipk(k)

    def sc(v):
        s, c, _ = _sn_cn_dn(v * K, kp)
        return s / max(c, 1e-300)

    # sc is increasing and unbounded as v K -> K'(k); bracket adaptively
    lo, hi = 0.0, 1.0
    while sc(hi) < w and hi < 64.0:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if sc(mid) < w:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _degree_k(N: int, k1: float) -> float:
    """Solve the degree equation for the selectivity k given order N and
    discrimination k1: N = [K(k)/K'(k)] / [K(k1)/K'(k1)] (bisection)."""
    target = N * ellipk(k1) / ellipk(float(np.sqrt(1 - k1 * k1)))

    def ratio(k):
        return ellipk(k) / ellipk(float(np.sqrt(1 - k * k)))

    lo, hi = 1e-9, 1.0 - 1e-12
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if ratio(mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# Analog elliptic prototype + digital design
# ---------------------------------------------------------------------------

def ellipap(N: int, rp: float, rs: float):
    """Analog elliptic lowpass prototype: (zeros, poles, gain) with
    passband ripple rp dB on [0, 1] and stopband attenuation rs dB."""
    eps_p = float(np.sqrt(10 ** (rp / 10.0) - 1.0))
    eps_s = float(np.sqrt(10 ** (rs / 10.0) - 1.0))
    k1 = eps_p / eps_s                    # discrimination factor
    k = _degree_k(N, k1)                  # selectivity from degree eq.

    L = N // 2
    r = N % 2
    ui = (2 * np.arange(1, L + 1) - 1) / N

    # Zeros of H = poles of the elliptic rational function R_N: in the
    # normalized cd-coordinate they sit at u_i + j K'/K (numerically
    # verified: R explodes there) — evaluate w = cd((u_i + jK'/K) K, k).
    kp = float(np.sqrt(1.0 - k * k))
    jkpk = ellipk(kp) / ellipk(k)
    zeros = []
    for u in ui:
        w_z = _cd_complex(u + 1j * jkpk, k).real
        z = 1j * w_z
        zeros += [z, np.conj(z)]

    v0 = _asn_imag(1.0 / eps_p, k1) / N
    poles = []
    for u in ui:
        p = 1j * _cd_complex(u - 1j * v0, k)
        if p.real > 0:
            p = -np.conj(p)
        poles += [p, np.conj(p)]
    if r:
        # real pole: j sn(j v0 ...) = -sc(v0 K', k')-like, via cd at u=1
        p0 = 1j * _cd_complex(1.0 - 1j * v0, k)
        poles.append(complex(-abs(p0.real), 0.0))

    zeros = np.asarray(zeros, complex)
    poles = np.asarray(poles, complex)
    gain = abs(np.prod(poles) / np.prod(zeros)) if len(zeros) else \
        abs(np.prod(poles))
    if r == 0:
        gain = gain / np.sqrt(1.0 + eps_p * eps_p)
    return zeros, poles, float(gain)


def elliptic_sos(order: int, cutoff, btype: str = "lowpass",
                 rp: float = 1.0, rs: float = 40.0) -> np.ndarray:
    """Digital elliptic filter as SOS (cutoff in Nyquist units)."""
    from njw_tpu_torch.signal.filters import _zpk_bilinear, _zpk_to_sos

    z, p, kgain = ellipap(order, rp, rs)
    fs2 = 2.0
    if btype == "lowpass":
        wc = fs2 * np.tan(np.pi * cutoff / 2.0)
        z, p = z * wc, p * wc
        kgain = kgain * wc ** (len(p) - len(z))
    elif btype == "highpass":
        wc = fs2 * np.tan(np.pi * cutoff / 2.0)
        kgain = kgain * np.real(np.prod(-z) / np.prod(-p))
        z, p = wc / z, wc / p
        z = np.append(z, np.zeros(len(p) - len(z)))
    else:
        raise ValueError(f"unsupported btype {btype!r} for elliptic")
    zd, pd, kd = _zpk_bilinear(z, p, kgain, fs2)
    sos = _zpk_to_sos(zd, pd, kd)
    return (sos / sos[:, [3]]).astype(np.float32)
