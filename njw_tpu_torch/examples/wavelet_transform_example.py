"""Wavelet and time-frequency example: a noisy chirp through DWT
denoising, a CWT scalogram and a spectrogram. Counterpart of
``examples/wavelet_transform_example.py``.

    python -m njw_tpu_torch.examples.wavelet_transform_example
"""
import argparse

import numpy as np

from njw_tpu_torch.examples._common import add_device
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.signal import CWT, DWT, compute_spectrogram
from njw_tpu_torch.viz._common import to_numpy


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.wavelet_transform_example",
        description=__doc__)
    add_device(p)
    args = p.parse_args(argv)
    dev = require_device(args.device)

    fs = 1000.0
    t = np.arange(4096) / fs
    clean = np.sin(2 * np.pi * (20 + 30 * t) * t).astype(np.float32)
    rng = np.random.default_rng(0)
    noisy = clean + 0.5 * rng.standard_normal(len(t)).astype(np.float32)

    dwt = DWT(wavelet="db4", device=dev)
    den = to_numpy(dwt.denoise(noisy, level=4))
    print(f"input SNR : {10*np.log10(np.var(clean)/np.var(noisy-clean)):.1f} dB")
    print(f"denoised  : {10*np.log10(np.var(clean)/np.var(den-clean)):.1f} dB")

    cwt = CWT(wavelet="morlet", device=dev)
    scalogram = np.abs(to_numpy(cwt.forward(
        noisy, np.geomspace(2, 64, 32).astype(np.float32))))
    print(f"scalogram shape: {scalogram.shape}")

    f, tt, S = compute_spectrogram(noisy, fs=fs, nperseg=256, device=dev)
    ridge = to_numpy(f)[to_numpy(S).argmax(axis=0)]
    print(f"chirp ridge: {ridge[0]:.0f} Hz -> {ridge[-1]:.0f} Hz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
