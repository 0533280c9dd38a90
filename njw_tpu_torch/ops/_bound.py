"""The rule of the port's kernel steppers, and what the three kernel
modules (``stencil``, ``pe_stencil``, ``baro_stencil``) share with it.

The rule. A kernel stepper owns the buffers it steps between and
recognises the states it handed out by identity. Any other state is
checked once, with the public wrapper's own check and error, and the
stepper adopts its buffers as they are (no copy). Each launch a step
repeats is bound once per arrangement of the buffers: binding checks the
operands, folds the constants, applies the tile or layout rule and fixes
the pointers, pitches and device (``Launch``), and a step calls its bound
launches and nothing else. Adopting a state drops the bindings of the
arrangement it replaces, so a stepper holds only those of its own
buffers. On CPU tensors the plain versions are bound the same way, as
calls with their arguments fixed. ``BoundSteps`` keeps the rule for a
stepper. The public wrappers check every call.
"""
from __future__ import annotations

import operator
from typing import Any, Callable, Iterable, NamedTuple, Sequence

import torch


def device_kind(t: torch.Tensor, name: str) -> str:
    """"cuda" (the kernel) or "cpu" (the plain version) for ``t``'s
    device; ValueError for any other."""
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return kind


def require_cuda(name: str, named: Iterable[tuple[str, torch.Tensor]]
                 ) -> None:
    """Refuse, before anything is built, a tensor that is not on a CUDA
    device (the ``*_cuda`` wrappers: no fallback)."""
    for n, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {n} is on {t.device}; the kernel "
                             "takes CUDA tensors only")


def launch_on(index: int, entry: Callable[[int], int]) -> int:
    """``entry(stream)`` on the current stream of CUDA device ``index``,
    entering the device only where it is not the current one; returns
    entry's CUDA error code. The raw stream is read as PyTorch's own
    launches read it: ``torch.cuda.current_stream`` makes a Stream object,
    about 4 us a call on the H100's host against 0.2."""
    if index == torch._C._cuda_getDevice():
        return entry(torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return entry(torch._C._cuda_getCurrentRawStream(index))


class Launch(NamedTuple):
    """A kernel launch bound once: ``entry(stream)`` is the C entry with
    every argument but the stream fixed, for tensors on CUDA device
    ``index``. A call launches on the current stream (``launch_on``),
    raises RuntimeError for a nonzero code (``message(code)``: the CUDA
    error's name, bytes), counts one on ``counter`` (the wrapper and the
    attribute that count the form) and returns ``out``. ``operands`` are
    kept alive with it: every tensor and buffer whose pointer ``entry``
    holds."""

    name: str
    entry: Callable[[int], int]
    index: int
    message: Callable[[int], bytes]
    counter: tuple
    out: Any
    operands: tuple

    def __call__(self):
        err = launch_on(self.index, self.entry)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"{self.message(err).decode()} ({err})")
        wrapper, attr = self.counter
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
        return self.out


def step(launches: Sequence[Callable], handed: tuple) -> Callable:
    """A bound step for ``BoundSteps``: calls ``launches`` in order and
    hands out ``handed``."""
    def run(_given):
        for launch in launches:
            launch()
        return handed

    return run


class BoundSteps:
    """The rule for one stepper. A call takes ``given`` (the tuple a step
    starts from: say a carry and a state) and returns the tuple the step
    hands out. ``given`` that is, element by element, what the last step
    handed out takes the next step of the cycle; any other is adopted:
    ``adopt(given)`` checks it as the public wrapper does (raising its
    error) and returns the bound steps from it, one callable a step
    (``step``), around the cycle that brings the buffers back where they
    were. A step is called with ``given`` and returns what it hands out.
    ``adopt`` is passed at each call, not kept: kept, a stepper's own
    method would make a reference cycle, and its buffers would outlive it
    until the garbage collector ran."""

    def __init__(self):
        self._steps, self._turn, self._handed = (), 0, ()

    def __call__(self, given: tuple,
                 adopt: Callable[[tuple], Sequence[Callable]]) -> tuple:
        last = self._handed
        if len(given) != len(last) or not all(map(operator.is_, given,
                                                  last)):
            self._steps = self._handed = ()    # the replaced bindings go
            self._steps, self._turn = tuple(adopt(given)), 0
        turn = self._turn
        handed = self._steps[turn](given)
        self._turn, self._handed = (turn + 1) % len(self._steps), handed
        return handed
