"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Every kernel wrapper launches its kernel for CUDA tensors, runs
the plain version for CPU tensors and raises for any other device; it
counts its launches in a `launches` attribute, and inside
`record_launches()` every launch is kept with the arguments its wrapper
was given."""
from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

from ... import _build


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype, shape and
    device (the checks every launch makes before passing a pointer)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def launch(lib_name: str, fn_name: str, argtypes: list, *args) -> None:
    """Call the C launch function `fn_name` of csrc/<lib_name>.cu (typed
    with `argtypes`); raise if it returns a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    fn = getattr(_build.library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


MAX_CLUSTER = 8         # the portable cluster size (csrc/common.cuh::kMaxCluster)


class Partition(NamedTuple):
    """How one cluster launch (K9 v1, K11) spreads n items over its CTAs."""
    cluster: int     # CTAs, all in one cluster (the grid)
    per_cta: int     # CTA r takes items [r * per_cta, min(n, (r + 1) * per_cta))


def cluster_partition(n: int, per_cta: int) -> Partition:
    """A CTA for every `per_cta` items, at least 1 and at most MAX_CLUSTER,
    in contiguous ranges of equal size but the last."""
    cluster = max(1, min(MAX_CLUSTER, -(-n // per_cta)))
    return Partition(cluster, -(-n // cluster))


_recording = None       # the open `record_launches` list, if any
_capturing = None       # the open `capture_launches` list, if any


def launched(wrapper, *args, counted_in=None) -> None:
    """A wrapper calls this where it has launched its kernel, with the
    arguments it was given: one more in `wrapper.launches` (in
    `counted_in.launches` instead where another wrapper keeps the kernel's
    count), and a (wrapper, args) entry in the open recording.  Under
    `capture_launches` (a CUDA-graph capture, which runs nothing) the
    counting wrapper is noted there instead, and counted by `replayed` each
    time the graph runs."""
    counter = wrapper if counted_in is None else counted_in
    if _capturing is not None:
        _capturing.append(counter)
        return
    counter.launches += 1
    if _recording is not None:
        _recording.append((wrapper, args))


@contextlib.contextmanager
def capture_launches():
    """Within the block (a CUDA-graph capture), kernel launches are not
    counted: the list this yields receives each launching wrapper, in order,
    for `replayed`."""
    global _capturing
    _capturing = cap = []
    try:
        yield cap
    finally:
        _capturing = None


def replayed(captured: list) -> None:
    """A captured graph ran once: one more launch for each wrapper that
    launched into it."""
    for wrapper in captured:
        wrapper.launches += 1


@contextlib.contextmanager
def record_launches():
    """Within the block, every kernel launch is appended to the list this
    yields as (wrapper, the wrapper's arguments), in launch order: a caller
    can drive an entry point and then hand each kernel and its plain
    version the very inputs that path gave it."""
    global _recording
    if _recording is not None:
        raise RuntimeError("record_launches is already open")
    _recording = rec = []
    try:
        yield rec
    finally:
        _recording = None


P = ctypes.c_void_p
I = ctypes.c_int
Fl = ctypes.c_float
