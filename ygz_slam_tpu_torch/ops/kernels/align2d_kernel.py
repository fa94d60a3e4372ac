"""K1, K2, K6: integer-origin window gathers, and bilinear patches built
on them.

Counterpart of ygz_slam_tpu/ops/pallas/align2d_kernel.py.  The CUDA
kernels (csrc/gather_windows.cu) replace `gather_windows` (K1),
`gather_windows_multi` (K2) and `gather_windows_grouped` (K6) there; the
TPU's aligned super-windows, shift matmuls and image de-duplication are
not carried over.  Every gather returns the window of the zero-padded
image at the requested origin, as the JAX kernels do: pixels outside the
image are 0.  K1 also takes every level of a pyramid in one launch
(`gather_windows_levels`); `gather_windows` is its one-level case, and
`bilinear_patches` the one-level case of `bilinear_patches_levels`.  K1,
K2 and K6 copy a window with one warp (the body they share); K6 takes up
to MAX_GROUPS requests per launch, enough for every level of 21
sequences of three levels (the batch path's whole frame at S <= 21,
through `gather_windows_stacked`, which writes them into one buffer).  K2
names its images either as one [S, H, W] stack (the batch path's
sequences; `bilinear_patches_multi`) or as a table of up to MAX_LEVELS
images of their own shapes (the VO's pyramid levels, read in place).  The
JAX package hands its kernel a zero-padded [levels, H, W] stack of the
pyramid, because the TPU kernel keeps the whole stack in VMEM; a level's
window of the zero-padded level is the same window bit for bit, so the
port builds no stack.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import I, P, launch, launched, on_card, require, stream

PATCH = 8
# Cached-window aligner geometry: one CACHE_WIN window per point, fetched
# once; a point may drift CACHE_SLACK px from its init before sampling
# clamps (the caller rejects such points).
CACHE_WIN = 32
CACHE_SLACK = (CACHE_WIN - PATCH - 1) // 2  # 11 px
MAX_GROUPS = 64         # K6 requests per launch (csrc/gather_windows.cu kMaxGroups)
MAX_LEVELS = 8          # K1 levels per launch, K2 table images (csrc/gather_windows.cu)


def _check_window(win: int, H: int, W: int) -> None:
    if win > H or win > W:
        raise ValueError(f"window {win} larger than image {H}x{W}")


def _window_index(H: int, W: int, xi: torch.Tensor, yi: torch.Tensor, win: int):
    """Row and column indices [N, win, 1] / [N, 1, win] of each window,
    clamped into the image, and the mask [N, win, win] of the pixels that
    lie inside it."""
    ar = torch.arange(win, device=xi.device)
    rows = yi.long()[:, None] + ar
    cols = xi.long()[:, None] + ar
    inside = (((rows >= 0) & (rows < H))[:, :, None]
              & ((cols >= 0) & (cols < W))[:, None, :])
    return rows.clamp(0, H - 1)[:, :, None], cols.clamp(0, W - 1)[:, None, :], inside


def gather_windows_plain(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
                         win: int) -> torch.Tensor:
    """Plain version of K1: [H, W] image + int origins [N] -> [N, win, win],
    the windows of the zero-padded image."""
    H, W = img.shape
    r, c, inside = _window_index(H, W, xi, yi, win)
    return torch.where(inside, img[r, c], 0.0)


class _LevelImage(ctypes.Structure):
    """One level of a K1 launch, laid out as `LevelImage` in
    csrc/gather_windows.cu."""
    _fields_ = [("img", ctypes.c_void_p), ("H", ctypes.c_int), ("W", ctypes.c_int)]


def _level_table(imgs, dev: torch.device):
    """The `LevelImage` descriptors of float32 [H_l, W_l] images on `dev`."""
    descs = (_LevelImage * len(imgs))()
    for l, img in enumerate(imgs):
        require(img, f"imgs[{l}]", torch.float32, tuple(img.shape), dev)
        if img.dim() != 2:
            raise ValueError(f"imgs[{l}]: expected an [H, W] image, got {tuple(img.shape)}")
        descs[l] = _LevelImage(img.data_ptr(), *img.shape)
    return descs


def _launch_levels(imgs, xi, yi, win: int, out: torch.Tensor) -> None:
    """K1 on L = len(imgs) images and origins [L, N] into out [L, N, win, win]."""
    dev = out.device
    L, N = xi.shape
    descs = _level_table(imgs, dev)
    require(xi, "xi", torch.int32, (L, N), dev)
    require(yi, "yi", torch.int32, (L, N), dev)
    launch("gather_windows", "gather_windows_levels_launch", [P, I, P, P, I, I, P, P],
           ctypes.addressof(descs), L, xi.data_ptr(), yi.data_ptr(), N, win, out.data_ptr(),
           stream(dev))


def gather_windows(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
                   win: int) -> torch.Tensor:
    """[H, W] float32 image + int32 origins [N] -> [N, win, win] windows of
    the zero-padded image.  K1 (one level) on the card, the plain version
    on the CPU."""
    H, W = img.shape
    _check_window(win, H, W)
    if not on_card(img):
        return gather_windows_plain(img, xi, yi, win)
    N = xi.shape[0]
    require(xi, "xi", torch.int32, (N,), img.device)
    require(yi, "yi", torch.int32, (N,), img.device)
    out = torch.empty((1, N, win, win), dtype=torch.float32, device=img.device)
    _launch_levels((img,), xi.view(1, N), yi.view(1, N), win, out)
    launched(gather_windows, img, xi, yi, win)
    return out[0]


gather_windows.launches = 0


def gather_windows_levels_plain(imgs, xi: torch.Tensor, yi: torch.Tensor,
                                win: int) -> torch.Tensor:
    """Plain version of K1 over a pyramid: K1's plain version on each
    level, stacked."""
    return torch.stack([gather_windows_plain(img, xi[l], yi[l], win)
                        for l, img in enumerate(imgs)])


def gather_windows_levels(imgs, xi: torch.Tensor, yi: torch.Tensor,
                          win: int) -> torch.Tensor:
    """The levels of one pyramid, `imgs` (1..MAX_LEVELS float32 [H_l, W_l]
    images), with int32 origins xi, yi [L, N] -> [L, N, win, win]: level
    l's windows of its zero-padded image, `gather_windows` on each level,
    in one launch of K1 on the card, the plain version on the CPU."""
    L = len(imgs)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"K1 takes 1..{MAX_LEVELS} levels, got {L}")
    if xi.dim() != 2 or xi.shape[0] != L or yi.shape != xi.shape:
        raise ValueError(f"origins: expected xi, yi [{L}, N], got {tuple(xi.shape)} and "
                         f"{tuple(yi.shape)}")
    for img in imgs:
        _check_window(win, *img.shape)
    if not on_card(imgs[0]):
        return gather_windows_levels_plain(imgs, xi, yi, win)
    out = torch.empty((L, xi.shape[1], win, win), dtype=torch.float32, device=imgs[0].device)
    _launch_levels(imgs, xi, yi, win, out)
    launched(gather_windows_levels, imgs, xi, yi, win)
    return out


gather_windows_levels.launches = 0


def _image_count(imgs) -> int:
    """How many images K2's `imgs` names: S of an [S, H, W] stack, or the
    table's length (1..MAX_LEVELS)."""
    if isinstance(imgs, torch.Tensor):
        if imgs.dim() != 3:
            raise ValueError(f"imgs: expected an [S, H, W] stack, got {tuple(imgs.shape)}")
        return imgs.shape[0]
    if not 1 <= len(imgs) <= MAX_LEVELS:
        raise ValueError(f"K2 takes a table of 1..{MAX_LEVELS} images, got {len(imgs)}")
    return len(imgs)


def gather_windows_multi_plain(imgs, img_idx: torch.Tensor, xi: torch.Tensor,
                               yi: torch.Tensor, win: int) -> torch.Tensor:
    """Plain version of K2: an [S, H, W] stack, or a table of [H_l, W_l]
    images, + image index and int origins [N] -> [N, win, win] windows of
    the zero-padded images.  Raises IndexError for an image index that
    names no image."""
    count = _image_count(imgs)
    if img_idx.numel() and not bool(((img_idx >= 0) & (img_idx < count)).all()):
        raise IndexError(f"gather_windows_multi: an image index lies outside [0, {count})")
    if not isinstance(imgs, torch.Tensor):
        out = torch.zeros((xi.shape[0], win, win), dtype=imgs[0].dtype, device=xi.device)
        for l, img in enumerate(imgs):
            out = torch.where((img_idx == l)[:, None, None],
                              gather_windows_plain(img, xi, yi, win), out)
        return out
    _, H, W = imgs.shape
    r, c, inside = _window_index(H, W, xi, yi, win)
    return torch.where(inside, imgs[img_idx.long()[:, None, None], r, c], 0.0)


def gather_windows_multi(imgs, img_idx: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
                         win: int) -> torch.Tensor:
    """Like `gather_windows` over several images with an int32 image index
    per window.  `imgs` is an [S, H, W] float32 stack (any S), or a
    sequence of 1..MAX_LEVELS float32 [H_l, W_l] images of their own
    shapes, which are read in place (the window of the zero-padded image,
    for any origin and any image smaller than the window).  The window may
    be no larger than the stack, or the table's largest height and width.
    K2 on the card, the plain version on the CPU.  An index that names no
    image raises: IndexError on the CPU; on the card the kernel stops on a
    device-side assert, which the next synchronisation raises (and which
    leaves the CUDA context unusable)."""
    count = _image_count(imgs)
    stacked = isinstance(imgs, torch.Tensor)
    if stacked:
        _check_window(win, *imgs.shape[1:])
        first = imgs
    else:
        _check_window(win, max(img.shape[0] for img in imgs),
                      max(img.shape[1] for img in imgs))
        first = imgs[0]
    if not on_card(first):
        return gather_windows_multi_plain(imgs, img_idx, xi, yi, win)
    N = xi.shape[0]
    dev = first.device
    require(img_idx, "img_idx", torch.int32, (N,), dev)
    require(xi, "xi", torch.int32, (N,), dev)
    require(yi, "yi", torch.int32, (N,), dev)
    out = torch.empty((N, win, win), dtype=torch.float32, device=dev)
    if stacked:
        require(imgs, "imgs", torch.float32, tuple(imgs.shape), dev)
        launch("gather_windows", "gather_windows_multi_launch",
               [P, I, I, I, P, P, P, I, I, P, P], imgs.data_ptr(), *imgs.shape,
               img_idx.data_ptr(), xi.data_ptr(), yi.data_ptr(), N, win, out.data_ptr(),
               stream(dev))
    else:
        descs = _level_table(imgs, dev)
        launch("gather_windows", "gather_windows_multi_levels_launch",
               [P, I, P, P, P, I, I, P, P], ctypes.addressof(descs), count,
               img_idx.data_ptr(), xi.data_ptr(), yi.data_ptr(), N, win, out.data_ptr(),
               stream(dev))
    launched(gather_windows_multi, imgs, img_idx, xi, yi, win)
    return out


gather_windows_multi.launches = 0


class _GatherGroup(ctypes.Structure):
    """One K6 request, laid out as `GatherGroup` in csrc/gather_windows.cu."""
    _fields_ = [("img", ctypes.c_void_p), ("ox", ctypes.c_void_p), ("oy", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("N", ctypes.c_int), ("win", ctypes.c_int)]


def gather_windows_grouped_plain(groups) -> list:
    """Plain version of K6: K1's plain version for each (img, xi, yi, win)
    request."""
    return [gather_windows_plain(*g) for g in groups]


def gather_windows_grouped(groups) -> list:
    """Window stacks for up to MAX_GROUPS (img [H, W], xi [N], yi [N], win)
    requests, each with `gather_windows` semantics, in one launch (K6 on
    the card, the plain version on the CPU).  Requests may name different
    images, sizes and windows, and the same image more than once."""
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"K6 takes 1..{MAX_GROUPS} requests, got {len(groups)}")
    for img, _, _, win in groups:
        _check_window(win, *img.shape)
    if not on_card(groups[0][0]):
        return gather_windows_grouped_plain(groups)
    dev = groups[0][0].device
    descs = (_GatherGroup * len(groups))()
    outs = []
    for k, (img, xi, yi, win) in enumerate(groups):
        H, W = img.shape
        N = xi.shape[0]
        require(img, f"groups[{k}].img", torch.float32, (H, W), dev)
        require(xi, f"groups[{k}].xi", torch.int32, (N,), dev)
        require(yi, f"groups[{k}].yi", torch.int32, (N,), dev)
        out = torch.empty((N, win, win), dtype=torch.float32, device=dev)
        descs[k] = _GatherGroup(img.data_ptr(), xi.data_ptr(), yi.data_ptr(), out.data_ptr(),
                                H, W, N, win)
        outs.append(out)
    launch("gather_windows", "gather_windows_grouped_launch", [P, I, P],
           ctypes.addressof(descs), len(groups), stream(dev))
    launched(gather_windows_grouped, groups)
    return outs


gather_windows_grouped.launches = 0


def gather_windows_stacked_plain(stacks, xi: torch.Tensor, yi: torch.Tensor,
                                 win: int) -> torch.Tensor:
    """Plain version of `gather_windows_stacked`: K1's plain version for
    each sequence's level, stacked into [S, L, N, win, win]."""
    S, L, _ = xi.shape
    return torch.stack([torch.stack([gather_windows_plain(stacks[li][s], xi[s, li], yi[s, li],
                                                          win) for li in range(L)])
                        for s in range(S)])


def gather_windows_stacked(stacks, xi: torch.Tensor, yi: torch.Tensor, win: int) -> torch.Tensor:
    """K6 over S stacked pyramids: the win x win windows at origins xi / yi
    [S, L, N] int32 on level l of sequence s, `stacks` holding the L levels
    as float32 stacks [S, H_l, W_l]; returns one [S, L, N, win, win] buffer,
    which K6 writes in place.  The S * L requests go sequence by sequence
    in launches of up to MAX_GROUPS, each counted as a K6 launch (in
    `gather_windows_grouped.launches`) and recorded with this call's
    arguments; their descriptors are taken from
    the tensors' base pointers, not from a view per request.  The plain
    version on the CPU."""
    S, L, N = xi.shape
    if len(stacks) != L:
        raise ValueError(f"{len(stacks)} levels, origins for {L}")
    for lv in stacks:
        _check_window(win, *lv.shape[1:])
    if not on_card(xi):
        return gather_windows_stacked_plain(stacks, xi, yi, win)
    dev = xi.device
    for li, lv in enumerate(stacks):
        require(lv, f"stacks[{li}]", torch.float32, (S, *lv.shape[1:]), dev)
    require(xi, "xi", torch.int32, (S, L, N), dev)
    require(yi, "yi", torch.int32, (S, L, N), dev)
    out = torch.empty((S, L, N, win, win), dtype=torch.float32, device=dev)
    shapes = [tuple(lv.shape[1:]) for lv in stacks]
    bases = [lv.data_ptr() for lv in stacks]
    xp, yp, op = xi.data_ptr(), yi.data_ptr(), out.data_ptr()
    for first in range(0, S * L, MAX_GROUPS):
        n = min(MAX_GROUPS, S * L - first)
        descs = (_GatherGroup * n)()
        for j in range(n):
            k = first + j
            s, li = divmod(k, L)
            H, W = shapes[li]
            descs[j] = _GatherGroup(bases[li] + 4 * s * H * W, xp + 4 * k * N, yp + 4 * k * N,
                                    op + 4 * k * N * win * win, H, W, N, win)
        launch("gather_windows", "gather_windows_grouped_launch", [P, I, P],
               ctypes.addressof(descs), n, stream(dev))
        launched(gather_windows_stacked, stacks, xi, yi, win, counted_in=gather_windows_grouped)
    return out


def level_consts(shapes, device, sub: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """For a pyramid whose levels have these [H_l, W_l] shapes: each level's
    scale 2^-l [L, 1] and (W_l - sub, H_l - sub) [L, 2], float32 tensors on
    `device`, made once per pyramid geometry (no host-to-device copy per
    frame)."""
    return _level_consts(tuple((int(h), int(w)) for h, w in shapes), str(device), float(sub))


@functools.lru_cache(maxsize=64)
def _level_consts(shapes, device: str, sub: float):
    scale = torch.tensor([[0.5 ** li] for li in range(len(shapes))], dtype=torch.float32,
                         device=device)
    wh = torch.tensor([[W - sub, H - sub] for H, W in shapes], dtype=torch.float32,
                      device=device)
    return scale, wh


def _bilinear_origins(centers: torch.Tensor, shapes, size: int):
    """Clamped centers c [..., 2] (x, y), window origins o [..., 2] (float)
    and the half-width of `size`-patches on the symmetric grid, for centers
    [L, N, 2] on images of the L `shapes` (or [N, 2] on one image).  Wild
    centers (NaN, +-1e12 from behind-camera projections of masked points)
    are clamped into the image first, so the mix weights stay finite."""
    half = (size - 1) / 2.0
    _, hi_c = level_consts(shapes, centers.device, 1.0)           # (W - 1, H - 1)
    _, hi_o = level_consts(shapes, centers.device, size + 1.0)    # (W - win, H - win)
    if centers.dim() == 3:
        hi_c, hi_o = hi_c[:, None, :], hi_o[:, None, :]
    c = torch.minimum(torch.clamp(torch.nan_to_num(centers), min=0.0), hi_c)
    o = torch.minimum(torch.clamp(torch.floor(c - half), min=0.0), hi_o)
    return c, o, half


def _bilinear_mix(w, c, o, half, size):
    """The [..., size, size] patches of the (size+1)-windows w at origins o
    around centers c ([..., 2] each)."""
    f = c - half - o
    fx = f[..., 0, None, None]
    fy = f[..., 1, None, None]
    return (w[..., :size, :size] * (1 - fx) * (1 - fy)
            + w[..., :size, 1:] * fx * (1 - fy)
            + w[..., 1:, :size] * (1 - fx) * fy
            + w[..., 1:, 1:] * fx * fy)


def bilinear_patches_levels(imgs, centers: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear [L, N, size, size] patches at sub-pixel `centers [L, N, 2]`,
    level l's on `imgs[l]`, on the symmetric grid, from one (size+1)-window
    per point and level: every level's in one launch of K1."""
    c, o, half = _bilinear_origins(centers, [img.shape for img in imgs], size)
    oi = o.to(torch.int32)
    w = gather_windows_levels(tuple(imgs), oi[..., 0].contiguous(), oi[..., 1].contiguous(),
                              size + 1)
    return _bilinear_mix(w, c, o, half, size)


def bilinear_patches(img: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear [N, size, size] patches at sub-pixel `centers [N, 2]` on the
    symmetric grid: `bilinear_patches_levels` on one image."""
    return bilinear_patches_levels((img,), centers[None], size)[0]


def bilinear_patches_multi(imgs: torch.Tensor, img_idx: torch.Tensor, centers: torch.Tensor,
                           size: int) -> torch.Tensor:
    """`bilinear_patches` over an image stack [S, H, W] with an int32 image
    index per point (K2)."""
    c, o, half = _bilinear_origins(centers, [imgs.shape[1:]], size)
    oi = o.to(torch.int32)
    w = gather_windows_multi(imgs, img_idx, oi[:, 0].contiguous(), oi[:, 1].contiguous(),
                             size + 1)
    return _bilinear_mix(w, c, o, half, size)
