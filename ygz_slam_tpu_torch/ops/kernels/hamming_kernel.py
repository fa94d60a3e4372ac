"""K10: all-pairs Hamming distance over packed 256-bit descriptors.

Counterpart of ygz_slam_tpu/ops/pallas/hamming_kernel.py.  The CUDA kernel
(csrc/hamming.cu) replaces `distance_matrix_pallas`; `distance_matrix` is
its wrapper and `distance_matrix_plain` its plain version.  The kernel
counts bits on the tensor cores (a single-bit MMA gives popc(a & b), and
popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b)); its loads want both
sides 16-byte aligned, as every tensor PyTorch allocates is.  Descriptors are
8 x 32-bit words stored as int32 (PyTorch has next to no arithmetic on
uint32); only the bit pattern matters.
"""
from __future__ import annotations

import torch

from . import I, P, launch, launched, on_card, require, stream

WORDS = 8           # 256-bit descriptors


def popcount_i32(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (SWAR).  `>>` on int32 is arithmetic, so
    every shifted value is masked down to the bits a logical shift keeps."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + ((v >> 4) & 0x0FFFFFFF)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    require(a, "a", torch.int32, (a.shape[0], WORDS), a.device)
    require(b, "b", torch.int32, (b.shape[0], WORDS), a.device)


def distance_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K10: [N, 8] x [M, 8] int32 words -> [N, M] int32
    Hamming distances (XOR, SWAR popcount, summed word by word so no
    [N, M, 8] tensor is made)."""
    _check(a, b)
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for w in range(WORDS):
        acc += popcount_i32(a[:, w, None] ^ b[None, :, w])
    return acc


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances: [N, 8] x [M, 8] int32 words -> [N, M]
    int32.  K10 on the card, the plain version on the CPU; an empty side
    gives an empty matrix without a launch."""
    if not on_card(a):
        return distance_matrix_plain(a, b)
    _check(a, b)
    N, M = a.shape[0], b.shape[0]
    out = torch.empty((N, M), dtype=torch.int32, device=a.device)
    if N == 0 or M == 0:
        return out
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("K10 takes descriptors that start on a 16-byte boundary")
    launch("hamming", "hamming_launch", [P, P, I, I, P, P],
           a.data_ptr(), b.data_ptr(), N, M, out.data_ptr(), stream(a.device))
    launched(distance_matrix, a, b)
    return out


distance_matrix.launches = 0
