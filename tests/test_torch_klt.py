"""Parity of the port's pyramidal KLT (ops/align.klt_pyramidal) with the
JAX package's on the CPU (jnp there, plain PyTorch here: neither has a
kernel), on PlaneScene frames of the monocular workload at 240x320: the
init reference's FAST features tracked to frames 4 and 9, from their own
positions and from a warm start."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_slam_tpu.ops.align import klt_pyramidal as jklt

from ygz_slam_tpu_torch.models import frontend as fe
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.ops.align import klt_pyramidal as tklt

from _torch_port import np32

torch.set_num_threads(1)

MIN_AGREE = 0.99     # converged flags: a residual on the 25 threshold may flip
TOL_PX = 1e-3        # tracked positions, on the tracks both accept


@pytest.fixture(scope="module")
def seq():
    cam, frames, _ = mw.make_mono_workload(10, device="cpu", shape=(240, 320), du=2 / 64)
    pyrs = [fe.preprocess(f, 3) for f in frames]
    feats = fe.detect_multilevel(pyrs[0], 20.0, 16, (160, 64, 32))
    return pyrs, feats


@pytest.mark.parametrize("frame,warm", [(4, False), (9, False), (9, True)])
def test_klt_matches_jax(seq, frame, warm):
    pyrs, feats = seq
    init = feats.px
    if warm:
        init = tklt(pyrs[0], pyrs[4], feats.px).xy
    t = tklt(pyrs[0], pyrs[frame], feats.px, init)
    j = jklt(tuple(jnp.asarray(np32(x)) for x in pyrs[0]),
             tuple(jnp.asarray(np32(x)) for x in pyrs[frame]),
             jnp.asarray(np32(feats.px)), jnp.asarray(np32(init)))
    ct, cj = np32(t.converged), np32(j.converged)
    valid = np32(feats.valid)
    agree = np.mean(ct[valid] == cj[valid])
    both = ct & cj & valid
    dxy = np.abs(np32(t.xy)[both] - np32(j.xy)[both]).max()
    derr = np.abs(np32(t.error)[both] - np32(j.error)[both]).max()
    print(f"KLT frame {frame} warm={warm}: converged flags agree {agree:.4f}, {both.sum()} "
          f"tracks both accept, max |xy diff| {dxy:.2e} px, max |error diff| {derr:.2e}")
    assert agree >= MIN_AGREE and both.sum() > 100
    assert dxy <= TOL_PX and derr <= 1e-3
