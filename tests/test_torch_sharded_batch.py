"""The port's `sharded_batch_align` (parallel/batch_tracking.py) on the CPU:
against its own `batched_sparse_align` for every split of 8 sequences over
1, 2, 4 and 8 shards, bit for bit, and against the JAX package on
tests/test_batch_tracking.py's `make_batch(S=8)` (8 PlaneScenes, 240x320,
80 FAST corners, from the identity).

The port's counterpart is the JAX kernel route (K3: Hessian frozen per
level, windows fetched once at the frame-init pose).  Its kernels do not
run interpreted inside `shard_map` (their output shapes carry no
varying-mesh-axis annotation), so the JAX `batched_sparse_align` runs
them interpreted outside it, eagerly, on sequence SEQ at the default cap
and at n_iter=3; the port is held to it at TOL_INTERPRETED.  Eagerly,
because under jit XLA reorders the interpreted kernels' float32 sums and
the JAX route itself moves by up to 4.6e-3 on these inputs.

The JAX `sharded_batch_align` on `make_mesh(8)` takes its CPU route, a
Gauss-Newton loop per level that recomputes the Hessian, jit compiled
(~7 s): a different algorithm, so that check is a sanity bound: each
sequence within twice JAX_ROUTE_SPREAD (the JAX package's own kernel route
against its CPU route), plus TOL_FLOOR, and both within
test_batch_tracking.py's 1e-2 of the truth."""
import numpy as np
import jax
import pytest
import torch
import torch.distributed as dist

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.parallel import make_mesh as jmake_mesh
from ygz_slam_tpu.ops import sparse_align as jsa
from ygz_slam_tpu.parallel.batch_tracking import batched_sparse_align as jbatched_sparse_align
from ygz_slam_tpu.parallel.batch_tracking import sharded_batch_align as jsharded_batch_align

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.ops import sparse_align as tsa
from ygz_slam_tpu_torch.ops.kernels import sparse_align_mega as tk3
from ygz_slam_tpu_torch.parallel import batch_tracking as tbt
from ygz_slam_tpu_torch.parallel import mesh as tmesh

import test_batch_tracking
from _torch_port import jax_kernels_interpreted, np32

torch.set_num_threads(1)

S = 8
TOL_TRUTH = 1e-2        # test_batch_tracking.py's bound on the JAX sharded run
# Pose distance, per sequence, between the JAX package's kernel route and its CPU
# route on make_batch(S=8) from the identity.
JAX_ROUTE_SPREAD = np.array([2.398e-4, 8.310e-4, 8.138e-4, 6.569e-5, 3.187e-5, 2.303e-4,
                             2.266e-3, 6.320e-3])
TOL_FLOOR = 1e-5
SEQ = 7                 # the sequence of the largest JAX_ROUTE_SPREAD
# Twice the largest pose distance between the port and the JAX kernel route
# (interpreted, eager) over make_batch(S=8)'s sequences at n_iter 15 and 3:
# 3.80e-6, on sequence 2 at both.
TOL_INTERPRETED = 8e-6


@pytest.fixture(scope="module", autouse=True)
def _one_rank():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def batch():
    """make_batch(S=8) as torch tensors, and the JAX sharded run's poses."""
    rp, cp, px, d, m, T_gt = test_batch_tracking.make_batch(S=S)
    mesh = jmake_mesh(8)
    run = jax.jit(lambda rp, cp, px, d, m: jsharded_batch_align(
        mesh, rp, cp, test_batch_tracking.CAM, px, d, m, JSE3.identity((S,))).params7())
    j7 = np32(run(rp, cp, px, d, m))
    t = lambda a: torch.tensor(np32(a))
    return dict(rp=tuple(map(t, rp)), cp=tuple(map(t, cp)), px=t(px), d=t(d), m=t(m),
                gt7=t(T_gt.params7()), j7=torch.tensor(j7),
                cam=convert.camera_from_numpy(*test_batch_tracking.CAM),
                jax=(rp, cp, px, d, m))


@pytest.fixture(scope="module")
def interpreted(batch):
    """The JAX batched_sparse_align on sequence SEQ with its kernels
    interpreted, eagerly, at n_iter 15 (capped at 12) and 3, on one
    ReferencePrep: {n_iter: params7 [1, 7]}."""
    rp, cp, px, d, m = (a[SEQ:SEQ + 1] if not isinstance(a, tuple)
                        else tuple(x[SEQ:SEQ + 1] for x in a) for a in batch["jax"])
    cam = test_batch_tracking.CAM
    with jax_kernels_interpreted():
        prep = jsa.prepare_reference(tuple(r[0] for r in rp), cam, px[0], d[0], m[0],
                                     distorted=True)
        return {n_iter: torch.tensor(np32(jbatched_sparse_align(
            rp, cp, cam, px, d, m, JSE3.identity((1,)), n_iter=n_iter,
            ref_preps=[prep]).params7())) for n_iter in (15, 3)}


def _args(b, sl=slice(None)):
    return (tuple(r[sl] for r in b["rp"]), tuple(c[sl] for c in b["cp"]), b["cam"], b["px"][sl],
            b["d"][sl], b["m"][sl])


def _identity(n):
    return TSE3.identity((n,), device="cpu")


@pytest.fixture(scope="module")
def unsharded(batch):
    rp, cp, cam, px, d, m = _args(batch)
    preps = [tsa.prepare_reference(tuple(r[s] for r in rp), cam, px[s], d[s], m[s],
                                   distorted=tbt.DISTORTED) for s in range(S)]
    return tbt.batched_sparse_align(rp, cp, cam, px, d, m, _identity(S), preps).params7()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_every_split_equals_batched(batch, unsharded, n):
    """A rank holding all n shards, and each of n ranks holding one shard
    (its block of 8 / n sequences), give batched_sparse_align's poses bit
    for bit."""
    whole = tbt.sharded_batch_align(tmesh.make_mesh(n, device="cpu"), *_args(batch),
                                    _identity(S)).params7()
    assert torch.equal(whole, unsharded)
    per = S // n
    blocks = [tbt.sharded_batch_align(tmesh.make_mesh(1, device="cpu"),
                                      *_args(batch, slice(k * per, (k + 1) * per)),
                                      _identity(per)).params7() for k in range(n)]
    assert torch.equal(torch.cat(blocks), unsharded)


@pytest.mark.parametrize("n_iter", [15, 3])
def test_matches_jax_kernel_route(batch, interpreted, n_iter):
    """Sequence SEQ against the JAX kernel route at the same cap; the two
    caps' JAX poses lie far apart, so a cap the port ignored would show."""
    T = tbt.sharded_batch_align(tmesh.make_mesh(1, device="cpu"),
                                *_args(batch, slice(SEQ, SEQ + 1)), _identity(1),
                                n_iter=n_iter).params7()
    d = float(tse3.distance(TSE3.from_params7(T), TSE3.from_params7(interpreted[n_iter])).max())
    apart = float(tse3.distance(TSE3.from_params7(interpreted[15]),
                                TSE3.from_params7(interpreted[3])).max())
    print(f"measured: sequence {SEQ} at n_iter {n_iter}, port against the interpreted JAX "
          f"kernel route {d:.2e}; the JAX route at 15 against 3 {apart:.2e}")
    assert d <= TOL_INTERPRETED
    assert apart > 100 * TOL_INTERPRETED


def test_matches_jax_sharded(batch, unsharded):
    """Sanity bound against the JAX sharded run (its CPU route): each
    sequence within twice that route's spread from the kernel route, and
    both runs within 1e-2 of the truth."""
    T = TSE3.from_params7(unsharded)
    d_j = tse3.distance(T, TSE3.from_params7(batch["j7"]))
    gt = TSE3.from_params7(batch["gt7"])
    d_t, d_jt = tse3.distance(T, gt), tse3.distance(TSE3.from_params7(batch["j7"]), gt)
    print(f"measured: sharded batch align, port against JAX {d_j.numpy()}, from the truth port "
          f"{d_t.numpy()}, JAX {d_jt.numpy()}")
    assert float(d_t.max()) < TOL_TRUTH and float(d_jt.max()) < TOL_TRUTH
    assert (d_j.numpy() <= 2 * JAX_ROUTE_SPREAD + TOL_FLOOR).all()


@pytest.mark.parametrize("n_iter, want", [(3, 3), (15, 12)])
def test_n_iter_reaches_k3(batch, monkeypatch, n_iter, want):
    """`n_iter` (capped at 12) reaches K3's plain version, which runs at
    most that many iterations per level; the default keeps 12."""
    seen = []
    plain = tk3.mega_gn_plain

    def spy(*a, **kw):
        st = {}
        out = plain(*a, **kw, stats=st)
        seen.append((a[12], st["passes"]))
        return out

    monkeypatch.setattr(tk3, "mega_gn_plain", spy)
    out = tbt.sharded_batch_align(tmesh.make_mesh(1, device="cpu"), *_args(batch, slice(0, 2)),
                                  _identity(2), n_iter=n_iter).params7()
    assert len(seen) == 2 and all(k == want for k, _ in seen)
    assert all(max(p) <= want + 1 for _, p in seen)
    if n_iter == 3:
        assert any(max(p) == 4 for _, p in seen)     # the cap, not convergence, stopped a level
        assert not torch.equal(out, tbt.sharded_batch_align(
            tmesh.make_mesh(1, device="cpu"), *_args(batch, slice(0, 2)), _identity(2)).params7())


def test_variants_1_and_2_refuse_fewer_iterations(batch, monkeypatch):
    rp, cp, cam, px, d, m = _args(batch, slice(0, 1))
    monkeypatch.setattr(tsa, "FUSED_VARIANT", 2)
    with pytest.raises(ValueError):
        tsa.sparse_image_align(tuple(r[0] for r in rp), tuple(c[0] for c in cp), cam, px[0],
                               d[0], m[0], TSE3.identity(device="cpu"), n_iter=3)
