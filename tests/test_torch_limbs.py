"""The query limbs behind the tensor-core kernels (``hnsw_rs_tpu_torch.ops.limbs``)
and the kernels' arithmetic, emulated on the CPU, against the JAX package's
Pallas kernels run in interpret mode.

``_limb_l2sq`` is what ``csrc/dist_core.cuh`` computes: every limb product
S_l = limbs[l] . c exactly (float64 here, which holds these integers
exactly; int32 on the tensor cores), converted to float32 (exact below
2^24, rounded to nearest past it, as the kernels' I2F), folded from the
top limb down (acc * 256 + S_l, one rounding each), times the
power-of-two scale, then the plain version's affine epilogue in its order.

Tolerances: |limb - jax| <= 2e-6 * (|q|^2 + |x|^2), as for the plain
version (tests/test_torch_l2_kernel.py): the limbs represent q to within
2^-31 of max|q|, and the remaining roundings are a few float32 ulps of the
terms the affine form cancels. Group rows must be equal except where the
two rows' d2 are a tie within 1e-5 * d2 + 2e-6 * (|q|^2 + |x|^2).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu.ops import dequantize, point_normsq, quantize
from hnsw_rs_tpu.ops.pallas import pairwise_l2sq_pallas
from hnsw_rs_tpu.ops.pallas.l2_groupmin import group_min_d2 as j_group_min_d2
from hnsw_rs_tpu.utils import gen_rand_vecs
from hnsw_rs_tpu_torch.ops import cuda_build
from hnsw_rs_tpu_torch.ops.limbs import CHUNK, K_STEP, padded_dim, query_limbs


def _limb_dot(limbs, scale, codes):
    d = codes.shape[1]
    c = codes.to(torch.float64)
    acc = None
    for l in range(limbs.shape[0] - 1, -1, -1):
        s = (limbs[l, :, :d].to(torch.float64) @ c.T).to(torch.float32)
        acc = s if acc is None else acc * 256.0 + s  # the multiply is exact
    return acc * scale[:, None]


def _limb_l2sq(q, codes, scales, normsq, fast=False):
    qp = q.to(torch.bfloat16).to(torch.float32) if fast else q
    dot = _limb_dot(*query_limbs(qp), codes)
    qdotx = scales[:, 1][None] * dot + scales[:, 0][None] * q.sum(1, keepdim=True)
    return torch.clamp_min((q * q).sum(1, keepdim=True) + normsq[None] - 2.0 * qdotx, 0.0)


def _inputs(n, d, b, seed):
    codes, scales = quantize(jnp.asarray(gen_rand_vecs(n, d, seed=seed)))
    nsq = point_normsq(codes, scales)
    q = dequantize(*quantize(jnp.asarray(gen_rand_vecs(b, d, seed=seed + 1))))
    return [np.array(a) for a in (q, codes, scales, nsq)]


def _reconstruct(limbs, scale):
    ints = sum(limbs[l].to(torch.float64) * 256.0 ** l for l in range(limbs.shape[0]))
    return ints * scale.to(torch.float64)[:, None]


@pytest.mark.parametrize("d", [7, 24, 50, 96, 100, 200, 300, 768])
def test_limbs_reconstruct_within_half_scale(d):
    rng = np.random.default_rng(d)
    q = rng.normal(0, 5, (40, d)).astype(np.float32) * rng.random((40, 1)).astype(np.float32)
    q[0] = 0.0                                 # all-zero row
    q[1] = np.clip(q[1], -4.0, 4.0)
    q[1, d // 2] = 4.0                         # max |q| an exact power of two
    q[2] = -2.0 ** -3                          # every component a power of two
    q[3] = 1e-30 * rng.normal(0, 1, d)         # tiny but nonzero
    qt = torch.from_numpy(q)
    limbs, scale = query_limbs(qt)
    assert limbs.dtype == torch.int8 and limbs.shape == (4, 40, padded_dim(d))
    assert scale.dtype == torch.float32 and scale.shape == (40,)
    # the scale is a power of two with one bit of headroom: |Q| <= 2^30
    assert bool((torch.frexp(scale)[0] == 0.5).all())
    assert int(limbs[3].abs().max()) <= 64
    rec = _reconstruct(limbs, scale)
    assert bool((rec[:, d:] == 0).all()) and bool((limbs[:, :, d:] == 0).all())
    err = (rec[:, :d] - qt.to(torch.float64)).abs()
    assert bool((err <= scale.to(torch.float64)[:, None] / 2).all())
    assert bool((limbs[:, 0] == 0).all())
    # a power-of-two maximum is represented exactly, top limb inside int8
    assert rec[1, d // 2] == 4.0 and bool((rec[2, :d] == -0.125).all())


@pytest.mark.parametrize("d", [1, 7, 32, 255, 256, 257, 288, 300, 520, 700, 768])
def test_padded_dim_splits_into_equal_chunks(d):
    """Up to CHUNK, d_pad is d rounded up to a tensor-core step; past it,
    d_pad splits into ceil(d_pad / CHUNK) equal chunks of whole steps,
    each at most CHUNK and wider than CHUNK / 2 (the streamed layout's
    kernels are built for 5 to 8 steps), and pads less than 96."""
    p = padded_dim(d)
    assert p >= d and p % K_STEP == 0 and p - d < 3 * K_STEP
    if p <= CHUNK:
        assert p - d < K_STEP
    else:
        n = -(-p // CHUNK)
        chunk = p // n
        assert chunk * n == p and chunk % K_STEP == 0
        assert CHUNK // 2 < chunk <= CHUNK


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_fewer_limbs_keep_the_headroom(n_limbs):
    q = torch.from_numpy(np.random.default_rng(n_limbs).normal(0, 3, (64, 33)).astype(np.float32))
    q[0, 5] = 8.0
    limbs, scale = query_limbs(q, n_limbs)
    assert limbs.shape == (n_limbs, 64, 64)
    assert int(limbs[-1].abs().max()) <= 64
    err = (_reconstruct(limbs, scale)[:, :33] - q.to(torch.float64)).abs()
    assert bool((err <= scale.to(torch.float64)[:, None] / 2).all())


def test_limbs_reject_bad_inputs():
    with pytest.raises(ValueError, match="float32"):
        query_limbs(torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="n_limbs"):
        query_limbs(torch.zeros((2, 3)), n_limbs=5)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("n,d,b,tb,tn,seed", [(300, 50, 70, 64, 128, 0),
                                              (512, 128, 128, 128, 256, 2),
                                              (256, 300, 40, 64, 128, 5),
                                              (200, 768, 30, 64, 128, 6)])
def test_limb_product_matches_pallas_kernel(n, d, b, tb, tn, seed, fast):
    q, codes, scales, nsq = _inputs(n, d, b, seed)
    want = np.asarray(pairwise_l2sq_pallas(
        *(jnp.asarray(a) for a in (q, codes, scales, nsq)), tb=tb, tn=tn,
        interpret=True, fast=fast))
    got = _limb_l2sq(*(torch.from_numpy(a) for a in (q, codes, scales, nsq)), fast).numpy()
    mag = (q * q).sum(1)[:, None] + nsq[None, :]
    err = np.abs(got - want)
    assert np.all(err <= 2e-6 * mag), float((err / mag).max())
    assert np.all(got >= 0.0)


# the Pallas kernel takes B a multiple of 256 and N of 2048
@pytest.mark.parametrize("n,d,b,seed", [(4096, 24, 256, 1), (2048, 96, 256, 3),
                                        (2048, 7, 256, 4)])
def test_limb_group_minima_match_pallas_kernel(n, d, b, seed):
    rng = np.random.default_rng(seed)
    codes, scales = quantize(jnp.asarray(rng.random((n, d), np.float32)))
    nsq = point_normsq(codes, scales)
    q = dequantize(*quantize(jnp.asarray(rng.random((b, d), np.float32))))
    jd, ji = j_group_min_d2(q, codes, scales, nsq, interpret=True)
    jd, ji = np.asarray(jd).T, np.asarray(ji).T  # Pallas writes [N/128, B]
    tq, tc, ts, tn = (torch.from_numpy(np.array(a)) for a in (q, codes, scales, nsq))
    d2 = _limb_l2sq(tq, tc, ts, tn).view(b, n // 128, 128)
    ld, lr = d2.min(dim=-1)  # the first row of the minimum, as the kernel keeps
    li = (lr + torch.arange(0, n, 128)[None]).numpy()
    ld = ld.numpy()
    mag = (np.array(q) ** 2).sum(1)[:, None] + np.array(nsq)[li]
    tol = 1e-5 * jd + 2e-6 * mag
    assert np.all(np.abs(ld - jd) <= tol)
    # a differing row is a tie: its d2 under the limb arithmetic is within
    # the tolerance of the JAX row's
    flat = _limb_l2sq(tq, tc, ts, tn).numpy()
    diff = li != ji
    rows_b = np.nonzero(diff)[0]
    ties = np.abs(flat[rows_b, ji[diff]] - flat[rows_b, li[diff]])
    assert np.all(ties <= tol[diff])
    print(f"group rows differing from the Pallas kernel (ties): {int(diff.sum())}")


def test_library_key_covers_shared_headers(tmp_path, monkeypatch):
    for src in cuda_build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    headers = sorted(tmp_path.glob("*.cuh"))
    assert headers, "the kernels share a header"
    before = {n: cuda_build.library_path(n) for n in ("group_min", "l2_kernel")}
    assert before == {n: cuda_build.library_path(n) for n in before}  # stable
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in before}
    assert all(before[n] != after[n] for n in before)
    # a new header joins the key too
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(cuda_build.library_path(n) != after[n] for n in before)
