"""The port's quantized all-pairs L2 (``hnsw_rs_tpu_torch.ops.l2_kernel``)
against the JAX package's Pallas kernel ``pairwise_l2sq_pallas``, run in
interpret mode on the CPU, at the two shapes of tests/test_pallas.py and
with ``fast`` False and True.

Tolerance: |port - jax| <= 2e-6 * (|q|^2 + |x|^2). The affine form cancels
those two terms, so its rounding error scales with them, not with d2; the
two sides sum the q.c products in different orders, a few float32 ulps
(1.2e-7 each) of that magnitude. With ``fast`` both round q to bf16 the
same way (round to nearest even) and a bf16 value times a code is exact
in float32, so the same bound holds. The CUDA kernel runs only on a GPU:
tests/test_torch_cuda.py holds it against this plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu.ops import dequantize, point_normsq, quantize
from hnsw_rs_tpu.ops.pallas import pairwise_l2sq_pallas
from hnsw_rs_tpu.utils import gen_rand_vecs
from hnsw_rs_tpu_torch.ops import l2_kernel


def _inputs(n, d, b, seed):
    codes, scales = quantize(jnp.asarray(gen_rand_vecs(n, d, seed=seed)))
    nsq = point_normsq(codes, scales)
    q = dequantize(*quantize(jnp.asarray(gen_rand_vecs(b, d, seed=seed + 1))))
    return [np.array(a) for a in (q, codes, scales, nsq)]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("n,d,b,tb,tn,seed", [(300, 50, 70, 64, 128, 0),
                                              (512, 128, 128, 128, 256, 2)])
def test_plain_matches_pallas_kernel(n, d, b, tb, tn, seed, fast):
    q, codes, scales, nsq = _inputs(n, d, b, seed)
    want = np.asarray(pairwise_l2sq_pallas(
        *(jnp.asarray(a) for a in (q, codes, scales, nsq)), tb=tb, tn=tn,
        interpret=True, fast=fast))
    before = l2_kernel.pairwise_l2sq_kernel.launches
    got = l2_kernel.pairwise_l2sq_kernel(
        *(torch.from_numpy(a) for a in (q, codes, scales, nsq)), fast=fast)
    assert l2_kernel.pairwise_l2sq_kernel.launches == before  # CPU: plain
    assert got.shape == (b, n) and got.dtype == torch.float32
    mag = (q * q).sum(1)[:, None] + nsq[None, :]
    err = np.abs(got.numpy() - want)
    assert np.all(err <= 2e-6 * mag), float((err / mag).max())
    assert np.all(got.numpy() >= 0.0)


def test_fast_rounds_only_the_product():
    q, codes, scales, nsq = (torch.from_numpy(a) for a in _inputs(300, 50, 70, 0))
    exact = l2_kernel.pairwise_l2sq_plain(q, codes, scales, nsq)
    fast = l2_kernel.pairwise_l2sq_plain(q, codes, scales, nsq, fast=True)
    qb = q.to(torch.bfloat16).to(torch.float32)
    # the bf16 query enters only through q.c: the product of the rounded
    # query with the unrounded |q|^2 and sum(q) terms
    want = torch.clamp_min(
        (q * q).sum(1, keepdim=True) + nsq[None]
        - 2.0 * (scales[:, 1][None] * (qb @ codes.float().T)
                 + scales[:, 0][None] * q.sum(1, keepdim=True)), 0.0)
    assert torch.equal(fast, want)
    assert not torch.equal(fast, exact)


def test_wrapper_rejects_bad_inputs():
    q, codes, scales, nsq = (torch.from_numpy(a) for a in _inputs(64, 8, 4, 5))
    with pytest.raises(TypeError, match="codes"):
        l2_kernel.pairwise_l2sq_kernel(q, codes.to(torch.int32), scales, nsq)
    with pytest.raises(TypeError, match="q must be"):
        l2_kernel.pairwise_l2sq_kernel(q.double(), codes, scales, nsq)
    with pytest.raises(ValueError, match="shapes"):
        l2_kernel.pairwise_l2sq_kernel(q[:, :5], codes, scales, nsq)
    with pytest.raises(ValueError, match="scales must be"):
        l2_kernel.pairwise_l2sq_kernel(q, codes, scales[:10], nsq)
    with pytest.raises(ValueError, match="contiguous"):
        l2_kernel.pairwise_l2sq_kernel(q, codes.T.contiguous().T, scales, nsq)
    with pytest.raises(ValueError, match="is on"):
        l2_kernel.pairwise_l2sq_kernel(q, codes, scales, nsq.to("meta"))
