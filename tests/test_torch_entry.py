"""The port's entry points (``entry``) on the CPU: ``entry``'s
query step against the JAX package's ``search.ann_search`` on the same
index arrays and queries (ids equal), and ``dryrun_multichip`` over a
3-cell and an 8-cell mesh of one device, with its line. The JAX ``entry()`` is not
called: it sets a JAX compile-cache directory; its arrays are built here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hnsw_rs_tpu import search as jsearch
from hnsw_rs_tpu_torch.entry import dryrun_multichip, entry, main


def test_entry_step_matches_jax_ann_search():
    fn, args = entry("cpu")
    adjs, codes, scales, q, ep = args
    assert codes.shape == (512, 50) and q.shape == (64, 50) and len(adjs) >= 2
    assert all(a.device == torch.device("cpu") for a in (codes, scales, q, *adjs))
    dist, ids = fn(*args)
    assert dist.shape == ids.shape == (64, 10)
    assert np.all(np.isfinite(dist.numpy()))
    jfn = jax.jit(functools.partial(jsearch.ann_search, ef=64, k=10, max_iters=144))
    jd, ji = jfn(tuple(jnp.asarray(a.numpy()) for a in adjs), jnp.asarray(codes.numpy()),
                 jnp.asarray(scales.numpy()), jnp.asarray(q.numpy()),
                 jnp.asarray(ep, jnp.int32))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    assert np.mean(ids.numpy()[:, 0] == np.arange(64)) >= 0.95  # self-match


def test_dryrun_multichip_on_one_device(capsys):
    dryrun_multichip(3, "cpu")  # an odd count: one data row
    out = capsys.readouterr().out
    assert "dryrun_multichip ok on 3 devices: mesh (data=1, shard=3)" in out
    assert "self-match 8/8 plain+seeded" in out


def test_entry_cli_runs_both(capsys):
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry ok: (64, 10) (64, 10)" in out
    assert "dryrun_multichip ok on 8 devices: mesh (data=2, shard=4)" in out
