"""The port's warm-start cache joins against the JAX package's: the join
hits (which current key finds which cache row) must be exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nudge_tpu.ops import cache as jcache
from nudge_tpu.state import ContactCache as JCache
from nudge_tpu_torch.ops import cache as pcache

from _torch_bridge import assert_close, assert_equal, jax_manifolds, np_

torch.set_num_threads(2)


def _keys(rng, n, n_ids=12, n_feat=6):
    return (rng.integers(0, n_ids, n).astype(np.int32),
            rng.integers(0, n_ids, n).astype(np.int32),
            rng.integers(0, n_feat, n).astype(np.int32))


def _unique_rows(rng, n, valid_frac):
    """n rows of keys, unique among the valid ones."""
    ga, gb, ft = _keys(rng, 4 * n)
    _, first = np.unique(np.stack([ga, gb, ft], 1), axis=0, return_index=True)
    sel = rng.permutation(np.sort(first))[:n]
    valid = rng.uniform(size=sel.shape[0]) < valid_frac
    return ga[sel], gb[sel], ft[sel], valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_hits_match_reference(seed):
    rng = np.random.default_rng(seed)
    c_ga, c_gb, c_ft, c_valid = _unique_rows(rng, 200, 0.7)
    k_ga, k_gb, k_ft, k_valid = _unique_rows(rng, 150, 0.8)
    # payload 1 + row index: a hit names its cache row, a miss reads 0
    payload = np.stack([np.arange(c_ga.shape[0], dtype=np.float32) + 1,
                        rng.normal(size=c_ga.shape[0]).astype(np.float32)], 1)
    args = (c_ga, c_gb, c_ft, payload, c_valid, k_ga, k_gb, k_ft, k_valid)
    j = jcache._join(*map(jnp.asarray, args))
    p = pcache._join(*map(torch.from_numpy, args))
    assert (np.asarray(j)[:, 0] > 0).sum() > 10
    assert_equal(p, j)


def test_join_i32_matches_reference():
    rng = np.random.default_rng(5)
    ck = rng.permutation(5000)[:300].astype(np.int32)
    kk = np.concatenate([ck[:150], rng.permutation(5000)[:150]]).astype(np.int32)
    kk = np.unique(kk)[:250]
    cpay = rng.integers(0, 1 << 20, ck.shape[0]).astype(np.int32)
    cval = rng.uniform(size=ck.shape[0]) < 0.8
    kval = rng.uniform(size=kk.shape[0]) < 0.9
    args = (ck, cpay, cval, kk, kval)
    j = jcache.join_i32(*map(jnp.asarray, args))
    p = pcache.join_i32(*map(torch.from_numpy, args))
    assert (np.asarray(j) != 0).sum() > 50
    assert_equal(p, j)


def _manifolds(rng, m=40, n_ids=30):
    """Port manifolds with unique (ga, gb) and distinct features."""
    from nudge_tpu_torch.ops.contacts import Manifolds

    pairs = rng.permutation(n_ids * n_ids)[:m]
    ga, gb = (pairs // n_ids).astype(np.int32), (pairs % n_ids).astype(np.int32)
    feat = np.stack([rng.permutation(24)[:4] for _ in range(m)]).astype(np.int32)
    pv = rng.uniform(size=(m, 4)) < 0.75
    valid = pv.any(1)
    t = torch.from_numpy
    z3 = np.zeros((m, 3), np.float32)
    return Manifolds(
        body_a=t(ga), body_b=t(gb), ga=t(ga), gb=t(gb), normal=t(z3),
        friction=t(np.zeros(m, np.float32)),
        pos=t(np.zeros((m, 4, 3), np.float32)),
        depth=t(np.zeros((m, 4), np.float32)), feat=t(feat),
        point_valid=t(pv), valid=t(valid),
        count=torch.tensor(int(valid.sum()), dtype=torch.int32),
        overflow=torch.tensor(False))


def test_read_write_roundtrip_matches_reference():
    rng = np.random.default_rng(7)
    man0 = _manifolds(rng)
    imp = torch.from_numpy(rng.normal(size=(40, 4, 3)).astype(np.float32))
    pse = torch.from_numpy(rng.uniform(size=(40, 4)).astype(np.float32))
    pc = pcache.write_cached_impulses(man0, imp, pse)
    jc = jcache.write_cached_impulses(jax_manifolds(man0), jnp.asarray(imp),
                                      jnp.asarray(pse))
    for k in ("ga", "gb", "feat", "impulse", "pseudo", "valid"):
        assert_equal(getattr(pc, k), getattr(jc, k), k)
    # next frame: keep half the manifolds, shuffle, add new ones
    man1 = _manifolds(np.random.default_rng(7))
    perm = torch.from_numpy(np.random.default_rng(8).permutation(40))
    for k in ("body_a", "body_b", "ga", "gb", "feat", "point_valid", "valid"):
        setattr(man1, k, getattr(man1, k)[perm])
    pw, pp = pcache.read_cached_impulses(pc, man1)
    jw, jp = jcache.read_cached_impulses(
        JCache(**{k: jnp.asarray(np_(getattr(pc, k)))
                  for k in ("ga", "gb", "feat", "impulse", "pseudo", "valid")}),
        jax_manifolds(man1))
    assert (np.asarray(jp) > 0).sum() > 20
    assert_equal((pw != 0).any(-1), (np.asarray(jw) != 0).any(-1), "hits")
    assert_close(pw, jw, 0.0)
    assert_close(pp, jp, 0.0)
    assert_equal(pw, imp[perm] * man1.point_valid[..., None])


def test_join_of_cache_with_itself_hits_every_row():
    rng = np.random.default_rng(9)
    c_ga, c_gb, c_ft, c_valid = _unique_rows(rng, 50, 1.0)
    payload = np.ones((c_ga.shape[0], 1), np.float32)
    out = pcache._join(*map(torch.from_numpy, (
        c_ga, c_gb, c_ft, payload, c_valid, c_ga, c_gb, c_ft, c_valid)))
    assert out.device.type == "cpu"
    assert torch.all(out[:, 0] == 1.0)
