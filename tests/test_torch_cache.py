"""The port's warm-start cache joins. On the CPU, the plain twins against
the JAX package's: the join hits (which current key finds which cache row)
must be exact, also on duplicate keys, where the highest-indexed equal
cache row wins and only the lowest-indexed equal current row gets it (the
contract the CUDA hash join copies, held here against a rule written out
in numpy too). On the card (marked gpu; skipped without one), the hash
join (`csrc/join.cu`) against the twins on the same CUDA tensors, bit for
bit.

The CPU tests import JAX inside the tests, so on a machine with a card and
no JAX the card tests run without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cache.py
"""

import numpy as np
import pytest
import torch

from nudge_tpu_torch import trace
from nudge_tpu_torch.ops import cache as pcache
from nudge_tpu_torch.state import tree_map

torch.set_num_threads(2)

I32_MAX = 2 ** 31 - 1
WORD_SENTINEL = 2 ** 30 - 1


def _jax():
    """The JAX package's cache module, its ContactCache and the bridge."""
    import jax.numpy as jnp

    import _torch_bridge
    from nudge_tpu.ops import cache as jcache
    from nudge_tpu.state import ContactCache as JCache

    return jnp, jcache, JCache, _torch_bridge


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


def _rule(c_keys, c_valid, k_keys, k_valid, sentinel):
    """The join's rule written out: for each current row, the cache row it
    takes (-1: none). A row's key is its key where valid, else `sentinel`;
    a valid current row that is the lowest-indexed current row with its key
    takes the highest-indexed cache row with that key."""
    def eff(keys, valid):
        return [tuple(int(k[i]) for k in keys) if valid[i] else sentinel
                for i in range(valid.shape[0])]

    last_cache, first_cur = {}, {}
    for i, k in enumerate(eff(c_keys, c_valid)):
        last_cache[k] = i
    k_eff = eff(k_keys, k_valid)
    for i, k in enumerate(k_eff):
        first_cur.setdefault(k, i)
    return np.array([last_cache.get(k, -1) if k_valid[r] and first_cur[k] == r
                     else -1 for r, k in enumerate(k_eff)], np.int64)


def _dup_rows(rng, n, n_ids, n_feat, valid_frac):
    """Rows with many repeated keys, some invalid rows carrying a valid
    row's key, and a few valid keys at or next to the sentinel."""
    ga, gb, ft = _keys(rng, n, n_ids, n_feat)
    valid = rng.uniform(size=n) < valid_frac
    near = rng.choice(n, size=max(n // 10, 2), replace=False)
    for j, i in enumerate(near):
        pick = [(I32_MAX, I32_MAX, I32_MAX), (I32_MAX, I32_MAX, I32_MAX - 1),
                (I32_MAX - 1, I32_MAX, I32_MAX), (I32_MAX, 0, I32_MAX)][j % 4]
        ga[i], gb[i], ft[i] = pick
    return ga, gb, ft, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_hits_match_reference(seed):
    jnp, jcache, _, bridge = _jax()
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
    bridge.assert_equal(p, j)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_join_duplicate_rule_matches_reference(seed):
    """Duplicate keys on both sides, invalid rows with valid rows' keys and
    valid keys at the sentinel: the twin, the JAX package and the rule
    written out agree row for row."""
    jnp, jcache, _, bridge = _jax()
    rng = np.random.default_rng(100 + seed)
    c_ga, c_gb, c_ft, c_valid = _dup_rows(rng, 240, 5, 3, 0.7)
    k_ga, k_gb, k_ft, k_valid = _dup_rows(rng, 180, 5, 3, 0.8)
    k_valid[:3] = True                  # a valid key at the sentinel
    k_ga[:3] = k_gb[:3] = k_ft[:3] = I32_MAX
    payload = np.stack([np.arange(c_ga.shape[0], dtype=np.float32) + 1,
                        -np.arange(c_ga.shape[0], dtype=np.float32)], 1)
    args = (c_ga, c_gb, c_ft, payload, c_valid, k_ga, k_gb, k_ft, k_valid)
    j = np.asarray(jcache._join(*map(jnp.asarray, args)))
    p = pcache._join(*map(torch.from_numpy, args))
    bridge.assert_equal(p, j)
    want = _rule((c_ga, c_gb, c_ft), c_valid, (k_ga, k_gb, k_ft), k_valid,
                 (I32_MAX,) * 3)
    assert (want >= 0).sum() > 20
    assert ((want < 0) & k_valid).sum() > 20   # duplicates and misses
    bridge.assert_equal(j[:, 0], np.where(want >= 0, want + 1, 0))


@pytest.mark.parametrize("seed", [0, 1])
def test_join_i32_duplicate_rule_matches_reference(seed):
    """join_i32 on repeated keys and keys at or next to its sentinel
    2^30 - 1: the twin, the JAX package and the rule agree."""
    jnp, jcache, _, bridge = _jax()
    rng = np.random.default_rng(200 + seed)
    ck = rng.integers(0, 40, 300).astype(np.int32)
    kk = rng.integers(0, 40, 220).astype(np.int32)
    for keys in (ck, kk):
        at = rng.choice(keys.shape[0], 30, replace=False)
        keys[at] = WORD_SENTINEL - rng.integers(0, 2, 30)
    cval = rng.uniform(size=ck.shape[0]) < 0.75
    kval = rng.uniform(size=kk.shape[0]) < 0.85
    cpay = np.arange(1, ck.shape[0] + 1, dtype=np.int32)
    args = (ck, cpay, cval, kk, kval)
    j = np.asarray(jcache.join_i32(*map(jnp.asarray, args)))
    p = pcache.join_i32(*map(torch.from_numpy, args))
    bridge.assert_equal(p, j)
    want = _rule((ck,), cval, (kk,), kval, (WORD_SENTINEL,))
    assert (want >= 0).sum() > 20
    bridge.assert_equal(j, np.where(want >= 0, want + 1, 0))


def test_join_i32_matches_reference():
    jnp, jcache, _, bridge = _jax()
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
    bridge.assert_equal(p, j)


def _manifolds(rng, m=40, n_ids=30, device="cpu"):
    """Port manifolds with unique (ga, gb) and distinct features."""
    from nudge_tpu_torch.ops.contacts import Manifolds

    pairs = rng.permutation(n_ids * n_ids)[:m]
    ga, gb = (pairs // n_ids).astype(np.int32), (pairs % n_ids).astype(np.int32)
    feat = np.stack([rng.permutation(24)[:4] for _ in range(m)]).astype(np.int32)
    pv = rng.uniform(size=(m, 4)) < 0.75
    valid = pv.any(1)

    def t(x):
        return torch.from_numpy(x).to(device)

    z3 = np.zeros((m, 3), np.float32)
    return Manifolds(
        body_a=t(ga), body_b=t(gb), ga=t(ga), gb=t(gb), normal=t(z3),
        friction=t(np.zeros(m, np.float32)),
        pos=t(np.zeros((m, 4, 3), np.float32)),
        depth=t(np.zeros((m, 4), np.float32)), feat=t(feat),
        point_valid=t(pv), valid=t(valid),
        count=torch.tensor(int(valid.sum()), dtype=torch.int32, device=device),
        overflow=torch.tensor(False, device=device))


def test_read_write_roundtrip_matches_reference():
    jnp, jcache, JCache, bridge = _jax()
    rng = np.random.default_rng(7)
    man0 = _manifolds(rng)
    imp = torch.from_numpy(rng.normal(size=(40, 4, 3)).astype(np.float32))
    pse = torch.from_numpy(rng.uniform(size=(40, 4)).astype(np.float32))
    pc = pcache.write_cached_impulses(man0, imp, pse)
    jc = jcache.write_cached_impulses(bridge.jax_manifolds(man0),
                                      jnp.asarray(imp), jnp.asarray(pse))
    for k in ("ga", "gb", "feat", "impulse", "pseudo", "valid"):
        bridge.assert_equal(getattr(pc, k), getattr(jc, k), k)
    # next frame: keep half the manifolds, shuffle, add new ones
    man1 = _manifolds(np.random.default_rng(7))
    perm = torch.from_numpy(np.random.default_rng(8).permutation(40))
    for k in ("body_a", "body_b", "ga", "gb", "feat", "point_valid", "valid"):
        setattr(man1, k, getattr(man1, k)[perm])
    pw, pp = pcache.read_cached_impulses(pc, man1)
    jw, jp = jcache.read_cached_impulses(
        JCache(**{k: jnp.asarray(bridge.np_(getattr(pc, k)))
                  for k in ("ga", "gb", "feat", "impulse", "pseudo", "valid")}),
        bridge.jax_manifolds(man1))
    assert (np.asarray(jp) > 0).sum() > 20
    bridge.assert_equal((pw != 0).any(-1), (np.asarray(jw) != 0).any(-1),
                        "hits")
    bridge.assert_close(pw, jw, 0.0)
    bridge.assert_close(pp, jp, 0.0)
    bridge.assert_equal(pw, imp[perm] * man1.point_valid[..., None])


def test_join_of_cache_with_itself_hits_every_row():
    rng = np.random.default_rng(9)
    c_ga, c_gb, c_ft, c_valid = _unique_rows(rng, 50, 1.0)
    payload = np.ones((c_ga.shape[0], 1), np.float32)
    out = pcache._join(*map(torch.from_numpy, (
        c_ga, c_gb, c_ft, payload, c_valid, c_ga, c_gb, c_ft, c_valid)))
    assert out.device.type == "cpu"
    assert torch.all(out[:, 0] == 1.0)


def test_table_slots():
    """A table is the power of two >= 2 x its rows (at least 4): at most
    half full."""
    assert [pcache._table_slots(n) for n in (0, 1, 2, 3)] == [4, 4, 4, 8]
    assert pcache._table_slots(245_760) == 2 ** 19
    assert pcache._table_slots(1_572_876) == 2 ** 22
    assert pcache._table_slots(393_219) == 2 ** 20


# --- the hash join on the card -------------------------------------------

PILE_ROWS, BATCH_ROWS = 245_760, 1_572_876


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_bits(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    diff = int((_bits(a) != _bits(b)).sum())
    assert diff == 0, f"{what}: {diff} words differ from the twin's"


def _card_rows(gen, n, n_ids, n_feat, live, dev, near_sentinel=False):
    """n rows of (ga, gb, feat, valid) on the card, keys drawn from a small
    range so they repeat, `live` of them valid; with `near_sentinel` some
    keys at or next to INT_MAX."""
    ga = torch.randint(0, n_ids, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    gb = torch.randint(0, n_ids, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    ft = torch.randint(0, n_feat, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    valid = torch.rand(n, generator=gen, device=dev) < live
    if near_sentinel:
        at = torch.rand(n, generator=gen, device=dev) < 0.02
        off = torch.randint(0, 2, (3, n), generator=gen, device=dev,
                            dtype=torch.int32)
        ga = torch.where(at, I32_MAX - off[0], ga)
        gb = torch.where(at, I32_MAX - off[1], gb)
        ft = torch.where(at, I32_MAX - off[2], ft)
    return ga, gb, ft, valid


def _payload(gen, n, w, dev):
    p = torch.randn((n, w), generator=gen, device=dev)
    p[::7] = -0.0
    return p


def _check_join(c, k, payload):
    """The kernel's _join against the twin's on the same CUDA tensors,
    bitwise, and again bitwise itself."""
    args = (*c[:3], payload, c[3], *k)
    got = pcache._join(*args)
    again = pcache._join(*args)
    want = pcache._join_plain(*args)
    torch.cuda.synchronize()
    _same_bits(got, want, "join")
    _same_bits(again, got, "join repeat")
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [PILE_ROWS, BATCH_ROWS])
@pytest.mark.parametrize("width", [1, 3, 4])
def test_hash_join_matches_twin(cuda, rows, width):
    """Random keys at the pile's and the batch's row counts, repeated on
    both sides (ids and features from small ranges), a third of the rows
    invalid and carrying valid-looking keys, some keys at or next to the
    sentinel: the kernel's payloads are the twin's bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(rows + width)
    n_ids = int(rows ** 0.5) // 2
    c = _card_rows(gen, rows, n_ids, 4, 0.66, cuda, near_sentinel=True)
    k = _card_rows(gen, rows, n_ids, 4, 0.66, cuda, near_sentinel=True)
    got, want = _check_join(c, k, _payload(gen, rows, width, cuda))
    hit = (want != 0).any(1)
    assert int(hit.sum()) > rows // 10


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["all_miss", "all_hit", "empty_cache",
                                  "empty_current", "sentinel_keys",
                                  "all_invalid"])
def test_hash_join_edge_cases(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = 4096
    ga = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
    gb = torch.randint(0, 8, (n,), generator=gen, device=cuda,
                       dtype=torch.int32)
    ft = torch.randint(0, 4, (n,), generator=gen, device=cuda,
                       dtype=torch.int32)
    yes = torch.ones(n, dtype=torch.bool, device=cuda)
    c = [ga, gb, ft, yes.clone()]
    k = [ga.flip(0).contiguous(), gb.flip(0).contiguous(),
         ft.flip(0).contiguous(), yes.clone()]
    if case == "all_miss":
        k[0] = k[0] + n
    elif case == "empty_cache":
        c = [x[:0] for x in c]
    elif case == "empty_current":
        k = [x[:0] for x in k]
    elif case == "sentinel_keys":
        # valid rows keyed as the sentinel group with the invalid ones, and
        # keys one off it in each word
        for x in (c[0], c[1], c[2], k[0], k[1], k[2]):
            x[::5] = I32_MAX
        c[0][1::5] = I32_MAX - 1
        k[2][2::5] = I32_MAX - 1
        c[3][::3] = False
        k[3][1::3] = False
    elif case == "all_invalid":
        c[3].zero_()
        k[3].zero_()
    payload = _payload(gen, c[0].shape[0], 3, cuda)
    got, want = _check_join(c, k, payload)
    if case == "all_hit":
        assert torch.equal(got, payload.flip(0))
    if case in ("all_miss", "empty_cache", "all_invalid"):
        assert not bool((_bits(got) != 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [PILE_ROWS // 2, BATCH_ROWS // 4])
def test_hash_join_i32_matches_twin(cuda, rows):
    """join_i32 on repeated keys, keys at and next to 2^30 - 1, and keys
    past 2^30 and negative (the twin's key * 2 wraps): bitwise the twin."""
    gen = torch.Generator(device=cuda).manual_seed(rows)

    def side():
        key = torch.randint(0, rows, (rows,), generator=gen, device=cuda,
                            dtype=torch.int32)
        odd = torch.rand(rows, generator=gen, device=cuda)
        key = torch.where(odd < 0.01, WORD_SENTINEL - (key & 1), key)
        key = torch.where((odd > 0.01) & (odd < 0.02), key + 2 ** 30, key)
        key = torch.where((odd > 0.02) & (odd < 0.03), -key - 1, key)
        return key, torch.rand(rows, generator=gen, device=cuda) < 0.7

    ck, cval = side()
    kk, kval = side()
    cpay = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows,), generator=gen,
                         device=cuda, dtype=torch.int32)
    got = pcache.join_i32(ck, cpay, cval, kk, kval)
    want = pcache.join_i32_plain(ck, cpay, cval, kk, kval)
    torch.cuda.synchronize()
    _same_bits(got, want, "join_i32")
    assert int((want != 0).sum()) > rows // 10


@pytest.mark.gpu
def test_read_cached_impulses_kernel_matches_twin(cuda):
    """read_cached_impulses on the card (the manifolds' pairs read once a
    manifold) against the CPU twin on the same rows, bitwise, and the
    traced counts: the valid points that found a row, and the cache-table
    slots read (a key's run to its end: at least one a valid point, and
    the same in every call, whatever order the inserts ran in)."""
    m = 20_000
    rng = np.random.default_rng(7)
    man0 = _manifolds(rng, m=m, n_ids=400, device=cuda)
    imp = torch.randn((m, 4, 3), device=cuda)
    pse = torch.rand((m, 4), device=cuda) + 0.5
    pc = pcache.write_cached_impulses(man0, imp, pse)
    man1 = _manifolds(np.random.default_rng(7), m=m, n_ids=400, device=cuda)
    perm = torch.from_numpy(np.random.default_rng(8).permutation(m)).to(cuda)
    for f in ("body_a", "body_b", "ga", "gb", "feat", "point_valid", "valid"):
        setattr(man1, f, getattr(man1, f)[perm].contiguous())
    counts = []
    for _ in range(3):
        with trace.on(), trace.span("read"):
            kw, kp = pcache.read_cached_impulses(pc, man1)
        counts.append(trace.collect().spans[0].counts)
    tw, tp = pcache.read_cached_impulses(
        tree_map(lambda x: x.cpu(), pc), tree_map(lambda x: x.cpu(), man1))
    _same_bits(kw.cpu(), tw, "impulse")
    _same_bits(kp.cpu(), tp, "pseudo")
    hits = int((tp != 0).sum())
    assert hits > m
    assert counts[0]["cache_hits"] == hits
    assert counts[0]["cache_probes"] >= int(man1.point_valid.sum())
    assert counts[1] == counts[0] and counts[2] == counts[0]
