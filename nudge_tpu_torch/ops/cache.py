"""Warm-start impulse cache: the join on persistent contact keys (PyTorch
port of `nudge_tpu.ops.cache`, without the aligned fast path).

The plain twins (`_join_plain`, `join_i32_plain`) are the reference's
sort-merge join: cache rows (src=0) and current contact points (src=1) are
concatenated and sorted lexicographically by (ga, gb, feat, src); a current
point matches iff its sorted predecessor is a cache row with the same key.
torch has no multi-key sort, so the lexicographic order is built from
stable sorts, least significant key first. Every current row lands on its
own output row, so the reference's `.at[].add(mode="drop")` becomes a
scatter into unique rows plus one discarded row.

On the card `_join`, `join_i32` and `read_cached_impulses` launch one hash
join instead (`csrc/join.cu`), bit for bit the twins' on any input: current
row r gets the payload of the highest-indexed cache row with its key iff r
is valid and the lowest-indexed current row with that key (invalid rows
carry a sentinel key). Where a payload requires grad, the join is one
autograd node (`_JoinFn`) whose backward gathers each cache row's adjoint
from the one current row it went to, which the kernel records: each cache
row takes at most one term, and no adjoint of a miss reaches any row. With tracing on, `read_cached_impulses` counts `cache_hits` (the
valid points that found a row) and `cache_probes` (the cache-table slots
their lookups read).
"""

from __future__ import annotations

import math

import torch

from .. import _build, control, trace
from ..state import ContactCache
from .contacts import Manifolds

_SENTINEL = 2 ** 31 - 1


def _lexsort(keys):
    """Stable lexicographic order of equal-length 1-D key tensors, most
    significant first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _roll1(x):
    return torch.roll(x, 1, 0)


def _scatter_rows(n_cur, orig, sel, vals):
    """out[orig[r]] = vals[r] for rows with sel; other rows go to a spare
    row that is cut off."""
    tgt = torch.where(sel, orig, n_cur).to(torch.int64)
    out = torch.zeros((n_cur + 1,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    out.index_copy_(0, tgt, torch.where(
        sel.reshape(sel.shape + (1,) * (vals.ndim - 1)), vals,
        torch.zeros((), dtype=vals.dtype, device=vals.device)))
    return out[:n_cur]


def _join_plain(c_ga, c_gb, c_feat, c_imp, c_valid, k_ga, k_gb, k_feat,
                k_valid):
    """`_join` as the reference's sort-merge join."""
    dev = c_ga.device
    sent = torch.full((), _SENTINEL, dtype=torch.int32, device=dev)
    c_ga = torch.where(c_valid, c_ga, sent)
    c_gb = torch.where(c_valid, c_gb, sent)
    c_feat = torch.where(c_valid, c_feat, sent)
    k_ga = torch.where(k_valid, k_ga, sent)
    k_gb = torch.where(k_valid, k_gb, sent)
    k_feat = torch.where(k_valid, k_feat, sent)

    n_cache, n_cur = c_ga.shape[0], k_ga.shape[0]
    w = c_imp.shape[1]
    ga = torch.cat([c_ga, k_ga])
    gb = torch.cat([c_gb, k_gb])
    feat = torch.cat([c_feat, k_feat])
    src = torch.cat([torch.zeros(n_cache, dtype=torch.int32, device=dev),
                     torch.ones(n_cur, dtype=torch.int32, device=dev)])
    payload = torch.cat([c_imp, torch.zeros((n_cur, w), dtype=torch.float32,
                                            device=dev)])
    orig = torch.cat([torch.full((n_cache,), -1, dtype=torch.int32, device=dev),
                      torch.arange(n_cur, dtype=torch.int32, device=dev)])

    order = _lexsort([ga, gb, feat, src])
    ga, gb, feat, src = ga[order], gb[order], feat[order], src[order]
    payload, orig = payload[order], orig[order]

    prev_match = ((src == 1) & (_roll1(src) == 0) & (ga == _roll1(ga))
                  & (gb == _roll1(gb)) & (feat == _roll1(feat)))
    prev_match[0].fill_(False)
    matched = torch.where(prev_match[:, None], _roll1(payload), 0.0)
    out = _scatter_rows(n_cur, orig, src == 1, matched)
    return torch.where(k_valid[:, None], out, 0.0)


def join_i32_plain(c_key, c_payload, c_valid, k_key, k_valid):
    """`join_i32` as the reference's sort-merge join."""
    dev = c_key.device
    big = torch.full((), 2 ** 30 - 1, dtype=torch.int32, device=dev)
    ck = torch.where(c_valid, c_key, big)
    kk = torch.where(k_valid, k_key, big)
    n_cur = kk.shape[0]
    key2 = torch.cat([ck * 2, kk * 2 + 1])
    payload = torch.cat([c_payload, torch.zeros_like(kk)])
    orig = torch.cat([torch.full(ck.shape, -1, dtype=torch.int32, device=dev),
                      torch.arange(n_cur, dtype=torch.int32, device=dev)])
    key2, order = torch.sort(key2, stable=True)
    payload, orig = payload[order], orig[order]
    match = ((key2 & 1) == 1) & (key2 == _roll1(key2) + 1)
    match[0].fill_(False)
    matched = torch.where(match, _roll1(payload), 0)
    out = _scatter_rows(n_cur, orig, (key2 & 1) == 1, matched)
    return torch.where(k_valid, out, 0)


def _table_slots(rows: int) -> int:
    """A hash table's slots for `rows` rows: the power of two >= 2 x rows
    (and >= 4, so the kernel resets the tables 16 bytes at a time), so a
    table is at most half full and every probe ends."""
    return 1 << max(2, (2 * rows - 1).bit_length())


def _launch(c_keys, c_valid, k_keys, k_valid, payloads, div, counts,
            back=None):
    """One launch of the hash join into fresh payload outputs (`back`, if
    given, gets for each cache row the current row it went to, or -1)."""
    n_c, n_k = c_valid.shape[0], k_valid.shape[0]
    dev = c_valid.device
    slots_c, slots_k = _table_slots(n_c), _table_slots(n_k)
    table = torch.empty(slots_c + slots_k + 2, dtype=torch.int32, device=dev)
    outs = [torch.empty((n_k,) + tuple(p.shape[1:]), dtype=p.dtype,
                        device=dev) for p in payloads]
    args = []
    for j in range(2):
        if j < len(outs):
            args += [_build.ptr(payloads[j]), _build.ptr(outs[j]),
                     math.prod(payloads[j].shape[1:])]
        else:
            args += [0, 0, 0]
    if n_k:
        lead = ([*map(_build.ptr, c_keys), _build.ptr(c_valid), n_c,
                 *map(_build.ptr, k_keys), _build.ptr(k_valid), n_k, div]
                if len(c_keys) == 3 else
                [_build.ptr(c_keys[0]), _build.ptr(c_valid), n_c,
                 _build.ptr(k_keys[0]), _build.ptr(k_valid), n_k])
        _build.library().call(
            "nudge_join3" if len(c_keys) == 3 else "nudge_join1", *lead,
            _build.ptr(table), slots_c, slots_k, *args,
            0 if back is None else _build.ptr(back),
            0 if counts is None else _build.ptr(counts),
            _build.stream_of(c_valid))
        hash_join.launches += 1
    else:
        if counts is not None:
            counts.zero_()
        if back is not None:
            back.fill_(-1)
    return outs


class _JoinFn(torch.autograd.Function):
    """The hash join as one autograd node: the forward launches the kernel,
    which also writes, for each cache row, the current row it went to; the
    backward gathers each cache row's output adjoint through that map (a
    cache row goes to one current row at most, so no sum arises), and
    adds it to 0.0 as the twins' scatter-add into zeros does."""

    @staticmethod
    def forward(ctx, join, div, counts, *payloads):
        back = torch.empty(payloads[0].shape[0], dtype=torch.int32,
                           device=payloads[0].device)
        outs = _launch(*join, payloads, div, counts, back)
        ctx.save_for_backward(back)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        (back,) = ctx.saved_tensors
        hit = back >= 0
        rows = torch.clamp_min(back, 0)
        return (None, None, None,
                *(torch.where(hit.reshape((-1,) + (1,) * (g.ndim - 1)),
                              g.index_select(0, rows) + 0.0, 0.0)
                  for g in grads))


def hash_join(c_keys, c_valid, k_keys, k_valid, payloads, div: int = 1,
              counts=None):
    """The CUDA hash join: each payload (a tensor [n_cache, ...] of 32-bit
    words) gathered for every current row, zeros where it matches no cache
    row. `c_keys` and `k_keys` are (ga, gb, feat) or (key,); with `div` the
    current ga and gb hold one entry per `div` rows. `counts` (i32[2] or
    None) gets the probe launch's hits and cache-table slots read. Where a
    payload requires grad, one `_JoinFn` node."""
    n_c, n_k = c_valid.shape[0], k_valid.shape[0]
    i32 = torch.int32
    for side, keys, valid, n in (("cache", c_keys, c_valid, n_c),
                                 ("current", k_keys, k_valid, n_k)):
        _build.check_cuda("join", f"{side} valid", valid, torch.bool, (n,))
        for j, k in enumerate(keys):
            rows = n // div if side == "current" and j < 2 and len(keys) == 3 \
                else n
            _build.check_cuda("join", f"{side} key {j}", k, i32, (rows,))
    if not 1 <= len(payloads) <= 2:
        raise ValueError("join kernel: one or two payloads")
    for p in payloads:
        if p.element_size() != 4 or p.shape[0] != n_c:
            raise ValueError("join kernel: a payload must have 32-bit words "
                             f"and {n_c} rows, got {p.dtype} {tuple(p.shape)}")
        _build.check_cuda("join", "payload", p, p.dtype, p.shape)
    if counts is not None:
        _build.check_cuda("join", "counts", counts, i32, (2,))
    join = (c_keys, c_valid, k_keys, k_valid)
    if torch.is_grad_enabled() and any(p.requires_grad for p in payloads):
        return list(_JoinFn.apply(join, div, counts, *payloads))
    return _launch(*join, payloads, div, counts)


control.counter(hash_join)


def _join(c_ga, c_gb, c_feat, c_imp, c_valid, k_ga, k_gb, k_feat, k_valid):
    """f32[K,W] payloads for the current keys (zeros on miss): the payload
    of the last valid cache row with the same key, for the first valid
    current row with that key. CPU tensors go to the twin, CUDA tensors to
    the kernel."""
    dev = c_ga.device
    if dev.type == "cpu":
        return _join_plain(c_ga, c_gb, c_feat, c_imp, c_valid, k_ga, k_gb,
                           k_feat, k_valid)
    if dev.type == "cuda":
        return hash_join((c_ga, c_gb, c_feat), c_valid, (k_ga, k_gb, k_feat),
                         k_valid, [c_imp])[0]
    raise NotImplementedError(f"join: no kernel for device {dev}")


def join_i32(c_key, c_payload, c_valid, k_key, k_valid):
    """Single-i32-key join: the i32 payload of the valid cache row with the
    same key for each valid current key (0 on miss), as `_join` picks it.
    Keys < 2^30."""
    dev = c_key.device
    if dev.type == "cpu":
        return join_i32_plain(c_key, c_payload, c_valid, k_key, k_valid)
    if dev.type == "cuda":
        return hash_join((c_key,), c_valid, (k_key,), k_valid, [c_payload])[0]
    raise NotImplementedError(f"join: no kernel for device {dev}")


def read_cached_impulses(cache: ContactCache, man: Manifolds, cfg=None):
    """Warm-start payload for every manifold point: (impulse f32[M,P,3],
    pseudo f32[M,P])."""
    m, p = man.feat.shape
    if man.feat.is_cuda:
        counts = (torch.empty(2, dtype=torch.int32, device=man.feat.device)
                  if trace.enabled() else None)
        imp, pse = hash_join((cache.ga, cache.gb, cache.feat), cache.valid,
                             (man.ga, man.gb, man.feat.reshape(-1)),
                             man.point_valid.reshape(-1),
                             [cache.impulse, cache.pseudo], div=p,
                             counts=counts)
        if counts is not None:
            trace.count(cache_hits=counts[0], cache_probes=counts[1])
        return imp.reshape(m, p, 3), pse.reshape(m, p)
    ga_flat = man.ga[:, None].expand(m, p).reshape(-1)
    gb_flat = man.gb[:, None].expand(m, p).reshape(-1)
    payload = torch.cat([cache.impulse, cache.pseudo[:, None]], -1)
    out = _join(cache.ga, cache.gb, cache.feat, payload, cache.valid,
                ga_flat, gb_flat, man.feat.reshape(-1),
                man.point_valid.reshape(-1))
    return (out[:, 0:3].reshape(m, p, 3).contiguous(),
            out[:, 3].reshape(m, p).contiguous())


def write_cached_impulses(man: Manifolds, impulse_world: torch.Tensor,
                          pseudo_acc=None) -> ContactCache:
    """New cache = this frame's contact points with their accumulated world
    impulses f32[M,P,3] and pseudo normal impulses f32[M,P]."""
    m, p = man.feat.shape
    valid = man.point_valid.reshape(-1)
    ga_flat = man.ga[:, None].expand(m, p).reshape(-1)
    gb_flat = man.gb[:, None].expand(m, p).reshape(-1)
    if pseudo_acc is None:
        pseudo_acc = torch.zeros((m, p), dtype=torch.float32,
                                 device=valid.device)
    return ContactCache(
        ga=torch.where(valid, ga_flat, 0),
        gb=torch.where(valid, gb_flat, 0),
        feat=torch.where(valid, man.feat.reshape(-1), 0),
        impulse=torch.where(valid[:, None], impulse_world.reshape(-1, 3), 0.0),
        pseudo=torch.where(valid, pseudo_acc.reshape(-1), 0.0),
        valid=valid,
    )
