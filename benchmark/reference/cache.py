"""Warm-start impulse cache of the reference step: a sort-merge join on the
contact keys (gid_a, gid_b, feature). A frozen copy of the port's plain
code."""

from __future__ import annotations

import torch

from .tree import Rec

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


def _join(c_ga, c_gb, c_feat, c_imp, c_valid, k_ga, k_gb, k_feat, k_valid):
    """f32[K,W] payloads for the current keys (zeros on miss). Valid
    current keys must be unique."""
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


def join_i32(c_key, c_payload, c_valid, k_key, k_valid):
    """Single-i32-key join: the i32 payload of the valid cache row with the
    same key for each valid current key (0 on miss). Keys < 2^30."""
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


def read_cached_impulses(cache, man):
    """Warm-start payload for every manifold point: (impulse f32[M,P,3],
    pseudo f32[M,P])."""
    m, p = man.feat.shape
    ga_flat = man.ga[:, None].expand(m, p).reshape(-1)
    gb_flat = man.gb[:, None].expand(m, p).reshape(-1)
    payload = torch.cat([cache.impulse, cache.pseudo[:, None]], -1)
    out = _join(cache.ga, cache.gb, cache.feat, payload, cache.valid,
                ga_flat, gb_flat, man.feat.reshape(-1),
                man.point_valid.reshape(-1))
    return (out[:, 0:3].reshape(m, p, 3).contiguous(),
            out[:, 3].reshape(m, p).contiguous())


def write_cached_impulses(man, impulse_world: torch.Tensor, pseudo_acc):
    """New cache = this frame's contact points with their accumulated world
    impulses f32[M,P,3] and pseudo normal impulses f32[M,P]."""
    m, p = man.feat.shape
    valid = man.point_valid.reshape(-1)
    ga_flat = man.ga[:, None].expand(m, p).reshape(-1)
    gb_flat = man.gb[:, None].expand(m, p).reshape(-1)
    return Rec(
        ga=torch.where(valid, ga_flat, 0),
        gb=torch.where(valid, gb_flat, 0),
        feat=torch.where(valid, man.feat.reshape(-1), 0),
        impulse=torch.where(valid[:, None], impulse_world.reshape(-1, 3), 0.0),
        pseudo=torch.where(valid, pseudo_acc.reshape(-1), 0.0),
        valid=valid,
    )
