"""Greedy Luby manifold coloring, the claim rounds: the CUDA kernel's
wrappers, for the fresh coloring and for the cached one.

Replaces `nudge_tpu/ops/coloring_kernel.py: color_manifolds_pallas`
(kernel body `_color_kernel`). Per round c, every uncolored valid manifold
i claims its dynamic bodies with the token i ^ round_hash(c) (a bijection
of the indices, so tokens stay unique) by a scatter-min; a manifold whose
token holds both claims takes color c. Within a color no dynamic body
repeats. The rounds stop when every valid manifold is colored, or after
max_colors - 1 rounds.

The TPU kernel ran every round in one `pallas_call`, with one-hot matmuls
over membership-bitmask tile windows in place of the scatter-min and the
gather-back. The CUDA kernel (csrc/coloring.cu) runs every round in one
launch of one thread-block cluster: atomicMin claims into a per-body table
in global memory, a cluster barrier, then the win check fused with the
next round's claims. The plain twin `color_rounds_plain` is the
reference's XLA loop, which reads one flag back to the host per round.

The cached coloring (`ops/solver.py: color_manifolds_cached`) starts from
the colors joined from last step's cache (a manifold's cached color, or
-1) and colors the rest in the same rounds, where a manifold claims in
round c only if none of its dynamic bodies holds a cached color c. Its
twin `color_rounds_cached_plain` is the reference's loop: a per-body
forbidden-color table built from the cached colors, `control.bounded_while`
over the K - 1 rounds, each round's winners added to the table. The
kernel's cached instance builds a per-body mask of the cached colors once,
before the rounds, and only reads it after: round c reads column c of the
twin's table before it writes that column, and later rounds read only
higher columns, so the twin's writes change no color. Its loop runs while
any valid manifold is uncolored, eligible for the round or not, as the
twin's does, and it records the rounds it ran: with tracing on, the count
`claim_rounds` (trace.py).

`color_rounds` and `color_rounds_cached` dispatch by device: CPU tensors go
to the twins; CUDA tensors launch the kernel or raise. Both return the raw
colors, i32[M]: the round a manifold won (or its cached color), or -1 for
anything not colored (invalid, or past the last round).
"""

from __future__ import annotations

import torch

from .. import _build, control, trace


INF_I32 = 2 ** 31 - 1


def _wrap32(x: int) -> int:
    return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31


def round_hash(c: int) -> int:
    """The per-round Luby priority constant, in int32 wraparound arithmetic:
    h = (c+1)·0x9E3779B9; h = (h ^ (h >> 13))·0x85EBCA6B; h & 0x3FFFFF."""
    h = _wrap32((c + 1) * _wrap32(0x9E3779B9))
    h = _wrap32((h ^ (h >> 13)) * _wrap32(0x85EBCA6B))
    return h & 0x3FFFFF


def claim_min(n_bodies, body_a, body_b, token_a, token_b):
    """Per-body minimum of the tokens claimed on it (INF_I32 if none)."""
    claim = torch.full((n_bodies,), INF_I32, dtype=torch.int32,
                       device=token_a.device)
    claim.scatter_reduce_(0, body_a.to(torch.int64), token_a, "amin")
    claim.scatter_reduce_(0, body_b.to(torch.int64), token_b, "amin")
    return claim


def color_rounds_plain(body_a, body_b, valid, dyn, n_bodies: int,
                       max_colors: int):
    """The claim rounds as the reference's loop, one host read per round."""
    dyn_a, dyn_b = dyn[body_a], dyn[body_b]
    m = body_a.shape[0]
    idx = torch.arange(m, dtype=torch.int32, device=dyn.device)
    color = torch.full((m,), -1, dtype=torch.int32, device=dyn.device)
    c = 0
    while c < max_colors - 1 and bool(torch.any(valid & (color < 0))):
        token = idx ^ round_hash(c)
        uncolored = valid & (color < 0)
        token_a = torch.where(uncolored & dyn_a, token, INF_I32)
        token_b = torch.where(uncolored & dyn_b, token, INF_I32)
        claim = claim_min(n_bodies, body_a, body_b, token_a, token_b)
        ok_a = ~dyn_a | (claim[body_a] == token)
        ok_b = ~dyn_b | (claim[body_b] == token)
        color = torch.where(uncolored & ok_a & ok_b, c, color)
        c += 1
    return color


_HASHES: dict = {}


def _round_hashes(n: int, device) -> torch.Tensor:
    """round_hash(0..n-1) as an i32 tensor on `device` (computed on the
    host: the hash needs int32 wraparound and an arithmetic shift)."""
    key = (n, str(device))
    if key not in _HASHES:
        _HASHES[key] = torch.tensor([round_hash(c) for c in range(n)],
                                    dtype=torch.int32, device=device)
    return _HASHES[key]


def _checked(body_a, body_b, valid, dyn, n_bodies: int):
    """The kernel's manifold and body inputs, each checked."""
    m = body_a.shape[0]
    ins = dict(body_a=(body_a, torch.int32, (m,)),
               body_b=(body_b, torch.int32, (m,)),
               valid=(valid, torch.bool, (m,)),
               dyn=(dyn, torch.bool, (n_bodies,)))
    for name, (t, dt, shape) in ins.items():
        _build.check_cuda("coloring", name, t, dt, shape)
    return [t for t, _, _ in ins.values()]


def color_rounds_cuda(body_a, body_b, valid, dyn, n_bodies: int,
                      max_colors: int):
    """The claim rounds from the CUDA kernel, all in one launch."""
    m = body_a.shape[0]
    ins = _checked(body_a, body_b, valid, dyn, n_bodies)
    dev = body_a.device
    n_rounds = max(max_colors - 1, 0)
    hashes = _round_hashes(max(n_rounds, 1), dev)
    # the two alternating claim tables of 64-bit keys
    claim = torch.empty((2 * max(n_bodies, 1),), dtype=torch.int64,
                        device=dev)
    color = torch.empty((m,), dtype=torch.int32, device=dev)
    if m:
        _build.library().call(
            "nudge_color_rounds", *[_build.ptr(t) for t in ins],
            _build.ptr(hashes), m, n_bodies, n_rounds, _build.ptr(claim),
            _build.ptr(color), _build.stream_of(body_a))
        color_rounds.launches += 1
    return color


def color_rounds(body_a, body_b, valid, dyn, n_bodies: int, max_colors: int):
    """Raw greedy colors of the manifolds (body_a/body_b i32[M], valid
    bool[M], dyn bool[n_bodies]): the winning round, or -1."""
    dev = body_a.device
    if dev.type == "cpu":
        return color_rounds_plain(body_a, body_b, valid, dyn, n_bodies,
                                  max_colors)
    if dev.type == "cuda":
        return color_rounds_cuda(body_a, body_b, valid, dyn, n_bodies,
                                 max_colors)
    raise NotImplementedError(f"coloring: no kernel for device {dev}")


control.counter(color_rounds)


def color_rounds_cached_plain(body_a, body_b, valid, dyn, color,
                              n_bodies: int, max_colors: int):
    """The cached coloring's claim rounds as the reference's loop, from the
    cached colors `color` (i32[M], -1 where none), with a per-body
    forbidden-color table."""
    K = max_colors
    dev = dyn.device
    m = body_a.shape[0]
    dyn_a, dyn_b = dyn[body_a], dyn[body_b]
    # forbidden-color table [n_bodies, K], flattened for the scatters
    ba, bb = body_a.to(torch.int64), body_b.to(torch.int64)
    forbid = torch.zeros(n_bodies * K, dtype=torch.int32, device=dev)
    cc = torch.clamp(color, 0, K - 1).to(torch.int64)
    okc = color >= 0
    forbid.scatter_reduce_(0, ba * K + cc, (okc & dyn_a).to(torch.int32),
                           "amax")
    forbid.scatter_reduce_(0, bb * K + cc, (okc & dyn_b).to(torch.int32),
                           "amax")

    idx = torch.arange(m, dtype=torch.int32, device=dev)

    def uncolored(c, carry):
        return torch.any(valid & (carry[0] < 0))

    def claim_round(c, carry):
        color, forbid = carry
        token = idx ^ round_hash(c)
        elig = (valid & (color < 0)
                & ((forbid[ba * K + c] == 0) | ~dyn_a)
                & ((forbid[bb * K + c] == 0) | ~dyn_b))
        token_a = torch.where(elig & dyn_a, token, INF_I32)
        token_b = torch.where(elig & dyn_b, token, INF_I32)
        claim = claim_min(n_bodies, body_a, body_b, token_a, token_b)
        ok_a = ~dyn_a | (claim[body_a] == token)
        ok_b = ~dyn_b | (claim[body_b] == token)
        win = elig & ok_a & ok_b
        forbid.scatter_reduce_(0, ba * K + c, (win & dyn_a).to(torch.int32),
                               "amax")
        forbid.scatter_reduce_(0, bb * K + c, (win & dyn_b).to(torch.int32),
                               "amax")
        return torch.where(win, c, color), forbid

    # the reference's lax.while_loop, with its static bound K - 1
    color, _ = control.bounded_while(K - 1, uncolored, claim_round,
                                     (color, forbid))
    return color


def color_rounds_cached_cuda(body_a, body_b, valid, dyn, color,
                             n_bodies: int, max_colors: int):
    """The cached coloring's claim rounds from the CUDA kernel's cached
    instance, all in one launch, written over `color` in place."""
    m = body_a.shape[0]
    i32 = torch.int32
    ins = _checked(body_a, body_b, valid, dyn, n_bodies)
    _build.check_cuda("coloring", "color", color, i32, (m,))
    dev = body_a.device
    n_rounds = max(max_colors - 1, 0)
    words = (max_colors + 31) // 32     # of a body's forbidden-color mask
    hashes = _round_hashes(max(n_rounds, 1), dev)
    nb = max(n_bodies, 1)
    claim = torch.empty((2 * nb,), dtype=torch.int64, device=dev)
    mask = torch.empty((nb * words,), dtype=i32, device=dev)
    rounds = torch.empty((), dtype=i32, device=dev)
    if m:
        _build.library().call(
            "nudge_color_rounds_cached", *[_build.ptr(t) for t in ins],
            _build.ptr(hashes),
            m, n_bodies, n_rounds, words, _build.ptr(claim), _build.ptr(mask),
            _build.ptr(color), _build.ptr(rounds), _build.stream_of(body_a))
        color_rounds_cached.launches += 1
    else:
        rounds.zero_()
    trace.count(claim_rounds=rounds)
    return color


def color_rounds_cached(body_a, body_b, valid, dyn, color, n_bodies: int,
                        max_colors: int):
    """Raw colors of the cached coloring (body_a/body_b i32[M], valid
    bool[M], dyn bool[n_bodies], color i32[M] the cached colors or -1):
    the cached color, the winning round, or -1."""
    dev = body_a.device
    if dev.type == "cpu":
        return color_rounds_cached_plain(body_a, body_b, valid, dyn, color,
                                         n_bodies, max_colors)
    if dev.type == "cuda":
        return color_rounds_cached_cuda(body_a, body_b, valid, dyn, color,
                                        n_bodies, max_colors)
    raise NotImplementedError(f"coloring: no kernel for device {dev}")


control.counter(color_rounds_cached)
