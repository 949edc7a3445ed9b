"""The `cache_probe_len.p50` reader's arithmetic on synthetic replays:
active steps with live points only, and nothing where the program counts
no probes."""

from types import SimpleNamespace as NS

from harness import registry


def _replay(counts, active=True):
    t = 0 if active else None
    return NS(graph="step", stamps=[("start", 0), ("collide", t)],
              counts=counts, call=1, parent=None)


def test_probes_a_point_over_active_steps_with_points():
    mod = registry.load_module(registry.BENCH_DIR / "metrics",
                               "cache_probe_len.p50")
    rs = [_replay({"points": 100, "cache_probes": 110, "cache_hits": 90}),
          _replay({"points": 0, "cache_probes": 0, "cache_hits": 0}),
          _replay({"points": 50, "cache_probes": None}, active=False),
          _replay({"points": 200, "cache_probes": 230, "cache_hits": 150})]
    assert mod.per_point(rs, "cache_probes") == [1.1, 1.15]
    assert mod.per_point(rs, "cache_hits") == [0.9, 0.75]
    assert mod.per_point([_replay({"points": 100})], "cache_probes") == []
