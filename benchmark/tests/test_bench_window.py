"""The window's arithmetic: whole episodes until the time has passed, the
rate over all the work and all the wall time, the 95th percentile over
every frame."""

import time

import numpy as np
import tiny_bench  # noqa: F401  (puts the harness on the path)

from harness import cell


class Spawn:
    class bodies:
        class pos:
            is_cuda = False


class FakeEntry:
    """Calls of known host times; 10 body-steps a call."""

    calls, body_steps, spawn = 4, 10, Spawn()

    def __init__(self, times):
        self.times, self.k, self.episodes = times, 0, []

    def start_episode(self, ep):
        self.episodes.append(ep)

    def call(self, c):
        time.sleep(self.times[self.k % len(self.times)])
        self.k += 1
        return c == 3

    def end_episode(self):
        pass


def test_window_runs_whole_episodes_past_its_seconds():
    entry = FakeEntry([0.01])
    win = cell.Window().run(entry, 0.1)
    assert win.episodes == len(entry.episodes) >= 3
    assert len(win.call_s) == 4 * win.episodes
    assert win.wall_s >= 0.1
    assert win.failed == win.episodes          # one failed call an episode


def test_rate_is_all_work_over_all_wall_time():
    entry = FakeEntry([0.002, 0.02])
    win = cell.Window().run(entry, 0.05)
    got = cell.end_to_end(win, 3 * 2 ** 30, 1.5)
    assert got["body_steps_per_s"] == 10 * len(win.call_s) / win.wall_s
    assert got["peak_mem_gib"] == 3.0 and got["setup_s"] == 1.5


def test_p95_is_over_every_frame():
    win = cell.Window()
    win.call_s = [0.001] * 95 + [0.050] * 5
    win.wall_s, win.body_steps = 1.0, 100
    got = cell.end_to_end(win, 0, 0.0)
    assert got["frame_ms_p95"] == float(np.percentile(
        np.asarray(win.call_s) * 1e3, 95))
    assert 1.0 < got["frame_ms_p95"] < 50.0
