"""The port's demo (`nudge_tpu_torch.examples.demo`, the port of
examples/demo.py) on the CPU: a run without rendering and a rendered run
of two frames. The gradient examples run on the card (chip_smoke.py phase
18)."""

import numpy as np

from nudge_tpu_torch.examples import demo


def test_demo_runs_without_rendering():
    out = demo.main(["--device", "cpu", "--no-render", "--bodies", "16",
                     "--steps", "20"])
    assert out["steps"] == 20 and out["written"] == []
    assert np.isfinite(out["pos"]).all()
    f = out["final"]
    assert f["contacts"] > 0 and not f["overflow"]
    assert np.isfinite(f["ke"]) and 0.0 <= f["max_depth"] < 0.1


def test_demo_renders_frames(tmp_path):
    out = demo.main(["--device", "cpu", "--bodies", "16", "--steps", "4",
                     "--frame-every", "2", "--out", str(tmp_path)])
    pngs = sorted(p.name for p in tmp_path.glob("frame_*.png"))
    assert pngs == ["frame_0000.png", "frame_0001.png"]
    assert all((tmp_path / p).stat().st_size > 0 for p in pngs)
    assert len(out["written"]) >= 2
