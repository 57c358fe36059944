"""What decides ``correct``: a run on the CPU at 320x240 (``tiny.desk``,
TUM1's RGB-D camera at half size on the desk traffic) with the program as
it is, then with the timed path broken underneath, each fault once: a step
that returns its state unchanged, every other frame left out (the pose
before it sent again), the published answer altered where it is produced,
the depth maps read 1.1 times too deep, and a keyframe's BoW row altered
where it is produced.  And the reference's controls, kept beside the runs
of them on the card (PERF.md), at this size."""

import json
import time

import numpy as np
import pytest
import torch

import _tiny
from harness import cell, frames, spec
from reference import poses

from opendlv_perception_vision_orbslam2_tpu_torch.models import selflocalization, slam, vocabulary

WARM = 6        # tiny-rgbd.json's warm-up frames

# a few threads a test, so that tests run side by side each keep a frame
# rate that fills the window
torch.set_num_threads(2)


def _result(capsys, **kw):
    rc = cell.run(_tiny.TINY, 5, 20.0, False, time.perf_counter(), device="cpu",
                  bench=_tiny.bench_with_tiny(), **kw)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _skip_steps(monkeypatch, every: int):
    """From the first frame after the warm-up, every ``every``-th step
    returns the tracker's state unchanged: no tracking, the last pose again."""
    step = slam.StereoSlam._step

    def broken(self, cur):
        if self.frame_idx >= WARM and (self.frame_idx - WARM) % every == 0:
            self.frame_idx += 1
            self._log_pose(self.T_cw)
            return self.T_cw
        return step(self, cur)

    monkeypatch.setattr(slam.StereoSlam, "_step", broken)


def _deep_depth(monkeypatch):
    """Every depth map read 1.1 times too deep: the map and the poses at the
    wrong metric scale, consistent among themselves."""
    process = slam.process_rgbd

    def broken(img, depth_map, config, timestamp=0.0):
        return process(img, depth_map.to(torch.float32) * 1.1, config, timestamp)

    monkeypatch.setattr(slam, "process_rgbd", broken)


def _altered_bow(monkeypatch):
    """Each keyframe's BoW row with its heaviest word taken out, the rest
    normalised again."""
    bow_vector = vocabulary.bow_vector

    def broken(vocab, word_ids):
        v = bow_vector(vocab, word_ids)
        v = v.scatter(-1, v.argmax(dim=-1, keepdim=True), 0.0)
        return v / v.sum(dim=-1, keepdim=True).clamp_min(1e-12)

    monkeypatch.setattr(vocabulary, "bow_vector", broken)


def test_a_sound_run_is_correct(capsys):
    r = _result(capsys)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4, r["checks"]
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    assert set(r["checks"]) >= {"pose_rel_deg_p90", "pose_scale_err", "kf_scale_err", "bow_row_l1"}


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered", "deep_depth",
                                   "altered_bow"])
def test_a_broken_timed_path_is_not_correct(fault, capsys, monkeypatch):
    if fault == "unchanged":
        _skip_steps(monkeypatch, 1)
    elif fault == "half_left_out":
        _skip_steps(monkeypatch, 2)
    elif fault == "deep_depth":
        _deep_depth(monkeypatch)
    elif fault == "altered_bow":
        _altered_bow(monkeypatch)
    else:
        geo = selflocalization.pose_to_geolocation

        def altered(T, *ref):
            # the published pose turned 2 degrees about the vertical
            T = np.array(T, np.float64)
            a = np.radians(2.0)
            R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
            T[:3, :3] = R @ T[:3, :3]
            return geo(T, *ref)

        monkeypatch.setattr(selflocalization, "pose_to_geolocation", altered)
    r = _result(capsys)
    assert not r["correct"], r["checks"]


def test_the_stale_control_is_not_correct(capsys):
    r = _result(capsys, control="stale")
    assert not r["correct"]
    c = r["checks"]["pose_rel_deg_p90"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("control, number", [("scale", "pose_scale_err"),
                                             ("bf16", "bow_row_l1")])
def test_each_control_is_not_correct(control, number, capsys):
    r = _result(capsys, control=control)
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"]


def test_the_reference_reads_its_own_truth_as_exact():
    bench = _tiny.bench_with_tiny()
    cfg = spec.config(bench, "tiny-rgbd")
    traffic = spec.traffic("road-explore")
    cam = frames.camera_from_flags(cfg["flags"])

    def truth(i):
        return frames.pose(traffic, i, cam.fps)

    from opendlv_perception_vision_orbslam2_tpu_torch.models.selflocalization import (
        pose_to_geolocation,
    )
    ref = (12.5, 57.7, 0.3)
    pub = []
    for i in range(30):
        g = pose_to_geolocation(truth(i), *ref)
        pub.append((i, *poses.geolocation_to_centre(g.latitude, g.longitude, g.altitude,
                                                   g.heading, *ref)))
    anchors = {i: (i - i % 4, truth(i - i % 4)) for i in range(1, 30)}
    n = poses.pose_numbers(pub[1:], anchors, truth)
    assert n["pose_rel_m"] < 1e-6 and n["pose_rel_deg"] < 1e-6
    stale = poses.stale_control(range(1, 30), anchors, truth)
    assert stale["pose_rel_m"] == pytest.approx(1.06, rel=1e-6)
