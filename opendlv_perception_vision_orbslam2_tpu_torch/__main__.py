"""CLI entry point: flag-compatible with the reference microservice.

Parity with main() (reference: src/opendlv-perception-vision-orbslam2.cpp:32-129):
required flags ``--name --cid --width --height --bpp``; ``--kittiPath``
selects dataset mode; otherwise frames come from the shared-memory ingest
loop fed by a camera proxy.  All ``--Camera.*`` / ``--ORBextractor.*`` /
``--BoundingBox.*`` flags accept the reference's exact syntax (see
utils/config.py), so the docker-compose command line ports unchanged.

    python -m opendlv_perception_vision_orbslam2_tpu_torch --kittiPath=DIR ...

runs on the CUDA device; from Python, ``main(argv, device="cpu")`` runs on
the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .utils.config import config_from_flags, parse_flags

USAGE = """\
opendlv-perception-vision-orbslam2-tpu-torch: stereo/mono SLAM on a CUDA device.
Required: --cid=<conference> --name=<shm name> --width=<px> --height=<px> --bpp=<bits>
Dataset mode: --kittiPath=<dir with times.txt + image_0/ + image_1/>
Optional: --cameraType=stereo|mono|rgbd --vocFilePath=<ORBvoc.txt>
          --Camera.fx/.fy/.cx/.cy/.fps/.bf  --ThDepth  --ORBextractor.*
          --refLatitude/--refLongitude/--startHeading  --verbose
"""


def _upload(img: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host frame on ``device``; bound for the card through pinned memory
    and an asynchronous copy (a copy from pageable memory waits)."""
    t = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def live_loop(pipeline, frames, raw_width: int, rect_maps=None, resize_to=None) -> None:
    """Track each side-by-side gray frame of ``frames`` (an iterable of
    ``(frame [H, W], timestamp)``), split at the RAW width even when
    rectification rescaled the SLAM-facing config (nextContainer, reference:
    src/selflocalization.cpp:267-299); each half is remapped by
    ``rect_maps`` (on the engine's device) or resized to ``resize_to``
    there, then the pipeline shuts down."""
    device = pipeline.slam.device
    for img, ts in frames:
        if rect_maps is None and resize_to is None:
            left, right = img[:, : raw_width // 2], img[:, raw_width // 2 :]
        else:
            both = _upload(img, device)
            left, right = both[:, : raw_width // 2], both[:, raw_width // 2 :]
        if rect_maps is not None:
            from .ops.undistort import remap_bilinear

            left = remap_bilinear(left, rect_maps[0])
            right = remap_bilinear(right, rect_maps[1])
        elif resize_to is not None:
            from .ops.resample import resize_bilinear

            left = resize_bilinear(left, resize_to)
            right = resize_bilinear(right, resize_to)
        pipeline.track(left, right, ts)
    pipeline.shutdown()


def main(argv=None, device="cuda", frames=None) -> int:
    """Run the service.  ``frames`` is the live mode's frame source (an
    iterable of ``(gray frame [H, W], timestamp)``); None reads the camera
    proxy's shared memory (``shared_memory_frames``)."""
    argv = sys.argv[1:] if argv is None else argv
    flags = parse_flags(argv)
    required = ("cid", "name", "width", "height", "bpp")
    if "kittiPath" not in flags and not all(k in flags for k in required):
        print(USAGE, file=sys.stderr)
        return 1

    config = config_from_flags(flags)
    raw_config = config   # pre-rectification dims for the SHM layout

    # Live stereo ingest may need resize + undistort-rectify before the
    # SLAM core (setUpRealtime, reference: src/selflocalization.cpp:380-531:
    # stereoRectify + initUndistortRectifyMap once, then per-frame remap at
    # :267-299; the rectified P1 intrinsics replace the raw ones :497-501).
    rect_maps = None
    if (not config.rectify) and 0 < config.resize < 1 and not config.kitti_path:
        # resize-only ingest: scale intrinsics + frame dims like the
        # reference's resizeScale pre-multiplication (reference:
        # src/selflocalization.cpp:438-472)
        import dataclasses

        sc = config.resize
        cam = config.camera
        config = dataclasses.replace(
            config,
            camera=dataclasses.replace(
                cam, fx=cam.fx * sc, fy=cam.fy * sc, cx=cam.cx * sc,
                cy=cam.cy * sc, bf=cam.bf * sc,
                width=int((config.width // 2) * sc),
                height=int(config.height * sc),
            ),
        )
    if config.rectify and not config.kitti_path:
        import dataclasses

        from .ops import undistort as und

        scale = config.resize if config.resize > 0 else 1.0
        camL, camR = config.camera, config.camera_right
        h = int(config.height * scale)
        w = int((config.width // 2) * scale)
        # the maps are built once, in float32 on the host, and moved to the
        # engine's device with it
        R = und.rodrigues(torch.tensor([camL.rx, camL.cv_rot, camL.rz], dtype=torch.float32))
        T = torch.tensor([-camL.baseline, 0.0, 0.0], dtype=torch.float32)
        sl = lambda v: v * scale  # noqa: E731
        R1, R2, (fxn, fyn, cxn, cyn), baseline = und.stereo_rectify(
            R, T, sl(camL.fx), sl(camL.fy), sl(camL.cx), sl(camL.cy),
            sl(camR.fx), sl(camR.fy), sl(camR.cx), sl(camR.cy),
        )
        grid_l = und.build_rectify_map(
            h, w, sl(camL.fx), sl(camL.fy), sl(camL.cx), sl(camL.cy),
            camL.k1, camL.k2, camL.p1, camL.p2, camL.k3,
            R1, fxn, fyn, cxn, cyn,
        )
        grid_r = und.build_rectify_map(
            h, w, sl(camR.fx), sl(camR.fy), sl(camR.cx), sl(camR.cy),
            camR.k1, camR.k2, camR.p1, camR.p2, camR.k3,
            R2, fxn, fyn, cxn, cyn,
        )
        rect_maps = (grid_l, grid_r)
        config = dataclasses.replace(
            config,
            camera=dataclasses.replace(
                camL, fx=float(fxn), fy=float(fyn), cx=float(cxn),
                cy=float(cyn), k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0,
                bf=float(fxn * baseline), width=w, height=h,
            ),
        )

    vocab = None
    if config.voc_file_path:
        from .models.vocabulary import load_text_vocabulary

        vocab = load_text_vocabulary(config.voc_file_path)

    from .io.od4 import NullSession, OD4Session
    from .models.selflocalization import Selflocalization

    od4 = NullSession()
    if "cid" in flags:
        try:
            od4 = OD4Session(config.cid, sender_stamp=config.id)
        except OSError as exc:
            print(f"OD4 unavailable ({exc}); publishing disabled", file=sys.stderr)

    pipeline = Selflocalization(config, od4=od4, vocab=vocab, device=device)
    if rect_maps is not None:
        rect_maps = tuple(g.to(pipeline.slam.device) for g in rect_maps)

    if config.kitti_path:
        from .io.kitti import KittiRunner

        runner = KittiRunner(
            config.kitti_path, pipeline, real_time=False, publisher=od4
        )
        runner.run()
        stats = runner.shutdown_stats()
        print(
            f"median tracking time: {stats['median_s']*1e3:.1f} ms, "
            f"mean: {stats['mean_s']*1e3:.1f} ms ({stats['fps']:.1f} fps)"
        )
        pipeline.shutdown(config.kitti_path)
        return 0

    # live mode: shared-memory ingest (reference: :78-118)
    if frames is None:
        from .io.shared_memory import shared_memory_frames

        frames = shared_memory_frames(raw_config)
    resize_to = None
    if rect_maps is None and 0 < config.resize < 1:
        resize_to = (config.camera.height, config.camera.width)
    live_loop(pipeline, frames, int(flags.get("width", config.width)), rect_maps, resize_to)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
