"""Ingest-tier transcode CLI: corpus videos → MJPEG-AVI (decodable by
native/videodec.cpp with no codec library), the DCT pass on `--device`.

Port of scripts/ingest_transcode.py over the port's `data/ingest.py`:

    python -m affectgpt_tpu_torch.scripts.ingest_transcode \
        --src /data/mer2023/video --dst /data/mer2023/video_mjpeg [--quality 90]
    python -m affectgpt_tpu_torch.scripts.ingest_transcode --src clip.mp4 --dst clip.avi
"""

from __future__ import annotations

import argparse
import os

from affectgpt_tpu_torch.data.ingest import transcode_tree, transcode_video


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="video → MJPEG-AVI ingest transcode")
    parser.add_argument("--src", required=True, help="video file or corpus root")
    parser.add_argument("--dst", required=True, help="output file or root")
    parser.add_argument("--quality", type=int, default=90)
    parser.add_argument("--device", default="cuda", help="the DCT pass's device (cuda or cpu)")
    args = parser.parse_args(argv)
    if os.path.isdir(args.src):
        n = transcode_tree(args.src, args.dst, quality=args.quality, device=args.device)
        print(f"transcoded {n} clips → {args.dst}")
    else:
        n = transcode_video(args.src, args.dst, quality=args.quality, device=args.device)
        print(f"transcoded {n} frames → {args.dst}")


if __name__ == "__main__":
    main()
