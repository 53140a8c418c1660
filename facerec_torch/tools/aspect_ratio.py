"""Display-aspect-ratio prober.

Port of ``facerec_tpu/tools/aspect_ratio.py``; it probes through the
port's reader.

Behavioural rebuild of reference aspect_ratio.py: derive DAR from
the container SAR×PAR (the "VLC approach") and print the display
resolution; useful for building ``aspect_ratios.csv`` overrides.
"""
from __future__ import annotations

import argparse

from facerec_torch.video.reader import probe_video


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("files", nargs="+")
    parser.add_argument("--csv", action="store_true",
                        help="emit aspect_ratios.csv rows")
    args = parser.parse_args(argv)

    if args.csv:
        print("filename,display_width,display_height")
    for path in args.files:
        info = probe_video(path)
        if args.csv:
            import os

            print(f"{os.path.basename(path)},{info.display_width},"
                  f"{info.display_height}")
        else:
            dar = info.display_width / info.display_height
            print(f"{path}: display aspect ratio {dar:.2f} "
                  f"(resolution: {info.display_width}×"
                  f"{info.display_height})")


if __name__ == "__main__":
    main()
