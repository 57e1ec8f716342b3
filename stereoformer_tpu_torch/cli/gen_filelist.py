"""Filename-list generation: walk the left-image directory in sorted order,
check that each right image (and disparity) exists, and write
``left right [disp]`` lines relative to ``--root``.

Counterpart of ``stereoformer_tpu/cli/gen_filelist.py``; its output is the
same byte for byte. Usage:
  python -m stereoformer_tpu_torch.cli.gen_filelist --root /data/sceneflow \\
      --left-dir frames_finalpass/left --right-dir frames_finalpass/right \\
      --disp-dir disparity/left --out train.list
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser("stereoformer_tpu_torch gen_filelist")
    p.add_argument("--root", required=True)
    p.add_argument("--left-dir", required=True)
    p.add_argument("--right-dir", required=True)
    p.add_argument("--disp-dir", default=None)
    p.add_argument("--disp-ext", default=".pfm")
    p.add_argument("--out", required=True)
    opt = p.parse_args(argv)

    left_root = os.path.join(opt.root, opt.left_dir)
    lines, missing = [], 0
    for dirpath, _, files in sorted(os.walk(left_root)):
        for f in sorted(files):
            lp = os.path.join(dirpath, f)
            rel = os.path.relpath(lp, left_root)
            rp = os.path.join(opt.root, opt.right_dir, rel)
            if not os.path.isfile(rp):
                missing += 1
                continue
            entry = [
                os.path.relpath(lp, opt.root),
                os.path.relpath(rp, opt.root),
            ]
            if opt.disp_dir:
                dp = os.path.join(
                    opt.root, opt.disp_dir,
                    os.path.splitext(rel)[0] + opt.disp_ext,
                )
                if not os.path.isfile(dp):
                    missing += 1
                    continue
                entry.append(os.path.relpath(dp, opt.root))
            lines.append(" ".join(entry))
    with open(opt.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} entries to {opt.out} ({missing} skipped)")


if __name__ == "__main__":
    main()
