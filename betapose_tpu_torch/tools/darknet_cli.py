"""darknet-compatible detector CLI, the part the port runs: training.

Counterpart of `betapose_tpu/tools/darknet_cli.py` (the vendored
darknet's `darknet.c:351` main -> `detector.c:1225` run_detector):

  python -m betapose_tpu_torch.tools.darknet_cli detector train <data> <cfg>
      [weights] [-clear] [-gpus 0] [-resize_buckets 3]
      [-precision bfloat16|tensorfloat32|float32] [-device cuda|cpu]

.data files are darknet's key=value format (`option_list.c
read_data_cfg`): classes/train/valid/names/backup.  .cfg files are stock
darknet network descriptions; .weights files are byte-compatible with
darknet's and the JAX package's (`models/yolov3.py`).  `-device` is the
port's own flag: CUDA unless it says cpu.  `-gpus` other than one device
raises (data parallelism is ROADMAP slice 6).  Every other verb of the
JAX CLI raises: they are not ported yet (ROADMAP slice 7).
"""

from __future__ import annotations

import sys

# boolean flags take no value (darknet find_arg vs find_char_arg, utils.c)
BOOL_FLAGS = {"clear", "dont_show", "show", "tokenized"}


def read_data_cfg(path):
    """key=value parser (option_list.c:read_data_cfg)."""
    opts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                opts[k.strip()] = v.strip()
    return opts


class CliError(int):
    """Error exit status distinguishable from data returns that happen to
    equal 1: the __main__ shim maps only CliError to a nonzero exit."""


def parse_flags(rest):
    """(positionals, {flag: value}) in darknet's flag syntax: '-name
    value', or '-name' alone for a boolean flag or at the end."""
    pos, flags = [], {}
    i = 0
    while i < len(rest):
        if rest[i].startswith("-"):
            name = rest[i].lstrip("-")
            if name in BOOL_FLAGS or i + 1 >= len(rest):
                flags[name] = ""
                i += 1
            else:
                flags[name] = rest[i + 1]
                i += 2
        else:
            pos.append(rest[i])
            i += 1
    return pos, flags


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else CliError(1)
    if argv[:2] != ["detector", "train"]:
        raise NotImplementedError(
            f"darknet_cli {' '.join(argv[:2])}: not ported yet (ROADMAP "
            "slice 7); the port runs `detector train`")
    pos, flags = parse_flags(argv[2:])
    if len(pos) < 2:
        print(__doc__)
        return CliError(1)
    from betapose_tpu_torch.train.train_yolo_main import train_from_data_cfg
    return train_from_data_cfg(
        pos[0], pos[1], pos[2] if len(pos) > 2 else None,
        clear="clear" in flags,
        n_devices=len(flags.get("gpus", "0").split(",")),
        # the static analog of darknet's per-10-iteration random resize
        resize_buckets=int(flags.get("resize_buckets", 3)),
        precision=flags.get("precision"),
        device=flags.get("device") or None)


if __name__ == "__main__":
    out = main()
    raise SystemExit(1 if isinstance(out, CliError) else 0)
