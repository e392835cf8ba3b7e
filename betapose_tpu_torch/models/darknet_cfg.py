"""Darknet .cfg parsing and generation.

The .cfg INI-block format is the config contract shared with stock darknet
tooling (reference: `yolo/darknet.py:45-74` reads it for inference,
`train_YOLO/src/parser.c:699` for training).  `parse_cfg` accepts a path or a
string; `make_yolov3_cfg` programmatically emits a LineMod-style YOLOv3
network description (Darknet-53 backbone + 3 detection heads), so the
framework does not depend on any vendored cfg file.

A copy of the JAX package's `models/darknet_cfg.py` (the port imports
nothing of that package); the char-RNN cfg generator waits for the darknet
tools slice (ROADMAP slice 7).
"""

from __future__ import annotations

import os


def parse_cfg(cfg) -> list[dict]:
    """Parse a darknet cfg (path or literal text) into a list of block dicts;
    each dict has a 'type' key plus the block's key=value options."""
    if os.path.exists(cfg) if len(cfg) < 4096 and "\n" not in cfg else False:
        with open(cfg) as f:
            text = f.read()
    else:
        text = cfg
    lines = [ln.strip() for ln in text.split("\n")]
    lines = [ln for ln in lines if ln and not ln.startswith(("#", ";"))]

    blocks: list[dict] = []
    block: dict = {}
    for line in lines:
        if line.startswith("["):
            if block:
                blocks.append(block)
                block = {}
            block["type"] = line[1:-1].strip()
        else:
            key, value = line.split("=", 1)
            key = key.strip()
            if key == "type" and "type" in block:
                # [cost] blocks carry a `type=sse` option that must not
                # clobber the block's own type tag
                key = "type_option"
            block[key] = value.strip()
    if block:
        blocks.append(block)
    return blocks


# ---------------------------------------------------------------------------
# Programmatic YOLOv3 cfg generation
# ---------------------------------------------------------------------------

_DARKNET53_PLAN = [
    # (filters, repeats) residual stages of darknet-53
    (64, 1), (128, 2), (256, 8), (512, 8), (1024, 4),
]

YOLOV3_ANCHORS = [(10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                  (59, 119), (116, 90), (156, 198), (373, 326)]


def _conv(lines, filters, size, stride, bn=True, activation="leaky"):
    lines.append("[convolutional]")
    if bn:
        lines.append("batch_normalize=1")
    lines.append(f"filters={filters}")
    lines.append(f"size={size}")
    lines.append(f"stride={stride}")
    lines.append("pad=1")
    lines.append(f"activation={activation}")
    lines.append("")


def make_yolov3_cfg(num_classes: int = 1, width: int = 416, height: int = 416,
                    batch: int = 64, subdivisions: int = 16,
                    max_batches: int = 6100, anchors=None) -> str:
    """Emit a YOLOv3 cfg equivalent in architecture to the reference's
    `yolo-linemod-single.cfg` (75 conv layers, 3 heads, 9 anchors), with
    `classes` and head `filters=(classes+5)*3` derived from num_classes."""
    anchors = anchors or YOLOV3_ANCHORS
    head_filters = (num_classes + 5) * 3
    anchor_str = ",  ".join(f"{a},{b}" for a, b in anchors)

    L: list[str] = []
    L += [
        "[net]",
        f"batch={batch}",
        f"subdivisions={subdivisions}",
        f"width={width}",
        f"height={height}",
        "channels=3",
        "momentum=0.9",
        "decay=0.0005",
        "angle=0",
        "saturation=1.5",
        "exposure=1.5",
        "hue=.1",
        "learning_rate=0.001",
        "burn_in=1000",
        f"max_batches={max_batches}",
        "policy=steps",
        f"steps={max_batches // 2},{max_batches * 5 // 6}",
        "scales=.1,.1",
        "",
    ]
    # Backbone: darknet-53
    _conv(L, 32, 3, 1)
    in_filters = 32
    for stage_filters, repeats in _DARKNET53_PLAN:
        _conv(L, stage_filters, 3, 2)  # downsample
        for _ in range(repeats):
            _conv(L, stage_filters // 2, 1, 1)
            _conv(L, stage_filters, 3, 1)
            L += ["[shortcut]", "from=-3", "activation=linear", ""]
        in_filters = stage_filters

    def head(scale_filters, mask):
        for _ in range(3):
            _conv(L, scale_filters // 2, 1, 1)
            _conv(L, scale_filters, 3, 1)
        _conv(L, head_filters, 1, 1, bn=False, activation="linear")
        L.extend([
            "[yolo]",
            f"mask = {','.join(str(m) for m in mask)}",
            f"anchors = {anchor_str}",
            f"classes={num_classes}",
            "num=9",
            "jitter=.3",
            "ignore_thresh = .7",
            "truth_thresh = 1",
            "random=1",
            "",
        ])

    # Large-object head (stride 32)
    head(1024, [6, 7, 8])
    # Medium head: route back, upsample, concat with stage-4 output
    L += ["[route]", "layers = -4", "", ]
    _conv(L, 256, 1, 1)
    L += ["[upsample]", "stride=2", ""]
    L += ["[route]", "layers = -1, 61", ""]
    head(512, [3, 4, 5])
    # Small head: stride 8
    L += ["[route]", "layers = -4", ""]
    _conv(L, 128, 1, 1)
    L += ["[upsample]", "stride=2", ""]
    L += ["[route]", "layers = -1, 36", ""]
    head(256, [0, 1, 2])

    return "\n".join(L)
