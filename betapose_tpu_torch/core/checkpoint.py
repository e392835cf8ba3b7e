"""Checkpoint paths and the KPD checkpoint loader.

- YOLO: darknet `.weights`, read by `models/yolov3.load_darknet_weights`.
- KPD: the reference stores torch `state_dict` pickles
  (`train_KPD/src/train.py:192-197`); the port's FastPose and PyraNet keep
  the reference module names, so a `.pkl`/`.pth` loads natively.  The JAX
  package saves its own KPD checkpoints as `.npz` files of its param tree
  (`core/checkpoint.save_pytree_npz` there: one array per leaf, keyed by
  `jax.tree_util.keystr` of its path).  The port reads those with numpy,
  rebuilds the tree, and converts it with the networks' bridges
  (`kpd.state_dict_from_jax`, `hgprm.state_dict_from_jax`).  The port
  writes its own in the same layout (`save_kpd_npz`), so the JAX
  package's `load_kpd_checkpoint` reads a network the port trained.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from betapose_tpu_torch.models import hgprm as hgprm_mod
from betapose_tpu_torch.models import kpd as kpd_mod

# one step of a keystr path: ['name'] (a dict key) or [3] (a list index)
_KEY_STEP = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


class _Node(dict):
    """A dict of the rebuilt tree whose missing keys raise with their
    keystr path, as the JAX `load_pytree_npz` names a missing leaf."""

    def __init__(self, path=""):
        super().__init__()
        self.path = path

    def __missing__(self, key):
        raise KeyError(f"checkpoint missing {self.path}{[key]!r}")


def _parse_keystr(key):
    steps, pos = [], 0
    for m in _KEY_STEP.finditer(key):
        if m.start() != pos:
            break
        steps.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not steps:
        raise ValueError(f"not a pytree keystr path: {key!r}")
    return steps


def _lists(node):
    """Turn the dicts whose keys are all list indices into lists; a gap in
    the indices raises with the missing path."""
    for k, v in node.items():
        if isinstance(v, _Node):
            node[k] = _lists(v)
    if node and all(isinstance(k, int) for k in node):
        for i in range(len(node)):
            node[i]                                 # raises on a gap
        return [node[i] for i in range(len(node))]
    return node


def load_pytree_npz(path):
    """The nested dict/list tree of a JAX `save_pytree_npz` file, its
    leaves float32 numpy arrays.  The tree's `Static` nodes (no leaves) are
    not in the file; reading a key the file lacks raises KeyError naming
    its path."""
    root = _Node()
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = _parse_keystr(key)
            node = root
            for step in parents:
                if step not in node:
                    node[step] = _Node(f"{node.path}{[step]!r}")
                node = node[step]
            node[leaf] = np.asarray(data[key], np.float32)
    return _lists(root)


def _flatten(tree, path=""):
    """(keystr path, array) of every leaf of a nested dict/list tree: a
    dict key is written ['name'], a list index [3], as
    `jax.tree_util.keystr` writes them."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield path, np.asarray(tree)
        return
    for k, v in items:
        yield from _flatten(v, f"{path}[{k!r}]")


def save_pytree_npz(path, tree):
    """One array per leaf of the nested dict/list `tree`, keyed by its
    keystr path: the layout of the JAX package's `save_pytree_npz`."""
    np.savez(path, **dict(_flatten(tree)))


def save_kpd_npz(path, model):
    """A FastPose or PyraNet as the JAX package's `.npz` param tree, which
    its `load_kpd_checkpoint` and the port's read back."""
    sd = model.state_dict()
    if isinstance(model, hgprm_mod.PyraNet):
        tree = hgprm_mod.params_from_state_dict(
            sd, model.n_stack, model.n_residual, model.cardinality)
    else:
        tree = kpd_mod.params_from_state_dict(sd)
    save_pytree_npz(path, tree)


def _strip_prefixes(state_dict):
    """'module.' or 'model.' prefixes (DataParallel checkpoints) removed."""
    sd = {}
    for k, v in state_dict.items():
        for pref in ("module.", "model."):
            if k.startswith(pref):
                k = k[len(pref):]
        sd[k] = v
    return sd


def load_kpd_checkpoint(path, n_classes: int = 50, arch: str = "resnet101",
                        **net_kwargs):
    """A pose network from a checkpoint: a torch `.pkl`/`.pth` state_dict
    (optionally wrapped as {"state_dict": ...}; loaded with
    `weights_only=True`, tensors and containers only) or a JAX `.npz`
    param tree.

    arch: FastPose 'resnet50'/'resnet101', or 'hgPRM' (PyraNet), whose
    net_kwargs (n_feats, n_stack, n_residual, base_width, cardinality) size
    the network and must match the checkpoint's training."""
    ext = os.path.splitext(path)[1]
    if ext == ".npz":
        tree = load_pytree_npz(path)
        sd = (hgprm_mod if arch == "hgPRM" else kpd_mod).state_dict_from_jax(
            tree)
    elif ext in (".pkl", ".pth"):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        sd = _strip_prefixes(obj)
    else:
        raise ValueError(f"KPD checkpoint {path}: the port reads torch "
                         ".pkl/.pth state_dicts and JAX .npz param trees")
    model = (hgprm_mod.PyraNet(n_classes, **net_kwargs) if arch == "hgPRM"
             else kpd_mod.FastPose(n_classes, arch))
    model.load_state_dict(sd)
    return model


# Per-object KPD checkpoint names (reference
# KPD/src/main_fast_inference.py:29-36 hardcodes these .pkl names).
KPD_MODEL_NAMES = {
    1: "seq1_model", 2: "seq2_model", 4: "seq4_model", 5: "seq5_model",
    6: "seq6_model", 8: "seq8_model", 9: "seq9_model", 10: "seq10_model",
    11: "seq11_model", 12: "seq12_model", 13: "seq13_model",
    14: "seq14_model", 15: "seq15_model",
}


def default_kpd_path(obj_id: int, base: str = "./exp/final_model"):
    name = KPD_MODEL_NAMES.get(obj_id, f"seq{obj_id}_model")
    for ext in (".pkl", ".pth", ".npz"):
        p = os.path.join(base, name + ext)
        if os.path.exists(p):
            return p
    return os.path.join(base, name + ".pkl")


def default_yolo_path(obj_id: int, base: str = "models/yolo"):
    """Reference DetectionLoader weight path (`dataloader.py:289`)."""
    return os.path.join(base, "{:02d}.weights".format(obj_id))
