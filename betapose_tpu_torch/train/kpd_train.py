"""KPD training: the masked-MSE heatmap loss, PCK accuracy, optax's
optimizers, and the train, eval and flip-TTA steps.

Counterpart of `betapose_tpu/train/kpd_train.py` (reference
`train_KPD/src/train.py`):
- loss = MSE(out * setMask, labels), mean over every element; summed over
  the heads of a stacked network (hgPRM's intermediate supervision), the
  accuracy taken on the last head;
- with `sym_perms` (keypoint-channel permutations, one per symmetry
  element of the object), the per-sample minimum over the symmetry modes
  of the label, and the accuracy against each sample's chosen mode;
- PCK accuracy with norm outputResH/10 and threshold 0.5;
- batch norm in train mode: FastPose rolls its running statistics with
  momentum 0.1 (`BN_MOMENTUM`, nn.BatchNorm2d's), PyraNet leaves them
  (`models/hgprm.BatchNorm2d`);
- the conv operands in the `--trainPrecision` mode (`models/precision`),
  the rest float32.

Heatmaps here are [B, K, H, W] (the JAX package's are NHWC).  The
optimizers reproduce optax's arithmetic (`Optimizer`), not torch's: optax's
rmsprop puts eps inside the root and applies momentum after the learning
rate, where `torch.optim.RMSprop` divides by sqrt(nu) + eps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from betapose_tpu_torch.models.hgprm import PyraNet
from betapose_tpu_torch.models.precision import conv_precision
from betapose_tpu_torch.parallel import collectives as coll

BN_MOMENTUM = 0.1  # torch BatchNorm2d default
DEFAULT_TRAIN_PRECISION = "bfloat16"
OPT_METHODS = ("rmsprop", "adam", "sgd")


class Optimizer(torch.optim.Optimizer):
    """optax's `rmsprop(lr, decay=0.99, eps=1e-8, momentum)`,
    `adam(lr)` or `sgd(lr, momentum)`, chained after
    `add_decayed_weights(weight_decay)`, as the JAX `make_optimizer` builds
    them, in optax's order of operations:

    - weight decay: g = g + wd * p (batch-norm scales and biases too);
    - rmsprop: nu = (1 - 0.99) * g^2 + 0.99 * nu; u = -lr * g *
      rsqrt(nu + 1e-8); then momentum: t = u + m * t, u = t;
    - adam: mu, nu as rmsprop's with 0.9 and 0.999; u = -lr * mu_hat /
      (sqrt(nu_hat) + 1e-8), mu_hat = mu / (1 - 0.9^n), nu_hat likewise;
    - sgd: t = g + m * t; u = -lr * t;
    - p = p + u.

    Batch-norm running statistics are buffers, which an optimizer never
    sees (the JAX package masks them out)."""

    def __init__(self, params, method: str = "rmsprop", lr: float = 2.5e-4,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        if method not in OPT_METHODS:
            raise ValueError(f"unknown optimizer {method}")
        super().__init__(params, dict(method=method, lr=lr,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            method, lr = group["method"], group["lr"]
            m, wd = group["momentum"], group["weight_decay"]
            bias_fix = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    for slot in (("nu",) if method == "rmsprop" else
                                 ("mu", "nu") if method == "adam" else ()):
                        st[slot] = torch.zeros_like(p)
                    if m and method != "adam":
                        st["trace"] = torch.zeros_like(p)
                st["count"] += 1
                if method == "rmsprop":
                    st["nu"] = (1 - 0.99) * (g * g) + 0.99 * st["nu"]
                    u = -lr * (torch.rsqrt(st["nu"] + 1e-8) * g)
                    if m:
                        st["trace"] = u + m * st["trace"]
                        u = st["trace"]
                elif method == "adam":
                    st["mu"] = (1 - 0.9) * g + 0.9 * st["mu"]
                    st["nu"] = (1 - 0.999) * (g * g) + 0.999 * st["nu"]
                    n = st["count"]
                    if n not in bias_fix:   # 1 - b^n in float32, as optax
                        bias_fix[n] = tuple(
                            float(np.float32(1) - np.float32(b) ** n)
                            for b in (0.9, 0.999))
                    c1, c2 = bias_fix[n]
                    u = -lr * ((st["mu"] / c1)
                               / (torch.sqrt(st["nu"] / c2) + 1e-8))
                else:
                    if m:
                        st["trace"] = g + m * st["trace"]
                        g = st["trace"]
                    u = -lr * g
                p.add_(u)

    def _slots(self):
        """The state slots of each parameter, in the port's layout."""
        g = self.param_groups[0]
        method, m = g["method"], g["momentum"]
        slots = {"rmsprop": ["nu"], "adam": ["mu", "nu"], "sgd": []}[method]
        return ["count"] + slots + (["trace"] if m and method != "adam"
                                    else [])

    def jax_named_state(self, model: nn.Module, to_tree):
        """The state in the JAX trainer's `optimizer.npz` layout, {optax
        key path: array}, which its `load_pytree_npz` reads back for
        --Continue.  `to_tree` maps a `state_dict` of `model` to the JAX
        param tree (`kpd.params_from_state_dict`, or hgPRM's)."""
        g = self.param_groups[0]
        paths = jax_state_paths(g["method"], g["weight_decay"])
        sd = model.state_dict()
        out = {}
        for slot, path in paths.items():
            if slot == "count":
                counts = [st["count"] for st in self.state.values()]
                out[path] = np.asarray(max(counts, default=0), np.int32)
                continue
            slot_sd = {k: torch.zeros_like(v) for k, v in sd.items()}
            for name, p in model.named_parameters():
                if slot in self.state.get(p, {}):
                    slot_sd[name] = self.state[p][slot]
            for key, leaf in trainable_leaves(to_tree(slot_sd)):
                out[path + key] = np.asarray(leaf, np.float32)
        return out

    def load_named_state(self, arrays, model: nn.Module, to_tree=None,
                         from_tree=None):
        """Restore the state of `model`'s parameters from an
        `optimizer.npz`: the JAX trainer's layout (optax key paths; needs
        `to_tree` and its inverse `from_tree`, `kpd.state_dict_from_jax`
        or hgPRM's) or the port's own ("<slot>/<parameter name>").  A
        missing slot or an unknown key raises, as the JAX loader does."""
        files = set(arrays.keys())
        named = list(model.named_parameters())
        g = self.param_groups[0]
        if any(k.startswith(".") for k in files):
            paths = jax_state_paths(g["method"], g["weight_decay"])
            like = to_tree(model.state_dict())
            expect = {p + k for slot, p in paths.items() if slot != "count"
                      for k, _ in trainable_leaves(like)}
            if "count" in paths:
                expect.add(paths["count"])
            _check_keys(files, expect)
            count = int(arrays[paths["count"]]) if "count" in paths else 0
            slots = {}
            for slot, path in paths.items():
                if slot == "count":
                    continue
                sd = from_tree(map_trainable_leaves(
                    like, lambda key, leaf, pre=path: arrays[pre + key]))
                slots[slot] = sd
            for name, p in named:
                st = {"count": count}
                for slot in self._slots()[1:]:
                    st[slot] = torch.as_tensor(
                        np.asarray(slots[slot][name]), dtype=p.dtype,
                        device=p.device).clone()
                self.state[p] = st
            return
        expect = {f"{slot}/{name}" for name, _ in named
                  for slot in self._slots()}
        _check_keys(files, expect)
        for name, p in named:
            st = {}
            for slot in self._slots():
                v = arrays[f"{slot}/{name}"]
                st[slot] = (int(v) if slot == "count" else
                            torch.as_tensor(v, dtype=p.dtype,
                                            device=p.device).clone())
            self.state[p] = st


def _check_keys(files, expect):
    missing = sorted(expect - files)
    if missing:
        raise KeyError(f"optimizer state missing {missing[0]} "
                       f"({len(missing)} keys)")
    unknown = sorted(files - expect)
    if unknown:
        raise KeyError(f"optimizer state has unknown key {unknown[0]} "
                       f"({len(unknown)} keys)")


def jax_state_paths(method: str, weight_decay: float) -> dict:
    """{port slot: optax key path} of the state of the JAX
    `make_optimizer(method, ..., weight_decay, params_example)`:
    `masked(chain(add_decayed_weights, tx))` or `masked(tx)`.  rmsprop and
    sgd carry a momentum trace even at momentum 0 (decay 0: it holds the
    last update, which nothing reads); adam one step count."""
    inner = ".inner_state" + ("[1]" if weight_decay else "")
    return {"rmsprop": {"nu": f"{inner}[0].nu", "trace": f"{inner}[2].trace"},
            "adam": {"count": f"{inner}[0].count", "mu": f"{inner}[0].mu",
                     "nu": f"{inner}[0].nu"},
            "sgd": {"trace": f"{inner}[0].trace"}}[method]


def _tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _is_bn_stat(key: str) -> bool:
    return key.endswith("['mean']") or key.endswith("['var']")


def trainable_leaves(tree):
    """(JAX key path, leaf) of a JAX param tree's trainable leaves, as
    `jax.tree_util.keystr` writes the paths; batch-norm running statistics
    are left out, as the JAX optimizer masks them."""
    return [(k, v) for k, v in _tree_items(tree) if not _is_bn_stat(k)]


def map_trainable_leaves(tree, fn, prefix=""):
    """`tree` with each trainable leaf replaced by fn(key path, leaf)."""
    if isinstance(tree, dict):
        return {k: map_trainable_leaves(v, fn, f"{prefix}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_trainable_leaves(v, fn, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return tree if _is_bn_stat(prefix) else fn(prefix, tree)


def make_optimizer(params, method: str = "rmsprop", lr: float = 2.5e-4,
                   momentum: float = 0.0, weight_decay: float = 0.0):
    """The JAX `make_optimizer` (the CLI's --optMethod, --LR, --momentum,
    --weightDecay) over `params`: an `Optimizer`."""
    return Optimizer(params, method, lr, momentum, weight_decay)


def masked_mse_loss(out, labels, set_mask):
    """MSE over all elements with torch 'mean' reduction semantics."""
    diff = out * set_mask - labels
    return torch.mean(diff * diff)


def _peaks(hm):
    """[B,K,2] (x, y) of each map's first maximum."""
    b, k, _, w = hm.shape
    idx = torch.argmax(hm.reshape(b, k, -1), dim=2)
    x = (idx % w).float()
    y = torch.floor(idx.float() / w)
    return torch.stack([x, y], dim=-1)


def pck_accuracy(out, labels, out_res_h: int):
    """Heatmap PCK@0.5 with norm outputResH/10 (eval.py:36-53); out and
    labels [B,K,H,W].  Keypoints whose label peak has a non-positive
    coordinate are not counted.  Returns (acc, n_valid)."""
    p, g = _peaks(out), _peaks(labels)
    dist = torch.linalg.norm(p - g, dim=-1) / (out_res_h / 10.0)
    valid = (g[..., 0] > 0) & (g[..., 1] > 0)
    correct = (dist <= 0.5) & valid
    n_valid = valid.sum()
    return correct.sum() / n_valid.clamp_min(1), n_valid


def _per_sample_mse(outs, labels, set_mask):
    """Masked MSE per batch element, summed over the heads: [B]."""
    total = 0.0
    for o in outs:
        diff = o * set_mask - labels
        total = total + torch.mean(diff * diff, dim=(1, 2, 3))
    return total


def make_loss_fn(out_res_h: int, sym_perms=None):
    """loss_fn(out, labels, set_mask) -> (loss, acc, n_valid).  `out` is one
    heatmap tensor or the list of a stacked network's heads (the loss sums
    over them, the accuracy reads the last).  With `sym_perms`, the loss
    is the mean over samples of the minimum over symmetry modes (mode 0
    the labels as given, then labels[:, perm] per permutation), and the
    accuracy is taken against each sample's chosen mode."""
    perms = [torch.as_tensor(p, dtype=torch.long) for p in sym_perms or ()]

    def loss_fn(out, labels, set_mask):
        outs = [o.float() for o in (out if isinstance(out, (list, tuple))
                                    else [out])]
        if not perms:
            loss = sum(masked_mse_loss(o, labels, set_mask) for o in outs)
            return (loss,
                    *pck_accuracy(outs[-1] * set_mask, labels, out_res_h))
        mode_labels, mode_masks = [labels], [set_mask]
        for p in perms:
            p = p.to(labels.device)
            mode_labels.append(labels[:, p])
            mode_masks.append(set_mask[:, p])
        stacked = torch.stack([_per_sample_mse(outs, lab, msk) for lab, msk
                               in zip(mode_labels, mode_masks)])   # [M,B]
        loss = stacked.min(dim=0).values.mean()
        pick = torch.argmin(stacked, dim=0).detach()                # [B]
        rows = torch.arange(labels.shape[0], device=labels.device)
        lab_sel = torch.stack(mode_labels)[pick, rows]
        mask_sel = torch.stack(mode_masks)[pick, rows]
        return loss, *pck_accuracy(outs[-1] * mask_sel, lab_sel, out_res_h)
    return loss_fn


def forward_heads(model: nn.Module, inps):
    """The training forward: every head of a stacked network (PyraNet
    with `all_heads`), FastPose's one heatmap otherwise."""
    if isinstance(model, PyraNet):
        return model(inps, all_heads=True)
    return model(inps)


def make_train_step(model: nn.Module, optimizer, out_res_h: int = 80,
                    precision: str = DEFAULT_TRAIN_PRECISION, sym_perms=None,
                    group=None):
    """train_step(batch) -> {"loss", "acc"} (device scalars, no host sync):
    one forward (all heads) and backward in train mode with the convs in
    `precision`, then one optimizer update.  batch: the dict of
    `train/augment.augment_batch`.

    Data parallelism: with `group` (the mesh's `data` axis), batch is this
    rank's rows of the global batch.  The loss is a mean over the batch
    (the symmetry-aware one a mean of per-sample minima), so the gradients
    are all-reduced as a mean over the group, and the step is the
    single-device step on the global batch, as the JAX step under GSPMD
    is.  The logged loss is the group's mean, and `acc` the global PCK:
    the correct and valid counts are summed before the division.  (The
    batch norms take the global statistics when pointed at the group,
    `parallel/layers.set_batch_norm_group`.)"""
    loss_fn = make_loss_fn(out_res_h, sym_perms)
    params = list(model.parameters())

    def train_step(batch):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with conv_precision(model, precision):
            out = forward_heads(model, batch["inps"])
            loss, acc, n_valid = loss_fn(out, batch["labels"],
                                         batch["set_mask"])
            loss.backward()
        coll.all_reduce_grads(params, group, "mean")
        optimizer.step()
        loss = loss.detach()
        if group is not None:
            with torch.no_grad():
                n_valid = n_valid.float()
                stats = coll.all_reduce_sum(torch.stack(
                    [loss, torch.round(acc * n_valid.clamp_min(1)),
                     n_valid]), group)
            loss = stats[0] / coll.group_size(group)
            acc = stats[1] / stats[2].clamp_min(1)
        return {"loss": loss, "acc": acc}

    return train_step


def make_eval_step(out_res_h: int = 80, sym_perms=None):
    """eval_step(model, batch) -> {"loss", "acc", "n"}: the last head in
    eval mode (running statistics), float32."""
    loss_fn = make_loss_fn(out_res_h, sym_perms)

    @torch.no_grad()
    def eval_step(model, batch):
        model.eval()
        out = model(batch["inps"]).float()
        loss, acc, n = loss_fn(out, batch["labels"], batch["set_mask"])
        return {"loss": loss, "acc": acc, "n": n}

    return eval_step


@torch.no_grad()
def flip_tta_step(model, inps):
    """Flip test-time augmentation (valid path, train.py:80-84): the mean
    of the heatmaps of the NHWC crops and of their horizontal flip, the
    latter flipped back.  No channel swap: LineMod keypoints have no
    left/right pairs."""
    return (model(inps) + model(inps.flip(2)).flip(-1)) / 2.0
