"""YOLO's bf16 layers round once, as the JAX `_conv_layer` does.

JAX (`betapose_tpu/models/yolov3.py` `_conv_layer`) convolves bf16
activations with bf16 weights into float32 sums, adds the float32 bias (or
applies the batch norm) and the activation in float32, and rounds to bf16
once.  The port's layer did the conv in bf16, then the bias add and the
leaky in bf16: three roundings.  On the CPU, with the same bf16 inputs and
float32 parameters on both sides:

- the port's layer, the whole tiny Darknet's raw heads and the s2d stem
  agree with JAX bit for bit on at least 99.9% of the outputs and by at
  most 1 bf16 ulp anywhere (only float32 summation order differs);
- the old three-rounding epilogue, written out here, fails that bar: the
  test sees the fault;
- the float32 layer is bitwise what it was.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import torch.nn.functional as F  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from betapose_tpu.models import stem_s2d as jax_s2d  # noqa: E402
from betapose_tpu.models import yolov3 as jax_yolo  # noqa: E402
from betapose_tpu_torch.models import stem_s2d as port_s2d  # noqa: E402
from betapose_tpu_torch.models import yolov3 as port_yolo  # noqa: E402
from tests.test_torch_pipeline import TINY_YOLO_CFG  # noqa: E402

LAYER_CFG = """[net]
channels=16

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation={act}
"""


def ulp_keys(a):
    """bf16 values as integers in value order (-0 and +0 both 0), so that
    the difference of two keys counts the bf16 steps between them."""
    v = torch.tensor(np.asarray(a, np.float32)).bfloat16().view(
        torch.int16).int()
    return torch.where(v < 0, -(v & 0x7FFF), v)


def ulp_stats(got, ref):
    """(share of outputs bitwise equal, most bf16 steps apart)."""
    d = (ulp_keys(got) - ulp_keys(ref)).abs()
    return (d == 0).float().mean().item(), d.max().item()


def rounds_once(got, ref):
    equal, worst = ulp_stats(got, ref)
    return equal >= 0.999 and worst <= 1


def _layer(act, folded, seed=0):
    """A JAX conv layer's spec and params and the port's layer holding the
    same float32 parameters: folded ({"w", "b"}) or with batch norm."""
    cfg = LAYER_CFG.format(act=act)
    l = jax_yolo.build_spec(cfg).layers[0]
    rng = np.random.default_rng(seed)
    p = {"w": (rng.standard_normal((3, 3, 16, 32))
               * np.sqrt(2 / (9 * 16))).astype(np.float32)}
    if folded:
        p["b"] = rng.normal(0.0, 0.5, 32).astype(np.float32)
    else:
        p.update(bn_scale=rng.uniform(0.5, 1.5, 32),
                 bn_bias=rng.normal(0.0, 0.5, 32),
                 bn_mean=rng.normal(0.0, 0.3, 32),
                 bn_var=rng.uniform(0.5, 2.0, 32))
        p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    model = port_yolo.params_from_jax(port_yolo.build_spec(cfg), [p], 416)
    return l, {k: jnp.asarray(v) for k, v in p.items()}, model.layers[0]


def _bf16_input(seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 16, 24, 20)).astype(np.float32)).bfloat16()


def _jax_layer(l, p, x):
    y = jax_yolo._conv_layer(l, p, jnp.asarray(
        x.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16))
    assert y.dtype == jnp.bfloat16
    return np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("act,folded", [("leaky", True), ("linear", True),
                                        ("leaky", False)])
def test_conv_layer_rounds_once_as_jax(act, folded):
    l, p, layer = _layer(act, folded)
    x = _bf16_input()
    with torch.no_grad():
        got = layer(x)
    assert got.dtype == torch.bfloat16
    assert rounds_once(got.float().numpy(), _jax_layer(l, p, x)), \
        ulp_stats(got.float().numpy(), _jax_layer(l, p, x))


def test_old_three_rounding_epilogue_fails_the_bar():
    """The port's layer before the repair: the conv's bf16 output, the
    folded bias added in bf16, the leaky in bf16."""
    l, p, layer = _layer("leaky", True)
    x = _bf16_input()
    conv = layer.conv
    with torch.no_grad():
        y = F.conv2d(x.float(), conv.weight.bfloat16().float(), None,
                     conv.stride, conv.padding).bfloat16()
        y = y + conv.bias.bfloat16()[:, None, None]
        old = F.leaky_relu(y, port_yolo.LEAKY_SLOPE)
    assert old.dtype == torch.bfloat16
    equal, worst = ulp_stats(old.float().numpy(), _jax_layer(l, p, x))
    assert not (equal >= 0.999 and worst <= 1), (equal, worst)


@pytest.mark.parametrize("folded", [True, False])
def test_float32_layer_is_unchanged(folded):
    _, _, layer = _layer("leaky", folded)
    x = _bf16_input().float()
    with torch.no_grad():
        got = layer(x)
        y = layer.conv(x)
        if layer.bn is not None:
            y = layer.bn(y)
        ref = F.leaky_relu(y, port_yolo.LEAKY_SLOPE)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)


def test_bf16_darknet_heads_match_jax():
    """The tiny two-head Darknet of tests/test_torch_pipeline.py, folded,
    in bf16: every raw head within the bar."""
    spec = jax_yolo.build_spec(TINY_YOLO_CFG)
    rng = np.random.default_rng(2)
    params = [
        {"w": (rng.standard_normal((l.size, l.size, l.in_channels,
                                    l.out_channels))
               * np.sqrt(2.0 / (l.size ** 2 * l.in_channels))
               ).astype(np.float32),
         "b": rng.normal(0, 0.1, l.out_channels).astype(np.float32)}
        if l.kind == "conv" else {} for l in spec.layers]
    model = port_yolo.params_from_jax(port_yolo.build_spec(TINY_YOLO_CFG),
                                      params, 64)
    x = torch.from_numpy(rng.random((2, 64, 64, 3), np.float32)).bfloat16()
    ref = jax_yolo.forward(spec, [{k: jnp.asarray(v) for k, v in q.items()}
                                  for q in params],
                           jnp.asarray(x.float().numpy(), jnp.bfloat16), 64,
                           decode=False)
    with torch.no_grad():
        heads = model(x, decode=False)
    assert len(heads) == len(ref) == 2
    for h, r in zip(heads, ref):
        assert h.dtype == torch.bfloat16 and h.shape == r.shape
        r = np.asarray(r.astype(jnp.float32))
        assert rounds_once(h.float().numpy(), r), ulp_stats(
            h.float().numpy(), r)


def test_s2d_stem_bf16_rounds_once_as_jax():
    rng = np.random.default_rng(3)
    p = [{"w": rng.standard_normal((3, 3, 3, 32)) * 0.3,
          "b": rng.normal(0, 0.1, 32)},
         {"w": rng.standard_normal((3, 3, 32, 64)) * 0.1,
          "b": rng.normal(0, 0.1, 64)}]
    packed = jax_s2d.pack_stem_params(
        [{k: jnp.asarray(v, jnp.float32) for k, v in q.items()} for q in p])
    x = torch.from_numpy(rng.random((2, 32, 32, 3), np.float32)).bfloat16()
    ref = np.asarray(jax_s2d.stem_forward(
        packed, jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(
            jnp.float32))
    with torch.no_grad():
        got = port_s2d.stem_forward(
            {k: torch.from_numpy(np.array(v)) for k, v in packed.items()}, x)
    assert got.dtype == torch.bfloat16
    assert rounds_once(got.float().numpy(), ref), ulp_stats(
        got.float().numpy(), ref)
