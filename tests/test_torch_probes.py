"""The port's measurement tools run end to end on the CPU at tiny shapes
(`--device cpu`) and print well-formed JSON with their documented keys; on
the CPU no device metric (MFU) is filled in.  Options with no counterpart
on the card raise.  The numbers themselves come only from runs on the card
(`chip_smoke.py`)."""

import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from betapose_tpu_torch.core import profiling  # noqa: E402
from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc  # noqa: E402
from betapose_tpu_torch.ops.kernels import build  # noqa: E402
from betapose_tpu_torch.tools import probe_chain_variants  # noqa: E402
from betapose_tpu_torch.tools import probe_conv_mfu  # noqa: E402
from betapose_tpu_torch.tools import probe_s2d_stage  # noqa: E402
from betapose_tpu_torch.tools import profile_pipeline  # noqa: E402


def _json_lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def test_probe_conv_mfu_rows(capsys, monkeypatch):
    monkeypatch.setattr(probe_conv_mfu, "WIDTH", 32)
    rows = probe_conv_mfu.main(["--device", "cpu", "--batch", "1", "--k", "2",
                                "--rounds", "1"])
    assert _json_lines(capsys) == rows
    assert [r["op"] for r in rows] == [
        "conv3x3 13x13x32", "conv3x3 16x16x32", "conv1x1 13x13x32",
        "mm-as-1x1 [169,32]@[32,32]", "conv3x3 26x26x16",
        "matmul [256,32]@[32,32]"]
    for r in rows:
        assert set(r) == {"op", "device", "ms", "tflops", "mfu", "mfu_peak"}
        assert r["device"] == "cpu" and r["ms"] > 0
        assert r["tflops"] is None and r["mfu"] is None


def test_probe_conv_mfu_int8_raises():
    with pytest.raises(NotImplementedError, match="int8"):
        probe_conv_mfu.main(["--int8", "--device", "cpu"])


@pytest.fixture
def tiny_stage(monkeypatch):
    monkeypatch.setattr(probe_s2d_stage, "STAGE", (8, 8, 16))
    monkeypatch.setattr(probe_s2d_stage, "RESIZE", ((24, 32), 16))


def test_probe_s2d_stage_rows(capsys, tiny_stage):
    rows = probe_s2d_stage.main(["--device", "cpu", "--batch", "1", "--k",
                                 "1", "--rounds", "1"])
    assert _json_lines(capsys) == rows
    stage, resize = rows
    assert set(stage) == {"probe", "device", "max_rel_err", "normal_ms",
                          "normal_mfu", "s2d_ms", "s2d_dense_gflop_ratio",
                          "speedup", "mfu_peak"}
    assert stage["probe"] == "s2d_stage_8x8x16_b1"
    assert stage["max_rel_err"] < 0.05 and stage["normal_mfu"] is None
    assert set(resize) == {"probe", "device", "resize_ms", "ms_per_frame"}
    assert resize["probe"] == "resize_24x32->16_b1"


def test_probe_s2d_stage_skip_resize(capsys, tiny_stage):
    rows = probe_s2d_stage.main(["--device", "cpu", "--batch", "1", "--k",
                                 "1", "--rounds", "1", "--skip_resize"])
    assert len(rows) == 1 and _json_lines(capsys) == rows


TINY = ["--device", "cpu", "--batch", "1", "--iters", "1"]


@pytest.fixture
def tiny_pipeline(monkeypatch):
    monkeypatch.setattr(profile_pipeline, "SIZES", {
        "reso": 64, "crop": (64, 32), "arch": "resnet50",
        "frame": (96, 128)})


def test_profile_pipeline_document(capsys, tmp_path, tiny_pipeline):
    out = profile_pipeline.main(TINY + ["--s2d_stem", "--trace",
                                        str(tmp_path)])
    assert _json_lines(capsys) == [out]
    assert set(out) == {"device", "batch", "det_capacity", "s2d_stem",
                        "step_ms_per_batch", "fps", "stage_ms", "sub_ms",
                        "flops_per_batch", "mfu_step", "mfu_peak", "note"}
    assert out["device"] == "cpu" and out["s2d_stem"] is True
    assert set(out["stage_ms"]) == {"dt", "pt", "pn"}
    assert set(out["sub_ms"]) == {"resize_ms", "yolo_fwd_ms", "kpd_fwd_ms",
                                  "crop_ms", "decode_ms", "pnp_ms"}
    flops = out["flops_per_batch"]
    assert flops["det"] > 0 and flops["pose"] > 0
    assert flops["step"] >= flops["det"] + flops["pose"]
    assert out["mfu_step"] is None
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_profile_pipeline_det_capacity_raises(capsys, tiny_pipeline):
    """`--det_capacity` > 1, refused before the multi-candidate path was
    ported, now profiles that path: the same document, on B*N crops."""
    out = profile_pipeline.main(TINY + ["--det_capacity", "2"])
    assert _json_lines(capsys) == [out]
    assert out["det_capacity"] == 2 and out["device"] == "cpu"
    assert set(out["stage_ms"]) == {"dt", "pt", "pn"}
    assert set(out["sub_ms"]) == {"resize_ms", "yolo_fwd_ms", "kpd_fwd_ms",
                                  "crop_ms", "decode_ms", "pnp_ms"}
    flops = out["flops_per_batch"]
    assert flops["step"] >= flops["det"] + flops["pose"] > 0
    assert out["mfu_step"] is None


def test_tools_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    for tool in (probe_conv_mfu, probe_s2d_stage):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(["--batch", "1"])


def test_chain_ms_counts_every_call():
    calls = []
    ms = profiling.chain_ms(lambda: calls.append(1), "cpu", k=3, rounds=2,
                            warmup=1)
    assert len(calls) == 1 + 3 * 2 and ms >= 0


def test_runtime_profile_summary():
    prof = profiling.RuntimeProfile()
    with prof.bucket("dt"):
        pass
    assert prof.summary().startswith("dt: ")
    assert "pt" not in prof.summary()


@pytest.mark.parametrize("name", sorted(probe_chain_variants.VARIANTS))
def test_chain_variant_edits_apply_to_the_kernel_source(name):
    """Every variant of the chain probe still applies to the committed
    source, each edit exactly once, and changes it unless it is the
    committed kernel."""
    path = os.path.join(build.CSRC, bc.SOURCE)
    with open(path) as f:
        source = f.read()
    edited = probe_chain_variants.variant_source(name, source)
    assert (edited == source) == (name == "committed")


def test_chain_variant_rejects_an_edit_that_does_not_apply(monkeypatch):
    monkeypatch.setitem(probe_chain_variants.VARIANTS, "stale",
                        ([("no such text", "x")], True))
    with pytest.raises(ValueError, match="applies 0 times"):
        probe_chain_variants.variant_source("stale", "kernel source")


def test_chain_variants_need_cuda_and_known_names():
    with pytest.raises(ValueError, match="unknown variants"):
        probe_chain_variants.main(["--variants", "committed,fastest"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        probe_chain_variants.main(["--variants", "committed"])
