"""The port's host feed (`betapose_tpu_torch/native/loader`,
`betapose_tpu_torch/data/loader`, `tools/probe_feed`) against the JAX
package's, at small sizes: as tests/test_native_loader.py and
tests/test_loader.py::TestFrameCache hold the JAX package's.

The feed is a pure transport: PNG is lossless, so a native PNG decode is
byte-identical to cv2's and to the JAX package's native decode; JPEG is
held to exactness too (both wrap the system libjpeg family).  The tests
that need the C++ library skip only where it cannot build (no g++ or
libpng/libjpeg headers), as the JAX package's do; that is decided in a
fixture, never at import."""

import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from betapose_tpu.data import loader as jax_loader  # noqa: E402
from betapose_tpu.native import loader as jax_native  # noqa: E402
from betapose_tpu_torch.data import loader as port_loader  # noqa: E402
from betapose_tpu_torch.data.loader import (FrameCache,  # noqa: E402
                                            PrefetchLoader, make_loader)
from betapose_tpu_torch.native import loader as native  # noqa: E402
from betapose_tpu_torch.tools import probe_feed  # noqa: E402


@pytest.fixture
def needs_native():
    if not native.available():
        pytest.skip("native loader unavailable (no g++ or libpng/libjpeg)")


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_native_imgs")
    rng = np.random.default_rng(7)
    paths = []
    for i in range(11):
        p = str(d / f"{i:04d}.png")
        cv2.imwrite(p, rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
        paths.append(p)
    return paths


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _fake_png(tmp_path, name="fake.png"):
    """A .png name holding BMP bytes: the native codecs reject it (a
    codec-class failure), cv2 decodes it."""
    rng = np.random.default_rng(3)
    bmp = str(tmp_path / "real.bmp")
    cv2.imwrite(bmp, rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    fake = str(tmp_path / name)
    os.rename(bmp, fake)
    return fake


# ---- the library and its codecs ----------------------------------------

def test_library_builds_into_the_build_dir(needs_native):
    path = native.build_native()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libbploader-")
    assert path == native.library_path()


@pytest.mark.parametrize("i", [0, 1, 2])
def test_png_byte_identical_to_cv2_and_to_the_jax_package(needs_native,
                                                          img_dir, i):
    p = img_dir[i]
    got = native.imread_rgb(p)
    np.testing.assert_array_equal(got, _cv2_rgb(p))
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_native.imread_rgb(p))
    np.testing.assert_array_equal(port_loader.imread_rgb(p),
                                  jax_loader.imread_rgb(p))


def test_jpeg_matches_cv2_and_the_jax_package(needs_native, img_dir,
                                              tmp_path):
    p = str(tmp_path / "x.jpg")
    cv2.imwrite(p, cv2.cvtColor(_cv2_rgb(img_dir[0]), cv2.COLOR_RGB2BGR))
    got = native.imread_rgb(p)
    np.testing.assert_array_equal(got, _cv2_rgb(p))
    np.testing.assert_array_equal(port_loader.imread_rgb(p),
                                  jax_loader.imread_rgb(p))


def test_gray_and_rgba_png_promoted_to_rgb(needs_native, tmp_path):
    rng = np.random.default_rng(1)
    pg = str(tmp_path / "gray.png")
    cv2.imwrite(pg, rng.integers(0, 255, (20, 30), dtype=np.uint8))
    got = native.imread_rgb(pg)
    assert got.shape == (20, 30, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(pg))
    pa = str(tmp_path / "rgba.png")
    cv2.imwrite(pa, rng.integers(0, 255, (20, 30, 4), dtype=np.uint8))
    assert native.imread_rgb(pa).shape == (20, 30, 3)


def test_probe_dims_reads_the_header(needs_native, img_dir):
    assert native.probe_dims(img_dir[0]) == (48, 64)


@pytest.mark.parametrize("case", ["missing", "not_an_image", "truncated"])
def test_bad_files_raise(needs_native, img_dir, tmp_path, case):
    p = str(tmp_path / "bad.png")
    if case == "not_an_image":
        with open(p, "wb") as f:
            f.write(b"definitely not an image")
    elif case == "truncated":
        data = open(img_dir[0], "rb").read()
        with open(p, "wb") as f:
            f.write(data[: len(data) // 2])
    with pytest.raises(IOError):
        native.imread_rgb(p)


def test_parse_rc():
    assert native._parse_rc("decode failed (rc=-3): x.png") == -3
    assert native._parse_rc("no code here") == 0
    assert native.BP_ERRORS == jax_native.BP_ERRORS


# ---- the ring loader -----------------------------------------------------

@pytest.mark.parametrize("batch,workers,lookahead", [(4, 3, 3), (2, 4, 1)])
def test_ring_order_and_tail_padding(needs_native, img_dir, batch, workers,
                                     lookahead):
    """Batches in path order, the tail padded with the last frame; a
    window smaller than the path count (lookahead 1) recycles ring slots
    and keeps the order."""
    ref = list(PrefetchLoader(img_dir, batch_size=batch))
    nat = native.NativeLoader(img_dir, batch_size=batch, workers=workers,
                              lookahead=lookahead)
    got = list(nat)
    assert len(nat) == len(ref) == len(got)
    n = len(img_dir)
    assert nat.batch_sizes == [min(batch, n - s) for s in range(0, n, batch)]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    np.testing.assert_array_equal(got[-1][-1], _cv2_rgb(img_dir[-1]))
    if jax_native.available():
        for j, g in zip(jax_native.NativeLoader(img_dir, batch_size=batch),
                        got):
            np.testing.assert_array_equal(j, g)


def test_exact_batch_multiple(needs_native, img_dir):
    nat = native.NativeLoader(img_dir[:8], batch_size=4)
    assert len(list(nat)) == 2 and nat.batch_sizes == [4, 4]


def test_missing_file_mid_stream_raises(needs_native, img_dir, tmp_path):
    with pytest.raises(IOError, match="rc=-1"):
        list(native.NativeLoader(img_dir[:3] + [str(tmp_path / "no.png")],
                                 batch_size=2))


def test_mixed_dims_raise(needs_native, img_dir, tmp_path):
    p = str(tmp_path / "odd.png")
    cv2.imwrite(p, np.zeros((10, 10, 3), np.uint8))
    with pytest.raises(IOError, match="rc=-4"):
        list(native.NativeLoader(img_dir[:2] + [p], batch_size=3))


def test_codec_failure_hands_the_rest_to_cv2(needs_native, img_dir,
                                             tmp_path, capsys):
    """A .png whose bytes the native codecs reject but cv2 decodes: the
    frames from its batch on go to the cv2 pool, with a warning, and the
    batches are the cv2 loader's, byte for byte."""
    paths = img_dir[:3] + [_fake_png(tmp_path)] + img_dir[3:5]
    ref = list(PrefetchLoader(paths, batch_size=2))
    nat = native.NativeLoader(paths, batch_size=2)
    got = list(nat)
    assert len(got) == len(ref) and nat.fallbacks == 1
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    err = capsys.readouterr().err
    assert "WARNING: native loader failed (decode failed (rc=-2)" in err
    assert "falling back to the cv2 loader" in err


# ---- imread_rgb and make_loader -------------------------------------------

def test_imread_falls_back_for_bmp_and_raises_on_missing(tmp_path):
    p = str(tmp_path / "f.bmp")
    cv2.imwrite(p, np.arange(48, dtype=np.uint8).reshape(4, 4, 3))
    np.testing.assert_array_equal(port_loader.imread_rgb(p), _cv2_rgb(p))
    with pytest.raises(FileNotFoundError):
        port_loader.imread_rgb(str(tmp_path / "absent.png"))
    # a .png only cv2 decodes falls through to cv2
    fake = _fake_png(tmp_path)
    np.testing.assert_array_equal(port_loader.imread_rgb(fake),
                                  _cv2_rgb(fake))


def test_make_loader_modes(needs_native, img_dir, tmp_path):
    assert isinstance(make_loader(img_dir, 4), native.NativeLoader)
    nat = make_loader(img_dir, 4, mode="native")
    assert isinstance(nat, native.NativeLoader)
    assert isinstance(make_loader(img_dir, 4, mode="threads"),
                      PrefetchLoader)
    procs = make_loader(img_dir, 4, mode="procs")
    assert isinstance(procs, PrefetchLoader) and procs.use_processes
    # auto with an input the native codecs do not take: cv2 threads
    p = str(tmp_path / "frame.bmp")
    cv2.imwrite(p, np.zeros((48, 64, 3), np.uint8))
    auto = make_loader(img_dir + [p], 4)
    assert isinstance(auto, PrefetchLoader) and not auto.use_processes
    for r, g in zip(PrefetchLoader(img_dir, batch_size=4), nat):
        np.testing.assert_array_equal(r, g)
    with pytest.raises(ValueError):
        make_loader(img_dir, 4, mode="warp")


def test_make_loader_without_the_library(img_dir, monkeypatch):
    """Where the library cannot build, native raises and auto takes the
    cv2 threads (the JAX package's rules)."""
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="C\\+\\+ loader unavailable"):
        make_loader(img_dir, 4, mode="native")
    auto = make_loader(img_dir, 4)
    assert isinstance(auto, PrefetchLoader) and not auto.use_processes


# ---- FrameCache --------------------------------------------------------------

def test_frame_cache_builds_and_serves_the_jax_packages_frames(img_dir,
                                                              tmp_path):
    path = str(tmp_path / "frames.npy")
    cache = FrameCache(img_dir, path)
    assert os.path.exists(path)
    jax_cache = jax_loader.FrameCache(img_dir, str(tmp_path / "jax.npy"))
    ref = list(PrefetchLoader(img_dir, batch_size=4))
    got = list(cache.batches(4))
    assert len(got) == len(ref) == 3
    for r, g, j in zip(ref, got, jax_cache.batches(4)):
        np.testing.assert_array_equal(r, g)
        np.testing.assert_array_equal(j, g)
    # the manifest is the JAX package's: (path, size) per frame
    with open(path + ".manifest.json") as f:
        assert json.load(f) == json.load(open(
            str(tmp_path / "jax.npy") + ".manifest.json"))


def test_frame_cache_reload_skips_decode(img_dir, tmp_path, monkeypatch):
    path = str(tmp_path / "frames.npy")
    FrameCache(img_dir, path)

    def boom(p):
        raise AssertionError("decoded again despite the cache")
    monkeypatch.setattr(port_loader, "imread_rgb", boom)
    assert len(list(FrameCache(img_dir, path).batches(6))) == 2


@pytest.mark.parametrize("case", ["shorter", "reordered", "no_manifest"])
def test_frame_cache_rejects_a_stale_cache(img_dir, tmp_path, case):
    path = str(tmp_path / "frames.npy")
    cache = FrameCache(img_dir, path)
    if case == "shorter":
        with pytest.raises(ValueError, match="stale"):
            FrameCache(img_dir[:5], path)
    elif case == "reordered":
        with pytest.raises(ValueError, match="manifest mismatch"):
            FrameCache(list(reversed(img_dir)), path)
    else:
        os.remove(cache._manifest_path())
        with pytest.raises(ValueError, match="no manifest"):
            FrameCache(img_dir, path)


# ---- probe_feed -------------------------------------------------------------

def test_measure_scaling(needs_native, img_dir):
    curve = probe_feed.measure_scaling(img_dir, 4, [1, 2], "native")
    assert set(curve) == {1, 2} and all(v > 0 for v in curve.values())
    assert probe_feed.measure_scaling(img_dir, 4, [1], "threads")[1] > 0
    with pytest.raises(ValueError):
        probe_feed.measure_scaling(img_dir, 4, [1], "warp")


def test_probe_json_has_the_jax_probes_keys(needs_native, capsys):
    res = probe_feed.main(["--workers", "1,2", "--frames", "8", "--batch",
                           "4", "--loader", "native,threads"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    from betapose_tpu.tools.probe_feed import run_probe
    ref = run_probe(workers_list=(1,), frames=4, batch=4,
                    loaders=("threads",))
    assert set(res) == set(ref)
    assert set(res["curves"]) == {"native", "threads"}
    for curve in res["curves"].values():
        assert set(curve) == {"1", "2"}
    assert res["per_core_native_fps"] == res["curves"]["native"]["1"]
    assert res["best_fps"] > 0 and res["host_cpus"] >= 1
